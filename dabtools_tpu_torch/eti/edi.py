"""EDI — Encapsulation of DAB Interfaces (ETSI TS 102 693), ETI(LI) over AF.

The modern replacement for raw ETI(NI) transport: ensemble data is packed
into TAG items (``*ptr`` protocol marker, ``deti`` frame header + FIC,
``est`` per sub-channel stream), concatenated into a TAG packet and
framed by the AF (Application Framing) layer with sequence numbers and a
CRC.  For lossy/datagram links the PFT layer (TS 102 821) fragments AF
packets to an MTU with per-fragment headers and loss-tolerant
reassembly; PFT's optional Reed-Solomon FEC and addressing are NOT
implemented (flags transmitted 0) — a documented gap.

No counterpart exists in the reference (SURVEY.md s2a — dabtools predates
EDI); provided for the "complete toolset" widening: ``eti2edi`` /
``edi2eti`` CLIs convert losslessly in both directions, closed-loop
tested (ETI -> EDI -> ETI is byte-identical modulo TIST/FSYNC phase,
which EDI does not carry: FSYNC is regenerated and TIST is carried in
an ``atst`` item only when timestamping is enabled).

Interop caveats [K-med/K-low — docs/INTEROP.md row 19]: exact deti/est
bit packing and the AF CRC convention are reconstructions; the layer
structure (TAG name + 32-bit bit-length + value; AF sync/seq/CRC) is
standard-stable.  Verify against ODR-DabMux EDI output when available.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.utils.crc import crc16_ccitt

log = logging.getLogger("dabtools_tpu.edi")

AF_SYNC = b"AF"
_PT_TAG = ord("T")


# ---------------------------------------------------------------- TAG layer
def tag_item(name: bytes, value: bytes) -> bytes:
    """One TAG item: 4-byte name, 4-byte length in BITS, value."""
    if len(name) != 4:
        raise ValueError("TAG name must be 4 bytes")
    return name + (8 * len(value)).to_bytes(4, "big") + value


def parse_tag_packet(payload: bytes) -> list[tuple[bytes, bytes]]:
    """TAG packet -> [(name, value)]; ignores zero-padding at the end."""
    items, pos = [], 0
    while pos + 8 <= len(payload):
        name = payload[pos:pos + 4]
        if name == b"\x00\x00\x00\x00":      # padding
            break
        nbits = int.from_bytes(payload[pos + 4:pos + 8], "big")
        nbytes = (nbits + 7) // 8
        value = payload[pos + 8:pos + 8 + nbytes]
        if len(value) != nbytes:
            raise ValueError("truncated TAG item")
        items.append((name, value))
        pos += 8 + nbytes
    return items


# ----------------------------------------------------------------- AF layer
def af_packet(tag_payload: bytes, seq: int) -> bytes:
    """AF packet: SYNC LEN(4) SEQ(2) AR PT payload CRC(2).

    AR = 0x80 | (maj 1 << 4) | min 0: CRC present, revision 1.0.  The CRC
    is the FIB convention (CRC-16/CCITT, init all-ones, inverted) over
    everything before it [K-med].
    """
    head = (AF_SYNC + len(tag_payload).to_bytes(4, "big")
            + (seq & 0xFFFF).to_bytes(2, "big") + bytes([0x90, _PT_TAG]))
    body = head + tag_payload
    return body + crc16_ccitt(body).to_bytes(2, "big")


class AfParser:
    """Incremental AF de-framer with resynchronisation."""

    def __init__(self):
        self._buf = bytearray()
        self.resyncs = 0
        self.crc_failures = 0
        self.last_seq = None

    def feed(self, data: bytes) -> list[bytes]:
        """Bytes in -> list of TAG payloads (CRC-checked)."""
        self._buf += data
        out = []
        while True:
            pkt = self._next()
            if pkt is None:
                return out
            out.append(pkt)

    def _next(self):
        buf = self._buf
        while True:
            pos = buf.find(AF_SYNC)
            if pos < 0:
                del buf[:-1]
                return None
            if pos:
                self.resyncs += 1
                del buf[:pos]
            if len(buf) < 10:
                return None
            ln = int.from_bytes(buf[2:6], "big")
            total = 10 + ln + 2
            # Validate the rest of the header before trusting LEN: a false
            # "AF" hit with a large length would otherwise stall the
            # stream waiting for megabytes that never come.
            if (ln > (1 << 20) or not buf[8] & 0x80
                    or buf[9] != _PT_TAG):
                del buf[:2]
                self.resyncs += 1
                continue
            if len(buf) < total:
                return None
            pkt = bytes(buf[:total])
            if crc16_ccitt(pkt[:-2]) != int.from_bytes(pkt[-2:], "big"):
                self.crc_failures += 1
                del buf[:2]
                continue
            del buf[:total]
            seq = int.from_bytes(pkt[6:8], "big")
            if (self.last_seq is not None
                    and seq != (self.last_seq + 1) & 0xFFFF):
                log.warning("AF sequence jump %d -> %d", self.last_seq, seq)
            self.last_seq = seq
            return pkt[10:-2]


# ----------------------------------------------------------- ETI <-> TAGs
@dataclasses.dataclass
class EdiFrame:
    """Decoded content of one EDI AF packet (ETI(LI) equivalent)."""

    fct: int
    fp: int
    mid: int
    err: int
    fic: bytes
    streams: list[tuple[int, int, int, bytes]]   # (subchid, sad, tpl, data)
    tist: int | None = None


class EdiWriter:
    """ETI(NI) frames (or parsed EtiFrame objects) -> EDI AF packets."""

    def __init__(self, mode=C.MODE_I):
        self.mode = mode
        self.seq = 0
        self._eti = None

    def from_eti_bytes(self, data: bytes) -> list[bytes]:
        from dabtools_tpu_torch.eti.parse import EtiParser
        if self._eti is None:
            self._eti = EtiParser(mode=self.mode)
        return [self.from_eti_frame(f) for f in self._eti.feed(data)]

    def from_eti_frame(self, f) -> bytes:
        """One parsed ``EtiFrame`` -> one AF packet."""
        items = [tag_item(b"*ptr", b"DETI" + bytes([0, 1, 0, 0]))]
        # deti: flags(1): ficf<<7 | atstf<<6 | rfu, fct(1), stat(1)=ERR,
        # mid/fp(1): mid<<5 | fp<<2, then the FIC bytes [K-med packing].
        atstf = f.tist is not None
        head = bytes([(1 << 7) | (atstf << 6), f.fct, f.err,
                      (f.mid << 5) | (f.fp << 2)])
        if atstf:
            head += f.tist.to_bytes(4, "big")
        items.append(tag_item(b"deti", head + f.fic))
        for s in sorted(f.streams.values(), key=lambda s: s.subchid):
            # SSTC: SCID(6) SAD(10) TPL(6) STL(10), like the ETI STC
            sstc = bytes([s.subchid << 2 | (s.sad_words >> 8) & 0x03,
                          s.sad_words & 0xFF,
                          (s.tpl << 2) | (s.stl_words >> 8) & 0x03,
                          s.stl_words & 0xFF])
            items.append(tag_item(b"est" + bytes([s.subchid]),
                                  sstc + s.data))
        pkt = af_packet(b"".join(items), self.seq)
        self.seq = (self.seq + 1) & 0xFFFF
        return pkt


class EdiReader:
    """EDI AF byte stream -> EdiFrame objects (and back to ETI bytes)."""

    def __init__(self, mode=C.MODE_I):
        self.mode = mode
        self.af = AfParser()

    def feed(self, data: bytes) -> list[EdiFrame]:
        out = []
        for payload in self.af.feed(data):
            frame = self._decode(parse_tag_packet(payload))
            if frame is not None:
                out.append(frame)
        return out

    def _decode(self, items) -> EdiFrame | None:
        tags = dict(items)   # est names are unique per subchid
        ptr = tags.get(b"*ptr")
        if ptr is None or ptr[:4] != b"DETI":
            return None
        deti = tags.get(b"deti")
        if deti is None or len(deti) < 4:
            return None
        flags, fct, err, midfp = deti[0], deti[1], deti[2], deti[3]
        pos, tist = 4, None
        if flags & 0x40:
            tist = int.from_bytes(deti[4:8], "big")
            pos = 8
        fic = deti[pos:] if flags & 0x80 else b""
        streams = []
        for name, value in items:
            if name[:3] == b"est" and len(value) >= 4:
                subchid = value[0] >> 2
                sad = (value[0] & 0x03) << 8 | value[1]
                streams.append((subchid, sad, value[2] >> 2, value[4:]))
        return EdiFrame(fct=fct, fp=(midfp >> 2) & 0x07, mid=midfp >> 5,
                        err=err, fic=fic, streams=streams, tist=tist)

    def to_eti_bytes(self, frame: EdiFrame) -> bytes:
        """Re-assemble the 6144-byte ETI(NI) frame (FSYNC phase from FP)."""
        fic_len = len(frame.fic)
        # MST layout must follow SAD order: EtiParser (and any ETS 300 799
        # consumer) slices stream data at mst[sad*8:...], so concatenating
        # in subchid order while keeping the original SADs would silently
        # scramble muxes whose subchid order differs from CU order.  SADs
        # are then RECOMPUTED from the actual contiguous placement:
        # third-party EDI may carry SADs with gaps (e.g. CIF CU addresses
        # after a reconfiguration), which would misaddress every stream
        # in the rebuilt frame while both CRCs still pass.
        streams = sorted(frame.streams, key=lambda s: s[1])
        sad = len(frame.fic) // 8
        placed = []
        for subchid, _, tpl, data in streams:
            placed.append((subchid, sad, tpl, data))
            sad += len(data) // 8
        streams = placed
        nst = len(streams)
        mst_bytes = fic_len + sum(len(d) for _, _, _, d in streams)
        fl_words = (4 * nst + 4 + mst_bytes) // 4
        out = bytearray()
        out.append(frame.err)
        fsync = C.ETI_FSYNC if frame.fp % 2 == 0 else C.ETI_FSYNC_INV
        out += fsync.to_bytes(3, "big")
        fc = bytearray(4)
        fc[0] = frame.fct
        fc[1] = (1 << 7) | nst
        fc[2] = (frame.fp << 5) | (frame.mid << 3) | ((fl_words >> 8) & 0x07)
        fc[3] = fl_words & 0xFF
        out += fc
        stc = bytearray()
        for subchid, sad, tpl, data in streams:
            stl = len(data) // 8
            stc += bytes([subchid << 2 | (sad >> 8) & 0x03, sad & 0xFF,
                          (tpl << 2) | (stl >> 8) & 0x03, stl & 0xFF])
        out += stc
        mnsc = b"\xff\xff"
        out += mnsc + crc16_ccitt(bytes(fc) + bytes(stc) + mnsc).to_bytes(2, "big")
        mst = frame.fic + b"".join(d for _, _, _, d in streams)
        out += mst
        out += crc16_ccitt(mst).to_bytes(2, "big") + b"\xff\xff"
        out += (frame.tist if frame.tist is not None
                else 0xFFFFFFFF).to_bytes(4, "big")
        if len(out) > C.ETI_FRAME_BYTES:
            # mirror EtiAssembler.frame: a silent >6144-byte "frame" would
            # desynchronize every downstream 6144-byte-aligned consumer
            raise ValueError(
                f"ETI frame overflow: {len(out)} > {C.ETI_FRAME_BYTES} "
                f"bytes (oversized EDI stream data)")
        out += b"\x55" * (C.ETI_FRAME_BYTES - len(out))
        return bytes(out)


# ------------------------------------------------------------- PFT layer
PFT_SYNC = b"PF"
PFT_PARITY = 48          # RS(k+48, k), shortened from RS(255, 207)
PFT_MAX_K = 207


def _pft_header(seq: int, findex: int, fcount: int, plen: int,
                rs: tuple[int, int] | None,
                addr: tuple[int, int] | None) -> bytes:
    """PFT fragment header (TS 102 821): "PF" Pseq(2) Findex(3) Fcount(3)
    FEC|Addr|Plen(2: flags in the top 2 bits, length in the low 14),
    [RSk(1) RSz(1)], [Source(2) Dest(2)], HCRC(2).  Field packing is
    [K-med] (docs/INTEROP.md row 19); self round-trip is exact."""
    flags = ((rs is not None) << 15) | ((addr is not None) << 14)
    head = (PFT_SYNC + (seq & 0xFFFF).to_bytes(2, "big")
            + findex.to_bytes(3, "big") + fcount.to_bytes(3, "big")
            + (flags | (plen & 0x3FFF)).to_bytes(2, "big"))
    if rs is not None:
        head += bytes([rs[0], rs[1]])
    if addr is not None:
        head += addr[0].to_bytes(2, "big") + addr[1].to_bytes(2, "big")
    return head + crc16_ccitt(head).to_bytes(2, "big")


def pft_fragments(af: bytes, seq: int, mtu: int = 1400, fec: bool = False,
                  addr: tuple[int, int] | None = None) -> list[bytes]:
    """Fragment one AF packet for lossy/datagram links (TS 102 821 PFT).

    ``fec=True`` adds RS(k+48, k) protection: the AF packet (zero-padded
    to c rows of RSk=``k`` bytes) gets 48 parity bytes per row, and the
    c x (k+48) matrix is fragmented by whole COLUMNS — losing a fragment
    erases the same known columns of every row, so the reassembler can
    erasure-correct up to 48 lost columns per group.  ``addr``: optional
    (source, dest) 16-bit addresses carried in every fragment header.
    """
    rs_info = None
    if fec:
        from dabtools_tpu_torch.utils.gf256 import rs_parity
        L = len(af)
        k = min(PFT_MAX_K, max(1, L))
        c = -(-L // k)
        z = c * k - L
        rows = np.frombuffer(af + bytes(z), dtype=np.uint8).reshape(c, k)
        m = np.concatenate([rows, rs_parity(rows, PFT_PARITY)], axis=1)
        rs_info = (k, z)
        n_cols = k + PFT_PARITY
        body = mtu - len(_pft_header(0, 0, 1, 0, rs_info, addr))
        # Cap at the parity budget: a fragment carrying more than 48
        # columns would make even a SINGLE loss unrecoverable (seen with
        # small AF packets, where few rows make MTU-sized fragments very
        # wide).  The cap guarantees any one lost fragment is always
        # within the RS erasure budget.
        cols_per_frag = min(max(1, body // c), PFT_PARITY)
        n_frags = -(-n_cols // cols_per_frag)
        # Rebalance so the receiver can re-derive the geometry from
        # Fcount alone: cols_per_frag = ceil(n_cols / Fcount) (never
        # exceeds the MTU-derived value).
        cols_per_frag = -(-n_cols // n_frags)
        out = []
        for i in range(n_frags):
            cols = m[:, i * cols_per_frag:(i + 1) * cols_per_frag]
            frag = cols.T.tobytes()     # column-major within the fragment
            out.append(_pft_header(seq, i, n_frags, len(frag), rs_info,
                                   addr) + frag)
        return out
    body = mtu - len(_pft_header(0, 0, 1, 0, None, addr))
    if body <= 0:
        raise ValueError("mtu too small")
    chunks = [af[i:i + body] for i in range(0, len(af), body)] or [b""]
    return [_pft_header(seq, i, len(chunks), len(c), None, addr) + c
            for i, c in enumerate(chunks)]


class PftReassembler:
    """PFT fragments in (any order, losses allowed) -> AF packets out.

    Loss recovery: when a group with RS FEC closes (a newer Pseq starts
    or the group is evicted) and its missing fragments cover at most 48
    matrix columns, the erasures are corrected (``recovered_groups``
    counts successes).  ``dest``: if given, fragments addressed to a
    different destination are ignored.
    """

    def __init__(self, max_pending: int = 8, dest: int | None = None):
        self._groups: dict[int, dict[int, bytes]] = {}
        self._meta: dict[int, tuple] = {}   # pseq -> (fcount, rs, plen0)
        self._max_pending = max_pending
        self._dest = dest
        self._buf = bytearray()
        self._last_emitted: int | None = None
        self.crc_failures = 0
        self.dropped_groups = 0
        self.recovered_groups = 0
        self.late_dropped = 0

    @staticmethod
    def _newer(a: int, b: int) -> bool:
        """Pseq ``a`` strictly after ``b`` in 16-bit wraparound order."""
        return 0 < ((a - b) & 0xFFFF) < 0x8000

    def feed(self, data: bytes) -> list[bytes]:
        """Byte stream of concatenated fragments -> completed AF packets."""
        self._buf += data
        out = []
        while True:
            pos = self._buf.find(PFT_SYNC)
            if pos < 0:
                del self._buf[:-1]
                break
            del self._buf[:pos]
            if len(self._buf) < 12:
                break
            flags = int.from_bytes(self._buf[10:12], "big")
            fec, has_addr = bool(flags & 0x8000), bool(flags & 0x4000)
            hlen = 12 + (2 if fec else 0) + (4 if has_addr else 0)
            if len(self._buf) < hlen + 2:
                break
            head = bytes(self._buf[:hlen])
            if crc16_ccitt(head) != int.from_bytes(
                    self._buf[hlen:hlen + 2], "big"):
                self.crc_failures += 1
                del self._buf[:2]
                continue
            plen = flags & 0x3FFF
            if len(self._buf) < hlen + 2 + plen:
                break
            frag = bytes(self._buf[hlen + 2:hlen + 2 + plen])
            del self._buf[:hlen + 2 + plen]
            rs = None
            p = 12
            if fec:
                rs = (head[p], head[p + 1])
                p += 2
            if has_addr and self._dest is not None:
                dst = int.from_bytes(head[p + 2:p + 4], "big")
                if dst != self._dest:
                    continue
            out += self._take(int.from_bytes(head[2:4], "big"),
                              int.from_bytes(head[4:7], "big"),
                              int.from_bytes(head[7:10], "big"), rs, frag)
        return out

    def _take(self, pseq, findex, fcount, rs, frag) -> list[bytes]:
        if fcount == 0:
            # A craftable header (valid HCRC) must not divide-by-zero the
            # network-facing reassembler.
            self.crc_failures += 1
            return []
        # A group completing/recovering AFTER newer groups were already
        # emitted must not be delivered out of sequence: ETI consumers
        # check FCT continuity, and a ~190 ms-late frame reads as a
        # discontinuity.  Late arrivals are dropped and counted.
        if (self._last_emitted is not None
                and not self._newer(pseq, self._last_emitted)):
            self.late_dropped += 1
            return []
        self._groups.setdefault(pseq, {})[findex] = frag
        self._meta[pseq] = (fcount, rs)
        g = self._groups[pseq]
        out = []
        if len(g) == fcount and all(i in g for i in range(fcount)):
            out += self._finish(pseq)
        # Bound memory: close the OLDEST incomplete group (loss on link) —
        # with FEC, closure attempts erasure recovery first.  Never close
        # the group a fragment just arrived for: it is still filling.
        # Age must be SIGNED wraparound distance: groups newer than pseq
        # would otherwise wrap to huge "ages" and a single stale fragment
        # would evict every in-flight newer group (cascading to zero
        # output on a reordering link).  A stale arrival (everything else
        # newer) therefore evicts nothing until the hard 2x+1 cap.
        if len(self._groups) > self._max_pending:
            def _age(p: int) -> int:
                d = (pseq - p) & 0xFFFF
                return d - 0x10000 if d >= 0x8000 else d
            others = [p for p in self._groups if p != pseq]
            older = [p for p in others if _age(p) > 0]
            if older:
                oldest = max(older, key=_age)
            elif len(self._groups) > 2 * self._max_pending + 1:
                oldest = max(others, key=_age, default=None)
            else:
                oldest = None
            if oldest is not None:
                if (self._last_emitted is None
                        or self._newer(oldest, self._last_emitted)):
                    got = self._finish(oldest)
                else:
                    got = []
                    self.late_dropped += 1
                if got:
                    self.recovered_groups += 1
                    out += got
                else:
                    self._groups.pop(oldest, None)
                    self._meta.pop(oldest, None)
                    self.dropped_groups += 1
        return out

    def flush(self) -> list[bytes]:
        """Close every pending group (end of stream) in sequence order,
        recovering what the FEC allows."""
        out = []
        base = self._last_emitted or 0
        for pseq in sorted(self._groups, key=lambda p: (p - base) & 0xFFFF):
            fcount = self._meta[pseq][0]
            incomplete = len(self._groups[pseq]) < fcount
            got = self._finish(pseq)
            if got:
                if incomplete:
                    self.recovered_groups += 1
                out += got
            else:
                self.dropped_groups += 1
        self._groups.clear()
        self._meta.clear()
        return out

    def _finish(self, pseq) -> list[bytes]:
        """Assemble (and erasure-correct, if FEC) group ``pseq``; [] if
        unrecoverable.  Removes the group on success."""
        g = self._groups.get(pseq)
        if g is None:
            return []
        fcount, rs = self._meta[pseq]
        if not fcount:
            return []
        complete = len(g) == fcount and all(i in g for i in range(fcount))
        if rs is None:
            if not complete:
                return []
            del self._groups[pseq], self._meta[pseq]
            self._last_emitted = pseq
            return [b"".join(g[i] for i in range(fcount))]

        k, z = rs
        n_cols = k + PFT_PARITY
        cols_per_frag = -(-n_cols // fcount)
        # Row count from any received fragment's size and column count.
        any_i, any_frag = next(iter(g.items()))
        cols_i = min(cols_per_frag, n_cols - any_i * cols_per_frag)
        if cols_i <= 0 or len(any_frag) % cols_i:
            return []
        c = len(any_frag) // cols_i
        m = np.zeros((c, n_cols), dtype=np.uint8)
        missing_cols = []
        for i in range(fcount):
            c0 = i * cols_per_frag
            cols = min(cols_per_frag, n_cols - c0)
            if cols <= 0:
                continue
            if i in g and len(g[i]) == c * cols:
                m[:, c0:c0 + cols] = np.frombuffer(
                    g[i], dtype=np.uint8).reshape(cols, c).T
            else:
                missing_cols.extend(range(c0, c0 + cols))
        if missing_cols:
            from dabtools_tpu_torch.utils.gf256 import rs_erasure_correct
            m, ok = rs_erasure_correct(m, missing_cols, PFT_PARITY)
            if not ok:
                return []
        del self._groups[pseq], self._meta[pseq]
        self._last_emitted = pseq
        data = m[:, :k].reshape(-1).tobytes()
        return [data[: c * k - z]]


class EdiToEti:
    """Transparent EDI -> ETI(NI) byte transcoder for consumers that
    want ETI regardless of capture flavor (``eti2audio``/``etiinfo``
    auto-detect: first two bytes ``AF`` = plain AF framing, ``PF`` =
    PFT-fragmented).  Oversized frames are skipped, never fatal; counts
    in ``stats``."""

    def __init__(self, mode=None, dest: int | None = None):
        from dabtools_tpu_torch import constants as C
        self._reader = EdiReader(mode=mode or C.MODE_I)
        self._pft: PftReassembler | None = None
        self._dest = dest
        self._first = True
        self.stats = {"frames": 0, "oversized": 0}

    def _convert(self, frames) -> bytes:
        out = []
        for frame in frames:
            try:
                out.append(self._reader.to_eti_bytes(frame))
                self.stats["frames"] += 1
            except ValueError:
                self.stats["oversized"] += 1
        return b"".join(out)

    def feed(self, chunk: bytes) -> bytes:
        if self._first:
            self._first = False
            if chunk[:2] == PFT_SYNC:
                self._pft = PftReassembler(dest=self._dest)
        if self._pft is not None:
            chunk = b"".join(self._pft.feed(chunk))
        return self._convert(self._reader.feed(chunk))

    def flush(self) -> bytes:
        if self._pft is None:
            return b""
        out = []
        for af in self._pft.flush():
            out.append(self._convert(self._reader.feed(af)))
        return b"".join(out)


def _edi_packet_valid_at(buf: bytes, i: int,
                         require_crc: bool = False) -> bool:
    """Validate an AF/PFT packet starting at ``buf[i:]`` with the same
    checks the de-framers apply.  With ``require_crc`` a
    truncated-at-buffer-end AF packet (header plausible, CRC
    unavailable) does NOT count."""
    b = buf[i:i + (1 << 20) + 12]
    if b[:2] == AF_SYNC:
        if len(b) < 10:
            return False
        ln = int.from_bytes(b[2:6], "big")
        if ln > (1 << 20) or not b[8] & 0x80 or b[9] != _PT_TAG:
            return False
        total = 10 + ln + 2
        if len(b) >= total:           # whole packet present: CRC decides
            return crc16_ccitt(b[:total - 2]) == int.from_bytes(
                b[total - 2:total], "big")
        return not require_crc
    if b[:2] == PFT_SYNC:
        # PFT header: "PF" Pseq(2) Findex(3) Fcount(3) flags|plen(2)
        # [+RS(2)] [+Addr(4)] HCRC(2) — the header CRC decides.
        if len(b) < 14:
            return False
        flags = int.from_bytes(b[10:12], "big")
        hlen = 12 + (2 if flags & 0x8000 else 0) + (4 if flags & 0x4000
                                                    else 0)
        if len(b) < hlen + 2:
            return False
        return crc16_ccitt(b[:hlen]) == int.from_bytes(
            b[hlen:hlen + 2], "big")
    return False


def _sniff_edi(first: bytes) -> bool:
    """True iff ``first`` really starts an EDI stream — the two sync
    bytes alone are not enough: a live ETI pipe tapped mid-frame whose
    first two bytes happen to be ``AF``/``PF`` must NOT be routed through
    the EDI transcoder (which would silently consume the whole stream as
    unsynced garbage instead of letting the ETI parser resync).  So the
    header behind the sync is validated the same way the de-framers do.

    A single CORRUPTED first packet must not condemn a real EDI stream
    to the raw path either (the de-framers resync past bad packets, the
    raw path loses everything): if position 0 doesn't validate, scan the
    buffer for any other FULLY-validated (CRC-checked) AF/PFT packet —
    present in any genuine EDI capture, vanishingly unlikely inside an
    ETI byte stream."""
    if first[:2] not in (AF_SYNC, PFT_SYNC):
        return False
    if _edi_packet_valid_at(first, 0):
        return True
    for sync in (AF_SYNC, PFT_SYNC):
        pos, tried = first.find(sync, 1, 1 << 18), 0
        while pos != -1 and tried < 64:
            if _edi_packet_valid_at(first, pos, require_crc=True):
                return True
            tried += 1
            pos = first.find(sync, pos + 1, 1 << 18)
    return False


def iter_eti_chunks(f, mode=None):
    """Yield ETI byte chunks from file-like ``f``, transparently
    transcoding EDI captures: the stream is identified as plain AF
    framing (``AF``) or PFT fragmentation (``PF``) by sync bytes PLUS a
    validated header (see ``_sniff_edi``); anything else streams through
    untouched and lands in the caller's normal ETI resync path.  Shared
    by eti2audio/etiinfo so every ETI consumer accepts EDI files for
    free."""
    import logging
    log = logging.getLogger("dabtools_tpu.edi")
    first = f.read(1 << 20)
    if not first:
        return
    if _sniff_edi(first):
        conv = EdiToEti(mode=mode)
        log.info("EDI input detected (%s); transcoding to ETI",
                 "PFT-fragmented" if first[:2] == PFT_SYNC else "AF")
        yield conv.feed(first)
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            yield conv.feed(chunk)
        yield conv.flush()
        if conv.stats["oversized"]:
            log.warning("%d oversized EDI frames skipped",
                        conv.stats["oversized"])
        return
    yield first
    while True:
        chunk = f.read(1 << 20)
        if not chunk:
            break
        yield chunk

"""FEC for MSC packet mode — "enhanced packet mode" (EN 300 401 s5.3.5).

Reference counterpart: none — upstream dabtools has no packet mode at all
(SURVEY.md s2, R17 is stream audio only).  This protects packet-mode data
services (EPG/TPEG/MOT) with an RS(204,188) outer code, signalled per
sub-channel by FIG 0/14 (FEC scheme 1).

Scheme [K-med — reconstructed from the public standard; the exact FEC
packet header bit layout is K-low, kept in ONE place (`_fec_header` /
`_parse_fec_header`) so an interop fix is a one-liner —
docs/INTEROP.md row 26]:

* The packet stream is carved into **FEC frames**: 2 256 bytes of
  application data (ordinary packets, padding included) followed by
  9 FEC packets of 24 bytes = 216 bytes, 2 472 bytes per FEC frame.
* Application data table: 12 rows x 188 columns, filled **column by
  column** (app byte k -> row k mod 12, column k div 12), so each RS
  codeword takes every 12th stream byte — a burst of 12x8 = 96
  consecutive corrupted bytes (a whole packet) stays correctable.
* RS(204,188, t=8) over each row: field poly 0x11D, generator roots
  alpha^0..alpha^15 (the DVB code; same field as the DAB+ RS).
* RS data table: 12 rows x 16 parity columns, read column by column into
  the FEC packets' data fields (9 x 22 = 198 = 192 parity + 6 zero pad).
* FEC packet: 2-byte header (Counter(4) = packet index 0..8,
  Address(10) = 1022, rfa(2)) + 22 RS-table bytes.  No packet CRC — the
  RS code itself protects these bytes.

The TPU's job ended at the convolutional decode of the sub-channel;
like `eti.packet`, this layer is host-side byte work (control plane) and
defaults to the NumPy codec (12 codewords per 2.5 kB is far below jit
dispatch overhead).  For bulk offline extraction pass
``decoder=ops.rs.make_rs_decoder(204, 188)`` to `FecDecoder` /
`fec_correct` to batch the rows through the device codec instead.
"""

from __future__ import annotations

import logging

import numpy as np

from dabtools_tpu_torch.eti.packet import PACKET_SIZES, PacketDecoder, padding_packet
from dabtools_tpu_torch.utils.gf256 import rs_decode, rs_parity

log = logging.getLogger("dabtools_tpu.pfec")

APP_ROWS = 12
APP_COLS = 188
APP_BYTES = APP_ROWS * APP_COLS          # 2256
RS_PARITY = 16                           # RS(204,188): t = 8
N_FEC_PACKETS = 9
FEC_PACKET_LEN = 24
FEC_DATA_LEN = FEC_PACKET_LEN - 2        # 22 RS-table bytes per FEC packet
FEC_BYTES = N_FEC_PACKETS * FEC_PACKET_LEN          # 216
FEC_FRAME_LEN = APP_BYTES + FEC_BYTES    # 2472
FEC_ADDRESS = 1022                       # [K-low] reserved packet address


def _fec_header(counter: int) -> bytes:
    """2-byte FEC packet header: Counter(4) Address(10) rfa(2) [K-low]."""
    hdr = (counter & 0x0F) << 12 | FEC_ADDRESS << 2
    return hdr.to_bytes(2, "big")


def _parse_fec_header(b0: int, b1: int) -> int | None:
    """Counter if the two bytes are a FEC packet header, else None."""
    hdr = b0 << 8 | b1
    if (hdr >> 2) & 0x3FF != FEC_ADDRESS or hdr & 0x03:
        return None
    counter = hdr >> 12
    return counter if counter < N_FEC_PACKETS else None


def _app_table(app: bytes) -> np.ndarray:
    """(12, 188) application data table, filled column by column."""
    return np.frombuffer(app, dtype=np.uint8).reshape(APP_COLS, APP_ROWS).T


def fec_packets(app: bytes) -> bytes:
    """The 216 FEC bytes (9 packets) protecting 2256 application bytes."""
    if len(app) != APP_BYTES:
        raise ValueError(f"FEC frame needs exactly {APP_BYTES} app bytes")
    parity = rs_parity(_app_table(app), RS_PARITY)       # (12, 16)
    rs_table = parity.T.reshape(-1).tobytes()            # column by column
    rs_table += b"\x00" * (N_FEC_PACKETS * FEC_DATA_LEN - len(rs_table))
    return b"".join(
        _fec_header(i) + rs_table[i * FEC_DATA_LEN:(i + 1) * FEC_DATA_LEN]
        for i in range(N_FEC_PACKETS))


def fec_correct(frame: bytes | bytearray,
                decoder=None) -> tuple[bytes, int]:
    """Correct one 2472-byte FEC frame; returns (app bytes, n_corrected).

    ``n_corrected = -1`` marks >=1 uncorrectable RS row; corrections in
    the OTHER rows are still applied, and the failed rows pass through
    exactly as received (an uncorrectable decode may scribble bogus
    "corrections", so those rows are restored) — the packet CRCs remain
    the final gate.  ``decoder``: optional batched codec taking
    (12, 204) -> (data, counts) (the device path); defaults to the
    NumPy reference.
    """
    if len(frame) != FEC_FRAME_LEN:
        raise ValueError(f"FEC frame is {FEC_FRAME_LEN} bytes")
    app, fec = frame[:APP_BYTES], frame[APP_BYTES:]
    rs_data = b"".join(
        fec[i * FEC_PACKET_LEN + 2:(i + 1) * FEC_PACKET_LEN]
        for i in range(N_FEC_PACKETS))
    parity = np.frombuffer(
        rs_data[:APP_ROWS * RS_PARITY],
        dtype=np.uint8).reshape(RS_PARITY, APP_ROWS).T    # (12, 16)
    table = _app_table(bytes(app))
    cw = np.concatenate([table, parity], axis=1)          # (12, 204)
    if decoder is None:
        data, counts = rs_decode(cw, n_parity=RS_PARITY)
    else:
        data, counts = decoder(cw)
    data = np.asarray(data, dtype=np.uint8).copy()
    counts = np.asarray(counts)
    bad = counts < 0
    if bad.any():
        data[bad] = table[bad]       # as received, not as mis-"corrected"
    corrected = data.T.reshape(-1).tobytes()
    if bad.any():
        return corrected, -1
    return corrected, int(counts.sum())


class FecEncoder:
    """Application packet stream -> FEC-framed stream for one sub-channel.

    Feed whole packets (any standard size); read out with ``take_frame``
    like `PacketEncoder`.  The encoder inserts the 9 FEC packets after
    every 2256 application bytes, padding with address-0 packets so a
    data packet never straddles the FEC frame boundary (the table is
    byte-oriented so straddling would be legal, but keeping packets whole
    costs at most 3 padding packets and simplifies every receiver).
    """

    def __init__(self):
        self._queue: list[bytes] = []     # mixed app + FEC packets, in order
        self._app = bytearray()           # current FEC frame's app bytes

    def add_packet(self, pkt: bytes) -> None:
        if len(pkt) not in PACKET_SIZES:
            raise ValueError("not a standard packet size")
        room = APP_BYTES - len(self._app)
        if len(pkt) > room:               # pad to the FEC frame boundary
            while room:
                pad = next(s for s in reversed(PACKET_SIZES) if s <= room)
                self._push_app(padding_packet(pad))
                room -= pad
        self._push_app(pkt)

    def _push_app(self, pkt: bytes) -> None:
        self._queue.append(pkt)
        self._app += pkt
        if len(self._app) == APP_BYTES:
            self._queue.append(fec_packets(bytes(self._app)))
            self._app.clear()

    def flush(self) -> None:
        """Close the current FEC frame (pad with address-0 packets)."""
        while self._app:
            room = APP_BYTES - len(self._app)
            pad = next(s for s in reversed(PACKET_SIZES) if s <= room)
            self._push_app(padding_packet(pad))

    @property
    def pending_bytes(self) -> int:
        return sum(len(p) for p in self._queue)

    def take_frame(self, frame_bytes: int) -> bytes:
        """Exactly ``frame_bytes`` of FEC-framed stream (multiple of 24).

        Unlike `PacketEncoder.take_frame`, trailing capacity is padded
        with address-0 packets that COUNT toward the running FEC frame
        (everything in the stream is protected)."""
        if frame_bytes % 24:
            raise ValueError("packet-mode sub-channel frames are n x 24 B")
        out = bytearray()
        while len(out) < frame_bytes:
            if not self._queue:
                room = min(frame_bytes - len(out),
                           APP_BYTES - len(self._app))
                pad = next(s for s in reversed(PACKET_SIZES) if s <= room)
                self._push_app(padding_packet(pad))
            nxt = self._queue[0]
            if len(out) + len(nxt) <= frame_bytes:
                out += self._queue.pop(0)
            else:                          # split across logical frames
                take = frame_bytes - len(out)
                out += nxt[:take]
                self._queue[0] = nxt[take:]
        return bytes(out)


class FecDecoder:
    """FEC-framed sub-channel stream -> corrected MSC data groups.

    Wraps a `PacketDecoder`.  The stream may start anywhere (the receiver
    locks mid-transmission): sync hunts for the 9-packet FEC group
    signature (counters 0..8 at 24-byte spacing) and then stays in
    lockstep; a failed signature at an expected boundary triggers a
    re-hunt.  Until sync, nothing is emitted (at most one FEC frame,
    ~2.5 kB, of latency).
    """

    def __init__(self, decoder=None):
        self._buf = bytearray()
        self._synced = False
        self._inner = PacketDecoder()
        self._decoder = decoder
        self._fec_stats = {"fec_frames": 0, "rs_corrected_bytes": 0,
                           "rs_failures": 0, "resyncs": 0}

    @property
    def stats(self) -> dict:
        """Packet stats merged with the FEC layer's own counters (drop-in
        for `PacketDecoder.stats` at the CLI logging sites)."""
        return {**self._inner.stats, **self._fec_stats}

    @property
    def packet_stats(self) -> dict:
        return self._inner.stats

    @staticmethod
    def _fec_group_at(buf, pos: int, min_match: int = 7) -> bool:
        """>= min_match of the 9 FEC packet headers (counters 0..8 at
        24-byte spacing) found at pos?  The hunt demands 7 of 9 (a
        >=14-byte signature — false sync on random payload is ~2^-100
        per position, while all-9 would let a single bit error in the
        18 unprotected header bytes veto a whole group); the in-lockstep
        check tolerates more (6) since position is already known."""
        if pos + FEC_BYTES > len(buf):
            return False
        hits = sum(
            _parse_fec_header(buf[pos + i * FEC_PACKET_LEN],
                              buf[pos + i * FEC_PACKET_LEN + 1]) == i
            for i in range(N_FEC_PACKETS))
        return hits >= min_match

    def _hunt(self) -> bool:
        """Find a FEC group; drop everything before the app data that
        follows it, leaving the buffer at an app-region boundary."""
        for pos in range(len(self._buf) - FEC_BYTES + 1):
            if self._fec_group_at(self._buf, pos):
                del self._buf[:pos + FEC_BYTES]
                self._synced = True
                return True
        # keep a tail that could still grow into a group
        if len(self._buf) > FEC_BYTES:
            del self._buf[:len(self._buf) - FEC_BYTES]
        return False

    def feed(self, data: bytes) -> list[tuple[int, bytes]]:
        self._buf += data
        out: list[tuple[int, bytes]] = []
        if not self._synced:
            if len(self._buf) < FEC_FRAME_LEN:
                return out               # too early to tell — keep latency
            if self._fec_group_at(self._buf, APP_BYTES):
                self._synced = True      # stream began on a frame boundary:
            elif not self._hunt():       # keep its first app region
                return out
        while len(self._buf) >= FEC_FRAME_LEN:
            if not self._fec_group_at(self._buf, APP_BYTES, min_match=6):
                # lost lockstep (bit errors in headers or a stream gap)
                self._synced = False
                self._fec_stats["resyncs"] += 1
                if not self._hunt():
                    return out
                continue
            frame = bytes(self._buf[:FEC_FRAME_LEN])
            del self._buf[:FEC_FRAME_LEN]
            app, n = fec_correct(frame, self._decoder)
            self._fec_stats["fec_frames"] += 1
            if n < 0:
                self._fec_stats["rs_failures"] += 1
            else:
                self._fec_stats["rs_corrected_bytes"] += n
            out += self._inner.feed(app)
        return out

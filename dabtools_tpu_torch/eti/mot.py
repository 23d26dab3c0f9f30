"""MOT object transfer + slideshow over X-PAD (EN 301 234, TS 101 499).

Carries files ("MOT objects" — for slideshow: JFIF/PNG images) inside the
PAD of an audio sub-channel: the object is split into MOT segments, each
segment rides in an MSC *data group* (EN 300 401 s5.3.3), and the data
groups ride in X-PAD subfields of application types 12 (data group
start) / 13 (continuation), each preceded by a type-1 "data group length
indicator" so the receiver can strip the contents-indicator padding —
the same transport the dynamic label uses one apptype pair down
([[eti/pad.py]]).

The reference has no data-application support at all; both directions are
implemented here (encoder = closed-loop fixture).  Interop caveats
[K-med/K-low — docs/INTEROP.md row 20]: MSC data group header bit
layout, the MOT header-core field packing, and the omission of the
X-PAD "data group length indicator" (apptype 1) which real multiplexes
interleave with the DG subfields; the object/segment state machines are
standard-stable.
"""

from __future__ import annotations

import dataclasses
import logging

from dabtools_tpu_torch.utils.crc import crc16_ccitt

log = logging.getLogger("dabtools_tpu.mot")

APP_DGLI = 1             # X-PAD apptype: data group length indicator
APP_MOT_START = 12       # X-PAD apptype: MOT data group, start
APP_MOT_CONT = 13        # continuation

DG_TYPE_MOT_HEADER = 3   # MSC data group types (EN 300 401 table)
DG_TYPE_MOT_BODY = 4
DG_TYPE_MOT_DIRECTORY = 6   # EN 301 234 directory mode (uncompressed)
DG_TYPE_MOT_DIRECTORY_Z = 7  # EN 301 234 directory mode (compressed)

COMPRESSION_GZIP = 1     # TS 101 756 MOT compression type registry

# TS 101 499: slideshow content type/subtype
CONTENT_IMAGE = 2
SUBTYPE_JFIF = 1
SUBTYPE_PNG = 3

# In-flight incomplete transfers kept per data-group type before the
# stalest is evicted (memory bound for 24/7 lossy reception; a slideshow
# carousel rarely has more than a handful of objects in flight).
MAX_PENDING_TRANSFERS = 64


# ------------------------------------------------------- MSC data groups
def dgli(length: int) -> bytes:
    """Data group length indicator value: rfa(2) len(14) + CRC16 [K-med]."""
    v = (length & 0x3FFF).to_bytes(2, "big")
    return v + crc16_ccitt(v).to_bytes(2, "big")


def parse_dgli(value: bytes) -> int | None:
    if len(value) < 4 or crc16_ccitt(value[:2]) != int.from_bytes(
            value[2:4], "big"):
        return None
    return int.from_bytes(value[:2], "big") & 0x3FFF


def build_data_group(dg_type: int, continuity: int, segment: int,
                     last: bool, transport_id: int, payload: bytes) -> bytes:
    """One MSC data group: header, session header, payload, CRC-16.

    Layout [K-med]: b0 = ext(0) crc(1) seg(1) user(1) | type(4);
    b1 = continuity(4) << 4 | repetition(4)=0; session = last(1) +
    segnum(15), then user-access byte 0x12 (transport-id flag, length 2)
    + TransportId(16).
    """
    b0 = 0b0111 << 4 | (dg_type & 0x0F)
    b1 = (continuity & 0x0F) << 4
    session = ((last << 15) | (segment & 0x7FFF)).to_bytes(2, "big")
    user = bytes([0x12]) + (transport_id & 0xFFFF).to_bytes(2, "big")
    body = bytes([b0, b1]) + session + user + payload
    return body + crc16_ccitt(body).to_bytes(2, "big")


@dataclasses.dataclass
class DataGroup:
    dg_type: int
    continuity: int
    segment: int
    last: bool
    transport_id: int | None
    payload: bytes


def parse_data_group(dg: bytes) -> DataGroup | None:
    """CRC-check and unpack one MSC data group (None on failure)."""
    if len(dg) < 4:
        return None
    b0 = dg[0]
    crc_flag, seg_flag, user_flag = b0 >> 6 & 1, b0 >> 5 & 1, b0 >> 4 & 1
    if crc_flag:
        if crc16_ccitt(dg[:-2]) != int.from_bytes(dg[-2:], "big"):
            return None
        dg = dg[:-2]
    pos = 2
    if b0 >> 7:                         # extension field
        pos += 2
    segment, last = 0, True
    if seg_flag:
        if pos + 2 > len(dg):           # truncated: header fields missing
            return None
        v = int.from_bytes(dg[pos:pos + 2], "big")
        last, segment = bool(v >> 15), v & 0x7FFF
        pos += 2
    tid = None
    if user_flag:
        if pos >= len(dg):
            return None
        ua = dg[pos]
        li = ua & 0x0F
        pos += 1
        if ua >> 4 & 1:                 # transport id present
            if pos + 2 > len(dg):
                return None
            tid = int.from_bytes(dg[pos:pos + 2], "big")
        pos += li
        if pos > len(dg):
            return None
    return DataGroup(dg_type=b0 & 0x0F, continuity=dg[1] >> 4,
                     segment=segment, last=last, transport_id=tid,
                     payload=dg[pos:])


# ------------------------------------------------------------ MOT objects
def mot_header_core(body_size: int, header_size: int, content_type: int,
                    subtype: int) -> bytes:
    """7-byte MOT header core: BodySize(28) HeaderSize(13) Type(6) Sub(9)."""
    v = (body_size << 28) | (header_size << 15) | (content_type << 9) | subtype
    return v.to_bytes(7, "big")


def parse_header_core(h: bytes) -> tuple[int, int, int, int]:
    v = int.from_bytes(h[:7], "big")
    return v >> 28, (v >> 15) & 0x1FFF, (v >> 9) & 0x3F, v & 0x1FF


def parse_header_params(header: bytes, header_size: int) -> dict[int, bytes]:
    """Header extension parameters after the 7-byte core: {param_id: value}.

    Parameter byte: PLI(2) ParamId(6); PLI 0..2 = fixed 0/1/2/4-byte value,
    PLI 3 = variable (next byte is the length) [K-med].
    """
    params: dict[int, bytes] = {}
    pos = 7
    while pos + 1 <= min(header_size, len(header)):
        pli, pid = header[pos] >> 6, header[pos] & 0x3F
        if pli == 0b11:                         # variable length
            if pos + 2 > len(header):
                break
            plen = header[pos + 1]
            params[pid] = header[pos + 2:pos + 2 + plen]
            pos += 2 + plen
        else:                                   # fixed lengths 0/1/2/4
            plen = (0, 1, 2, 4)[pli]
            params[pid] = header[pos + 1:pos + 1 + plen]
            pos += 1 + plen
    return params


PARAM_CONTENT_NAME = 0x0C


def _content_name(params: dict[int, bytes]) -> str:
    val = params.get(PARAM_CONTENT_NAME, b"")
    return val[1:].decode("latin-1", "replace") if val else ""


# --------------------------------------------- MOT directory (EN 301 234)
def build_mot_directory(entries: list[tuple[int, bytes]],
                        carousel_period_ms: int = 0) -> bytes:
    """Uncompressed MOT directory: the carousel's table of contents.

    ``entries``: (transport_id, full object header) per object.  Layout
    [K-med, docs/INTEROP.md row 20]: rfu(2) DirectorySize(30) |
    NumberOfObjects(16) | DataCarouselPeriod(24) | rfu(3) SegmentSize(13)
    | DirectoryExtensionLength(16) + extension | per object:
    TransportId(16) + header (its own HeaderSize field bounds it).
    """
    body = b"".join((tid & 0xFFFF).to_bytes(2, "big") + hdr
                    for tid, hdr in entries)
    fixed = (len(entries).to_bytes(2, "big")
             + (carousel_period_ms & 0xFFFFFF).to_bytes(3, "big")
             + (0).to_bytes(2, "big")           # SegmentSize: unspecified
             + (0).to_bytes(2, "big"))          # no directory extension
    size = 4 + len(fixed) + len(body)
    return (size & 0x3FFFFFFF).to_bytes(4, "big") + fixed + body


def build_mot_directory_compressed(entries: list[tuple[int, bytes]],
                                   carousel_period_ms: int = 0) -> bytes:
    """Compressed MOT directory entity (data group type 7).

    Layout [K-low — docs/INTEROP.md row 20]: rfu(2) EntitySize(30) |
    CompressionId(8) = 1 (gzip, the only type the TS 101 756 registry
    defines) | gzip stream of the complete UNCOMPRESSED directory entity
    ([[build_mot_directory]]).  Closed-loop exact against our decoder;
    field packing needs a real carousel capture to verify.
    """
    import gzip

    z = gzip.compress(build_mot_directory(entries, carousel_period_ms),
                      mtime=0)
    size = 5 + len(z)
    return ((size & 0x3FFFFFFF).to_bytes(4, "big")
            + bytes([COMPRESSION_GZIP]) + z)


def parse_mot_directory_compressed(data: bytes) -> dict[int, bytes] | None:
    """Type-7 entity -> {transport_id: header}; None if malformed or the
    compression type is unknown."""
    import gzip

    import zlib

    if len(data) < 5 or data[4] != COMPRESSION_GZIP:
        return None
    size = int.from_bytes(data[:4], "big") & 0x3FFFFFFF
    try:
        raw = gzip.decompress(data[5:size])
    except (OSError, EOFError, zlib.error):
        # gzip raises BadGzipFile (OSError) on bad magic, but EOFError on
        # truncation and zlib.error on corrupt deflate data
        return None
    return parse_mot_directory(raw)


def parse_mot_directory(data: bytes) -> dict[int, bytes] | None:
    """Directory bytes -> {transport_id: object header}; None if malformed."""
    if len(data) < 13:
        return None
    size = int.from_bytes(data[:4], "big") & 0x3FFFFFFF
    n_objects = int.from_bytes(data[4:6], "big")
    ext_len = int.from_bytes(data[11:13], "big")
    pos = 13 + ext_len
    out: dict[int, bytes] = {}
    for _ in range(n_objects):
        if pos + 9 > min(size, len(data)):
            return None
        tid = int.from_bytes(data[pos:pos + 2], "big")
        _, header_size, _, _ = parse_header_core(data[pos + 2:pos + 9])
        if header_size < 7 or pos + 2 + header_size > len(data):
            return None
        out[tid] = data[pos + 2:pos + 2 + header_size]
        pos += 2 + header_size
    return out


def mot_segments(data: bytes, seg_size: int) -> list[bytes]:
    """Split into MOT segments, each prefixed RepCount(3)=0 SegSize(13)."""
    out = []
    for i in range(0, max(len(data), 1), seg_size):
        chunk = data[i:i + seg_size]
        out.append(len(chunk).to_bytes(2, "big") + chunk)
    return out


@dataclasses.dataclass
class MotObject:
    transport_id: int
    content_type: int
    subtype: int
    name: str
    body: bytes


class MotEncoder:
    """Slideshow fixture: image bytes -> X-PAD subfields [(apptype, data)].

    ``subfield_size`` must be a contents-indicator length (the X-PAD layer
    transmits subfields at exactly CI sizes): non-final chunks of a data
    group then arrive unpadded, and the final chunk's CI padding is
    stripped by the receiver via the data group length indicator.
    """

    def __init__(self, seg_size: int = 32, subfield_size: int = 48):
        from dabtools_tpu_torch.eti.pad import CI_LENGTHS
        if subfield_size not in CI_LENGTHS:
            raise ValueError(f"subfield_size must be one of {CI_LENGTHS}")
        self.seg_size = seg_size
        self.subfield_size = subfield_size
        self._continuity = 0
        self._tid = 0

    def object_groups(self, body: bytes, name: str = "slide.jpg",
                      subtype: int = SUBTYPE_JFIF) -> list[bytes]:
        """HEADER-mode data groups for one object (type 3 + type 4s) —
        the transport-agnostic form (X-PAD via ``object_subfields``,
        packet mode via ``eti.packet.PacketEncoder.add_data_group``)."""
        self._tid = (self._tid + 1) & 0xFFFF
        header = self._make_header(body, name, subtype)
        groups = []
        for dg_type, data in ((DG_TYPE_MOT_HEADER, header),
                              (DG_TYPE_MOT_BODY, body)):
            segs = mot_segments(data, self.seg_size)
            for i, seg in enumerate(segs):
                groups.append(build_data_group(
                    dg_type, self._continuity, i, i == len(segs) - 1,
                    self._tid, seg))
                self._continuity = (self._continuity + 1) & 0x0F
        return groups

    def object_subfields(self, body: bytes, name: str = "slide.jpg",
                         subtype: int = SUBTYPE_JFIF) -> list[tuple[int, bytes]]:
        return self._groups_to_subfields(
            self.object_groups(body, name, subtype))

    def _make_header(self, body: bytes, name: str, subtype: int) -> bytes:
        """Header core + ContentName parameter (0x0C, charset 0) [K-med]."""
        nm = name.encode("latin-1")[:63]
        param = bytes([0xCC, len(nm) + 1, 0]) + nm
        return mot_header_core(len(body), 7 + len(param),
                               CONTENT_IMAGE, subtype) + param

    def carousel_groups(
            self, objects: list[tuple[str, bytes]],
            carousel_period_ms: int = 0,
            compress: bool = False) -> list[bytes]:
        """DIRECTORY-mode carousel (EN 301 234 s6) as raw data groups: one
        type-6 directory group carries every object's header; bodies
        follow as type-4 groups keyed by transport id.  ``objects``:
        (name, body) pairs.  ``compress=True`` sends the TOC as a type-7
        gzip'd directory."""
        entries = []
        body_groups = []
        for name, body in objects:
            self._tid = (self._tid + 1) & 0xFFFF
            subtype = SUBTYPE_PNG if name.lower().endswith(".png") \
                else SUBTYPE_JFIF
            entries.append((self._tid, self._make_header(body, name, subtype)))
            segs = mot_segments(body, self.seg_size)
            for i, seg in enumerate(segs):
                body_groups.append(build_data_group(
                    DG_TYPE_MOT_BODY, self._continuity, i,
                    i == len(segs) - 1, self._tid, seg))
                self._continuity = (self._continuity + 1) & 0x0F
        if compress:
            directory = build_mot_directory_compressed(entries,
                                                       carousel_period_ms)
            dir_type = DG_TYPE_MOT_DIRECTORY_Z
        else:
            directory = build_mot_directory(entries, carousel_period_ms)
            dir_type = DG_TYPE_MOT_DIRECTORY
        self._tid = (self._tid + 1) & 0xFFFF
        dir_segs = mot_segments(directory, self.seg_size)
        dir_groups = [build_data_group(
            dir_type, (self._continuity + i) & 0x0F, i,
            i == len(dir_segs) - 1, self._tid, seg)
            for i, seg in enumerate(dir_segs)]
        self._continuity = (self._continuity + len(dir_segs)) & 0x0F
        return dir_groups + body_groups

    def carousel_subfields(
            self, objects: list[tuple[str, bytes]],
            carousel_period_ms: int = 0,
            compress: bool = False) -> list[tuple[int, bytes]]:
        """X-PAD form of :meth:`carousel_groups`."""
        return self._groups_to_subfields(
            self.carousel_groups(objects, carousel_period_ms, compress))

    def _groups_to_subfields(self, groups) -> list[tuple[int, bytes]]:
        """Data groups -> DGLI + apptype-12/13 subfields."""
        out = []
        for g in groups:
            out.append((APP_DGLI, dgli(len(g))))
            for j in range(0, len(g), self.subfield_size):
                out.append((APP_MOT_START if j == 0 else APP_MOT_CONT,
                            g[j:j + self.subfield_size]))
        return out


class MotDecoder:
    """X-PAD MOT subfields -> complete MotObjects (slideshow images)."""

    def __init__(self):
        self._dg = bytearray()
        self._in_dg = False
        self._dg_len: int | None = None
        self._next_len: int | None = None
        self._headers: dict[int, dict[int, bytes]] = {}
        self._bodies: dict[int, dict[int, bytes]] = {}
        self._dirs: dict[int, dict[int, bytes]] = {}
        self._last_seg: dict[tuple[int, int], int] = {}
        # Directory mode (EN 301 234 s6): current carousel TOC, and the
        # caching model — an object is re-emitted only when its directory
        # header changes, not on every carousel repetition.
        self._directory: dict[int, bytes] = {}
        self._emitted: dict[int, bytes] = {}
        self.stats = {"data_groups": 0, "crc_failures": 0, "objects": 0,
                      "directories": 0}

    def feed(self, apptype: int, data: bytes) -> list[MotObject]:
        out = []
        if apptype == APP_DGLI:
            self._next_len = parse_dgli(data)
        elif apptype == APP_MOT_START:
            if self._in_dg:             # previous group ends at the next start
                out = self._finish()
            self._dg = bytearray(data)
            self._dg_len = self._next_len
            self._next_len = None
            self._in_dg = True
        elif apptype == APP_MOT_CONT and self._in_dg:
            self._dg += data
        # A complete group need not wait for the next start marker.
        if (self._in_dg and self._dg_len is not None
                and len(self._dg) >= self._dg_len):
            out += self._finish()
        return out

    def flush(self) -> list[MotObject]:
        """Close any pending data group and return newly-completed objects."""
        return self._finish() if self._in_dg else []

    def feed_data_group(self, raw: bytes) -> list[MotObject]:
        """One complete MSC data group (packet-mode transport: already
        reassembled by :class:`dabtools_tpu.eti.packet.PacketDecoder`,
        so no X-PAD subfield/DGLI framing applies)."""
        out = self._finish() if self._in_dg else []
        self._dg = bytearray(raw)
        self._dg_len = len(raw)
        self._in_dg = True
        return out + self._finish()

    @staticmethod
    def _dg_length(raw: bytes) -> int | None:
        """Expected MOT data-group byte length from its own headers."""
        if len(raw) < 9:
            return None
        pos = 2 + (2 if raw[0] >> 7 else 0)
        pos += 2                                  # session header
        ua = raw[pos]
        pos += 1 + (ua & 0x0F)
        if pos + 2 > len(raw):
            return None
        seg_size = int.from_bytes(raw[pos:pos + 2], "big") & 0x1FFF
        return pos + 2 + seg_size + 2             # + segment + CRC

    def _finish(self) -> list[MotObject]:
        self._in_dg = False
        # The subfields are padded to CI sizes: trim to the length the
        # group's own headers imply (fallback: scan back for a valid CRC).
        raw = bytes(self._dg)
        n = self._dg_len if self._dg_len is not None else self._dg_length(raw)
        self._dg_len = None
        dg = parse_data_group(raw[:n]) if n and n <= len(raw) else None
        if dg is None and raw and raw[0] >> 6 & 1:
            # Guess-the-end fallback is only safe for groups that carry a
            # CRC: without one, ANY truncation of corrupt bytes "parses"
            # and garbage would be accepted as valid segments.
            for end in range(len(raw), 3, -1):
                dg = parse_data_group(raw[:end])
                if dg is not None:
                    break
        self.stats["data_groups"] += 1
        if dg is None or dg.transport_id is None:
            self.stats["crc_failures"] += 1
            return []
        seg = dg.payload[2:2 + (int.from_bytes(dg.payload[:2], "big")
                                & 0x1FFF)]
        if dg.dg_type == DG_TYPE_MOT_HEADER:
            store, types = self._headers, (DG_TYPE_MOT_HEADER,)
        elif dg.dg_type == DG_TYPE_MOT_BODY:
            store, types = self._bodies, (DG_TYPE_MOT_BODY,)
        elif dg.dg_type in (DG_TYPE_MOT_DIRECTORY, DG_TYPE_MOT_DIRECTORY_Z):
            store, types = self._dirs, (DG_TYPE_MOT_DIRECTORY,
                                        DG_TYPE_MOT_DIRECTORY_Z)
        else:
            return []
        store.setdefault(dg.transport_id, {})[dg.segment] = seg
        if dg.last:
            self._last_seg[(dg.dg_type, dg.transport_id)] = dg.segment
        # Bound memory on 24/7 reception: header-mode transfers whose last
        # segment is lost would otherwise accumulate forever (rotating
        # transport ids on a lossy signal).  Evict the stalest transfer
        # (dict order = first touched), never the one just fed.
        if len(store) > MAX_PENDING_TRANSFERS:
            victim = next(t for t in store if t != dg.transport_id)
            del store[victim]
            for k in types:
                self._last_seg.pop((k, victim), None)
        if dg.dg_type in (DG_TYPE_MOT_DIRECTORY, DG_TYPE_MOT_DIRECTORY_Z):
            return self._try_directory(dg.transport_id, dg.dg_type)
        return self._try_complete(dg.transport_id)

    def _try_directory(self, tid: int, dg_type: int) -> list[MotObject]:
        """Assemble + adopt a completed type-6/7 directory, then re-check
        every pending body against the new table of contents."""
        last = self._last_seg.get((dg_type, tid))
        if last is None:
            return []
        raw = self._assemble(self._dirs.get(tid, {}), last)
        if raw is None:
            return []
        directory = (parse_mot_directory_compressed(raw)
                     if dg_type == DG_TYPE_MOT_DIRECTORY_Z
                     else parse_mot_directory(raw))
        self._dirs.pop(tid, None)
        self._last_seg.pop((dg_type, tid), None)
        if directory is None:
            self.stats["crc_failures"] += 1
            return []
        self.stats["directories"] += 1
        self._directory = directory
        # Caching model: forget emitted objects no longer in the carousel.
        self._emitted = {t: h for t, h in self._emitted.items()
                         if directory.get(t) == h}
        # Bound memory on 24/7 carousels with rotating transport ids:
        # bodies whose tid is in neither the new TOC nor an in-flight
        # header-mode transfer can never complete — drop them.
        for t in [t for t in self._bodies
                  if t not in directory and t not in self._headers]:
            del self._bodies[t]
            self._last_seg.pop((DG_TYPE_MOT_BODY, t), None)
        out = []
        for t in list(self._bodies):
            out += self._try_complete(t)
        return out

    def _assemble(self, parts: dict[int, bytes], last: int) -> bytes | None:
        if any(i not in parts for i in range(last + 1)):
            return None
        return b"".join(parts[i] for i in range(last + 1))

    def _try_complete(self, tid: int) -> list[MotObject]:
        bl = self._last_seg.get((DG_TYPE_MOT_BODY, tid))
        if bl is None:
            return []
        # Header-mode (type-3 data groups) takes priority; the directory
        # TOC covers objects whose headers ride in the type-6 directory.
        hl = self._last_seg.get((DG_TYPE_MOT_HEADER, tid))
        if hl is not None:
            header = self._assemble(self._headers.get(tid, {}), hl)
        else:
            header = self._directory.get(tid)
            if header is not None and self._emitted.get(tid) == header:
                # Caching model: already delivered this version — drop the
                # repetition's segments so the carousel can't grow memory.
                self._bodies.pop(tid, None)
                self._last_seg.pop((DG_TYPE_MOT_BODY, tid), None)
                return []
        body = self._assemble(self._bodies.get(tid, {}), bl)
        if header is None or body is None:
            return []
        body_size, header_size, ctype, subtype = parse_header_core(header)
        if body_size != len(body):
            return []                   # incomplete/inconsistent: keep waiting
        name = _content_name(parse_header_params(header, header_size))
        self._headers.pop(tid, None)
        self._bodies.pop(tid, None)
        self._last_seg.pop((DG_TYPE_MOT_HEADER, tid), None)
        self._last_seg.pop((DG_TYPE_MOT_BODY, tid), None)
        if hl is None:
            self._emitted[tid] = header
        self.stats["objects"] += 1
        return [MotObject(transport_id=tid, content_type=ctype,
                          subtype=subtype, name=name, body=body)]

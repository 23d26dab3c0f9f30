"""Programme-Associated Data: F-PAD / X-PAD transport + dynamic label (DLS).

EN 300 401 s7.4: every DAB audio frame carries a 2-byte F-PAD at its end;
an optional X-PAD field sits immediately before the scale-factor CRC and
carries typed "data subfields" (here: the dynamic label, application
types 2/3).  In DAB+ (TS 102 563 s5.4.3) the same X-PAD+F-PAD bytes ride
inside each access unit as an AAC data_stream_element at the AU start.

The reference has no PAD handling at all (`upstream:eti2mpa.c` dumps the
raw MP2 stream, SURVEY.md s2a R17); this module is part of the "complete
receiver toolset" widening.  Both directions are implemented — the
encoder is the closed-loop test fixture, mirroring the modulator strategy
(SURVEY.md s4 item 1).

Interop caveats (all verified closed-loop only; listed in
docs/INTEROP.md for when a real capture is available):
  * [K-med] X-PAD bytes are stored in reverse order at the frame tail
    (logical byte 0 nearest the ScF-CRC).
  * [K-low] exact F-PAD bit layout (we use: byte0 = type<<6 | xpad_ind<<4,
    byte1 = CI-flag<<1) and the non-first DLS prefix nibble placement.
  * [K-low] ScF-CRC field length (4 bytes at 48 kHz, 2 at 24 kHz).
"""

from __future__ import annotations

import dataclasses
import logging

from dabtools_tpu_torch.utils.crc import crc16_ccitt

log = logging.getLogger("dabtools_tpu.pad")

# X-PAD indicator values in F-PAD (EN 300 401 s7.4.2) [K-med]
XPAD_NONE = 0b00
XPAD_SHORT = 0b01      # fixed 4-byte X-PAD (not emitted here)
XPAD_VARIABLE = 0b10

# X-PAD application types (EN 300 401 table: AppTy) [K-med]
APP_END_MARKER = 0      # terminates the contents-indicator list
APP_DLS_START = 2       # dynamic label segment, start of data group
APP_DLS_CONT = 3        # dynamic label segment, continuation

# Contents-indicator length index -> subfield bytes (EN 300 401 s7.4.3)
CI_LENGTHS = (4, 6, 8, 12, 16, 24, 32, 48)

DLS_MAX_SEGMENT_CHARS = 16
DLS_MAX_SEGMENTS = 8            # label <= 128 characters


def scf_crc_len(sample_rate_hz: int = 48000) -> int:
    """Scale-factor-CRC field size preceding F-PAD [K-low]."""
    return 2 if sample_rate_hz == 24000 else 4


# --------------------------------------------------------------- DLS groups
def dls_data_groups(label: str, toggle: int, charset: int = 0) -> list[bytes]:
    """Segment a label into DLS data groups (prefix + chars + CRC16).

    EN 300 401 s7.4.5.2: each group holds <= 16 characters; prefix byte 0 =
    Toggle|First|Last|C|Field1 (C=0, Field1 = nchars-1); prefix byte 1 =
    charset<<4 (first segment) or segnum<<4 (continuations) [K-low]; CRC-16
    is the FIB convention (CCITT, init all-ones, inverted).
    """
    raw = label.encode("latin-1", "replace")[: DLS_MAX_SEGMENTS *
                                             DLS_MAX_SEGMENT_CHARS]
    if not raw:
        # A zero-char segment is not representable (Field1 = nchars-1):
        # the receiver's CRC window would be one byte off and every
        # group rejected.  Clearing the display is a command, not a label.
        raise ValueError(
            "DLS labels cannot be empty; use dls_clear_command() to "
            "clear the display")
    chunks = [raw[i:i + DLS_MAX_SEGMENT_CHARS]
              for i in range(0, len(raw), DLS_MAX_SEGMENT_CHARS)]
    groups = []
    for seg, chunk in enumerate(chunks):
        first = seg == 0
        last = seg == len(chunks) - 1
        b0 = ((toggle & 1) << 7 | first << 6 | last << 5 | 0 << 4
              | (len(chunk) - 1))
        b1 = (charset << 4) if first else (seg << 4)
        body = bytes([b0, b1]) + chunk
        groups.append(body + crc16_ccitt(body).to_bytes(2, "big"))
    return groups


DLS_CMD_CLEAR = 0b0001
DLS_CMD_DL_PLUS = 0b0010       # TS 102 980: DL Plus tags command


def dls_clear_command(toggle: int) -> bytes:
    """The 'clear display' DLS command group (C=1, command 0b0001)."""
    body = bytes([(toggle & 1) << 7 | 1 << 6 | 1 << 5 | 1 << 4 | 0b0001, 0])
    return body + crc16_ccitt(body).to_bytes(2, "big")


def dlplus_command(tags: list[tuple[int, int, int]], toggle: int,
                   item_toggle: bool = False, item_running: bool = False,
                   link: int = 0) -> bytes:
    """DL Plus tags command group (TS 102 980 s5) [K-med; prefix byte 1
    layout K-low — link(1) rfa(3) body-length-1(4)].

    ``tags``: up to 4 of (content type, start char, length chars), each
    marking a substring of the CURRENT dynamic label (e.g. the artist
    inside "artist - title").  Body: CId(4)=0 IT(1) IR(1) NT(2), then
    3 bytes per tag: CT(8) start(8) length-1(8) (the 7-bit fields ride
    in full bytes; top bits rfa=0).
    """
    if not 1 <= len(tags) <= 4:
        raise ValueError("DL Plus carries 1..4 tags per command")
    body = bytearray([0 << 4 | (1 if item_toggle else 0) << 3
                      | (1 if item_running else 0) << 2 | (len(tags) - 1)])
    for ct, start, length in tags:
        if not (0 <= ct < 128 and 0 <= start < 128 and 1 <= length <= 128):
            raise ValueError("DL Plus tag fields are 7-bit "
                             "(length stored as length-1)")
        body += bytes([ct, start, length - 1])
    b0 = ((toggle & 1) << 7 | 1 << 6 | 1 << 5 | 1 << 4 | DLS_CMD_DL_PLUS)
    b1 = (link & 1) << 7 | (len(body) - 1)
    g = bytes([b0, b1]) + bytes(body)
    return g + crc16_ccitt(g).to_bytes(2, "big")


@dataclasses.dataclass
class DynamicLabel:
    text: str
    charset: int
    toggle: int


@dataclasses.dataclass
class DlPlusTag:
    content_type: int              # TS 102 980 annex A id
    text: str                      # resolved against the current label


@dataclasses.dataclass
class DlPlusInfo:
    item_toggle: bool
    item_running: bool
    tags: tuple[DlPlusTag, ...]


class DlsDecoder:
    """Reassemble DLS data groups from X-PAD subfields into labels.

    Subfields arrive via :meth:`feed` tagged start/continuation; a group is
    complete when its CRC checks; a *label* is complete when segments
    first..last of one toggle phase have all arrived.
    """

    def __init__(self):
        self._group = bytearray()
        self._in_group = False
        self._segments: dict[int, bytes] = {}
        self._charset = 0
        self._toggle = None
        self._last_seg = None
        self._text = ""                # last complete label (DL+ anchor)
        self.dlplus: list[DlPlusInfo] = []   # drained by PadDecoder/CLI
        self.stats = {"groups": 0, "crc_failures": 0, "labels": 0,
                      "commands": 0, "dlplus_commands": 0,
                      "dlplus_orphans": 0}

    def feed(self, data: bytes, start: bool) -> list[DynamicLabel]:
        if start:
            self._group = bytearray()
            self._in_group = True
        elif not self._in_group:
            return []
        self._group += data
        # Group length is known from its prefix once 2 bytes are in.
        if len(self._group) < 4:
            return []
        b0 = self._group[0]
        is_cmd = (b0 >> 4) & 1
        if is_cmd:
            # DL Plus commands carry a body sized by prefix byte 1 [K-low]
            extra = ((self._group[1] & 0x0F) + 1
                     if b0 & 0x0F == DLS_CMD_DL_PLUS else 0)
            nbody = 2 + extra
        else:
            nbody = 2 + (b0 & 0x0F) + 1
        if len(self._group) < nbody + 2:
            return []
        group = bytes(self._group[: nbody + 2])
        self._in_group = False
        self.stats["groups"] += 1
        if crc16_ccitt(group[:-2]) != int.from_bytes(group[-2:], "big"):
            self.stats["crc_failures"] += 1
            return []
        return self._take_group(group[:-2])

    def _take_group(self, g: bytes) -> list[DynamicLabel]:
        b0, b1 = g[0], g[1]
        toggle, first, last, cmd = b0 >> 7, b0 >> 6 & 1, b0 >> 5 & 1, b0 >> 4 & 1
        if cmd:
            self.stats["commands"] += 1
            code = b0 & 0x0F
            if code == DLS_CMD_CLEAR:
                self._segments.clear()
                self._toggle = None
                self._text = ""
            elif code == DLS_CMD_DL_PLUS:
                self._take_dlplus(g[2:])
            return []
        if toggle != self._toggle:       # new label transmission begins
            self._segments.clear()
            self._last_seg = None
            self._toggle = toggle
        seg = 0 if first else b1 >> 4
        if first:
            self._charset = b1 >> 4
        self._segments[seg] = g[2:]
        if last:
            self._last_seg = seg
        if (self._last_seg is not None
                and all(i in self._segments
                        for i in range(self._last_seg + 1))):
            text = b"".join(self._segments[i]
                            for i in range(self._last_seg + 1))
            self._segments.clear()
            self._last_seg = None
            self.stats["labels"] += 1
            self._text = text.decode("latin-1")
            return [DynamicLabel(self._text, self._charset, toggle)]
        return []

    def _take_dlplus(self, body: bytes) -> None:
        """Resolve a DL Plus tags command against the current label."""
        if not body or body[0] >> 4 != 0:    # CId 0 = DL Plus tags
            return
        if not self._text:
            self.stats["dlplus_orphans"] += 1   # no label yet to index
            return
        item_toggle = bool(body[0] >> 3 & 1)
        item_running = bool(body[0] >> 2 & 1)
        n_tags = (body[0] & 0x03) + 1
        if len(body) < 1 + 3 * n_tags:
            return
        tags = []
        for i in range(n_tags):
            ct = body[1 + 3 * i] & 0x7F
            start = body[2 + 3 * i] & 0x7F
            length = (body[3 + 3 * i] & 0x7F) + 1
            if start >= len(self._text):
                continue                     # stale tag for another label
            tags.append(DlPlusTag(ct, self._text[start:start + length]))
        self.stats["dlplus_commands"] += 1
        self.dlplus.append(DlPlusInfo(item_toggle, item_running,
                                      tuple(tags)))


# ------------------------------------------------------------ X-PAD framing
def build_xpad(subfields: list[tuple[int, bytes]]) -> tuple[bytes, bytes]:
    """Subfields [(apptype, data)] -> (xpad_bytes_logical, fpad 2 bytes).

    Emits a variable-size X-PAD: CI list (length index + apptype, closed by
    an end marker when fewer than 4 CIs), then the data subfields padded to
    their CI length.  Returns the *logical* byte order; the MP2 framer
    reverses it into the frame tail.
    """
    if len(subfields) > 4:
        raise ValueError("at most 4 X-PAD subfields per frame")
    if not subfields:
        return b"", bytes([0, 0])
    cis, payload = bytearray(), bytearray()
    for apptype, data in subfields:
        li = next(i for i, n in enumerate(CI_LENGTHS) if n >= len(data))
        cis.append(li << 5 | apptype)
        payload += data.ljust(CI_LENGTHS[li], b"\x00")
    if len(subfields) < 4:
        cis.append(APP_END_MARKER)
    fpad = bytes([XPAD_VARIABLE << 4, 1 << 1])    # CI flag set [K-low]
    return bytes(cis) + bytes(payload), fpad


def parse_xpad(xpad: bytes, fpad: bytes) -> list[tuple[int, bytes]]:
    """Inverse of :func:`build_xpad` -> [(apptype, data)] (padded lengths)."""
    if len(fpad) != 2 or (fpad[0] >> 4) & 0b11 != XPAD_VARIABLE:
        return []
    if not (fpad[1] >> 1) & 1:
        return []                       # CI-less frames not emitted by us
    cis, pos = [], 0
    while pos < min(4, len(xpad)) and xpad[pos] & 0x1F != APP_END_MARKER:
        cis.append((CI_LENGTHS[xpad[pos] >> 5], xpad[pos] & 0x1F))
        pos += 1
    if pos < 4:
        pos += 1                        # skip the end marker
    out = []
    for n, apptype in cis:
        out.append((apptype, xpad[pos:pos + n]))
        pos += n
    return out


# ----------------------------------------------------------- MP2 frame tail
def attach_pad_mp2(frame: bytearray, xpad: bytes, fpad: bytes,
                   sample_rate_hz: int = 48000) -> None:
    """Write [reversed X-PAD][ScF-CRC (untouched)][F-PAD] into an MP2
    frame tail in place (frame length = bitrate_kbps * 3 bytes)."""
    scf = scf_crc_len(sample_rate_hz)
    if len(xpad) + scf + 2 > len(frame):
        raise ValueError("X-PAD larger than audio frame")
    frame[-2:] = fpad
    if xpad:
        frame[-(2 + scf + len(xpad)): -(2 + scf)] = xpad[::-1]


def extract_pad_mp2(frame: bytes, sample_rate_hz: int = 48000,
                    max_xpad: int = 196) -> tuple[bytes, bytes]:
    """MP2 frame -> (logical xpad bytes, fpad).  The X-PAD length is not
    signalled; return up to ``max_xpad`` reversed tail bytes — the CI list
    bounds the parse (EN 300 401 leaves sizing to the CIs) [K-med]."""
    scf = scf_crc_len(sample_rate_hz)
    fpad = frame[-2:]
    if (fpad[0] >> 4) & 0b11 != XPAD_VARIABLE:
        return b"", fpad
    n = min(max_xpad, len(frame) - scf - 2)
    region = frame[-(2 + scf + n): -(2 + scf)]
    return region[::-1], fpad


# ------------------------------------------------------------ DAB+ AU DSE
def wrap_pad_dse(xpad: bytes, fpad: bytes) -> bytes:
    """PAD bytes -> AAC data_stream_element placed at the AU start
    (TS 102 563 s5.4.3: id_syn_ele=ID_DSE(0b100), instance tag 0,
    byte-aligned; payload = [xpad][fpad]) [K-med]."""
    payload = xpad + fpad
    count = len(payload)
    if count >= 255 + 254:
        raise ValueError("PAD too large for one DSE")
    head = bytes([0b100_0000_1])        # DSE, tag 0, align flag set
    if count < 255:
        return head + bytes([count]) + payload
    return head + bytes([255, count - 255]) + payload


def unwrap_pad_dse(au: bytes) -> tuple[bytes, bytes] | None:
    """AU -> (xpad, fpad) if it starts with a PAD DSE, else None."""
    if len(au) < 4 or au[0] != 0b100_0000_1:
        return None
    count, pos = au[1], 2
    if count == 255:
        count += au[2]
        pos = 3
    payload = au[pos:pos + count]
    if len(payload) < 2:
        return None
    return payload[:-2], payload[-2:]


class PadDecoder:
    """Per-service PAD pipeline: frames/AUs in, dynamic labels out.

    With ``mot=True`` also reassembles MOT slideshow objects
    ([[eti/mot.py]]); collect them from :attr:`objects` after feeding.
    """

    def __init__(self, mot: bool = False):
        self.dls = DlsDecoder()
        self.mot = None
        self.objects = []
        if mot:
            from dabtools_tpu_torch.eti.mot import MotDecoder
            self.mot = MotDecoder()

    def feed_pad(self, xpad: bytes, fpad: bytes) -> list[DynamicLabel]:
        from dabtools_tpu_torch.eti.mot import APP_DGLI, APP_MOT_CONT, APP_MOT_START
        out = []
        for apptype, data in parse_xpad(xpad, fpad):
            if apptype in (APP_DLS_START, APP_DLS_CONT):
                out += self.dls.feed(data, apptype == APP_DLS_START)
            elif self.mot is not None and apptype in (APP_DGLI,
                                                      APP_MOT_START,
                                                      APP_MOT_CONT):
                self.objects += self.mot.feed(apptype, data)
        return out

    def flush(self) -> None:
        if self.mot is not None:
            self.objects += self.mot.flush()

    def take_dlplus(self) -> list[DlPlusInfo]:
        """Drain DL Plus tag sets decoded since the last call."""
        out, self.dls.dlplus = self.dls.dlplus, []
        return out

    def feed_mp2_frame(self, frame: bytes,
                       sample_rate_hz: int = 48000) -> list[DynamicLabel]:
        return self.feed_pad(*extract_pad_mp2(frame, sample_rate_hz))

    def feed_dabplus_au(self, au: bytes) -> list[DynamicLabel]:
        pad = unwrap_pad_dse(au)
        return self.feed_pad(*pad) if pad else []

"""MPEG Audio Layer II frame-header parsing and stream health checks.

DAB audio (EN 300 401 s7) is MPEG-1 Layer II at 48 kHz or MPEG-2 LSF
Layer II at 24 kHz, one audio frame per 24 ms logical frame (resp. per
48 ms), so the elementary stream's headers are a strong self-check on an
extraction: the syncword must land on every logical-frame boundary and
bitrate/sample-rate must match the sub-channel's signalled capacity.
`eti2audio --verify` uses this as an etisnoop-style audio health report;
the reference tool chain had nothing comparable (validation was "listen
to it").

This is a header parser only — audio *decoding* stays out of scope, like
the reference's `eti2mpa` (extraction ends at the elementary stream).
"""

from __future__ import annotations

import dataclasses

# (MPEG-1, MPEG-2 LSF) Layer II bitrate tables, kbit/s; index 0 = free.
_BITRATES_V1 = (0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256,
                320, 384, 0)
_BITRATES_V2 = (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144,
                160, 0)
_RATES_V1 = (44100, 48000, 32000, 0)
_RATES_V2 = (22050, 24000, 16000, 0)
_MODES = ("stereo", "joint_stereo", "dual_channel", "mono")


@dataclasses.dataclass(frozen=True)
class Mp2Header:
    version: int          # 1 = MPEG-1, 2 = MPEG-2 LSF
    bitrate_kbps: int
    sample_rate: int
    mode: str
    protected: bool       # CRC-16 present after the header
    padding: bool
    frame_bytes: int      # header-inclusive frame length


def parse_mp2_header(b: bytes, off: int = 0) -> Mp2Header | None:
    """Parse a Layer II header at ``b[off:]``; None if not a valid one."""
    if len(b) - off < 4:
        return None
    h = int.from_bytes(b[off:off + 4], "big")
    if (h >> 21) & 0x7FF != 0x7FF:            # syncword
        return None
    version_id = (h >> 19) & 0x3              # 3 = MPEG-1, 2 = MPEG-2 LSF
    layer = (h >> 17) & 0x3                   # 2 = Layer II
    if layer != 2 or version_id not in (2, 3):
        return None
    v1 = version_id == 3
    bitrate = (_BITRATES_V1 if v1 else _BITRATES_V2)[(h >> 12) & 0xF]
    rate = (_RATES_V1 if v1 else _RATES_V2)[(h >> 10) & 0x3]
    if not bitrate or not rate:
        return None
    padding = bool((h >> 9) & 1)
    frame_bytes = 144 * bitrate * 1000 // rate + padding
    return Mp2Header(
        version=1 if v1 else 2,
        bitrate_kbps=bitrate,
        sample_rate=rate,
        mode=_MODES[(h >> 6) & 0x3],
        protected=not ((h >> 16) & 1),
        padding=padding,
        frame_bytes=frame_bytes,
    )


def build_mp2_header(bitrate_kbps: int, sample_rate: int = 48000,
                     mode: str = "stereo") -> bytes | None:
    """A valid 4-byte Layer II header for a DAB sub-channel's rate, or
    None if the rate has no Layer II index (then leave bytes alone).

    Used by dabmux's filler audio source so generated streams carry
    real, self-consistent MP2 framing (one header per 24 ms logical
    frame at 48 kHz — frame length 3*bitrate_kbps bytes exactly).
    Marked unprotected: the filler carries no real CRC.
    """
    v1 = sample_rate in _RATES_V1
    table = _BITRATES_V1 if v1 else _BITRATES_V2
    rates = _RATES_V1 if v1 else _RATES_V2
    if bitrate_kbps not in table[1:] or sample_rate not in rates:
        return None
    h = (0x7FF << 21) | ((3 if v1 else 2) << 19) | (2 << 17) | (1 << 16)
    h |= table.index(bitrate_kbps) << 12
    h |= rates.index(sample_rate) << 10
    h |= _MODES.index(mode) << 6
    return h.to_bytes(4, "big")


class Mp2HealthChecker:
    """Streaming elementary-stream health: feed extracted MP2 bytes,
    read ``stats`` at the end.

    Checks: syncword cadence (every header's frame_bytes must land on
    the next header), header consistency (bitrate/rate/mode constant —
    DAB sub-channels are CBR by construction), and DAB plausibility
    (48 kHz MPEG-1 or 24 kHz MPEG-2 LSF).
    """

    def __init__(self):
        self._buf = bytearray()
        self._expect: Mp2Header | None = None
        self.stats = {"frames": 0, "bytes": 0, "resyncs": 0,
                      "header_changes": 0, "bitrate_kbps": None,
                      "sample_rate": None, "mode": None, "dab_legal": None}

    def feed(self, data: bytes) -> None:
        self._buf += data
        self.stats["bytes"] += len(data)
        while True:
            if len(self._buf) < 4:
                return               # too short to judge — wait, don't drop
            hdr = parse_mp2_header(self._buf)
            if hdr is None:
                # hunt for the next syncword (lost alignment)
                pos = self._buf.find(b"\xff", 1)
                if pos < 0:
                    self._buf.clear()
                    return
                if len(self._buf) - pos < 4:
                    # candidate header straddles the chunk boundary: keep
                    # it pending (discarding here corrupted the verdict
                    # for callers feeding <4-byte-aligned chunks)
                    del self._buf[:pos]
                    return
                if parse_mp2_header(self._buf, pos) is None:
                    del self._buf[:pos + 1]
                    continue
                del self._buf[:pos]
                self.stats["resyncs"] += 1
                continue
            if len(self._buf) < hdr.frame_bytes:
                return
            self._note(hdr)
            del self._buf[:hdr.frame_bytes]

    def _note(self, hdr: Mp2Header) -> None:
        s = self.stats
        s["frames"] += 1
        key = (hdr.bitrate_kbps, hdr.sample_rate, hdr.mode)
        if self._expect is not None and key != (
                self._expect.bitrate_kbps, self._expect.sample_rate,
                self._expect.mode):
            s["header_changes"] += 1
        self._expect = hdr
        s["bitrate_kbps"] = hdr.bitrate_kbps
        s["sample_rate"] = hdr.sample_rate
        s["mode"] = hdr.mode
        s["dab_legal"] = (hdr.version == 1 and hdr.sample_rate == 48000
                          ) or (hdr.version == 2
                                and hdr.sample_rate == 24000)

    def summary(self) -> str:
        s = self.stats
        if not s["frames"]:
            return f"no MP2 frames found in {s['bytes']} bytes"
        flags = []
        if s["resyncs"]:
            flags.append(f"{s['resyncs']} resyncs")
        if s["header_changes"]:
            flags.append(f"{s['header_changes']} header changes")
        if not s["dab_legal"]:
            flags.append("non-DAB rate/version")
        return (f"{s['frames']} MP2 frames, {s['bitrate_kbps']} kbit/s "
                f"{s['sample_rate']} Hz {s['mode']}"
                + (f" [{', '.join(flags)}]" if flags else " [healthy]"))

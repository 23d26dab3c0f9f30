"""DAB+ audio superframe path (N12; ETSI TS 102 563).

Absent from the reference (`eti2mpa` is MP2-only, SURVEY.md s2a) but
mandated by BASELINE config #2.  Takes the sub-channel logical-frame bytes
coming out of ETI (or straight from the receiver) and produces the HE-AAC
access units:

  5 x 24 ms logical frames -> 120-row x (bitrate/8)-column table, RS(120,110)
  per column (interleaved byte-wise in transmission order) -> superframe
  header (firecode-protected) -> AU start table -> AUs (each CRC16-checked).

Also includes the *builder* (the transmit direction) as the closed-loop
test fixture, and an optional ADTS wrapper for playback tooling (NB: DAB+
AAC uses 960-sample frames; players must support them).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.ops.rs import rs_decode_batch
from dabtools_tpu_torch.utils.crc import crc16_ccitt, firecode
from dabtools_tpu_torch.utils.gf256 import rs_encode

log = logging.getLogger("dabtools_tpu.dabplus")


def _rs_decode_columns(table: np.ndarray):
    """RS-decode a superframe's columns: ``table`` (n_cols, 120) uint8 ->
    (data (n_cols, 110) uint8, counts (n_cols,) int32), NumPy arrays.

    The batched decoder (`ops.rs`) runs on the CPU: this is a host
    byte-stream stage (the data rate is kB/120ms), and the card belongs
    to the main pipeline.  A broken decoder raises: there is no fallback
    to the NumPy codec (`utils.gf256.rs_decode`), its reference.
    """
    data, counts = rs_decode_batch(torch.from_numpy(table))
    return data.numpy(), counts.numpy()

# (dac_rate, sbr_flag) -> (num_aus, au_start[0])
_AU_TABLE = {(0, 1): (2, 5), (1, 1): (3, 6), (0, 0): (4, 8), (1, 0): (6, 11)}


@dataclasses.dataclass
class SuperframeConfig:
    dac_rate: int = 1            # 0: 32 kHz core, 1: 48 kHz core
    sbr_flag: int = 1
    aac_channel_mode: int = 1    # 0: mono, 1: stereo
    ps_flag: int = 0
    mpeg_surround: int = 0

    @property
    def num_aus(self) -> int:
        return _AU_TABLE[(self.dac_rate, self.sbr_flag)][0]

    @property
    def au_start0(self) -> int:
        return _AU_TABLE[(self.dac_rate, self.sbr_flag)][1]

    @property
    def sample_rate(self) -> int:
        core = 32000 if self.dac_rate == 0 else 48000
        return core // 2 if self.sbr_flag else core


@dataclasses.dataclass
class AccessUnit:
    data: bytes
    crc_ok: bool
    superframe_index: int
    au_index: int


# ------------------------------------------------------------------ build
class SuperframeBuilder:
    """Test fixture: pack AAC AUs into RS-protected superframe bytes."""

    def __init__(self, subch_bitrate_kbps: int,
                 config: SuperframeConfig | None = None):
        self.cfg = config or SuperframeConfig()
        self.n_cols = subch_bitrate_kbps // 8
        self.payload_bytes = C.RS_K * self.n_cols   # 110 rows of data
        self.frame_bytes = subch_bitrate_kbps * 3   # per 24 ms

    def au_sizes(self) -> list[int]:
        """AU byte sizes (sans CRC) that exactly fill the payload."""
        cfg = self.cfg
        budget = self.payload_bytes - cfg.au_start0 - 2 * cfg.num_aus
        base = budget // cfg.num_aus
        sizes = [base] * cfg.num_aus
        sizes[-1] += budget - base * cfg.num_aus
        return sizes

    def build(self, aus: list[bytes]) -> np.ndarray:
        """AUs (without CRCs) -> 5 logical frames, (5, frame_bytes) uint8."""
        cfg = self.cfg
        if len(aus) != cfg.num_aus:
            raise ValueError(f"expected {cfg.num_aus} AUs")
        header_bits = []

        def put(v, n):
            header_bits.extend((v >> i) & 1 for i in range(n - 1, -1, -1))

        put(0, 1)                      # rfa
        put(cfg.dac_rate, 1)
        put(cfg.sbr_flag, 1)
        put(cfg.aac_channel_mode, 1)
        put(cfg.ps_flag, 1)
        put(cfg.mpeg_surround, 3)
        starts = [cfg.au_start0]
        for au in aus[:-1]:
            starts.append(starts[-1] + len(au) + 2)
        for s in starts[1:]:
            put(s, 12)
        while len(header_bits) % 8:
            header_bits.append(0)
        body = bytearray(np.packbits(np.array(header_bits, dtype=np.uint8))
                         .tobytes())
        payload = bytearray()
        for au in aus:
            crc = crc16_ccitt(au)
            payload += au + crc.to_bytes(2, "big")
        frame = bytearray(2) + body + payload
        if len(frame) != self.payload_bytes:
            raise ValueError(
                f"AUs must exactly fill the superframe payload: got "
                f"{len(frame)} B, need {self.payload_bytes} B "
                f"(the audio encoder rate-controls to an exact fill; use "
                f"au_sizes() to size test AUs)")
        fc = firecode(bytes(frame[2:11]))
        frame[0], frame[1] = fc >> 8, fc & 0xFF

        # Column-wise RS encode, byte-interleave to transmission order.
        table = np.frombuffer(bytes(frame), dtype=np.uint8).reshape(
            C.RS_K, self.n_cols)
        coded = rs_encode(table.T.copy()).T    # (120, n_cols)
        stream = coded.reshape(-1)             # row-major == tx order
        return stream.reshape(C.SUPERFRAME_FRAMES, self.frame_bytes)


# ------------------------------------------------------------------ decode
class SuperframeDecoder:
    """Streaming decoder: feed logical frames, get AccessUnits.

    Maintains 5-frame phase alignment via the firecode (re-searching on
    loss, the reference's resync-on-FSYNC idea one layer up), applies RS
    column decode, parses the AU table, CRC-checks each AU.
    """

    def __init__(self, subch_bitrate_kbps: int):
        self.n_cols = subch_bitrate_kbps // 8
        self.frame_bytes = subch_bitrate_kbps * 3
        self._frames: list[np.ndarray] = []
        self._synced = False
        self._sync_cache: tuple | None = None
        self._sf_index = 0
        self.stats = {"superframes": 0, "rs_corrected": 0,
                      "rs_failures": 0, "firecode_failures": 0,
                      "au_crc_failures": 0}

    def feed(self, frame_bytes: bytes | np.ndarray) -> list[AccessUnit]:
        frame = np.frombuffer(bytes(frame_bytes), dtype=np.uint8)
        if frame.size != self.frame_bytes:
            raise ValueError(
                f"expected {self.frame_bytes}-byte logical frame")
        self._frames.append(frame)
        out: list[AccessUnit] = []
        while len(self._frames) >= C.SUPERFRAME_FRAMES:
            if not self._synced and not self._check_phase():
                self._frames.pop(0)     # slide the 5-frame window
                continue
            chunk = np.concatenate(self._frames[:C.SUPERFRAME_FRAMES])
            del self._frames[:C.SUPERFRAME_FRAMES]
            out.extend(self._decode_superframe(chunk))
        return out

    def _check_phase(self) -> bool:
        chunk = np.concatenate(self._frames[:C.SUPERFRAME_FRAMES])
        payload, counts = self._rs_raw(chunk)
        if (counts < 0).any():
            return False
        ok = firecode(payload[2:11].tobytes()) == (
            int(payload[0]) << 8 | int(payload[1]))
        if ok:
            self._synced = True
            # Hand the decoded payload to the immediate _decode_superframe
            # of the same 5-frame window: the RS pass dominates the path
            # (NumPy fallback ~0.7x real-time), so re-running it would
            # double every resync's stall.
            self._sync_cache = (chunk.tobytes(), payload, counts)
            log.info("DAB+ superframe sync acquired")
        return ok

    def _rs_raw(self, chunk: np.ndarray):
        table = chunk.reshape(C.RS_N, self.n_cols).T.copy()  # (cols, 120)
        data, counts = _rs_decode_columns(table)
        return data.T.reshape(-1), counts  # (110 * n_cols,) payload bytes

    def _decode_superframe(self, chunk: np.ndarray) -> list[AccessUnit]:
        cached, self._sync_cache = self._sync_cache, None
        if cached is not None and cached[0] == chunk.tobytes():
            payload, counts = cached[1], cached[2]
        else:
            payload, counts = self._rs_raw(chunk)
        self.stats["rs_corrected"] += int(np.sum(counts[counts > 0]))
        self.stats["rs_failures"] += int(np.sum(counts < 0))
        self.stats["superframes"] += 1
        sf = self._sf_index
        self._sf_index += 1
        if firecode(payload[2:11].tobytes()) != (
                int(payload[0]) << 8 | int(payload[1])):
            self.stats["firecode_failures"] += 1
            self._synced = False       # resync on next feed
            return []
        bits = np.unpackbits(payload[2:])
        pos = 0

        def get(n):
            nonlocal pos
            v = 0
            for _ in range(n):
                v = (v << 1) | int(bits[pos])
                pos += 1
            return v

        get(1)  # rfa
        cfg = SuperframeConfig(dac_rate=get(1), sbr_flag=get(1),
                               aac_channel_mode=get(1), ps_flag=get(1),
                               mpeg_surround=get(3))
        starts = [cfg.au_start0]
        for _ in range(cfg.num_aus - 1):
            starts.append(get(12))
        ends = starts[1:] + [payload.size]
        self.config = cfg
        aus = []
        for i, (a, b) in enumerate(zip(starts, ends)):
            if not (a + 2 <= b <= payload.size):
                self.stats["au_crc_failures"] += 1
                continue
            au = payload[a:b]
            body, crc = au[:-2].tobytes(), au[-2:]
            ok = crc16_ccitt(body) == (int(crc[0]) << 8 | int(crc[1]))
            if not ok:
                self.stats["au_crc_failures"] += 1
            aus.append(AccessUnit(data=body, crc_ok=ok,
                                  superframe_index=sf, au_index=i))
        return aus


def adts_wrap(au: bytes, cfg: SuperframeConfig) -> bytes:
    """Wrap one AAC AU in an ADTS header (AAC-LC profile signalling;
    note DAB+ frames are 960 samples — player must cope)."""
    freq_index = {48000: 3, 32000: 5, 24000: 6, 16000: 8}[cfg.sample_rate]
    channels = 2 if cfg.aac_channel_mode or cfg.ps_flag else 1
    frame_len = len(au) + 7
    h = bytearray(7)
    h[0] = 0xFF
    h[1] = 0xF1                       # MPEG-4, no CRC
    h[2] = (1 << 6) | (freq_index << 2) | (channels >> 2)
    h[3] = ((channels & 3) << 6) | ((frame_len >> 11) & 0x03)
    h[4] = (frame_len >> 3) & 0xFF
    h[5] = ((frame_len & 0x07) << 5) | 0x1F
    h[6] = 0xFC
    return bytes(h) + au

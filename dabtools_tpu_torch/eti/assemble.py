"""ETI(NI) frame assembly (ETS 300 799; N10).

Reference counterpart: `upstream:dab.c` `eti_build` (R16).  Host-side byte
work (one 6144-B frame per 24 ms CIF); the C fast path in
``native/dabhost.c`` accelerates the inner copy/CRC when available.

Frame layout (ETS 300 799 s5):
  ERR(1) FSYNC(3) | FC(4) STC(4*NST) EOH{MNSC(2) CRC(2)} |
  MST{FIC 3 FIBs=96B (Mode I), sub-channel data} | EOF{CRC(2) RFU(2)} |
  TIST(4) | 0x55 padding to 6144.

Field packing notes [K-med — reconstructed from the standard; round-trip
covered by tests, re-verify against reference captures when available]:
  FC: FCT(8) FICF(1) NST(7) FP(3) MID(2) FL(11), FL in 32-bit words over
  STC+EOH+MST.  STC entry: SubChId(6) SAD(10) TPL(6) STL(10), SAD/STL in
  64-bit words.  TPL: 0b010LLL = UEP level L-1; 0b1ooLL = EEP option
  o (0=A,1=B) level L-1 (see ``tpl_for_subchannel``).
"""

from __future__ import annotations

import numpy as np

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.fic.config import Ensemble, Subchannel
from dabtools_tpu_torch.utils.crc import crc16_ccitt


def tpl_for_subchannel(s: Subchannel) -> int:
    """6-bit STC TPL field (ETS 300 799).

    The STC entry is 32 bits = SCID(6) SAD(10) TPL(6) STL(10) — the
    field widths are forced by the value ranges (SAD/STL address up to
    864 CUs).  The TPL bit meaning is reconstructed [K-low,
    docs/INTEROP.md row 8]: EEP long form 0b1 + option(3) + level-1(2);
    UEP 0b010 + level-1(3), i.e. ``0x10 | (level - 1)``, which
    every Table 31 row has (its index, 7 bits with the short form's
    table switch, does not fit the field).  Display/interop field only:
    decode config comes from the FIC, so the stream itself is
    unaffected."""
    if s.protection_type == "UEP":
        return 0x10 | (s.protection_level - 1)
    option = 0 if s.eep_option == "A" else 1
    return 0x20 | (option << 2) | (s.protection_level - 1)


# Monotone degradation ladder [K-med, ETS 300 799 ERR levels]: 0xFF
# clean, 0x7F FIB-CRC loss, 0x0F frame-sync degraded, 0x00 unusable —
# four DISTINCT values so observability keeps the receiver's
# level-1/level-2 distinction.  Shared by frame() and frame_batch().
ERR_LADDER = (0xFF, 0x7F, 0x0F, 0x00)

TIST_TICKS_PER_SEC = 16_384_000   # ETS 300 799 annex: 1/16.384 MHz [K-med]
TIST_TICKS_PER_FRAME = TIST_TICKS_PER_SEC * 24 // 1000     # = 393216 exactly
TIST_NONE = 0xFFFFFFFF


class EtiAssembler:
    """Builds the 6144-byte ETI(NI) stream for a fixed ensemble config.

    ``tist_start``: seconds-within-second phase of frame 0; enables TIST
    timestamping (each frame advances 24 ms, wrapping at 1 s).  ``None``
    emits the 0xFFFFFFFF "timestamp not in use" marker.  No CRC covers
    TIST, so it is patched into the frame after assembly (shared by the
    native and Python paths).
    """

    def __init__(self, ensemble: Ensemble, mode=C.MODE_I,
                 tist_start: float | None = None):
        self.ensemble = ensemble
        self.mode = mode
        self.subs = ensemble.sorted_subchannels()
        self.frame_count = 0
        self._tist0 = (None if tist_start is None
                       else int(tist_start * TIST_TICKS_PER_SEC))
        # Everything below is fixed by the mux configuration, so it is
        # computed ONCE: the per-frame hot path (24 ms cadence; the e2e
        # host bottleneck) only concatenates payloads and stamps
        # FCT/FP/ERR.  STC: SCID(6) SAD(10) TPL(6) STL(10) per entry
        # (ETS 300 799); SAD/STL in 64-bit (8-byte) words.
        self._fic_len = mode.n_fibs // mode.n_cifs * C.FIB_BYTES
        sad = self._fic_len // 8   # sub-channel data starts after the FIC
        stc = bytearray()
        for s in self.subs:
            stl = s.data_bytes // 8
            stc.append((s.subchid << 2) | ((sad >> 8) & 0x03))
            stc.append(sad & 0xFF)
            stc.append((tpl_for_subchannel(s) << 2) | ((stl >> 8) & 0x03))
            stc.append(stl & 0xFF)
            sad += stl
        self._stc = bytes(stc)
        self._nst = len(self.subs)
        self._mst_bytes = self._fic_len + sum(s.data_bytes
                                              for s in self.subs)
        self._fl_words = (4 * self._nst + 4 + self._mst_bytes) // 4
        self._mid = {"I": 1, "II": 2, "III": 3, "IV": 0}[mode.name]

    def _tist(self, count: int) -> bytes:
        if self._tist0 is None:
            return TIST_NONE.to_bytes(4, "big")
        ticks = (self._tist0 + count * TIST_TICKS_PER_FRAME) % TIST_TICKS_PER_SEC
        return ticks.to_bytes(4, "big")

    @staticmethod
    def _patch_tist(frame: bytes, nst: int, mst_bytes: int,
                    tist: bytes) -> bytes:
        pos = 8 + 4 * nst + 4 + mst_bytes + 4      # after EOF
        return frame[:pos] + tist + frame[pos + 4:]

    @property
    def fct(self) -> int:
        return self.frame_count % 250

    def _validated_parts(self, subch_data) -> list[bytes]:
        """Per-frame payloads in STC order, length-checked."""
        parts = []
        for s in self.subs:
            data = subch_data[s.subchid]
            if len(data) != s.data_bytes:
                raise ValueError(
                    f"subch {s.subchid}: expected {s.data_bytes} bytes, "
                    f"got {len(data)}")
            parts.append(bytes(data))
        return parts

    def frame_batch(self, fibs_list, subch_data_list,
                    error_levels=None) -> list[bytes]:
        """Assemble N consecutive frames with ONE native call.

        Semantically identical to N ``frame()`` calls (cross-checked in
        tests/test_native.py) but amortizes the ctypes crossing and the
        per-frame Python work over a device block — the e2e host hot
        path.  Falls back to per-frame assembly without the native lib.
        """
        n = len(fibs_list)
        if error_levels is None:
            error_levels = [0] * n
        if len(subch_data_list) != n or len(error_levels) != n:
            # the native loop strides fixed offsets: a ragged batch would
            # read past the end of the payload buffers
            raise ValueError(
                f"ragged batch: {n} FIB entries, "
                f"{len(subch_data_list)} payload entries, "
                f"{len(error_levels)} error levels")
        from dabtools_tpu_torch.utils import native
        if n == 0 or native.lib() is None:
            return [self.frame(f, d, e) for f, d, e in
                    zip(fibs_list, subch_data_list, error_levels)]
        fics = [b"".join(bytes(f) for f in fibs) for fibs in fibs_list]
        if any(len(f) != self._fic_len for f in fics):
            raise ValueError(f"every frame needs {self._fic_len} FIC bytes")
        fic_all = b"".join(fics)
        parts = []
        for subch_data in subch_data_list:
            parts += self._validated_parts(subch_data)
        subch_all = b"".join(parts)
        err = bytes(ERR_LADDER[min(e, 3)] for e in error_levels)
        count = self.frame_count
        self.frame_count += n
        out = native.eti_build_batch(
            count % 250, count % 8, err, self._mid, self._stc, self._nst,
            fic_all, self._fic_len, subch_all,
            self._mst_bytes - self._fic_len)
        frames = [out[i * 6144:(i + 1) * 6144] for i in range(n)]
        if self._tist0 is not None:
            frames = [self._patch_tist(f, self._nst, self._mst_bytes,
                                       self._tist(count + i))
                      for i, f in enumerate(frames)]
        return frames

    def frame(self, fibs: list[bytes], subch_data: dict[int, bytes],
              error_level: int = 0) -> bytes:
        """One ETI frame for one 24 ms CIF.

        ``fibs``: FIBs for this CIF (Mode I: 3 x 32 B).  ``subch_data``:
        subchid -> decoded logical-frame bytes.  ``error_level``: 0 = clean,
        1..3 degrade the ERR byte (sync-loss observability, SURVEY.md s5.3).
        """
        fibs_bytes = b"".join(bytes(f) for f in fibs)
        fic_len = self._fic_len
        if len(fibs_bytes) != fic_len:
            raise ValueError(f"expected {fic_len} FIC bytes, got {len(fibs_bytes)}")

        parts = self._validated_parts(subch_data)

        nst, mst_bytes, fl_words = self._nst, self._mst_bytes, self._fl_words
        stc = self._stc               # config-constant, built in __init__
        err = ERR_LADDER[min(error_level, 3)]
        mid = self._mid
        count = self.frame_count
        self.frame_count += 1
        fct = count % 250
        fp = count % 8        # continuous mod-8 phase (NOT fct%8: 250%8!=0)

        subch_bytes = b"".join(parts)

        # Native fast path (dabhost.cc eti_build; bit-identical to the
        # Python path below, cross-checked in tests/test_native.py).
        from dabtools_tpu_torch.utils import native
        if native.lib() is not None:
            frame = native.eti_build(fct, fp, err, mid, stc, nst,
                                     fibs_bytes, subch_bytes)
            if self._tist0 is not None:
                frame = self._patch_tist(frame, nst, mst_bytes,
                                         self._tist(count))
            return frame

        fsync = C.ETI_FSYNC if count % 2 == 0 else C.ETI_FSYNC_INV
        out = bytearray()
        out.append(err)
        out += fsync.to_bytes(3, "big")

        # FC
        fc = bytearray(4)
        fc[0] = fct
        ficf = 1
        fc[1] = (ficf << 7) | nst
        fc[2] = (fp << 5) | (mid << 3) | ((fl_words >> 8) & 0x07)
        fc[3] = fl_words & 0xFF
        out += fc
        out += stc

        # EOH: MNSC + header CRC over FC+STC+MNSC
        mnsc = b"\xff\xff"
        crc = crc16_ccitt(bytes(fc) + bytes(stc) + mnsc)
        out += mnsc + crc.to_bytes(2, "big")

        # MST
        mst = fibs_bytes + subch_bytes
        out += mst

        # EOF: CRC over MST + RFU
        out += crc16_ccitt(mst).to_bytes(2, "big") + b"\xff\xff"
        out += self._tist(count)

        if len(out) > C.ETI_FRAME_BYTES:
            raise ValueError("ETI frame overflow")
        out += b"\x55" * (C.ETI_FRAME_BYTES - len(out))
        return bytes(out)

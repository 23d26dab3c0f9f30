"""Standard-exact DAB modulator, Modes I-IV (NumPy, test fixture N17).

Implements the full EN 300 401 transmitter chain so every receiver stage has
an exact inverse test: energy dispersal -> convolutional encoding ->
puncturing -> (MSC) time interleaving -> CIF assembly -> QPSK mapping ->
frequency interleaving -> DQPSK differential encoding from the PRS -> IFFT
-> guard insertion -> null symbol.  No counterpart exists in the reference
(receive-only); SURVEY.md s4 mandates this as the closed-loop truth fixture.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as C
from .convcode import conv_encode
from .freq_interleave import freq_interleave_map
from .prs import prs_spectrum
from .puncturing import (
    PuncturingProfile,
    fic_puncture_mask,
    puncture_mask_for_profile,
)
from .time_interleave import tx_delay_for_bits
from .prbs import scramble_bits


@dataclasses.dataclass
class SubchannelSource:
    """One sub-channel to transmit.

    ``start_cu``/``profile`` size the CIF placement; payload is supplied per
    logical frame (24 ms CIF) via ``frames`` as 0/1 bit arrays of length
    ``profile.data_bits``.
    """

    start_cu: int
    profile: PuncturingProfile

    def __post_init__(self):
        self.tx_bits = self.profile.tx_bits
        if self.tx_bits % C.CU_BITS:
            raise ValueError("profile tx bits not CU-aligned")
        self.size_cus = self.tx_bits // C.CU_BITS
        # 16-CIF transmitter interleaver history of coded CIF contributions.
        self._history = np.zeros((C.TIME_INTERLEAVE_DEPTH, self.tx_bits),
                                 dtype=np.uint8)
        self._cif_index = 0

    def encode_cif(self, payload_bits: np.ndarray) -> np.ndarray:
        """Payload bits of one logical frame -> interleaved coded CIF bits."""
        payload_bits = np.asarray(payload_bits, dtype=np.uint8).reshape(-1)
        if payload_bits.size != self.profile.data_bits:
            raise ValueError(
                f"expected {self.profile.data_bits} payload bits, "
                f"got {payload_bits.size}")
        scrambled = scramble_bits(payload_bits)
        mother = conv_encode(scrambled)
        mask = puncture_mask_for_profile(self.profile).astype(bool)
        coded = mother[mask]
        if self.profile.padding_bits:
            coded = np.concatenate(
                [coded, np.zeros(self.profile.padding_bits, dtype=np.uint8)])
        slot = self._cif_index % C.TIME_INTERLEAVE_DEPTH
        self._history[slot] = coded
        delays = tx_delay_for_bits(self.tx_bits)
        src = (self._cif_index - delays) % C.TIME_INTERLEAVE_DEPTH
        out = self._history[src, np.arange(self.tx_bits)]
        # Bits from logical frames < 0 (startup) transmit as zeros.
        out = np.where(delays > self._cif_index, 0, out).astype(np.uint8)
        self._cif_index += 1
        return out


class Modulator:
    """Ensemble modulator producing 2.048 Msps complex baseband.

    Mode I is the primary (verified-details) path; Modes II-IV share the
    same chain with their own numerology and PRS tables (the latter
    placeholder-valued, docs/INTEROP.md row 18).  In Mode III the FIC
    codewords span transmission frames (4 FIBs/frame vs 3 FIBs/codeword),
    so use :meth:`frames` with ``n_frames`` a multiple of 3 there.
    """

    def __init__(self, subchannels: list[SubchannelSource],
                 mode=C.MODE_I, gain: float = 1.0,
                 tii: tuple[int, int] | None = None, tii_amp: float = 0.5):
        """``tii=(sub_id, main_id)`` radiates TII carrier pairs in the
        null symbol (EN 300 401 s14.8; closed-loop fixture for ops.tii)."""
        self.mode = mode
        self.subchannels = subchannels
        self.gain = gain
        self._null = np.zeros(mode.null_size, dtype=np.complex64)
        if tii is not None:
            raise ValueError("TII is not part of the frozen generator")
        occupied = np.zeros(C.CIF_CUS, dtype=bool)
        for s in subchannels:
            span = occupied[s.start_cu:s.start_cu + s.size_cus]
            if span.size != s.size_cus or span.any():
                raise ValueError("sub-channel CU ranges overlap/overflow CIF")
            span[:] = True
        self._interleave = freq_interleave_map(mode)
        self._prs_spec = prs_spectrum(mode)

    # ------------------------------------------------------------- FIC
    def _fic_stream(self, fibs_all: np.ndarray) -> np.ndarray:
        """FIBs (n_frames, n_fibs, 32) -> (n_frames, fic_bits_per_frame).

        Codewords protect FIB triplets; in Mode III (4 FIBs/frame) they
        straddle frame boundaries, so the whole run is encoded as one
        codeword stream and re-sliced per frame.
        """
        n_frames = fibs_all.shape[0]
        if fibs_all.shape[1:] != (self.mode.n_fibs, C.FIB_BYTES):
            raise ValueError(
                f"expected (*, {self.mode.n_fibs}, {C.FIB_BYTES}) FIBs")
        total_fibs = n_frames * self.mode.n_fibs
        if total_fibs % C.FIBS_PER_CODEWORD:
            raise ValueError(
                "FIB count not codeword-aligned; in Mode III modulate a "
                "multiple of 3 frames")
        mask = fic_puncture_mask().astype(bool)
        triplets = fibs_all.reshape(
            total_fibs // C.FIBS_PER_CODEWORD, -1)
        cw = [conv_encode(scramble_bits(np.unpackbits(t)))[mask]
              for t in triplets]
        return np.concatenate(cw).reshape(
            n_frames, self.mode.fic_bits_per_frame)

    def _fic_bits(self, fibs: np.ndarray) -> np.ndarray:
        """Single-frame FIC (modes whose codewords align with frames)."""
        return self._fic_stream(
            np.asarray(fibs, dtype=np.uint8)[None])[0]

    # ------------------------------------------------------------- OFDM
    def _ofdm_frame(self, bit_symbols: np.ndarray) -> np.ndarray:
        """(75, bits_per_symbol) data-symbol bits -> one frame of samples."""
        mode = self.mode
        k = mode.n_carriers
        b0 = bit_symbols[:, :k].astype(np.float32)
        b1 = bit_symbols[:, k:].astype(np.float32)
        qpsk = ((1 - 2 * b0) + 1j * (1 - 2 * b1)) / np.sqrt(2)
        spec = np.zeros((bit_symbols.shape[0], mode.fft_size),
                        dtype=np.complex64)
        spec[:, self._interleave] = qpsk
        # DQPSK differential encoding, PRS as symbol 0 reference.
        carriers = np.concatenate([self._prs_spec[None], spec], axis=0)
        carriers = self._diff_encode(carriers)
        time = np.fft.ifft(carriers, axis=-1).astype(np.complex64)
        time *= self.gain * mode.fft_size / np.sqrt(mode.n_carriers)
        with_guard = np.concatenate([time[:, -mode.guard:], time], axis=-1)
        return np.concatenate([self._null, with_guard.reshape(-1)])

    @staticmethod
    def _diff_encode(carriers: np.ndarray) -> np.ndarray:
        # cumprod would drift numerically for zero bins; multiply iteratively
        # only on active bins (inactive bins stay exactly 0).
        out = carriers.copy()
        for l in range(1, out.shape[0]):
            active = out[l] != 0
            out[l, active] = out[l - 1, active] * out[l, active]
            out[l, ~active] = 0
        return out

    # ------------------------------------------------------------- frames
    def frame(self, fibs: np.ndarray,
              payloads: dict[int, np.ndarray],
              fic_bits: np.ndarray | None = None) -> np.ndarray:
        """Modulate one transmission frame.

        ``fibs``: (n_fibs, 32) uint8.  ``payloads``: subchannel index ->
        (n_cifs, data_bits) payload bits, one row per CIF.  ``fic_bits``
        overrides the FIC coding (used by :meth:`frames` in Mode III where
        codewords span frames).
        """
        mode = self.mode
        fic = (np.asarray(fic_bits, dtype=np.uint8) if fic_bits is not None
               else self._fic_bits(np.asarray(fibs, dtype=np.uint8)))
        fic_syms = fic.reshape(mode.n_fic_syms, mode.bits_per_symbol)

        msc_syms = np.zeros((mode.n_msc_syms, mode.bits_per_symbol),
                            dtype=np.uint8)
        syms_per_cif = mode.n_msc_syms // mode.n_cifs
        for cif in range(mode.n_cifs):
            cif_bits = np.zeros(C.CIF_BITS, dtype=np.uint8)
            for idx, sub in enumerate(self.subchannels):
                rows = payloads[idx]
                coded = sub.encode_cif(rows[cif])
                start = sub.start_cu * C.CU_BITS
                cif_bits[start:start + coded.size] = coded
            msc_syms[cif * syms_per_cif:(cif + 1) * syms_per_cif] = (
                cif_bits.reshape(syms_per_cif, mode.bits_per_symbol))

        data_syms = np.concatenate([fic_syms, msc_syms], axis=0)
        assert data_syms.shape[0] == mode.n_symbols - 1
        return self._ofdm_frame(data_syms)

    def frames(self, n_frames: int, fibs_fn, payload_fn) -> np.ndarray:
        """Modulate ``n_frames`` consecutive frames.

        ``fibs_fn(frame_idx) -> (12, 32)``;
        ``payload_fn(frame_idx, sub_idx) -> (4, data_bits)``.
        """
        fibs_all = np.stack([np.asarray(fibs_fn(f), dtype=np.uint8)
                             for f in range(n_frames)])
        fic_rows = self._fic_stream(fibs_all)
        out = [
            self.frame(fibs_all[f],
                       {i: payload_fn(f, i)
                        for i in range(len(self.subchannels))},
                       fic_bits=fic_rows[f])
            for f in range(n_frames)
        ]
        return np.concatenate(out)

"""Phase-reference symbol (PRS) tables (ETSI EN 300 401 s14.3.2).

Reference counterpart: `upstream:sdr_prstab.c` / the PRS table used by the
WaveFinder AFC math (R6 in SURVEY.md).

The PRS fixes the phase phi_k = (pi/2) * (h_{i(k), k-k'(k)} + n(k)) of every
active carrier k; z_k = exp(j*phi_k).  It is both the DQPSK differential
reference (first OFDM symbol of each frame) and the matched-filter template
for fine time/frequency sync.

NOTE [K-med, SURVEY.md availability notice]: the h table and the Mode I
(k', i, n) assignment table are reconstructed from knowledge of the public
standard.  They are exercised closed-loop (modulator <-> receiver share
them); verify against a real capture when one is available.
"""

from __future__ import annotations

import functools

import numpy as np

from .constants import MODE_I, Mode

# h_{i,j}, i=0..3, j=0..31 (EN 300 401 Table 43; period 16 in j).
_H = np.array([
    [0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1,
     0, 2, 0, 0, 0, 0, 1, 1, 2, 0, 0, 0, 2, 2, 1, 1],
    [0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0,
     0, 3, 2, 3, 0, 1, 3, 0, 2, 1, 2, 3, 2, 3, 3, 0],
    [0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3,
     0, 0, 0, 2, 0, 2, 1, 3, 2, 2, 0, 2, 2, 0, 1, 3],
    [0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2,
     0, 1, 2, 1, 0, 3, 3, 2, 2, 3, 2, 1, 2, 1, 3, 2],
], dtype=np.int64)

# Mode I (k', i, n) table (EN 300 401 Table 44): 32-carrier groups.
_MODE_I_NEG = (  # k in [-768, -1]; rows are (k', i, n)
    (-768, 0, 1), (-736, 1, 2), (-704, 2, 0), (-672, 3, 1),
    (-640, 0, 3), (-608, 1, 2), (-576, 2, 2), (-544, 3, 3),
    (-512, 0, 2), (-480, 1, 1), (-448, 2, 2), (-416, 3, 3),
    (-384, 0, 1), (-352, 1, 2), (-320, 2, 3), (-288, 3, 3),
    (-256, 0, 2), (-224, 1, 2), (-192, 2, 2), (-160, 3, 1),
    (-128, 0, 1), (-96, 1, 3), (-64, 2, 1), (-32, 3, 2),
)
_MODE_I_POS = (  # k in [1, 768]
    (1, 0, 3), (33, 3, 1), (65, 2, 1), (97, 1, 1),
    (129, 0, 2), (161, 3, 2), (193, 2, 1), (225, 1, 0),
    (257, 0, 2), (289, 3, 2), (321, 2, 3), (353, 1, 3),
    (385, 0, 0), (417, 3, 2), (449, 2, 1), (481, 1, 3),
    (513, 0, 3), (545, 3, 3), (577, 2, 3), (609, 1, 0),
    (641, 0, 3), (673, 3, 0), (705, 2, 1), (737, 1, 1),
)

# Modes II-IV (k', i, n) tables (EN 300 401 Tables 45-47), reconstructed
# from knowledge of the public standard at the same [K-med] tier as the
# Mode I table above.  Structural cross-checks they all satisfy (and the
# Mode I table shares): the i column cycles 0,1,2,3 ascending across the
# negative-k groups and descends ...,3,2,1,0 across the positive-k groups;
# n is in 0..3; groups tile [-K/2, -1] and [1, K/2] in 32-carrier blocks.
# CAVEAT (ADVICE r4): closed-loop tests CANNOT catch a wrong value here —
# modulator and receiver share this table, so any consistent error
# cancels.  Verify over-the-air via docs/INTEROP.md row 18, or pin
# against a second independent source (a known-good Mode II/IV capture
# or another implementation's tables), when one exists.
_MODE_II_NEG = (  # k in [-192, -1]
    (-192, 0, 2), (-160, 1, 3), (-128, 2, 2), (-96, 3, 2),
    (-64, 0, 1), (-32, 1, 2),
)
_MODE_II_POS = (  # k in [1, 192]
    (1, 2, 0), (33, 1, 2), (65, 0, 2), (97, 3, 1),
    (129, 2, 0), (161, 1, 3),
)
_MODE_III_NEG = (  # k in [-96, -1]
    (-96, 0, 2), (-64, 1, 3), (-32, 2, 0),
)
_MODE_III_POS = (  # k in [1, 96]
    (1, 3, 2), (33, 2, 2), (65, 1, 2),
)
_MODE_IV_NEG = (  # k in [-384, -1]
    (-384, 0, 0), (-352, 1, 1), (-320, 2, 1), (-288, 3, 2),
    (-256, 0, 2), (-224, 1, 2), (-192, 2, 0), (-160, 3, 3),
    (-128, 0, 3), (-96, 1, 1), (-64, 2, 3), (-32, 3, 2),
)
_MODE_IV_POS = (  # k in [1, 384]
    (1, 0, 0), (33, 3, 1), (65, 2, 0), (97, 1, 2),
    (129, 0, 0), (161, 3, 1), (193, 2, 2), (225, 1, 2),
    (257, 0, 2), (289, 3, 1), (321, 2, 3), (353, 1, 0),
)


_TABLES: dict[str, tuple[tuple[int, int, int], ...]] = {
    "I": _MODE_I_NEG + _MODE_I_POS,
    "II": _MODE_II_NEG + _MODE_II_POS,
    "III": _MODE_III_NEG + _MODE_III_POS,
    "IV": _MODE_IV_NEG + _MODE_IV_POS,
}


def _mode_groups(mode: Mode) -> tuple[tuple[int, int, int], ...]:
    """(k', i, n) 32-carrier groups for the mode.

    All four modes carry the reconstructed standard tables above
    [K-med — docs/INTEROP.md row 18].  The modulator and receiver share
    this table, so the closed loop is exact regardless; over-the-air
    interop for Modes II-IV should be spot-checked against EN 300 401
    Tables 45-47 / a real capture when available (Mode I is the
    reference's actual scope).
    """
    return _TABLES[mode.name]


@functools.cache
def prs_carriers(mode: Mode = MODE_I) -> np.ndarray:
    """z_k for carriers k = -K/2..-1, 1..K/2 (ascending k), complex64, (K,)."""
    half = mode.n_carriers // 2
    ks = np.concatenate([np.arange(-half, 0), np.arange(1, half + 1)])
    phase_idx = np.empty(ks.shape, dtype=np.int64)
    for kp, i, n in _mode_groups(mode):
        sel = (ks >= kp) & (ks <= kp + 31)
        phase_idx[sel] = _H[i, ks[sel] - kp] + n
    return np.exp(1j * np.pi / 2 * phase_idx).astype(np.complex64)


@functools.cache
def prs_spectrum(mode: Mode = MODE_I) -> np.ndarray:
    """PRS as a full FFT-bin spectrum (T_u,), complex64 (inactive bins 0)."""
    from .freq_interleave import carrier_bins_in_order

    spec = np.zeros(mode.fft_size, dtype=np.complex64)
    spec[carrier_bins_in_order(mode)] = prs_carriers(mode)
    return spec


@functools.cache
def prs_time(mode: Mode = MODE_I) -> np.ndarray:
    """Time-domain PRS useful part (T_u,), complex64 (no guard)."""
    return np.fft.ifft(prs_spectrum(mode)).astype(np.complex64)

"""Frequency-interleaving permutation (ETSI EN 300 401 s14.6).

Reference counterpart: the table built at init in `upstream:input_sdr.c`
(R8 in SURVEY.md) via the recursion Pi(i) = (13*Pi(i-1) + T_u/4 - 1) mod T_u.

For Mode I (T_u = 2048): keep values in [256, 1792] excluding 1024 (the DC
bin); the i-th *kept* value R gives the carrier index k = R - 1024 in
[-768, 768] \\ {0} for the i-th QPSK symbol of the OFDM symbol.

The receiver uses the inverse map as a static gather; the modulator uses the
forward map.  Both are derived once here with NumPy.
"""

from __future__ import annotations

import functools

import numpy as np

from .constants import Mode


@functools.cache
def freq_interleave_map(mode: Mode) -> np.ndarray:
    """``carrier_of_symbol[n]`` — FFT *bin* index for QPSK symbol ``n``.

    Bins are in natural FFT order (0..T_u-1); carrier k maps to bin
    ``k mod T_u`` (negative carriers in the upper half of the spectrum).
    Shape: (n_carriers,), dtype int32.
    """
    tu = mode.fft_size
    lo, hi, dc = tu // 8, 7 * tu // 8, tu // 2
    increment = tu // 4 - 1
    perm = np.empty(tu, dtype=np.int64)
    perm[0] = 0
    for i in range(1, tu):
        perm[i] = (13 * perm[i - 1] + increment) % tu
    kept = perm[(perm >= lo) & (perm <= hi) & (perm != dc)]
    if kept.size != mode.n_carriers:
        raise AssertionError(
            f"interleaver yielded {kept.size} carriers, expected {mode.n_carriers}")
    k = kept - dc                      # carrier index in [-K/2, K/2] \ {0}
    bins = np.mod(k, tu).astype(np.int32)
    return bins


@functools.cache
def carrier_bins_in_order(mode: Mode) -> np.ndarray:
    """FFT bin indices of the active carriers k=-K/2..-1,1..K/2 (ascending k)."""
    tu, half = mode.fft_size, mode.n_carriers // 2
    k = np.concatenate([np.arange(-half, 0), np.arange(1, half + 1)])
    return np.mod(k, tu).astype(np.int32)

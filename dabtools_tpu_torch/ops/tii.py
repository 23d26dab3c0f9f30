"""TII — Transmitter Identification Information from the null symbol.

Port of ``dabtools_tpu/ops/tii.py``.  EN 300 401 s14.8: during the
otherwise-silent null symbol a transmitter may radiate pairs of adjacent
carriers identifying it: a *comb* c (0..23, the sub id) selects the
carrier offsets and a *pattern* p (0..69, the main id) selects which 4 of
8 carrier groups are active — 70 = C(8,4) patterns, encoded here as the
lexicographic rank of the active-group subset.

The NumPy parts (pattern codec, carrier-pair table, null-symbol inserter,
``solve_tii``) are the JAX module's, verbatim.  The detector is torch: one
batched FFT over the block's null symbols plus a (24, 8) gather, on the
device of the samples.  Its windows start where ``lax.dynamic_slice``
would put them: clamped into range, never wrapped.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools

import numpy as np
import torch

from dabtools_tpu_torch.constants import MODE_I, Mode
from dabtools_tpu_torch.ops.sync import coarse_null_sync

N_COMBS = 24
N_GROUPS = 8
N_ACTIVE = 4
N_PATTERNS = 70          # C(8, 4)

_SUBSETS = list(itertools.combinations(range(N_GROUPS), N_ACTIVE))


def pattern_groups(p: int) -> tuple[int, ...]:
    """Main id p (0..69) -> the 4 active group indices."""
    return _SUBSETS[p]


def groups_pattern(groups) -> int:
    """Inverse of :func:`pattern_groups` (groups in any order)."""
    return _SUBSETS.index(tuple(sorted(groups)))


@functools.cache
def tii_carrier_pairs(mode: Mode = MODE_I) -> np.ndarray:
    """(N_COMBS, N_GROUPS) carrier index k of each pair's lower carrier.

    Pairs are (k, k+1).  Reconstruction [K-low]: groups tile the active
    band in K/8-carrier strides; the comb steps by 8 carriers inside a
    group; the upper half shifts by +1 to skip the DC bin.
    """
    half = mode.n_carriers // 2
    stride = mode.n_carriers // N_GROUPS
    b = np.arange(N_GROUPS)
    c = np.arange(N_COMBS)
    k = -half + stride * b[None, :] + 8 * c[:, None] + (b[None, :] >= N_GROUPS // 2)
    return k.astype(np.int32)


@functools.cache
def _pair_bins(mode: Mode) -> tuple[np.ndarray, np.ndarray]:
    k = tii_carrier_pairs(mode)
    return (np.mod(k, mode.fft_size).astype(np.int32),
            np.mod(k + 1, mode.fft_size).astype(np.int32))


# ----------------------------------------------------------------- insert
def tii_null_symbol(c: int, p: int, mode: Mode = MODE_I,
                    amp: float = 1.0) -> np.ndarray:
    """Time-domain null symbol (null_size,) carrying TII (c, p).

    The 2048-sample TII waveform is cyclically extended to T_null, so any
    T_u-long receiver window sees a circular shift of it.
    """
    if not 0 <= c < N_COMBS or not 0 <= p < N_PATTERNS:
        raise ValueError("comb 0..23, pattern 0..69")
    spec = np.zeros(mode.fft_size, dtype=np.complex64)
    lo, hi = _pair_bins(mode)
    for b in pattern_groups(p):
        spec[lo[c, b]] = amp
        spec[hi[c, b]] = amp
    time = np.fft.ifft(spec).astype(np.complex64)
    time *= mode.fft_size / np.sqrt(mode.n_carriers)
    reps = -(-mode.null_size // mode.fft_size)
    return np.tile(time, reps)[: mode.null_size]


# ----------------------------------------------------------------- detect
@functools.cache
def _pair_bins_on(mode: Mode, device: torch.device):
    lo, hi = _pair_bins(mode)
    return (torch.from_numpy(lo.astype(np.int64)).to(device),
            torch.from_numpy(hi.astype(np.int64)).to(device))


def tii_pair_powers(x: torch.Tensor, null_starts: torch.Tensor,
                    mode: Mode = MODE_I) -> dict:
    """(24, 8) accumulated pair powers over the block's nulls.

    One T_u window per null symbol, offset into the null to dodge the
    preceding symbol's tail under timing error.  ``x``: (n,) complex64;
    ``null_starts``: (F,) integer tensor on ``x``'s device.  Returns
    tensors ``powers`` (24, 8) float32 and ``floor`` (0-dim): the mean
    of |X|^2 over every bin and window, times F.  Nothing here reads a
    value back to the host.
    """
    off = (mode.null_size - mode.fft_size) // 2
    s = (null_starts.to(torch.int64) + off).clamp(0, x.shape[0]
                                                  - mode.fft_size)
    idx = s[:, None] + torch.arange(mode.fft_size, device=x.device)
    spec = torch.fft.fft(x[idx], dim=-1)                # (F, T_u)
    lo, hi = _pair_bins_on(mode, x.device)
    prod = spec[:, lo] * torch.conj(spec[:, hi])        # (F, 24, 8)
    powers = torch.sum(prod.abs(), dim=0)
    floor = torch.mean(spec.abs() ** 2) + 1e-20         # per-bin noise proxy
    return {"powers": powers, "floor": floor * null_starts.shape[0]}


@dataclasses.dataclass
class TiiDetection:
    main_id: int      # pattern p
    sub_id: int       # comb c
    snr: float        # active-pair power over the noise floor estimate


def solve_tii(powers: np.ndarray, floor: float,
              min_snr: float = 3.0) -> TiiDetection | None:
    """(24, 8) pair powers -> best (p, c), or None below ``min_snr``."""
    powers = np.asarray(powers, dtype=np.float64)
    best = None
    for c in range(N_COMBS):
        order = np.argsort(powers[c])
        active = order[-N_ACTIVE:]
        on = float(powers[c, active].sum())
        off = float(powers[c, order[:-N_ACTIVE]].sum())
        # Contrast: active groups must dominate the inactive ones.
        score = on / (off + 0.25 * float(floor) + 1e-20)
        if best is None or score > best[0]:
            best = (score, c, active, on)
    score, c, active, on = best
    snr = on / (float(floor) + 1e-20) * (N_GROUPS * N_COMBS / N_ACTIVE)
    if score < 2.0 or snr < min_snr:
        return None
    return TiiDetection(main_id=groups_pattern(active), sub_id=c,
                        snr=float(snr))


def tii_powers_at(x: torch.Tensor, null_start: torch.Tensor, n_frames: int,
                  mode: Mode = MODE_I) -> dict:
    """Pair powers for a block whose null position is already known (the
    receiver's coarse sync, a 0-dim tensor): what ``DabReceiver(tii=True)``
    adds to each block's output."""
    starts = null_start.to(torch.int64) + torch.arange(
        n_frames, dtype=torch.int64, device=x.device) * mode.frame_size
    return tii_pair_powers(x, starts, mode)


def detect_tii_block(x: torch.Tensor, n_frames: int, mode: Mode = MODE_I,
                     min_snr: float = 3.0) -> TiiDetection | None:
    """Self-synchronizing block detector: IQ block (complex64 tensor on
    the device that runs it) -> TiiDetection | None."""
    ns = coarse_null_sync(x, mode)["null_start"]
    out = tii_powers_at(x, ns, n_frames, mode)
    return solve_tii(out["powers"].cpu().numpy(), float(out["floor"]),
                     min_snr)

"""Sync engine: null-symbol coarse time, guard-interval fractional CFO,
PRS matched filter for fine time + integer CFO.

Port of ``dabtools_tpu/ops/sync.py``.  Alignment stays data, never host
control flow: argmin/argmax results are tensors that feed the gathers
downstream, and nothing here reads a value back to the host.  The JAX
package vmaps the per-frame functions; here they take a leading batch of
frame starts.  Every function also takes a leading stream axis: ``x``
(B, n) with per-stream starts and CFOs, one row each, and returns per
stream; a 1-D ``x`` is one stream with no such axis.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dabtools_tpu_torch.constants import MODE_I, Mode
from dabtools_tpu_torch.ops.slicing import window_slices
from dabtools_tpu_torch.tables.prs import prs_spectrum, prs_time

# Where machine-readable output carries an snr_db derived from this,
# attach SNR_METHOD/SNR_CAVEAT so consumers see the estimator's limits
# without reading source (--stats-json).
SNR_METHOD = "null_floor"
SNR_CAVEAT = ("saturates ~30 dB; underestimates when TII carriers or "
              "long SFN echo tails raise the null-symbol floor")


def null_ratio_to_snr_db(null_ratio: float) -> float:
    """SNR estimated from the null-symbol noise floor.

    null_ratio r = P_null / P_mean, so SNR = (1 - r) / r.  See SNR_CAVEAT
    for the estimator's known biases.
    """
    r = min(max(float(null_ratio), 1e-6), 1.0 - 1e-6)
    return 10.0 * math.log10(1.0 / r - 1.0)


def _rot(phase: torch.Tensor) -> torch.Tensor:
    """exp(j*phase) as complex64 from a float32 phase."""
    return torch.complex(torch.cos(phase), torch.sin(phase))


def moving_power(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding-window power sum along the last axis, valid positions only
    (cumsum trick)."""
    p = x.abs() ** 2
    cs = torch.cat([p.new_zeros(*p.shape[:-1], 1), torch.cumsum(p, -1)], -1)
    return cs[..., window:] - cs[..., :-window]


def coarse_null_sync(x: torch.Tensor, mode: Mode = MODE_I) -> dict:
    """Locate the null symbol inside the first frame-length of ``x``
    ((n,) or (B, n): per stream).

    Returns tensors of ``x``'s leading shape (0-dim for one stream):
    ``null_start`` (int32) and ``null_ratio`` (null power / mean power,
    the sync-confidence metric).
    """
    n = mode.frame_size + mode.null_size
    win = moving_power(x[..., :n], mode.null_size)[..., : mode.frame_size]
    idx = torch.argmin(win, dim=-1)
    ratio = (win.gather(-1, idx[..., None])[..., 0]
             / (win.mean(dim=-1) + 1e-20))
    return {"null_start": idx.to(torch.int32), "null_ratio": ratio}


def fractional_cfo(x: torch.Tensor, frame_start: torch.Tensor,
                   mode: Mode = MODE_I, n_syms: int = 8) -> torch.Tensor:
    """Fractional CFO (in carrier spacings, |.| < 0.5) from guard-interval
    correlation over the first ``n_syms`` symbols of the frame at
    ``frame_start`` (start of the null symbol: 0-dim, or (B,) for a
    (B, n) ``x``, one per stream).  Returns one CFO per stream."""
    sym0 = frame_start.to(torch.int64)[..., None] + mode.null_size
    starts = sym0 + torch.arange(n_syms, device=x.device) * mode.symbol_size
    sym = window_slices(x, starts, mode.symbol_size)  # (..., n_syms, T_s)
    guard = sym[..., : mode.guard]
    tail = sym[..., mode.fft_size: mode.fft_size + mode.guard]
    corr = torch.sum(torch.conj(guard) * tail, dim=(-2, -1))
    # phase advance over T_u samples = 2*pi * cfo_norm
    return torch.angle(corr) / (2.0 * math.pi)


@functools.cache
def _prs_templates_np(mode: Mode, max_int_cfo: int,
                      fft_len: int) -> np.ndarray:
    """Conjugated spectra of the PRS shifted by c carriers, zero-padded to
    ``fft_len``; (2*max_int_cfo+1, fft_len) complex64."""
    t = prs_time(mode)
    n = np.arange(mode.fft_size)
    temps = []
    for c in range(-max_int_cfo, max_int_cfo + 1):
        shifted = t * np.exp(2j * np.pi * c * n / mode.fft_size)
        padded = np.zeros(fft_len, dtype=np.complex64)
        padded[: mode.fft_size] = shifted
        temps.append(np.conj(np.fft.fft(padded)))
    return np.stack(temps).astype(np.complex64)


@functools.cache
def _prs_templates(mode: Mode, max_int_cfo: int, fft_len: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _prs_templates_np(mode, max_int_cfo, fft_len)).to(device)


@functools.cache
def _prs_energy(mode: Mode) -> float:
    """sum |prs_time|^2 in float32, as the JAX package computes it."""
    return float(np.sum(np.abs(prs_time(mode)) ** 2, dtype=np.float32))


def fine_sync_prs(x: torch.Tensor, prs_guess: torch.Tensor,
                  mode: Mode = MODE_I, search: int = 256,
                  max_int_cfo: int = 8,
                  frac_cfo: torch.Tensor | float = 0.0) -> dict:
    """Joint fine-timing + integer-CFO estimate from the PRS, for a batch
    of frames of one stream or of each of B streams.

    ``prs_guess``: (F,) integer tensor, estimated start of each frame's
    PRS useful part (frame_start + null + guard); (B, F) for a (B, n)
    ``x``.  Searches timing offsets in [-search, +search) and integer
    CFOs in [-max_int_cfo, +max_int_cfo] by correlating against shifted
    PRS templates (one batched FFT correlation evaluates every hypothesis
    of every frame of every stream).  ``frac_cfo`` (0-dim, or (B,): one
    per stream) is derotated from the window before the integer search,
    so the integer bin and the fractional estimate cannot pair
    inconsistently (see the JAX docstring).

    Returns tensors of ``prs_guess``'s shape: ``offset`` (int32, add to
    prs_guess), ``int_cfo`` (int32, carriers), ``peak`` (float32
    normalized 0..1 correlation quality).
    """
    dev = x.device
    win_len = mode.fft_size + 2 * search
    fft_len = int(2 ** np.ceil(np.log2(win_len + mode.fft_size)))
    win = window_slices(x, prs_guess.to(torch.int64) - search, win_len)
    frac = torch.as_tensor(frac_cfo, dtype=torch.float32, device=dev)
    ph = -2.0 * math.pi * torch.remainder(
        frac[..., None] * torch.arange(win_len, dtype=torch.float32,
                                       device=dev)
        / mode.fft_size, 1.0)                           # (..., win_len)
    win = win * _rot(ph).unsqueeze(-2)
    wspec = torch.fft.fft(win, n=fft_len, dim=-1)              # (..., F, L)
    temps = _prs_templates(mode, max_int_cfo, fft_len, dev)    # (C, L)
    corr = torch.fft.ifft(wspec[..., None, :] * temps, dim=-1)
    n_lags = 2 * search
    mag = corr[..., :n_lags].abs()                        # (..., F, C, lags)
    # flat argmax in row-major (CFO bin, lag) order, as jnp.argmax
    best, flat = mag.flatten(-2).max(dim=-1)
    c_idx = torch.div(flat, n_lags, rounding_mode="floor")
    lag = flat - c_idx * n_lags
    energy = torch.sqrt(
        torch.sum(win[..., search:search + mode.fft_size].abs() ** 2, -1)
        * _prs_energy(mode))
    return {
        "offset": (lag - search).to(torch.int32),
        "int_cfo": (c_idx - max_int_cfo).to(torch.int32),
        "peak": (best / (energy + 1e-20)).to(torch.float32),
    }


@functools.cache
def _cir_tables(mode: Mode, device: torch.device):
    """conj(Z_k) on the active carriers (complex64) and the lag-0-centre
    index map of the output (int64), both (fft_size,)."""
    z = prs_spectrum(mode)
    zc = (np.conj(z) * (np.abs(z) > 0).astype(np.float32)).astype(
        np.complex64)
    n = mode.fft_size
    centre = (np.arange(n) - n // 2) % n          # roll(h, n // 2)
    return (torch.from_numpy(zc).to(device),
            torch.from_numpy(centre.astype(np.int64)).to(device))


def channel_impulse_response(x: torch.Tensor, prs_start: torch.Tensor,
                             cfo_carriers: torch.Tensor,
                             mode: Mode = MODE_I) -> torch.Tensor:
    """Least-squares channel impulse response from the synchronized PRS,
    for a batch of frames of one stream or of each of B streams.

    ``prs_start``: (F,) integer tensor, start of each PRS useful part
    after fine sync; (B, F) for a (B, n) ``x``.  ``cfo_carriers``: the
    stream's total CFO in carrier spacings, float32, 0-dim or (B,)
    (integer part undone by a spectrum rotation, fractional part by a
    time-domain derotation, each per stream).

    Returns (..., F, fft_size) complex64, circularly shifted so index
    ``fft_size // 2`` is lag 0 (the receiver's timing reference).
    """
    dev = x.device
    n = mode.fft_size
    win = window_slices(x, prs_start, n)                   # (..., F, n)
    ic = torch.round(cfo_carriers)
    frac = cfo_carriers - ic
    k = torch.arange(n, dtype=torch.float32, device=dev)
    win = win * torch.exp(-2j * math.pi * frac[..., None] * k
                          / n).unsqueeze(-2)
    spec = torch.fft.fft(win, dim=-1)
    # jnp.roll(spec, -ic) with a per-stream tensor shift:
    # y[..., k] = spec[..., (k + ic) mod n]
    shift_idx = torch.remainder(
        torch.arange(n, device=dev) + ic.to(torch.int64)[..., None], n)
    y = spec.gather(-1, shift_idx.unsqueeze(-2).expand_as(spec))
    zc, centre = _cir_tables(mode, dev)
    h = torch.fft.ifft(y * zc, dim=-1)
    return h[..., centre]

"""Batched OFDM demodulation.

Port of ``dabtools_tpu/ops/ofdm.py``: one gather builds the (frames, 76,
2048) window tensor from per-frame start tensors, one batched FFT
(``torch.fft``; cuFFT on the card) demodulates every symbol of the block,
and the differential demap, frequency deinterleave and soft-bit
extraction are elementwise ops and one gather.  Only the JAX package's
default ``twostage`` window semantics are ported.  A leading stream axis
is explicit: ``x`` (B, n) with per-stream frame starts, CFO and drift
demodulates every frame of every stream in the same ops.
"""

from __future__ import annotations

import functools
import math

import torch

from dabtools_tpu_torch.constants import MODE_I, SAMPLE_RATE, Mode
from dabtools_tpu_torch.ops.slicing import window_starts
from dabtools_tpu_torch.ops.sync import _rot
from dabtools_tpu_torch.tables.freq_interleave import freq_interleave_map

# Clip margin for per-symbol drift window shifts: keeps the per-frame
# window length fixed.  50 ppm over one Mode I frame is ~10 samples; 64 is
# 6x headroom.
_DRIFT_MARGIN = 64


@functools.cache
def _interleave_idx(mode: Mode, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        freq_interleave_map(mode).astype("int64")).to(device)


def _sym_pos(mode: Mode, device: torch.device) -> torch.Tensor:
    sym_idx = torch.arange(mode.n_symbols, dtype=torch.int32, device=device)
    return (mode.null_size + sym_idx * mode.symbol_size).to(torch.float32)


def _drift_adjustment(drift, sym_pos: torch.Tensor,
                      mode: Mode) -> torch.Tensor:
    """Per-symbol integer window shift for sample-clock drift, CLIPPED to
    the margin: (..., n_symbols) for a drift of shape (...), one row per
    stream.  Shared by ``gather_symbol_windows`` (which shifts the
    windows) and ``demod_frames`` (which undoes the shifts in phase): both
    sides must see the identical clipped value, or a drift estimate beyond
    the margin silently corrupts the DQPSK differential."""
    d = torch.as_tensor(drift, dtype=torch.float32, device=sym_pos.device)
    return torch.clamp(torch.round(d[..., None] * sym_pos / mode.frame_size),
                       -_DRIFT_MARGIN, _DRIFT_MARGIN)


def gather_symbol_windows(x: torch.Tensor, frame_starts: torch.Tensor,
                          mode: Mode = MODE_I,
                          cfo_norm: torch.Tensor | float = 0.0,
                          drift: torch.Tensor | float = 0.0
                          ) -> torch.Tensor:
    """Gather the useful part of every OFDM symbol of every frame.

    ``x``: (n_samples,) complex64 block, or (B, n_samples) for B streams.
    ``frame_starts``: (F,) integer tensor, first sample of each frame's
    null symbol; (B, F) for B streams.  ``cfo_norm``: residual CFO in
    carrier spacings, corrected with a per-sample phase ramp on the
    gathered windows.  ``drift``: sample-clock drift in samples per
    frame; symbol windows slide linearly within the frame.  Both are
    0-dim, or (B,): one per stream.

    One clamped whole-frame window per frame, then the (76, 2048) local
    windows inside it (the JAX package's ``twostage`` layout; its clamp
    applies to the frame window), read in one flat gather.  Returns
    (..., F, n_symbols, T_u) complex64.
    """
    dev = x.device
    sym_idx = torch.arange(mode.n_symbols, device=dev)
    drift_adj = _drift_adjustment(drift, _sym_pos(mode, dev),
                                  mode).to(torch.int64)     # (..., 76)
    frame_len = (mode.null_size + (mode.n_symbols - 1) * mode.symbol_size
                 + mode.guard + mode.fft_size + _DRIFT_MARGIN)
    if x.shape[-1] < frame_len:
        # shorter-than-a-frame inputs (unit tests, tail blocks): edge-pad
        # so the frame window fits
        pad = x[..., -1:].expand(*x.shape[:-1], frame_len - x.shape[-1])
        x = torch.cat([x, pad], dim=-1)
    fs = frame_starts.to(torch.int64)
    # Absolute sample index of the first sample of every symbol window
    # (also the CFO ramp's phase reference: the block timebase).
    starts = (fs[..., None] + mode.null_size + sym_idx * mode.symbol_size
              + mode.guard + drift_adj.unsqueeze(-2))       # (..., F, 76)
    tap = torch.arange(mode.fft_size, device=dev)
    local = (mode.null_size + sym_idx[:, None] * mode.symbol_size
             + mode.guard + drift_adj[..., None] + tap)     # (..., 76, T_u)
    # the clamped frame windows' flat starts, then each symbol inside
    frames = window_starts(x, fs, frame_len)                # (..., F)
    win = x.reshape(-1)[frames[..., None, None] + local.unsqueeze(-3)]
    idx = starts[..., None] + tap
    cfo = torch.as_tensor(cfo_norm, dtype=torch.float32, device=dev)
    # exp(-j*2*pi*f*t): f in carrier spacings, t in samples / T_u.
    phase = -2.0 * math.pi * torch.remainder(
        cfo[..., None, None, None] * idx.to(torch.float32) / mode.fft_size,
        1.0)
    return win * _rot(phase)


def demod_frames(x: torch.Tensor, frame_starts: torch.Tensor,
                 mode: Mode = MODE_I,
                 cfo_norm: torch.Tensor | float = 0.0,
                 drift: torch.Tensor | float = 0.0):
    """Full-block OFDM demod: samples -> soft bits, for one stream or a
    leading axis of B streams (arguments as
    :func:`gather_symbol_windows`').

    Returns ``(soft, diag)``: soft (..., F, n_symbols-1, 2*K) float32
    with positive => coded bit 0 (symbol 0 of each frame is the PRS,
    consumed as the differential reference); ``diag`` holds per-frame
    magnitudes, (..., F).
    """
    dev = x.device
    win = gather_symbol_windows(x, frame_starts, mode, cfo_norm, drift)
    spec = torch.fft.fft(win, dim=-1)
    # Undo the per-symbol drift-adjustment window shifts in phase so every
    # symbol is referenced to one timebase.
    adj = _drift_adjustment(drift, _sym_pos(mode, dev), mode)
    bins = torch.arange(mode.fft_size, dtype=torch.float32, device=dev)
    ph = -2.0 * math.pi * torch.remainder(
        adj[..., None] * bins / mode.fft_size, 1.0)
    spec = spec * _rot(ph).unsqueeze(-3)
    z = spec[..., 1:, :] * torch.conj(spec[..., :-1, :])
    q = z[..., _interleave_idx(mode, dev)]
    mag = q.abs()
    # Normalize per frame so Viterbi metrics are SNR-comparable.
    scale = mag.mean(dim=(-2, -1), keepdim=True) + 1e-20
    qn = q / scale
    soft = torch.cat([qn.real, qn.imag], dim=-1).to(torch.float32)
    diag = {
        "carrier_mag_mean": scale[..., 0, 0],
        # dispersion of |q| around its mean: crude per-frame SNR proxy
        # (population std, as jnp.std)
        "carrier_mag_cv": (mag.std(dim=(-2, -1), correction=0)
                           / scale[..., 0, 0]),
    }
    return soft, diag


def cfo_from_hz(cfo_hz, mode: Mode = MODE_I):
    """Convert Hz to carrier-spacing units used by ``gather_symbol_windows``
    (on the host: a Python scalar or a NumPy array in, the same out)."""
    carrier_spacing = SAMPLE_RATE / mode.fft_size
    return cfo_hz / carrier_spacing

"""Rational-rate polyphase resampler: native SDR rates -> 2.048 Msps.

Port of ``dabtools_tpu/ops/resample.py``.  Converts by L/M with a
polyphase FIR:

  y[n] = sum_k h[k*L + phase(n)] * x[floor(n*M/L) - k]

The host keeps the stream's index bookkeeping in int64 (``n * M`` passes
2^31 after ~14 s of a 2.4 Msps input); the device gathers the input into
(n_out, taps_per_phase) windows in reversed tap order and takes two real
sums against each output phase's tap row.  Streaming keeps an input tail
and the global output index, so chunk boundaries are seamless.  Spans
(``utils/spans.py``) as the channelizer's: ``frontend`` around the call,
``frontend.h2d`` (the three uploads), ``frontend.enqueue``,
``frontend.wait`` and ``frontend.d2h`` inside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dabtools_tpu_torch.constants import SAMPLE_RATE
from dabtools_tpu_torch.ops.fir import design_lowpass
from dabtools_tpu_torch.utils import spans


class Resampler:
    """Convert complex IQ from ``fs_in`` to ``fs_out`` (default DAB rate).

    ``device``: where the filtering runs.  Required; the resampler never
    picks it.  ``__call__`` takes and returns NumPy complex64 arrays.
    """

    def __init__(self, fs_in: int, fs_out: int = SAMPLE_RATE,
                 taps_per_phase: int = 24, beta: float = 8.6, *, device):
        g = math.gcd(int(fs_in), int(fs_out))
        self.up = fs_out // g          # L
        self.down = fs_in // g         # M
        if self.up > 512:
            raise ValueError(
                f"{fs_in} -> {fs_out} needs interpolation factor {self.up}; "
                "choose a rationally-related capture rate")
        self.device = torch.device(device)
        self.fs_in, self.fs_out = int(fs_in), int(fs_out)
        n_taps = taps_per_phase * self.up
        # cutoff at the tighter of the two Nyquists, in units of fs_in*L
        cutoff = 0.45 * min(fs_in, fs_out)
        proto = design_lowpass(n_taps, cutoff / (fs_in * self.up), beta)
        proto *= self.up               # interpolation gain
        # polyphase bank: phase p uses taps h[p], h[p+L], ...
        self.bank = proto.reshape(taps_per_phase, self.up).T.copy()
        self.taps_per_phase = taps_per_phase
        self._tail = np.zeros(taps_per_phase - 1, dtype=np.complex64)
        self._next_out = 0             # global output index
        self._consumed = 0             # global input samples consumed
        self._bank_dev = torch.from_numpy(self.bank).to(self.device)
        self._taps_rev = torch.arange(taps_per_phase - 1, -1, -1,
                                      device=self.device)

    def _resample_chunk(self, x, phases, starts):
        # x: (n_in,) complex64; windows: (n_out, T) via gather
        idx = starts[:, None] + self._taps_rev[None, :]
        win = x[idx]                               # (n_out, T)
        taps = self._bank_dev[phases]              # (n_out, T)
        yr = torch.sum(win.real * taps, dim=-1)
        yi = torch.sum(win.imag * taps, dim=-1)
        return torch.complex(yr, yi)

    def __call__(self, samples: np.ndarray) -> np.ndarray:
        with spans.span("frontend"):
            return self._call(samples)

    def _call(self, samples: np.ndarray) -> np.ndarray:
        x = np.concatenate([self._tail,
                            np.asarray(samples, dtype=np.complex64)])
        base = self._consumed - self._tail.size    # global idx of x[0]
        t = self.taps_per_phase
        # output n uses inputs [floor(n*M/L) - t + 1 .. floor(n*M/L)]
        n0 = self._next_out
        # last output whose newest input is within x:
        last_in = base + x.size - 1
        n1 = (last_in * self.up + self.up - 1) // self.down  # upper bound
        while n1 * self.down // self.up > last_in:
            n1 -= 1
        if n1 < n0:
            self._tail = x[-(t - 1):] if x.size >= t - 1 else x
            self._consumed = base + x.size
            return np.zeros(0, dtype=np.complex64)
        n = np.arange(n0, n1 + 1, dtype=np.int64)
        newest = n * self.down // self.up          # global input index
        starts = (newest - base) - (t - 1)
        # warmup is covered by the zero-filled initial tail, so starts is
        # always non-negative (the first call's base is -(t-1))
        if starts.min() < 0:
            raise AssertionError("resampler window before buffer start")
        phases = (n * self.down) % self.up
        with spans.span("frontend.h2d",
                        x.nbytes + phases.nbytes + starts.nbytes):
            x_dev, phases_dev, starts_dev = (
                torch.from_numpy(a).to(self.device)
                for a in (x, phases, starts))
        with spans.span("frontend.enqueue"):
            y = self._resample_chunk(x_dev, phases_dev, starts_dev)
        y = spans.download(y, "frontend.wait", "frontend.d2h")
        self._next_out = int(n[-1]) + 1
        self._tail = x[-(t - 1):].copy()
        self._consumed = base + x.size
        return y

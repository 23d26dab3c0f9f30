"""Rational-rate polyphase resampler: native SDR rates -> 2.048 Msps.

Port of ``dabtools_tpu/ops/resample.py``.  Converts by L/M with a
polyphase FIR:

  y[n] = sum_k h[k*L + phase(n)] * x[floor(n*M/L) - k]

The host keeps the stream's bookkeeping in exact Python integers (``n *
M`` passes 2^31 after ~14 s of a 2.4 Msps input) and hands the device
three scalars a call: output ``i`` of the call has ``t = r0 + i*M``,
window start ``s0 + t // L`` in ``tail ++ x`` and phase ``t % L``.  On a
CUDA tensor one hand-written kernel (``csrc/resample.cu``, wrapper
:func:`resample_cuda`) forms the windows and filters them; on a CPU
tensor :func:`resample_plain` gathers (n_out, taps_per_phase) windows in
reversed tap order and takes two real sums against each output phase's
tap row.  Streaming keeps the last ``taps_per_phase - 1`` inputs and the
global output index, so chunk boundaries are seamless: the host keeps
the tail as NumPy, the device as the end of the last upload, which the
kernel reads through a second pointer (the samples are never
concatenated on the host).  The output stays on the device: the
receiver takes it there.  Spans (``utils/spans.py``) as the
channelizer's: ``frontend`` around the call, ``frontend.h2d`` (the new
samples; the tail too after a call that left it on the host alone) and
``frontend.enqueue`` inside it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dabtools_tpu_torch.constants import SAMPLE_RATE
from dabtools_tpu_torch.ops import cudalib
from dabtools_tpu_torch.ops.fir import design_lowpass
from dabtools_tpu_torch.utils import spans

OUTS_PER_BLOCK = 1024               # csrc/resample.cu's outputs a block
SMEM_MAX = 227 * 1024               # shared memory a block may opt into
INT32_MAX = 2 ** 31 - 1


def window_indices(r0: int, s0: int, n_out: int, down: int, up: int,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(phases, starts), int64, of a call's ``n_out`` outputs: output
    ``i`` has ``t = r0 + i*down``, phase ``t % up`` and window start
    ``s0 + t // up`` in ``tail ++ x``."""
    t = r0 + torch.arange(n_out, dtype=torch.int64, device=device) * down
    return t % up, s0 + t // up


def resample_plain(tail: torch.Tensor, x: torch.Tensor, bank: torch.Tensor,
                   r0: int, s0: int, n_out: int, down: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`resample_cuda`: the windows of
    ``tail ++ x`` gathered in reversed tap order, two sums against each
    output's row of ``bank`` (up, taps) float32."""
    up, taps = bank.shape
    phases, starts = window_indices(r0, s0, n_out, down, up, x.device)
    idx = starts[:, None] + torch.arange(taps - 1, -1, -1,
                                         device=x.device)[None, :]
    win = torch.cat([tail, x])[idx]                # (n_out, T)
    w = bank[phases]                               # (n_out, T)
    return torch.complex(torch.sum(win.real * w, dim=-1),
                         torch.sum(win.imag * w, dim=-1))


def _smem_bytes(up: int, down: int, taps: int) -> int:
    """Dynamic shared memory of a ``csrc/resample.cu`` block: the bank in
    rows of odd stride, then the block's input span."""
    span = (up - 1 + (OUTS_PER_BLOCK - 1) * down) // up + taps
    smem = (up * (taps | 1) * 4 + 7) // 8 * 8 + span * 8
    if smem > SMEM_MAX or (OUTS_PER_BLOCK - 1) * down + up > INT32_MAX:
        raise ValueError(f"L/M = {up}/{down} at {taps} taps a phase: a "
                         f"block's input span does not fit shared memory")
    return smem


def resample_cuda(tail: torch.Tensor, x: torch.Tensor, bank: torch.Tensor,
                  r0: int, s0: int, n_out: int, down: int) -> torch.Tensor:
    """The resampler's kernel: ``n_out`` outputs of ``tail ++ x``.

    ``tail``: (taps - 1,) complex64, the inputs before ``x``; ``x``: (n,)
    complex64; ``bank``: (up, taps) float32; ``r0``, ``s0`` as in
    :func:`window_indices`.  Returns (n_out,) complex64.  Counted in
    ``cudalib.launches["dab_resample"]``.
    """
    dev = x.device
    up, taps = bank.shape
    n_x = x.shape[0]
    cudalib.check(tail, "tail", torch.complex64, (taps - 1,), dev, 8)
    cudalib.check(x, "x", torch.complex64, (n_x,), dev, 8)
    cudalib.check(bank, "bank", torch.float32, (up, taps), dev)
    last = s0 + (r0 + (n_out - 1) * down) // up if n_out else 0
    if not (0 <= r0 < up and s0 >= 0 and last < n_x
            and max(n_out, taps - 1 + n_x) <= INT32_MAX):
        raise ValueError(f"windows of r0={r0}, s0={s0}, n_out={n_out} "
                         f"leave the {taps - 1} + {n_x} inputs")
    y = torch.empty((n_out,), dtype=torch.complex64, device=dev)
    if n_out == 0:
        return y
    smem = _smem_bytes(up, down, taps)
    lib = cudalib.build()
    cudalib.launch(lib.dab_resample, tail.data_ptr(), x.data_ptr(),
                   bank.data_ptr(), y.data_ptr(), r0, s0, n_out, down, up,
                   taps, OUTS_PER_BLOCK, smem, device=dev)
    return y


class Resampler:
    """Convert complex IQ from ``fs_in`` to ``fs_out`` (default DAB rate).

    ``device``: where the filtering runs.  Required; the resampler never
    picks it.  ``__call__`` takes a NumPy complex64 array and returns an
    (n_out,) complex64 tensor on the device, launched but not waited
    for.
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
        # _tail on the device, or None when it must be uploaded
        self._tail_dev = torch.zeros(taps_per_phase - 1,
                                     dtype=torch.complex64,
                                     device=self.device)

    def _plan(self, n_new: int) -> tuple[int, int, int]:
        """(n1, r0, s0) of a call given ``n_new`` samples: its last output
        ``n1`` (no output if below ``_next_out``), and the kernel's
        scalars, exact Python integers."""
        t = self.taps_per_phase
        base = self._consumed - self._tail.size    # global idx of tail[0]
        # output n uses inputs [floor(n*M/L) - t + 1 .. floor(n*M/L)]
        n0 = self._next_out
        # last output whose newest input is within tail ++ samples:
        last_in = self._consumed + n_new - 1
        n1 = (last_in * self.up + self.up - 1) // self.down  # upper bound
        while n1 * self.down // self.up > last_in:
            n1 -= 1
        q0, r0 = divmod(n0 * self.down, self.up)
        # window starts are non-decreasing, so s0 is the least; warmup is
        # covered by the zero-filled initial tail, so it is never negative
        # (the first call's base is -(t-1))
        return n1, r0, q0 - base - (t - 1)

    def __call__(self, samples: np.ndarray) -> torch.Tensor:
        with spans.span("frontend"):
            return self._call(samples)

    def _call(self, samples: np.ndarray) -> torch.Tensor:
        x = np.asarray(samples, dtype=np.complex64)
        if not x.flags.writeable:
            x = x.copy()
        keep = self.taps_per_phase - 1
        n0 = self._next_out
        n1, r0, s0 = self._plan(x.size)
        tail = np.concatenate([self._tail, x[-keep:]])[-keep:]
        if n1 < n0:
            if x.size:
                self._tail_dev = None
            self._tail = tail
            self._consumed += x.size
            return torch.zeros(0, dtype=torch.complex64, device=self.device)
        if s0 < 0:
            raise AssertionError("resampler window before buffer start")
        up_tail = self._tail_dev is None
        with spans.span("frontend.h2d",
                        x.nbytes + up_tail * self._tail.nbytes):
            if up_tail:
                self._tail_dev = torch.from_numpy(self._tail).to(
                    self.device, copy=True)
            x_dev = torch.from_numpy(x).to(self.device, copy=True)
        with spans.span("frontend.enqueue"):
            fn = resample_cuda if x_dev.is_cuda else resample_plain
            y = fn(self._tail_dev, x_dev, self._bank_dev, r0, s0,
                   n1 - n0 + 1, self.down)
        self._next_out = n1 + 1
        self._tail = tail
        self._tail_dev = x_dev[-keep:] if x.size >= keep else None
        self._consumed += x.size
        return y

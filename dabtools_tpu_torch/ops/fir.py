"""Wideband channelizer: one capture -> many DAB blocks.

Port of ``dabtools_tpu/ops/fir.py``.  The host side (filter design,
method choice, overlap-save bookkeeping, exact integer mixer phases) is
the JAX module's; the device side is torch on the channelizer's device:

* ``fft``: overlap-save frequency-domain filtering — one batched FFT per
  chunk, mixing as an exact integer spectrum roll (one gather for all
  channels), filtering as a bin product, decimation as alias folding
  (``reshape(n_chunks, K, decim, nd).sum(2)``) before a short IFFT.
* ``direct``: the modulated filter bank as ONE strided ``conv1d`` with
  2K real output channels, then a periodic output derotation.  It runs
  in IEEE float32 whatever the process-wide TF32 setting: cuDNN rounds a
  float32 convolution's inputs to TF32 by default, which would cost the
  filter three decimal digits.

``__call__`` takes a NumPy array, (n,) complex64 wideband samples, and
returns a tensor on the channelizer's device, (K, n_out) complex64
baseband: one upload (two for ``fft``: the samples and the mixer
phases) and no download, since the receivers take the rows on the
device.  Spans (``utils/spans.py``): ``frontend`` around the call, and
inside it ``frontend.h2d`` and ``frontend.enqueue``; the rest of
``frontend`` is the host's own work.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from dabtools_tpu_torch.constants import SAMPLE_RATE
from dabtools_tpu_torch.utils import spans


def design_lowpass(num_taps: int, cutoff_norm: float,
                   beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed sinc low-pass; ``cutoff_norm`` = cutoff / fs."""
    n = np.arange(num_taps) - (num_taps - 1) / 2
    h = 2 * cutoff_norm * np.sinc(2 * cutoff_norm * n)
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


class Channelizer:
    """Split a wideband IQ stream into DAB baseband blocks.

    ``offsets_hz``: centre-frequency offset of each DAB block relative to
    the capture centre (integer Hz, on the receiver raster).

    ``method``:
      * ``"fft"`` (default when every offset is FFT-bin-aligned):
        overlap-save frequency-domain filtering.
      * ``"direct"``: strided convolution; also the cross-check reference
        for the fft method.

    ``device``: where the filtering runs.  Required; the channelizer
    never picks it.
    """

    N_FFT = 4096

    def __init__(self, fs_in: int, offsets_hz: list[int],
                 num_taps: int | None = None, out_rate: int = SAMPLE_RATE,
                 method: str = "auto", *, device):
        if fs_in % out_rate:
            raise ValueError(
                f"fs_in ({fs_in}) must be an integer multiple of the DAB "
                f"rate ({out_rate})")
        self.device = torch.device(device)
        self.fs_in = int(fs_in)
        self.decim = fs_in // out_rate
        self.offsets_hz = [int(f) for f in offsets_hz]
        for f in self.offsets_hz:
            if abs(f) > fs_in / 2:
                raise ValueError(f"offset {f} Hz outside capture bandwidth")
        if num_taps is None:
            # transition 0.768->0.944 MHz (adjacent-block spacing 1.712 MHz)
            trans = 0.176e6 / fs_in
            num_taps = int(np.ceil(5.0 / trans)) | 1
        self.num_taps = num_taps
        self.taps = design_lowpass(num_taps, cutoff_norm=0.85e6 / fs_in)
        self._mixers = [self._mixer_table(f) for f in self.offsets_hz]
        self._consumed = 0              # wideband samples consumed so far
        self._tail: np.ndarray | None = None

        bin_hz = fs_in / self.N_FFT
        aligned = all(f % bin_hz == 0 for f in self.offsets_hz)
        if method not in ("auto", "fft", "direct"):
            raise ValueError(f"unknown channelizer method {method!r}")
        # The overlap-save hop must be a positive multiple of decim:
        # num_taps <= N_FFT - decim guarantees it.
        fft_fits = num_taps <= self.N_FFT - self.decim
        if method == "auto":
            method = "fft" if aligned and fft_fits else "direct"
        if method == "fft" and not aligned:
            raise ValueError("fft method needs bin-aligned offsets "
                             f"(multiples of {bin_hz:.0f} Hz)")
        if method == "fft" and not fft_fits:
            raise ValueError(
                f"fft method needs num_taps <= {self.N_FFT - self.decim} "
                f"(N_FFT - decim) for a positive overlap-save hop; "
                f"got {num_taps}.  Use method='direct'.")
        self.method = method
        dev = self.device
        if method == "fft":
            n = self.N_FFT
            # correlation (to match the direct conv) => conjugated spectrum
            h = np.zeros(n, dtype=np.complex64)
            h[: num_taps] = self.taps
            self._hspec = np.conj(np.fft.fft(h)).astype(np.complex64)
            self._bin_shift = [int(f / bin_hz) for f in self.offsets_hz]
            self.hop = (n - num_taps + 1) // self.decim * self.decim
            # every channel's spectrum roll as one (K, n) gather index
            roll = ((np.arange(n)[None, :]
                     + np.array(self._bin_shift)[:, None]) % n)
            self._roll_dev = torch.from_numpy(roll.astype(np.int64)).to(dev)
            self._hspec_dev = torch.from_numpy(self._hspec).to(dev)
        else:
            # Modulated complex taps h[k] * mix_c[k], as 2K real filters
            # (re parts, then im parts), and each channel's mixer table.
            k = np.arange(num_taps)
            hh = np.stack([m[k % m.size] * self.taps for m in self._mixers])
            filt = np.concatenate([hh.real, hh.imag]).astype(np.float32)
            self._filt_dev = torch.from_numpy(filt[:, None, :]).to(dev)
            self._mixers_dev = [torch.from_numpy(m).to(dev)
                                for m in self._mixers]

    def _mixer_table(self, f_hz: int) -> np.ndarray:
        g = math.gcd(abs(f_hz), self.fs_in) or self.fs_in
        q = self.fs_in // g
        p = f_hz // g
        i = np.arange(q, dtype=np.float64)
        return np.exp(-2j * np.pi * p * i / q).astype(np.complex64)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        a = np.require(x, requirements="CW")
        with spans.span("frontend.h2d", a.nbytes):
            return torch.from_numpy(a).to(self.device)

    def __call__(self, x: np.ndarray) -> torch.Tensor:
        """Feed wideband samples; returns (K, n_out) baseband complex64
        on the channelizer's device, launched but not waited for.

        Streaming: keeps the (taps-1)-sample tail and absolute phase so
        consecutive calls are seamless.
        """
        with spans.span("frontend"):
            return self._call(x)

    def _empty(self) -> torch.Tensor:
        return torch.zeros((len(self.offsets_hz), 0), dtype=torch.complex64,
                           device=self.device)

    def _call(self, x: np.ndarray) -> torch.Tensor:
        x = np.asarray(x, dtype=np.complex64)
        if self._tail is not None:
            x = np.concatenate([self._tail, x])
            start = self._consumed - self._tail.size
        else:
            start = 0
        if self.method == "fft":
            return self._call_fft(x, start)
        # Output m uses inputs [mM, mM + taps); keep the unfinished tail.
        n_out = max(0, (x.size - self.num_taps) // self.decim + 1)
        used = n_out * self.decim
        self._tail = x[used:].copy()
        self._consumed = start + used + self._tail.size
        if n_out == 0:
            return self._empty()
        phases = tuple(int((start) % m.size) for m in self._mixers)
        x_dev = self._upload(x[: used + self.num_taps - 1])
        with spans.span("frontend.enqueue"):
            return _channelize(x_dev, self._filt_dev, self._mixers_dev,
                               phases, self.decim)

    def _call_fft(self, x: np.ndarray, start: int) -> torch.Tensor:
        n, hop = self.N_FFT, self.hop
        n_chunks = max(0, (x.size - n) // hop + 1)
        n_out = n_chunks * (hop // self.decim)
        used = n_out * self.decim
        self._tail = x[used:].copy()
        self._consumed = start + used + self._tail.size
        if n_chunks == 0:
            return self._empty()
        # Per-(offset, chunk) global mixer phase at the chunk start,
        # computed with exact integer arithmetic (no float accumulation).
        phases = np.empty((len(self.offsets_hz), n_chunks),
                          dtype=np.complex64)
        starts = start + np.arange(n_chunks, dtype=np.int64) * hop
        for k, f in enumerate(self.offsets_hz):
            g = math.gcd(abs(f), self.fs_in) or self.fs_in
            p, q = f // g, self.fs_in // g
            phases[k] = np.exp(-2j * np.pi * ((starts % q) * p % q) / q)
        x_dev = self._upload(x[: (n_chunks - 1) * hop + n])
        phases_dev = self._upload(phases)
        with spans.span("frontend.enqueue"):
            return _channelize_fft(x_dev, self._hspec_dev, phases_dev,
                                   self._roll_dev, n_fft=n, hop=hop,
                                   decim=self.decim)


def _channelize_fft(x, hspec, phases, roll, *, n_fft, hop, decim):
    """Overlap-save chunks -> (K, n_chunks * hop // decim) baseband.
    ``roll``: (K, n_fft) int64, each channel's spectrum roll."""
    n_chunks = (x.shape[0] - n_fft) // hop + 1
    nd = n_fft // decim
    n_ch = roll.shape[0]
    idx = (torch.arange(n_chunks, device=x.device)[:, None] * hop
           + torch.arange(n_fft, device=x.device)[None, :])
    spec = torch.fft.fft(x[idx], dim=-1)           # (n_chunks, n_fft)
    # All channels' spectrum rolls as one gather, then ONE batched IFFT
    # over (n_chunks, K, nd).
    mixed = spec[:, roll] * hspec[None, None, :]   # (n_chunks, K, n_fft)
    folded = mixed.reshape(n_chunks, n_ch, decim, nd).sum(dim=2)
    z = torch.fft.ifft(folded, dim=-1) / decim     # (n_chunks, K, nd)
    z = z[:, :, : hop // decim] * phases.T[:, :, None]
    return z.permute(1, 0, 2).reshape(n_ch, -1)


def _channelize(x, filt, mixers, phases, decim):
    """Modulated-filter-bank form of mix -> FIR -> decimate.

    y_c[m] = sum_k h[k] x[mD+k] mix_c[start+mD+k]
           = mix_c[start+mD] * sum_k (h[k] mix_c[k]) x[mD+k],
    so all K channels are ONE strided conv with 2K real output channels
    (``filt``: (2K, 1, T), re parts then im parts of the modulated taps)
    plus a periodic output derotation: the wideband input is read once.
    ``phases``: each channel's mixer index at ``x[0]`` (host ints).
    """
    n_ch = len(mixers)
    planes = torch.stack([x.real, x.imag])[:, None, :]       # (2, 1, n)
    cudnn = torch.backends.cudnn
    # IEEE float32 for this convolution only; the global setting is
    # restored on exit.
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv1d(planes, filt, stride=decim)
    # y[b, oc]: b = re/im of x; oc < K = re(taps), oc >= K = im(taps)
    yr = y[0, :n_ch] - y[1, n_ch:]                 # (K, n_out)
    yi = y[0, n_ch:] + y[1, :n_ch]
    z = torch.complex(yr, yi)
    m = torch.arange(z.shape[1], dtype=torch.int64, device=x.device)
    derot = torch.stack([mix[torch.remainder(ph + m * decim, mix.shape[0])]
                         for mix, ph in zip(mixers, phases)])
    return z * derot

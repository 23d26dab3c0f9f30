"""Wrappers of the hand-written Viterbi CUDA kernels.

From ``dabtools_tpu_torch/csrc/viterbi4.cu`` (radix-4, even trellis
lengths): K1 ``acs4`` (replaces
``dabtools_tpu/ops/viterbi_pallas4.py::_acs4_kernel``), K2 ``traceback4``
(replaces ``::_traceback4_kernel``) and K2' ``traceback4_onehot64``
(replaces ``::_traceback4_kernel_onehot64``).  From
``dabtools_tpu_torch/csrc/viterbi2.cu`` (radix-2, odd trellis lengths): K3
``acs2`` (replaces ``dabtools_tpu/ops/viterbi_pallas.py::_acs_kernel``)
and K4 ``traceback2`` (replaces ``::_traceback_kernel``).  Their plain
PyTorch versions are ``ops/viterbi.py::acs4_plain``, ``::traceback4_plain``,
``::traceback4_onehot64_plain``, ``::acs2_plain`` and ``::traceback2_plain``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty`` and launches through ``cudalib.launch``, on
the tensor's device on PyTorch's current stream, which counts it in
``cudalib.launches`` under its C symbol (``dab_acs4``, ``dab_traceback4``,
``dab_traceback4_onehot64``, ``dab_acs2``, ``dab_traceback2``).
"""

from __future__ import annotations

import torch

from dabtools_tpu_torch.ops import cudalib

CHUNK = 32              # (double) steps per staged chunk: kChunk of
                        # csrc/viterbi4.cu (K1/K2/K2') and csrc/viterbi2.cu
                        # (K3/K4), for the tests' chunk edges

build = cudalib.build   # rxbench/drive.py builds the library by this name


def acs4(soft8: torch.Tensor, t2: torch.Tensor, ws4: torch.Tensor):
    """K1: radix-4 ACS forward pass.

    ``soft8``: (B, T2, 8) float32; ``t2``: (B,) int32 lane lengths in
    double steps; ``ws4``: (256, 8) float32 branch-metric signs.  Returns
    ``(dec (B, T2, 4) int32 packed decisions, metric (B,) float32)``.
    """
    dev = soft8.device
    b, t2_max = soft8.shape[0], soft8.shape[1]
    cudalib.check(soft8, "soft8", torch.float32, (b, t2_max, 8), dev)
    cudalib.check(t2, "t2", torch.int32, (b,), dev)
    cudalib.check(ws4, "ws4", torch.float32, (256, 8), dev)
    lib = cudalib.build()
    dec = torch.empty((b, t2_max, 4), dtype=torch.int32, device=dev)
    metric = torch.empty((b,), dtype=torch.float32, device=dev)
    cudalib.launch(lib.dab_acs4, soft8.data_ptr(), t2.data_ptr(),
                   ws4.data_ptr(), dec.data_ptr(), metric.data_ptr(), b,
                   t2_max, device=dev)
    return dec, metric


def _traceback(fn_name: str, dec: torch.Tensor, words: int,
               steps_per_word: int) -> torch.Tensor:
    """Launch a traceback on ``dec`` (B, T, words) int32; returns bits
    (B, steps_per_word * T) uint8."""
    dev = dec.device
    b, t_max = dec.shape[0], dec.shape[1]
    cudalib.check(dec, "dec", torch.int32, (b, t_max, words), dev)
    lib = cudalib.build()
    bits = torch.empty((b, steps_per_word * t_max), dtype=torch.uint8,
                       device=dev)
    cudalib.launch(getattr(lib, fn_name), dec.data_ptr(), bits.data_ptr(),
                   b, t_max, device=dev)
    return bits


def traceback4(dec: torch.Tensor) -> torch.Tensor:
    """K2: survivor walk from state 0.  ``dec``: (B, T2, 4) int32 from
    :func:`acs4`.  Returns bits (B, 2*T2) uint8."""
    return _traceback("dab_traceback4", dec, 4, 2)


def traceback4_onehot64(dec: torch.Tensor) -> torch.Tensor:
    """K2': the same function as :func:`traceback4`, with the survivor
    state carried as a 64-state one-hot mask, never as a state index."""
    return _traceback("dab_traceback4_onehot64", dec, 4, 2)


def acs2(soft4: torch.Tensor, ws2: torch.Tensor):
    """K3: radix-2 ACS forward pass.

    ``soft4``: (B, T, 4) float32; ``ws2``: (128, 4) float32 branch-metric
    signs (``viterbi.ws2_table()``).  Returns ``(dec (B, T, 2) int32
    decision words, metric (B,) float32)``.
    """
    dev = soft4.device
    b, t_max = soft4.shape[0], soft4.shape[1]
    cudalib.check(soft4, "soft4", torch.float32, (b, t_max, 4), dev)
    cudalib.check(ws2, "ws2", torch.float32, (128, 4), dev)
    lib = cudalib.build()
    dec = torch.empty((b, t_max, 2), dtype=torch.int32, device=dev)
    metric = torch.empty((b,), dtype=torch.float32, device=dev)
    cudalib.launch(lib.dab_acs2, soft4.data_ptr(), ws2.data_ptr(),
                   dec.data_ptr(), metric.data_ptr(), b, t_max, device=dev)
    return dec, metric


def traceback2(dec: torch.Tensor) -> torch.Tensor:
    """K4: radix-2 survivor walk from state 0.  ``dec``: (B, T, 2) int32
    from :func:`acs2`.  Returns bits (B, T) uint8."""
    return _traceback("dab_traceback2", dec, 2, 1)

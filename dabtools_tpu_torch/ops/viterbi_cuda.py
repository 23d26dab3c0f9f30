"""Wrappers of the hand-written radix-4 Viterbi CUDA kernels.

K1 ``acs4`` (replaces ``dabtools_tpu/ops/viterbi_pallas4.py::_acs4_kernel``)
and K2 ``traceback4`` (replaces ``::_traceback4_kernel``), from
``dabtools_tpu_torch/csrc/viterbi4.cu``.  Their plain PyTorch versions are
``ops/viterbi.py::acs4_plain`` and ``::traceback4_plain``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
library lives in ``dabtools_tpu_torch/_build/`` (git-ignored) under a name
keyed on a hash of the sources and flags, so a changed source rebuilds and
a fresh checkout builds on its first call.  A failed build, a failed
launch or a nonzero ``cudaGetLastError()`` raises; nothing falls back.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the tensor's device on PyTorch's
current stream, and adds one to its launch counter (``acs4_launches``,
``traceback4_launches``) per launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

acs4_launches = 0
traceback4_launches = 0
build_log = ""          # nvcc's output (ptxas register/smem report)

_lib: ctypes.CDLL | None = None


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdabviterbi4_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the Viterbi kernels need the "
                           "CUDA toolkit to build")
    return found


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in _sources() if s.suffix == ".cu"]]
        r = subprocess.run(cmd, capture_output=True, text=True, check=False)
        build_log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dab_acs4.restype = ci
    lib.dab_acs4.argtypes = [vp, vp, vp, vp, vp, ci, ci, vp]
    lib.dab_traceback4.restype = ci
    lib.dab_traceback4.argtypes = [vp, vp, ci, ci, vp]
    _lib = lib
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _launch(fn, *args, device: torch.device) -> None:
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def acs4(soft8: torch.Tensor, t2: torch.Tensor, ws4: torch.Tensor):
    """K1: radix-4 ACS forward pass.

    ``soft8``: (B, T2, 8) float32; ``t2``: (B,) int32 lane lengths in
    double steps; ``ws4``: (256, 8) float32 branch-metric signs.  Returns
    ``(dec (B, T2, 4) int32 packed decisions, metric (B,) float32)``.
    """
    global acs4_launches
    dev = soft8.device
    b, t2_max = soft8.shape[0], soft8.shape[1]
    _check(soft8, "soft8", torch.float32, (b, t2_max, 8), dev)
    _check(t2, "t2", torch.int32, (b,), dev)
    _check(ws4, "ws4", torch.float32, (256, 8), dev)
    lib = build()
    dec = torch.empty((b, t2_max, 4), dtype=torch.int32, device=dev)
    metric = torch.empty((b,), dtype=torch.float32, device=dev)
    _launch(lib.dab_acs4, soft8.data_ptr(), t2.data_ptr(), ws4.data_ptr(),
            dec.data_ptr(), metric.data_ptr(), b, t2_max, device=dev)
    acs4_launches += 1
    return dec, metric


def traceback4(dec: torch.Tensor) -> torch.Tensor:
    """K2: survivor walk from state 0.  ``dec``: (B, T2, 4) int32 from
    :func:`acs4`.  Returns bits (B, 2*T2) uint8."""
    global traceback4_launches
    dev = dec.device
    b, t2_max = dec.shape[0], dec.shape[1]
    _check(dec, "dec", torch.int32, (b, t2_max, 4), dev)
    lib = build()
    bits = torch.empty((b, 2 * t2_max), dtype=torch.uint8, device=dev)
    _launch(lib.dab_traceback4, dec.data_ptr(), bits.data_ptr(), b, t2_max,
            device=dev)
    traceback4_launches += 1
    return bits

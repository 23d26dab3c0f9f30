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

Each source is compiled at first use with ``nvcc`` for ``sm_90a``, all of
them at once, and linked into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lives in
``dabtools_tpu_torch/_build/`` (git-ignored) under a name keyed on a hash
of the sources and flags, so a changed source rebuilds and a fresh
checkout builds on its first call.  A failed build, a failed launch or a
nonzero ``cudaGetLastError()`` raises; nothing falls back.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs with ``torch.empty``, launches on the tensor's device on PyTorch's
current stream, and adds one to its launch counter (``acs4_launches``,
``traceback4_launches``, ``traceback4_onehot64_launches``,
``acs2_launches``, ``traceback2_launches``) per launch.
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

CHUNK = 32              # (double) steps per staged chunk: kChunk of
                        # csrc/viterbi4.cu (K1/K2/K2') and csrc/viterbi2.cu
                        # (K3/K4), for the tests' chunk edges

acs4_launches = 0
traceback4_launches = 0
traceback4_onehot64_launches = 0
acs2_launches = 0
traceback2_launches = 0
build_log = ""          # nvcc's output (ptxas register/smem report)

_lib: ctypes.CDLL | None = None


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdabviterbi_{h.hexdigest()[:16]}.so"


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


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their joined output, or raise
    with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    if any(p.returncode for p in procs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library: one
    ``nvcc -c`` per source, all started together, then one link."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        srcs = [s for s in _sources() if s.suffix == ".cu"]
        objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
        build_log = _run([[_nvcc(), *compile_flags, "-c", str(s), "-o",
                           str(o)] for s, o in zip(srcs, objs)])
        tmp = so.with_name(f"{tag}.so.tmp")
        build_log += _run([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                            *map(str, objs)]])
        for o in objs:
            o.unlink()
        os.replace(tmp, so)
    _lib = load(so)
    return _lib


def load(so: pathlib.Path) -> ctypes.CDLL:
    """Load a library built from the kernel sources and declare its C
    interface."""
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, args in (("dab_acs4", [vp, vp, vp, vp, vp, ci, ci, vp]),
                       ("dab_traceback4", [vp, vp, ci, ci, vp]),
                       ("dab_traceback4_onehot64", [vp, vp, ci, ci, vp]),
                       ("dab_acs2", [vp, vp, vp, vp, ci, ci, vp]),
                       ("dab_traceback2", [vp, vp, ci, ci, vp])):
        fn = getattr(lib, name)
        fn.restype = ci
        fn.argtypes = args
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


def _traceback(fn_name: str, dec: torch.Tensor, words: int,
               steps_per_word: int) -> torch.Tensor:
    """Launch a traceback on ``dec`` (B, T, words) int32; returns bits
    (B, steps_per_word * T) uint8."""
    dev = dec.device
    b, t_max = dec.shape[0], dec.shape[1]
    _check(dec, "dec", torch.int32, (b, t_max, words), dev)
    lib = build()
    bits = torch.empty((b, steps_per_word * t_max), dtype=torch.uint8,
                       device=dev)
    _launch(getattr(lib, fn_name), dec.data_ptr(), bits.data_ptr(), b,
            t_max, device=dev)
    return bits


def traceback4(dec: torch.Tensor) -> torch.Tensor:
    """K2: survivor walk from state 0.  ``dec``: (B, T2, 4) int32 from
    :func:`acs4`.  Returns bits (B, 2*T2) uint8."""
    global traceback4_launches
    bits = _traceback("dab_traceback4", dec, 4, 2)
    traceback4_launches += 1
    return bits


def traceback4_onehot64(dec: torch.Tensor) -> torch.Tensor:
    """K2': the same function as :func:`traceback4`, with the survivor
    state carried as a 64-state one-hot mask, never as a state index."""
    global traceback4_onehot64_launches
    bits = _traceback("dab_traceback4_onehot64", dec, 4, 2)
    traceback4_onehot64_launches += 1
    return bits


def acs2(soft4: torch.Tensor, ws2: torch.Tensor):
    """K3: radix-2 ACS forward pass.

    ``soft4``: (B, T, 4) float32; ``ws2``: (128, 4) float32 branch-metric
    signs (``acs_matmul_matrices()[1]``).  Returns ``(dec (B, T, 2) int32
    decision words, metric (B,) float32)``.
    """
    global acs2_launches
    dev = soft4.device
    b, t_max = soft4.shape[0], soft4.shape[1]
    _check(soft4, "soft4", torch.float32, (b, t_max, 4), dev)
    _check(ws2, "ws2", torch.float32, (128, 4), dev)
    lib = build()
    dec = torch.empty((b, t_max, 2), dtype=torch.int32, device=dev)
    metric = torch.empty((b,), dtype=torch.float32, device=dev)
    _launch(lib.dab_acs2, soft4.data_ptr(), ws2.data_ptr(), dec.data_ptr(),
            metric.data_ptr(), b, t_max, device=dev)
    acs2_launches += 1
    return dec, metric


def traceback2(dec: torch.Tensor) -> torch.Tensor:
    """K4: radix-2 survivor walk from state 0.  ``dec``: (B, T, 2) int32
    from :func:`acs2`.  Returns bits (B, T) uint8."""
    global traceback2_launches
    bits = _traceback("dab_traceback2", dec, 2, 1)
    traceback2_launches += 1
    return bits

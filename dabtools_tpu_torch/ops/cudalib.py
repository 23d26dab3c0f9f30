"""The port's CUDA library: every kernel of ``dabtools_tpu_torch/csrc/``
in one shared library with a plain C interface, loaded with ``ctypes``,
and the input checks and launch that its wrappers share.

The wrappers sit beside their callers, each knowing only its own kernel:
``ops/viterbi_cuda.py`` (K1-K4 and K2') and ``ops/resample.py``
(``resample_cuda``).  A new kernel declares its C signature in
:data:`SIGNATURES` and launches through :func:`launch`.

Each ``.cu`` source is compiled at first use with ``nvcc`` for
``sm_90a``, all of them at once, and linked into one library in a
``_build/`` directory beside the sources (git-ignored) under a name keyed
on a hash of the sources and flags, so a changed source rebuilds and a
fresh checkout builds on its first call.  A failed build, a failed launch
or a nonzero ``cudaGetLastError()`` raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp, _ci, _cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Every exported symbol's arguments before the trailing stream; each
# returns its cudaError_t as an int.
SIGNATURES = {
    "dab_acs4": (_vp, _vp, _vp, _vp, _vp, _ci, _ci),
    "dab_traceback4": (_vp, _vp, _ci, _ci),
    "dab_traceback4_onehot64": (_vp, _vp, _ci, _ci),
    "dab_acs2": (_vp, _vp, _vp, _vp, _ci, _ci),
    "dab_traceback2": (_vp, _vp, _ci, _ci),
    "dab_resample": (_vp, _vp, _vp, _vp, _cl, _cl, _ci, _ci, _ci, _ci, _ci,
                     _ci),
}

launches: collections.Counter = collections.Counter()   # by symbol
build_log = ""          # nvcc's output (ptxas register/smem report)
lib: ctypes.CDLL | None = None      # the package's library, once built;
                                    # every wrapper launches from it


def _sources(csrc: pathlib.Path) -> list[pathlib.Path]:
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def library_path(csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Where the library of ``csrc``'s sources is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return csrc.parent / "_build" / f"libdabviterbi_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
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


def compile_library(csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """Compile ``csrc``'s sources once per source hash: one ``nvcc -c``
    per source, all started together, then one link.  Returns the
    library's path."""
    global build_log
    so = library_path(csrc)
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        srcs = [s for s in _sources(csrc) if s.suffix == ".cu"]
        objs = [so.parent / f"{tag}.{s.stem}.o" for s in srcs]
        build_log = _run([[_nvcc(), *compile_flags, "-c", str(s), "-o",
                           str(o)] for s, o in zip(srcs, objs)])
        tmp = so.with_name(f"{tag}.so.tmp")
        build_log += _run([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                            *map(str, objs)]])
        for o in objs:
            o.unlink()
        os.replace(tmp, so)
    return so


def load(so: pathlib.Path) -> ctypes.CDLL:
    """Load a library built from the kernel sources and declare its C
    interface."""
    handle = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.restype = _ci
        fn.argtypes = [*args, _vp]
    return handle


def build() -> ctypes.CDLL:
    """The package's library: compiled if need be, loaded once."""
    global lib
    if lib is None:
        lib = load(compile_library())
    return lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device, align: int = 16) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous CUDA tensor on
    ``device`` of ``dtype`` and ``shape``, its data ``align``-byte
    aligned."""
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
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def launch(fn, *args, device: torch.device) -> None:
    """Call ``fn``, a symbol of the library, with ``args`` and PyTorch's
    current stream on ``device``; raise on a nonzero CUDA error, else add
    one to ``launches[fn.__name__]``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    launches[fn.__name__] += 1

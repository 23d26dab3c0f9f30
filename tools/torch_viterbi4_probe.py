#!/usr/bin/env python3
"""What sets the pace of the Viterbi kernels of ``dabtools_tpu_torch`` on a
CUDA card, and how they compare with another version of their sources.

    python3 tools/torch_viterbi4_probe.py [--against CSRC_DIR] [--sass FILE]

1. Times K1 ``acs4``, K2 ``traceback4`` and K2' ``traceback4_onehot64``
   on batches of full-length lanes (1539 double steps, the flagship's MSC
   codewords), and K3 ``acs2`` and
   K4 ``traceback2`` on lanes of 3079 steps (``chip_smoke.py``'s odd
   length), of growing lane count.  One lane alone shows what one
   codeword's chain of steps takes; one lane per SM and one per warp
   scheduler (4 per SM) add no contention for issue slots; beyond 528
   lanes some schedulers hold two.
2. With ``--against``, builds the kernels of another checkout's
   ``dabtools_tpu_torch/csrc`` (for example the parent commit's, unpacked
   with ``git archive``) as the package builds its own, into a ``_build/``
   directory beside those sources, and times all five kernels of both
   builds at the shapes ``chip_smoke.py`` uses, in turns (this, other,
   other, this): K1, K2 and K2' on 640 ragged lanes (64 x 387 + 576 x
   1539 double steps), K3 and K4 on 640 lanes of 3079 steps.  The two
   builds' outputs must be equal.
3. Prints each kernel's SASS instruction count (``cuobjdump``), its
   longest run without a branch (in K1-K4 and K2' the unrolled walk of a
   full chunk, 32 (double) steps), and how many warp votes (``VOTE``),
   shuffles (``SHFL``) and global loads (``LDG``) the kernel and that run
   hold, for this build and the ``--against`` build; ``--sass`` writes
   the whole listing of this build to FILE.

Every time is the median over 10 pairs of CUDA events, each pair around
20 launches back to back, divided by 20.  Prints the card's name and
power limit first and the SM clock after the runs.  Needs a CUDA card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from chip_smoke import KERNEL_RUN, time_ms  # noqa: E402
from dabtools_tpu_torch.ops import cudalib  # noqa: E402
from dabtools_tpu_torch.ops import viterbi as V  # noqa: E402
from dabtools_tpu_torch.ops import viterbi_cuda as K  # noqa: E402

T2 = 1539                      # double steps of a flagship MSC codeword
FIC_T2 = 387                   # of a FIC codeword
T_RADIX2 = 3079                # chip_smoke.py's odd trellis length
LANES = (1, 66, 132, 264, 528, 640, 1056)
REPS = 10


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _sass(lib: pathlib.Path) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    tool = pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


OPCODES = ("VOTE", "SHFL", "LDG")     # counted in a kernel and its walk


def _instruction_counts(sass: str) -> dict:
    """Per kernel: (its instructions, its longest run of instructions
    without a branch or an exit, {opcode: (count in the kernel, count in
    that run)} for ``OPCODES``)."""
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = []
        elif name and line.strip().startswith("/*") and ";" in line:
            kernels[name].append(line)
    out = {}
    for name, lines in kernels.items():
        runs = [[]]
        for line in lines:
            if "BRA" in line or "EXIT" in line:
                runs.append([])
            else:
                runs[-1].append(line)
        walk = max(runs, key=len)
        out[name] = (len(lines), len(walk), {
            op: tuple(sum(f" {op}" in line for line in part)
                      for part in (lines, walk)) for op in OPCODES})
    return out


def lane_scaling(rng, ws4, ws2) -> None:
    for lanes in LANES:
        soft = rng.normal(size=(lanes, T2, 8)).astype(np.float32)
        soft8 = torch.from_numpy(soft).cuda()
        t2 = torch.full((lanes,), T2, dtype=torch.int32, device="cuda")
        soft = rng.normal(size=(lanes, T_RADIX2, 4)).astype(np.float32)
        soft4 = torch.from_numpy(soft).cuda()
        dec4, _ = K.acs4(soft8, t2, ws4)
        dec2, _ = K.acs2(soft4, ws2)
        line = []
        for name, fn, steps in (
                ("K1", lambda: K.acs4(soft8, t2, ws4), T2),
                ("K2", lambda: K.traceback4(dec4), T2),
                ("K2'", lambda: K.traceback4_onehot64(dec4), T2),
                ("K3", lambda: K.acs2(soft4, ws2), T_RADIX2),
                ("K4", lambda: K.traceback2(dec2), T_RADIX2)):
            ms = time_ms(fn, REPS, KERNEL_RUN)
            line.append(f"{name} {ms:.4f} ms = {ms * 1e3 / steps:.4f} "
                        f"us/step")
        print(f"lanes {lanes:5d}: " + "; ".join(line))


def against(rng, ws4, other: ctypes.CDLL) -> None:
    """All five kernels of this build and of ``other``, in turns."""
    soft = rng.normal(size=(640, T2, 8)).astype(np.float32)
    soft[rng.random(soft.shape) < 1 / 3] = 0.0
    soft8 = torch.from_numpy(soft).cuda()
    t2 = torch.full((640,), T2, dtype=torch.int32, device="cuda")
    t2[:64] = FIC_T2
    soft2 = rng.normal(size=(640, T_RADIX2, 4)).astype(np.float32)
    soft4 = torch.from_numpy(soft2).cuda()
    ws2 = V._ws2(soft4.device)
    this = cudalib.build()
    libs = {"this": this, "other": other}
    outs = {}
    for name, lib in libs.items():
        cudalib.lib = lib
        dec4, m4 = K.acs4(soft8, t2, ws4)
        dec2, m2 = K.acs2(soft4, ws2)
        outs[name] = (dec4, m4, K.traceback4(dec4),
                      K.traceback4_onehot64(dec4), dec2, m2,
                      K.traceback2(dec2))
    torch.cuda.synchronize()
    same = all(bool((a == b).all()) for a, b in zip(*outs.values()))
    print(f"this build and the other give equal outputs: {same}")
    if not same:
        raise AssertionError("the two builds disagree")
    dec4, dec2 = outs["this"][0], outs["this"][4]
    kernels = {
        "K1 acs4": (lambda: K.acs4(soft8, t2, ws4), T2),
        "K2 traceback4": (lambda: K.traceback4(dec4), T2),
        "K2' traceback4_onehot64": (lambda: K.traceback4_onehot64(dec4), T2),
        "K3 acs2": (lambda: K.acs2(soft4, ws2), T_RADIX2),
        "K4 traceback2": (lambda: K.traceback2(dec2), T_RADIX2),
    }
    for name in ("this", "other", "other", "this"):
        cudalib.lib = libs[name]
        line = []
        for kname, (fn, steps) in kernels.items():
            ms = time_ms(fn, REPS, KERNEL_RUN)
            line.append(f"{kname} {ms:.4f} ms ({ms * 1e3 / steps:.4f} "
                        f"us/step)")
        print(f"{name:5s}: " + "; ".join(line))
    cudalib.lib = this


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=pathlib.Path, default=None,
                    help="another checkout's dabtools_tpu_torch/csrc")
    ap.add_argument("--sass", type=pathlib.Path, default=None,
                    help="write this build's SASS listing here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_viterbi4_probe: no CUDA device")
    print(_smi("name,power.limit"))
    cudalib.build()
    rng = np.random.default_rng(7)
    ws4 = V._ws4(torch.device("cuda"))
    lane_scaling(rng, ws4, V._ws2(torch.device("cuda")))
    builds = {"this": cudalib.library_path()}
    if args.against:
        builds["other"] = cudalib.compile_library(args.against)
        against(rng, ws4, cudalib.load(builds["other"]))
    print(f"SM clock after the runs: {_smi('clocks.sm,clocks.max.sm')}")
    for build, so in builds.items():
        for name, (n, run, ops) in _instruction_counts(_sass(so)).items():
            print(f"SASS {build} {name}: {n} instructions; longest run "
                  f"without a branch {run}; " + ", ".join(
                      f"{op} {k} ({r} in that run)"
                      for op, (k, r) in ops.items()))
    if args.sass:
        sass = _sass(builds["this"])
        args.sass.parent.mkdir(parents=True, exist_ok=True)
        args.sass.write_text(sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())

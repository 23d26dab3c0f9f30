"""viterbi_roofline_pct (%, device trace): the least time the card could
take for the profiled sub-window's Viterbi decoding, over the device
time of the Viterbi kernels in it.

The work is counted from the code's trellis and the block's lanes
alone, never from one implementation's intermediates:

* Lanes.  Each device step of a receiver decodes, for a block of n
  Mode I frames, 4n FIC codewords (12 FIBs a frame, 3 FIBs of 256 bits
  a codeword: 768 data bits, 2304 punctured soft bits; EN 300 401
  s11.2) and, once it has an ensemble, one codeword per sub-channel and
  CIF (4n each): ``kbps`` x 24 data bits and the sub-channel's CUs x 64
  soft bits (EEP sizes of EN 300 401 Tables 7 and 8; a UEP sub-channel's
  size is its Table 31 row's, from ``rxbench/gen/puncturing.py``, its
  padding bits included).
* Steps.  A lane of d data bits is d + 6 trellis steps (the K = 7
  code's zero tail).
* Operations per step.  Each of the 64 states adds two branch metrics
  to its two predecessors' path metrics and keeps the larger: 2
  additions and 1 compare-select, 192 operations; the rate-1/4 mother
  code has 16 distinct branch metrics, each a signed sum of 4 soft
  values, 3 additions each, 48 operations.  240 in all.
* Bytes.  Each transmitted soft bit read once as float32 (4 bytes, the
  type the demodulator hands the decoder); each decoded bit written
  once as one byte.

The least time is the larger of bytes / 3.35 TB/s and operations / 67
TFLOP/s (NVIDIA H100 SXM: HBM3 bandwidth and float32 outside the tensor
cores; the card's power limit is printed beside every run).  The device
time sums the kernels named in ``KERNELS`` (a kernel's name without its
namespace and argument list): the radix-4 and radix-2
add-compare-select and traceback kernels of ``csrc/viterbi4.cu`` and
``csrc/viterbi2.cu``.
"""

import re

from rxbench.gen.puncturing import UEP_TABLE_31

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
OPS_PER_STEP = 64 * 3 + 16 * 3
TAIL = 6
KERNELS = ("acs4_kernel", "traceback4_kernel", "traceback4_onehot64_kernel",
           "acs2_kernel", "traceback2_kernel")
# CUs of an EEP sub-channel per unit of bit rate (n = kbps / 8 for
# option A, kbps / 32 for option B), by protection level
EEP_CUS = {"A": (8, (12, 8, 6, 4)), "B": (32, (27, 21, 18, 15))}


def lanes(spec, n_frames: int) -> list[tuple[int, int]]:
    """(soft bits, data bits) of each codeword of one device step; ``spec``
    is the ensemble's configuration entry, or None before acquisition."""
    out = [(2304, 768)] * (4 * n_frames)
    for s in (spec or {}).get("subchannels", ()):
        kind, prot = s["protection"].split("-")
        if kind == "UEP":
            soft = next(cus for cus, level, kbps in UEP_TABLE_31
                        if (str(level), kbps) == (prot, s["kbps"])) * 64
        else:
            unit, cus = EEP_CUS[prot[1]]
            soft = cus[int(prot[0]) - 1] * s["kbps"] // unit * 64
        out += [(soft, s["kbps"] * 24)] * (4 * n_frames)
    return out


def work(lane_list) -> tuple[int, int]:
    """(operations, bytes) of decoding ``lane_list``."""
    ops = sum((d + TAIL) * OPS_PER_STEP for _, d in lane_list)
    nbytes = sum(4 * soft + d for soft, d in lane_list)
    return ops, nbytes


def least_s(ops: int, nbytes: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def kernel_name(name: str) -> str:
    """``(anonymous namespace)::acs4_kernel(float const*, ...)`` ->
    ``acs4_kernel``; "" for a name that is no plain function's."""
    m = re.match(r"(?:void\s+)?(?:\w+::)*(\w+)\(",
                 name.replace("(anonymous namespace)::", ""))
    return m.group(1) if m else ""


def read(r):
    d = r.device
    if d is None:
        return None
    kernel_ns = sum(e1 - e0 for name, e0, e1 in d.events
                    if kernel_name(name) in KERNELS)
    if not kernel_ns:
        return None
    n = int(r.traffic["frames_per_block"])
    ops = nbytes = 0
    for spec, steps in d.steps:
        o, b = work(lanes(spec, n))
        ops, nbytes = ops + steps * o, nbytes + steps * b
    return 100.0 * least_s(ops, nbytes) / (kernel_ns / 1e9)

"""Host-side K=7 rate-1/4 convolutional code: encoder + reference decoder.

EN 300 401 s11.1: generators g1=1+D^2+D^3+D^5+D^6, g2=1+D+D^2+D^3+D^6,
g3=1+D+D^4+D^6, g4=g1 (octal 133,171,145,133), zero initial state, 6 zero
tail bits.

The encoder feeds the modulator fixture; ``viterbi_decode_ref`` is a slow,
obviously-correct NumPy Viterbi used only in tests to validate the
JAX/Pallas decoders (`dabtools_tpu.ops.viterbi`).  Reference counterpart:
`upstream:viterbi.c` (R12) — rebuilt from the textbook algorithm.

Bit/state conventions (shared with ops.viterbi — keep in sync):
* register = (u_n << 6) | state, state = last 6 input bits, newest at bit 5;
* output bit i = parity(register & POLYS[i]) with POLYS bit 6 = D^0 coeff;
* next state = register >> 1.
"""

from __future__ import annotations

import functools

import numpy as np

from . import constants as C


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


@functools.cache
def output_table() -> np.ndarray:
    """out[reg] -> 4 coded bits for 7-bit register value; (128, 4) uint8."""
    regs = np.arange(128, dtype=np.int64)[:, None]
    polys = np.array(C.CONV_POLYS, dtype=np.int64)[None, :]
    return _parity(regs & polys).astype(np.uint8)


def conv_encode(bits: np.ndarray) -> np.ndarray:
    """Encode 0/1 ``bits`` (+6 zero tail) -> mother codeword, len 4*(n+6).

    Vectorized: output i at step n is the XOR of the delayed input taps of
    generator i — computed for all n at once with shifted views.
    """
    bits = np.asarray(bits, dtype=np.uint8).reshape(-1)
    n = bits.size + C.TAIL_BITS
    # delayed[d, t] = u_{t-d} (zeros before the start / in the tail)
    hist = np.zeros(n + C.CONV_K - 1, dtype=np.uint8)
    hist[C.CONV_K - 1: C.CONV_K - 1 + bits.size] = bits
    out = np.empty((n, 4), dtype=np.uint8)
    for i, poly in enumerate(C.CONV_POLYS):
        acc = np.zeros(n, dtype=np.uint8)
        for d in range(C.CONV_K):
            if (poly >> (C.CONV_K - 1 - d)) & 1:   # coeff of D^d
                acc ^= hist[C.CONV_K - 1 - d: C.CONV_K - 1 - d + n]
        out[:, i] = acc
    return out.reshape(-1)


def viterbi_decode_ref(soft: np.ndarray) -> np.ndarray:
    """Reference soft-decision Viterbi (slow NumPy; tests only).

    ``soft``: (4*(n+6),) float, positive => coded bit 0 (matches the
    receiver's soft-bit convention: soft ~ +A for bit 0, -A for bit 1,
    0 = erasure).  Returns the n decoded information bits (tail stripped).
    """
    soft = np.asarray(soft, dtype=np.float64).reshape(-1, 4)
    n_steps = soft.shape[0]
    table = output_table().astype(np.float64)   # (128, 4)
    signs = 1.0 - 2.0 * table                    # +1 for bit 0, -1 for bit 1
    pm = np.full(64, -1e18)
    pm[0] = 0.0
    decisions = np.zeros((n_steps, 64), dtype=np.uint8)
    states = np.arange(64)
    pred0 = (2 * states) % 64            # even predecessor (its oldest bit 0)
    pred1 = pred0 + 1
    u = states >> 5                      # input bit that enters state s
    for t in range(n_steps):
        bm = signs @ soft[t]             # (128,) branch metric per register
        reg0 = (u << 6) | pred0          # register value for pred0 -> s
        reg1 = (u << 6) | pred1
        cand0 = pm[pred0] + bm[reg0]
        cand1 = pm[pred1] + bm[reg1]
        take1 = cand1 > cand0
        decisions[t] = take1
        pm = np.where(take1, cand1, cand0)
    # Traceback from state 0 (tail flushes the register).
    state = 0
    bits = np.empty(n_steps, dtype=np.uint8)
    for t in range(n_steps - 1, -1, -1):
        bits[t] = state >> 5
        state = 2 * (state & 31) + decisions[t, state]
    return bits[: n_steps - C.TAIL_BITS]

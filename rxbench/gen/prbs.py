"""Energy-dispersal PRBS (ETSI EN 300 401 s10).

Generator x^9 + x^5 + 1, register initialised to all ones; the output bit is
the XOR of taps 9 and 5, which is also fed back.  The same sequence
scrambles FIB triplets (768 bits) and each sub-channel logical frame,
restarting from the all-ones state every codeword.

Reference counterpart: the descrambler in `upstream:dab.c` (R13).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.cache
def energy_dispersal_bits(n: int) -> np.ndarray:
    """First ``n`` PRBS bits (uint8 0/1), register re-armed to all ones."""
    reg = np.ones(9, dtype=np.uint8)  # reg[0] newest .. reg[8] oldest
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        bit = reg[8] ^ reg[4]         # taps x^9 and x^5
        out[i] = bit
        reg[1:] = reg[:-1]
        reg[0] = bit
    out.setflags(write=False)
    return out


def scramble_bits(bits: np.ndarray) -> np.ndarray:
    """XOR ``bits`` (0/1 array) with the PRBS (involution: also descrambles)."""
    return np.bitwise_xor(bits.astype(np.uint8),
                          energy_dispersal_bits(bits.shape[-1]))

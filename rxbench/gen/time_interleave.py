"""MSC time-interleaving delay table (ETSI EN 300 401 s12).

Bit index i of a sub-channel's convolutionally-coded CIF contribution is
delayed by ``DELAYS[i mod 16]`` logical frames (24 ms CIFs) at the
transmitter, where DELAYS is the bit-reversed 4-bit sequence.  The receiver
applies the complementary delay ``15 - DELAYS[i mod 16]`` so all bits of one
logical frame re-align 15 CIFs later (total latency 16 CIFs = 384 ms, as in
the reference receiver path, `upstream:input_sdr.c` R15).
"""

from __future__ import annotations

import numpy as np


def _bitrev4(x: int) -> int:
    return int(f"{x:04b}"[::-1], 2)


DELAYS = np.array([_bitrev4(i) for i in range(16)], dtype=np.int32)
# [0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15]
RX_DELAYS = 15 - DELAYS


def tx_delay_for_bits(n_bits: int) -> np.ndarray:
    return DELAYS[np.arange(n_bits) % 16]


def rx_delay_for_bits(n_bits: int) -> np.ndarray:
    return RX_DELAYS[np.arange(n_bits) % 16]

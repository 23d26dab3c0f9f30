"""Bit <-> byte packing helpers (MSB-first, the DAB wire convention)."""

from __future__ import annotations

import numpy as np


def bytes_to_bits(data: bytes | np.ndarray) -> np.ndarray:
    """uint8 bytes -> 0/1 uint8 bit array, MSB first."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """0/1 bit array (length divisible by 8) -> bytes, MSB first."""
    bits = np.asarray(bits, dtype=np.uint8).reshape(-1)
    if bits.size % 8:
        raise ValueError(f"bit count {bits.size} not a multiple of 8")
    return np.packbits(bits).tobytes()

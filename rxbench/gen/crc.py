"""CRC-16/CCITT of the FIBs (frozen copy of the port's ``utils/crc.py``,
table-driven NumPy path only).

Poly 0x1021, init 0xFFFF, final one's complement (EN 300 401 s5.2.1).
"""

from __future__ import annotations

import numpy as np


def _make_table(poly: int) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly if crc & 0x8000 else crc << 1) & 0xFFFF
        table[byte] = crc
    return table


_CCITT_TABLE = _make_table(0x1021)


def _crc16(data: bytes | np.ndarray, table: np.ndarray, init: int) -> int:
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = init
    for b in buf:
        crc = ((crc << 8) & 0xFFFF) ^ int(table[(crc >> 8) ^ b])
    return crc


def crc16_ccitt(data: bytes | np.ndarray) -> int:
    """CRC-16/CCITT with init 0xFFFF and final complement (DAB convention)."""
    return _crc16(data, _CCITT_TABLE, 0xFFFF) ^ 0xFFFF

"""CRCs used by DAB/ETI (host side).

* FIB / ETI header / ETI MST CRC: CRC-16/CCITT, poly 0x1021, init 0xFFFF,
  final one's complement (EN 300 401 s5.2.1, ETS 300 799 annex).
* DAB+ firecode: 16-bit CRC, poly x^16+x^14+x^13+x^12+x^11+x^5+x^3+x^2+x+1
  (0x782F), init 0x0000, over the 9 bytes following the firecode word
  (TS 102 563 s5.2).

Reference counterpart: CRC helpers in `upstream:dab.c` (R9/R16) — rebuilt
from the standards.  A C fast path lives in ``native/dabhost.c``; these
table-driven NumPy versions are the always-available fallback and the
cross-check in tests.
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
_FIRECODE_TABLE = _make_table(0x782F)


def _crc16(data: bytes | np.ndarray, table: np.ndarray, init: int) -> int:
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = init
    for b in buf:
        crc = ((crc << 8) & 0xFFFF) ^ int(table[(crc >> 8) ^ b])
    return crc


def _native():
    # The per-FIB CRC rate at 1000x+ real-time makes the Python loop a
    # host bottleneck; route through dabhost.cc when available (identical
    # tables, cross-checked in tests/test_native.py).
    try:
        from dabtools_tpu_torch.utils import native
        return native.lib()
    except Exception:  # pragma: no cover
        return None


def crc16_ccitt_py(data: bytes | np.ndarray) -> int:
    """Pure-Python CRC (the cross-check reference for the native path)."""
    return _crc16(data, _CCITT_TABLE, 0xFFFF) ^ 0xFFFF


def firecode_py(data: bytes | np.ndarray) -> int:
    return _crc16(data, _FIRECODE_TABLE, 0x0000)


def crc16_ccitt(data: bytes | np.ndarray) -> int:
    """CRC-16/CCITT with init 0xFFFF and final complement (DAB convention)."""
    lib = _native()
    if lib is not None:
        from dabtools_tpu_torch.utils import native
        return native.crc16_ccitt(data)
    return crc16_ccitt_py(data)


def crc16_ok(block: bytes | np.ndarray) -> bool:
    """True if the trailing 2 bytes of ``block`` are its valid DAB CRC."""
    block = bytes(block)
    return crc16_ccitt(block[:-2]) == int.from_bytes(block[-2:], "big")


def crc16_ok_batch(blocks: np.ndarray) -> np.ndarray:
    """(n, block_len) uint8 -> (n,) bool validity (one native call for a
    whole device block's FIBs instead of n Python round trips)."""
    lib = _native()
    if lib is not None:
        from dabtools_tpu_torch.utils import native
        return native.crc16_ok_batch(blocks)
    return np.array([crc16_ok(b.tobytes()) for b in np.asarray(blocks)],
                    dtype=bool)


def firecode(data: bytes | np.ndarray) -> int:
    """DAB+ firecode CRC over ``data`` (init 0, no complement)."""
    lib = _native()
    if lib is not None:
        from dabtools_tpu_torch.utils import native
        return native.firecode(data)
    return firecode_py(data)

"""Device-side bit packing: (..., 8n) 0/1 -> (..., n) uint8, MSB-first.

Port of ``dabtools_tpu/ops/bits.py``.  Decoded bits leave the device as
packed bytes (8x less device->host traffic); integer shifts and a sum over
the 8 bits of each byte, matching ``np.packbits`` exactly.
"""

from __future__ import annotations

import functools

import torch


@functools.cache
def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(7, -1, -1, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8n) uint8 0/1 bits -> (..., n) uint8 bytes, MSB first."""
    *lead, n = bits.shape
    if n % 8:
        raise ValueError(f"bit count {n} not a multiple of 8")
    grouped = bits.reshape(*lead, n // 8, 8).to(torch.int32)
    return (grouped << _shifts(bits.device)).sum(-1).to(torch.uint8)

"""Dynamic window extraction as one batched gather.

Port of ``dabtools_tpu/ops/slicing.py``.  The JAX module exists to keep a
TPU gather on its fast path under nested vmaps; here it is a plain
gather.  What carries over is the start contract of ``lax.dynamic_slice``,
which every window of the receiver relies on: one NumPy-style wrap of a
negative start, then a clamp into ``[0, n - length]``.
"""

from __future__ import annotations

import torch


def window_slices(x: torch.Tensor, starts: torch.Tensor,
                  length: int) -> torch.Tensor:
    """``stack([x[s:s+length] for s in starts])`` with tensor ``starts``.

    ``x``: (n,) samples; ``starts``: (m,) integer tensor on ``x``'s
    device; returns (m, length).  Starts wrap once if negative and then
    clamp to ``[0, n - length]``; ``length > n`` raises.
    """
    n, length = x.shape[0], int(length)
    if length > n:
        raise ValueError(f"window length {length} exceeds the {n} samples")
    s = starts.to(torch.int64)
    s = torch.where(s < 0, s + n, s).clamp(0, n - length)
    return x[s[:, None] + torch.arange(length, device=x.device)]

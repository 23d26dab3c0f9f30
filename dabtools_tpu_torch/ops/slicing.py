"""Dynamic window extraction as one batched gather.

Port of ``dabtools_tpu/ops/slicing.py``.  The JAX module exists to keep a
TPU gather on its fast path under nested vmaps, collapsing the outer
vmap's stream axis into one flat gather; here the stream axis is explicit
and the gather is flat from the start.  What carries over is the start
contract of ``lax.dynamic_slice``, which every window of the receiver
relies on: one NumPy-style wrap of a negative start, then a clamp into
``[0, n - length]``, per stream.
"""

from __future__ import annotations

import torch


def window_starts(x: torch.Tensor, starts: torch.Tensor,
                  length: int) -> torch.Tensor:
    """Flat start of each window in ``x.reshape(-1)``.

    ``x``: (n,) samples, or (B, n) for B streams; ``starts``: (..., m)
    integer tensor on ``x``'s device, with a leading (B,) for a 2-D
    ``x``.  Each start wraps once if negative and then clamps to ``[0, n
    - length]`` within its own row; a 2-D ``x`` then adds its row's
    offset ``b * n``.  ``length > n`` raises.
    """
    n, length = x.shape[-1], int(length)
    if length > n:
        raise ValueError(f"window length {length} exceeds the {n} samples")
    s = starts.to(torch.int64)
    s = torch.where(s < 0, s + n, s).clamp(0, n - length)
    if x.ndim == 2:
        rows = torch.arange(0, x.numel(), n, device=x.device)
        s = s + rows.reshape(-1, *([1] * (s.ndim - 1)))
    return s


def window_slices(x: torch.Tensor, starts: torch.Tensor,
                  length: int) -> torch.Tensor:
    """``stack([x[s:s+length] for s in starts])`` with tensor ``starts``.

    ``x``: (n,) samples with ``starts`` (m,), returning (m, length); or
    (B, n), one row per stream, with ``starts`` (B, m), returning (B, m,
    length) as one flat gather at ``b*n + s + arange(length)``.  The
    start contract is :func:`window_starts`'s.
    """
    s = window_starts(x, starts, length)
    tap = torch.arange(int(length), device=x.device)
    return x.reshape(-1)[s[..., None] + tap]

"""The receiver's (channels, time) device grid.

Port of ``dabtools_tpu/parallel/mesh.py::make_receiver_mesh``.  The JAX
package builds a ``jax.sharding.Mesh`` whose axes its pipelines shard
over: ``channels`` (independent ensembles, DP-like) x ``time`` (time
blocks of one stream, SP-like).  Here a mesh is a plain grid of
``torch.device``s: the parallel layers place each stream or time shard on
its grid cell's device and move halos between cells with ``.to``.  A
device may fill several cells (eight cells on one card run as one batch).

``init_multihost`` (``jax.distributed``) is not ported yet: halo exchange
between processes with ``torch.distributed`` is the next slice
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ReceiverMesh:
    """``devices``: the (channels, time) grid, a tuple of rows."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"channels": len(self.devices), "time": len(self.devices[0])}

    def rows_of(self, n_streams: int) -> list[int]:
        """The channel row of each of ``n_streams`` streams, split as a
        sharding over ``channels`` splits a leading axis: in equal
        contiguous parts, one per row."""
        rows = len(self.devices)
        if n_streams % rows:
            raise ValueError(f"{n_streams} streams do not split over "
                             f"{rows} channel rows")
        per = n_streams // rows
        return [s // per for s in range(n_streams)]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_receiver_mesh(n_channels: int | None = None,
                       n_time: int | None = None,
                       devices=None) -> ReceiverMesh:
    """Build a (channels, time) mesh over ``devices``.

    ``devices``: a sequence of ``torch.device`` (or strings), repeats
    allowed; defaults to the visible CUDA devices.  Defaults: all devices
    on the ``channels`` axis (the embarrassingly parallel direction),
    ``time=1``.  Pass explicit sizes for mixed sharding; their product
    must equal the device count.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("no CUDA device; pass devices= (e.g. "
                             "['cpu'] * 8)")
    devices = [_device(d) for d in devices]
    n = len(devices)
    if n_channels is None and n_time is None:
        n_channels, n_time = n, 1
    elif n_channels is None:
        n_channels = n // n_time
    elif n_time is None:
        n_time = n // n_channels
    if n_channels * n_time != n:
        raise ValueError(
            f"mesh {n_channels}x{n_time} != {n} devices")
    return ReceiverMesh(tuple(tuple(devices[c * n_time:(c + 1) * n_time])
                              for c in range(n_channels)))

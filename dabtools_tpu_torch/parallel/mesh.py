"""The receiver's (channels, time) grid of cells, and multi-process
bring-up.

Port of ``dabtools_tpu/parallel/mesh.py``.  The JAX package builds a
``jax.sharding.Mesh`` whose axes its pipelines shard over: ``channels``
(independent ensembles, DP-like) x ``time`` (time blocks of one stream,
SP-like); after ``init_multihost`` its mesh over ``jax.devices()`` spans
processes.  Here a mesh is a plain grid of cells, each a
``torch.device`` and the ``torch.distributed`` rank that owns it: the
parallel layers place each stream or time shard on its cell's device,
in its cell's process.  Halos between cells of one process are slices
moved with ``.to``; halos between processes travel by point-to-point
sends (``parallel/timeblock.py``).  A device may fill several cells
(eight cells on one card run as one batch), and a device is meaningful
only on the rank that owns its cell.
"""

from __future__ import annotations

import atexit
import dataclasses

import torch
import torch.distributed as dist

from dabtools_tpu_torch.models.receiver import to_host


@dataclasses.dataclass(frozen=True)
class ReceiverMesh:
    """``devices``: the (channels, time) grid, a tuple of rows;
    ``ranks``: the grid of the ranks that own the cells, of the same
    shape."""

    devices: tuple[tuple[torch.device, ...], ...]
    ranks: tuple[tuple[int, ...], ...]

    @property
    def shape(self) -> dict:
        return {"channels": len(self.devices), "time": len(self.devices[0])}

    @property
    def spans_processes(self) -> bool:
        """Whether the cells name more than one rank."""
        return len({r for row in self.ranks for r in row}) > 1

    def process_rank(self) -> int:
        """This process's rank in the mesh: its ``torch.distributed``
        rank, or 0 without a process group.  Raises if a cell names a
        rank that the group does not have."""
        named = {r for row in self.ranks for r in row}
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if max(named) >= world:
                raise ValueError(f"mesh cells name ranks {sorted(named)} "
                                 f"but the process group has {world}")
            return dist.get_rank()
        if named != {0}:
            raise RuntimeError(f"mesh cells name ranks {sorted(named)} but "
                               f"no torch.distributed process group is "
                               f"initialized (init_multihost)")
        return 0

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


def init_multihost(coordinator: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   backend: str = "nccl") -> None:
    """``torch.distributed.init_process_group`` in the form of the JAX
    package's ``jax.distributed.initialize`` wrapper.

    With ``num_processes`` None or <= 1 this does nothing.  Otherwise
    every process calls it with the same ``coordinator`` (``host:port``
    of rank 0's rendezvous), ``num_processes`` and its own
    ``process_id``, before it builds a mesh; ``make_receiver_mesh`` then
    spans the processes.  ``backend`` is the caller's: ``"nccl"`` moves
    halos between the cells' CUDA devices, ``"gloo"`` through host
    memory (NCCL does not put two ranks on one GPU).

    The group is destroyed at interpreter exit unless the caller has done
    so, as the JAX client shuts down at exit: a process that exits with
    the group alive can abort in C++ (``terminate called without an
    active exception``) while the interpreter tears down the group's
    threads.  A caller whose ranks must not leave before each other ends
    with ``dist.barrier()`` and ``dist.destroy_process_group()`` itself;
    the exit hook has no barrier, which would hang on a dead peer.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator is None:
        raise ValueError(f"init_multihost: {num_processes} processes need "
                         f"a coordinator address (host:port)")
    if process_id is None:
        raise ValueError(f"init_multihost: {num_processes} processes need "
                         f"this process's process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    atexit.unregister(_destroy_group)
    atexit.register(_destroy_group)


def _destroy_group() -> None:
    """``init_multihost``'s exit hook: destroy the process group if it is
    still alive."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_receiver_mesh(n_channels: int | None = None,
                       n_time: int | None = None,
                       devices=None) -> ReceiverMesh:
    """Build a (channels, time) mesh over ``devices``.

    ``devices``: a sequence of ``torch.device`` (or strings), repeats
    allowed; defaults to the visible CUDA devices.  Defaults: all devices
    on the ``channels`` axis (the embarrassingly parallel direction),
    ``time=1``.  Pass explicit sizes for mixed sharding; their product
    must equal the device count.

    Under an initialized process group (``init_multihost``) the devices
    are this process's, and the grid holds every rank's, rank-major (the
    order of ``jax.devices()`` across processes), gathered with
    ``all_gather_object``: every rank calls this with the same sizes.
    ``devices`` may instead name every cell as a ``(rank, device)``
    pair, the same list on every rank, which can lay one time row
    across ranks.
    """
    grouped = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices and not grouped:
            raise ValueError("no CUDA device; pass devices= (e.g. "
                             "['cpu'] * 8)")
    devices = list(devices)
    if devices and all(isinstance(d, tuple) for d in devices):
        cells = [(int(r), _device(d)) for r, d in devices]
    elif grouped:
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, [_device(d) for d in devices])
        cells = [(r, d) for r, ds in enumerate(per_rank) for d in ds]
        if not cells:
            raise ValueError("no CUDA device on any rank; pass devices= "
                             "(e.g. ['cpu'] * 4)")
    else:
        cells = [(0, _device(d)) for d in devices]
    n = len(cells)
    if n_channels is None and n_time is None:
        n_channels, n_time = n, 1
    elif n_channels is None:
        n_channels = n // n_time
    elif n_time is None:
        n_time = n // n_channels
    if n_channels * n_time != n:
        raise ValueError(
            f"mesh {n_channels}x{n_time} != {n} devices")
    rows = [cells[c * n_time:(c + 1) * n_time] for c in range(n_channels)]
    return ReceiverMesh(tuple(tuple(d for _, d in row) for row in rows),
                        tuple(tuple(r for r, _ in row) for row in rows))


def assemble_cells(cells: dict, home) -> dict:
    """``{(channel, shard): cell dict}`` covering a whole grid -> one
    dict of the same structure: each leaf the cells' concatenated over
    the shards of a channel, stacked over the channels, on ``home``."""
    n_ch = 1 + max(c for c, _ in cells)
    n_shards = 1 + max(i for _, i in cells)

    def join(parts):
        # a channel batch's streams are single cells, and may hold 0-dim
        # leaves (``null_start``)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def build(pick, node):
        return {k: (build(lambda cell, k=k: pick(cell)[k], v)
                    if isinstance(v, dict) else torch.stack([
                        join([pick(cells[c, i])[k].to(home)
                              for i in range(n_shards)])
                        for c in range(n_ch)]))
                for k, v in node.items()}

    return build(lambda cell: cell, cells[0, 0])


def gather_span(out: dict, mesh: ReceiverMesh) -> dict:
    """Every rank's cells of a span (or streams of a channel batch) ->
    the dict the one-process receiver returns: global shapes, the
    cells of a channel concatenated on the time axis and the channels
    stacked, on the device of this rank's first cell (the CPU if it owns
    none).  The counterpart of ``multihost_utils.process_allgather(...,
    tiled=True)``; every rank of the group calls it.

    ``out``: ``{(channel, shard): cell dict}`` as ``timeblock_receiver``
    and ``channel_parallel_block`` return it on a mesh that spans
    processes; on any other mesh ``out`` is already global and comes
    back as it is.
    """
    if not mesh.spans_processes:
        return out
    mesh.process_rank()
    home = torch.device("cpu")
    if out:
        node = next(iter(out.values()))
        while isinstance(node, dict):
            node = next(iter(node.values()))
        home = node.device
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, to_host(out))

    def tensors(node):
        return {k: tensors(v) if isinstance(v, dict) else torch.from_numpy(v)
                for k, v in node.items()}

    return assemble_cells({cell: tensors(v) for part in parts
                           for cell, v in part.items()}, home)

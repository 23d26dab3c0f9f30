"""Channel-parallel decoding: many IQ streams as one batch.

Port of ``dabtools_tpu/parallel/channel.py``.  The JAX package vmaps the
per-stream pipeline over a leading channel axis; here the receiver's
:func:`pre_viterbi` takes that axis itself, so each device runs the
demod chain ONCE for all of its streams, and their FIC and MSC codewords
go to the Viterbi as ONE ragged dispatch: the channel axis is flattened
into the lane axis only there, so K1 and K2 launch once per batched
block and device whatever the channel count.  With a ``mesh``, each
stream runs on its channel row's device, as the JAX ``mesh=`` places it;
on a mesh whose rows span processes, each process runs the streams of
its own rows, with no communication (the JAX ``NamedSharding`` over
``channels``).
"""

from __future__ import annotations

import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models.receiver import (
    pick_stream,
    post_viterbi,
    pre_viterbi,
)
from dabtools_tpu_torch.ops.sync import coarse_null_sync
from dabtools_tpu_torch.ops.viterbi import viterbi_decode_ragged
from dabtools_tpu_torch.parallel.mesh import ReceiverMesh


def _join(trees: list, where: list, device: torch.device) -> dict:
    """Batched trees of one structure (one per device) -> one tree on
    ``device`` whose stream ``c`` is stream ``where[c][1]`` of
    ``trees[where[c][0]]``.  One tree holds every stream in order."""
    if len(trees) == 1:
        return _to(trees[0], device)
    return {k: (_join([t[k] for t in trees], where, device)
                if isinstance(v, dict)
                else torch.cat([trees[t][k][j:j + 1].to(device)
                                for t, j in where]))
            for k, v in trees[0].items()}


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _rows(t: torch.Tensor, idx: list, device: torch.device) -> torch.Tensor:
    """Rows ``idx`` (ascending) of ``t`` on ``device``: a view where they
    are contiguous, else one concatenation."""
    if idx == list(range(idx[0], idx[-1] + 1)):
        return t[idx[0]: idx[-1] + 1].to(device)
    return torch.cat([t[i: i + 1].to(device) for i in idx])


def channel_parallel_block(x, rings, cif_count, *,
                           ensemble: Ensemble | None, mode=C.MODE_I,
                           n_frames: int = 8, search: int = 192,
                           max_int_cfo: int = 8,
                           mesh: ReceiverMesh | None = None):
    """Decode a batch of streams: ``x`` (n_channels, block_samples)
    complex64 tensor.

    ``rings``: {subchid str: (n_channels, 16, n_bits) tensor};
    ``cif_count``: 0-dim int32 tensor shared by the streams; all on
    ``x``'s device.  Returns the structure of ``process_block``'s result
    with a leading channel axis on ``out``'s and the rings' leaves, and
    the advanced CIF counter, on ``x``'s device.  ``ensemble=None`` with
    ``rings={}`` is the FIC-only pass.  With ``mesh``, the streams split
    over its channel rows as a sharding over ``channels`` splits them
    (:meth:`ReceiverMesh.rows_of`) and each runs on its row's device.
    On a mesh whose rows span processes, every rank calls this with the
    whole batch and decodes the streams of the rows it owns (a row is
    its first cell's); ``out`` and the rings are then ``{(stream, 0):
    stream dict}`` on the rows' devices, which
    :func:`~dabtools_tpu_torch.parallel.mesh.gather_span` stacks.
    """
    n = x.shape[0]
    streams = list(range(n))
    devices = [x.device] * n
    if mesh is not None:
        rows = mesh.rows_of(n)
        rank = mesh.process_rank()
        streams = [c for c in streams if mesh.ranks[rows[c]][0] == rank]
        devices = [mesh.devices[rows[c]][0] for c in streams]
    # one demod chain (pre_viterbi), one Viterbi dispatch and one
    # post_viterbi per device, over all of its streams
    by_dev = {d: [c for c, e in zip(streams, devices) if e == d]
              for d in dict.fromkeys(devices)}
    outs, new_rings = [], []
    for dev, idx in by_dev.items():
        xd = _rows(x, idx, dev)
        sync = coarse_null_sync(xd, mode)
        ns = sync["null_start"]
        off = torch.arange(n_frames, dtype=torch.int32,
                           device=dev) * mode.frame_size
        out, ring, jobs, groups = pre_viterbi(
            xd, ns[:, None] + off,
            {k: _rows(v, idx, dev) for k, v in rings.items()},
            cif_count.to(dev), ensemble=ensemble, mode=mode, search=search,
            max_int_cfo=max_int_cfo,
            sync_diag={"null_start": ns, "null_ratio": sync["null_ratio"]})
        post_viterbi(out, groups, viterbi_decode_ragged(jobs), n_frames,
                     mode)
        outs.append(out)
        new_rings.append(ring)
    new_cif = cif_count + n_frames * mode.n_cifs
    where = {c: (t, j) for t, idx in enumerate(by_dev.values())
             for j, c in enumerate(idx)}
    if len(streams) < n:
        return ({(c, 0): pick_stream(outs[t], j)
                 for c, (t, j) in where.items()},
                {(c, 0): pick_stream(new_rings[t], j)
                 for c, (t, j) in where.items()}, new_cif)
    order = [where[c] for c in range(n)]
    return (_join(outs, order, x.device), _join(new_rings, order, x.device),
            new_cif)

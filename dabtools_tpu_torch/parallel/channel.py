"""Channel-parallel decoding: many IQ streams as one batch.

Port of ``dabtools_tpu/parallel/channel.py``.  The JAX package vmaps the
per-stream pipeline over a leading channel axis; here each stream runs the
receiver's :func:`pre_viterbi` in turn, and then every stream's FIC and
MSC codewords go to the Viterbi as ONE ragged dispatch per device: the
channel axis is flattened into the lane axis, so K1 and K2 launch once
per batched block and device whatever the channel count.  With a
``mesh``, each stream runs on its channel row's device, as the JAX
``mesh=`` places it; on a mesh whose rows span processes, each process
runs the streams of its own rows, with no communication (the JAX
``NamedSharding`` over ``channels``).
"""

from __future__ import annotations

import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models.receiver import post_viterbi, pre_viterbi
from dabtools_tpu_torch.ops.sync import coarse_null_sync
from dabtools_tpu_torch.ops.viterbi import viterbi_decode_ragged
from dabtools_tpu_torch.parallel.mesh import ReceiverMesh


def _stack(trees: list, device: torch.device) -> dict:
    """Dicts of tensors with one structure -> one dict of the tensors
    stacked along a new leading axis on ``device``."""
    return {k: (_stack([t[k] for t in trees], device) if isinstance(v, dict)
                else torch.stack([t[k].to(device) for t in trees]))
            for k, v in trees[0].items()}


def decode_by_device(devices: list, jobs: list) -> list:
    """Item ``i``'s codeword batches ``jobs[i]`` (all of one length list,
    on ``devices[i]``) -> its decoded ``[(bits, metric), ...]``, with ONE
    ragged Viterbi dispatch per distinct device for all of its items."""
    decoded = [None] * len(jobs)
    for dev in dict.fromkeys(devices):
        items = [i for i, d in enumerate(devices) if d == dev]
        res = viterbi_decode_ragged([j for i in items for j in jobs[i]])
        per = len(jobs[items[0]])
        for k, i in enumerate(items):
            decoded[i] = res[k * per:(k + 1) * per]
    return decoded


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
    offsets: dict = {}
    outs, new_rings, jobs = [], [], []
    groups: dict = {}
    for c, dev in zip(streams, devices):
        xc = x[c].to(dev)
        if dev not in offsets:
            offsets[dev] = torch.arange(n_frames, dtype=torch.int32,
                                        device=dev) * mode.frame_size
        sync = coarse_null_sync(xc, mode)
        ns = sync["null_start"]
        out, ring, job, groups = pre_viterbi(
            xc, ns + offsets[dev], {k: v[c].to(dev) for k, v in rings.items()},
            cif_count.to(dev), ensemble=ensemble, mode=mode, search=search,
            max_int_cfo=max_int_cfo,
            sync_diag={"null_start": ns, "null_ratio": sync["null_ratio"]})
        outs.append(out)
        new_rings.append(ring)
        jobs.append(job)
    for out, dec in zip(outs, decode_by_device(devices, jobs)):
        post_viterbi(out, groups, dec, n_frames, mode)
    new_cif = cif_count + n_frames * mode.n_cifs
    if len(streams) < n:
        return ({(c, 0): o for c, o in zip(streams, outs)},
                {(c, 0): r for c, r in zip(streams, new_rings)}, new_cif)
    return _stack(outs, x.device), _stack(new_rings, x.device), new_cif

"""Channel-parallel decoding: many IQ streams as one batch.

Port of ``dabtools_tpu/parallel/channel.py`` on one device (the JAX
function's ``mesh`` placement comes with the sharding slice).  The JAX
package vmaps the per-stream pipeline over a leading channel axis; here
each stream runs the receiver's :func:`pre_viterbi` in turn, and then
every stream's FIC and MSC codewords go to the Viterbi as ONE ragged
dispatch: the channel axis is flattened into the lane axis, so K1 and K2
launch once per batched block whatever the channel count.
"""

from __future__ import annotations

import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models.receiver import post_viterbi, pre_viterbi
from dabtools_tpu_torch.ops.sync import coarse_null_sync
from dabtools_tpu_torch.ops.viterbi import viterbi_decode_ragged


def _stack(trees: list) -> dict:
    """Dicts of tensors with one structure -> one dict of the tensors
    stacked along a new leading axis."""
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def channel_parallel_block(x, rings, cif_count, *,
                           ensemble: Ensemble | None, mode=C.MODE_I,
                           n_frames: int = 8, search: int = 192,
                           max_int_cfo: int = 8):
    """Decode a batch of streams: ``x`` (n_channels, block_samples)
    complex64 tensor.

    ``rings``: {subchid str: (n_channels, 16, n_bits) tensor};
    ``cif_count``: 0-dim int32 tensor shared by the streams.  All on one
    device.  Returns the structure of ``process_block``'s result with a
    leading channel axis on ``out``'s and the rings' leaves, and the
    advanced CIF counter.  ``ensemble=None`` with ``rings={}`` is the
    FIC-only pass.
    """
    off = torch.arange(n_frames, dtype=torch.int32,
                       device=x.device) * mode.frame_size
    outs, new_rings, jobs = [], [], []
    groups: dict = {}
    for c in range(x.shape[0]):
        sync = coarse_null_sync(x[c], mode)
        ns = sync["null_start"]
        out, ring, job, groups = pre_viterbi(
            x[c], ns + off, {k: v[c] for k, v in rings.items()}, cif_count,
            ensemble=ensemble, mode=mode, search=search,
            max_int_cfo=max_int_cfo,
            sync_diag={"null_start": ns, "null_ratio": sync["null_ratio"]})
        outs.append(out)
        new_rings.append(ring)
        jobs.append(job)
    decoded = viterbi_decode_ragged([j for job in jobs for j in job])
    per = len(jobs[0])
    for c, out in enumerate(outs):
        post_viterbi(out, groups, decoded[c * per:(c + 1) * per], n_frames,
                     mode)
    return (_stack(outs), _stack(new_rings),
            cif_count + n_frames * mode.n_cifs)

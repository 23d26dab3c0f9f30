"""Parallelism layer of the PyTorch port.

* ``channel``   — many independent streams as one batch, with one Viterbi
  dispatch per device for all of them; with a ``mesh``, each stream on
  its channel row's device.
* ``timeblock`` — one stream's time axis cut into shards, each re-primed
  by a warmup halo from its left neighbour, all shards' codewords in one
  Viterbi dispatch per device.
* ``mesh``      — the (channels, time) grid of ``torch.device``s both
  place their work on; one card may fill every cell.

Halo exchange between processes (``torch.distributed``) and
``init_multihost`` are not ported yet (ROADMAP.md).
"""

from dabtools_tpu_torch.parallel.mesh import make_receiver_mesh  # noqa: F401
from dabtools_tpu_torch.parallel.channel import (  # noqa: F401
    channel_parallel_block,
)
from dabtools_tpu_torch.parallel.timeblock import (  # noqa: F401
    timeblock_receiver,
)

"""Parallelism layer of the PyTorch port.

* ``channel``   — many independent streams as one batch: per device, one
  demod chain over a leading stream axis and one Viterbi dispatch for
  all of its streams; with a ``mesh``, each stream on its channel row's
  device.
* ``timeblock`` — one stream's time axis cut into shards, each re-primed
  by a warmup halo from its left neighbour; a device's (channel, shard)
  cells run as one batch, one demod chain and one Viterbi dispatch.
* ``mesh``      — the (channels, time) grid of cells, each a
  ``torch.device`` and the rank that owns it, that both place their
  work on; one card may fill every cell.  ``init_multihost`` starts a
  ``torch.distributed`` group, a mesh then spans its processes, halos
  between them are sent, and ``gather_span`` collects the ranks' cells.
"""

from dabtools_tpu_torch.parallel.mesh import (  # noqa: F401
    gather_span,
    init_multihost,
    make_receiver_mesh,
)
from dabtools_tpu_torch.parallel.channel import (  # noqa: F401
    channel_parallel_block,
)
from dabtools_tpu_torch.parallel.timeblock import (  # noqa: F401
    timeblock_receiver,
)

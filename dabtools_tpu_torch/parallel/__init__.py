"""Parallelism layer of the PyTorch port.

* ``channel``   — many independent streams as one batch, with one Viterbi
  dispatch per device for all of them; with a ``mesh``, each stream on
  its channel row's device.
* ``timeblock`` — one stream's time axis cut into shards, each re-primed
  by a warmup halo from its left neighbour, all shards' codewords in one
  Viterbi dispatch per device.
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

"""Parity of the PyTorch port's receiver with the JAX package in
transmission Modes II, III and IV (CPU).

The same modulated IQ (``tests/test_modes.py``'s one-sub-channel ensemble
and seeded payload, as a NumPy array) goes through the JAX
``DabReceiver`` and the port's ``DabReceiver(device="cpu")`` with the
mode's own block length.  The ETI bytes must be identical, at least two
frames of them, and the acquired ensembles equal once the JAX one is
carried across to the port's classes through its dict form.
"""

import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.models.receiver import DabReceiver as JaxReceiver
from dabtools_tpu_torch import constants as TC
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models.receiver import DabReceiver
from tests.test_modes import _ensemble, _modulate

torch.set_num_threads(2)


@pytest.mark.parametrize("mode_name,n_frames,block", [
    ("II", 28, 4),
    ("III", 27, 6),
    ("IV", 16, 4),
])
def test_receiver_mode_matches_jax(mode_name, n_frames, block):
    ens = _ensemble(0x2000 + ord(mode_name[-1]))
    x, _ = _modulate(ens, C.MODES[mode_name], n_frames)
    x = np.asarray(x)
    ref_rx = JaxReceiver(n_frames=block, mode=C.MODES[mode_name])
    ref = ref_rx.feed(x)
    rx = DabReceiver(n_frames=block, mode=TC.MODES[mode_name], device="cpu")
    eti = rx.feed(x)
    assert len(ref) >= 2
    assert eti == ref
    assert rx.ensemble == Ensemble.from_dict(ref_rx.ensemble.to_dict())

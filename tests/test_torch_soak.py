"""``tests/test_soak.py`` at full length through the port, held against
the JAX receiver (CPU).

A minute of stream (625 frames, a 180 Hz CFO, 14 dB) in ragged chunks of
1,000,003 samples through both ``DabReceiver(n_frames=8)``s: the ETI
streams are identical over the whole minute, and the port's receiver
keeps the JAX test's bounds on its host state (FIB and sub-channel
FIFOs, stats), its continuity (FCT) and its lock (no FIB CRC failure
after the second block).

The stream is ``tests/test_soak.py``'s, sample for sample, but impaired
in pieces of ``STEP`` samples (``_impaired``): the whole-array
expressions hold several GB of float64 temporaries at this length, and
the tier-1 run shares its host with the JAX package's ~52 GB UEP case.
"""

import numpy as np
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.mod.impairments import awgn, carrier_offset
from dabtools_tpu.models import receiver as jrx
from dabtools_tpu_torch.models import receiver as trx
from tests.test_closed_loop import build_ensemble, modulate

torch.set_num_threads(2)

N_FRAMES = 625                  # 60 s of stream
STEP = 1_000_003                # ragged, prime-sized chunks


def _impaired(x, step=STEP):
    """``awgn(carrier_offset(x, 180.0), 14.0, default_rng(7))`` piece by
    piece: the rotation restarts at each piece's first sample, the SNR
    is set by the whole rotated stream's power, and the noise is drawn
    from one generator in the same order, so every sample equals the
    whole-array result."""
    y = np.empty_like(x)
    for pos in range(0, x.size, step):
        y[pos:pos + step] = carrier_offset(x[pos:pos + step], 180.0,
                                           start_sample=pos)
    power = float(np.mean(np.abs(y) ** 2))
    scale = np.sqrt(power / (10 ** (14.0 / 10)) / 2)
    rng = np.random.default_rng(7)
    for pos in range(0, y.size, step):
        piece = y[pos:pos + step]
        noise = rng.normal(scale=scale, size=(piece.size, 2))
        y[pos:pos + step] = (piece + noise[:, 0]
                             + 1j * noise[:, 1]).astype(np.complex64)
    return y


def test_impaired_in_pieces_is_the_whole_array_chain():
    x, _ = modulate(build_ensemble(), 3, seed=42)
    np.testing.assert_array_equal(
        _impaired(x, step=100_003),
        awgn(carrier_offset(x, 180.0), 14.0, np.random.default_rng(7)))


def _feed(rx, x):
    eti = []
    for pos in range(0, x.size, STEP):
        eti += rx.feed(x[pos:pos + STEP])
    return eti


def test_long_stream_soak_matches_jax():
    x, payload = modulate(build_ensemble(), N_FRAMES, seed=42)
    x = _impaired(x)
    ref = _feed(jrx.DabReceiver(n_frames=8), x)
    rx = trx.DabReceiver(n_frames=8, device="cpu")
    eti = _feed(rx, x)
    assert eti == ref

    assert rx.ensemble is not None
    frames = list(EtiParser().feed(b"".join(eti)))
    assert len(frames) >= (N_FRAMES - 30) * C.MODE_I.n_cifs
    a = rx._activation_cif
    bad = sum(f.subchannel_data(1) != payload[1][a + k].tobytes()
              for k, f in enumerate(frames))
    assert bad == 0, f"{bad}/{len(frames)} payload mismatches"
    assert all(f.fct == k % 250 for k, f in enumerate(frames))
    assert len(rx._fib_fifo) <= rx.MAX_PENDING_CIFS + 64
    assert len(rx.stats) <= rx.MAX_STATS
    assert sum(len(v) for v in rx._subch_fifo.values()) <= \
        rx.MAX_PENDING_CIFS + 64
    assert all(s.fib_crc_bad == 0 for s in rx.stats[2:])

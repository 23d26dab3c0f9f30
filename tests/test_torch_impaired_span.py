"""The port's time-block span and channel batch under RF impairments,
held against the JAX package (CPU).

The three cases of ``tests/test_sharding_impaired.py``, with its
impairment chain (TU6, a 2.5-carrier CFO, 50 ppm sample-clock drift,
AWGN; fading on the second) and its seeds: the 2 x 4 span, the 1 x 2
span under 4 Hz fading (``devices=["cpu"] * 2``) and 8 impaired streams
as one channel batch, all with the PRS search widened to ``search=448``.
The JAX side runs on ``tests/conftest.py``'s virtual CPU mesh, the
port's on ``"cpu"`` devices.  Bytes are identical to the JAX outputs
(``tests/test_torch_timeblock.py``'s ``_assert_parity``) and every
payload row equals the modulator's, as the JAX tests require; float
diagnostics agree within that file's ``TOL``.
"""

import jax.numpy as jnp
import numpy as np
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.ops.fec import init_deinterleave_ring
from dabtools_tpu.parallel.channel import channel_parallel_block as jcpb
from dabtools_tpu.parallel.mesh import make_receiver_mesh as jmesh
from dabtools_tpu_torch.models.receiver import block_samples, to_host
from dabtools_tpu_torch.parallel import channel as tchannel
from dabtools_tpu_torch.parallel.mesh import make_receiver_mesh
from dabtools_tpu_torch.testsignal import (SPAN_CFO_HZ, SPAN_PPM,
                                            impaired_span_signal)
from dabtools_tpu_torch.utils.crc import crc16_ok_batch
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_sharding_impaired import CFO_HZ, _impair
from tests.test_torch_timeblock import (
    FLOATS,
    TOL,
    _assert_parity,
    _both,
    _host,
    _port,
    _span,
)

torch.set_num_threads(2)

SEARCH = 448                    # the JAX tests' widened PRS search


def _rows_exact(got, payload, g0, n_rows):
    """Row ``j`` of every channel equals the modulator's CIF ``g0*4 + j
    - 15`` (rows before CIF 0 skipped)."""
    for c in range(got.shape[0]):
        for j in range(n_rows):
            n = g0 * 4 + j - 15
            if n >= 0:
                assert got[c, j].tobytes() == payload[n].tobytes(), (c, j)


def test_testsignal_impairment_chain_is_the_jax_tests():
    """``chip_smoke.py``'s impaired-span chain (``testsignal``, no JAX)
    gives ``_impair``'s samples, static and fading."""
    assert (SPAN_CFO_HZ, SPAN_PPM) == (CFO_HZ, 50.0)
    x, _ = modulate(build_ensemble(), 3, seed=21)
    np.testing.assert_array_equal(impaired_span_signal(x, 42),
                                  _impair(x, seed=42))
    np.testing.assert_array_equal(
        impaired_span_signal(x, 47, snr_db=26.0, doppler_hz=4.0),
        _impair(x, seed=47, snr_db=26.0, doppler_hz=4.0))


def test_timeblock_impaired_tu6_cfo_drift_matches_jax():
    """``test_timeblock_impaired_tu6_cfo_drift``: TU6, 2.5 carriers, 50
    ppm and 22 dB over a 2 x 4 span.  Bit-exact against the JAX span;
    per-shard CFOs within 0.15 carriers of 2.5 with a spread under 0.1;
    every FIB CRC good and every row the modulator's."""
    ens = build_ensemble()
    n_time, f_own, warmup = 4, 6, 5
    g0 = warmup + 1
    x, payload = modulate(ens, g0 + n_time * f_own + 1, seed=21)
    x = _impair(x, seed=42)
    jout, tout = _both(ens, 2, n_time, *_span(x, g0, n_time, f_own, warmup),
                       g0, frames_per_shard=f_own, warmup_frames=warmup,
                       search=SEARCH)
    _assert_parity(jout, tout)
    cfo = tout["cfo_carriers"].ravel()
    assert np.all(np.abs(cfo - CFO_HZ / 1000.0) < 0.15), cfo
    assert np.ptp(cfo) < 0.1, cfo
    assert crc16_ok_batch(tout["fib_bytes"].reshape(-1, 32)).all()
    _rows_exact(tout["subch"]["1"], payload[1], g0, n_time * f_own * 4)


def test_timeblock_impaired_with_fading_matches_jax():
    """``test_timeblock_impaired_with_fading``: the same chain with 4 Hz
    fading at 26 dB over a 1 x 2 span on two devices; bit-exact against
    the JAX span and the modulator."""
    ens = build_ensemble()
    n_time, f_own, warmup = 2, 6, 5
    g0 = warmup + 1
    x, payload = modulate(ens, g0 + n_time * f_own + 1, seed=23)
    x = _impair(x, seed=47, snr_db=26.0, doppler_hz=4.0)
    span = [a.copy() for a in _span(x, g0, n_time, f_own, warmup, n_ch=1)]
    jout, tout = _both(ens, 1, n_time, *span, g0,
                       frames_per_shard=f_own, warmup_frames=warmup,
                       search=SEARCH)
    _assert_parity(jout, tout)
    _rows_exact(tout["subch"]["1"], payload[1], g0, n_time * f_own * 4)


def test_channel_parallel_impaired_matches_jax():
    """``test_channel_parallel_impaired``: 8 streams, each its own noise
    and TU6 realization, as one 6-frame channel batch over an 8 x 1
    mesh.  Bytes equal the JAX batch's, every CFO within 0.15 carriers of
    2.5, and rows 15 on equal each stream's modulator payload."""
    ens = build_ensemble()
    n_frames, n_ch = 6, 8
    xs, payloads = [], []
    for c in range(n_ch):
        x, p = modulate(ens, n_frames + 2, seed=300 + c)
        xs.append(_impair(x, seed=500 + c)[: block_samples(n_frames)])
        payloads.append(p)
    xb = np.stack(xs)
    nb = ens.subchannel(1).profile.tx_bits
    ring = init_deinterleave_ring(nb)[None]
    jout, _, jcif = jcpb(
        jnp.asarray(xb), {"1": jnp.tile(ring, (n_ch, 1, 1))},
        jnp.asarray(0, jnp.int32), ensemble=ens, n_frames=n_frames,
        mesh=jmesh(n_channels=n_ch, n_time=1), search=SEARCH)
    tout, trings, tcif = tchannel.channel_parallel_block(
        torch.from_numpy(xb),
        {"1": torch.from_numpy(np.tile(ring, (n_ch, 1, 1)))},
        torch.tensor(0, dtype=torch.int32), ensemble=_port(ens),
        n_frames=n_frames,
        mesh=make_receiver_mesh(n_channels=n_ch, n_time=1,
                                devices=["cpu"] * n_ch), search=SEARCH)
    jout, tout = _host(jout), to_host(tout)
    assert int(tcif) == int(jcif) == n_frames * C.MODE_I.n_cifs
    for key in ("null_start", "prs_offset", "fib_bytes"):
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
    np.testing.assert_array_equal(tout["subch"]["1"], jout["subch"]["1"])
    for key in ("null_ratio", *FLOATS):
        np.testing.assert_allclose(tout[key], jout[key], err_msg=key, **TOL)
    np.testing.assert_allclose(tout["subch_metric"]["1"],
                               jout["subch_metric"]["1"], **TOL)
    cfo = tout["cfo_carriers"]
    assert np.all(np.abs(cfo - CFO_HZ / 1000.0) < 0.15), cfo
    for c in range(n_ch):
        for j in range(15, n_frames * 4):
            assert (tout["subch"]["1"][c, j].tobytes()
                    == payloads[c][1][j - 15].tobytes()), (c, j)

"""Parity of the PyTorch port's time-block receiver, mesh and channel mesh
placement with the JAX package (CPU).

The JAX side runs on the 8-device virtual CPU mesh that
``tests/conftest.py`` sets up; the port's side on ``devices=["cpu"] *
8``.  Spans, prefixes, suffixes and ``g0`` are those of
``tests/test_sharding.py``.  Bytes must be identical (FIB bytes, PRS
offsets, sub-channel rows); float diagnostics agree within ``atol=2e-4,
rtol=1e-4``, the tolerance of ``tests/test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.mod.impairments import awgn, carrier_offset
from dabtools_tpu.parallel.channel import channel_parallel_block as jcpb
from dabtools_tpu.parallel.mesh import make_receiver_mesh as jmesh
from dabtools_tpu.parallel.timeblock import timeblock_receiver as jtb
from dabtools_tpu_torch.fic import config as tconfig
from dabtools_tpu_torch.models.receiver import block_samples, to_host
from dabtools_tpu_torch.parallel import channel as tchannel
from dabtools_tpu_torch.parallel.mesh import make_receiver_mesh
from dabtools_tpu_torch.parallel.timeblock import (
    halo_sizes,
    timeblock_receiver,
)
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_modes import _ensemble, _modulate

torch.set_num_threads(2)

TOL = {"atol": 2e-4, "rtol": 1e-4}
FLOATS = ("fic_metric", "prs_peak", "cfo_carriers")


def _port(ens):
    return tconfig.Ensemble.from_dict(ens.to_dict())


def _host(out) -> dict:
    return {k: ({kk: np.asarray(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in out.items()}


def _both(ens, n_ch, n_time, span, prefix, suffix, g0, mode=C.MODE_I,
          **kw):
    """The same span through the JAX receiver on the virtual CPU mesh and
    the port's on ``["cpu"] * (n_ch * n_time)``; (JAX out, port out) as
    NumPy dicts."""
    n = n_ch * n_time
    jfn = jtb(jmesh(n_channels=n_ch, n_time=n_time,
                    devices=jax.devices()[:n]), ens, mode=mode, **kw)
    tfn = timeblock_receiver(make_receiver_mesh(
        n_channels=n_ch, n_time=n_time, devices=["cpu"] * n), _port(ens),
        mode=mode, **kw)
    jout = jfn(jnp.asarray(span), jnp.asarray(prefix), jnp.asarray(suffix),
               g0)
    tout = tfn(torch.from_numpy(span), torch.from_numpy(prefix),
               torch.from_numpy(suffix), g0)
    return _host(jout), to_host(tout)


def _assert_parity(jout, tout, skip_shards=0, n_time=1):
    """Bytes equal, floats within ``TOL``, from shard ``skip_shards`` on
    (each output's time axis has ``n_time`` equal shards)."""
    assert set(tout) == set(jout)

    def cut(a):
        return a[:, skip_shards * (a.shape[1] // n_time):]

    for key in ("fib_bytes", "prs_offset", *FLOATS):
        assert tout[key].shape == jout[key].shape, key
        if key in FLOATS:
            np.testing.assert_allclose(cut(tout[key]), cut(jout[key]),
                                       err_msg=key, **TOL)
        else:
            np.testing.assert_array_equal(cut(tout[key]), cut(jout[key]),
                                          err_msg=key)
    assert set(tout["subch"]) == set(jout["subch"])
    for k in jout["subch"]:
        np.testing.assert_array_equal(cut(tout["subch"][k]),
                                      cut(jout["subch"][k]))
        np.testing.assert_allclose(cut(tout["subch_metric"][k]),
                                   cut(jout["subch_metric"][k]), **TOL)


def _span(x, g0, n_time, f_own, warmup, mode=C.MODE_I, n_ch=2):
    """``tests/test_sharding.py``'s span, prefix and suffix of ``x``,
    tiled over ``n_ch`` channels."""
    fr = mode.frame_size
    lh, rh = halo_sizes(warmup, mode)
    s0, sl = g0 * fr, n_time * f_own * fr

    def tile(a):
        return np.ascontiguousarray(np.broadcast_to(a, (n_ch, a.size)))

    return (tile(x[s0:s0 + sl]), tile(x[s0 - lh:s0]),
            tile(x[s0 + sl:s0 + sl + rh]))


@pytest.mark.parametrize("kw", [
    {}, {"n_time": 4}, {"n_channels": 2}, {"n_channels": 4, "n_time": 2},
    {"n_channels": 8, "n_time": 1}])
def test_mesh_construction_matches_jax(kw):
    """``test_mesh_construction``'s meshes, and the channel row of each
    of 8 streams as a sharding over ``channels`` places them."""
    mesh = make_receiver_mesh(devices=["cpu"] * 8, **kw)
    jm = jmesh(**kw)
    assert mesh.shape == dict(jm.shape)
    assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
    per = 8 // mesh.shape["channels"]
    assert mesh.rows_of(8) == [c // per for c in range(8)]


def test_mesh_errors_match_jax():
    with pytest.raises(ValueError) as jerr:
        jmesh(n_channels=3, n_time=3)
    with pytest.raises(ValueError) as terr:
        make_receiver_mesh(n_channels=3, n_time=3, devices=["cpu"] * 8)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="do not split"):
        make_receiver_mesh(n_channels=2, devices=["cpu"] * 2).rows_of(3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            make_receiver_mesh()


def test_timeblock_matches_jax():
    """The 2 x 4 span of ``test_timeblock_matches_sequential``: bit-exact
    against the JAX receiver, and every primed row the modulator's."""
    ens = build_ensemble()
    n_time, f_own, warmup = 4, 6, 5
    g0 = warmup + 1
    x, payload = modulate(ens, g0 + n_time * f_own + 1, seed=55)
    jout, tout = _both(ens, 2, n_time, *_span(x, g0, n_time, f_own, warmup),
                       g0, frames_per_shard=f_own, warmup_frames=warmup)
    assert tout["fib_bytes"].shape == (2, n_time * f_own, 12, 32)
    assert tout["cfo_carriers"].shape == (2, n_time)
    _assert_parity(jout, tout)
    got = tout["subch"]["1"]
    for c in range(2):
        for j in range(n_time * f_own * 4):
            assert got[c, j].tobytes() == payload[1][g0 * 4 + j - 15].tobytes()


def test_timeblock_cold_start_matches_jax():
    """A zero prefix (``test_timeblock_cold_start_transient_is_local``):
    the transient stays in shard 0, whose warmup frames are zeros (both
    receivers' CFO search ends on its bound there, and the garbage they
    demodulate is not compared); shards 1-3 equal the JAX receiver's and
    the modulator's."""
    ens = build_ensemble()
    n_time, f_own, warmup = 4, 6, 5
    g0 = warmup + 1
    x, payload = modulate(ens, g0 + n_time * f_own + 1, seed=77)
    span, prefix, suffix = _span(x, g0, n_time, f_own, warmup)
    jout, tout = _both(ens, 2, n_time, span, np.zeros_like(prefix), suffix,
                       g0, frames_per_shard=f_own, warmup_frames=warmup)
    _assert_parity(jout, tout, skip_shards=1, n_time=n_time)
    np.testing.assert_array_equal(tout["cfo_carriers"][:, 0], [-8.0, -8.0])
    np.testing.assert_array_equal(jout["cfo_carriers"][:, 0], [-8.0, -8.0])
    got = tout["subch"]["1"]
    for j in range(f_own * 4, n_time * f_own * 4):
        assert got[0, j].tobytes() == payload[1][g0 * 4 + j - 15].tobytes()


def test_timeblock_mode_iv_matches_jax():
    """Mode IV (2 CIFs a frame), the cheapest of
    ``test_timeblock_modes_ii_iv``'s cases, on a 2 x 2 mesh: bit-exact
    against the JAX receiver and the modulator."""
    mode = C.MODES["IV"]
    f_own, warmup, g0, n_time = 9, 8, 9, 2
    ens = _ensemble(0x3100 + ord("V"))
    x, pb = _modulate(ens, mode, g0 + n_time * f_own + 3)
    jout, tout = _both(ens, 2, n_time,
                       *_span(x, g0, n_time, f_own, warmup, mode), g0,
                       mode=mode, frames_per_shard=f_own,
                       warmup_frames=warmup)
    _assert_parity(jout, tout)
    assert tout["fib_bytes"].shape[1:] == (n_time * f_own, mode.n_fibs, 32)
    for j in range(n_time * f_own * mode.n_cifs):
        assert (tout["subch"]["1"][1, j].tobytes()
                == pb[g0 * mode.n_cifs + j - 15].tobytes())


def _raises_like_jax(build_j, build_t):
    with pytest.raises(ValueError) as jerr:
        build_j()
    with pytest.raises(ValueError) as terr:
        build_t()
    assert str(terr.value) == str(jerr.value)
    return str(terr.value)


# (frames_per_shard, warmup_frames) of each case
_REJECT = {"warmup_short": (6, 3), "mode_iii_shards": (20, 18),
           "halo_exceeds_shard": (4, 5), "span_length": (6, 5),
           "prefix_length": (6, 5), "mode_iii_g0": (21, 18)}


@pytest.mark.parametrize("case", list(_REJECT))
def test_timeblock_rejects_like_jax(case):
    """Every ``ValueError`` of the JAX receiver, with its message: a
    warmup too short to prime the deinterleaver, Mode III shards or g0
    off the FIC codeword phase (``test_timeblock_mode_iii_rejects_
    misaligned_shards``), a halo longer than a shard, and wrong span or
    halo lengths."""
    ens = _ensemble(0x3203)
    mode = C.MODES["III"] if case.startswith("mode_iii") else C.MODE_I
    kw = dict(zip(("frames_per_shard", "warmup_frames"), _REJECT[case]))

    def jbuild():
        return jtb(jmesh(n_channels=4, n_time=2), ens, mode=mode, **kw)

    def tbuild():
        return timeblock_receiver(make_receiver_mesh(
            n_channels=4, n_time=2, devices=["cpu"] * 8), _port(ens),
            mode=mode, **kw)

    if case in ("warmup_short", "mode_iii_shards", "halo_exceeds_shard"):
        msg = _raises_like_jax(jbuild, tbuild)
        assert {"warmup_short": "prime the deinterleaver",
                "mode_iii_shards": "multiples of 3",
                "halo_exceeds_shard": "exceeds the shard span"}[case] in msg
        return
    lh, rh = halo_sizes(kw["warmup_frames"], mode)
    n = 2 * kw["frames_per_shard"] * mode.frame_size
    shapes = {"span_length": (n + 1, lh, rh), "prefix_length": (n, lh - 1, rh),
              "mode_iii_g0": (n, lh, rh)}[case]
    args = [np.zeros((4, m), np.complex64) for m in shapes]
    g0 = 22 if case == "mode_iii_g0" else 6
    jfn, tfn = jbuild(), tbuild()
    msg = _raises_like_jax(
        lambda: jfn(*map(jnp.asarray, args), g0),
        lambda: tfn(*map(torch.from_numpy, args), g0))
    assert {"span_length": "span must be", "prefix_length": "prefix/suffix",
            "mode_iii_g0": "g0=22 must be a multiple of 3"}[case] in msg


# ------------------------------------------------------- channel mesh
def _streams(n_ch):
    """``n_ch`` streams of one modulation, each with its own CFO, start
    and noise seed; (n_ch, block_samples(4)) complex64."""
    ens = build_ensemble()
    x, _ = modulate(ens, 6, seed=3)
    n = block_samples(4)
    return ens, np.stack([
        awgn(carrier_offset(x[300 + 1700 * c:], -300.0 + 200.0 * c), 15.0,
             np.random.default_rng(c))[:n] for c in range(n_ch)])


def test_channel_parallel_mesh_matches_jax():
    """4 streams over a 2 x 2 mesh (two streams a channel row, replicated
    over ``time``): the port's ``mesh=`` batch equals the JAX one."""
    ens, xs = _streams(4)
    nb = ens.subchannel(1).profile.tx_bits
    jout, _, jcif = jcpb(
        jnp.asarray(xs), {"1": jnp.zeros((4, 16, nb))},
        jnp.asarray(0, jnp.int32), ensemble=ens, n_frames=4,
        mesh=jmesh(n_channels=2, n_time=2, devices=jax.devices()[:4]))
    tout, trings, tcif = tchannel.channel_parallel_block(
        torch.from_numpy(xs), {"1": torch.zeros((4, 16, nb))},
        torch.tensor(0, dtype=torch.int32), ensemble=_port(ens), n_frames=4,
        mesh=make_receiver_mesh(n_channels=2, n_time=2,
                                devices=["cpu"] * 4))
    jout, tout = _host(jout), to_host(tout)
    assert int(tcif) == int(jcif) == 16
    assert trings["1"].shape == (4, 16, nb)
    for key in ("null_start", "prs_offset", "fib_bytes"):
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
    np.testing.assert_array_equal(tout["subch"]["1"][:, 15:],
                                  jout["subch"]["1"][:, 15:])
    for key in ("cfo_carriers", "null_ratio", *FLOATS[:2]):
        np.testing.assert_allclose(tout[key], jout[key], err_msg=key, **TOL)


def test_channel_mesh_one_dispatch_per_device(monkeypatch):
    """Streams on two distinct devices ("cpu" and "cpu:0") reach the
    Viterbi in one ragged dispatch per device, with the results of the
    batch without a mesh."""
    ens, xs = _streams(4)
    tens = _port(ens).decode_config()
    nb = ens.subchannel(1).profile.tx_bits
    calls = []
    real = tchannel.viterbi_decode_ragged

    def counting(softs):
        calls.append(sum(s.shape[0] for s in softs))
        return real(softs)

    def run(mesh):
        out, rings, _ = tchannel.channel_parallel_block(
            torch.from_numpy(xs), {"1": torch.zeros((4, 16, nb))},
            torch.tensor(0, dtype=torch.int32), ensemble=tens, n_frames=4,
            mesh=mesh)
        return to_host(out), rings

    want, want_rings = run(None)
    monkeypatch.setattr(tchannel, "viterbi_decode_ragged", counting)
    got, rings = run(make_receiver_mesh(
        n_channels=2, devices=[torch.device("cpu"),
                               torch.device("cpu", 0)]))
    assert calls == [2 * (16 + 16)] * 2
    np.testing.assert_array_equal(got["fib_bytes"], want["fib_bytes"])
    np.testing.assert_array_equal(got["subch"]["1"], want["subch"]["1"])
    assert torch.equal(rings["1"], want_rings["1"])

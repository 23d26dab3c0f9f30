"""The port's demod chain over a leading stream axis (CPU).

Each batched op of the port is held against ``jax.vmap`` of its JAX
counterpart and against the port's own op applied stream by stream, on
the same seeded NumPy inputs of 3 streams: integers exactly, floats
within ``atol=2e-4, rtol=1e-4`` (soft bits and diagnostics; the CIR,
whose magnitude is not normalized, within that share of its peak).

Then a hard batch: 3 streams whose integer CFOs (-2.4, +0.3 and +3.3
carriers) and sample-clock drifts (-50, 0 and +50 ppm) all differ, one
through a TU6 channel, as ``channel_parallel_block`` 4-frame blocks:
bytes equal the JAX ``channel_parallel_block``'s and each stream's own
``process_block``'s, and the rings equal.  A bug that used stream 0's
CFO or drift for every stream would fail it.

Last, the batch runs the chain ONCE per device: ``pre_viterbi`` is
counted on the channel batch (with and without a mesh), ``dabscan`` and
the time-block span.
"""

import functools
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.mod.impairments import (
    awgn,
    carrier_offset,
    multipath,
)
from dabtools_tpu.ops import fec as jfec
from dabtools_tpu.ops import ofdm as jofdm
from dabtools_tpu.ops import sync as jsync
from dabtools_tpu.ops.slicing import window_slices as jwindow_slices
from dabtools_tpu.parallel.channel import channel_parallel_block as jcpb
from dabtools_tpu_torch.fic import config as tconfig
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.ops import fec, ofdm, sync
from dabtools_tpu_torch.ops.slicing import window_slices
from dabtools_tpu_torch.parallel import channel as tchannel
from dabtools_tpu_torch.parallel.mesh import make_receiver_mesh
from dabtools_tpu_torch.parallel.timeblock import (
    halo_sizes,
    timeblock_receiver,
)
from dabtools_tpu_torch.testsignal import (HARD_CFO_CARRIERS, HARD_PPM,
                                            HARD_START)
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_tools_and_drift import _resample_ppm

torch.set_num_threads(2)

MODE = C.MODE_I
FRAME = MODE.frame_size
TOL = {"atol": 2e-4, "rtol": 1e-4}
B = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rowwise(fn, *args):
    """The port's op on each stream in turn, stacked: ``fn(*row_c)``."""
    outs = [fn(*(a[c] for a in args)) for c in range(B)]
    if isinstance(outs[0], tuple):
        return tuple(_stack(z) for z in zip(*outs))
    return _stack(outs)


def _stack(parts):
    if isinstance(parts[0], dict):
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    return torch.stack(parts)


# --------------------------------------------------------- per-op parity
DELAYS = (777, 100, 3000)
CFO_HZ = (-420.0, 2300.0, -3300.0)


@functools.cache
def _signals() -> np.ndarray:
    """3 streams of one 4-frame modulation, each with its own AWGN seed
    and carrier offset, starting inside frame 0 so that frame 1's null
    symbol starts at its ``DELAYS`` entry; (3, n) complex64."""
    x, _ = modulate(build_ensemble(), 4, seed=5)
    n = x.size - FRAME
    return np.stack([
        carrier_offset(awgn(x, 15.0, np.random.default_rng(8 + c)),
                       cfo)[FRAME - d:][:n]
        for c, (cfo, d) in enumerate(zip(CFO_HZ, DELAYS))])


def _frame_starts(frames: int = 2) -> np.ndarray:
    """(3, frames) int32: each stream's frame starts, stream 1's second
    one two samples late."""
    return (np.asarray(DELAYS)[:, None] + np.arange(frames) * FRAME
            + np.array([[0, 0], [0, 2], [0, 0]])[:, :frames]).astype(
        np.int32)


def test_window_slices_batched():
    """Per-row wrap-then-clamp: negative starts and starts past ``n -
    length`` in different rows, as one flat gather."""
    x = (np.arange(3 * 100, dtype=np.float32) * 1.5).reshape(3, 100)
    s = np.array([[0, 5, 17], [-3, -40, 2], [90, 95, 500]], np.int32)
    ref = np.asarray(jax.vmap(lambda r, q: jwindow_slices(r, q, 40))(
        jnp.asarray(x), jnp.asarray(s)))
    got = window_slices(_t(x), _t(s), 40)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got.numpy(), _rowwise(lambda r, q: window_slices(r, q, 40),
                              _t(x), _t(s)).numpy())


def test_coarse_null_sync_batched():
    x = _signals()
    ref = jax.vmap(lambda r: jsync.coarse_null_sync(r, MODE))(jnp.asarray(x))
    got = sync.coarse_null_sync(_t(x), MODE)
    rows = _rowwise(lambda r: sync.coarse_null_sync(r, MODE), _t(x))
    np.testing.assert_array_equal(got["null_start"].numpy(),
                                  np.asarray(ref["null_start"]))
    np.testing.assert_array_equal(got["null_start"].numpy(),
                                  rows["null_start"].numpy())
    np.testing.assert_array_equal(got["null_start"].numpy(), DELAYS)
    for want in (np.asarray(ref["null_ratio"]), rows["null_ratio"].numpy()):
        np.testing.assert_allclose(got["null_ratio"].numpy(), want, **TOL)


def test_fractional_cfo_batched():
    x = _signals()
    fs = np.asarray(DELAYS, np.int32)
    ref = np.asarray(jax.vmap(lambda r, f: jsync.fractional_cfo(r, f, MODE))(
        jnp.asarray(x), jnp.asarray(fs)))
    got = sync.fractional_cfo(_t(x), _t(fs), MODE).numpy()
    rows = _rowwise(lambda r, f: sync.fractional_cfo(r, f, MODE), _t(x),
                    _t(fs)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, rows, **TOL)
    # each stream's own fractional part, not stream 0's
    np.testing.assert_allclose(got, [-0.42, 0.3, -0.3], atol=0.02)


def test_fine_sync_prs_batched():
    x = _signals()
    guess = (_frame_starts() + MODE.null_size + MODE.guard + 5).astype(
        np.int32)
    frac = np.array([-0.42, 0.3, -0.3], np.float32)

    def jone(r, g, f):
        return jax.vmap(lambda q: jsync.fine_sync_prs(
            r, q, MODE, 192, 8, frac_cfo=f))(g)

    ref = jax.vmap(jone)(jnp.asarray(x), jnp.asarray(guess),
                         jnp.asarray(frac))
    got = sync.fine_sync_prs(_t(x), _t(guess), MODE, 192, 8,
                             frac_cfo=_t(frac))
    rows = _rowwise(lambda r, g, f: sync.fine_sync_prs(
        r, g, MODE, 192, 8, frac_cfo=f), _t(x), _t(guess), _t(frac))
    for key in ("offset", "int_cfo"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
        np.testing.assert_array_equal(got[key].numpy(), rows[key].numpy(),
                                      err_msg=key)
    np.testing.assert_array_equal(got["offset"].numpy(),
                                  np.array([[-5, -5], [-5, -7], [-5, -5]]))
    np.testing.assert_array_equal(got["int_cfo"].numpy(),
                                  np.array([[0, 0], [2, 2], [-3, -3]]))
    for want in (np.asarray(ref["peak"]), rows["peak"].numpy()):
        np.testing.assert_allclose(got["peak"].numpy(), want, **TOL)


def test_channel_impulse_response_batched():
    """Per-stream integer and fractional CFO: each row's spectrum roll is
    its own."""
    x = _signals()
    starts = (_frame_starts() + MODE.null_size + MODE.guard).astype(np.int32)
    cfo = np.array([-0.42, 2.3, -3.3], np.float32)

    def jone(r, s, f):
        return jax.vmap(lambda q: jsync.channel_impulse_response(
            r, q, f, MODE))(s)

    ref = np.asarray(jax.vmap(jone)(jnp.asarray(x), jnp.asarray(starts),
                                    jnp.asarray(cfo)))
    got = sync.channel_impulse_response(_t(x), _t(starts), _t(cfo),
                                        MODE).numpy()
    rows = _rowwise(lambda r, s, f: sync.channel_impulse_response(
        r, s, f, MODE), _t(x), _t(starts), _t(cfo)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=TOL["atol"] * scale)
    np.testing.assert_allclose(got, rows, atol=TOL["atol"] * scale)
    np.testing.assert_array_equal(np.abs(got).argmax(-1),
                                  np.abs(ref).argmax(-1))


def test_demod_frames_batched():
    """Per-stream CFO and drift, one drift clipped at the margin: the
    clipped shift is each stream's own on both sides of the FFT."""
    x = _signals()
    starts = _frame_starts()
    cfo = np.array([-0.42, 2.3, -3.3], np.float32)
    drift = np.array([3.7, 0.0, -150.0], np.float32)
    rsoft, rdiag = jax.vmap(lambda r, s, f, d: jofdm.demod_frames(
        r, s, MODE, f, d))(jnp.asarray(x), jnp.asarray(starts),
                           jnp.asarray(cfo), jnp.asarray(drift))
    soft, diag = ofdm.demod_frames(_t(x), _t(starts), MODE, _t(cfo),
                                   _t(drift))
    rows_soft, rows_diag = _rowwise(
        lambda r, s, f, d: ofdm.demod_frames(r, s, MODE, f, d), _t(x),
        _t(starts), _t(cfo), _t(drift))
    assert soft.shape == (B, 2, MODE.n_symbols - 1, 2 * MODE.n_carriers)
    for want in (np.asarray(rsoft), rows_soft.numpy()):
        np.testing.assert_allclose(soft.numpy(), want, **TOL)
    for key in ("carrier_mag_cv", "carrier_mag_mean"):
        for want in (np.asarray(rdiag[key]), rows_diag[key].numpy()):
            np.testing.assert_allclose(diag[key].numpy(), want, **TOL,
                                       err_msg=key)


def test_gather_symbol_windows_batched_short_input():
    """Edge padding of inputs shorter than a frame window, per row."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(B, 50_000))
         + 1j * rng.normal(size=(B, 50_000))).astype(np.complex64)
    starts = np.array([[0, 1000], [7, 30], [-5, 900]], np.int32)
    ref = np.asarray(jax.vmap(lambda r, s: jofdm.gather_symbol_windows(
        r, s, MODE, 0.0, 0.0))(jnp.asarray(x), jnp.asarray(starts)))
    got = ofdm.gather_symbol_windows(_t(x), _t(starts), MODE, 0.0,
                                     0.0).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("per_stream", [True, False],
                         ids=["cif_per_stream", "cif_shared"])
def test_time_deinterleave_batched(per_stream):
    """Rings carried over two runs; a (B,) CIF count (each stream its
    own, across the mod-16 slot wrap) or a shared 0-dim one."""
    rng = np.random.default_rng(11)
    n_bits = 96
    cif = (np.array([0, 13, 2 ** 20 - 3], np.int32) if per_stream
           else np.int32(5))
    jring = jnp.zeros((B, 16, n_bits), jnp.float32)
    tring = torch.zeros((B, 16, n_bits))
    rows_ring = [torch.zeros((16, n_bits)) for _ in range(B)]
    jfn = jax.vmap(jfec.time_deinterleave,
                   in_axes=(0, 0 if per_stream else None, 0))
    for n_cifs in (5, 16):
        coded = rng.normal(size=(B, n_cifs, n_bits)).astype(np.float32)
        jring, jout = jfn(jring, jnp.asarray(cif), jnp.asarray(coded))
        tring, tout = fec.time_deinterleave(tring, _t(np.asarray(cif)),
                                            _t(coded))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
        for c in range(B):
            ci = cif[c] if per_stream else cif
            rows_ring[c], out_c = fec.time_deinterleave(
                rows_ring[c], torch.tensor(ci), _t(coded[c]))
            assert torch.equal(tout[c], out_c)
            assert torch.equal(tring[c], rows_ring[c])
        cif = cif + n_cifs


# ------------------------------------------------------------ hard batch
# carriers -2.4, +0.3, +3.3 (integer bins -2, 0, +3), drifts -50, 0,
# +50 ppm: the batch phase 8 of chip_smoke.py decodes on the card
HARD_CFO = HARD_CFO_CARRIERS
HARD_TU6 = len(HARD_START) - 1     # the stream through a TU6 channel


def _port(ens):
    return tconfig.Ensemble.from_dict(ens.to_dict())


@functools.cache
def _hard_streams():
    """The hard batch: (3, room for 2 blocks of 4 frames) complex64, the
    ensemble and the modulator's payload."""
    ens = build_ensemble()
    x, payload = modulate(ens, 11, seed=21)
    n = trx.block_samples(4) + 5 * FRAME
    xs = []
    for c in range(B):
        y = carrier_offset(_resample_ppm(x, HARD_PPM[c]),
                           HARD_CFO[c] * 1000.0)[HARD_START[c]:]
        if c == HARD_TU6:
            y = multipath(y, rng=np.random.default_rng(6))
        xs.append(awgn(y, 20.0, np.random.default_rng(30 + c))[:n])
    return np.stack(xs), ens, payload


def test_hard_batch_matches_jax_and_each_stream():
    """Two consecutive 4-frame blocks of the hard batch, rings carried:
    bytes and integers equal the JAX ``channel_parallel_block``'s and
    each stream's ``process_block``'s, rings equal the per-stream ones
    and the JAX ones within the float tolerance,
    each stream's CFO and drift are its own, and the primed rows are the
    modulator's payload."""
    x, ens, payload = _hard_streams()
    tens = _port(ens).decode_config()
    nb = ens.subchannel(1).profile.tx_bits
    n = trx.block_samples(4)
    jrings = {"1": np.zeros((B, 16, nb), np.float32)}
    trings = {"1": torch.zeros((B, 16, nb))}
    srings = [{"1": torch.zeros((16, nb))} for _ in range(B)]
    jcif, tcif = jnp.asarray(0, jnp.int32), torch.tensor(0, dtype=torch.int32)
    adv = [0] * B
    for blk in range(2):
        xb = np.stack([x[c, adv[c]: adv[c] + n] for c in range(B)])
        jout, jrings, jcif = jcpb(jnp.asarray(xb), jrings, jcif,
                                  ensemble=ens.decode_config(), n_frames=4)
        tout, trings, tcif = tchannel.channel_parallel_block(
            _t(xb), trings, tcif, ensemble=tens, n_frames=4)
        tout = trx.to_host(tout)
        # the rings hold soft values: JAX's and the port's demod differ
        # in the last bits of float32, so the float tolerance
        np.testing.assert_allclose(trings["1"].numpy(),
                                   np.asarray(jrings["1"]), **TOL)
        rows = slice(15 if blk == 0 else 0, None)
        for key in ("null_start", "prs_offset", "fib_bytes"):
            np.testing.assert_array_equal(tout[key], np.asarray(jout[key]),
                                          err_msg=key)
        np.testing.assert_array_equal(tout["subch"]["1"][:, rows],
                                      np.asarray(jout["subch"]["1"])[:, rows])
        for key in ("cfo_carriers", "null_ratio", "prs_peak", "fic_metric",
                    "delay_spread"):
            np.testing.assert_allclose(tout[key], np.asarray(jout[key]),
                                       err_msg=key, **TOL)
        np.testing.assert_allclose(tout["cfo_carriers"], HARD_CFO, atol=0.05)
        # the drift shows in each stream's own PRS offsets
        spread = np.ptp(tout["prs_offset"], axis=1)
        assert spread[0] >= 20 and spread[1] <= 2 and spread[2] >= 20
        for c in range(B):
            sout, srings[c], scif = trx.process_block(
                _t(xb[c]), srings[c],
                torch.tensor(16 * blk, dtype=torch.int32), ensemble=tens,
                n_frames=4)
            sout = trx.to_host(sout)
            assert int(scif) == int(tcif) == int(jcif) == 16 * (blk + 1)
            for key in ("null_start", "prs_offset", "fib_bytes"):
                np.testing.assert_array_equal(tout[key][c], sout[key],
                                              err_msg=key)
            np.testing.assert_array_equal(tout["subch"]["1"][c],
                                          sout["subch"]["1"])
            assert torch.equal(trings["1"][c], srings[c]["1"])
            adv[c] += int(sout["null_start"]) + 4 * FRAME - 4096
    # block 2's rows are logical frames 1..16 after the first whole frame
    for c in range(B):
        for j in range(16):
            assert (tout["subch"]["1"][c, j].tobytes()
                    == payload[1][4 + 1 + j].tobytes()), (c, j)


def test_batch_of_one_is_process_block():
    """A batch of one stream equals ``process_block`` of that stream."""
    x, ens, _ = _hard_streams()
    tens = _port(ens).decode_config()
    nb = ens.subchannel(1).profile.tx_bits
    xb = x[2, : trx.block_samples(4)]
    cif = torch.tensor(0, dtype=torch.int32)
    bout, brings, _ = tchannel.channel_parallel_block(
        _t(xb[None]), {"1": torch.zeros((1, 16, nb))}, cif, ensemble=tens,
        n_frames=4)
    sout, srings, _ = trx.process_block(_t(xb), {"1": torch.zeros((16, nb))},
                                        cif, ensemble=tens, n_frames=4)
    bout, sout = trx.to_host(bout), trx.to_host(sout)
    for key in ("null_start", "prs_offset", "fib_bytes"):
        np.testing.assert_array_equal(bout[key][0], sout[key], err_msg=key)
    np.testing.assert_array_equal(bout["subch"]["1"][0], sout["subch"]["1"])
    assert torch.equal(brings["1"][0], srings["1"])


# ----------------------------------------------- one chain per device
@pytest.fixture
def pre_viterbi_calls(monkeypatch):
    """Every ``pre_viterbi`` call, as (streams in its batch,) shapes."""
    calls = []
    real = trx.pre_viterbi

    def counting(x, *args, **kwargs):
        calls.append(tuple(x.shape[:-1]))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(trx, "pre_viterbi", counting)
    monkeypatch.setattr(tchannel, "pre_viterbi", counting)
    return calls


@pytest.mark.parametrize("layout", ["no_mesh", "one_device_mesh",
                                    "two_device_mesh"])
def test_channel_batch_one_pre_viterbi_per_device(pre_viterbi_calls,
                                                  layout):
    """4 streams: one ``pre_viterbi`` over all four on one device, with
    or without a mesh; one over each row's two streams on two devices
    ("cpu" and "cpu:0"), with the outputs of the batch without a mesh."""
    x, ens, _ = _hard_streams()
    xs = np.concatenate([x, x[:1]])[:, : trx.block_samples(4)]
    tens = _port(ens).decode_config()
    nb = ens.subchannel(1).profile.tx_bits
    mesh = {"no_mesh": None,
            "one_device_mesh": make_receiver_mesh(n_channels=2,
                                                  devices=["cpu"] * 2),
            "two_device_mesh": make_receiver_mesh(
                n_channels=2, devices=[torch.device("cpu"),
                                       torch.device("cpu", 0)])}[layout]

    def run(mesh):
        out, rings, _ = tchannel.channel_parallel_block(
            _t(xs), {"1": torch.zeros((4, 16, nb))},
            torch.tensor(0, dtype=torch.int32), ensemble=tens, n_frames=4,
            mesh=mesh)
        return trx.to_host(out), rings

    got, rings = run(mesh)
    want_calls = [(2,), (2,)] if layout == "two_device_mesh" else [(4,)]
    assert pre_viterbi_calls == want_calls
    pre_viterbi_calls.clear()
    want, want_rings = run(None)
    np.testing.assert_array_equal(got["fib_bytes"], want["fib_bytes"])
    np.testing.assert_array_equal(got["subch"]["1"], want["subch"]["1"])
    assert torch.equal(rings["1"], want_rings["1"])


def test_dabscan_one_pre_viterbi(pre_viterbi_calls, tmp_path, capsys):
    """``dabscan``'s FIC-only acquisition of four candidate blocks is one
    ``pre_viterbi`` over the four streams."""
    from dabtools_tpu_torch.cli.dabscan import main
    from tests.test_torch_parallel import _scan_capture
    cap = _scan_capture(str(tmp_path))
    assert main(["--torch-device", "cpu", "--center", "184.5e6", "--rate",
                 "8.192e6", "--seconds", "0.8", str(cap)]) == 0
    assert pre_viterbi_calls == [(4,)]
    assert "2 ensemble(s) found" in capsys.readouterr().err


@pytest.mark.parametrize("devices", ["one", "two"])
def test_span_one_pre_viterbi_per_device(pre_viterbi_calls, devices):
    """A 1 x 2 span on one device is one ``pre_viterbi`` over its two
    cells; on two devices, one per device, with the same bytes."""
    ens = build_ensemble()
    n_time, f_own, w = 2, 5, 4
    g0 = w + 1
    x, payload = modulate(ens, g0 + n_time * f_own + 1, seed=55)
    lh, rh = halo_sizes(w)
    s0, sl = g0 * FRAME, n_time * f_own * FRAME
    span, prefix, suffix = (_t(a[None]) for a in (
        x[s0:s0 + sl], x[s0 - lh:s0], x[s0 + sl:s0 + sl + rh]))
    devs = {"one": ["cpu"] * 2,
            "two": [torch.device("cpu"), torch.device("cpu", 0)]}[devices]
    fn = timeblock_receiver(make_receiver_mesh(
        n_channels=1, n_time=n_time, devices=devs), _port(ens),
        frames_per_shard=f_own, warmup_frames=w)
    out = trx.to_host(fn(span, prefix, suffix, g0))
    assert pre_viterbi_calls == ([(2,)] if devices == "one"
                                 else [(1,), (1,)])
    got = out["subch"]["1"]
    assert got.shape[:2] == (1, n_time * f_own * 4)
    for j in range(n_time * f_own * 4):
        assert got[0, j].tobytes() == payload[1][g0 * 4 + j - 15].tobytes()


def test_port_has_no_vmap():
    """The stream axis is written out: the port never wraps the
    single-stream chain in ``torch.func.vmap`` (which runs an op without
    a batching rule once per stream)."""
    import dabtools_tpu_torch
    root = pathlib.Path(inspect.getfile(dabtools_tpu_torch)).parent
    for path in root.rglob("*.py"):
        src = path.read_text()
        assert "torch.func" not in src and "vmap(" not in src, path

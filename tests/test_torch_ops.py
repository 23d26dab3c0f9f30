"""Parity of the PyTorch port's signal ops with the JAX package (CPU).

The same NumPy inputs go through ``dabtools_tpu.ops`` (JAX on the CPU)
and ``dabtools_tpu_torch.ops`` (PyTorch on the CPU).  Integers and bytes
must agree exactly (window starts, null start, PRS offsets, integer CFO,
depunctured/descrambled/packed bits, deinterleaved values).  Floats that
pass through an FFT or a transcendental agree to a stated tolerance:
pocketfft (PyTorch) and XLA's CPU FFT round differently, by a few ulps of
float32 at these sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.mod.impairments import awgn, carrier_offset, timing_offset
from dabtools_tpu.ops import fec as jfec
from dabtools_tpu.ops import ofdm as jofdm
from dabtools_tpu.ops import sync as jsync
from dabtools_tpu.ops.bits import pack_bits as jpack_bits
from dabtools_tpu.ops.slicing import window_slices as jwindow_slices
from dabtools_tpu.tables.puncturing import FIC_PROFILE, eep_profile
from dabtools_tpu_torch import constants as tC
from dabtools_tpu_torch.ops import fec, ofdm, sync
from dabtools_tpu_torch.ops.bits import pack_bits
from dabtools_tpu_torch.ops.slicing import window_slices
from tests.test_closed_loop import build_ensemble, modulate

torch.set_num_threads(2)

MODE = C.MODE_I
# Soft bits are normalized to mean |q| = 1; FFT/transcendental rounding
# differences between the two frameworks stay far below this.
SOFT_ATOL = 2e-4
SOFT_RTOL = 1e-4


@functools.cache
def _signal(impaired: bool) -> np.ndarray:
    x, _ = modulate(build_ensemble(), 3, seed=5)
    if impaired:
        rng = np.random.default_rng(8)
        x = timing_offset(carrier_offset(awgn(x, 15.0, rng), -420.0), 777)
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- slicing
@pytest.mark.parametrize("starts", [[0, 5, 17], [-3, -40, 2], [90, 95, 500],
                                    [-1000, 60, 61]])
def test_window_slices_clamp_and_wrap(starts):
    x = np.arange(100, dtype=np.float32) * 1.5
    s = np.asarray(starts, dtype=np.int32)
    ref = np.asarray(jwindow_slices(jnp.asarray(x), jnp.asarray(s), 40))
    got = window_slices(_t(x), _t(s), 40).numpy()
    np.testing.assert_array_equal(got, ref)


def test_window_slices_longer_than_input_raises():
    x = np.zeros(10, dtype=np.float32)
    s = np.zeros(1, dtype=np.int32)
    with pytest.raises((TypeError, ValueError)):
        jwindow_slices(jnp.asarray(x), jnp.asarray(s), 11)
    with pytest.raises(ValueError):
        window_slices(_t(x), _t(s), 11)


# ------------------------------------------------------------------ bits
def test_pack_bits_exact():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=(3, 5, 64), dtype=np.uint8)
    got = pack_bits(_t(bits)).numpy()
    np.testing.assert_array_equal(got, np.packbits(bits, axis=-1))
    np.testing.assert_array_equal(got, np.asarray(jpack_bits(
        jnp.asarray(bits))))
    with pytest.raises(ValueError):
        pack_bits(torch.zeros(7, dtype=torch.uint8))


@pytest.mark.parametrize("profile", [FIC_PROFILE, eep_profile(3, "A", 128),
                                     eep_profile(2, "B", 64)],
                         ids=lambda p: p.name)
def test_depuncture_exact(profile):
    rng = np.random.default_rng(1)
    tx = rng.normal(size=(3, profile.tx_bits)).astype(np.float32)
    ref = np.asarray(jfec.depuncture(jnp.asarray(tx), profile))
    got = fec.depuncture(_t(tx), profile).numpy()
    np.testing.assert_array_equal(got, ref)


def test_descramble_exact():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, size=(4, 3072), dtype=np.uint8)
    ref = np.asarray(jfec.descramble(jnp.asarray(bits)))
    np.testing.assert_array_equal(fec.descramble(_t(bits)).numpy(), ref)


# ----------------------------------------------------------- deinterleave
@pytest.mark.parametrize("cif0,blocks", [(0, (4, 16, 7, 4)),
                                         (13, (5, 3, 16, 1)),
                                         (2 ** 20 - 3, (8, 9))])
def test_time_deinterleave_across_blocks(cif0, blocks):
    """Block splits and the mod-16 slot wrap of the CIF counter: the
    port's ring and aligned output equal the JAX package's exactly."""
    rng = np.random.default_rng(cif0)
    n_bits = 96
    jring = jfec.init_deinterleave_ring(n_bits)
    tring = fec.init_deinterleave_ring(n_bits, "cpu")
    cif = cif0
    for n_cifs in blocks:
        coded = rng.normal(size=(n_cifs, n_bits)).astype(np.float32)
        jring, jout = jfec.time_deinterleave(
            jring, jnp.asarray(cif, jnp.int32), jnp.asarray(coded))
        tring, tout = fec.time_deinterleave(
            tring, torch.tensor(cif, dtype=torch.int32), _t(coded))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tring.numpy(), np.asarray(jring))
        cif += n_cifs


# ------------------------------------------------------------------ sync
@pytest.mark.parametrize("impaired", [False, True])
def test_coarse_null_sync(impaired):
    x = _signal(impaired)
    ref = jsync.coarse_null_sync(jnp.asarray(x), MODE)
    got = sync.coarse_null_sync(_t(x), MODE)
    assert int(got["null_start"]) == int(ref["null_start"])
    assert got["null_start"].dtype == torch.int32
    np.testing.assert_allclose(float(got["null_ratio"]),
                               float(ref["null_ratio"]), rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("impaired", [False, True])
def test_fractional_cfo(impaired):
    x = _signal(impaired)
    start = 777 if impaired else 0
    ref = float(jsync.fractional_cfo(jnp.asarray(x),
                                     jnp.asarray(start, jnp.int32), MODE))
    got = float(sync.fractional_cfo(_t(x), torch.tensor(start), MODE))
    assert abs(got - ref) < 1e-5


@pytest.mark.parametrize("impaired", [False, True])
def test_fine_sync_prs_batched(impaired):
    """Per-frame PRS search as one batch vs the JAX vmap: offsets and
    integer CFO exact, peaks to 1e-4 relative."""
    x = _signal(impaired)
    base = 777 if impaired else 0
    guesses = (np.array([base - 40, base + MODE.frame_size + 25,
                         base + 2 * MODE.frame_size])
               + MODE.null_size + MODE.guard).astype(np.int32)
    frac = float(jsync.fractional_cfo(jnp.asarray(x),
                                      jnp.asarray(base, jnp.int32), MODE))
    ref = jax.vmap(lambda g: jsync.fine_sync_prs(
        jnp.asarray(x), g, MODE, 192, 8, frac_cfo=frac))(
        jnp.asarray(guesses))
    got = sync.fine_sync_prs(_t(x), _t(guesses), MODE, 192, 8,
                             frac_cfo=torch.tensor(frac))
    np.testing.assert_array_equal(got["offset"].numpy(),
                                  np.asarray(ref["offset"]))
    np.testing.assert_array_equal(got["int_cfo"].numpy(),
                                  np.asarray(ref["int_cfo"]))
    np.testing.assert_allclose(got["peak"].numpy(), np.asarray(ref["peak"]),
                               rtol=1e-4)
    if impaired:
        assert (got["int_cfo"].numpy() == 0).all()   # -420 Hz = -0.42 car.


def test_channel_impulse_response():
    x = _signal(True)
    starts = (np.array([777, 777 + MODE.frame_size]) + MODE.null_size
              + MODE.guard).astype(np.int32)
    cfo = np.float32(-0.42)
    ref = np.asarray(jax.vmap(lambda s: jsync.channel_impulse_response(
        jnp.asarray(x), s, jnp.asarray(cfo), MODE))(jnp.asarray(starts)))
    got = sync.channel_impulse_response(_t(x), _t(starts),
                                        torch.tensor(cfo), MODE).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale)
    assert np.argmax(np.abs(got[0])) == np.argmax(np.abs(ref[0]))


def test_null_ratio_to_snr_db_matches():
    for r in (0.001, 0.01, 0.3, 0.9):
        assert sync.null_ratio_to_snr_db(r) == jsync.null_ratio_to_snr_db(r)
    assert (sync.SNR_METHOD, sync.SNR_CAVEAT) == (jsync.SNR_METHOD,
                                                  jsync.SNR_CAVEAT)


# ------------------------------------------------------------------ ofdm
@pytest.mark.parametrize("impaired,cfo,drift", [(False, 0.0, 0.0),
                                                (True, -0.42, 3.7),
                                                (True, 0.13, -150.0)])
def test_demod_frames(impaired, cfo, drift):
    """Soft bits of every symbol within the stated tolerance, including a
    nonzero CFO, a drift and a drift clipped at the margin."""
    x = _signal(impaired)
    base = 777 if impaired else 0
    starts = np.array([base, base + MODE.frame_size + 2], dtype=np.int32)
    rsoft, rdiag = jofdm.demod_frames(jnp.asarray(x), jnp.asarray(starts),
                                      MODE, jnp.float32(cfo),
                                      jnp.float32(drift))
    soft, diag = ofdm.demod_frames(_t(x), _t(starts), MODE,
                                   torch.tensor(cfo), torch.tensor(drift))
    np.testing.assert_allclose(soft.numpy(), np.asarray(rsoft),
                               atol=SOFT_ATOL, rtol=SOFT_RTOL)
    # the clean signal's dispersion is ~1e-6, i.e. rounding noise itself
    np.testing.assert_allclose(diag["carrier_mag_cv"].numpy(),
                               np.asarray(rdiag["carrier_mag_cv"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(diag["carrier_mag_mean"].numpy(),
                               np.asarray(rdiag["carrier_mag_mean"]),
                               rtol=1e-4)


@pytest.mark.parametrize("mode", ["I", "II", "III", "IV"])
def test_cfo_from_hz_matches_jax(mode):
    """Hz to carrier spacings, on the host, for a scalar and an array:
    equal to the JAX package's value in every mode."""
    hz = np.array([-4300.0, -1499.0, 0.0, 420.0, 2500.0, 12345.6])
    for v in (420.0, -3500.0, hz):
        got = ofdm.cfo_from_hz(v, tC.MODES[mode])
        want = jofdm.cfo_from_hz(v, C.MODES[mode])
        assert type(got) is type(want)
        np.testing.assert_array_equal(got, want)
    assert ofdm.cfo_from_hz(1000.0) == 1000.0 / (C.SAMPLE_RATE / 2048)


def test_demod_with_cfo_correction():
    """``tests/test_ops.py``'s CFO-corrected demod (420 Hz, 22 dB) with
    ``cfo_norm=cfo_from_hz(420.0)``: soft bits within the stated
    tolerance of the JAX demod, and that test's raw bit-error bound."""
    from dabtools_tpu.mod.convcode import conv_encode
    from dabtools_tpu.utils.prbs import scramble_bits
    from tests.test_ops import _modulated_frames
    x, fibs, _, _ = _modulated_frames(1, seed=4)
    x = awgn(carrier_offset(x, 420.0), 22, np.random.default_rng(11))
    starts = np.array([0], dtype=np.int32)
    rsoft, _ = jofdm.demod_frames(jnp.asarray(x), jnp.asarray(starts),
                                  cfo_norm=jofdm.cfo_from_hz(420.0))
    soft, _ = ofdm.demod_frames(_t(x), _t(starts),
                                cfo_norm=ofdm.cfo_from_hz(420.0))
    np.testing.assert_allclose(soft.numpy(), np.asarray(rsoft),
                               atol=SOFT_ATOL, rtol=SOFT_RTOL)
    mask = FIC_PROFILE.mask().astype(bool)
    triplet = np.unpackbits(fibs[0, :3].reshape(-1))
    expect = conv_encode(scramble_bits(triplet))[mask][:3072]
    got = (soft[0, 0, :].numpy() < 0).astype(np.uint8)
    assert int(np.sum(got[:expect.size] != expect)) < 20


def test_gather_symbol_windows_short_input_edge_pad():
    """Inputs shorter than one frame window are edge-padded, as in JAX."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=50_000) + 1j * rng.normal(size=50_000)).astype(
        np.complex64)
    starts = np.array([0, 1000], dtype=np.int32)
    ref = np.asarray(jofdm.gather_symbol_windows(
        jnp.asarray(x), jnp.asarray(starts), MODE, 0.0, 0.0))
    got = ofdm.gather_symbol_windows(_t(x), _t(starts), MODE, 0.0,
                                     0.0).numpy()
    np.testing.assert_array_equal(got, ref)

"""Parity of the PyTorch port's front ends with the JAX package (CPU):
TII detection and ``DabReceiver(tii=True)``, the polyphase resampler,
the wideband channelizer (both methods) and the Band III table.

Each input is built once from a NumPy seed and goes through the JAX
function and the port's.  TII pair powers and SNR agree within
``rtol=1e-4``; resampler outputs within ``atol=1e-5`` on unit-power
input; channelizer outputs within ``atol=1e-4``; decoded bytes, detected
ids and streaming state exactly.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.mod.impairments import awgn, quantize_u8, u8_to_complex
from dabtools_tpu.models import receiver as jrx
from dabtools_tpu.ops import fir as jfir
from dabtools_tpu.ops import resample as jres
from dabtools_tpu.ops import tii as jtii
from dabtools_tpu.ops.sync import coarse_null_sync
from dabtools_tpu.tables import bandiii as jband
from dabtools_tpu_torch.mod import modulator as tmod
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.ops import cudalib
from dabtools_tpu_torch.ops import fir as tfir
from dabtools_tpu_torch.ops import resample as tres
from dabtools_tpu_torch.ops import tii as ttii
from dabtools_tpu_torch.tables import bandiii as tband
from tests.test_tii import _ensemble, _modulate

torch.set_num_threads(2)


def _unit_noise(n: int, seed: int) -> np.ndarray:
    """(n,) complex64 Gaussian noise of unit mean power."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n))
            / np.sqrt(2)).astype(np.complex64)


# -------------------------------------------------------------------- TII
def test_tii_tables_and_inserter_match_jax():
    for p in range(jtii.N_PATTERNS):
        assert ttii.pattern_groups(p) == jtii.pattern_groups(p)
        assert ttii.groups_pattern(jtii.pattern_groups(p)[::-1]) == p
    np.testing.assert_array_equal(ttii.tii_carrier_pairs(),
                                  jtii.tii_carrier_pairs())
    for c, p in ((0, 0), (23, 69), (7, 31)):
        np.testing.assert_array_equal(ttii.tii_null_symbol(c, p, amp=0.5),
                                      jtii.tii_null_symbol(c, p, amp=0.5))
    with pytest.raises(ValueError):
        ttii.tii_null_symbol(24, 0)


def test_modulator_with_tii_matches_jax():
    """The port's ``Modulator(tii=...)`` (whose lazy ``ops.tii`` import
    now resolves to the port's module) equals the JAX one exactly."""
    ens = _ensemble()
    ref = _modulate(ens, 2, tii=(7, 31), seed=4)
    sub = ens.subchannels[0]
    from dabtools_tpu_torch.fic import config as tconfig
    from dabtools_tpu_torch.fic.fig import build_fibs_for_ensemble
    tens = tconfig.Ensemble.from_dict(ens.to_dict())
    rng = np.random.default_rng(4)
    payload = np.unpackbits(rng.integers(
        0, 256, size=(8, sub.data_bytes), dtype=np.uint8), axis=-1)
    mod = tmod.Modulator([tmod.SubchannelSource(0, tens.subchannels[0]
                                                .profile)],
                         tii=(7, 31), tii_amp=0.5)
    got = mod.frames(2, lambda f: build_fibs_for_ensemble(tens, f),
                     lambda f, i: payload[f * 4:(f + 1) * 4])
    np.testing.assert_array_equal(got, ref)


@functools.cache
def _tii_capture(tii, noisy: bool):
    x = _modulate(_ensemble(), 5, tii=tii, seed=2)
    if noisy:
        x = awgn(x, snr_db=8.0, rng=np.random.default_rng(1))
    return x[: 5 * C.MODE_I.frame_size]


@pytest.mark.parametrize("tii,noisy", [((0, 0), False), ((23, 69), False),
                                       ((7, 31), False), ((11, 42), True),
                                       (None, False)])
def test_tii_powers_and_detection_match_jax(tii, noisy):
    x = _tii_capture(tii, noisy)
    ns = int(coarse_null_sync(jnp.asarray(x), C.MODE_I)["null_start"])
    ref = jtii.tii_powers_at(jnp.asarray(x), jnp.int32(ns), 4)
    got = ttii.tii_powers_at(torch.from_numpy(x),
                             torch.tensor(ns, dtype=torch.int32), 4)
    np.testing.assert_allclose(got["powers"].numpy(),
                               np.asarray(ref["powers"]), rtol=1e-4,
                               atol=1e-4 * float(np.max(ref["powers"])))
    np.testing.assert_allclose(float(got["floor"]), float(ref["floor"]),
                               rtol=1e-4)
    jdet = jtii.detect_tii_block(x, n_frames=4)
    tdet = ttii.detect_tii_block(torch.from_numpy(x), n_frames=4)
    if tii is None:
        assert jdet is None and tdet is None
        return
    assert (tdet.sub_id, tdet.main_id) == (jdet.sub_id, jdet.main_id) == tii
    np.testing.assert_allclose(tdet.snr, jdet.snr, rtol=1e-4)


def test_tii_window_start_clamps():
    """A window past the end of the block starts at ``n - fft_size``, as
    ``lax.dynamic_slice`` clamps it (no wrap)."""
    x = _unit_noise(6000, 3)
    late = torch.tensor([5000, 0], dtype=torch.int64)
    got = ttii.tii_pair_powers(torch.from_numpy(x), late)
    ref = jtii.tii_pair_powers(jnp.asarray(x), jnp.asarray([5000, 0],
                                                            jnp.int32))
    np.testing.assert_allclose(got["powers"].numpy(),
                               np.asarray(ref["powers"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["floor"]), float(ref["floor"]),
                               rtol=1e-4)


@functools.cache
def _receiver_tii_capture():
    return _modulate(_ensemble(), 10, tii=(5, 17), seed=0)


def test_receiver_tii_matches_jax():
    """``DabReceiver(tii=True)`` on the CPU: the same ETI bytes and the same
    accumulated powers, floor and detection as the JAX receiver (which
    accumulates on every pass, the acquisition replay included)."""
    x = _receiver_tii_capture()
    jr = jrx.DabReceiver(n_frames=4, tii=True)
    ref = jr.feed(x)
    tr = trx.DabReceiver(n_frames=4, tii=True, device="cpu")
    assert tr.feed(x) == ref and ref
    assert tr.device_steps == len(tr.stats) + 1
    np.testing.assert_allclose(tr._tii_powers, jr._tii_powers, rtol=1e-4,
                               atol=1e-4 * jr._tii_powers.max())
    np.testing.assert_allclose(tr._tii_floor, jr._tii_floor, rtol=1e-4)
    jdet, tdet = jr.tii(), tr.tii()
    assert (tdet.main_id, tdet.sub_id) == (jdet.main_id, jdet.sub_id) == (
        17, 5)
    np.testing.assert_allclose(tdet.snr, jdet.snr, rtol=1e-4)
    assert trx.DabReceiver(n_frames=4, device="cpu").tii() is None


def test_receiver_tii_from_u8():
    """On u8 input the port detects TII on the converted samples: its
    result equals the JAX receiver's on the same samples fed as complex64.
    (The JAX receiver fed u8 windows the raw interleaved bytes and finds
    nothing; ROADMAP Queue 3.)"""
    u8 = quantize_u8(_receiver_tii_capture())
    tr = trx.DabReceiver(n_frames=4, tii=True, device="cpu")
    tr.feed(u8)
    jr = jrx.DabReceiver(n_frames=4, tii=True)
    jr.feed(u8_to_complex(u8))
    np.testing.assert_allclose(tr._tii_powers, jr._tii_powers, rtol=1e-4,
                               atol=1e-4 * jr._tii_powers.max())
    tdet, jdet = tr.tii(), jr.tii()
    assert (tdet.main_id, tdet.sub_id) == (jdet.main_id, jdet.sub_id) == (
        17, 5)


# -------------------------------------------------------------- resampler
def test_resampler_matches_jax_oneshot_and_streaming():
    x = _unit_noise(300_000, 0)
    ref = jres.Resampler(2_400_000)(x)
    one = tres.Resampler(2_400_000, device="cpu")
    assert (one.up, one.down) == (64, 75)
    np.testing.assert_array_equal(one.bank, jres.Resampler(2_400_000).bank)
    np.testing.assert_allclose(one(x).cpu().numpy(), ref, atol=1e-5)
    # the JAX test's uneven chunks, one call at a time in both packages
    jr, tr = jres.Resampler(2_400_000), tres.Resampler(2_400_000,
                                                       device="cpu")
    for a, b in ((0, 50_000), (50_000, 50_137), (50_137, 200_000),
                 (200_000, 300_000)):
        want, got = jr(x[a:b]), tr(x[a:b]).cpu().numpy()
        assert got.shape == want.shape and got.dtype == np.complex64
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (tr._next_out, tr._consumed, tr._tail.size) == (
            jr._next_out, jr._consumed, jr._tail.size)


N0_PAST_2_32 = 2 ** 32 + 12_345    # a global output index past 2^32
# uneven chunks: an empty one, one shorter than the tail, single samples
# (some of which complete no output at 75/64) and long ones
RESAMPLER_CHUNKS = ([(0, 50_000), (50_000, 50_000), (50_000, 50_005)]
                    + [(a, a + 1) for a in range(50_005, 50_025)]
                    + [(50_025, 50_137), (50_137, 200_000),
                       (200_000, 300_000)])


def _past_2_32(*resamplers):
    """Put each resampler at output ``N0_PAST_2_32``, having consumed
    exactly the inputs before that output's newest one, so that its first
    window starts at the head of the buffer (the zero tail)."""
    for r in resamplers:
        r._next_out = N0_PAST_2_32
        r._consumed = N0_PAST_2_32 * r.down // r.up


def test_resampler_window_indices_past_2_32():
    """The plain path's phases and window starts, from the call's three
    scalars, equal the NumPy formula over int64 output indices."""
    r = tres.Resampler(2_400_000, device="cpu")
    _past_2_32(r)
    t = r.taps_per_phase
    base = r._consumed - r._tail.size
    for n_new in (1, 5, 50_000, 1_843_200):
        n1, r0, s0 = r._plan(n_new)
        n0 = r._next_out
        n = np.arange(n0, n1 + 1, dtype=np.int64)
        assert n1 >= n0 and n[0] * r.down > 2 ** 38
        phases, starts = tres.window_indices(r0, s0, n.size, r.down, r.up)
        np.testing.assert_array_equal(phases.numpy(), (n * r.down) % r.up)
        np.testing.assert_array_equal(
            starts.numpy(), n * r.down // r.up - base - (t - 1))
        assert starts[0] == s0 == 0


@pytest.mark.parametrize("rate", [2_400_000, 2_500_000])
def test_resampler_matches_jax_past_2_32(rate):
    """The JAX comparison at a global output index past 2^32, over uneven
    chunks; at 2.5 Msps the bank has 512 phases."""
    x = _unit_noise(300_000, 1)
    jr = jres.Resampler(rate)
    tr = tres.Resampler(rate, device="cpu")
    _past_2_32(jr, tr)
    sizes = []
    for a, b in RESAMPLER_CHUNKS:
        want, got = jr(x[a:b]), tr(x[a:b]).cpu().numpy()
        assert got.shape == want.shape and got.dtype == np.complex64
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (tr._next_out, tr._consumed, tr._tail.size) == (
            jr._next_out, jr._consumed, jr._tail.size)
        np.testing.assert_array_equal(tr._tail, jr._tail)
        sizes.append((b - a, got.size))
    assert (0, 0) in sizes and any(n and not m for n, m in sizes)
    assert (5, 0) not in sizes


def test_resample_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back: a CPU tensor raises before
    any build or launch, and the launch counter stays."""
    r = tres.Resampler(2_400_000, device="cpu")
    before = cudalib.launches["dab_resample"]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tres.resample_cuda(r._tail_dev,
                           torch.zeros(100, dtype=torch.complex64),
                           r._bank_dev, 0, 0, 10, r.down)
    assert cudalib.launches["dab_resample"] == before


def test_resampler_rejects_unrelated_rate():
    with pytest.raises(ValueError, match="interpolation factor"):
        tres.Resampler(2_400_001, device="cpu")
    with pytest.raises(TypeError):
        tres.Resampler(2_400_000)              # the device is required


# ------------------------------------------------------------ channelizer
@pytest.mark.parametrize("method", ["fft", "direct"])
def test_channelizer_matches_jax(method):
    fs = 8_192_000
    x = _unit_noise(fs // 10, 9)
    offs = [-3_072_000, 1_712_000, 0]
    if method == "direct":
        offs[0] += 1000                        # off the fft method's grid
    ref = jfir.Channelizer(fs, offs, method=method)(x)
    ch = tfir.Channelizer(fs, offs, method=method, device="cpu")
    assert ch.method == method and ch.num_taps == 233
    got = ch(x).cpu().numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # across streaming calls, in the JAX test's uneven chunks
    jc = jfir.Channelizer(fs, offs, method=method)
    tc = tfir.Channelizer(fs, offs, method=method, device="cpu")
    for a, b in ((0, 100_000), (100_000, 100_128), (100_128, 500_000),
                 (500_000, x.size)):
        want, got = jc(x[a:b]), tc(x[a:b]).cpu().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert (tc._consumed, tc._tail.size) == (jc._consumed,
                                                 jc._tail.size)


def test_channelizer_method_rules_match_jax():
    assert tfir.Channelizer(8_192_000, [0], device="cpu").method == "fft"
    assert tfir.Channelizer(8_192_000, [1_712_000 + 1000],
                            device="cpu").method == "direct"
    for kwargs in ({"method": "FFT"},
                   {"method": "fft", "offsets_hz": [1000]},
                   {"method": "fft", "num_taps": 4095},
                   {"offsets_hz": [5_000_000]},
                   {"fs_in": 3_000_000}):
        args = {"fs_in": 8_192_000, "offsets_hz": [0], **kwargs}
        with pytest.raises(ValueError):
            jfir.Channelizer(**args)
        with pytest.raises(ValueError):
            tfir.Channelizer(**args, device="cpu")
    np.testing.assert_array_equal(tfir.design_lowpass(383, 0.05),
                                  jfir.design_lowpass(383, 0.05))


def test_bandiii_matches_jax():
    assert tband.BAND_III == jband.BAND_III
    for center, fs in ((184.5e6, 8.192e6), (178_352_000, 8.192e6),
                       (200e6, 16.384e6), (230e6, 2.048e6)):
        assert tband.blocks_within(center, fs) == jband.blocks_within(
            center, fs)
    assert [n for n, _ in tband.blocks_within(184.5e6, 8.192e6)] == [
        "6A", "6B", "6C", "6D"]

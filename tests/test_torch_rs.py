"""Parity of the PyTorch port's batched RS decoder, DAB+ superframe path
and mixed mux with the JAX package (CPU).

* RS: ``tests/test_rs_device.py``'s four cases, each through the port's
  ``make_rs_decoder``, the JAX ``ops.rs`` decoder and the NumPy codec
  (``utils.gf256.rs_decode``): data and counts must be identical.
* DAB+: the same access units through both packages' ``SuperframeBuilder``
  and ``SuperframeDecoder`` (``tests/test_dabplus.py``'s cases): builder
  bytes, decoded AUs and decoder stats must be identical.
* The mixed mux (6 x EEP, UEP, DAB+) through both ``DabReceiver``s: ETI
  bytes identical but for the UEP entry's STC TPL (the port writes
  ``0x10 | (level - 1)``, the JAX package the Table 31 index) and the
  header CRC over it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.eti import dabplus as jdp
from dabtools_tpu.fic import config as jconfig
from dabtools_tpu.models.receiver import DabReceiver as JDabReceiver
from dabtools_tpu.ops.rs import make_rs_decoder as jmake_rs_decoder
from dabtools_tpu.utils.gf256 import rs_decode, rs_encode, rs_parity
from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.eti import dabplus as tdp
from dabtools_tpu_torch.eti.parse import EtiParser
from dabtools_tpu_torch.models.receiver import DabReceiver
from dabtools_tpu_torch.ops.rs import make_rs_decoder, rs_decode_batch
from tests.test_torch_host_copies import as_port_tpl

torch.set_num_threads(2)


# -------------------------------------------------------------------- RS
def _batch_120(rng, errs):
    """``tests/test_rs_device.py``'s RS(120,110) batch."""
    data = rng.integers(0, 256, size=(len(errs), C.RS_K), dtype=np.uint8)
    bad = rs_encode(data).copy()
    for row, k in enumerate(errs):
        pos = rng.choice(C.RS_N, size=k, replace=False)
        for p in pos:
            bad[row, p] ^= rng.integers(1, 256)
    return data, bad


def _batch_204(rng, errs):
    """``tests/test_rs_device.py``'s RS(204,188) batch."""
    n, k = 204, 188
    data = rng.integers(0, 256, size=(len(errs), k), dtype=np.uint8)
    cw = np.concatenate([data, rs_parity(data, n - k)], axis=1)
    bad = cw.copy()
    for row, e in enumerate(errs):
        pos = rng.choice(n, size=e, replace=False)
        for p in pos:
            bad[row, p] ^= rng.integers(1, 256)
    return data, bad


def _case(name):
    """(n, k, errs, data, bad codewords, the counts the JAX test wants),
    from the JAX test's seed."""
    if name == "error_counts":
        errs = [0, 1, 2, 3, 4, 5, 5, 0]
        return (120, 110, errs, *_batch_120(np.random.default_rng(0), errs),
                errs)
    if name == "uncorrectable":
        errs = [7, 8, 6, 2]
        return (120, 110, errs, *_batch_120(np.random.default_rng(1), errs),
                [-1, -1, -1, 2])
    if name == "large_batch":
        rng = np.random.default_rng(2)
        errs = list(rng.integers(0, 6, size=256))
        return (120, 110, errs, *_batch_120(rng, errs), errs)
    errs = [0, 1, 4, 8, 8, 0, 9, 12]
    return (204, 188, errs, *_batch_204(np.random.default_rng(3), errs),
            [e if e <= 8 else -1 for e in errs])


@pytest.mark.parametrize("name", ["error_counts", "uncorrectable",
                                  "large_batch", "rs_204_188"])
def test_rs_matches_jax_and_numpy(name):
    n, k, errs, data, bad, want_n = _case(name)
    got_d, got_n = make_rs_decoder(n, k)(torch.from_numpy(bad))
    assert got_d.dtype == torch.uint8 and got_n.dtype == torch.int32
    assert got_d.shape == (len(errs), k) and got_n.shape == (len(errs),)
    got_d, got_n = got_d.numpy(), got_n.numpy()
    jax_d, jax_n = jmake_rs_decoder(n, k)(jnp.asarray(bad))
    ref_d, ref_n = rs_decode(bad, n_parity=n - k)
    np.testing.assert_array_equal(got_d, np.asarray(jax_d))
    np.testing.assert_array_equal(got_n, np.asarray(jax_n))
    np.testing.assert_array_equal(got_d, ref_d)
    np.testing.assert_array_equal(got_n, ref_n)
    assert got_n.tolist() == want_n
    ok = np.array(want_n) >= 0
    np.testing.assert_array_equal(got_d[ok], data[ok])
    # an uncorrectable row's data passes through
    np.testing.assert_array_equal(got_d[~ok], bad[~ok, :k])


def test_rs_decode_batch_is_the_dab_plus_code():
    _, _, _, _, bad, _ = _case("error_counts")
    got = rs_decode_batch(torch.from_numpy(bad))
    want = make_rs_decoder(120, 110)(torch.from_numpy(bad))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("bad", [
    np.zeros((4, 120), np.int32),        # not uint8
    np.zeros((4, 119), np.uint8),        # wrong n
    np.zeros(120, np.uint8),             # not a batch
])
def test_rs_rejects_malformed_codewords(bad):
    with pytest.raises(ValueError, match="uint8 codewords"):
        rs_decode_batch(torch.from_numpy(bad))


# ------------------------------------------------------------------ DAB+
def _aus(builder, rng):
    return [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in builder.au_sizes()]


def _feed_both(bitrate, frames):
    """Feed the same logical frames to both decoders; returns the port's
    decoder, and each package's AUs as comparable tuples."""
    jdec, tdec = jdp.SuperframeDecoder(bitrate), tdp.SuperframeDecoder(bitrate)
    jgot, tgot = [], []
    for f in frames:
        jgot += jdec.feed(bytes(f))
        tgot += tdec.feed(bytes(f))

    def rec(a):
        return (a.data, a.crc_ok, a.superframe_index, a.au_index)

    assert tdec.stats == jdec.stats
    return tdec, [rec(a) for a in jgot], [rec(a) for a in tgot]


@pytest.mark.parametrize("dac_rate,sbr", [(1, 1), (0, 0), (1, 0), (0, 1)])
def test_superframe_builder_and_decoder_match_jax(dac_rate, sbr):
    rng = np.random.default_rng(2)
    jb = jdp.SuperframeBuilder(64, jdp.SuperframeConfig(dac_rate=dac_rate,
                                                        sbr_flag=sbr))
    tb = tdp.SuperframeBuilder(64, tdp.SuperframeConfig(dac_rate=dac_rate,
                                                        sbr_flag=sbr))
    assert tb.au_sizes() == jb.au_sizes()
    aus = _aus(tb, rng)
    frames = tb.build(aus)
    np.testing.assert_array_equal(frames, jb.build(aus))
    tdec, jgot, tgot = _feed_both(64, frames)
    assert tgot == jgot
    assert [a[0] for a in tgot] == aus and all(a[1] for a in tgot)
    jcfg = jdp.SuperframeConfig(dac_rate=dac_rate, sbr_flag=sbr)
    assert dataclasses.asdict(tdec.config) == dataclasses.asdict(jcfg)
    assert tdp.adts_wrap(aus[0], tdec.config) == jdp.adts_wrap(aus[0], jcfg)


def test_superframe_phase_sync_matches_jax():
    """A start 2 frames into superframe 0: superframes 1-3 decode."""
    rng = np.random.default_rng(3)
    b = tdp.SuperframeBuilder(64)
    all_aus, frames = [], []
    for _ in range(4):
        aus = _aus(b, rng)
        all_aus.append(aus)
        frames.extend(b.build(aus))
    _, jgot, tgot = _feed_both(64, frames[2:])
    assert tgot == jgot
    assert len(tgot) == 3 * b.cfg.num_aus
    assert [a[0] for a in tgot[:b.cfg.num_aus]] == list(all_aus[1])


def test_superframe_rs_corrections_match_jax():
    """5 byte errors (t) in each of 6 RS columns: RS corrects them."""
    rng = np.random.default_rng(4)
    b = tdp.SuperframeBuilder(96)
    aus = _aus(b, rng)
    frames = b.build(aus).reshape(-1).copy()
    for col in range(6):
        for row in rng.choice(C.RS_N, size=5, replace=False):
            frames[row * b.n_cols + col] ^= rng.integers(1, 256)
    tdec, jgot, tgot = _feed_both(96, frames.reshape(5, -1))
    assert tgot == jgot
    assert [a[0] for a in tgot] == aus and all(a[1] for a in tgot)
    assert tdec.stats["rs_corrected"] == 30


def test_superframe_loses_and_regains_sync_like_jax():
    """Superframe 2 of 5 corrupted beyond RS (its header bytes and 6 more
    errors in every column): its firecode fails, sync is lost, and the
    decoder finds the phase again at superframe 3."""
    rng = np.random.default_rng(5)
    b = tdp.SuperframeBuilder(64)
    all_aus, frames = [], []
    for _ in range(5):
        aus = _aus(b, rng)
        all_aus.append(aus)
        frames.append(b.build(aus).reshape(-1).copy())
    bad = frames[2]
    bad[:11] ^= 0xA5                       # the header's bytes
    for col in range(b.n_cols):
        for row in rng.choice(np.arange(2, C.RS_N), size=6, replace=False):
            bad[row * b.n_cols + col] ^= rng.integers(1, 256)
    stream = np.concatenate(frames).reshape(-1, b.frame_bytes)
    tdec, jgot, tgot = _feed_both(64, stream)
    assert tgot == jgot
    assert tdec.stats["firecode_failures"] == 1
    assert tdec.stats["rs_failures"] == b.n_cols
    assert [a[0] for a in tgot] == [
        au for k in (0, 1, 3, 4) for au in all_aus[k]]
    assert [a[2] for a in tgot] == [k for k in (0, 1, 3, 4)
                                    for _ in range(b.cfg.num_aus)]


# ------------------------------------------------------------- mixed mux
def test_mixed_mux_eti_matches_jax():
    """The mixed mux (6 x EEP 3-A, UEP idx 16, DAB+ 72 kbit/s of real
    superframes), 12 frames in 8-frame blocks: identical ETI bytes from
    both receivers but for the UEP entry's TPL and the header CRC, every
    payload the modulator's, the DAB+ sub-channel back to its access
    units."""
    mix = S.mixed_ensemble()
    rng = np.random.default_rng(1)
    rows, aus = S.dabplus_superframes(12 * 4, rng)
    x, payload = S.modulate(mix, 12, rng, rows={S.MIXED_DABPLUS: rows})
    eti = DabReceiver(n_frames=8, ensemble=mix, device="cpu").feed(x)
    jeti = JDabReceiver(n_frames=8, ensemble=jconfig.Ensemble.from_dict(
        mix.to_dict())).feed(x)
    assert len(eti) == 17
    # the UEP sub-channel 6 is the seventh STC entry (TPL byte 34)
    assert {f[34] >> 2 for f in eti} == {0x12}     # UEP level 3
    assert {f[34] >> 2 for f in jeti} == {16}      # Table 31 index 16
    assert eti == [as_port_tpl(f, {6: 3}) for f in jeti]
    assert S.check_eti_payloads(eti, payload, 0) == 17
    frames = list(EtiParser().feed(b"".join(eti)))
    assert S.check_dabplus([f.subchannel_data(S.MIXED_DABPLUS)
                            for f in frames], aus) >= 6

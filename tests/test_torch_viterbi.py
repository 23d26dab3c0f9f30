"""Parity of the PyTorch port's Viterbi (radix-4 and radix-2) with the JAX
package.

On the CPU the port runs the plain PyTorch versions of its kernels
(``acs4_plain``, ``traceback4_plain``, ``acs2_plain``,
``traceback2_plain``); they are held against JAX's ``viterbi_decode``
(the XLA scan), ``viterbi_decode_ragged`` and the radix-4 and radix-2
Pallas kernels in interpret mode, on the same NumPy inputs.
Contract: decoded bits exact, path metric within ``rtol=1e-5`` (the
branch-metric sums are taken in another order than XLA's dot).

The hand-written CUDA kernels are held against the plain versions in
``tests/test_torch_kernels.py`` (marked ``gpu``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu.mod.convcode import conv_encode
from dabtools_tpu.ops import fec as jfec
from dabtools_tpu.ops import viterbi as jv
from dabtools_tpu.ops.uep_probe import candidate_metrics as jcandidates
from dabtools_tpu.ops.viterbi_pallas import viterbi_decode_pallas
from dabtools_tpu.ops.viterbi_pallas4 import viterbi_decode_pallas4
from dabtools_tpu.tables.puncturing import (
    FIC_PROFILE,
    eep_profile,
    enumerate_uep_candidates,
)
from dabtools_tpu_torch.ops import fec
from dabtools_tpu_torch.ops import viterbi as V
from dabtools_tpu_torch.ops.uep_probe import candidate_metrics

torch.set_num_threads(2)


def _noisy_batch(rng, batch, n, scale=0.6):
    msgs = rng.integers(0, 2, size=(batch, n), dtype=np.uint8)
    soft = np.stack([1.0 - 2.0 * conv_encode(m) for m in msgs])
    soft = soft.astype(np.float32)
    soft += rng.normal(scale=scale, size=soft.shape).astype(np.float32)
    return msgs, soft


def _punctured(rng, profile, batch, scale):
    msgs = rng.integers(0, 2, size=(batch, profile.data_bits),
                        dtype=np.uint8)
    mask = profile.mask().astype(bool)
    tx = np.stack([(1.0 - 2.0 * conv_encode(m))[mask] for m in msgs])
    tx = (tx + rng.normal(scale=scale, size=tx.shape)).astype(np.float32)
    return msgs, tx


def test_tables_match_jax():
    pu4, ws4 = V.acs_radix4_matrices()
    jpu4, jws4 = jv.acs_radix4_matrices()
    np.testing.assert_array_equal(pu4, jpu4)
    np.testing.assert_array_equal(ws4, jws4)
    np.testing.assert_array_equal(V.transition_matrix(),
                                  jv.transition_matrix())
    pu, ws = V.acs_matmul_matrices()
    jpu, jws = jv.acs_matmul_matrices()
    np.testing.assert_array_equal(pu, jpu)
    np.testing.assert_array_equal(ws, jws)
    # K3's sign rows t and 64 + t are transition_matrix rows 4c + 2b + u
    t = np.arange(64)
    w = V.transition_matrix()
    np.testing.assert_array_equal(ws[:64], w[4 * (t & 31) + (t >> 5)])
    np.testing.assert_array_equal(ws[64:], w[4 * (t & 31) + 2 + (t >> 5)])
    assert V.NEG_INF == jv.NEG_INF


@pytest.mark.parametrize("batch,n", [(3, 768), (2, 3072)])
def test_plain_matches_jax(batch, n):
    rng = np.random.default_rng(batch * 77 + n)
    msgs, soft = _noisy_batch(rng, batch, n)
    rb, rm = jv.viterbi_decode(jnp.asarray(soft))
    bits, metric = V.viterbi_decode(torch.from_numpy(soft))
    assert bits.dtype == torch.uint8
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    np.testing.assert_allclose(metric.numpy(), np.asarray(rm), rtol=1e-5)
    np.testing.assert_array_equal(bits.numpy(), msgs)


def test_fic_punctured_codewords():
    """Depunctured erasures are exactly 0, so ACS ties are common: the
    strict-'>' select must resolve them as JAX does."""
    rng = np.random.default_rng(2)
    msgs, tx = _punctured(rng, FIC_PROFILE, 4, 0.4)
    jsoft = jfec.depuncture(jnp.asarray(tx), FIC_PROFILE)
    soft = fec.depuncture(torch.from_numpy(tx), FIC_PROFILE)
    rb, rm = jv.viterbi_decode(jsoft)
    bits, metric = V.viterbi_decode(soft)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    np.testing.assert_allclose(metric.numpy(), np.asarray(rm), rtol=1e-5)
    np.testing.assert_array_equal(bits.numpy(), msgs)


def test_noise_free_ties_match_jax():
    """Exact-valued soft bits (many exact ties between candidates)."""
    rng = np.random.default_rng(9)
    msgs, tx = _punctured(rng, eep_profile(1, "A", 32), 3, 0.0)
    tx = np.round(tx * 2 + rng.integers(-1, 2, size=tx.shape)) / 2
    tx = tx.astype(np.float32)
    prof = eep_profile(1, "A", 32)
    rb, rm = jv.viterbi_decode(jfec.depuncture(jnp.asarray(tx), prof))
    bits, metric = V.viterbi_decode(fec.depuncture(torch.from_numpy(tx),
                                                   prof))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    np.testing.assert_allclose(metric.numpy(), np.asarray(rm), rtol=1e-5)


def test_one_dimensional_squeezes():
    rng = np.random.default_rng(4)
    msgs, soft = _noisy_batch(rng, 1, 250)
    bits, metric = V.viterbi_decode(torch.from_numpy(soft[0]))
    assert bits.shape == (250,) and metric.shape == ()
    np.testing.assert_array_equal(bits.numpy(), msgs[0])


def test_ragged_matches_jax_and_pallas4():
    """8 x 774 FIC + 4 x 3078 MSC in one lane batch vs JAX's ragged
    decode (per-batch XLA scans on the CPU) and vs the radix-4 Pallas
    kernel in interpret mode with the same per-lane lengths."""
    rng = np.random.default_rng(11)
    fic_msgs, fic_tx = _punctured(rng, FIC_PROFILE, 8, 0.4)
    prof = eep_profile(3, "A", 128)
    msc_msgs, msc_tx = _punctured(rng, prof, 4, 0.3)
    jobs_np = [np.array(jfec.depuncture(jnp.asarray(fic_tx), FIC_PROFILE)),
               np.array(jfec.depuncture(jnp.asarray(msc_tx), prof))]
    assert [j.shape[1] // 4 for j in jobs_np] == [774, 3078]

    outs = V.viterbi_decode_ragged([torch.from_numpy(j) for j in jobs_np])
    refs = jv.viterbi_decode_ragged([jnp.asarray(j) for j in jobs_np],
                                    impl="xla")
    for (bits, metric), (rb, rm), m in zip(outs, refs,
                                           (fic_msgs, msc_msgs)):
        np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
        np.testing.assert_allclose(metric.numpy(), np.asarray(rm),
                                   rtol=1e-5)
        np.testing.assert_array_equal(bits.numpy(), m)

    soft, lengths = V.ragged_lanes([torch.from_numpy(j) for j in jobs_np])
    pb, pm = viterbi_decode_pallas4(jnp.asarray(soft.numpy()),
                                    interpret=True, lengths=lengths)
    bits, metric = V.viterbi_decode4(soft, lengths)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(pb))
    np.testing.assert_allclose(metric.numpy(), np.asarray(pm), rtol=1e-5)


@pytest.mark.parametrize("lengths", [[10, 7], [10, 0], [10, 12], [10]],
                         ids=["odd", "zero", "too-long", "wrong-shape"])
def test_bad_lengths_rejected(lengths):
    soft = np.zeros((2, 4 * 10), np.float32)
    with pytest.raises(ValueError):
        viterbi_decode_pallas4(jnp.asarray(soft), interpret=True,
                               lengths=np.array(lengths))
    with pytest.raises(ValueError):
        V.viterbi_decode4(torch.from_numpy(soft), np.array(lengths))


@pytest.mark.parametrize("n", [3, 769, 1001])
def test_odd_length_matches_jax(n):
    """Odd trellis lengths decode radix-2 (``acs2_plain`` /
    ``traceback2_plain`` on the CPU) as JAX's XLA scan does."""
    rng = np.random.default_rng(n)
    msgs, soft = _noisy_batch(rng, 3, n)
    assert (n + 6) % 2
    rb, rm = jv.viterbi_decode(jnp.asarray(soft), impl="xla")
    bits, metric = V.viterbi_decode(torch.from_numpy(soft))
    assert bits.dtype == torch.uint8 and bits.shape == (3, n)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    np.testing.assert_allclose(metric.numpy(), np.asarray(rm), rtol=1e-5)
    np.testing.assert_array_equal(bits.numpy(), msgs)


def test_odd_length_matches_pallas():
    """The radix-2 Pallas kernel (K3/K4) in interpret mode."""
    rng = np.random.default_rng(57)
    _, soft = _noisy_batch(rng, 3, 57)
    pb, pm = viterbi_decode_pallas(jnp.asarray(soft), interpret=True)
    bits, metric = V.viterbi_decode(torch.from_numpy(soft))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(pb))
    np.testing.assert_allclose(metric.numpy(), np.asarray(pm), rtol=1e-5)
    with pytest.raises(ValueError):
        V.viterbi_decode4(torch.from_numpy(soft))   # radix-4 needs even T


def test_odd_length_ties_match_jax():
    """Erasure-heavy, exact-valued soft bits: half the positions are 0 and
    the rest small integers, so every sum is exact and ACS ties are
    common; the strict-'>' select must resolve them as JAX does."""
    rng = np.random.default_rng(21)
    msgs = rng.integers(0, 2, size=(4, 301), dtype=np.uint8)
    soft = np.stack([1.0 - 2.0 * conv_encode(m) for m in msgs])
    soft = soft * rng.integers(1, 3, size=soft.shape)
    soft[rng.random(soft.shape) < 0.5] = 0.0
    soft = soft.astype(np.float32)
    rb, rm = jv.viterbi_decode(jnp.asarray(soft), impl="xla")
    bits, metric = V.viterbi_decode(torch.from_numpy(soft))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
    np.testing.assert_allclose(metric.numpy(), np.asarray(rm), rtol=1e-5)


def test_ragged_with_odd_length_matches_jax():
    """A mix that holds an odd T decodes batch by batch, as JAX's does."""
    rng = np.random.default_rng(14)
    fic_msgs, fic_tx = _punctured(rng, FIC_PROFILE, 3, 0.4)
    fic = np.array(jfec.depuncture(jnp.asarray(fic_tx), FIC_PROFILE))
    odd_msgs, odd = _noisy_batch(rng, 2, 101)
    even_msgs, even = _noisy_batch(rng, 2, 300)
    jobs = [fic, odd, even]
    outs = V.viterbi_decode_ragged([torch.from_numpy(j) for j in jobs])
    refs = jv.viterbi_decode_ragged([jnp.asarray(j) for j in jobs],
                                    impl="xla")
    for (bits, metric), (rb, rm), m in zip(outs, refs,
                                           (fic_msgs, odd_msgs, even_msgs)):
        np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))
        np.testing.assert_allclose(metric.numpy(), np.asarray(rm),
                                   rtol=1e-5)
        np.testing.assert_array_equal(bits.numpy(), m)


def test_onehot64_traceback_matches_default():
    """``traceback="onehot64"`` gives the default traceback's bits, and
    the bits of JAX's one-hot64 Pallas traceback in interpret mode."""
    rng = np.random.default_rng(15)
    _, s1 = _noisy_batch(rng, 2, 40)
    _, s2 = _noisy_batch(rng, 2, 90)
    soft, lengths = V.ragged_lanes([torch.from_numpy(s1),
                                    torch.from_numpy(s2)])
    bits, metric = V.viterbi_decode4(soft, lengths)
    bits_oh, metric_oh = V.viterbi_decode4(soft, lengths,
                                           traceback="onehot64")
    np.testing.assert_array_equal(bits_oh.numpy(), bits.numpy())
    np.testing.assert_array_equal(metric_oh.numpy(), metric.numpy())
    pb, _ = viterbi_decode_pallas4(jnp.asarray(soft.numpy()),
                                   interpret=True, lengths=lengths,
                                   traceback="onehot64")
    np.testing.assert_array_equal(bits_oh.numpy(), np.asarray(pb))
    with pytest.raises(ValueError):
        V.viterbi_decode4(soft, lengths, traceback="onehot16")


def test_short_lane_padding_is_inert():
    """A short lane padded to a long one decodes as it does alone, and
    its dead steps record decision 0 (traceback's fixed point)."""
    rng = np.random.default_rng(12)
    m1, s1 = _noisy_batch(rng, 1, 100)
    m2, s2 = _noisy_batch(rng, 1, 300)
    soft, lengths = V.ragged_lanes([torch.from_numpy(s1),
                                    torch.from_numpy(s2)])
    b, n4 = soft.shape
    t2 = torch.from_numpy((lengths // 2).astype(np.int32))
    dec, metric = V.acs4_plain(soft.reshape(b, n4 // 8, 8), t2,
                               V._ws4(soft.device))
    assert (dec[0, 53:] == 0).all()
    alone, alone_metric = V.viterbi_decode(torch.from_numpy(s1))
    bits = V.traceback4_plain(dec)
    np.testing.assert_array_equal(bits[0, :100].numpy(), alone[0].numpy())
    assert metric[0] == alone_metric[0]
    np.testing.assert_array_equal(bits[1, :300].numpy(), m2[0])


def test_uep_candidate_metrics_match_jax():
    """The autoprobe's batched candidate decode (ops/uep_probe.py)."""
    cands = enumerate_uep_candidates(192, 2)[:3]
    prof = cands[0]
    rng = np.random.default_rng(13)
    _, tx = _punctured(rng, prof, 2, 0.3)
    ref = jcandidates(tx, cands)
    got = candidate_metrics(tx, cands, "cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert int(np.argmax(got.mean(axis=1))) == 0

"""Parity of the PyTorch port's Viterbi (radix-4 and radix-2) with the JAX
package.

On the CPU the port runs the plain PyTorch versions of its kernels
(``acs4_plain``, ``traceback4_plain``, ``traceback4_onehot64_plain``,
``acs2_plain``, ``traceback2_plain``); they are held against JAX's
``viterbi_decode``
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
from dabtools_tpu_torch.ops.viterbi_cuda import CHUNK
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


@pytest.mark.parametrize("n1,n2", [(40, 90), (2 * CHUNK - 6, 4 * CHUNK - 6)])
def test_onehot64_traceback_matches_default(n1, n2):
    """``traceback="onehot64"`` (``traceback4_onehot64_plain`` on the CPU)
    gives the default traceback's bits and the bits of JAX's one-hot64
    Pallas traceback in interpret mode, on ragged lanes right-padded with
    zeros as ``tests/test_viterbi_pallas.py``'s onehot64 case builds them
    (the second case: lanes of 1 and 2 chunks of double steps)."""
    rng = np.random.default_rng(15 + n1)
    m1, s1 = _noisy_batch(rng, 2, n1)
    m2, s2 = _noisy_batch(rng, 2, n2)
    soft = np.zeros((4, s2.shape[-1]), np.float32)
    soft[:2, : s1.shape[-1]] = s1
    soft[2:] = s2
    lengths = np.array([n1 + 6, n1 + 6, n2 + 6, n2 + 6])
    bits, metric = V.viterbi_decode4(torch.from_numpy(soft), lengths)
    bits_oh, metric_oh = V.viterbi_decode4(torch.from_numpy(soft), lengths,
                                           traceback="onehot64")
    np.testing.assert_array_equal(bits_oh.numpy(), bits.numpy())
    np.testing.assert_array_equal(metric_oh.numpy(), metric.numpy())
    np.testing.assert_array_equal(bits_oh[:2, :n1].numpy(), m1)
    np.testing.assert_array_equal(bits_oh[2:].numpy(), m2)
    pb, pm = viterbi_decode_pallas4(jnp.asarray(soft), interpret=True,
                                    lengths=lengths, traceback="onehot64")
    np.testing.assert_array_equal(bits_oh.numpy(), np.asarray(pb))
    np.testing.assert_allclose(metric_oh.numpy(), np.asarray(pm), rtol=1e-5)
    with pytest.raises(ValueError):
        V.viterbi_decode4(torch.from_numpy(soft), lengths,
                          traceback="onehot16")


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


# K1/K2's warp schedule (csrc/viterbi4.cu), emulated with torch on the CPU:
# axis 1 of a (lanes, 32) tensor is the warp's 32 threads, a shuffle is a
# gather along it and a ballot packs it into a word.
_THREADS = torch.arange(32)


def _pattern(w):
    """(32, 4) +/-1 signs -> (32,) sign pattern 8 n0 + 4 n1 + 2 n2 + n3."""
    neg = (w < 0).to(torch.int64)
    return 8 * neg[:, 0] + 4 * neg[:, 1] + 2 * neg[:, 2] + neg[:, 3]


def _warp_signs(ws4):
    """Thread j's own signs (pattern j & 15) and the threads whose
    patterns are its sign rows A, B, C: the first step of (p=0, t=j) and
    (p=2, t=j), the second step of (p=0, t=j)."""
    j = _THREADS
    wq = 1.0 - 2.0 * ((j[:, None] >> torch.arange(3, -1, -1)) & 1).float()
    return (wq, _pattern(ws4[j, :4]), _pattern(ws4[128 + j, :4]),
            16 + _pattern(ws4[j, 4:]))


def _warp_branch_metrics(s, wq, la, lb, lc):
    """(lanes, 8) soft bits of one double step -> bm of target j and of
    target 32 + j, each (4 predecessors, lanes, 32), as the kernel forms
    them: thread j sums its pattern over trellis step j >> 4's 4 soft
    bits, left to right; A, B, C are gathered from threads la, lb, lc."""
    half = torch.where((_THREADS >> 4)[None, :, None] == 0,
                       s[:, None, :4], s[:, None, 4:])     # (lanes, 32, 4)
    sq = wq[None, :, 0] * half[..., 0]
    for k in range(1, 4):
        sq = sq + wq[None, :, k] * half[..., k]
    a, b, c = sq[:, la], sq[:, lb], sq[:, lc]
    return (torch.stack([a + c, -a + c, b + -c, -b + -c]),
            torch.stack([a + -c, -a + -c, b + c, -b + c]))


def _ballot(bits):
    """(lanes, 32) bool -> (lanes,) int64 word, thread j at bit j."""
    return (bits.to(torch.int64) << _THREADS).sum(-1)


def _select4(pred, bm):
    c0, c1, c2, c3 = (pred + bm).unbind(0)
    d01, d23 = c1 > c0, c3 > c2
    m01, m23 = torch.where(d01, c1, c0), torch.where(d23, c3, c2)
    hi = m23 > m01
    return torch.where(hi, m23, m01), torch.where(hi, d23, d01), hi


def _warp_acs4(soft8, t2, ws4):
    """K1's schedule: soft bits staged a chunk at a time (thread i holds
    step base + i), path metrics of states j / 32 + j in pm0 / pm1,
    predecessor 4a + p read from thread 4(a & 7) + p, register a >> 3."""
    b, t2_max, _ = soft8.shape
    signs = _warp_signs(ws4)
    a = _THREADS & 15
    src, upper = 4 * (a & 7), a >= 8
    length = t2.to(torch.int64).clamp(0, t2_max)
    pm0 = torch.full((b, 32), V.NEG_INF, dtype=torch.float32)
    pm0[:, 0] = 0.0
    pm1 = torch.full((b, 32), V.NEG_INF, dtype=torch.float32)
    dec = torch.full((b, t2_max, 4), -7, dtype=torch.int64)
    # Shared memory keeps what the last chunk left: start it as garbage.
    staged = torch.full((b, CHUNK, 8), float("nan"))
    dec_s = torch.full((b, CHUNK, 4), 0x5A5A5A5A, dtype=torch.int64)
    for base in range(0, t2_max, CHUNK):
        g = base + _THREADS
        staged = torch.where(g[None, :, None] < length[:, None, None],
                             soft8[:, g.clamp(max=t2_max - 1)], staged)
        n = (length - base).clamp(0, CHUNK)          # live steps, per lane
        for i in range(CHUNK):
            live = i < n
            bm0, bm1 = _warp_branch_metrics(staged[:, i], *signs)
            pred = torch.stack([torch.where(upper, pm1[:, src + p],
                                            pm0[:, src + p])
                                for p in range(4)])
            new0, lo0, lo1 = _select4(pred, bm0)
            new1, hi0, hi1 = _select4(pred, bm1)
            pm0 = torch.where(live[:, None], new0, pm0)
            pm1 = torch.where(live[:, None], new1, pm1)
            words = torch.stack([_ballot(x) for x in (lo0, lo1, hi0, hi1)],
                                dim=-1)
            dec_s[:, i] = torch.where(live[:, None], words, dec_s[:, i])
        # thread i stores step base + i: its staged word if live, else 0
        keep = g < t2_max
        out = torch.where(_THREADS[None, :, None] < n[:, None, None], dec_s,
                          0)
        dec[:, g[keep]] = out[:, keep]
    wrapped = torch.where(dec >= 2 ** 31, dec - 2 ** 32, dec)
    return wrapped.to(torch.int32), pm0[:, 0].clone()


def _warp_traceback4(dec):
    """K2's schedule: chunks walked from the top, thread i holds step base
    + i's words and keeps its two bits; one store per chunk."""
    b, t2_max, _ = dec.shape
    words = dec.to(torch.int64) & 0xFFFFFFFF
    out = torch.full((b, t2_max), -1, dtype=torch.int64)
    s = torch.zeros(b, dtype=torch.int64)
    top = (t2_max - 1) // CHUNK * CHUNK
    for base in range(top, -1, -CHUNK):
        g = base + _THREADS
        staged = words[:, g.clamp(max=t2_max - 1)] * (g < t2_max)[None, :,
                                                                   None]
        n = min(CHUNK, t2_max - base)
        own = torch.zeros((b, 32), dtype=torch.int64)
        for i in range(n - 1, -1, -1):
            w = staged[:, i]
            own[:, i] = ((s >> 4) & 1) | (((s >> 5) & 1) << 8)
            up = (s & 32) != 0
            lo = torch.where(up, w[:, 2], w[:, 0])
            hi = torch.where(up, w[:, 3], w[:, 1])
            bit = s & 31
            s = 4 * (s & 15) | ((lo >> bit) & 1) | (((hi >> bit) & 1) << 1)
        out[:, base:base + n] = own[:, :n]
    return torch.stack([out & 0xFF, out >> 8], -1).reshape(
        b, 2 * t2_max).to(torch.uint8)


def _warp_traceback4_onehot64(dec):
    """K2''s schedule: chunks walked from the top, thread i holds step base
    + i's words; the one-hot (lo, hi) is the same in every thread, as
    32-bit words, and moves by 32x32->64-bit squares; bit i of u1 / u2
    takes step i's bits, and after the chunk thread j stores bit j of
    each."""
    b, t2_max, _ = dec.shape
    words = dec.to(torch.int64) & 0xFFFFFFFF
    out = torch.full((b, t2_max), -1, dtype=torch.int64)
    lo = torch.ones(b, dtype=torch.int64)
    hi = torch.zeros(b, dtype=torch.int64)
    top = (t2_max - 1) // CHUNK * CHUNK
    for base in range(top, -1, -CHUNK):
        g = base + _THREADS
        staged = words[:, g.clamp(max=t2_max - 1)] * (g < t2_max)[None, :,
                                                                   None]
        n = min(CHUNK, t2_max - base)
        u1 = torch.zeros(b, dtype=torch.int64)
        u2 = torch.zeros(b, dtype=torch.int64)
        for i in range(n - 1, -1, -1):
            w = staged[:, i]
            sq = (lo | hi) * (lo | hi)
            sq_lo, sq_hi = sq & 0xFFFFFFFF, sq >> 32
            u1 += sq_hi.clamp(max=1) << i
            u2 += hi.clamp(max=1) << i
            d0 = ((lo & w[:, 0]) | (hi & w[:, 2])).clamp(max=1)
            d1 = ((lo & w[:, 1]) | (hi & w[:, 3])).clamp(max=1)
            d = d0 + (d1 << 1)
            x = sq_lo | sq_hi
            p = x * x
            lo = ((p & 0xFFFFFFFF) << d) & 0xFFFFFFFF
            hi = ((p >> 32) << d) & 0xFFFFFFFF
        own = (((u1[:, None] >> _THREADS) & 1)
               | (((u2[:, None] >> _THREADS) & 1) << 8))
        out[:, base:base + n] = own[:, :n]
    return torch.stack([out & 0xFF, out >> 8], -1).reshape(
        b, 2 * t2_max).to(torch.uint8)


@pytest.mark.parametrize("kind", ["random words", "ragged decisions"])
@pytest.mark.parametrize("t2_max", [1, CHUNK - 1, CHUNK, CHUNK + 1,
                                    2 * CHUNK, 2 * CHUNK + 1])
def test_onehot64_traceback_matches_plain(t2_max, kind):
    """``traceback4_onehot64_plain`` and K2''s warp schedule, emulated (the
    32-step staging, the walk from the top partial chunk down, thread j's
    two bits), against ``traceback4_plain`` at and around the chunk edges:
    on random decision words (every bit of every plane in play) and on
    ``acs4_plain``'s decisions of ragged lanes (lengths 0, 1, a chunk, the
    whole width, random; dead steps hold decision 0).  Bits must be
    equal."""
    rng = np.random.default_rng(2000 * t2_max + len(kind))
    lanes = 7
    if kind == "random words":
        dec = torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, size=(lanes, t2_max, 4)).astype(np.int32))
    else:
        soft = 1.0 - 2.0 * rng.integers(0, 2, size=(lanes, t2_max, 8))
        soft = soft + rng.normal(scale=0.8, size=soft.shape)
        soft[rng.random(soft.shape) < 1 / 3] = 0.0
        lengths = [0, 1, CHUNK, t2_max, t2_max,
                   int(rng.integers(0, t2_max + 1)), t2_max - 1]
        t2 = torch.tensor(np.minimum(lengths, t2_max), dtype=torch.int32)
        dec, _ = V.acs4_plain(torch.from_numpy(soft.astype(np.float32)), t2,
                              V._ws4(torch.device("cpu")))
    want = V.traceback4_plain(dec)
    torch.testing.assert_close(V.traceback4_onehot64_plain(dec), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(_warp_traceback4_onehot64(dec), want, rtol=0,
                               atol=0)


def test_warp_branch_metric_signs():
    """The kernel's three signed sums per thread, each gathered from the
    thread of its sign pattern, give every one of WS4's 256 branch metrics
    (the DAB polynomials tap their first and last register bits), equal to
    ``branch_metrics`` on erasure-heavy input."""
    _, ws4_np = V.acs_radix4_matrices()
    ws4 = torch.from_numpy(ws4_np)
    r = ws4.view(4, 2, 32, 8)                     # (p, t >> 5, j, k)
    torch.testing.assert_close(r[:, 1, :, :4], r[:, 0, :, :4])
    torch.testing.assert_close(r[:, 1, :, 4:], -r[:, 0, :, 4:])
    torch.testing.assert_close(r[1, 0, :, :4], -r[0, 0, :, :4])
    torch.testing.assert_close(r[3, 0, :, :4], -r[2, 0, :, :4])
    torch.testing.assert_close(r[1, 0, :, 4:], r[0, 0, :, 4:])
    torch.testing.assert_close(r[2, 0, :, 4:], -r[0, 0, :, 4:])
    torch.testing.assert_close(r[3, 0, :, 4:], -r[0, 0, :, 4:])
    rng = np.random.default_rng(31)
    soft = rng.integers(-2, 3, size=(40, 8)).astype(np.float32)
    soft[rng.random(soft.shape) < 0.4] = 0.0
    soft[:20] += rng.normal(size=(20, 8)).astype(np.float32)
    s = torch.from_numpy(soft)
    bm0, bm1 = _warp_branch_metrics(s, *_warp_signs(ws4))
    want = V.branch_metrics(s.T[None].contiguous(), ws4)[0]   # (256, lanes)
    got = torch.stack([bm0, bm1], 1).permute(0, 1, 3, 2).reshape(256, 40)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("t2_max,kind", [
    (CHUNK - 1, "noisy"), (CHUNK - 1, "ties"), (CHUNK, "ties"),
    (CHUNK + 1, "noisy"), (CHUNK + 1, "ties"), (2 * CHUNK + 3, "noisy"),
    (2 * CHUNK + 3, "ties"), (1, "ties")])
def test_warp_schedule_matches_plain(t2_max, kind):
    """K1's and K2's warp schedules, emulated, against ``acs4_plain`` and
    ``traceback4_plain``: lanes of length 0, 1, one chunk and the whole
    width, T2 off a chunk multiple, and erasures (exact zeros) for ties.
    Decisions, metrics and bits must be equal."""
    rng = np.random.default_rng(1000 * t2_max + len(kind))
    lanes = 7
    if kind == "noisy":
        soft = 1.0 - 2.0 * rng.integers(0, 2, size=(lanes, t2_max, 8))
        soft = soft + rng.normal(scale=0.8, size=soft.shape)
        soft[rng.random(soft.shape) < 1 / 3] = 0.0
    else:
        soft = rng.integers(-2, 3, size=(lanes, t2_max, 8)).astype(float)
        soft[rng.random(soft.shape) < 0.5] = 0.0
    soft8 = torch.from_numpy(soft.astype(np.float32))
    lengths = [0, 1, CHUNK, t2_max, t2_max,
               int(rng.integers(0, t2_max + 1)), t2_max - 1]
    t2 = torch.tensor(np.minimum(lengths, t2_max), dtype=torch.int32)
    ws4 = V._ws4(torch.device("cpu"))
    dec, metric = _warp_acs4(soft8, t2, ws4)
    dec_p, metric_p = V.acs4_plain(soft8, t2, ws4)
    torch.testing.assert_close(dec, dec_p, rtol=0, atol=0)
    torch.testing.assert_close(metric, metric_p, rtol=0, atol=0)
    torch.testing.assert_close(_warp_traceback4(dec_p),
                               V.traceback4_plain(dec_p), rtol=0, atol=0)


# K3/K4's warp schedule (csrc/viterbi2.cu), emulated the same way.  Thread
# j holds x and y: states j and 32 + j, swapped if j is odd.
_EVEN_BITS = 0x55555555


def _warp_signs2(ws2):
    """Thread j's signs: row j of WS, negated iff (j >> 4) ^ (j & 1)."""
    flip = ((_THREADS >> 4) ^ (_THREADS & 1)).bool()
    return torch.where(flip[:, None], -ws2[_THREADS], ws2[_THREADS])


def _warp_sums2(s, w):
    """(lanes, 4) soft bits of one step -> (lanes, 32): thread j's signed
    sum with its signs ``w[j]``, left to right."""
    acc = w[None, :, 0] * s[:, None, 0]
    for k in range(1, 4):
        acc = acc + w[None, :, k] * s[:, None, k]
    return acc


def _warp_acs2(soft4, ws2):
    """K3's schedule: soft bits staged a chunk at a time (thread i holds
    step base + i); a step reads x from thread 2(j & 15) + (j >> 4) and y
    from thread 2(j & 15) + 1 - (j >> 4), forms x' = max(r1 + B, r2 - B)
    and y' = max(r1 - B, r2 + B), and ballots whether each differs from
    its even predecessor's candidate; thread i interleaves step base + i's
    two ballots into its decision words when it stores them."""
    b, t_max, _ = soft4.shape
    w = _warp_signs2(ws2)
    hi = (_THREADS >> 4).bool()
    src1 = 2 * (_THREADS & 15) + (_THREADS >> 4)
    src2 = 2 * (_THREADS & 15) + 1 - (_THREADS >> 4)
    x = torch.full((b, 32), V.NEG_INF, dtype=torch.float32)
    x[:, 0] = 0.0
    y = torch.full((b, 32), V.NEG_INF, dtype=torch.float32)
    dec = torch.full((b, t_max, 2), -7, dtype=torch.int64)
    # Shared memory keeps what the last chunk left: start it as garbage.
    staged = torch.full((b, CHUNK, 4), float("nan"))
    dec_s = torch.full((b, CHUNK, 2), 0x5A5A5A5A, dtype=torch.int64)
    for base in range(0, t_max, CHUNK):
        g = base + _THREADS
        staged = torch.where((g < t_max)[None, :, None],
                             soft4[:, g.clamp(max=t_max - 1)], staged)
        sums = [_warp_sums2(staged[:, i], w)
                for i in range(min(CHUNK, t_max - base))]
        for i, bq in enumerate(sums):
            r1, r2 = x[:, src1], y[:, src2]
            x0, x1, y0, y1 = r1 + bq, r2 - bq, r1 - bq, r2 + bq
            x, y = torch.maximum(x0, x1), torch.maximum(y0, y1)
            # the survivor is not the even predecessor's candidate
            dx = x != torch.where(hi, x1, x0)
            dy = y != torch.where(hi, y1, y0)
            dec_s[:, i] = torch.stack([_ballot(dx), _ballot(dy)], -1)
        keep = g < t_max                  # thread i stores step base + i
        wx, wy = dec_s[:, keep, 0], dec_s[:, keep, 1]
        dec[:, g[keep]] = torch.stack(
            [(wx & _EVEN_BITS) | (wy & ~_EVEN_BITS),
             (wy & _EVEN_BITS) | (wx & ~_EVEN_BITS)], -1)
    wrapped = torch.where(dec >= 2 ** 31, dec - 2 ** 32, dec)
    return wrapped.to(torch.int32), x[:, 0].clone()


def _warp_traceback2(dec):
    """K4's schedule: chunks walked from the top, thread i holds step base
    + i's word pair; h carries the state in its low 6 bits and every
    decision shifted in above them (a 32-bit register), so after a chunk
    step base + i's bit, bit 5 of its state, is the decision of step base
    + i + 6: bit i + 6 of h or of the chunk above's h."""
    b, t_max, _ = dec.shape
    words = dec.to(torch.int64) & 0xFFFFFFFF
    out = torch.full((b, t_max), -1, dtype=torch.int64)
    h = torch.zeros(b, dtype=torch.int64)
    above = torch.zeros(b, dtype=torch.int64)
    top = (t_max - 1) // CHUNK * CHUNK
    k = _THREADS + 6
    for base in range(top, -1, -CHUNK):
        g = base + _THREADS
        staged = words[:, g.clamp(max=t_max - 1)] * (g < t_max)[None, :,
                                                                None]
        n = min(CHUNK, t_max - base)
        word = torch.where((h & 32) != 0, staged[:, n - 1, 1],
                           staged[:, n - 1, 0])
        for i in range(n - 1, -1, -1):
            nxt = torch.where((h & 16) != 0, staged[:, i - 1, 1],
                              staged[:, i - 1, 0]) if i > 0 else None
            h = ((h << 1) | ((word >> (h & 31)) & 1)) & 0xFFFFFFFF
            word = nxt
        bits = torch.where(k < CHUNK, h[:, None] >> k.clamp(max=CHUNK - 1),
                           above[:, None] >> (k - CHUNK).clamp(min=0)) & 1
        out[:, base:base + n] = bits[:, :n]
        above = h
    return out.to(torch.uint8)


def test_warp_radix2_branch_metric_signs():
    """All four DAB polynomials tap the newest and the oldest register
    bit, so WS's 128 rows are rows 0..31 up to sign; one signed sum A per
    thread then gives all of a step's branch metrics: A, -A, -A, A for
    rows j, 32 + j, 64 + j, 96 + j, equal to ``_signed_sums``' table on
    erasure-heavy input (zeros compare equal whatever their sign: adding
    either to a path metric, never -0, gives the same candidate).  The
    kernel's own sum B, with row j's signs negated where j >> 4 differs
    from j's parity, is A or -A."""
    ws = torch.from_numpy(V.acs_matmul_matrices()[1])
    torch.testing.assert_close(ws[32:64], -ws[:32], rtol=0, atol=0)
    torch.testing.assert_close(ws[64:96], -ws[:32], rtol=0, atol=0)
    torch.testing.assert_close(ws[96:128], ws[:32], rtol=0, atol=0)
    rng = np.random.default_rng(32)
    soft = rng.integers(-2, 3, size=(40, 4)).astype(np.float32)
    soft[rng.random(soft.shape) < 0.5] = 0.0
    soft[:20] += rng.normal(size=(20, 4)).astype(np.float32)
    s = torch.from_numpy(soft)
    a = _warp_sums2(s, ws[:32])                              # (lanes, 32)
    got = torch.cat([a, -a, -a, a], dim=1).T                 # (128, lanes)
    want = V._signed_sums(s.T[None].contiguous()).index_select(
        1, V._sign_rows(ws))[0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    flip = ((_THREADS >> 4) ^ (_THREADS & 1)).bool()
    torch.testing.assert_close(_warp_sums2(s, _warp_signs2(ws)),
                               torch.where(flip, -a, a), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["noisy", "ties"])
@pytest.mark.parametrize("t_max", [7, CHUNK - 1, CHUNK + 1, 2 * CHUNK - 1,
                                   2 * CHUNK + 1, 3 * CHUNK + 1])
def test_warp_radix2_schedule_matches_plain(t_max, kind):
    """K3's and K4's warp schedules, emulated, against ``acs2_plain`` and
    ``traceback2_plain`` at odd T at and around the chunk edges (a partial
    last chunk, one step past a chunk), noisy or integer-valued with half
    the soft bits erased (ACS ties).  Decisions, metrics and bits must be
    equal."""
    rng = np.random.default_rng(1000 * t_max + len(kind))
    lanes = 5
    if kind == "noisy":
        soft = 1.0 - 2.0 * rng.integers(0, 2, size=(lanes, t_max, 4))
        soft = soft + rng.normal(scale=0.8, size=soft.shape)
        soft[rng.random(soft.shape) < 1 / 3] = 0.0
    else:
        soft = rng.integers(-2, 3, size=(lanes, t_max, 4)).astype(float)
        soft[rng.random(soft.shape) < 0.5] = 0.0
    soft4 = torch.from_numpy(soft.astype(np.float32))
    ws2 = V._ws2(torch.device("cpu"))
    dec, metric = _warp_acs2(soft4, ws2)
    dec_p, metric_p = V.acs2_plain(soft4, ws2)
    torch.testing.assert_close(dec, dec_p, rtol=0, atol=0)
    torch.testing.assert_close(metric, metric_p, rtol=0, atol=0)
    torch.testing.assert_close(_warp_traceback2(dec_p),
                               V.traceback2_plain(dec_p), rtol=0, atol=0)


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

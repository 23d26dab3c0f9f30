"""The hand-written CUDA Viterbi kernels (K1 ``acs4``, K2 ``traceback4``,
K2' ``traceback4_onehot64``, K3 ``acs2``, K4 ``traceback2``) against their
plain PyTorch versions, and the receiver on the card against the receiver
on the CPU.

Every test needs a CUDA device (marker ``gpu``) and skips without one.
The file imports no JAX, so on the GPU machine it runs with the port
alone:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu

Contract: decisions, metrics and bits equal the plain versions exactly
(same branch-metric summation order, same strict-'>' select); ETI bytes
from the card equal those from the CPU.
"""

import numpy as np
import pytest
import torch

from dabtools_tpu_torch.mod.convcode import conv_encode
from dabtools_tpu_torch.ops import cudalib
from dabtools_tpu_torch.ops import viterbi as V
from dabtools_tpu_torch.ops.viterbi_cuda import CHUNK

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _noisy_batch(rng, batch, n, scale=0.6):
    msgs = rng.integers(0, 2, size=(batch, n), dtype=np.uint8)
    soft = np.stack([1.0 - 2.0 * conv_encode(m) for m in msgs])
    soft = (soft + rng.normal(scale=scale, size=soft.shape)).astype(
        np.float32)
    return msgs, soft


def _info_bits(t2):
    """Information bits of a codeword of ``t2`` double steps."""
    return 2 * t2 - 6


def _launches(*kernels):
    """Launches so far of each named kernel (its C symbol less ``dab_``)."""
    return tuple(cudalib.launches[f"dab_{k}"] for k in kernels)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,erased", [
    ((3, 768), 0.0), ((5, 3072), 0.0), ((1, 2), 0.0),
    ((5, _info_bits(CHUNK - 1)), 1 / 3), ((7, _info_bits(CHUNK + 1)), 1 / 3),
    ((9, _info_bits(2 * CHUNK + 3)), 1 / 3)])
def test_kernels_match_plain(cuda, shape, erased):
    """K1/K2 against the plain versions, exactly.  The last three cases
    test the kernels' chunking: T2 off a multiple of the chunk, an odd
    lane count (the last two-lane block half empty), lanes of 0, 1 and
    one chunk of double steps, and a third of the soft bits erased to
    exactly 0 (ACS ties)."""
    from dabtools_tpu_torch.ops import viterbi_cuda as K
    batch, n = shape
    rng = np.random.default_rng(batch + n)
    msgs, soft = _noisy_batch(rng, batch, n, scale=0.4 if erased else 0.6)
    soft[rng.random(soft.shape) < erased] = 0.0
    s = torch.from_numpy(soft).to(cuda)
    b, n4 = s.shape
    soft8 = s.reshape(b, n4 // 8, 8)
    t2 = torch.full((b,), n4 // 8, dtype=torch.int32, device=cuda)
    t2[0] = n4 // 16                                # one short lane
    if b >= 5:
        t2[1:4] = torch.tensor([0, 1, min(CHUNK, n4 // 8)])
    ws4 = V._ws4(cuda)
    dec_k, metric_k = K.acs4(soft8, t2, ws4)
    dec_p, metric_p = V.acs4_plain(soft8, t2, ws4)
    torch.testing.assert_close(dec_k, dec_p, rtol=0, atol=0)
    torch.testing.assert_close(metric_k, metric_p, rtol=0, atol=0)
    torch.testing.assert_close(K.traceback4(dec_k),
                               V.traceback4_plain(dec_k), rtol=0, atol=0)
    bits, _ = V.viterbi_decode(s)
    np.testing.assert_array_equal(bits.cpu().numpy(), msgs)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 769), (5, 3073), (1, 1), (7, 27),
                                   (4, 59), (640, 91)])
def test_radix2_kernels_match_plain(cuda, shape):
    """K3/K4 at odd trellis lengths, with a third of the soft bits erased
    to exactly 0 (ACS ties): decisions, metrics and bits equal the plain
    versions exactly, and ``viterbi_decode`` runs them once each.  T = 7,
    33, 65 and 97 (n + 6) are a partial first chunk and one step past
    one, two and three chunks; 7 and 5 lanes leave a two-lane block half
    empty."""
    from dabtools_tpu_torch.ops import viterbi_cuda as K
    batch, n = shape
    rng = np.random.default_rng(batch * 7 + n)
    msgs, soft = _noisy_batch(rng, batch, n, scale=0.4)
    soft[rng.random(soft.shape) < 1 / 3] = 0.0
    s = torch.from_numpy(soft).to(cuda)
    b, n4 = s.shape
    soft4 = s.reshape(b, n4 // 4, 4)
    ws2 = V._ws2(cuda)
    dec_k, metric_k = K.acs2(soft4, ws2)
    dec_p, metric_p = V.acs2_plain(soft4, ws2)
    torch.testing.assert_close(dec_k, dec_p, rtol=0, atol=0)
    torch.testing.assert_close(metric_k, metric_p, rtol=0, atol=0)
    torch.testing.assert_close(K.traceback2(dec_k),
                               V.traceback2_plain(dec_k), rtol=0, atol=0)
    n0 = _launches("acs2", "traceback2")
    bits, _ = V.viterbi_decode(s)
    assert _launches("acs2", "traceback2") == (n0[0] + 1, n0[1] + 1)
    np.testing.assert_array_equal(bits.cpu().numpy(), msgs)


@pytest.mark.gpu
@pytest.mark.parametrize("t2_max", [1, CHUNK - 1, CHUNK, CHUNK + 1,
                                    2 * CHUNK, 2 * CHUNK + 1, 1539])
def test_onehot64_traceback_matches_k2(cuda, t2_max):
    """K2' equals K2, ``traceback4_plain`` and ``traceback4_onehot64_plain``
    at T2 on and around the chunk edges (and the flagship's 1539 double
    steps): on K1's decisions of ragged lanes (lengths 0, 1, a chunk, the
    whole width, random; a third of the soft bits erased), and on random
    decision words.  Where T2 holds a codeword, the decode with
    ``traceback="onehot64"`` runs K1 and K2' once each and gives the
    messages of full and half-length lanes."""
    from dabtools_tpu_torch.ops import viterbi_cuda as K
    rng = np.random.default_rng(t2_max)
    soft = rng.normal(size=(7, t2_max, 8)).astype(np.float32)
    soft[rng.random(soft.shape) < 1 / 3] = 0.0
    lengths = [0, 1, CHUNK, t2_max, t2_max, int(rng.integers(0, t2_max + 1)),
               t2_max - 1]
    t2 = torch.tensor(np.minimum(lengths, t2_max), dtype=torch.int32,
                      device=cuda)
    dec, _ = K.acs4(torch.from_numpy(soft).to(cuda), t2, V._ws4(cuda))
    words = torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, size=(9, t2_max, 4)).astype(np.int32)).to(cuda)
    for d in (dec, words):
        got = K.traceback4_onehot64(d)
        torch.testing.assert_close(got, K.traceback4(d), rtol=0, atol=0)
        torch.testing.assert_close(got, V.traceback4_plain(d), rtol=0,
                                   atol=0)
        torch.testing.assert_close(got, V.traceback4_onehot64_plain(d),
                                   rtol=0, atol=0)
    n1, n2 = _info_bits(t2_max), _info_bits(t2_max // 2)
    if n2 <= 0:
        return
    m1, s1 = _noisy_batch(rng, 6, n1)
    m2, s2 = _noisy_batch(rng, 3, n2)
    soft, lengths = V.ragged_lanes([torch.from_numpy(s1).to(cuda),
                                    torch.from_numpy(s2).to(cuda)])
    n0 = _launches("acs4", "traceback4_onehot64")
    bits, _ = V.viterbi_decode4(soft, lengths, traceback="onehot64")
    assert _launches("acs4", "traceback4_onehot64") == (n0[0] + 1,
                                                       n0[1] + 1)
    np.testing.assert_array_equal(bits[:6].cpu().numpy(), m1)
    np.testing.assert_array_equal(bits[6:, :n2].cpu().numpy(), m2)


@pytest.mark.gpu
def test_ragged_dispatch_matches_cpu(cuda):
    """FIC-length and MSC-length lanes in one dispatch: the card's bits
    and metrics equal the CPU's plain decode of the same lanes."""
    rng = np.random.default_rng(5)
    m1, s1 = _noisy_batch(rng, 8, 768)
    m2, s2 = _noisy_batch(rng, 4, 3072)
    jobs = [torch.from_numpy(s1), torch.from_numpy(s2)]
    n0 = _launches("acs4", "traceback4")
    got = V.viterbi_decode_ragged([j.to(cuda) for j in jobs])
    assert _launches("acs4", "traceback4") == (n0[0] + 1, n0[1] + 1)
    ref = V.viterbi_decode_ragged(jobs)
    for (bits, metric), (rb, rm), m in zip(got, ref, (m1, m2)):
        np.testing.assert_array_equal(bits.cpu().numpy(), rb.numpy())
        np.testing.assert_array_equal(metric.cpu().numpy(), rm.numpy())
        np.testing.assert_array_equal(bits.cpu().numpy(), m)


@pytest.mark.gpu
def test_kernel_wrappers_check_inputs(cuda):
    from dabtools_tpu_torch.ops import viterbi_cuda as K
    ws4 = V._ws4(cuda)
    t2 = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K.acs4(torch.zeros((2, 4, 8)), t2, ws4)           # CPU tensor
    with pytest.raises(ValueError):
        K.acs4(torch.zeros((2, 4, 8), dtype=torch.float64, device=cuda),
               t2, ws4)
    with pytest.raises(ValueError):
        K.acs4(torch.zeros((2, 8, 4), device=cuda).transpose(1, 2), t2,
               ws4)
    with pytest.raises(ValueError):
        K.traceback4(torch.zeros((2, 4, 3), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        K.traceback4_onehot64(torch.zeros((2, 4, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        K.acs2(torch.zeros((2, 5, 4), device=cuda), V._ws2(cuda)[:64])
    with pytest.raises(ValueError):
        K.traceback2(torch.zeros((2, 5, 2), dtype=torch.int64, device=cuda))


@pytest.mark.gpu
def test_receiver_on_card_matches_cpu(cuda):
    """The whole receiver on the card emits the ETI bytes it emits on the
    CPU, and runs K1/K2 once per device step."""
    from dabtools_tpu_torch.fic.config import (
        Ensemble,
        Service,
        ServiceComponent,
        Subchannel,
    )
    from dabtools_tpu_torch.mod.impairments import quantize_u8
    from dabtools_tpu_torch.models.receiver import DabReceiver
    from dabtools_tpu_torch.testsignal import modulate
    ens = Ensemble(
        eid=0x4FFF, label="TWO SUBCH",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),
                     Subchannel.eep(9, 48, 2, "B", 64)),
        services=(Service(sid=1, components=(
            ServiceComponent(tmid=0, subchid=1),)),
                  Service(sid=2, components=(
                      ServiceComponent(tmid=0, subchid=9),))))
    rng = np.random.default_rng(3)
    x, payload = modulate(ens, 14, rng)
    u8 = quantize_u8(x)
    rx_cpu = DabReceiver(n_frames=4, device="cpu")
    ref = rx_cpu.feed(u8)
    n0 = _launches("acs4", "traceback4")
    rx = DabReceiver(n_frames=4, device=cuda)
    eti = rx.feed(u8)
    assert eti and eti == ref
    n1 = _launches("acs4", "traceback4")
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (rx.device_steps,
                                              rx.device_steps)
    assert rx._rings["1"].is_cuda and rx._cif_count.is_cuda


# ------------------------------------------------ front ends and channels
def _unit_noise(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n))
            / np.sqrt(2)).astype(np.complex64)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["fft", "direct"])
def test_channelizer_on_card_matches_cpu(cuda, method):
    from dabtools_tpu_torch.ops.fir import Channelizer
    fs = 8_192_000
    x = _unit_noise(fs // 10, 9)
    offs = [-3_072_000, 1_712_000, 0]
    want = Channelizer(fs, offs, method=method, device="cpu")(x)
    got = Channelizer(fs, offs, method=method, device=cuda)(x)
    assert got.shape == want.shape and got.is_cuda
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=2e-5)


@pytest.mark.gpu
def test_direct_channelizer_keeps_tf32_off(cuda):
    """With TF32 on process-wide, the direct form still agrees with the
    fft form within the JAX test's atol=2e-5 (a TF32 convolution misses
    by ~1e-3), and the process-wide setting is left as it was."""
    from dabtools_tpu_torch.ops.fir import Channelizer
    fs = 16_384_000
    x = _unit_noise(fs // 16, 9)
    offs = [3_424_000, -1_712_000, 0]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yd = Channelizer(fs, offs, method="direct", device=cuda)(x)
        yf = Channelizer(fs, offs, method="fft", device=cuda)(x)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    n = min(yd.shape[1], yf.shape[1])
    np.testing.assert_allclose(yf[:, :n].cpu().numpy(),
                               yd[:, :n].cpu().numpy(), atol=2e-5)


@pytest.mark.gpu
def test_resampler_on_card_matches_cpu(cuda):
    from dabtools_tpu_torch.ops.resample import Resampler
    x = _unit_noise(300_000, 0)
    cpu, card = Resampler(2_400_000, device="cpu"), Resampler(2_400_000,
                                                              device=cuda)
    for a, b in ((0, 50_000), (50_000, 50_137), (50_137, 300_000)):
        np.testing.assert_allclose(card(x[a:b]).cpu().numpy(),
                                   cpu(x[a:b]).numpy(), atol=1e-5)
    assert (card._next_out, card._consumed) == (cpu._next_out,
                                                cpu._consumed)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [2_400_000, 2_500_000, 10_000_000,
                                  1_024_000])
def test_resample_kernel_matches_plain(cuda, rate):
    """``csrc/resample.cu`` against ``resample_plain`` on the same card
    tensors: L/M = 64/75, 512/625 (a 48 KB bank, over the default shared
    memory), 128/625 and 2/1 (interpolation), every phase offset r0, a
    window start inside the tail and a span that ends at the last input."""
    from dabtools_tpu_torch.ops import resample as R
    rs = R.Resampler(rate, device=cuda)
    up, down, keep = rs.up, rs.down, rs.taps_per_phase - 1
    rng = np.random.default_rng(rate % 1000)
    tail = torch.from_numpy(_unit_noise(keep, 3)).to(cuda)
    x = torch.from_numpy(_unit_noise(200_003, 4)).to(cuda)
    for r0, s0 in ((0, 0), (up - 1, 1), (int(rng.integers(up)), 7)):
        # the most outputs: the last window ends at the last input
        n_out = ((x.numel() - s0) * up - r0 - 1) // down + 1
        before = cudalib.launches["dab_resample"]
        got = R.resample_cuda(tail, x, rs._bank_dev, r0, s0, n_out, down)
        want = R.resample_plain(tail, x, rs._bank_dev, r0, s0, n_out, down)
        assert cudalib.launches["dab_resample"] == before + 1
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="leave"):
        R.resample_cuda(tail, x, rs._bank_dev, r0, s0, n_out + 1, down)


@pytest.mark.gpu
def test_resampler_on_card_past_2_32_counts_launches(cuda):
    """The card's resampler against the CPU's at a global output index past
    2^32, over uneven chunks (an empty one, one shorter than the tail,
    single samples, some completing no output): outputs, state, and one
    kernel launch per call with output, none for a call without."""
    from dabtools_tpu_torch.ops import resample as R
    x = _unit_noise(300_000, 1)
    cpu, card = R.Resampler(2_400_000, device="cpu"), R.Resampler(
        2_400_000, device=cuda)
    for r in (cpu, card):
        r._next_out = 2 ** 32 + 12_345
        r._consumed = r._next_out * r.down // r.up
    chunks = ([(0, 50_000), (50_000, 50_000), (50_000, 50_005)]
              + [(a, a + 1) for a in range(50_005, 50_025)]
              + [(50_025, 50_137), (50_137, 200_000), (200_000, 300_000)])
    empty = 0
    for a, b in chunks:
        before = cudalib.launches["dab_resample"]
        got, want = card(x[a:b]), cpu(x[a:b])
        assert cudalib.launches["dab_resample"] == before + (got.numel() > 0)
        empty += got.numel() == 0
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   atol=1e-5)
        assert (card._next_out, card._consumed) == (cpu._next_out,
                                                    cpu._consumed)
        np.testing.assert_array_equal(card._tail, cpu._tail)
    assert empty >= 2


@pytest.mark.gpu
def test_tii_powers_on_card_match_cpu(cuda):
    from dabtools_tpu_torch.ops.tii import detect_tii_block, tii_powers_at
    from dabtools_tpu_torch.testsignal import flagship_ensemble, modulate
    x, _ = modulate(flagship_ensemble(), 3, np.random.default_rng(2),
                    tii=(7, 31))
    x = x[: 3 * 196_608]
    ns = torch.tensor(100, dtype=torch.int32)
    want = tii_powers_at(torch.from_numpy(x), ns, 2)
    got = tii_powers_at(torch.from_numpy(x).to(cuda), ns.to(cuda), 2)
    torch.testing.assert_close(got["powers"].cpu(), want["powers"],
                               rtol=1e-4, atol=1e-4 * float(
                                   want["powers"].max()))
    torch.testing.assert_close(got["floor"].cpu(), want["floor"],
                               rtol=1e-4, atol=0)
    det = detect_tii_block(torch.from_numpy(x).to(cuda), 2)
    assert (det.sub_id, det.main_id) == (7, 31)


@pytest.mark.gpu
def test_channel_batch_on_card_matches_cpu(cuda):
    """3 streams as one batched block on the card: bytes equal the CPU's,
    and K1/K2 launch once for all of them."""
    from dabtools_tpu_torch.fic.config import Ensemble, Subchannel
    from dabtools_tpu_torch.mod.impairments import awgn, carrier_offset
    from dabtools_tpu_torch.models.receiver import block_samples, to_host
    from dabtools_tpu_torch.parallel.channel import channel_parallel_block
    from dabtools_tpu_torch.testsignal import modulate
    ens = Ensemble(eid=0x4FFF, label="ONE SUBCH",
                   subchannels=(Subchannel.eep(1, 0, 3, "A", 64),))
    x, _ = modulate(ens, 6, np.random.default_rng(3))
    n = block_samples(4)
    xs = np.stack([
        awgn(carrier_offset(x[start:], cfo), 15.0,
             np.random.default_rng(c))[:n]
        for c, (cfo, start) in enumerate(((200.0, 300), (-350.0, 1500),
                                          (50.0, 7000)))])
    nb = ens.subchannel(1).profile.tx_bits

    def run(dev):
        out, rings, cif = channel_parallel_block(
            torch.from_numpy(xs).to(dev),
            {"1": torch.zeros((3, 16, nb), device=dev)},
            torch.tensor(0, dtype=torch.int32, device=dev),
            ensemble=ens.decode_config(), n_frames=4)
        return to_host(out), rings

    want, _ = run("cpu")
    n0 = _launches("acs4", "traceback4")
    got, rings = run(cuda)
    n1 = _launches("acs4", "traceback4")
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (1, 1)
    np.testing.assert_array_equal(got["fib_bytes"], want["fib_bytes"])
    np.testing.assert_array_equal(got["subch"]["1"], want["subch"]["1"])
    assert rings["1"].is_cuda and rings["1"].shape == (3, 16, nb)


@pytest.mark.gpu
def test_rs_on_card_matches_cpu(cuda):
    """The batched RS decoder on the card equals it on the CPU, for
    RS(120,110) and RS(204,188), with correctable and uncorrectable
    rows."""
    from dabtools_tpu_torch.ops.rs import make_rs_decoder
    from dabtools_tpu_torch.utils.gf256 import rs_parity
    rng = np.random.default_rng(11)
    for n, k in ((120, 110), (204, 188)):
        t = (n - k) // 2
        data = rng.integers(0, 256, size=(96, k), dtype=np.uint8)
        cw = np.concatenate([data, rs_parity(data, n - k)], axis=1)
        for row in range(96):
            for p in rng.choice(n, size=row % (t + 4), replace=False):
                cw[row, p] ^= rng.integers(1, 256)
        dec = make_rs_decoder(n, k)
        want_data, want_n = dec(torch.from_numpy(cw))
        got_data, got_n = dec(torch.from_numpy(cw).to(cuda))
        assert got_data.device.type == got_n.device.type == cuda.type
        assert torch.equal(got_data.cpu(), want_data)
        assert torch.equal(got_n.cpu(), want_n)
        assert (want_n < 0).any() and (want_n == t).any()


@pytest.mark.gpu
def test_timeblock_span_on_card_matches_cpu(cuda):
    """A 2 x 2 time-block span on the card equals the same span on the
    CPU (bytes exactly), with one K1 and one K2 launch for the span."""
    from dabtools_tpu_torch.constants import MODE_I
    from dabtools_tpu_torch.fic.config import Ensemble, Subchannel
    from dabtools_tpu_torch.models.receiver import to_host
    from dabtools_tpu_torch.parallel.mesh import make_receiver_mesh
    from dabtools_tpu_torch.parallel.timeblock import (
        halo_sizes,
        timeblock_receiver,
    )
    from dabtools_tpu_torch.testsignal import modulate
    ens = Ensemble(eid=0x4FFF, label="ONE SUBCH",
                   subchannels=(Subchannel.eep(1, 0, 3, "A", 64),))
    n_time, f_own, warm = 2, 6, 5
    g0 = warm + 1
    x, payload = modulate(ens, g0 + n_time * f_own + 1,
                          np.random.default_rng(5))
    fr = MODE_I.frame_size
    lh, rh = halo_sizes(warm)
    s0, sl = g0 * fr, n_time * f_own * fr
    args = [np.ascontiguousarray(np.broadcast_to(a, (2, a.size)))
            for a in (x[s0:s0 + sl], x[s0 - lh:s0], x[s0 + sl:s0 + sl + rh])]

    def run(dev):
        fn = timeblock_receiver(
            make_receiver_mesh(n_channels=2, n_time=n_time,
                               devices=[dev] * 4),
            ens, frames_per_shard=f_own, warmup_frames=warm)
        return to_host(fn(*(torch.from_numpy(a).to(dev) for a in args), g0))

    want = run(torch.device("cpu"))
    n0 = _launches("acs4", "traceback4")
    got = run(cuda)
    n1 = _launches("acs4", "traceback4")
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (1, 1)
    for key in ("fib_bytes", "prs_offset"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["subch"]["1"], want["subch"]["1"])
    for j in range(n_time * f_own * 4):
        assert (got["subch"]["1"][0, j].tobytes()
                == payload[1][g0 * 4 + j - 15].tobytes())


@pytest.mark.gpu
def test_span_across_two_processes_on_card(cuda, tmp_path):
    """A 2 x 4 span with shards 0-1 on rank 0 and 2-3 on rank 1, both
    ranks on ``cuda:0`` and their halos sent through ``gloo``: each
    rank's gathered span equals the one-process span on the card byte
    for byte, but for ``cfo_carriers`` within float32 rounding (a rank's
    batch of 4 cells sums the guard correlation in another order than
    the one-process batch of 8), and each rank launched K1 and K2
    once."""
    from dabtools_tpu_torch.constants import MODE_I
    from dabtools_tpu_torch.fic.config import Ensemble, Subchannel
    from dabtools_tpu_torch.models.receiver import to_host
    from dabtools_tpu_torch.parallel.mesh import make_receiver_mesh
    from dabtools_tpu_torch.parallel.timeblock import (
        halo_sizes,
        timeblock_receiver,
    )
    from dabtools_tpu_torch.testsignal import modulate
    # pytest puts tests/ on sys.path; a package named ``tests`` may
    # shadow the repo's directory of that name
    from torch_distributed_worker import launch
    cudalib.build()             # once, before the ranks load it
    ens = Ensemble(eid=0x4FFF, label="ONE SUBCH",
                   subchannels=(Subchannel.eep(1, 0, 3, "A", 64),))
    n_time, f_own, warm = 4, 6, 5
    g0 = warm + 1
    x, _ = modulate(ens, g0 + n_time * f_own + 1, np.random.default_rng(5))
    fr = MODE_I.frame_size
    lh, rh = halo_sizes(warm)
    s0, sl = g0 * fr, n_time * f_own * fr
    span, prefix, suffix = (
        np.ascontiguousarray(np.broadcast_to(a, (2, a.size)))
        for a in (x[s0:s0 + sl], x[s0 - lh:s0], x[s0 + sl:s0 + sl + rh]))
    fn = timeblock_receiver(
        make_receiver_mesh(n_channels=2, n_time=n_time, devices=[cuda] * 8),
        ens, frames_per_shard=f_own, warmup_frames=warm)
    want = to_host(fn(*(torch.from_numpy(a).to(cuda)
                        for a in (span, prefix, suffix)), g0))
    ranks = launch(tmp_path, "span_split", ens, device="cuda:0", x=span,
                   prefix=prefix, suffix=suffix, g0=g0, f_own=f_own,
                   warmup=warm)
    for res, info in ranks:
        assert info["launches"] == [1, 1]
        got = res["out"]
        for key in ("fib_bytes", "fic_metric", "prs_peak", "prs_offset"):
            assert got[key].tobytes() == want[key].tobytes(), key
        for key in ("subch", "subch_metric"):
            assert got[key]["1"].tobytes() == want[key]["1"].tobytes(), key
        np.testing.assert_allclose(got["cfo_carriers"], want["cfo_carriers"],
                                   atol=1e-9, rtol=1e-6)

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
from dabtools_tpu_torch.ops import viterbi as V

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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 768), (5, 3072), (1, 2)])
def test_kernels_match_plain(cuda, shape):
    from dabtools_tpu_torch.ops import viterbi_cuda as K
    batch, n = shape
    rng = np.random.default_rng(batch + n)
    msgs, soft = _noisy_batch(rng, batch, n)
    s = torch.from_numpy(soft).to(cuda)
    b, n4 = s.shape
    soft8 = s.reshape(b, n4 // 8, 8)
    t2 = torch.full((b,), n4 // 8, dtype=torch.int32, device=cuda)
    t2[0] = n4 // 16                                # one short lane
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
@pytest.mark.parametrize("shape", [(3, 769), (5, 3073), (1, 1)])
def test_radix2_kernels_match_plain(cuda, shape):
    """K3/K4 at odd trellis lengths, with a third of the soft bits erased
    to exactly 0 (ACS ties): decisions, metrics and bits equal the plain
    versions exactly, and ``viterbi_decode`` runs them once each."""
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
    n0 = K.acs2_launches, K.traceback2_launches
    bits, _ = V.viterbi_decode(s)
    assert (K.acs2_launches, K.traceback2_launches) == (n0[0] + 1,
                                                        n0[1] + 1)
    np.testing.assert_array_equal(bits.cpu().numpy(), msgs)


@pytest.mark.gpu
def test_onehot64_traceback_matches_k2(cuda):
    """K2' on K1's decisions of a ragged batch equals K2 and the plain
    traceback, and ``traceback="onehot64"`` runs it."""
    from dabtools_tpu_torch.ops import viterbi_cuda as K
    rng = np.random.default_rng(6)
    m1, s1 = _noisy_batch(rng, 6, 768)
    m2, s2 = _noisy_batch(rng, 3, 3072)
    soft, lengths = V.ragged_lanes([torch.from_numpy(s1).to(cuda),
                                    torch.from_numpy(s2).to(cuda)])
    b, n4 = soft.shape
    t2 = torch.from_numpy((lengths // 2).astype(np.int32)).to(cuda)
    dec, _ = K.acs4(soft.reshape(b, n4 // 8, 8), t2, V._ws4(cuda))
    got = K.traceback4_onehot64(dec)
    torch.testing.assert_close(got, K.traceback4(dec), rtol=0, atol=0)
    torch.testing.assert_close(got, V.traceback4_plain(dec), rtol=0, atol=0)
    n0 = K.traceback4_onehot64_launches
    bits, _ = V.viterbi_decode4(soft, lengths, traceback="onehot64")
    assert K.traceback4_onehot64_launches == n0 + 1
    np.testing.assert_array_equal(bits[:6, :768].cpu().numpy(), m1)
    np.testing.assert_array_equal(bits[6:].cpu().numpy(), m2)


@pytest.mark.gpu
def test_ragged_dispatch_matches_cpu(cuda):
    """FIC-length and MSC-length lanes in one dispatch: the card's bits
    and metrics equal the CPU's plain decode of the same lanes."""
    from dabtools_tpu_torch.ops import viterbi_cuda as K
    rng = np.random.default_rng(5)
    m1, s1 = _noisy_batch(rng, 8, 768)
    m2, s2 = _noisy_batch(rng, 4, 3072)
    jobs = [torch.from_numpy(s1), torch.from_numpy(s2)]
    n0 = K.acs4_launches, K.traceback4_launches
    got = V.viterbi_decode_ragged([j.to(cuda) for j in jobs])
    assert (K.acs4_launches, K.traceback4_launches) == (n0[0] + 1,
                                                        n0[1] + 1)
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
    from dabtools_tpu_torch.ops import viterbi_cuda as K
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
    n0 = K.acs4_launches, K.traceback4_launches
    rx = DabReceiver(n_frames=4, device=cuda)
    eti = rx.feed(u8)
    assert eti and eti == ref
    assert (K.acs4_launches - n0[0], K.traceback4_launches - n0[1]) == (
        rx.device_steps, rx.device_steps)
    assert rx._rings["1"].is_cuda and rx._cif_count.is_cuda

"""The hand-written CUDA Viterbi kernels (K1 ``acs4``, K2 ``traceback4``)
against their plain PyTorch versions, and the receiver on the card against
the receiver on the CPU.

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

from dabtools_tpu.mod.convcode import conv_encode
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


@pytest.mark.gpu
def test_receiver_on_card_matches_cpu(cuda):
    """The whole receiver on the card emits the ETI bytes it emits on the
    CPU, and runs K1/K2 once per device step."""
    from dabtools_tpu.fic.config import (
        Ensemble,
        Service,
        ServiceComponent,
        Subchannel,
    )
    from dabtools_tpu.mod.impairments import quantize_u8
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

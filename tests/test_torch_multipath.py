"""The port's receiver through ``tests/test_multipath.py``'s channels,
held against the JAX receiver (CPU).

The six receiver cases of that file (an SFN echo, static TU6, the SNR
estimate at 8, 15 and 22 dB, the clean delay-spread floor, TU6 with 10
Hz fading plus a 300 Hz CFO, and RA4), with the same seeds, go through
both ``DabReceiver(n_frames=4)``s.  ETI bytes are identical, every
block's ``delay_spread_us`` agrees within ``DELAY_ATOL`` and its SNR
estimate within ``SNR_ATOL``; the port also passes the JAX tests' own
windows (73.1 +- 4 us for the echo, 0.7-1.8 us for TU6, under 0.6 us
for the clean floor, the SNR within 1 dB) and payload checks.
"""

import numpy as np
import pytest
import torch

from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.mod.impairments import (
    RA4,
    TU6,
    awgn,
    carrier_offset,
    multipath,
    sfn_echo,
)
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_torch_robustness import _both

torch.set_num_threads(2)

# the port's delay spread differs from the JAX receiver's by 1.5e-5 us at
# most on these channels (the CIR passes through an FFT); 1e-4 us is far
# below the CIR's ~0.65 us resolution
DELAY_ATOL = 1e-4
# the SNR estimate is a log of null_ratio, which agrees within rtol=1e-4
# (tests/test_torch_receiver.py::test_process_block_matches_jax): 4.3e-4 dB
SNR_ATOL = 1e-3


def _channel(case: str):
    """(the case's samples, its payloads, the port's expected delay-spread
    window in us or None, the injected SNR in dB or None)."""
    if case.startswith("snr"):
        snr = float(case[3:])
        x, payload = modulate(build_ensemble(), 10)
        return (awgn(x, snr, np.random.default_rng(1)), payload, None,
                snr)
    x, payload = modulate(build_ensemble(), 14)
    rng = np.random.default_rng(5)
    if case == "sfn_echo":
        return (sfn_echo(awgn(x, 20.0, rng), 150.0, -2.0, phase=1.1),
                payload, (73.1 - 4.0, 73.1 + 4.0), None)
    if case == "tu6_static":
        return (multipath(awgn(x, 20.0, rng), TU6,
                          rng=np.random.default_rng(11)),
                payload, (0.7, 1.8), None)
    if case == "clean_floor":
        return x, payload, (-np.inf, 0.6), None
    if case == "tu6_fading_cfo":
        return (carrier_offset(multipath(
            awgn(x, 24.0, rng), TU6, doppler_hz=10.0,
            rng=np.random.default_rng(11)), 300.0), payload, None, None)
    assert case == "ra4"
    return (multipath(awgn(x, 20.0, rng), RA4,
                      rng=np.random.default_rng(2)), payload, None, None)


def _subch1_exact(rx, eti, payload):
    """``tests/test_multipath.py::_decode_subch1``'s checks on ``rx``'s
    output: at least 4000 bytes of sub-channel 1, bit-exact, and no FIB
    CRC failure in the last block."""
    got = b"".join(fr.streams[1].data for fr in EtiParser().feed(
        b"".join(eti)) if 1 in fr.streams)
    want = payload[1].tobytes()
    assert len(got) >= 4000, "too few ETI frames decoded"
    assert want.find(got[:64]) == 0 and want[:len(got)] == got, \
        "payload not bit-exact through the channel"
    assert rx.stats[-1].fib_crc_bad == 0


@pytest.mark.parametrize("case", ["sfn_echo", "tu6_static", "snr8",
                                  "snr15", "snr22", "clean_floor",
                                  "tu6_fading_cfo", "ra4"])
def test_receiver_through_channel_matches_jax(case):
    x, payload, window, snr = _channel(case)
    jr, je, tr, te = _both(x)
    assert tuple(te) == tuple(je)
    assert len(tr.stats) == len(jr.stats) > 0
    np.testing.assert_allclose([s.delay_spread_us for s in tr.stats],
                               [s.delay_spread_us for s in jr.stats],
                               atol=DELAY_ATOL, rtol=0)
    np.testing.assert_allclose([s.snr_db for s in tr.stats],
                               [s.snr_db for s in jr.stats],
                               atol=SNR_ATOL, rtol=0)
    last = tr.stats[-1]
    if snr is not None:
        assert abs(last.snr_db - snr) < 1.0
        return
    _subch1_exact(tr, te, payload)
    if window is not None:
        assert window[0] < last.delay_spread_us < window[1]

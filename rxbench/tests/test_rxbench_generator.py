"""The frozen generator against the port's own signal builders, and the
looped pool decoded across its seams by the port's receiver (CPU)."""

import numpy as np
import pytest

from rxbench.gen import pool as P
from rxbench.gen import signals
from rxbench.reference import StreamCheck

from tiny import CONFIG, TRAFFIC


def test_modulate_is_the_ports():
    from dabtools_tpu_torch import testsignal as S
    ens = signals.flagship_ensemble()
    assert ens.to_dict() == S.flagship_ensemble().to_dict()
    x, pay = signals.modulate(ens, 4, np.random.default_rng(123))
    y, want = S.modulate(S.flagship_ensemble(), 4, np.random.default_rng(123))
    assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert pay.keys() == want.keys()
    assert all(pay[k].tobytes() == want[k].tobytes() for k in pay)


def test_wideband_builders_are_the_ports():
    from dabtools_tpu_torch import testsignal as S
    muxes = {"6A": signals.flagship_ensemble(0x6A01, "MUX 6A")}
    a, pa = signals.wideband_capture(muxes, 184_500_000, 8_192_000, 1,
                                     np.random.default_rng(9))
    b, pb = S.wideband_capture({"6A": S.flagship_ensemble(0x6A01, "MUX 6A")},
                               184_500_000, 8_192_000, 1,
                               np.random.default_rng(9))
    assert a.tobytes() == b.tobytes()
    x = np.random.default_rng(1).normal(size=4096).astype(np.complex64)
    assert signals.fft_resample(x, 4800).tobytes() == \
        S.fft_resample(x, 4800).tobytes()


def test_config_builds_the_flagship():
    import json

    from rxbench.spec import Spec
    cfg = Spec().config("flagship")
    ens = P.ensemble_from_spec(cfg["receivers"][0]["ensemble"])
    assert ens == signals.flagship_ensemble()
    assert json.dumps(cfg)


@pytest.mark.parametrize("seed", [5, 2**31 + 7])
def test_pool_is_seeded(seed):
    a = P.synthesize(CONFIG, TRAFFIC, seed)
    b = P.synthesize(CONFIG, TRAFFIC, seed)
    c = P.synthesize(CONFIG, TRAFFIC, seed + 1)
    assert a.samples.tobytes() == b.samples.tobytes()
    assert a.samples.tobytes() != c.samples.tobytes()
    n = TRAFFIC["pool_frames"] * P.MODE.frame_size * 2
    assert a.period == n and a.handover == 8 * P.MODE.frame_size * 2
    k = n // a.handover + 1               # a hand-over across the seam
    seam = a.chunk(k)
    pos = (k * a.handover) % n
    assert seam.tobytes() == np.concatenate(
        [a.samples[pos:n], a.samples[:a.handover - (n - pos)]]).tobytes()


def test_looped_pool_decodes_across_seams():
    """Every payload exact over more than two seams of a 6-frame pool."""
    from dabtools_tpu_torch.models.receiver import DabReceiver
    pool = P.synthesize(CONFIG, TRAFFIC, 77)
    check = StreamCheck(pool.truth[0])
    rx = DabReceiver(n_frames=8, device="cpu")
    for k in range(7):
        check.add(rx.feed(pool.chunk(k)))
    n_cifs = TRAFFIC["pool_frames"] * P.CIFS
    assert check.count > 2 * n_cifs
    assert check.bad_frames() == (0, "")


def test_capture_is_the_sum_of_upconversions():
    rng = np.random.default_rng(0)
    n, f, offs = 4096, 4, (-500 * 37, 500 * 811)
    xs = [(rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)
          for _ in offs]
    want = sum(signals.upconvert(x, f, o, 2_048_000 * f)
               for x, o in zip(xs, offs))
    spec = np.zeros(n * f, dtype=np.complex128)
    for x, o in zip(xs, offs):
        spec[P._upconverted_bins(n, f, o * n // 2_048_000)] += np.fft.fft(x)
    assert np.abs(np.fft.ifft(spec) * f - want).max() < 1e-5

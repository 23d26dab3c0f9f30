"""Independent SDR streams in the harness: a configuration with no
``center_hz`` and several receivers is that many streams at 2.048 Msps,
each with its own ensemble, CFO, timing offset and noise; the port's
multi-stream entry emits each stream's frames as a receiver of its own
would; and the tiny two-stream cell runs end to end on the CPU."""

import io
import json
import re

import numpy as np
import pytest

from rxbench import drive, run
from rxbench.gen import pool as P
from rxbench.spec import Spec

from tiny import CONFIG, STREAMS, STREAMS_CELL, TRAFFIC, make_root

SEED = 2**31 + 41


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture(scope="module")
def streams_pool():
    return P.synthesize(STREAMS, TRAFFIC, SEED)


def _run(root, cell=STREAMS_CELL["name"], seed=SEED, fault=None,
         spec=None):
    spec = spec or Spec(root)
    log = io.StringIO()
    res = run.run_cell(spec, spec.cell(cell), seed, 1.0, False,
                       device="cpu", fault=fault, log=log)
    return res, log.getvalue()


def test_stream_count():
    assert P.stream_count(Spec().config("flagship"), TRAFFIC) == 1
    assert P.stream_count(Spec().config("wideband3"), TRAFFIC) == 1
    assert P.stream_count(STREAMS, TRAFFIC) == 2
    assert P.stream_count(STREAMS, dict(TRAFFIC, rate_hz=2048000)) == 2


@pytest.mark.parametrize("traffic,config,why", [
    (dict(TRAFFIC, rate_hz=2400000), STREAMS, "2 streams at 2400000 Hz"),
    (TRAFFIC, dict(STREAMS, rate_hz=2400000), "2 streams at 2400000 Hz"),
    (TRAFFIC, dict(STREAMS, receivers=STREAMS["receivers"] + [
        {"block": None, "ensemble": None}]), "a stream with no ensemble"),
])
def test_a_stream_configuration_that_cannot_run_is_refused(traffic, config,
                                                           why):
    for call in (P.stream_count, P.synthesize):
        args = (config, traffic) + ((SEED,) if call is P.synthesize else ())
        with pytest.raises(ValueError, match=why) as e:
            call(*args)
        assert e.value.args[0].startswith("tiny2: ")
    with pytest.raises(ValueError, match=why):
        drive.Path(config, traffic, "cpu")


def test_each_stream_is_its_own_sdr(streams_pool):
    """One row per stream; the first is the pool its ensemble alone
    would give (its draws come first), the second has its own CFO,
    timing offset and noise."""
    pool = streams_pool
    assert pool.samples.shape[0] == 2 and pool.samples.ndim == 2
    assert pool.chunk(5).shape == (2, pool.handover)
    assert np.shares_memory(pool.chunk(5), pool.samples)
    first = P.synthesize(dict(STREAMS, receivers=STREAMS["receivers"][:1]),
                         TRAFFIC, SEED)
    assert (first.period, first.handover) == (pool.period, pool.handover)
    np.testing.assert_array_equal(pool.samples[0], first.samples)
    assert pool.truth[0].fic == first.truth[0].fic
    a, b = pool.truth
    assert (a.cfo_hz, a.delay) != (b.cfo_hz, b.delay)
    assert sorted(a.payload) == [1] and sorted(b.payload) == [5]
    assert a.fic != b.fic
    assert not np.array_equal(pool.samples[0], pool.samples[1])
    again = P.synthesize(STREAMS, TRAFFIC, SEED)
    np.testing.assert_array_equal(again.samples, pool.samples)


def test_the_entry_emits_what_separate_receivers_emit(streams_pool):
    """The harness's multi-stream entry (the port's, where it has one)
    against two ``DabReceiver``s fed the same chunks; stream 1's chunk of
    hand-over 2 is empty and hand-over 4's is None: that stream stays as
    it is, and goes on where it was."""
    from dabtools_tpu_torch.models.receiver import DabReceiver
    pool = streams_pool
    bank = drive.channel_receiver()(2, n_frames=8, device="cpu")
    alone = [DabReceiver(n_frames=8, device="cpu") for _ in range(2)]
    got, want = [[], []], [[], []]
    for k in range(8):
        rows = list(pool.chunk(k))
        if k in (2, 4):
            before = list(bank.device_steps)
            rows[1] = rows[1][:0] if k == 2 else None
        out = bank.feed(rows)
        assert len(out) == 2
        if k in (2, 4):
            assert out[1] == []
            assert bank.device_steps[1] == before[1]
        for s in range(2):
            got[s] += out[s]
            if rows[s] is not None and len(rows[s]):
                want[s] += alone[s].feed(rows[s])
    assert [len(g) for g in got] == [len(w) for w in want]
    assert len(got[1]) < len(got[0])
    assert got == want and all(got)
    assert bank.device_steps == [rx.device_steps for rx in alone]
    assert [e.eid for e in bank.ensembles] == [0x4FF1, 0x4FF2]
    with pytest.raises(ValueError, match="1 chunks for 2 streams"):
        bank.feed([rows[0]])


def test_the_path_reaches_streams_only_through_the_entry(monkeypatch):
    """``Path`` builds one ``ChannelReceiver`` for a stream configuration
    and a wideband capture, and reads only its ``feed``,
    ``device_steps`` and ``ensembles``."""
    made = []

    class Entry:
        def __init__(self, n_streams, n_frames=8, *, device):
            made.append((n_streams, n_frames, device))
            self.device_steps = [3] * n_streams
            self.ensembles = [None] + [object()] * (n_streams - 1)

        def feed(self, chunks):
            return [[bytes([len(c) % 256])] for c in chunks]

    monkeypatch.setattr(drive, "channel_receiver", lambda: Entry)
    path = drive.Path(STREAMS, TRAFFIC, "cpu")
    assert made == [(2, 8, "cpu")] and path.rx is None
    assert path(np.zeros((2, 10), np.uint8)) == [[b"\n"], [b"\n"]]
    assert path.steps() == [3, 3] and path.acquired() == [False, True]
    assert drive.Path(CONFIG, TRAFFIC, "cpu").bank is None
    drive.Path(Spec().config("wideband3"), TRAFFIC, "cpu")
    assert made[-1] == (4, 8, "cpu")


def test_two_streams_run_correct(tiny_root):
    res, log = _run(tiny_root)
    assert res["correct"] is True, log
    assert res["checks"] == {"bad_frames": {"value": 0, "limit": 0},
                             "missing_frames": {"value": 0, "limit": 0}}
    lines = re.findall(r"^stream (\d+): (\d+) frames, (\d+) differ", log,
                       re.M)
    assert [(s, d) for s, _, d in lines] == [("0", "0"), ("1", "0")], log
    counts = [int(n) for _, n, _ in lines]
    assert min(counts) > 0 and res["attempted"] == sum(counts)
    assert "x 2 ensembles" in log
    assert {"realtime_x", "setup_s"} <= set(res["metrics"])


def test_two_streams_under_the_control_are_not_correct(tiny_root):
    res, log = _run(tiny_root, seed=SEED + 1, fault="flip")
    assert res["correct"] is False
    assert res["checks"]["bad_frames"]["value"] > 0
    bad = re.findall(r"^stream (\d+): \d+ frames, (\d+) differ", log, re.M)
    assert [s for s, _ in bad] == ["0", "1"]
    assert all(int(n) > 0 for _, n in bad), log


def test_two_streams_at_a_resampling_rate_are_refused(tiny_root):
    spec = Spec(tiny_root)
    traffic = dict(TRAFFIC, name="tiny2400", rate_hz=2400000)
    (tiny_root / "rxbench" / "traffic" / "tiny2400.json").write_text(
        json.dumps(traffic))
    spec.bench["workloads"].append(dict(STREAMS_CELL, name="tiny2.rtl",
                                        traffic="tiny2400"))
    with pytest.raises(ValueError, match="tiny2: 2 streams at 2400000 Hz"):
        _run(tiny_root, cell="tiny2.rtl", spec=spec)

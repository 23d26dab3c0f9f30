"""The port's host spans (``dabtools_tpu_torch/utils/spans.py``) on the CPU:
tracing changes no byte and no device step, the span tree of a receiver's
call, the bytes each copy span counts, the off path, and no profiler
event carrying a span's name."""

import functools

import numpy as np
import pytest
import torch

from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.cli.dab2eti import main as dab2eti
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.resample import Resampler
from dabtools_tpu_torch.utils import spans

torch.set_num_threads(2)

N_FRAMES = 4
BLOCK = trx.block_samples(N_FRAMES)


@pytest.fixture(autouse=True)
def tracer_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


@functools.cache
def _u8() -> np.ndarray:
    """14 frames of the closed-loop ensemble, impaired, as RTL-SDR u8."""
    rng = np.random.default_rng(5)
    x, _ = S.modulate(S.closed_loop_ensemble(), 14, rng)
    return S.impaired_u8(x, rng, 18.0, 350.0, 1234)


def _decode(traced: bool, monkeypatch=None):
    """The capture in two feeds, the second running every block; returns
    (ETI frames, device steps, the second feed's spans, the byte size of
    each ``to_host`` result)."""
    host_bytes = []
    if monkeypatch is not None:
        real = trx.to_host

        def counted(tree):
            out = real(tree)
            leaves = []

            def walk(node):
                for v in node.values():
                    walk(v) if isinstance(v, dict) else leaves.append(v)

            walk(out)
            host_bytes.append(sum(a.nbytes for a in leaves))
            return out

        monkeypatch.setattr(trx, "to_host", counted)
    rx = trx.DabReceiver(n_frames=N_FRAMES, device="cpu")
    u8 = _u8()
    if traced:
        spans.enable()
    eti = rx.feed(u8[:100_000])
    first = spans.drain()
    eti += rx.feed(u8[100_000:])
    spans.disable()
    assert len(first) == (1 if traced else 0)
    return eti, rx.device_steps, spans.drain(), host_bytes


def test_tracing_changes_no_byte_and_no_device_step():
    eti_off, steps_off, none, _ = _decode(False)
    eti_on, steps_on, done, _ = _decode(True)
    assert none == []
    assert eti_on == eti_off and len(eti_on) > 0
    assert steps_on == steps_off
    names = [s[0] for s in done]
    # acquisition replays the block that completes the MCI, with the MSC
    # decode on
    assert names.count("rx.block.acquire") == 1
    assert steps_on == names.count("rx.block") + 1


def test_span_tree_of_a_feed_that_runs_two_blocks(monkeypatch):
    _, _, done, host_bytes = _decode(True, monkeypatch)
    names = [s[0] for s in done]
    assert names[0] == "rx.feed" and done[0][3] is None
    assert [s for s in done if s[3] is None] == [done[0]]
    for name, t0, t1, parent, _ in done:
        assert t0 <= t1
        if parent is not None:
            p = done[parent]
            assert parent < done.index((name, t0, t1, parent, _))
            assert p[1] <= t0 and t1 <= p[2], (name, p[0])

    def children(i):
        return [s[0] for s in done if s[3] == i]

    blocks = [i for i, s in enumerate(done) if s[0] == "rx.block"]
    assert len(blocks) >= 2
    # the ring gathers the first block across the two feeds' chunks
    assert children(0) == ["rx.ring"] + ["rx.block"] * len(blocks)
    # the block that completes the MCI replays itself, inside its span
    replay = names.index("rx.block.acquire")
    acquired = done[replay][3]
    assert acquired in blocks
    per_block = ["rx.h2d", "rx.enqueue", "rx.wait", "rx.d2h", "rx.fic"]
    assert children(acquired) == per_block + ["rx.block.acquire"]
    for i in [replay] + blocks:
        if i != acquired:
            assert children(i) == per_block + ["rx.eti"]
    for i, s in enumerate(done):
        if s[0] == "rx.enqueue":
            assert children(i) == ["enqueue.sync", "enqueue.demod",
                                   "enqueue.viterbi", "enqueue.pack"]
    # copy spans count the uploaded block and to_host's flat buffer
    h2d = [s[4] for s in done if s[0] == "rx.h2d"]
    d2h = [s[4] for s in done if s[0] == "rx.d2h"]
    assert h2d == [2 * BLOCK] * len(h2d) and len(h2d) == len(blocks) + 1
    assert d2h == host_bytes and all(d2h)
    assert all(s[4] == 0 for s in done if not s[0].endswith(("h2d", "d2h")))


def test_to_host_counts_its_flat_buffer():
    tree = {"a": torch.arange(3, dtype=torch.int32),
            "b": {"c": torch.ones(5, dtype=torch.uint8)}}
    spans.enable()
    out = trx.to_host(tree)
    done = spans.drain()
    assert [s[0] for s in done] == ["rx.wait", "rx.d2h"]
    assert done[1][4] == 3 * 4 + 5
    np.testing.assert_array_equal(out["a"], [0, 1, 2])


def _unit_noise(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            / np.sqrt(2)).astype(np.complex64)


def _front_spans(front, x):
    spans.enable()
    y = front(x)
    spans.disable()
    done = spans.drain()
    assert done[0][0] == "frontend" and done[0][3] is None
    assert all(s[3] == 0 for s in done[1:])
    return y, done


@pytest.mark.parametrize("method", ["fft", "direct"])
def test_channelizer_copy_spans(method):
    fs, n = 8_192_000, 200_000
    offs = [-3_072_000, 1_712_000, 0]
    if method == "direct":
        offs[0] += 1000                        # off the fft method's grid
    ch = Channelizer(fs, offs, method=method, device="cpu")
    y, done = _front_spans(ch, _unit_noise(n, 3))
    names = [s[0] for s in done]
    if method == "fft":
        n_chunks = (n - ch.N_FFT) // ch.hop + 1
        up = [((n_chunks - 1) * ch.hop + ch.N_FFT) * 8, len(offs)
              * n_chunks * 8]
    else:
        used = ((n - ch.num_taps) // ch.decim + 1) * ch.decim
        up = [(used + ch.num_taps - 1) * 8]
    # the output stays on the device: no wait and no download
    assert names == ["frontend"] + ["frontend.h2d"] * len(up) + [
        "frontend.enqueue"]
    assert [s[4] for s in done if s[0] == "frontend.h2d"] == up
    assert torch.is_tensor(y) and y.shape[0] == len(offs) and y.numel()


def test_resampler_copy_spans():
    rs = Resampler(2_400_000, device="cpu")
    n = 120_000
    y, done = _front_spans(rs, _unit_noise(n, 4))
    # the output stays on the device: no wait and no download
    assert [s[0] for s in done] == ["frontend", "frontend.h2d",
                                    "frontend.enqueue"]
    # one upload, the new samples alone: the tail stays on the device and
    # the window indices are formed there
    assert done[1][4] == n * 8
    assert torch.is_tensor(y) and y.dim() == 1 and y.numel()


def test_resampler_uploads_its_tail_only_when_the_device_lacks_it():
    """After a call shorter than the tail, or one that completes no output,
    the device's tail is stale: the next call uploads the host's with the
    samples, in the same span.  An empty call changes no tail."""
    rs = Resampler(2_400_000, device="cpu")
    keep = rs.taps_per_phase - 1
    x = _unit_noise(10_000, 5)
    chunks = [(0, 4000), (4000, 4000), (4000, 4005), (4005, 6000)]
    chunks += [(a, a + 1) for a in range(6000, 6020)]
    up = []
    for a, b in chunks:
        stale = rs._tail_dev is None
        y, done = _front_spans(rs, x[a:b])
        h2d = [s[4] for s in done if s[0] == "frontend.h2d"]
        up.append(h2d)
        assert h2d == ([(b - a + keep * stale) * 8] if y.numel() else [])
    assert up[:4] == [[4000 * 8], [], [5 * 8], [(1995 + keep) * 8]]
    assert [] in up[4:]                    # a sample that completes nothing


def test_off_records_nothing_and_shares_one_object():
    assert spans.span("rx.feed") is spans.span("frontend", 7)
    with spans.span("rx.feed"):
        pass
    Resampler(2_400_000, device="cpu")(_unit_noise(20_000, 1))
    assert spans.drain() == []


def test_self_time_subtracts_children():
    done = [("a", 0, 100, None, 0), ("b", 10, 40, 0, 8),
            ("c", 20, 30, 1, 0), ("b", 50, 60, 0, 2)]
    assert spans.self_ns(done) == {"a": 60, "b": 30, "c": 10}


def test_no_profiler_event_carries_a_span_name():
    from torch.profiler import ProfilerActivity, profile
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        Resampler(2_400_000, device="cpu")(_unit_noise(20_000, 2))
        trx.to_host({"a": torch.ones(4)})
    names = {s[0] for s in spans.drain()}
    assert {"frontend", "frontend.h2d", "rx.d2h"} <= names
    assert not names & {e.name for e in prof.events()}


def test_cli_stats_logs_each_chunks_spans(tmp_path):
    x, _ = S.modulate(S.closed_loop_ensemble(), 14,
                      np.random.default_rng(6))
    cap = tmp_path / "cap.cf32"
    x.astype(np.complex64).tofile(cap)
    _, lines = S.run_cli(dab2eti, [
        "--format", "cf32", "--torch-device", "cpu", "--frames-per-block",
        str(N_FRAMES), "--stats", str(cap), "-o", str(tmp_path / "o.eti")])
    logged = [ln for ln in lines if "spans ms:" in ln]
    assert logged
    names = {kv.split("=")[0] for ln in logged
             for kv in ln.split("spans ms: ")[1].split(";")[0].split()}
    # 4 MiB chunks: most blocks are gathered across two of them
    assert names == {"rx.feed", "rx.ring", "rx.block", "rx.block.acquire",
                     "rx.h2d",
                     "rx.enqueue", "enqueue.sync", "enqueue.demod",
                     "demod.deinterleave", "demod.depuncture",
                     "enqueue.viterbi", "enqueue.pack", "rx.wait",
                     "rx.d2h", "rx.fic", "rx.eti"}
    assert all("MB" in ln for ln in logged)
    # the command turns the tracer off again when it returns
    assert spans.span("a") is spans.span("b") and spans.drain() == []

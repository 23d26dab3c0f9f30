"""The program's own spans in a traced run (``rxbench/spans.py``): the
tiny cell's traced run reports the copy values, an untraced run never
turns the tracer on and keeps its result keys, and the arithmetic of
self times, the idle split and the clock check on a synthetic
timeline."""

import io

import pytest

from rxbench import run, spans, trace
from rxbench.record import DeviceTrace
from rxbench.spec import Spec

from tiny import CELL, make_root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def test_traced_run_reports_the_copies(tiny_root):
    from dabtools_tpu_torch.utils import spans as tracer
    spec = Spec(tiny_root)
    real = (trace.HostSpans, trace.layer_ms, trace.breakdown, run.run_cell)
    res = spans.run_cell(spec, spec.cell(CELL["name"]), 7, 0.5,
                         device="cpu", log=io.StringIO())
    assert res["correct"] is True
    m = res["metrics"]
    assert {"h2d_ms", "d2h_ms", "copy_mb_per_block"} <= set(m)
    assert "frontend_host_ms" not in m           # no front end here
    assert m["copy_mb_per_block"]["unit"] == "MB"
    # at least one 8-frame u8 block of 2 bytes a sample a hand-over
    assert m["copy_mb_per_block"]["value"] >= 2 * (9 * 196608 + 4096) / 1e6
    assert {"ingest_ms", "enqueue_ms", "host_eti_ms"} <= set(m)
    assert tracer.span("a") is tracer.span("b")     # off again
    assert tracer.drain() == []
    assert (trace.HostSpans, trace.layer_ms, trace.breakdown,
            run.run_cell) == real


def test_untraced_run_never_turns_the_tracer_on(tiny_root, monkeypatch):
    from dabtools_tpu_torch.utils import spans as tracer

    def refuse():
        raise AssertionError("the tracer was turned on")

    monkeypatch.setattr(tracer, "enable", refuse)
    spec = Spec(tiny_root)
    res = run.run_cell(spec, spec.cell(CELL["name"]), 8, 0.5, False,
                       device="cpu", log=io.StringIO())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) <= {"realtime_x", "block_p95_ms", "setup_s"}
    assert tracer.drain() == []


# one hand-over [0, 1000] and one [2000, 2600] (ns): a front end with an
# upload, launches, a wait and a download, then a receiver's feed
SPANS = [("frontend", 100, 500, None, 0),
         ("frontend.h2d", 120, 220, 0, 4000),
         ("frontend.enqueue", 220, 260, 0, 0),
         ("frontend.wait", 260, 400, 0, 0),
         ("frontend.d2h", 400, 480, 0, 3000),
         ("rx.feed", 520, 980, None, 0),
         ("rx.block", 530, 970, 5, 0),
         ("rx.h2d", 540, 600, 6, 1000),
         ("rx.enqueue", 600, 700, 6, 0),
         ("rx.d2h", 800, 820, 6, 100),
         ("rx.feed", 2100, 2300, None, 0),
         ("rx.h2d", 2110, 2150, 10, 500),
         ("rx.feed", 5000, 5100, None, 0)]     # after the window


def test_self_times_and_values_on_a_timeline():
    per = spans.per_handover([(0, 1000), (2000, 2600)], SPANS)
    assert per[0]["self"] == {
        "frontend": 400 - 100 - 40 - 140 - 80, "frontend.h2d": 100,
        "frontend.enqueue": 40, "frontend.wait": 140, "frontend.d2h": 80,
        "rx.feed": 460 - 440, "rx.block": 440 - 60 - 100 - 20,
        "rx.h2d": 60, "rx.enqueue": 100, "rx.d2h": 20}
    assert per[0]["conversion"] == 100 and per[1]["conversion"] is None
    assert (per[0]["h2d"], per[0]["d2h"], per[0]["bytes"]) == (
        160, 100, 8100)
    assert (per[1]["h2d"], per[1]["d2h"], per[1]["bytes"]) == (40, 0, 500)
    assert per[1]["count"] == {"rx.feed": 1, "rx.h2d": 1}
    v = spans.metrics(per)
    assert v == pytest.approx({"h2d_ms": 100e-6, "d2h_ms": 50e-6,
                               "copy_mb_per_block": 4300e-6,
                               "frontend_host_ms": 20e-6})
    assert spans.metrics(spans.per_handover([(0, 1000)], [])) == {}


def test_idle_split_and_clock_check_on_a_timeline():
    # the device clock runs 10_000 ns ahead of perf_counter_ns
    off = 10_000
    ev = [("Memcpy HtoD (Pageable -> Device)", 10_125, 10_215),
          ("k", 10_215, 10_300),
          ("Memcpy DtoH (Device -> Pageable)", 10_405, 10_470),
          ("Memcpy HtoD (Pageable -> Device)", 10_545, 10_590),
          ("Memcpy DtoD (Device -> Device)", 10_700, 10_750),
          ("Memcpy HtoD (Pageable -> Device)", 12_000, 12_100)]
    dev = DeviceTrace(events=ev, window=(10_000, 11_000), offset=off,
                      handovers=1, steps=[])
    # on perf_counter_ns, idle [0, 125], [300, 405], [470, 545],
    # [590, 700] and [750, 1000], split at the span edges of SPANS
    want = {"loop": 100 + 20 + 20, "frontend": 20 + 20, "frontend.h2d": 5,
            "frontend.wait": 100, "frontend.d2h": 5 + 10,
            "rx.feed": 10 + 10, "rx.block": 10 + 50 + 150,
            "rx.h2d": 5 + 10, "rx.enqueue": 100, "rx.d2h": 20}
    got = spans.idle_by_span(dev, SPANS)
    assert len(got) == len(want) == spans.TOP
    assert [v for _, v in got] == sorted((v for _, v in got), reverse=True)
    for k, ns in want.items():
        assert dict(got)[f"idle in {k}"] == pytest.approx(ns / 1e9), k
    assert sum(v for _, v in got) == pytest.approx(
        (1000 - 175 - 65 - 45 - 50) / 1e9)
    # HtoD copies at 125 (in frontend.h2d) and 545 (in rx.h2d), and one
    # after the window; the DtoH copy at 405 (in frontend.d2h)
    assert spans.clock_check(dev, SPANS) == {"h2d": (2, 2, 0.0),
                                             "d2h": (1, 1, 0.0)}
    # a DtoH copy 30 ns after rx.d2h closed at 820
    dev.events = ev + [("Memcpy DtoH (Device -> Pageable)", 10_850,
                        10_900)]
    assert spans.clock_check(dev, SPANS, tol=20)["d2h"] == (2, 1, 0.03)
    assert spans.clock_check(dev, SPANS, tol=30)["d2h"] == (2, 2, 0.03)

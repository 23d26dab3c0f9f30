"""The harness on the CPU: cells, configurations and metrics found by
name, the result line's keys, the metric arithmetic on a recorded
timeline, a run without a card, and runs with the timed path broken
(the control among them) reading as not correct."""

import io
import json
import statistics
import subprocess
import sys

import pytest

from rxbench import run, trace
from rxbench.record import DeviceTrace, Record
from rxbench.spec import Spec

from tiny import CELL, ROOT, make_root

MS = 1_000_000


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("checkout"))


def _run(root, seed=11, seconds=1.0, traced=False, fault=None):
    spec = Spec(root)
    return run.run_cell(spec, spec.cell(CELL["name"]), seed, seconds,
                        traced, device="cpu", fault=fault, log=io.StringIO())


def test_new_files_are_found_by_name(tiny_root):
    spec = Spec(tiny_root)
    cell = spec.cell("tiny.short")
    assert spec.config(cell["config"])["name"] == "tiny"
    assert spec.traffic(cell["traffic"])["pool_frames"] == 6
    (tiny_root / "rxbench" / "metrics" / "new_metric.py").write_text(
        "def read(r):\n    return 2.0 * len(r.handovers)\n")
    spec.bench["end_to_end"].append({"name": "new_metric", "unit": "x",
                                     "better": "higher", "bound": 0.1,
                                     "source": "host_clock",
                                     "workloads": ["tiny.short"]})
    names = [m["name"] for m in spec.metrics("tiny.short", False)]
    assert names == ["realtime_x", "block_p95_ms", "setup_s", "new_metric"]
    e2e = [m["name"] for m in spec.metrics("flagship.dab2eti", False)]
    assert e2e == ["kernel_ms_per_air_s", "setup_s"]
    assert "block_p95_ms" in [m["name"] for m in
                              spec.metrics("flagship.archive64", False)]
    r = Record(config={}, traffic={}, setup_s=1.0, air_s=0.768, ensembles=1,
               window=(0, 1), handovers=[(0, 1)] * 3)
    assert spec.reader("new_metric").read(r) == 6.0
    per_layer = [m["name"] for m in spec.metrics("flagship.archive64", True)]
    assert "frontend_ms" not in per_layer and "ingest_ms" in per_layer
    assert [m["name"] for m in spec.metrics("flagship.rtl2400", False)] == [
        "kernel_ms_per_air_s", "setup_s"]
    per_layer = [m["name"] for m in spec.metrics("flagship.rtl2400", True)]
    assert "frontend_ms.host_paced" in per_layer
    assert "frontend_ms" not in per_layer
    per_layer = [m["name"] for m in spec.metrics("flagship.dab2eti", True)]
    assert "realtime_x.host_paced" in per_layer
    assert "ingest_ms" not in per_layer


def test_a_split_quantity_is_read_by_its_base(tiny_root):
    """``<base>.<variant>`` reads ``metrics/<base>.py`` unless the
    variant has a file of its own."""
    spec = Spec(tiny_root)
    r = Record(config={}, traffic={}, setup_s=1.0, air_s=0.768, ensembles=1,
               window=(0, 2 * MS), handovers=[(0, MS), (MS, 2 * MS)])
    assert spec.reader("realtime_x.host_paced").read(r) == pytest.approx(
        spec.reader("realtime_x").read(r))
    (tiny_root / "rxbench" / "metrics" / "realtime_x.own.py").write_text(
        "def read(r):\n    return -1.0\n")
    assert spec.reader("realtime_x.own").read(r) == -1.0


def test_result_line_and_a_sound_run(tiny_root):
    res = _run(tiny_root, seed=2**31 + 5)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) <= {"realtime_x", "block_p95_ms", "setup_s"}
    assert {"realtime_x", "setup_s"} <= set(res["metrics"])
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"] == {"bad_frames": {"value": 0, "limit": 0},
                             "missing_frames": {"value": 0, "limit": 0}}
    json.dumps(res)


def test_traced_run_reports_layers(tiny_root):
    res = _run(tiny_root, seed=3, traced=True)
    assert res["correct"] is True
    assert {"ingest_ms", "enqueue_ms", "host_eti_ms"} <= set(res["metrics"])
    assert "frontend_ms" not in res["metrics"]      # no front end here
    assert "realtime_x" not in res["metrics"]


@pytest.mark.parametrize("fault", ["flip", "stale", "half"])
def test_broken_timed_path_is_not_correct(tiny_root, fault):
    """``flip`` is the control: one payload bit altered per block."""
    res = _run(tiny_root, seed=19, fault=fault)
    assert res["correct"] is False
    assert res["checks"]["bad_frames"]["value"] > 0
    assert res["failed"] > 0


def test_metric_arithmetic_on_a_timeline():
    spec = Spec()
    # four hand-overs of 10, 20, 30 and 40 ms, with 5 ms of harness
    # between them: 115 ms of window
    hos, t = [], 0
    for ms in (10, 20, 30, 40):
        hos.append((t, t + ms * MS))
        t += (ms + 5) * MS
    r = Record(config={}, traffic={"frames_per_block": 8}, setup_s=12.5,
               air_s=0.768, ensembles=3, window=(hos[0][0], hos[-1][1]),
               handovers=hos)
    assert spec.reader("realtime_x").read(r) == pytest.approx(
        3 * 4 * 0.768 / 0.115)
    # linear interpolation, as numpy.percentile: 35 + 0.85 * 5 ms
    assert spec.reader("block_p95_ms").read(r) == pytest.approx(38.5)
    assert spec.reader("block_p95_ms").read(r) == pytest.approx(
        statistics.quantiles([10, 20, 30, 40], n=100,
                             method="inclusive")[94])
    assert spec.reader("setup_s").read(r) == 12.5
    # device: two overlapping kernels and a copy in a 100 us window
    ev = [("k1", 10_000, 30_000), ("k2", 20_000, 40_000),
          ("Memcpy HtoD", 70_000, 80_000), ("late", 95_000, 120_000)]
    r.device = DeviceTrace(events=ev, window=(0, 100_000), offset=0,
                           handovers=2, steps=[])
    assert r.device.busy() == [(10_000, 40_000), (70_000, 80_000),
                               (95_000, 100_000)]
    assert spec.reader("device_idle_pct").read(r) == pytest.approx(55.0)
    assert spec.reader("launches_per_block").read(r) == 2.0
    # kernels only: 30 us of k1 and k2, 5 us of "late" inside the window,
    # over 2 hand-overs of 0.768 s of air and 3 ensembles
    assert spec.reader("kernel_ms_per_air_s").read(r) == pytest.approx(
        0.035 / (2 * 0.768 * 3))
    r.layers = [{"ingest": 1.0, "enqueue": 4.0, "download": 1.0,
                 "host_eti": 2.0}, {"ingest": 3.0, "enqueue": 2.0,
                                    "download": 1.0, "host_eti": 4.0}]
    assert spec.reader("ingest_ms").read(r) == 2.0
    assert spec.reader("enqueue_ms").read(r) == 3.0
    assert spec.reader("host_eti_ms").read(r) == 3.0
    assert spec.reader("frontend_ms").read(r) is None


def test_layer_attribution_and_idle_labels():
    # one hand-over [0, 100]: front end to 20, then a feed [30, 90]
    # running two blocks
    hos = [(0, 100)]
    spans = [("frontend", 5, 20), ("feed", 30, 90),
             ("process_block", 35, 45), ("to_host", 46, 50),
             ("process_block", 60, 70), ("to_host", 70, 80)]
    (d,) = trace.layer_ms(hos, spans)
    assert d == {"frontend": 20e-6, "ingest": 5e-6, "enqueue": 21e-6,
                 "download": 14e-6, "host_eti": 20e-6}
    label = trace.Labeller(hos, spans)
    assert [label(t) for t in (2, 10, 32, 40, 48, 55, 85, 120)] == [
        "frontend", "frontend", "ingest", "enqueue", "download",
        "host_eti", "host_eti", "harness"]
    dev = DeviceTrace(events=[("a", 40, 50), ("b", 70, 80)],
                      window=(0, 100), offset=0, handovers=1, steps=[])
    b = trace.breakdown(dev, hos, spans)
    assert b["device_ops"] == [["a", 1e-8], ["b", 1e-8]]
    # gaps [0, 40], [50, 70], [80, 100], each labelled at its midpoint
    assert dict(b["idle_gaps"]) == {"idle in frontend": 4e-8,
                                    "idle in enqueue": 2e-8,
                                    "idle in host_eti": 2e-8}


def test_no_card_no_result():
    """Off the card only: with CUDA present the run has a card to use."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would use it")
    p = subprocess.run([sys.executable, "-m", "rxbench.run", "--workload",
                        "flagship.dab2eti", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "CUDA" in p.stderr

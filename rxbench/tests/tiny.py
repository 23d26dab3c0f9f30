"""Deployments small enough for the CPU: one 64 kbit/s EEP 3-A
sub-channel (``tiny``), and two independent SDR streams of one
sub-channel each at different protection (``tiny2``); a 6-frame pool,
8-frame blocks; and a checkout root that holds them beside copies of the
benchmark's metrics, as a later change would add a cell.  The tiny cells
report what ``flagship.archive64`` reports."""

from __future__ import annotations

import json
import pathlib
import shutil

HERE = pathlib.Path(__file__).resolve().parent
RXBENCH = HERE.parent
ROOT = RXBENCH.parent

CONFIG = {
    "name": "tiny", "mode": "I", "rate_hz": 2048000, "format": "u8",
    "center_hz": None,
    "receivers": [{"block": None, "ensemble": {
        "eid": 0x4FFF, "label": "TINY",
        "subchannels": [{"id": 1, "start_cu": 0, "protection": "EEP-3A",
                         "kbps": 64}],
        "services": [{"sid": 0x1234, "label": "SVC ONE", "subchid": 1}]}}],
}
STREAMS = {
    "name": "tiny2", "mode": "I", "rate_hz": 2048000, "format": "u8",
    "center_hz": None,
    "receivers": [{"block": None, "ensemble": {
        "eid": 0x4FF1, "label": "TINY A",
        "subchannels": [{"id": 1, "start_cu": 0, "protection": "EEP-3A",
                         "kbps": 64}],
        "services": [{"sid": 0x1241, "label": "SVC A", "subchid": 1}]}},
        {"block": None, "ensemble": {
            "eid": 0x4FF2, "label": "TINY B",
            "subchannels": [{"id": 5, "start_cu": 0,
                             "protection": "EEP-2B", "kbps": 32}],
            "services": [{"sid": 0x1242, "label": "SVC B",
                          "subchid": 5}]}}],
}
TRAFFIC = {"name": "tiny", "frames_per_block": 8, "rate_hz": None,
           "snr_db": 20.0, "cfo_hz_max": 500.0, "pool_frames": 6,
           "acquire_blocks": 6, "warmup_blocks": 1, "flush_blocks": 3,
           "trace_blocks": 1}
CELL = {"name": "tiny.short", "config": "tiny", "traffic": "tiny",
        "chips": 1, "why": "a CPU-sized cell"}
STREAMS_CELL = {"name": "tiny2.short", "config": "tiny2", "traffic": "tiny",
                "chips": 1, "why": "two CPU-sized streams"}


def make_root(tmp: pathlib.Path) -> pathlib.Path:
    """A checkout root at ``tmp`` whose BENCHMARK.json adds the tiny cells
    and whose ``rxbench/`` holds their files beside the real metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config, cell in ((CONFIG, CELL), (STREAMS, STREAMS_CELL)):
        name = config["name"]
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"rxbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flagship.archive64" in m.get("workloads", ()):
            m["workloads"] += [CELL["name"], STREAMS_CELL["name"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(RXBENCH / "metrics", tmp / "rxbench" / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind in ("configs", "traffic"):
        (tmp / "rxbench" / kind).mkdir(parents=True)
    for kind, obj in (("configs", CONFIG), ("configs", STREAMS),
                      ("traffic", TRAFFIC)):
        (tmp / "rxbench" / kind / f"{obj['name']}.json").write_text(
            json.dumps(obj))
    return tmp

"""The benchmark's definition, found by name: ``BENCHMARK.json`` at the
root of the checkout names each cell, its configuration and traffic mix
and its metrics; ``configs/<name>.json``, ``traffic/<name>.json`` and
``metrics/<name>.py`` under this folder hold each of them.  A cell, a
deployment, a traffic mix or a metric is added by adding its file and
its entry, with no edit here."""

from __future__ import annotations

import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent


class Spec:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files of the
    folder ``root/<data>`` that it names."""

    def __init__(self, root: pathlib.Path = ROOT, data: str = "rxbench"):
        self.root = pathlib.Path(root)
        self.data = self.root / data
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.data / kind / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The cell's metric entries: ``end_to_end`` without trace,
        ``per_layer`` with it; an entry with ``workloads`` only in the
        cells it lists."""
        entries = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """The module of ``metrics/<name>.py``: its ``read(record)`` gives
        the metric's value, or None where it finds nothing to read.  A
        quantity split by the end-to-end metric it moves, named
        ``<base>.<variant>``, is read by ``metrics/<base>.py`` unless
        the variant has a file of its own."""
        path = self.data / "metrics" / f"{name}.py"
        if not path.exists() and "." in name:
            path = self.data / "metrics" / f"{name.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            f"rxbench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

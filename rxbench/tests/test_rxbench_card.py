"""On the card (marker ``gpu``; skipped without CUDA): a short run of
each cell is correct, and the control (``--fault flip``) is not.

    python3 -m pytest -p no:cacheprovider rxbench/tests -m gpu
"""

import json
import subprocess
import sys

import pytest

from rxbench.spec import Spec

from tiny import ROOT

CELLS = ("flagship.dab2eti", "wideband3.dab2eti", "flagship.archive64",
         "flagship.rtl2400")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(cell, seed, *extra):
    p = subprocess.run([sys.executable, "-m", "rxbench.run", "--workload",
                        cell, "--seed", str(seed), "--seconds", "2",
                        *extra], cwd=ROOT, capture_output=True, text=True,
                       timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    res = _run(cell, 2**31 + 101)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    want = {m["name"] for m in Spec().metrics(cell, False)}
    assert set(res["metrics"]) == want


@pytest.mark.gpu
def test_control_on_the_card(card):
    res = _run("flagship.dab2eti", 2**31 + 103, "--fault", "flip")
    assert not res["correct"]
    assert res["checks"]["bad_frames"]["value"] > 0

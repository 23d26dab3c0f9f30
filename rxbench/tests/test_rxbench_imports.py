"""What a run loads: no top-level ``jax`` or ``dabtools_tpu`` (the JAX
package), compared as whole names, since ``dabtools_tpu_torch`` begins
with ``dabtools_tpu``; and the yardstick (generator, reference, metric
readers) imports nothing of the program."""

import subprocess
import sys

from rxbench import run

from tiny import ROOT, RXBENCH


def _python(code: str, tmp_path) -> list[str]:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env={
        "PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
        "PYTHONPATH": str(ROOT) + ":" + str(RXBENCH / "tests")},
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.split()


def test_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dabtools_tpu_torch_x", sys)
    assert "dabtools_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_a_cpu_run_loads_no_jax(tmp_path):
    """A whole run of the tiny cell on the CPU, as far as it goes
    without a card: the program is loaded, JAX and its package are not."""
    top = _python(
        "import io, pathlib, sys\n"
        "from rxbench import run\n"
        "from rxbench.spec import Spec\n"
        "from tiny import CELL, make_root\n"
        f"root = make_root(pathlib.Path({str(tmp_path)!r}))\n"
        "spec = Spec(root)\n"
        "res = run.run_cell(spec, spec.cell(CELL['name']), 4, 0.5, True,"
        " device='cpu', log=io.StringIO())\n"
        "assert res['correct'], res\n"
        "print(*sorted({m.split('.')[0] for m in sys.modules}))\n",
        tmp_path)
    assert "dabtools_tpu_torch" in top and "torch" in top
    assert not {"jax", "jaxlib", "flax", "dabtools_tpu"} & set(top)


def test_yardstick_imports_nothing_of_the_program(tmp_path):
    top = _python(
        "import sys\n"
        "import rxbench.reference, rxbench.record, rxbench.spec\n"
        "import rxbench.gen.pool, rxbench.gen.signals\n"
        "from rxbench.spec import Spec\n"
        "spec = Spec()\n"
        "for m in spec.bench['end_to_end'] + spec.bench['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "print(*sorted({m.split('.')[0] for m in sys.modules}))\n",
        tmp_path)
    assert not {"dabtools_tpu_torch", "dabtools_tpu", "jax", "torch"} \
        & set(top)

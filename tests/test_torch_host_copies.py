"""The port's copies of the JAX package's host modules.

``dabtools_tpu_torch`` imports nothing of ``dabtools_tpu``: the NumPy host
modules it needs are copied into it at the same relative path, verbatim
but for their import lines (``dabtools_tpu.`` becomes
``dabtools_tpu_torch.``).  One listed exception: ``utils/native.py``'s
docstring names the directory its library builds in, which is the port's
own ``native/`` (the code finds it relative to the module, unchanged).

Each copy is held against its original as text, and the copies' behaviour
against the originals' on one seed.
"""

import ast
import pathlib
import re

import numpy as np
import pytest

from dabtools_tpu import constants as jC
from dabtools_tpu.eti.assemble import EtiAssembler as JEtiAssembler
from dabtools_tpu.fic import config as jconfig
from dabtools_tpu.fic.fig import FigParser as JFigParser
from dabtools_tpu.fic.fig import build_fibs_for_ensemble as jbuild_fibs
from dabtools_tpu.mod.modulator import Modulator as JModulator
from dabtools_tpu.mod.modulator import SubchannelSource as JSource
from dabtools_tpu.utils.crc import crc16_ok_batch as jcrc16_ok_batch
from dabtools_tpu_torch import constants as tC
from dabtools_tpu_torch.eti.assemble import EtiAssembler
from dabtools_tpu_torch.fic import config as tconfig
from dabtools_tpu_torch.fic.fig import FigParser, build_fibs_for_ensemble
from dabtools_tpu_torch.mod.modulator import Modulator, SubchannelSource
from dabtools_tpu_torch.utils.crc import crc16_ok_batch

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "dabtools_tpu"
PORT_PKG = REPO / "dabtools_tpu_torch"

COPIED = [
    "constants.py",
    "tables/puncturing.py", "tables/time_interleave.py",
    "tables/freq_interleave.py", "tables/prs.py",
    "utils/crc.py", "utils/prbs.py", "utils/native.py", "utils/gf256.py",
    "native/dabhost.cc", "native/Makefile",
    "mod/convcode.py", "mod/impairments.py", "mod/modulator.py",
    "fic/config.py", "fic/fig.py",
    "eti/parse.py", "eti/assemble.py", "eti/edi.py",
    "tables/bandiii.py", "frontend/__init__.py", "frontend/rtlsdr.py",
]
# The one change besides import lines: where the native library builds.
EXCEPTIONS = {
    "utils/native.py": [("make -C dabtools_tpu/native",
                         "make -C dabtools_tpu_torch/native")],
}
_IMPORT = re.compile(r"^(\s*(?:from|import) )dabtools_tpu\b", re.MULTILINE)


def _as_copied(rel: str, text: str) -> str:
    """The original's text with its import lines rewritten (and the listed
    exceptions applied)."""
    text = _IMPORT.sub(r"\1dabtools_tpu_torch", text)
    for old, new in EXCEPTIONS.get(rel, []):
        assert text.count(old) == 1, (rel, old)
        text = text.replace(old, new)
    return text


@pytest.mark.parametrize("rel", COPIED)
def test_copy_differs_only_in_imports(rel):
    original = (JAX_PKG / rel).read_text()
    copy = (PORT_PKG / rel).read_text()
    assert copy == _as_copied(rel, original)
    # the port's copy never reaches back into the JAX package
    assert not re.search(r"^\s*(from|import) dabtools_tpu\b", copy,
                         re.MULTILINE)


def _top_level(path: pathlib.Path, name: str) -> str:
    src = path.read_text()
    for node in ast.parse(src).body:
        names = ([node.name] if isinstance(node, ast.FunctionDef) else
                 [t.id for t in getattr(node, "targets", [])
                  if isinstance(t, ast.Name)])
        if name in names:
            return ast.get_source_segment(src, node)
    raise LookupError(f"{name} not in {path}")


@pytest.mark.parametrize("name", ["CHUNK", "_FORMATS", "decode_iq",
                                  "iter_samples"])
def test_cli_input_readers_are_copies(name):
    rel = "cli/dab2eti.py"
    assert (_top_level(PORT_PKG / rel, name)
            == _top_level(JAX_PKG / rel, name))


def _ensembles():
    """The same two-sub-channel ensemble in each package's classes."""
    def build(cfg):
        return cfg.Ensemble(
            eid=0xC0DE, label="COPIES",
            subchannels=(cfg.Subchannel.eep(1, 0, 3, "A", 64),
                         cfg.Subchannel.uep(9, 48, table_index=2)),
            services=(cfg.Service(sid=0x101, label="ONE", components=(
                cfg.ServiceComponent(tmid=0, subchid=1),)),
                      cfg.Service(sid=0x102, label="NINE", components=(
                          cfg.ServiceComponent(tmid=0, subchid=9),))))
    return build(jconfig), build(tconfig)


def test_fibs_and_fig_parse_match():
    jens, tens = _ensembles()
    assert tens.to_dict() == jens.to_dict()
    jparse, tparse = JFigParser(), FigParser()
    for f in range(3):
        jf = jbuild_fibs(jens, f)
        tf = build_fibs_for_ensemble(tens, f)
        np.testing.assert_array_equal(tf, jf)
        for fib in tf:
            tparse.feed_fib(bytes(fib))
        for fib in jf:
            jparse.feed_fib(bytes(fib))
    assert tparse.have_mci() and jparse.have_mci()
    assert tparse.ensemble().to_dict() == jparse.ensemble().to_dict()


def test_modulator_samples_match():
    jens, tens = _ensembles()
    rng = np.random.default_rng(7)
    payload = [np.unpackbits(rng.integers(0, 256, size=(
        4, s.data_bytes), dtype=np.uint8), axis=-1)
        for s in jens.sorted_subchannels()]
    out = []
    for ens, mod_cls, src_cls, fibs in (
            (jens, JModulator, JSource, jbuild_fibs),
            (tens, Modulator, SubchannelSource, build_fibs_for_ensemble)):
        mod = mod_cls([src_cls(s.start_cu, s.profile)
                       for s in ens.sorted_subchannels()])
        out.append(mod.frames(1, lambda f, e=ens, b=fibs: b(e, f),
                              lambda f, i: payload[i]))
    assert out[0].dtype == out[1].dtype == np.complex64
    np.testing.assert_array_equal(out[1], out[0])


def test_eti_assembly_and_crc_match():
    jens, tens = _ensembles()
    rng = np.random.default_rng(8)
    n = 5
    fibs = [[rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
             for _ in range(3)] for _ in range(n)]
    subch = [{s.subchid: rng.integers(0, 256, s.data_bytes,
                                      dtype=np.uint8).tobytes()
              for s in jens.subchannels} for _ in range(n)]
    errs = [0, 1, 0, 2, 0]
    ref = JEtiAssembler(jens, jC.MODE_I, tist_start=0.25).frame_batch(
        fibs, subch, errs)
    got = EtiAssembler(tens, tC.MODE_I, tist_start=0.25).frame_batch(
        fibs, subch, errs)
    assert got == ref and len(got) == n
    blocks = rng.integers(0, 256, size=(64, 32), dtype=np.uint8)
    blocks[::3] = np.frombuffer(jbuild_fibs(jens, 0)[0].tobytes(),
                                np.uint8)
    np.testing.assert_array_equal(crc16_ok_batch(blocks),
                                  jcrc16_ok_batch(blocks))
    assert crc16_ok_batch(blocks)[::3].all()

"""The port's ETI-side commands against the JAX package's, on the CPU.

Each command of the lab chain (``dabmux``, ``etiinfo``, ``etiremux``,
``eti2edi``/``edi2eti``, ``eti2iq``, ``eti2audio``/``eti2mpa``) runs in
this process through ``main(argv)`` in both packages on the same input;
what they write must be byte-identical, and so must what they log (with
each run's own directory named ``DIR``).  Then the everything-mux's lab
chain through the port's commands alone, ``dab2eti`` on the CPU, held
against the dabmux ETI as ``chip_smoke.py``'s phase 13 holds it on the
card; and one point of the port's BER sweep against
``tools/ber_sweep.py``'s.
"""

import json
import pathlib

import pytest

from dabtools_tpu.cli import dabmux as jdabmux
from dabtools_tpu.cli import edi2eti as jedi2eti
from dabtools_tpu.cli import eti2audio as jeti2audio
from dabtools_tpu.cli import eti2edi as jeti2edi
from dabtools_tpu.cli import eti2iq as jeti2iq
from dabtools_tpu.cli import eti2mpa as jeti2mpa
from dabtools_tpu.cli import etiinfo as jetiinfo
from dabtools_tpu.cli import etiremux as jetiremux
from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.cli import (
    dabmux,
    edi2eti,
    eti2audio,
    eti2edi,
    eti2iq,
    eti2mpa,
    etiinfo,
    etiremux,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_CIFS = 64                     # the clean mux: the MOT object completes


def _both(tmp: pathlib.Path, jmain, tmain, argv) -> list:
    """``argv`` through the JAX command and the port's, each with ``DIR``
    in ``argv`` replaced by a directory of its own under ``tmp``: for
    each, (stdout, logged lines with that directory named ``DIR``, the
    directory)."""
    res = []
    for name, main in (("jax", jmain), ("port", tmain)):
        d = tmp / name
        d.mkdir(exist_ok=True)
        out, lines = S.run_cli(main, [a.replace("DIR", str(d))
                                      for a in argv])
        res.append((out, [line.replace(str(d), "DIR") for line in lines],
                    d))
    return res


def _files(d: pathlib.Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    """The JAX eti2audio turns on JAX's on-disk compilation cache unless
    told not to."""
    monkeypatch.setenv("DABTOOLS_JIT_CACHE", "off")


@pytest.fixture(scope="module")
def mux(tmp_path_factory) -> pathlib.Path:
    """The everything-mux's dabmux ETI (``N_CIFS`` CIFs), from the JAX
    command."""
    tmp = tmp_path_factory.mktemp("mux")
    obj = tmp / "epg.bin"
    obj.write_bytes(S.everything_object())
    cfg = tmp / "mux.json"
    cfg.write_text(json.dumps(S.everything_mux(obj)))
    eti = tmp / "mux.eti"
    S.run_cli(jdabmux.main, [str(cfg), "--cifs", str(N_CIFS), "-o",
                             str(eti)])
    return eti


@pytest.mark.parametrize("config", ["examples", "everything"])
def test_dabmux_eti_is_identical(tmp_path, config):
    if config == "examples":
        cfg = REPO / "examples" / "mux.json"
    else:
        obj = tmp_path / "epg.bin"
        obj.write_bytes(S.everything_object())
        cfg = tmp_path / "mux.json"
        cfg.write_text(json.dumps(S.everything_mux(obj)))
    (_, jlog, jd), (_, tlog, td) = _both(
        tmp_path, jdabmux.main, dabmux.main,
        [str(cfg), "--cifs", "24", "-o", "DIR/out.eti"])
    assert (td / "out.eti").read_bytes() == (jd / "out.eti").read_bytes()
    assert len((td / "out.eti").read_bytes()) == 24 * 6144
    assert tlog == jlog


@pytest.mark.parametrize("args", [[], ["--verbose"], ["--json"],
                                  ["--frames", "20"]])
def test_etiinfo_stdout_is_identical(tmp_path, mux, args):
    (jout, _, _), (tout, _, _) = _both(tmp_path, jetiinfo.main,
                                       etiinfo.main, [*args, str(mux)])
    assert tout == jout
    assert "EVERYTHING" in tout


@pytest.mark.parametrize("args", [["--keep", "1,3"], ["--drop", "2"]])
def test_etiremux_eti_is_identical(tmp_path, mux, args):
    (_, jlog, jd), (_, tlog, td) = _both(
        tmp_path, jetiremux.main, etiremux.main,
        [*args, str(mux), "-o", "DIR/out.eti"])
    got = (td / "out.eti").read_bytes()
    assert got == (jd / "out.eti").read_bytes() and got
    assert tlog == jlog


@pytest.mark.parametrize("args", [[], ["--pft-mtu", "400"],
                                  ["--pft-mtu", "400", "--pft-fec"]])
def test_eti2edi_edi2eti_bytes_are_identical(tmp_path, mux, args):
    (_, jlog, jd), (_, tlog, td) = _both(
        tmp_path, jeti2edi.main, eti2edi.main,
        [*args, str(mux), "-o", "DIR/out.edi"])
    assert (td / "out.edi").read_bytes() == (jd / "out.edi").read_bytes()
    assert tlog == jlog
    (_, jlog, jd), (_, tlog, td) = _both(
        tmp_path, jedi2eti.main, edi2eti.main,
        ["DIR/out.edi", "-o", "DIR/back.eti"])
    back = (td / "back.eti").read_bytes()
    assert back == (jd / "back.eti").read_bytes() == mux.read_bytes()
    assert tlog == jlog


@pytest.mark.parametrize("args", [
    ["--format", "cf32", "--snr", "12", "--cfo-hz", "350",
     "--multipath", "tu6", "--doppler-hz", "30"],
    ["--format", "u8", "--snr", "16", "--cfo-hz", "420",
     "--multipath", "0:0,5:-6", "--timing-offset", "1000"]])
def test_eti2iq_samples_are_identical(tmp_path, mux, args):
    (_, jlog, jd), (_, tlog, td) = _both(
        tmp_path, jeti2iq.main, eti2iq.main,
        [*args, "--frames", "4", str(mux), "-o", "DIR/out.iq"])
    got = (td / "out.iq").read_bytes()
    assert got == (jd / "out.iq").read_bytes() and got
    assert tlog == jlog


@pytest.mark.parametrize("args", [
    ["--all", "DIR/all"],
    ["--list", "-o", "DIR/none"],
    ["--sid", "0x1111", "--labels", "-o", "DIR/pop.mp2"],
    ["--sid", "0x1111", "--verify", "--stats-json", "DIR/stats.json",
     "-o", "DIR/pop.mp2"],
    ["--sid", "0x2222", "--verify", "--labels", "--stats-json",
     "DIR/stats.json", "-o", "DIR/news.aac"],
    ["--sid", "0x2222", "--adts", "-o", "DIR/news.adts"],
    ["--sid", "0xE1C00077", "--objects", "DIR/objects", "-o",
     "DIR/none"],
], ids=["all", "list", "labels", "verify-mp2", "verify-dabplus", "adts",
        "objects"])
def test_eti2audio_outputs_are_identical(tmp_path, mux, args):
    (jout, jlog, jd), (tout, tlog, td) = _both(
        tmp_path, jeti2audio.main, eti2audio.main, [*args, str(mux)])
    assert tout == jout
    assert tlog == jlog
    got = _files(td)
    assert got == _files(jd)
    if args[0] == "--all":
        assert got["all/0xE1C00077_EPGDATA_objects/epg.bin"] == \
            S.everything_object()
        assert {n.rsplit(".", 1)[-1] for n in got} >= {"mp2", "aac"}
    elif args[0] == "--list":
        assert "POPPLUS" in tout + "".join(tlog)
    else:
        assert got


def test_eti2mpa_stream_is_identical(tmp_path, mux):
    (_, jlog, jd), (_, tlog, td) = _both(
        tmp_path, jeti2mpa.main, eti2mpa.main,
        ["--sid", "0x1111", str(mux), "-o", "DIR/pop.mp2"])
    got = (td / "pop.mp2").read_bytes()
    assert got == (jd / "pop.mp2").read_bytes() and got[:2] == b"\xff\xfd"
    assert tlog == jlog


def test_lab_chain_through_the_port_on_the_cpu(tmp_path):
    """The everything-mux through the port's dabmux, eti2iq (u8, AWGN
    16 dB, CFO 420 Hz), dab2eti on the CPU (16-frame blocks), etiinfo
    and eti2audio, checked as ``chip_smoke.py``'s phase 13 checks it on
    the card: every off-air payload exact, FIG 0/14, ``epg.bin``, the DLS
    and DL Plus lines and the metadata."""
    res = S.lab_chain(tmp_path, "cpu")
    assert res["frames"] >= 48


def test_ber_point_matches_jax():
    """One waterfall point (10 dB, seed 0, 12 frames) of the port's sweep
    on the CPU against ``tools/ber_sweep.py``'s: every field equal but
    the wall time."""
    from tools import ber_sweep, torch_ber_sweep
    want = ber_sweep.run_point(10.0, 0.0, 12, 0)
    got = torch_ber_sweep.run_point(10.0, 0.0, 12, 0, device="cpu")
    assert set(got) == set(want)
    for rec in (got, want):
        del rec["wall_s"]
    assert got == want
    assert got["acquired"] and got["frame_decode_rate"] == 1.0

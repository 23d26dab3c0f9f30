"""Parity of the PyTorch port's receiver, checkpoints and CLI with the JAX
package, on the closed-loop fixtures (CPU).

The same captures (``tests/test_closed_loop.py``'s ``build_ensemble`` /
``modulate``, with NumPy-seeded impairments) go through both packages'
``process_block`` and ``DabReceiver``.  Decoded bytes (FIBs, sub-channel
payloads, ETI and EDI streams) must be identical; sync diagnostics agree
exactly where they are integers and to a stated tolerance where they are
floats that pass through an FFT.

The port keeps its own copy of the configuration classes, so an ensemble
crosses from the JAX package's classes to the port's through its dict
form (``_port``).
"""

import functools
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.fic.config import Ensemble, Service, ServiceComponent, Subchannel
from dabtools_tpu.mod.impairments import (
    awgn,
    carrier_offset,
    quantize_u8,
    timing_offset,
    u8_to_complex,
)
from dabtools_tpu.models import receiver as jrx
from dabtools_tpu_torch.fic import config as tconfig
from dabtools_tpu_torch.models import receiver as trx
from tests.test_closed_loop import build_ensemble, modulate

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _port(ens: Ensemble) -> tconfig.Ensemble:
    """The JAX package's ensemble as the port's (same configuration)."""
    return tconfig.Ensemble.from_dict(ens.to_dict())


def _impair(x, seed=99, delay=1234):
    rng = np.random.default_rng(seed)
    return timing_offset(carrier_offset(awgn(x, 18.0, rng), 350.0), delay)


@functools.cache
def _capture(kind: str):
    """(samples fed to the receivers, ensemble) for one fixture."""
    ens = build_ensemble()
    x, _ = modulate(ens, 14, seed=31)
    if kind == "clean":
        return x, ens
    x = _impair(x)
    if kind == "impaired":
        return x, ens
    u8 = quantize_u8(x)
    return (u8 if kind == "u8" else u8_to_complex(u8)), ens


@functools.cache
def _jax_eti(kind: str) -> tuple[bytes, ...]:
    x, _ = _capture(kind)
    rx = jrx.DabReceiver(n_frames=4)
    return tuple(rx.feed(x))


# ------------------------------------------------------------ process_block
def _jax_block(x, rings, cif, ens):
    out, rings, cif = jrx.process_block(
        jnp.asarray(x), rings, jnp.asarray(cif, jnp.int32),
        ensemble=ens.decode_config(), mode=C.MODE_I, n_frames=4)
    return {k: (np.asarray(v) if not isinstance(v, dict) else
                {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in out.items()}, rings, cif


def _torch_block(x, rings, cif, ens):
    out, rings, cif = trx.process_block(
        torch.from_numpy(x), rings, cif, ensemble=ens.decode_config(),
        mode=C.MODE_I, n_frames=4)
    return trx.to_host(out), rings, cif


def test_process_block_matches_jax():
    """Two consecutive blocks of a noisy capture with a CFO, each package
    carrying its own rings and CIF counter: FIB bytes and every
    fully-primed sub-channel row identical, sync diagnostics within
    tolerance."""
    ens = build_ensemble()
    x, payload = modulate(ens, 10, seed=17)
    x = _impair(x, seed=5, delay=0)
    n = trx.block_samples(4)
    step = 4 * C.MODE_I.frame_size
    jrings = {"1": np.zeros((16, ens.subchannel(1).profile.tx_bits),
                            np.float32)}
    trings = {"1": torch.from_numpy(jrings["1"].copy())}
    jcif, tcif = 0, torch.tensor(0, dtype=torch.int32)
    for blk in range(2):
        xb = x[blk * step: blk * step + n]
        jout, jrings, jcif = _jax_block(xb, jrings, jcif, ens)
        tout, trings, tcif = _torch_block(xb, trings, tcif, ens)
        assert int(tcif) == int(jcif) == 16 * (blk + 1)
        for key in ("null_start", "prs_offset", "fib_bytes"):
            np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
        rows = slice(15 if blk == 0 else 0, None)
        np.testing.assert_array_equal(tout["subch"]["1"][rows],
                                      jout["subch"]["1"][rows])
        np.testing.assert_allclose(tout["cfo_carriers"],
                                   jout["cfo_carriers"], atol=1e-4)
        for key in ("null_ratio", "prs_peak", "fic_metric"):
            np.testing.assert_allclose(tout[key], jout[key], rtol=1e-4,
                                       err_msg=key)
        np.testing.assert_allclose(tout["subch_metric"]["1"][rows],
                                   jout["subch_metric"]["1"][rows],
                                   rtol=1e-4)
        np.testing.assert_allclose(tout["delay_spread"],
                                   jout["delay_spread"], atol=1e-2)
        np.testing.assert_allclose(tout["cir_power"], jout["cir_power"],
                                   atol=1e-4 * jout["cir_power"].max())
        np.testing.assert_allclose(trings["1"].numpy(),
                                   np.asarray(jrings["1"]), atol=2e-4)
    # the second block's rows are logical frames 1..16, all real
    for j in range(16):
        assert tout["subch"]["1"][j].tobytes() == payload[1][1 + j].tobytes()


# --------------------------------------------------------------- receiver
@pytest.mark.parametrize("kind", ["clean", "impaired", "u8", "cf32"])
def test_eti_stream_identical_to_jax(kind):
    x, ens = _capture(kind)
    rx = trx.DabReceiver(n_frames=4, device="cpu")
    if kind == "u8":                     # odd split across two feeds
        cut = 2 * 23456 + 1
        eti = rx.feed(x[:cut]) + rx.feed(x[cut:])
    else:
        eti = rx.feed(x)
    ref = _jax_eti(kind)
    assert len(ref) > 0
    assert tuple(eti) == ref
    assert rx.ensemble.subchannels == _port(ens).subchannels
    assert all(s.fib_crc_bad == 0 for s in rx.stats[1:])
    assert rx.device_steps == len(rx.stats) + 1      # one acquisition replay


def test_reconfiguration_stream_identical_to_jax():
    """A mid-stream change of sub-channel organization: both receivers
    re-specialize at the same block and emit the same frames.  Across the
    seam a sub-channel's 16-CIF deinterleave mixes the two multiplexes,
    so its payload there is a decode of noise, where rounding-level
    differences in the soft bits may pick other near-tie paths; every
    frame whose payloads are the modulator's must be byte-identical, and
    the seam frames must agree in everything but those payloads."""
    from dabtools_tpu.eti.parse import EtiParser
    ens1 = build_ensemble()
    ens2 = Ensemble(eid=ens1.eid, label="TPU DAB",
                    subchannels=(Subchannel.eep(3, 96, 2, "B", 64),))
    x1, p1 = modulate(ens1, 10, seed=20)
    x2, p2 = modulate(ens2, 22, seed=21)
    x = np.concatenate([x1, x2])
    ref = jrx.DabReceiver(n_frames=4).feed(x)
    rx = trx.DabReceiver(n_frames=4, device="cpu")
    eti = rx.feed(x)
    assert rx.ensemble.subchannels == _port(ens2).subchannels
    assert len(eti) == len(ref) > 0
    sent = {r.tobytes() for r in p1[1]} | {r.tobytes() for r in p2[3]}
    seam = 0
    for raw_t, raw_j, ft, fj in zip(eti, ref,
                                    EtiParser().feed(b"".join(eti)),
                                    EtiParser().feed(b"".join(ref))):
        if all(fj.subchannel_data(sc) in sent for sc in fj.streams):
            assert raw_t == raw_j
        else:
            seam += 1
            assert (ft.fct, ft.fic, set(ft.streams)) == (
                fj.fct, fj.fic, set(fj.streams))
    assert len(eti) - seam >= 40      # the 23 merged-transient frames aside


@pytest.fixture
def debundled_32_3():
    """Temporarily remove the bundled (32 kbit/s, P3) UEP row from the
    port's table so its autoprobe has to identify it from the signal (the
    JAX package's table, which the modulator reads, keeps it)."""
    from dabtools_tpu_torch.tables import puncturing as P
    saved = P.UEP_PROFILES.pop((32, 3))
    P.enumerate_uep_candidates.cache_clear()
    yield saved
    P.UEP_PROFILES[(32, 3)] = saved
    P.enumerate_uep_candidates.cache_clear()


def test_uep_autoprobe_identifies_row_and_decodes(debundled_32_3):
    """The port's UEP autoprobe (probe rows deinterleaved on the device,
    one batched candidate decode, registration in the port's own table,
    replay with full continuity) under the assertions of the JAX
    package's ``tests/test_uep_autoprobe.py::TestReceiverAutoprobe``.  (A
    side by side run with the JAX receiver is left out: its candidate
    decode alone peaks at several GB.)"""
    from dabtools_tpu.eti.parse import EtiParser
    from dabtools_tpu.tables import puncturing as JP
    from dabtools_tpu_torch.tables import puncturing as P
    ens = Ensemble(
        eid=0x4EA7, label="AUTOPROBE",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),
                     Subchannel.uep(9, 48, table_index=2)))   # 32k P3
    x, payload = modulate(ens, 22, seed=5)
    assert (32, 3) not in P.UEP_PROFILES and (32, 3) in JP.UEP_PROFILES
    rx = trx.DabReceiver(n_frames=4, device="cpu")
    eti = rx.feed(x)
    got = P.UEP_PROFILES[(32, 3)]
    assert (got.regions, got.padding_bits) == (debundled_32_3.regions,
                                               debundled_32_3.padding_bits)
    frames = list(EtiParser().feed(b"".join(eti)))
    assert len(frames) >= 60
    a = rx._activation_cif
    k0 = next(k for k, f in enumerate(frames) if 9 in f.streams)
    assert k0 <= 2 * 4 * rx.n_frames          # identified within ~2 blocks
    for k, f in enumerate(frames):
        assert f.fct == (a + k) % 250, k       # contiguous, no restart
        assert f.subchannel_data(1) == payload[1][a + k].tobytes(), k
        if k >= k0:
            assert f.subchannel_data(9) == payload[9][a + k].tobytes(), k


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_resumes_across_packages(direction, tmp_path):
    """A checkpoint taken mid-stream by one package resumes in the other
    and the stream continues byte-identically (FCT continuity included):
    JAX dict -> port ``restore``; port ``save_checkpoint`` file -> JAX
    ``load_checkpoint``."""
    ens = Ensemble(
        eid=0xD00D, label="TWO SUBCH",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),
                     Subchannel.eep(9, 48, 2, "B", 64)),
        services=(Service(sid=1, components=(
            ServiceComponent(tmid=0, subchid=1),)),
                  Service(sid=2, components=(
                      ServiceComponent(tmid=0, subchid=9, ascty=63),))))
    x, _ = modulate(ens, 16, seed=7)
    ref = jrx.DabReceiver(n_frames=4).feed(x)
    half = 9 * C.MODE_I.frame_size + 100
    if direction == "jax_to_torch":
        rx1 = jrx.DabReceiver(n_frames=4)
        eti = rx1.feed(x[:half])
        ckpt = rx1.checkpoint()
        ckpt["ensemble"] = _port(ckpt["ensemble"])
        rx2 = trx.DabReceiver(n_frames=4, device="cpu")
        rx2.restore(ckpt)
        assert rx2._rings["1"].device.type == "cpu"
    else:
        rx1 = trx.DabReceiver(n_frames=4, device="cpu")
        eti = rx1.feed(x[:half])
        path = tmp_path / "rx.ckpt.npz"
        rx1.save_checkpoint(path)
        rx2 = jrx.DabReceiver.load_checkpoint(path, n_frames=4)
    assert eti, "the checkpoint must be taken after activation"
    eti += rx2.feed(np.concatenate([rx1.pending_samples(), x[half:]]))
    assert len(eti) >= 10
    assert eti == ref


def test_port_checkpoint_file_roundtrip(tmp_path):
    x, ens = _capture("clean")
    rx1 = trx.DabReceiver(n_frames=4, device="cpu")
    half = 9 * C.MODE_I.frame_size + 77
    eti = rx1.feed(x[:half])
    path = tmp_path / "rx.ckpt.npz"
    rx1.save_checkpoint(path)
    rx2 = trx.DabReceiver.load_checkpoint(path, n_frames=4, device="cpu")
    assert rx2.ensemble == rx1.ensemble
    state = trx.from_jax_state(rx1.checkpoint(), "cpu")
    assert torch.is_tensor(state["rings"]["1"])
    eti += rx2.feed(np.concatenate([rx1.pending_samples(), x[half:]]))
    assert tuple(eti) == _jax_eti("clean")


def test_receiver_requires_device_and_rejects_tii():
    """The device is required; TII is reported only when asked for at
    construction, and only once a block has been decoded."""
    with pytest.raises(TypeError):
        trx.DabReceiver(n_frames=4)
    x, _ = _capture("clean")
    rx = trx.DabReceiver(n_frames=4, device="cpu")
    assert rx.tii() is None
    rx = trx.DabReceiver(n_frames=4, tii=True, device="cpu")
    assert rx.tii() is None
    rx.feed(x[: trx.block_samples(4)])
    assert rx._tii_floor > 0 and rx._tii_powers.shape == (24, 8)
    assert rx.tii() is None                  # the capture carries no TII


# -------------------------------------------------------------------- CLI
@pytest.mark.parametrize("fmt", ["eti", "edi"])
def test_cli_matches_jax_receiver(fmt, tmp_path):
    from dabtools_tpu_torch.cli.dab2eti import main
    x, _ = _capture("clean")
    cap = tmp_path / "cap.cf32"
    x.astype(np.complex64).tofile(cap)
    out = tmp_path / f"out.{fmt}"
    stats = tmp_path / "stats.jsonl"
    argv = ["--format", "cf32", "--torch-device", "cpu",
            "--frames-per-block", "4", "--stats-json", str(stats),
            str(cap), "-o", str(out)]
    if fmt == "edi":
        argv.append("--edi")
    assert main(argv) == 0
    ref = b"".join(_jax_eti("clean"))
    if fmt == "edi":
        from dabtools_tpu.eti.edi import EdiWriter
        w = EdiWriter(mode=C.MODE_I)
        ref = b"".join(pkt for frame in _jax_eti("clean")
                       for pkt in w.from_eti_bytes(frame))
    assert out.read_bytes() == ref
    recs = [json.loads(line) for line in stats.read_text().splitlines()]
    assert recs and all("snr_db" in r and "subch1_metric_mean" in r
                        for r in recs[1:])


@pytest.mark.parametrize("args", [["--tii", "--tist", "--tist-epoch", "5"],
                                  ["--rate", "2400000", "--device",
                                   "rtlsdr"],
                                  ["--wideband", "200e6", "--device",
                                   "rtlsdr", "--frequency", "200e6"],
                                  ["--device", "rtlsdr"],
                                  ["--tist", "--tist-utc"]])
def test_cli_rejects_unported_options(args, capsys):
    """Every input flag is ported now; what the CLI rejects are the JAX
    CLI's usage errors, before it opens any file."""
    from dabtools_tpu_torch.cli.dab2eti import main
    with pytest.raises(SystemExit) as exc:
        main(["--torch-device", "cpu", *args, "nonexistent.iq"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("requires --frequency" in err or "mutually exclusive" in err
            or "does not drive an SDR" in err)
    assert "not ported" not in err


def test_cli_cuda_missing_is_an_error(capsys):
    from dabtools_tpu_torch.cli.dab2eti import main
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the error path needs none")
    with pytest.raises(SystemExit) as exc:
        main(["nonexistent.iq"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


# ----------------------------------------------------------------- no JAX
_NO_JAX = """
import importlib, json, pkgutil, sys
jaxmods = lambda: {m for m in sys.modules if m == "jax" or m.startswith("jax.")}
before = jaxmods()
import dabtools_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dabtools_tpu_torch.__path__,
                                               "dabtools_tpu_torch.")]
for name in names + ["chip_smoke", "tests.torch_distributed_worker"]:
    importlib.import_module(name)
imported = jaxmods() - before
# the smoke's host-side signal path, run on a small signal and on the CPU
import numpy as np
from dabtools_tpu_torch import testsignal as S
rng = np.random.default_rng(0)
ens = S.flagship_ensemble()
x, payloads = S.modulate(ens, 1, rng)
u8 = S.impaired_u8(x, rng, 20.0, 300.0, 100)
msgs, jobs = S.flagship_codewords(rng, "cpu")
print(json.dumps({"added": sorted(imported), "names": names,
                  "ran": sorted(jaxmods() - before),
                  "shapes": [list(u8.shape), [list(j.shape) for j in jobs]],
                  "ref": sorted(m for m in sys.modules
                                if m == "dabtools_tpu"
                                or m.startswith("dabtools_tpu."))}))
"""


def test_port_imports_no_jax():
    """Importing every module of the port, chip_smoke.py and the
    two-process tests' worker, and then running the smoke's host-side
    signal helpers, adds no ``jax`` module and no module of the JAX
    package at all: the port runs on its own copies of the host
    modules."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300,
                       check=True)
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert "dabtools_tpu_torch.models.receiver" in res["names"]
    assert "dabtools_tpu_torch.ops.viterbi_cuda" in res["names"]
    assert "dabtools_tpu_torch.testsignal" in res["names"]
    assert "dabtools_tpu_torch.fic.fig" in res["names"]
    for name in ("ops.tii", "ops.fir", "ops.resample", "parallel.channel",
                 "cli.dabscan", "frontend.rtlsdr", "tables.bandiii",
                 "ops.rs", "eti.dabplus", "parallel.mesh",
                 "parallel.timeblock"):
        assert f"dabtools_tpu_torch.{name}" in res["names"]
    assert res["added"] == []
    assert res["ran"] == []
    assert res["ref"] == []
    assert res["shapes"][1] == [[64, 3096], [576, 12312]]

"""Parity of the PyTorch port's multi-stream paths and CLI input flags
with the JAX package (CPU): ``channel_parallel_block``, ``dabscan``, and
``dab2eti --tii``, ``--rate``, ``--wideband`` and ``--device rtlsdr``.

Captures are small: ``tests/test_closed_loop.py``'s one-sub-channel
ensemble, 4-frame blocks, 3 channels, an 8.192 Msps capture of about a
second.  Bytes must be identical (FIB bytes, fully primed sub-channel
rows, ETI payloads); float diagnostics agree within ``atol=2e-4,
rtol=1e-4``.  The port's CLIs run in-process through ``main(argv)``.
"""

import contextlib
import functools
import io
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.fic.config import Ensemble, Subchannel
from dabtools_tpu.mod.impairments import (
    awgn,
    carrier_offset,
    quantize_u8,
)
from dabtools_tpu.models import receiver as jrx
from dabtools_tpu.parallel.channel import channel_parallel_block as jcpb
from dabtools_tpu.tables.bandiii import BAND_III
from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.fic import config as tconfig
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.parallel import channel as tchannel
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_tii import _ensemble, _modulate

torch.set_num_threads(2)

N_CH = 3
FRAME = C.MODE_I.frame_size


def _port(ens: Ensemble) -> tconfig.Ensemble:
    return tconfig.Ensemble.from_dict(ens.to_dict())


@functools.cache
def _streams():
    """3 streams of one 11-frame modulation, each with its own CFO, start
    (inside frame 0, so the first whole frame is frame 1) and noise seed;
    (n_channels, room for 2 blocks of 4 frames) complex64."""
    ens = build_ensemble()
    x, payload = modulate(ens, 11, seed=3)
    n = trx.block_samples(4) + 5 * FRAME
    xs = []
    for c, (cfo, start) in enumerate(((200.0, 300), (-350.0, 1500),
                                      (50.0, 7000))):
        y = carrier_offset(x[start:], cfo)
        xs.append(awgn(y, 15.0, np.random.default_rng(c))[:n])
    return np.stack(xs), ens, payload


def _jax_out(out):
    return {k: (np.asarray(v) if not isinstance(v, dict) else
                {kk: np.asarray(vv) for kk, vv in v.items()})
            for k, v in out.items()}


def test_channel_parallel_block_matches_jax_and_process_block():
    """Two consecutive batched blocks, rings carried: bytes equal the JAX
    ``channel_parallel_block``'s (FIB bytes, every fully primed row) and
    the port's per-stream ``process_block``'s (every row, and the rings);
    float diagnostics within tolerance; rows after priming equal the
    modulator's payload."""
    x, ens, payload = _streams()
    tens = _port(ens)
    nb = ens.subchannel(1).profile.tx_bits
    n = trx.block_samples(4)
    jrings = {"1": np.zeros((N_CH, 16, nb), np.float32)}
    trings = {"1": torch.zeros((N_CH, 16, nb))}
    srings = [{"1": torch.zeros((16, nb))} for _ in range(N_CH)]
    jcif, tcif = jnp.asarray(0, jnp.int32), torch.tensor(0, dtype=torch.int32)
    adv = [0] * N_CH
    for blk in range(2):
        xb = np.stack([x[c, adv[c]: adv[c] + n] for c in range(N_CH)])
        jout, jrings, jcif = jcpb(jnp.asarray(xb), jrings, jcif,
                                  ensemble=ens.decode_config(), n_frames=4)
        jout = _jax_out(jout)
        tout, trings, tcif = tchannel.channel_parallel_block(
            torch.from_numpy(xb), trings, tcif,
            ensemble=tens.decode_config(), n_frames=4)
        tout = trx.to_host(tout)
        assert int(tcif) == int(jcif) == 16 * (blk + 1)
        assert tout["fib_bytes"].shape == (N_CH, 4, 12, 32)
        assert trings["1"].shape == (N_CH, 16, nb)
        for key in ("null_start", "prs_offset", "fib_bytes"):
            np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
        rows = slice(15 if blk == 0 else 0, None)
        np.testing.assert_array_equal(tout["subch"]["1"][:, rows],
                                      jout["subch"]["1"][:, rows])
        for key in ("cfo_carriers", "null_ratio", "prs_peak", "fic_metric",
                    "delay_spread"):
            np.testing.assert_allclose(tout[key], jout[key], atol=2e-4,
                                       rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(tout["subch_metric"]["1"][:, rows],
                                   jout["subch_metric"]["1"][:, rows],
                                   atol=2e-4, rtol=1e-4)
        for c in range(N_CH):
            sout, srings[c], scif = trx.process_block(
                torch.from_numpy(xb[c]), srings[c],
                torch.tensor(16 * blk, dtype=torch.int32),
                ensemble=tens.decode_config(), n_frames=4)
            sout = trx.to_host(sout)
            assert int(scif) == int(tcif)
            np.testing.assert_array_equal(tout["fib_bytes"][c],
                                          sout["fib_bytes"])
            np.testing.assert_array_equal(tout["subch"]["1"][c],
                                          sout["subch"]["1"])
            assert torch.equal(trings["1"][c], srings[c]["1"])
            adv[c] += int(sout["null_start"]) + 4 * FRAME - 4096
    # block 2's rows are logical frames 1..16 after the first whole frame
    for c in range(N_CH):
        for j in range(16):
            assert (tout["subch"]["1"][c, j].tobytes()
                    == payload[1][4 + 1 + j].tobytes())


def test_channel_parallel_fic_only_pass_matches_jax():
    x, _, _ = _streams()
    xb = x[:, : trx.block_samples(4)]
    jout, jrings, _ = jcpb(jnp.asarray(xb), {}, jnp.asarray(0, jnp.int32),
                           ensemble=None, n_frames=4)
    tout, trings, tcif = tchannel.channel_parallel_block(
        torch.from_numpy(xb), {}, torch.tensor(0, dtype=torch.int32),
        ensemble=None, n_frames=4)
    tout = trx.to_host(tout)
    assert trings == {} and tout["subch"] == {} and int(tcif) == 16
    np.testing.assert_array_equal(tout["fib_bytes"],
                                  np.asarray(jout["fib_bytes"]))
    np.testing.assert_allclose(tout["null_ratio"],
                               np.asarray(jout["null_ratio"]), atol=2e-4,
                               rtol=1e-4)


def test_channel_parallel_block_is_one_viterbi_dispatch(monkeypatch):
    """Every stream's FIC and MSC codewords reach the Viterbi in ONE
    ragged dispatch: N_CH x (16 FIC + 16 MSC) lanes for 4-frame blocks."""
    x, ens, _ = _streams()
    calls = []
    real = tchannel.viterbi_decode_ragged

    def counting(softs):
        calls.append(sum(s.shape[0] for s in softs))
        return real(softs)

    monkeypatch.setattr(tchannel, "viterbi_decode_ragged", counting)
    nb = ens.subchannel(1).profile.tx_bits
    tchannel.channel_parallel_block(
        torch.from_numpy(x[:, : trx.block_samples(4)]),
        {"1": torch.zeros((N_CH, 16, nb))},
        torch.tensor(0, dtype=torch.int32),
        ensemble=_port(ens).decode_config(), n_frames=4)
    assert calls == [N_CH * (16 + 16)]


# ---------------------------------------------------------------- dabscan
def _scan_capture(tmp_dir):
    """8.192 Msps at 184.5 MHz: the small ensemble in 6A, another in 6C,
    6B and 6D empty (the JAX dabscan test's capture)."""
    import pathlib
    fs, center = 8_192_000, 184.5e6
    factor = fs // C.SAMPLE_RATE
    ens_b = Ensemble(eid=0xB10C, label="BLOCK B",
                     subchannels=(Subchannel.eep(4, 0, 2, "B", 64),))
    xa, _ = modulate(build_ensemble(), 8, seed=1)
    xb, _ = modulate(ens_b, 8, seed=2)
    wide = (S.upconvert(xa, factor, BAND_III["6A"] - center, fs)
            + S.upconvert(xb, factor, BAND_III["6C"] - center, fs)) * 0.5
    cap = pathlib.Path(tmp_dir) / "wide.cf32"
    wide.astype(np.complex64).tofile(cap)
    return cap


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def test_dabscan_matches_jax(tmp_path, monkeypatch, capsys):
    from dabtools_tpu.cli.dabscan import main as jmain
    from dabtools_tpu_torch.cli.dabscan import main as tmain
    cap = _scan_capture(str(tmp_path))
    common = ["--center", "184.5e6", "--rate", "8.192e6", "--seconds",
              "0.8", str(cap)]
    # the JAX CLI would turn on its on-disk compile cache in this process
    monkeypatch.setenv("DABTOOLS_JIT_CACHE", "off")
    rc_j, ref = _run(jmain, ["--cpu", "--json", *common])
    rc_t, got = _run(tmain, ["--torch-device", "cpu", "--json", *common])
    assert rc_t == rc_j == 0
    ref = [json.loads(line) for line in ref]
    got = [json.loads(line) for line in got]
    assert [r["block"] for r in got] == ["6A", "6B", "6C", "6D"]
    # rounded floats may round the other way: one step of their rounding
    floats = {"null_ratio": 0.0, "snr_db": 0.1, "delay_spread_us": 0.02}
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k not in floats} == {
            k: v for k, v in r.items() if k not in floats}
        for k, atol in floats.items():
            if k in r:
                np.testing.assert_allclose(g[k], r[k], atol=atol + 1e-9,
                                           rtol=1e-4, err_msg=k)
    assert [r.get("eid") for r in got] == ["0x4FFF", None, "0xB10C", None]
    rc_t, text = _run(tmain, ["--torch-device", "cpu", *common])
    assert rc_t == 0
    lines = {line[:2]: line for line in text}
    assert "0x4FFF" in lines["6A"] and "TPU DAB" in lines["6A"]
    assert "0xB10C" in lines["6C"] and "BLOCK B" in lines["6C"]
    assert "--" in lines["6B"]
    assert "2 ensemble(s) found" in capsys.readouterr().err


# ---------------------------------------------------------------- dab2eti
def _dab2eti(argv, caplog):
    from dabtools_tpu_torch.cli.dab2eti import main
    with caplog.at_level(logging.INFO, logger="dabtools_tpu_torch.dab2eti"):
        rc = main(["--torch-device", "cpu", "--frames-per-block", "4",
                   *argv])
    return rc, [r.getMessage() for r in caplog.records
                if r.name == "dabtools_tpu_torch.dab2eti"]


def _payloads_match(eti: bytes, payload: dict) -> int:
    """ETI frames against the modulator's rows, from wherever the stream
    starts; returns the number of frames checked."""
    frames = [eti[k:k + 6144] for k in range(0, len(eti), 6144)]
    return S.check_eti_payloads(frames, payload,
                                S.first_payload_cif(eti, payload))


def test_dab2eti_tii_cli(tmp_path, caplog):
    """``--tii``: the same ETI bytes and the same TII log line as the JAX
    receiver on the same capture."""
    ens = _ensemble()
    x = _modulate(ens, 10, tii=(5, 17), seed=6)
    cap = tmp_path / "tii.cf32"
    x.astype(np.complex64).tofile(cap)
    out = tmp_path / "out.eti"
    rc, logs = _dab2eti(["--format", "cf32", "--tii", str(cap), "-o",
                         str(out)], caplog)
    assert rc == 0
    jr = jrx.DabReceiver(n_frames=4, tii=True)
    assert out.read_bytes() == b"".join(jr.feed(x))
    det = jr.tii()
    assert (det.main_id, det.sub_id) == (17, 5)
    want = (f"TII: main id {det.main_id}, sub id {det.sub_id} "
            f"(snr {det.snr:.1f})")
    assert want in logs


def test_dab2eti_rate_cli(tmp_path, caplog):
    """``--rate 2400000``: a 2.4 Msps capture through the resampler gives
    the modulator's payloads."""
    ens = build_ensemble()
    x, payload = modulate(ens, 12, seed=32)
    cap24 = S.fft_resample(x, int(round(x.size * 75 / 64)))
    cap = tmp_path / "native24.cf32"
    cap24.tofile(cap)
    out = tmp_path / "out.eti"
    rc, logs = _dab2eti(["--format", "cf32", "--rate", "2400000",
                         str(cap), "-o", str(out)], caplog)
    assert rc == 0
    assert "resampling 2.4000 Msps -> 2.048 Msps (L/M = 64/75)" in logs
    assert _payloads_match(out.read_bytes(), payload) >= 4


@pytest.mark.parametrize("fmt", ["eti", "edi"])
def test_dab2eti_wideband_cli(fmt, tmp_path, caplog):
    """``--wideband`` with ``--blocks``: one file per block, each holding
    its own ensemble's payloads (as EDI, the same frames packetized)."""
    fs, center = 8_192_000, 178_352_000        # 5C; 5B/5D at -/+1.712 MHz
    factor = fs // C.SAMPLE_RATE
    ens_b = Ensemble(eid=0xB10C, label="BLOCK B",
                     subchannels=(Subchannel.eep(4, 0, 2, "B", 64),))
    xa, pa = modulate(build_ensemble(), 14, seed=31)
    xb, pb = modulate(ens_b, 14, seed=32)
    wide = (S.upconvert(xa, factor, -1_712_000, fs)
            + S.upconvert(xb, factor, +1_712_000, fs)) * 0.5
    cap = tmp_path / "wide.u8"
    quantize_u8(wide).tofile(cap)
    outdir = tmp_path / "out"
    argv = ["--format", "u8", "--wideband", str(center), "--rate", str(fs),
            "--blocks", "5B,5D", str(cap), "-o", str(outdir)]
    rc, logs = _dab2eti(argv + (["--edi"] if fmt == "edi" else []), caplog)
    assert rc == 0
    assert any(m.startswith("block 5B") and "0x4FFF" in m for m in logs)
    assert any(m.startswith("block 5D") and "0xB10C" in m for m in logs)
    assert not (outdir / f"5C.{fmt}").exists()
    if fmt == "edi":
        assert (outdir / "5B.edi").stat().st_size > 0
        return
    for block, payload in (("5B", pa), ("5D", pb)):
        assert _payloads_match((outdir / f"{block}.eti").read_bytes(),
                               payload) >= 4


@pytest.mark.parametrize("argv,msg", [
    (["--blocks", "9Z", "-o", "DIR"], "not inside"),
    (["-o", "-"], "-o must be a directory"),
    (["--rate", "3000000", "-o", "DIR"], "needs --rate"),
])
def test_dab2eti_wideband_cli_errors(argv, msg, tmp_path, caplog):
    cap = tmp_path / "x.cf32"
    np.zeros(4096, np.complex64).tofile(cap)
    argv = [str(tmp_path / "d") if a == "DIR" else a for a in argv]
    if "--rate" not in argv:
        argv += ["--rate", "8192000"]
    rc, logs = _dab2eti(["--format", "cf32", "--wideband", "178352000",
                         *argv, str(cap)], caplog)
    assert rc == 2
    assert any(msg in m for m in logs)


def test_dab2eti_rtlsdr_via_fake_dongle(tmp_path, monkeypatch, caplog):
    """``--device rtlsdr`` through the JAX test's fake librtlsdr: the
    dongle's u8 stream decodes to the modulator's payloads, and the
    dongle was tuned and set up as asked."""
    import dabtools_tpu_torch.frontend.rtlsdr as R
    from tests.test_rtlsdr import FakeRtlSdr
    ens = build_ensemble()
    x, payload = modulate(ens, 14, seed=9)
    fake = FakeRtlSdr(quantize_u8(x).tobytes())
    monkeypatch.setattr(R, "load_librtlsdr", lambda path=None: fake)
    # the whole capture is in the ring at once: end the stream after 1 s
    # without new data instead of the live default of 5 s
    read_block = R.RtlSdrSource.read_block
    monkeypatch.setattr(R.RtlSdrSource, "read_block",
                        lambda self, n: read_block(self, n, timeout_s=1.0))
    out = tmp_path / "live.eti"
    rc, _ = _dab2eti(["--device", "rtlsdr", "--frequency", "227360000",
                      "--gain", "19.7", "-o", str(out)], caplog)
    assert rc == 0
    assert ("freq", 227_360_000) in fake.calls
    assert ("rate", 2_048_000) in fake.calls and ("gain", 197) in fake.calls
    assert fake.calls[-1] == ("close",)
    assert _payloads_match(out.read_bytes(), payload) >= 4

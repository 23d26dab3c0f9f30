"""The port's receiver under ``tests/test_robustness.py``'s impairments,
held against the JAX receiver (CPU).

The same fixtures (ensemble, seeds, SNRs, CFOs) go through
``dabtools_tpu.models.receiver.DabReceiver(n_frames=4)`` and the port's
``DabReceiver(n_frames=4, device="cpu")``: the SNR threshold, a CFO of
4.3 carriers and the half-carrier boundary, sync loss across a gap of
noise with its ERR marking and re-lock, and the stats JSONL.  ETI bytes
are identical; the port also passes the JAX tests' own checks.

On noise the two Viterbi realizations of the reference disagree with
each other: radix-4 adds two steps' branch metrics before its compare,
the XLA scan one step at a time, so near-ties pick other survivors (the
sync-loss gap block's codewords 13 and 14 differ in 29 bits between the
scan and the radix-4 Pallas kernel).  The port's radix-4 follows the
Pallas kernel: its decode of every dispatch of the sync-loss stream,
the gap block's noise codewords included, is held bit for bit against
``viterbi_decode(impl="pallas")`` in interpret mode, metrics within
``rtol=1e-5``; the ETI frames that carry the gap's noise payloads are
compared in everything but those payloads.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.eti.parse import EtiParser
from dabtools_tpu.mod.impairments import awgn, carrier_offset
from dabtools_tpu.models import receiver as jrx
from dabtools_tpu.ops.viterbi import viterbi_decode as jviterbi
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.ops.viterbi import viterbi_decode4
from dabtools_tpu_torch.testsignal import sync_loss_stream
from tests.test_closed_loop import build_ensemble, modulate
from tests.test_torch_receiver import _port

torch.set_num_threads(2)

# tests/test_torch_receiver.py::test_process_block_matches_jax's
# tolerances for the diagnostics behind the stats records
CFO_ATOL = 1e-4
DIAG_RTOL = 1e-4
DELAY_ATOL = 1e-2
# snr_db is null_ratio in dB rounded to 2 decimals: DIAG_RTOL moves it by
# 4.3e-4 dB, which may cross one rounding step
SNR_ROUNDED_ATOL = 0.01 + 1e-9
# On a clean signal the null's power is 0 but for float32 cancellation
# in the difference of running sums (JAX -1.9e-7, the port 0.0 on
# test_stats_jsonl's stream); below null_ratio_to_snr_db's clip at 1e-6
# the estimate cannot tell such values apart
NULL_RATIO_ATOL = 1e-6


def _both(x, **kw):
    """``x`` through both receivers: (JAX rx, its ETI, port rx, its
    ETI)."""
    jr = jrx.DabReceiver(n_frames=4, **kw.get("jax", {}))
    je = jr.feed(x)
    tr = trx.DabReceiver(n_frames=4, device="cpu", **kw.get("port", {}))
    te = tr.feed(x)
    return jr, je, tr, te


def _assert_same_eti(jr, je, tr, te):
    assert tuple(te) == tuple(je)
    assert (tr.ensemble is None) == (jr.ensemble is None)
    if jr.ensemble is not None:
        assert tr.ensemble.subchannels == _port(jr.ensemble).subchannels
        assert tr._activation_cif == jr._activation_cif


def _decode_rate(rx, eti, payload_bytes):
    """``tests/test_robustness.py::_decode_rate``'s rate for one
    receiver's output."""
    if rx.ensemble is None or not eti:
        return 0.0
    frames = list(EtiParser().feed(b"".join(eti)))
    a = rx._activation_cif
    good = sum(f.subchannel_data(1) == payload_bytes[1][a + k].tobytes()
               for k, f in enumerate(frames))
    return good / len(frames)


@pytest.mark.parametrize("snr_db", [12.0, 8.0, -2.0])
def test_snr_threshold_matches_jax(snr_db):
    """``test_snr_threshold_behaviour``'s points (seed 0): the same
    decode rate, 1.0 at 12 and 8 dB and below 1.0 at -2 dB, and ETI
    identical wherever a receiver acquires."""
    x, payload_bytes = modulate(build_ensemble(), 12, seed=0)
    x = awgn(x, snr_db, np.random.default_rng(1000))
    jr, je, tr, te = _both(x)
    _assert_same_eti(jr, je, tr, te)
    rate = _decode_rate(tr, te, payload_bytes)
    assert rate == _decode_rate(jr, je, payload_bytes)
    if snr_db > 0:
        assert rate == 1.0
    else:                          # below the rate-1/2 DQPSK cliff
        assert rate < 1.0


# (cfo_hz, modulation seed, noise seed, SNR) of test_large_cfo_with_
# integer_part and test_half_carrier_cfo_boundary
_CFO_CASES = {"4300": (4300.0, 3, 3, 16.0), "2500": (2500.0, 5, 7, 18.0),
              "-3500": (-3500.0, 5, 7, 18.0), "1499": (1499.0, 5, 7, 18.0)}


@pytest.mark.parametrize("case", list(_CFO_CASES))
def test_large_cfo_matches_jax(case):
    """A CFO of 4.3 carriers, and the half-carrier boundary at 2500,
    -3500 and 1499 Hz: ETI byte-identical, every block's ``cfo_carriers``
    within ``CFO_ATOL`` of the JAX receiver's; the port's estimate within
    0.05 carriers of the truth and every payload the modulator's."""
    cfo_hz, seed, noise_seed, snr = _CFO_CASES[case]
    x, payload_bytes = modulate(build_ensemble(), 12, seed=seed)
    x = awgn(carrier_offset(x, cfo_hz), snr,
             np.random.default_rng(noise_seed))
    jr, je, tr, te = _both(x)
    _assert_same_eti(jr, je, tr, te)
    assert tr.ensemble is not None
    assert len(tr.stats) == len(jr.stats)
    np.testing.assert_allclose([s.cfo_carriers for s in tr.stats],
                               [s.cfo_carriers for s in jr.stats],
                               atol=CFO_ATOL, rtol=0)
    assert abs(tr.stats[-1].cfo_carriers - cfo_hz / 1000.0) < 0.05
    frames = list(EtiParser().feed(b"".join(te)))
    assert frames
    a = tr._activation_cif
    for k, f in enumerate(frames):
        assert f.subchannel_data(1) == payload_bytes[1][a + k].tobytes()


def _sync_loss_stream():
    """``test_sync_loss_marks_err_and_recovers``'s stream: 8 frames, 4
    frames of noise, 8 frames; (samples, sub-channel 1 rows sent)."""
    ens = build_ensemble()
    x1, p1 = modulate(ens, 8, seed=5)
    rng = np.random.default_rng(5)
    gap = (0.3 * (rng.normal(size=4 * C.MODE_I.frame_size)
                  + 1j * rng.normal(size=4 * C.MODE_I.frame_size))
           ).astype(np.complex64)
    x2, p2 = modulate(ens, 8, seed=6)
    sent = {r.tobytes() for r in p1[1]} | {r.tobytes() for r in p2[1]}
    return np.concatenate([x1, gap, x2]), sent


def test_testsignal_sync_loss_stream_is_the_jax_tests():
    """``chip_smoke.py``'s sync-loss stream (``testsignal``, no JAX) is
    this stream, sample for sample."""
    x, sent = _sync_loss_stream()
    tx, tsent = sync_loss_stream()
    np.testing.assert_array_equal(tx, x)
    assert tsent == sent


@functools.cache
def _sync_loss():
    """The sync-loss stream through both receivers, recording the port's
    Viterbi dispatches: (JAX ETI, port ETI, payloads sent, [(soft jobs,
    the dispatch's bits per job)])."""
    x, sent = _sync_loss_stream()
    dispatches = []
    real = trx.viterbi_decode_ragged

    def recording(jobs):
        res = real(jobs)
        dispatches.append(([j.clone() for j in jobs],
                           [b.clone() for b, _ in res]))
        return res

    trx.viterbi_decode_ragged = recording
    try:
        jr, je, tr, te = _both(x)
    finally:
        trx.viterbi_decode_ragged = real
    assert jr.ensemble is not None and tr.ensemble is not None
    return tuple(je), tuple(te), sent, dispatches


def test_sync_loss_matches_jax():
    """Sync loss: the ERR-flagged frames equal in count and position,
    the last frame 0xFF in both; ETI bytes identical on every frame with
    ERR 0xFF and FIC bytes on every frame; the flagged frames agree in
    FCT and streams, their noise payloads left uncompared."""
    je, te, sent, _ = _sync_loss()
    assert len(te) == len(je) > 0
    fj = list(EtiParser().feed(b"".join(je)))
    ft = list(EtiParser().feed(b"".join(te)))
    errs = [f.err for f in ft]
    assert errs == [f.err for f in fj]
    assert 0xFF in errs and any(e != 0xFF for e in errs)
    assert errs[-1] == 0xFF
    noise = 0
    for raw_t, raw_j, a, b in zip(te, je, ft, fj):
        assert a.fic == b.fic
        assert (a.fct, set(a.streams)) == (b.fct, set(b.streams))
        if a.err == 0xFF:
            assert raw_t == raw_j
        else:
            noise += b.subchannel_data(1) not in sent
    assert noise > 0               # the gap's payloads are decodes of noise


def test_noise_codewords_match_jax_pallas():
    """Every Viterbi dispatch of the sync-loss stream, the gap block's
    16 noise codewords of 6168 soft bits included: the port's plain
    radix-4 equals the JAX radix-4 Pallas kernel (interpret mode) bit for
    bit, metrics within rtol=1e-5, and equals the bits the stream's
    ragged dispatch gave."""
    _, _, _, dispatches = _sync_loss()
    shapes = [tuple(j.shape) for j in dispatches[-1][0]]
    assert shapes == [(16, 3096), (16, 6168)]
    for jobs, stream_bits in dispatches:
        for soft, got in zip(jobs, stream_bits):
            bits, metric = viterbi_decode4(soft)
            pb, pm = jviterbi(jnp.asarray(soft.numpy()), impl="pallas")
            np.testing.assert_array_equal(bits.numpy(), np.asarray(pb))
            np.testing.assert_allclose(metric.numpy(), np.asarray(pm),
                                       rtol=1e-5)
            assert torch.equal(bits, got)


def test_stats_jsonl_matches_jax(tmp_path):
    """``test_stats_jsonl``'s stream: the same records, integer and text
    fields equal, floats within the tolerances of
    ``test_process_block_matches_jax``."""
    x, _ = modulate(build_ensemble(), 10, seed=7)
    jpath, tpath = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    _both(x, jax={"stats_jsonl": str(jpath)},
          port={"stats_jsonl": str(tpath)})
    jl = [json.loads(s) for s in jpath.read_text().splitlines()]
    tl = [json.loads(s) for s in tpath.read_text().splitlines()]
    assert len(tl) == len(jl) >= 2
    assert any(k.startswith("subch") for k in tl[-1])
    close = {"cfo_carriers": {"atol": CFO_ATOL, "rtol": 0},
             "delay_spread_us": {"atol": DELAY_ATOL, "rtol": 0},
             "snr_db": {"atol": SNR_ROUNDED_ATOL, "rtol": 0},
             "null_ratio": {"atol": NULL_RATIO_ATOL, "rtol": DIAG_RTOL}}
    for t, j in zip(tl, jl):
        assert set(t) == set(j)
        assert {"cif_count", "null_ratio", "cfo_carriers",
                "fib_crc_ok"} <= set(t)
        for key, v in j.items():
            if isinstance(v, float):
                np.testing.assert_allclose(
                    t[key], v, err_msg=key,
                    **close.get(key, {"rtol": DIAG_RTOL}))
            else:
                assert t[key] == v, key

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``dabtools_tpu_torch`` (never JAX) on ``cuda:0`` in phases, each
of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: the Viterbi kernels from ``dabtools_tpu_torch/csrc/`` (one
   ``nvcc`` per source, all at once): K1 ``acs4``, K2 ``traceback4``, K2'
   ``traceback4_onehot64``, K3 ``acs2``, K4 ``traceback2`` (build seconds);
3. kernel vs plain at the flagship's ragged shape, 64 FIC codewords
   (774 trellis steps) + 576 EEP 3-A 128 kbit/s codewords (3078 steps) in
   one lane batch: K1's decisions and metrics and K2's bits must equal the
   plain PyTorch versions exactly, and the decode must equal the encoded
   messages; then the same on an adversarial ragged batch (640 lanes of
   1539 double steps, lengths at the kernels' chunk edges, a third of the
   soft bits erased); median times from CUDA events, each pair of events
   around 20 launches back to back, also per double step;
3a. radix-2 at full width: 640 codewords of 3073 information bits (3079
   trellis steps, odd, so ``viterbi_decode`` takes K3/K4), BPSK in AWGN
   with a third of the soft bits erased to exactly 0 (ACS ties).  The
   decode must launch K3 and K4 and equal the messages; K3's decisions
   and metrics and K4's bits must equal ``acs2_plain`` /
   ``traceback2_plain`` exactly; median times;
3b. the one-hot traceback K2' at the flagship ragged shape: the decode
   with ``traceback="onehot64"`` must launch K2' and equal the messages,
   and K2' on K1's decisions must equal K2's bits and
   ``traceback4_plain``'s; median time;
4. end to end: the flagship mux (9 x 128 kbit/s EEP 3-A, 864/864 CUs,
   Mode I) modulated for 100 frames, with AWGN, CFO and a timing offset,
   quantized to u8 and fed to ``DabReceiver(n_frames=16, device="cuda")``.
   The acquired sub-channels must equal the mux's, every FIB CRC after
   acquisition must pass, every ETI frame's 9 payloads must equal the
   modulator's bytes, and K1/K2 must have launched once per device step.
   Then one warm ``process_block`` under PyTorch's sync debug mode
   'error' (nothing inside may wait for the device), and the steady-state
   ms/block and real-time multiple.
5. TII: the flagship with TII (sub id 7, main id 31) in its null symbols,
   impaired to u8 as in phase 4, through ``DabReceiver(n_frames=16,
   tii=True)``: ``rx.tii()`` must give main id 31 and sub id 7, every ETI
   payload must stay the modulator's, ``process_block(tii=True)`` must
   pass the sync-free check, and phase 4's stream (no TII) must give
   None.
6. resampler: the flagship at 2.4 Msps (exact spectral resample) through
   ``Resampler(2_400_000)`` and the receiver: ETI payloads must be the
   modulator's; the resampler's input Msamples/s.
7. wideband + dabscan: one 8.192 Msps u8 capture at 184.5 MHz with a
   flagship-shaped mux of its own EId and label in 6A, 6C and 6D and
   nothing in 6B.  ``Channelizer`` fft against direct with TF32 on
   process-wide (within the JAX test's atol=2e-5) and each method's input
   Msamples/s; ``dab2eti --wideband`` must write three ETI files with
   each mux's payloads; ``dabscan`` (JSON and text) must find exactly the
   three EIds and labels, ``--`` for 6B, with one K1 and one K2 launch
   for all four candidate blocks.
8. channel batch: 8 flagship streams (one modulation; each its own CFO,
   start and noise seed) as one 8-frame ``channel_parallel_block``: one
   K1 and one K2 launch for 2560 lanes = 8 x (32 FIC + 288 MSC); each
   stream's FIB and sub-channel bytes equal its own ``process_block``,
   rows >= 15 equal the modulator's payload; K1/K2 held against their
   plain versions at that lane batch and timed; the batched ms per block
   beside a single-stream 8-frame block and the device operations of
   each (``torch.profiler``).

Every path starts with all five launch counters at 0 and reads them
when it ends.  Each phase prints its seconds.  The line before the last
is the kernels' JSON record, with each kernel's bound: the larger of
the bytes it must move over the
card's memory rate and the operations it must do over its float32 rate
(counted from this run's inputs; see :func:`_bound`).  The last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.cli import dab2eti, dabscan
from dabtools_tpu_torch.constants import MODE_I
from dabtools_tpu_torch.mod.convcode import conv_encode
from dabtools_tpu_torch.mod.impairments import (
    awgn,
    carrier_offset,
    quantize_u8,
)
from dabtools_tpu_torch.models.receiver import (
    DabReceiver,
    block_samples,
    pre_viterbi,
    process_block,
    to_host,
)
from dabtools_tpu_torch.ops import viterbi as V
from dabtools_tpu_torch.ops import viterbi_cuda as K
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.resample import Resampler
from dabtools_tpu_torch.ops.sync import coarse_null_sync
from dabtools_tpu_torch.parallel.channel import channel_parallel_block
from dabtools_tpu_torch.tables.bandiii import BAND_III as BAND

SEED = 20261016
BLOCK_FRAMES = 16
E2E_FRAMES = 100
SNR_DB = 20.0
CFO_HZ = 300.0
TIMING_OFFSET = 3000
BLOCK_SECONDS = 1.536           # 16 Mode I frames of 96 ms
SAMPLE_RATE_MSPS = 2.048
R2_LANES = 640
R2_INFO_BITS = 3073             # trellis length 3079: odd, so radix-2
R2_NOISE = 0.4                  # sigma per coded bit, Es/N0 4.95 dB
R2_ERASED = 1 / 3               # share of soft bits set to exactly 0
KERNEL_RUN = 20                 # kernel launches per pair of timing events
TII = (7, 31)                   # (sub id, main id) of phase 5
TII_FRAMES = 48
RS_FRAMES = 48                  # phase 6: frames resampled from 2.4 Msps
WB_RATE = 8_192_000
WB_CENTER = 184_500_000         # 6A-6D inside the band
WB_FRAMES = 32                  # 3 blocks of 8 frames; acquisition ~14
WB_MUXES = {"6A": (0x6A01, "MUX 6A"), "6C": (0x6C03, "MUX 6C"),
            "6D": (0x6D04, "MUX 6D")}
BATCH = 8                       # phase 8: streams per batched block
BATCH_FRAMES = 8
BATCH_CFO_HZ = (-400.0, -250.0, -100.0, 50.0, 150.0, 250.0, 350.0, 450.0)
FRAME_SIZE = MODE_I.frame_size

# Bounds: NVIDIA H100 SXM data-sheet peaks.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float operations per lane and (double) step, as the plain versions
# compute them: 16 signed sums of a step's 4 soft bits (29 adds or
# negations), then for radix-2 128 candidate adds and 64 compares; for
# radix-4 two such tables, 256 adds joining the two steps, 256 candidate
# adds and 192 compares.  A traceback does integer work only.
ACS2_OPS = 29 + 128 + 64
ACS4_OPS = 2 * 29 + 256 + 256 + 192
KERNELS = ("acs4", "traceback4", "traceback4_onehot64", "acs2", "traceback2")
REPLACES = {
    "acs4": "dabtools_tpu/ops/viterbi_pallas4.py:29",
    "traceback4": "dabtools_tpu/ops/viterbi_pallas4.py:177",
    "traceback4_onehot64": "dabtools_tpu/ops/viterbi_pallas4.py:246",
    "acs2": "dabtools_tpu/ops/viterbi_pallas.py:41",
    "traceback2": "dabtools_tpu/ops/viterbi_pallas.py:103",
}
SOURCES = {"acs4": "viterbi4.cu", "traceback4": "viterbi4.cu",
           "traceback4_onehot64": "viterbi4.cu", "acs2": "viterbi2.cu",
           "traceback2": "viterbi2.cu"}


def device_phase() -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; TF32 off")
    return card


def build_phase() -> None:
    t0 = time.perf_counter()
    K.build()
    dt = time.perf_counter() - t0
    print(f"build: {K.library_path().name} in {dt:.2f} s")
    for line in K.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def _reset_counts() -> None:
    for name in KERNELS:
        setattr(K, f"{name}_launches", 0)


def _counts() -> dict:
    return {name: getattr(K, f"{name}_launches") for name in KERNELS}


def _bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def _k1k2_bounds(lengths: np.ndarray, dec: torch.Tensor,
                 bits: torch.Tensor, ws4: torch.Tensor):
    """(K1's, K2's) bound for lanes of ``lengths`` trellis steps: K1 reads
    the live soft bits, the lane lengths and ``ws4`` and writes the
    decision words and metrics; K2 reads one decision word per plane per
    live double step and writes the bits."""
    b = dec.shape[0]
    live = int(lengths.sum()) // 2                   # live lane-double-steps
    return (_bound(live * 8 * 4 + dec.numel() * 4 + 4 * b
                   + ws4.numel() * 4 + 4 * b, live * ACS4_OPS),
            _bound(live * 8 + bits.numel(), 0))


def time_ms(fn, reps: int, run: int = 1) -> float:
    """Median CUDA-event time of one call of ``fn`` over ``reps`` pairs of
    events (after one warm-up call), each pair around ``run`` calls back
    to back.  A kernel is timed with ``run`` > 1 so that the card is busy
    from one event to the other: around a single launch the pair would
    also count the host's enqueue of the launch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(run):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / run)
    return statistics.median(times)


def _us_per_step(ms: float, steps: int) -> str:
    """A kernel's time per (double) step of its longest lane."""
    return f"{ms * 1e3 / steps:.4f} us/step"


def hold_k1k2(soft8, t2, ws4, what: str):
    """K1's decisions and metrics and K2's bits against their plain
    versions on the same inputs; raises unless they are equal.  Returns
    (K1's decisions, K2's bits, the plain traceback's bits, K1's max
    metric difference, K2's max bit difference)."""
    dec_k, metric_k = K.acs4(soft8, t2, ws4)
    dec_p, metric_p = V.acs4_plain(soft8, t2, ws4)
    bits_k = K.traceback4(dec_k)
    bits_p = V.traceback4_plain(dec_k)
    torch.cuda.synchronize()
    n_dec_diff = int((dec_k != dec_p).sum())
    acs_err = float((metric_k - metric_p).abs().max())
    tb_err = int((bits_k.int() - bits_p.int()).abs().max())
    print(f"{what}: K1 acs4 vs plain: {n_dec_diff} decision words differ, "
          f"max |metric diff| {acs_err}; K2 traceback4 vs plain: max |bit "
          f"diff| {tb_err}")
    if n_dec_diff or acs_err or tb_err:
        raise AssertionError(f"kernel and plain version disagree: {what}")
    return dec_k, bits_k, bits_p, acs_err, tb_err


def adversarial_check(rng, ws4: torch.Tensor, t2_max: int) -> None:
    """K1/K2 against their plain versions on 640 lanes of ``t2_max``
    double steps whose lengths probe the kernels' chunk edges (0, 1, a
    chunk and either side of it, 2 chunks + 3, the whole width, random),
    with the radix-2 phase's noise and a third of the soft bits erased to
    exactly 0 (ACS ties)."""
    soft_np = (1.0 - 2.0 * rng.integers(0, 2, size=(R2_LANES, t2_max, 8))
               + rng.normal(scale=R2_NOISE, size=(R2_LANES, t2_max, 8)))
    soft_np[rng.random(soft_np.shape) < R2_ERASED] = 0.0
    edges = np.array([0, 1, K.CHUNK - 1, K.CHUNK, K.CHUNK + 1,
                      2 * K.CHUNK + 3, t2_max - 1, t2_max])
    t2_np = rng.integers(0, t2_max + 1, size=R2_LANES)
    t2_np[: 8 * len(edges)] = np.tile(edges, 8)
    hold_k1k2(torch.from_numpy(soft_np.astype(np.float32)).cuda(),
              torch.from_numpy(t2_np.astype(np.int32)).cuda(), ws4,
              f"adversarial ragged batch, {R2_LANES} lanes x {t2_max} double "
              f"steps, lengths {edges.tolist()} and random")


def kernel_phase(rng) -> dict:
    """K1/K2 against their plain versions at the flagship ragged shape;
    returns their records and the inputs phase 3b reuses."""
    msgs, jobs = S.flagship_codewords(rng, "cuda")
    soft, lengths = V.ragged_lanes(jobs)
    b, n4 = soft.shape
    soft8 = soft.reshape(b, n4 // 8, 8)
    t2 = torch.from_numpy((lengths // 2).astype(np.int32)).cuda()
    ws4 = V._ws4(soft.device)
    print(f"lanes: {b} x {n4 // 8} double steps "
          f"(64 x 774 FIC + 576 x 3078 MSC trellis steps)")

    dec_k, bits_k, bits_p, acs_err, tb_err = hold_k1k2(
        soft8, t2, ws4, "flagship ragged shape")

    decoded = V.viterbi_decode_ragged(jobs)          # the dispatch itself
    for (bits, _), m, name in zip(decoded, msgs, ("FIC", "MSC")):
        wrong = int((bits.cpu().numpy() != m).sum())
        print(f"{name}: {m.shape[0]} codewords, {wrong} bit errors")
        if wrong:
            raise AssertionError(f"{name} decode differs from the messages")

    adversarial_check(rng, ws4, n4 // 8)

    acs_ms = time_ms(lambda: K.acs4(soft8, t2, ws4), 10, KERNEL_RUN)
    acs_plain_ms = time_ms(lambda: V.acs4_plain(soft8, t2, ws4), 3)
    tb_ms = time_ms(lambda: K.traceback4(dec_k), 10, KERNEL_RUN)
    tb_plain_ms = time_ms(lambda: V.traceback4_plain(dec_k), 3)
    print(f"K1 acs4: {acs_ms:.4f} ms, {_us_per_step(acs_ms, n4 // 8)} "
          f"(plain {acs_plain_ms:.2f} ms); K2 traceback4: {tb_ms:.4f} ms, "
          f"{_us_per_step(tb_ms, n4 // 8)} (plain {tb_plain_ms:.2f} ms)")
    acs_bound, tb_bound = _k1k2_bounds(lengths, dec_k, bits_k, ws4)
    return {
        "records": {
            "acs4": {"max_abs_err": acs_err, "ms": acs_ms,
                     "plain_ms": acs_plain_ms, "bound": acs_bound},
            "traceback4": {"max_abs_err": float(tb_err), "ms": tb_ms,
                           "plain_ms": tb_plain_ms, "bound": tb_bound}},
        "msgs": msgs, "soft": soft, "lengths": lengths, "dec": dec_k,
        "bits_k": bits_k, "bits_p": bits_p}


def radix2_phase(rng) -> dict:
    """K3/K4 at full width: the odd-length decode through
    ``viterbi_decode``, then each kernel against its plain version."""
    msgs = rng.integers(0, 2, size=(R2_LANES, R2_INFO_BITS), dtype=np.uint8)
    tx = np.stack([1.0 - 2.0 * conv_encode(m) for m in msgs])
    soft_np = (tx + rng.normal(scale=R2_NOISE, size=tx.shape)).astype(
        np.float32)
    soft_np[rng.random(soft_np.shape) < R2_ERASED] = 0.0
    soft = torch.from_numpy(soft_np).cuda()
    b, n4 = soft.shape
    print(f"radix-2 lanes: {b} x {n4 // 4} trellis steps, sigma "
          f"{R2_NOISE}, {R2_ERASED:.3f} of the soft bits erased")

    _reset_counts()
    bits, _ = V.viterbi_decode(soft)                 # the entry point
    torch.cuda.synchronize()
    launches = _counts()
    print(f"radix-2 decode launches: {launches}")
    if not (launches["acs2"] and launches["traceback2"]):
        raise AssertionError("the odd-length decode did not run K3/K4")
    wrong = int((bits.cpu().numpy() != msgs).sum())
    print(f"radix-2 decode: {wrong} bit errors")
    if wrong:
        raise AssertionError("radix-2 decode differs from the messages")

    soft4 = soft.reshape(b, n4 // 4, 4)
    ws2 = V._ws2(soft.device)
    dec_k, metric_k = K.acs2(soft4, ws2)
    dec_p, metric_p = V.acs2_plain(soft4, ws2)
    bits_k = K.traceback2(dec_k)
    bits_p = V.traceback2_plain(dec_k)
    torch.cuda.synchronize()
    n_dec_diff = int((dec_k != dec_p).sum())
    acs_err = float((metric_k - metric_p).abs().max())
    tb_err = int((bits_k.int() - bits_p.int()).abs().max())
    print(f"K3 acs2 vs plain: {n_dec_diff} decision words differ, "
          f"max |metric diff| {acs_err}")
    print(f"K4 traceback2 vs plain: max |bit diff| {tb_err}")
    if n_dec_diff or acs_err or tb_err:
        raise AssertionError("radix-2 kernel and plain version disagree")

    acs_ms = time_ms(lambda: K.acs2(soft4, ws2), 10, KERNEL_RUN)
    acs_plain_ms = time_ms(lambda: V.acs2_plain(soft4, ws2), 3)
    tb_ms = time_ms(lambda: K.traceback2(dec_k), 10, KERNEL_RUN)
    tb_plain_ms = time_ms(lambda: V.traceback2_plain(dec_k), 3)
    print(f"K3 acs2: {acs_ms:.4f} ms, {_us_per_step(acs_ms, n4 // 4)} "
          f"(plain {acs_plain_ms:.2f} ms); K4 traceback2: {tb_ms:.4f} ms, "
          f"{_us_per_step(tb_ms, n4 // 4)} (plain {tb_plain_ms:.2f} ms)")
    steps = b * (n4 // 4)
    return {"launches": launches, "records": {
        "acs2": {"max_abs_err": acs_err, "ms": acs_ms,
                 "plain_ms": acs_plain_ms, "bound": _bound(
                     steps * 16 + dec_k.numel() * 4 + ws2.numel() * 4
                     + 4 * b, steps * ACS2_OPS)},
        "traceback2": {"max_abs_err": float(tb_err), "ms": tb_ms,
                       "plain_ms": tb_plain_ms,
                       "bound": _bound(steps * 4 + bits_k.numel(), 0)}}}


def onehot_phase(kern: dict) -> dict:
    """K2' at the flagship ragged shape: the decode with
    ``traceback="onehot64"``, then K2' on K1's decisions against K2 and
    the plain traceback."""
    _reset_counts()
    bits, _ = V.viterbi_decode4(kern["soft"], kern["lengths"],
                                traceback="onehot64")  # the entry point
    torch.cuda.synchronize()
    launches = _counts()
    print(f"one-hot decode launches: {launches}")
    if not (launches["acs4"] and launches["traceback4_onehot64"]):
        raise AssertionError("the onehot64 decode did not run K1/K2'")
    bits = bits.cpu().numpy()
    o = 0
    for m, name in zip(kern["msgs"], ("FIC", "MSC")):
        wrong = int((bits[o:o + m.shape[0], :m.shape[1]] != m).sum())
        print(f"one-hot decode, {name}: {wrong} bit errors")
        if wrong:
            raise AssertionError(f"onehot64 {name} decode differs")
        o += m.shape[0]

    dec = kern["dec"]
    bits_o = K.traceback4_onehot64(dec)
    torch.cuda.synchronize()
    err_k2 = int((bits_o.int() - kern["bits_k"].int()).abs().max())
    err_p = int((bits_o.int() - kern["bits_p"].int()).abs().max())
    print(f"K2' traceback4_onehot64: max |bit diff| {err_k2} vs K2, "
          f"{err_p} vs traceback4_plain")
    if err_k2 or err_p:
        raise AssertionError("K2' disagrees with K2 or the plain version")
    ms = time_ms(lambda: K.traceback4_onehot64(dec), 10, KERNEL_RUN)
    k2 = kern["records"]["traceback4"]
    print(f"K2' traceback4_onehot64: {ms:.4f} ms, "
          f"{_us_per_step(ms, dec.shape[1])} (K2 {k2['ms']:.4f} ms)")
    # K2' computes K2's function: the same plain version, time and bound.
    return {"launches": launches, "records": {"traceback4_onehot64": {
        "max_abs_err": float(max(err_k2, err_p)), "ms": ms,
        "plain_ms": k2["plain_ms"], "bound": k2["bound"]}}}


def end_to_end_phase(rng) -> dict:
    """The flagship decoded end to end from u8 IQ on the card; returns the
    launch counts of that run, the u8 signal and the ensemble."""
    ens = S.flagship_ensemble()
    t0 = time.perf_counter()
    x, payload = S.modulate(ens, E2E_FRAMES, rng)
    u8 = S.impaired_u8(x, rng, SNR_DB, CFO_HZ, TIMING_OFFSET)
    print(f"signal: {E2E_FRAMES} frames, {u8.size // 2} samples u8, "
          f"AWGN {SNR_DB} dB, CFO {CFO_HZ} Hz, timing +{TIMING_OFFSET} "
          f"({time.perf_counter() - t0:.1f} s to modulate)")

    rx = DabReceiver(n_frames=BLOCK_FRAMES, device="cuda")
    _reset_counts()
    eti = rx.feed(u8)
    launches = _counts()

    if rx.ensemble is None:
        raise AssertionError("no ensemble acquired")
    if rx.ensemble.subchannels != ens.subchannels:
        raise AssertionError("acquired sub-channels differ from the mux")
    after = [s for s in rx.stats if s.cif_count >= rx._activation_cif]
    bad = sum(s.fib_crc_bad for s in after)
    print(f"blocks: {len(rx.stats)} ({rx.device_steps} device steps incl. "
          f"replay); FIB CRC failures after acquisition: {bad}; "
          f"CFO {after[-1].cfo_carriers:.4f} carriers; "
          f"null ratio {after[-1].null_ratio:.4f}")
    if bad:
        raise AssertionError("FIB CRC failures after acquisition")
    if abs(after[-1].cfo_carriers - CFO_HZ / 1000.0) > 0.05:
        raise AssertionError("CFO estimate off")
    if len(eti) < 64:
        raise AssertionError(f"only {len(eti)} ETI frames")
    n = S.check_eti_payloads(eti, payload, rx._activation_cif)
    print(f"ETI: {n} frames, all 9 sub-channel payloads "
          f"byte-identical to the modulator's")
    for name in ("acs4", "traceback4"):
        if launches[name] != rx.device_steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {rx.device_steps} device steps")
    print(f"launches: {launches} in {rx.device_steps} device steps")
    return {"launches": launches, "u8": u8, "ensemble": ens}


def sync_free_check(rx, block_u8: np.ndarray) -> None:
    """One warm ``process_block`` on the card, as ``rx`` runs it (TII
    included if ``rx`` has it on), under PyTorch's sync debug mode
    'error': any op inside that waits for the device (a device->host
    read, a pageable upload) raises.  The block's one upload happens
    before, its one download after."""
    x = rx._upload(block_u8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        process_block(x, rx._rings, rx._cif_count,
                      ensemble=rx._decode.decode_config(), mode=rx.mode,
                      n_frames=rx.n_frames, tii=rx._tii_enabled)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"process_block{' with TII' if rx._tii_enabled else ''}: no host "
          f"synchronization inside (sync debug mode 'error')")


def steady_state_phase(u8: np.ndarray, ens, card: str) -> float:
    """Median ms per block of a receiver already configured for ``ens``,
    after one warm-up block; host clock around each whole block (each
    ends in the block's device->host copy and includes its ETI
    assembly)."""
    rx = DabReceiver(n_frames=BLOCK_FRAMES, ensemble=ens, device="cuda")
    first = 2 * block_samples(BLOCK_FRAMES)
    rx.feed(u8[:first])
    sync_free_check(rx, u8[first: 2 * first])
    walls = []
    one_block = rx._process_one_block

    def timed(x, _replay=False):
        t0 = time.perf_counter()
        eti = one_block(x, _replay)
        walls.append(time.perf_counter() - t0)
        return eti

    rx._process_one_block = timed
    rx.feed(u8[first:])
    if not walls:
        raise AssertionError("no steady-state blocks")
    ms = statistics.median(walls) * 1e3
    rt = BLOCK_SECONDS * 1e3 / ms
    print(f"steady state: median {ms:.2f} ms/block over {len(walls)} "
          f"blocks of {BLOCK_FRAMES} frames (min {min(walls) * 1e3:.2f}, "
          f"max {max(walls) * 1e3:.2f}) = {rt:.1f}x real time, "
          f"{SAMPLE_RATE_MSPS * rt:.1f} Msamples/s "
          f"(u8 input, host ETI assembly included) on {card}")
    return ms


def tii_phase(rng, u8_no_tii: np.ndarray) -> None:
    """The flagship with TII in its null symbols, impaired to u8 as in
    phase 4, through the TII receiver; then phase 4's stream (no TII).

    Both streams start ``TIMING_OFFSET`` samples into frame 0 instead of
    after a run of that many zeros: on the zeros, the first block's coarse
    sync locks at 0, and its misplaced TII windows (data symbols) swamp
    the accumulated noise floor, in the JAX receiver as in the port."""
    ens = S.flagship_ensemble()
    x, payload = S.modulate(ens, TII_FRAMES, rng, tii=TII)
    u8 = S.impaired_u8(x, rng, SNR_DB, CFO_HZ, -TIMING_OFFSET)
    rx = DabReceiver(n_frames=BLOCK_FRAMES, tii=True, device="cuda")
    eti = rx.feed(u8)
    det = rx.tii()
    print(f"TII: {det} over {rx.device_steps} device steps")
    if det is None or (det.sub_id, det.main_id) != TII:
        raise AssertionError(f"TII detection: want sub/main {TII}, got "
                             f"{det}")
    if rx.ensemble is None or rx.ensemble.subchannels != ens.subchannels:
        raise AssertionError("TII stream: no or a wrong ensemble")
    n = S.check_eti_payloads(eti, payload,
                             S.first_payload_cif(b"".join(eti), payload))
    print(f"TII stream: {n} ETI frames, all 9 payloads byte-identical to "
          f"the modulator's")
    first = 2 * block_samples(BLOCK_FRAMES)
    sync_free_check(rx, u8[first: 2 * first])
    rx0 = DabReceiver(n_frames=BLOCK_FRAMES, tii=True, device="cuda")
    rx0.feed(u8_no_tii[4 * TIMING_OFFSET: 2 * 40 * FRAME_SIZE])
    if rx0.ensemble is None or rx0.tii() is not None:
        raise AssertionError(f"stream without TII gave {rx0.tii()}")
    print("stream without TII: rx.tii() is None")


def resampler_phase(rng, card: str) -> None:
    """The flagship at 2.4 Msps through the resampler and the receiver."""
    ens = S.flagship_ensemble()
    x, payload = S.modulate(ens, RS_FRAMES, rng)
    x24 = S.fft_resample(awgn(x, SNR_DB, rng), int(round(x.size * 75 / 64)))
    rs = Resampler(2_400_000, device="cuda")
    rs(x24[:100_000])                                # warm-up, own stream
    rs = Resampler(2_400_000, device="cuda")
    t0 = time.perf_counter()
    y = rs(x24)
    dt = time.perf_counter() - t0
    print(f"resampler: {x24.size} samples at 2.4 Msps -> {y.size} in "
          f"{dt * 1e3:.1f} ms = {x24.size / dt / 1e6:.1f} input Msamples/s "
          f"(host clock, upload and download included) on {card}")
    rx = DabReceiver(n_frames=BLOCK_FRAMES, device="cuda")
    eti = rx.feed(y)
    if rx.ensemble is None:
        raise AssertionError("resampled stream: no ensemble acquired")
    raw = b"".join(eti)
    n = S.check_eti_payloads(eti, payload, S.first_payload_cif(raw, payload))
    print(f"resampled stream: {n} ETI frames, all 9 payloads "
          f"byte-identical to the modulator's")


def _channelizer_rate(x: np.ndarray, method: str) -> tuple[np.ndarray, float]:
    """One call of a fresh channelizer of the capture's 4 blocks on the
    whole capture (after a warm-up instance): (output, input Msamples/s,
    host clock, upload and download included)."""
    offs = [f - WB_CENTER for f in (BAND[b] for b in ("6A", "6B", "6C",
                                                      "6D"))]
    Channelizer(WB_RATE, offs, method=method, device="cuda")(x[:1 << 20])
    ch = Channelizer(WB_RATE, offs, method=method, device="cuda")
    t0 = time.perf_counter()
    y = ch(x)
    return y, x.size / (time.perf_counter() - t0) / 1e6


def _run_cli(main_fn, argv: list[str]) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    return rc, out.getvalue().splitlines()


def wideband_phase(rng, card: str) -> None:
    """A 4-block capture through the channelizer (both methods),
    ``dab2eti --wideband`` and ``dabscan``."""
    t0 = time.perf_counter()
    muxes = {b: S.flagship_ensemble(eid, label)
             for b, (eid, label) in WB_MUXES.items()}
    wide, payloads = S.wideband_capture(muxes, WB_CENTER, WB_RATE,
                                        WB_FRAMES, rng)
    print(f"wideband capture: {wide.size} samples at {WB_RATE / 1e6} Msps, "
          f"muxes in {sorted(muxes)}, 6B empty "
          f"({time.perf_counter() - t0:.1f} s to synthesize)")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yd, rate_d = _channelizer_rate(wide, "direct")
        yf, rate_f = _channelizer_rate(wide, "fft")
    finally:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    n = min(yd.shape[1], yf.shape[1])
    err = float(np.abs(yf[:, :n] - yd[:, :n]).max())
    print(f"channelizer, TF32 on process-wide: fft vs direct max |diff| "
          f"{err:.3g} (limit 2e-05); input Msamples/s: fft {rate_f:.1f}, "
          f"direct {rate_d:.1f} (host clock, one call on the whole capture, "
          f"upload and download included) on {card}")
    if not err <= 2e-5:
        raise AssertionError("channelizer fft and direct disagree")

    with tempfile.TemporaryDirectory() as tmp:
        cap = pathlib.Path(tmp) / "wide.u8"
        quantize_u8(wide).tofile(cap)
        outdir = pathlib.Path(tmp) / "eti"
        t0 = time.perf_counter()
        rc, _ = _run_cli(dab2eti.main, [
            "--torch-device", "cuda", "--format", "u8", "--wideband",
            str(WB_CENTER), "--rate", str(WB_RATE), str(cap), "-o",
            str(outdir)])
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"dab2eti --wideband exited {rc}")
        for block, pl in payloads.items():
            raw = (outdir / f"{block}.eti").read_bytes()
            frames = [raw[k:k + 6144] for k in range(0, len(raw), 6144)]
            n = S.check_eti_payloads(frames, pl,
                                     S.first_payload_cif(raw, pl))
            if n < 16:
                raise AssertionError(f"{block}: only {n} ETI frames")
            print(f"dab2eti --wideband {block}: {n} ETI frames, all 9 "
                  f"payloads byte-identical to the mux's")
        if (outdir / "6B.eti").stat().st_size:
            raise AssertionError("6B (empty) produced ETI frames")
        print(f"dab2eti --wideband: 4 blocks of {WB_FRAMES} frames in "
              f"{dt:.2f} s = {wide.size / dt / 1e6:.1f} input Msamples/s "
              f"(file to ETI files, u8 input, 8-frame blocks)")

        scan = ["--torch-device", "cuda", "--format", "u8", "--center",
                str(WB_CENTER), "--rate", str(WB_RATE), str(cap)]
        _reset_counts()
        rc, lines = _run_cli(dabscan.main, ["--json", *scan])
        launches = _counts()
        recs = {r["block"]: r for r in map(json.loads, lines)}
        print("dabscan --json: " + ", ".join(
            f"{b} {r.get('eid', '--')} {r.get('label', '')}".strip()
            for b, r in sorted(recs.items())))
        print(f"dabscan launches: {launches}")
        if rc != 0 or set(recs) != {"6A", "6B", "6C", "6D"}:
            raise AssertionError(f"dabscan: rc {rc}, blocks {sorted(recs)}")
        for block, (eid, label) in WB_MUXES.items():
            if (recs[block].get("eid"), recs[block].get("label")) != (
                    f"0x{eid:04X}", label):
                raise AssertionError(f"dabscan {block}: {recs[block]}")
        if "eid" in recs["6B"]:
            raise AssertionError("dabscan found an ensemble in 6B")
        if (launches["acs4"], launches["traceback4"]) != (1, 1):
            raise AssertionError("dabscan's FIC pass is not one K1 and one "
                                 "K2 launch")
        rc, lines = _run_cli(dabscan.main, scan)
        b_line = next(line for line in lines if line.startswith("6B"))
        print(f"dabscan: {' | '.join(lines)}")
        if rc != 0 or "--" not in b_line:
            raise AssertionError("dabscan text output")


def _device_ops(fn) -> str:
    """Device operations (kernels, copies, sets) ``fn`` runs, from a
    ``torch.profiler`` trace of one call, or "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA")
    return str(n) if n else "not measured"


def channel_batch_phase(rng, card: str) -> None:
    """8 flagship streams as one batched block."""
    ens = S.flagship_ensemble()
    x, payload = S.modulate(ens, BATCH_FRAMES + 3, rng)
    n = block_samples(BATCH_FRAMES)
    starts = [300 + 9000 * c for c in range(BATCH)]
    xs = np.stack([
        awgn(carrier_offset(x[st:], cfo), SNR_DB, rng)[:n]
        for st, cfo in zip(starts, BATCH_CFO_HZ)])
    xd = torch.from_numpy(xs).cuda()
    dec = ens.decode_config()
    subs = dec.subchannels
    cif0 = torch.tensor(0, dtype=torch.int32, device="cuda")

    def rings(lead=()):
        return {str(s.subchid): torch.zeros(
            (*lead, 16, s.profile.tx_bits), device="cuda") for s in subs}

    def batched():
        out, _, _ = channel_parallel_block(xd, rings((BATCH,)), cif0,
                                           ensemble=dec,
                                           n_frames=BATCH_FRAMES)
        return to_host(out)

    def single(c=0):
        out, _, _ = process_block(xd[c], rings(), cif0, ensemble=dec,
                                  n_frames=BATCH_FRAMES)
        return to_host(out)

    _reset_counts()
    out = batched()
    launches = _counts()
    print(f"channel batch launches: {launches}")
    if (launches["acs4"], launches["traceback4"]) != (1, 1):
        raise AssertionError("the batch is not one K1 and one K2 launch")

    # the batch's one lane batch, as channel_parallel_block builds it
    jobs = []
    for c in range(BATCH):
        sync = coarse_null_sync(xd[c])
        off = torch.arange(BATCH_FRAMES, dtype=torch.int32,
                           device="cuda") * FRAME_SIZE
        jobs += pre_viterbi(xd[c], sync["null_start"] + off, rings(), cif0,
                            ensemble=dec)[2]
    soft, lengths = V.ragged_lanes(jobs)
    print(f"channel batch lanes: {soft.shape[0]} = {BATCH} x (32 FIC + 288 "
          f"MSC), {soft.shape[1] // 8} double steps")
    if soft.shape[0] != BATCH * (32 + 288):
        raise AssertionError("unexpected lane count")

    n_rows = BATCH_FRAMES * 4
    for c in range(BATCH):
        ref = single(c)
        if not np.array_equal(out["fib_bytes"][c], ref["fib_bytes"]):
            raise AssertionError(f"stream {c}: FIB bytes differ from its "
                                 f"process_block")
        for s in subs:
            key = str(s.subchid)
            if not np.array_equal(out["subch"][key][c], ref["subch"][key]):
                raise AssertionError(f"stream {c} subch {key}: bytes "
                                     f"differ from its process_block")
            # the stream starts inside frame 0: its CIF 0 is frame 1's
            for j in range(15, n_rows):
                if (out["subch"][key][c, j].tobytes()
                        != payload[s.subchid][4 + j - 15].tobytes()):
                    raise AssertionError(f"stream {c} subch {key} row {j} "
                                         f"differs from the modulator's")
    print(f"channel batch: {BATCH} streams' FIB and sub-channel bytes equal "
          f"their own process_block; rows 15-{n_rows - 1} of all 9 "
          f"sub-channels equal the modulator's payload")

    b, n4 = soft.shape
    soft8 = soft.reshape(b, n4 // 8, 8)
    t2 = torch.from_numpy((lengths // 2).astype(np.int32)).cuda()
    ws4 = V._ws4(soft.device)
    dec_k, bits_k, *_ = hold_k1k2(soft8, t2, ws4,
                                  f"channel batch, {b} lanes")
    acs_ms = time_ms(lambda: K.acs4(soft8, t2, ws4), 10, KERNEL_RUN)
    tb_ms = time_ms(lambda: K.traceback4(dec_k), 10, KERNEL_RUN)
    acs_bound, tb_bound = _k1k2_bounds(lengths, dec_k, bits_k, ws4)
    print(f"K1 acs4 at {b} lanes: {acs_ms:.4f} ms, "
          f"{_us_per_step(acs_ms, n4 // 8)}, bound {acs_bound[0]:.4f} ms by "
          f"{acs_bound[1]}; K2 traceback4: {tb_ms:.4f} ms, "
          f"{_us_per_step(tb_ms, n4 // 8)}, bound {tb_bound[0]:.4f} ms by "
          f"{tb_bound[1]}; on {card}")

    walls = {"batched": [], "single": []}
    for _ in range(7):
        for name, fn in (("batched", batched), ("single", single)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            walls[name].append(time.perf_counter() - t0)
    tb = statistics.median(walls["batched"][1:]) * 1e3
    t1 = statistics.median(walls["single"][1:]) * 1e3
    sig = BATCH_FRAMES * 96.0                      # ms of signal per stream
    print(f"channel batch: {tb:.2f} ms per batched block of {BATCH} x "
          f"{BATCH_FRAMES} frames = {BATCH * sig / tb:.1f}x real time "
          f"aggregate, {sig / tb:.1f}x per stream; single stream: "
          f"{t1:.2f} ms per {BATCH_FRAMES}-frame block = {sig / t1:.1f}x; "
          f"batched / ({BATCH} x single) = {tb / (BATCH * t1):.3f} (host "
          f"clock, median of 6 after a warm-up, device-resident complex64 "
          f"input, ending in the one download) on {card}")
    print(f"device operations per block: batched {_device_ops(batched)}, "
          f"single {_device_ops(single)} (torch.profiler)")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = device_phase()
    t_start = time.perf_counter()
    build_phase()
    rng = np.random.default_rng(SEED)
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s")
        return res

    kern = phase("kernels", kernel_phase, rng)
    r2 = phase("radix-2", radix2_phase, rng)
    oh = phase("one-hot", onehot_phase, kern)
    e2e = phase("end-to-end", end_to_end_phase, rng)
    phase("steady state", steady_state_phase, e2e["u8"], e2e["ensemble"],
          card)
    phase("TII", tii_phase, rng, e2e["u8"])
    phase("resampler", resampler_phase, rng, card)
    phase("wideband + dabscan", wideband_phase, rng, card)
    phase("channel batch", channel_batch_phase, rng, card)
    print(f"all phases: {time.perf_counter() - t_start:.1f} s (build "
          f"included)")
    # Each kernel's launches come from the path that drives it: K1/K2 from
    # the end-to-end decode, K3/K4 from the radix-2 decode, K2' from the
    # onehot64 decode.
    records = {**kern["records"], **r2["records"], **oh["records"]}
    launches = {**e2e["launches"],
                "acs2": r2["launches"]["acs2"],
                "traceback2": r2["launches"]["traceback2"],
                "traceback4_onehot64":
                    oh["launches"]["traceback4_onehot64"]}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"dabtools_tpu_torch/csrc/{SOURCES[name]}",
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": records[name]["max_abs_err"],
         "ms": records[name]["ms"], "plain_ms": records[name]["plain_ms"],
         "bound_ms": records[name]["bound"][0],
         "bound_by": records[name]["bound"][1],
         # no single PyTorch call computes a Viterbi decode
         "library_ms": None}
        for name in KERNELS]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

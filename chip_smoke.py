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
   ``traceback2_plain`` exactly; then the same on adversarial batches
   at the kernels' chunk edges (640 lanes of 33 and of 65 steps,
   integer-valued soft bits, half of them erased: ties everywhere);
   median times;
3b. the one-hot traceback K2': the decode with ``traceback="onehot64"``
   at the flagship ragged shape must launch K1 and K2' and equal the
   messages; K2' on K1's decisions of phase 3's two batches (the flagship
   shape and the adversarial chunk-edge batch) must equal K2's bits,
   ``traceback4_plain``'s and ``traceback4_onehot64_plain``'s; median
   times of K2' and its plain version, beside K2's;
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
9. RS: 2048 RS(120,110) codewords (0-5 byte errors a row, every eighth
   row 6-8) and 256 RS(204,188) codewords (0-8, every fourth row 9-12)
   through ``make_rs_decoder`` on the card: data and counts must equal
   the NumPy codec's (``utils.gf256.rs_decode``); one decode under the
   sync debug mode 'error'; codewords/s from CUDA events.
10. mixed mux: 6 x 128 kbit/s EEP 3-A, UEP (Table 31 idx 16) and DAB+
   (72 kbit/s EEP 3-A of real superframes) modulated for 40 frames,
   impaired to u8 as in phase 5, through ``DabReceiver(n_frames=16,
   ensemble=mix)``: every ETI frame's 8 payloads equal the modulator's,
   ``SuperframeDecoder(72)`` on the DAB+ sub-channel gives a run of the
   original access units with good CRCs, and K1/K2 launch once per
   device step.
11. time-block span: the mixed mux as a 2 x 4 ``timeblock_receiver``
   span on one card (8 mesh cells on ``cuda:0``, 6 own and 5 warmup
   frames per shard): every FIB CRC good, every row equal to the
   modulator's payload and to the sequential decode's, one K1 and one K2
   launch per span, the host half (``EtiAssembler.frame_batch`` ->
   ``EtiParser`` -> ``SuperframeDecoder``) gives the original access
   units, a warm span passes the sync-free check; K1/K2 held against
   their plain versions at the span's lane batch and timed; ms per span,
   the aggregate real-time multiple and the device operations per span
   beside one cell's ``pre_viterbi``.
12. span across processes: once the kernels and ``libdabhost.so`` are
   built, the script starts itself twice (``--span-worker RANK PORT
   DIR``, by ``subprocess``); both ranks use ``cuda:0`` and join a
   ``gloo`` group with ``init_multihost`` (NCCL will not put two ranks
   on one GPU, so the halos travel through host memory).  Phase 11's
   span with shards 0-1 on rank 0 and 2-3 on rank 1, each rank's input
   zero outside its own cells: one K1 and one K2 launch per rank, every
   FIB CRC good, and ``gather_span``'s bytes on both ranks equal to
   phase 11's output.  The sync-free check is not applied: the gloo
   exchange copies to the host by design.  Each rank's ms per span and
   the halo exchange's ms (host clock between barriers), beside phase
   11's ms and the whole span in one process again in rank 0's fresh
   process; device operations per rank.  A worker that exits non-zero
   or outlasts ``SPAN_WORKER_TIMEOUT_S`` fails the run.

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
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.cli import dab2eti, dabscan
from dabtools_tpu_torch.constants import MODE_I, RS_K, RS_N, RS_T
from dabtools_tpu_torch.eti.assemble import EtiAssembler
from dabtools_tpu_torch.eti.parse import EtiParser
from dabtools_tpu_torch.mod.convcode import conv_encode
from dabtools_tpu_torch.mod.impairments import (
    awgn,
    carrier_offset,
    quantize_u8,
)
from dabtools_tpu_torch.models.receiver import (
    DabReceiver,
    block_samples,
    pipeline_core,
    pre_viterbi,
    process_block,
    to_host,
)
from dabtools_tpu_torch.ops import viterbi as V
from dabtools_tpu_torch.ops import viterbi_cuda as K
from dabtools_tpu_torch.ops.fec import init_deinterleave_ring
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.resample import Resampler
from dabtools_tpu_torch.ops.rs import make_rs_decoder
from dabtools_tpu_torch.ops.sync import coarse_null_sync
from dabtools_tpu_torch.parallel.channel import channel_parallel_block
from dabtools_tpu_torch.parallel.mesh import (
    gather_span,
    init_multihost,
    make_receiver_mesh,
)
from dabtools_tpu_torch.parallel.timeblock import (
    exchange_halos,
    halo_sizes,
    timeblock_receiver,
)
from dabtools_tpu_torch.tables.bandiii import BAND_III as BAND
from dabtools_tpu_torch.utils import native
from dabtools_tpu_torch.utils.crc import crc16_ok_batch
from dabtools_tpu_torch.utils.gf256 import rs_decode, rs_encode, rs_parity

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
RS_BATCH = 2048                 # phase 9: RS(120,110) codewords, as bench.py
RS2_BATCH = 256                 # RS(204,188) codewords
MIX_FRAMES = 40                 # phase 10: 2 device steps of 16 frames
TB_FRAMES = 6                   # phase 11: own frames per time shard
TB_WARMUP = 5                   # warmup frames re-priming each shard
SPAN_RANKS = 2                  # phase 12: processes sharing the span
SPAN_WORKER_TIMEOUT_S = 300     # both ranks' whole runs, from the spawn
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


def adversarial_check(rng, ws4: torch.Tensor, t2_max: int):
    """K1/K2 against their plain versions on 640 lanes of ``t2_max``
    double steps whose lengths probe the kernels' chunk edges (0, 1, a
    chunk and either side of it, 2 chunks + 3, the whole width, random),
    with the radix-2 phase's noise and a third of the soft bits erased to
    exactly 0 (ACS ties).  Returns :func:`hold_k1k2`'s result."""
    soft_np = (1.0 - 2.0 * rng.integers(0, 2, size=(R2_LANES, t2_max, 8))
               + rng.normal(scale=R2_NOISE, size=(R2_LANES, t2_max, 8)))
    soft_np[rng.random(soft_np.shape) < R2_ERASED] = 0.0
    edges = np.array([0, 1, K.CHUNK - 1, K.CHUNK, K.CHUNK + 1,
                      2 * K.CHUNK + 3, t2_max - 1, t2_max])
    t2_np = rng.integers(0, t2_max + 1, size=R2_LANES)
    t2_np[: 8 * len(edges)] = np.tile(edges, 8)
    return hold_k1k2(
        torch.from_numpy(soft_np.astype(np.float32)).cuda(),
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

    adv = adversarial_check(rng, ws4, n4 // 8)

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
        "msgs": msgs, "soft": soft, "lengths": lengths,
        "batches": {"flagship ragged shape": (dec_k, bits_k, bits_p),
                    "adversarial chunk-edge batch": adv[:3]}}


def hold_k3k4(soft4, ws2, what: str):
    """K3's decisions and metrics and K4's bits against their plain
    versions on the same inputs; raises unless they are equal.  Returns
    (K3's decisions, K4's bits, K3's max metric difference, K4's max bit
    difference)."""
    dec_k, metric_k = K.acs2(soft4, ws2)
    dec_p, metric_p = V.acs2_plain(soft4, ws2)
    bits_k = K.traceback2(dec_k)
    bits_p = V.traceback2_plain(dec_k)
    torch.cuda.synchronize()
    n_dec_diff = int((dec_k != dec_p).sum())
    acs_err = float((metric_k - metric_p).abs().max())
    tb_err = int((bits_k.int() - bits_p.int()).abs().max())
    print(f"{what}: K3 acs2 vs plain: {n_dec_diff} decision words differ, "
          f"max |metric diff| {acs_err}; K4 traceback2 vs plain: max |bit "
          f"diff| {tb_err}")
    if n_dec_diff or acs_err or tb_err:
        raise AssertionError(f"radix-2 kernel and plain version disagree: "
                             f"{what}")
    return dec_k, bits_k, acs_err, tb_err


def radix2_phase(rng) -> dict:
    """K3/K4 at full width: the odd-length decode through
    ``viterbi_decode``, then each kernel against its plain version, at
    full width and on adversarial batches at the chunk edges."""
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
    dec_k, bits_k, acs_err, tb_err = hold_k3k4(
        soft4, ws2, f"full width, {b} lanes x {n4 // 4} steps")
    # Its own generator: the later phases' signals do not depend on it.
    adv = np.random.default_rng(SEED + 1)
    for t in (K.CHUNK + 1, 2 * K.CHUNK + 1):
        s = adv.integers(-2, 3, size=(R2_LANES, t, 4)).astype(np.float32)
        s[adv.random(s.shape) < 0.5] = 0.0
        _, _, a_err, t_err = hold_k3k4(
            torch.from_numpy(s).cuda(), ws2,
            f"adversarial radix-2 batch, {R2_LANES} lanes x {t} steps, "
            f"integer soft bits, half erased")
        acs_err, tb_err = max(acs_err, a_err), max(tb_err, t_err)

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
    """K2': the decode with ``traceback="onehot64"`` at the flagship ragged
    shape, then K2' on K1's decisions of phase 3's batches against K2 and
    both plain tracebacks."""
    _reset_counts()
    bits, _ = V.viterbi_decode4(kern["soft"], kern["lengths"],
                                traceback="onehot64")  # the entry point
    torch.cuda.synchronize()
    launches = _counts()
    print(f"one-hot decode launches: {launches}")
    if (launches["acs4"], launches["traceback4_onehot64"],
            launches["traceback4"]) != (1, 1, 0):
        raise AssertionError("the onehot64 decode is not one K1 and one K2' "
                             "launch")
    bits = bits.cpu().numpy()
    o = 0
    for m, name in zip(kern["msgs"], ("FIC", "MSC")):
        wrong = int((bits[o:o + m.shape[0], :m.shape[1]] != m).sum())
        print(f"one-hot decode, {name}: {wrong} bit errors")
        if wrong:
            raise AssertionError(f"onehot64 {name} decode differs")
        o += m.shape[0]

    err = 0
    for what, (dec, bits_k, bits_p) in kern["batches"].items():
        bits_o = K.traceback4_onehot64(dec)
        bits_op = V.traceback4_onehot64_plain(dec)
        torch.cuda.synchronize()
        errs = [int((bits_o.int() - b.int()).abs().max())
                for b in (bits_k, bits_p, bits_op)]
        print(f"{what}: K2' traceback4_onehot64 max |bit diff| {errs[0]} vs "
              f"K2, {errs[1]} vs traceback4_plain, {errs[2]} vs "
              f"traceback4_onehot64_plain")
        if any(errs):
            raise AssertionError(f"K2' disagrees with K2 or a plain "
                                 f"version: {what}")
        err = max(err, *errs)
    dec = kern["batches"]["flagship ragged shape"][0]
    ms = time_ms(lambda: K.traceback4_onehot64(dec), 10, KERNEL_RUN)
    plain_ms = time_ms(lambda: V.traceback4_onehot64_plain(dec), 3)
    k2 = kern["records"]["traceback4"]
    steps = dec.shape[1]
    print(f"K2' traceback4_onehot64: {ms:.4f} ms, {_us_per_step(ms, steps)} "
          f"(plain {plain_ms:.2f} ms); K2 traceback4: {k2['ms']:.4f} ms, "
          f"{_us_per_step(k2['ms'], steps)}")
    # K2' computes K2's function: the same bytes, so the same bound.
    return {"launches": launches, "records": {"traceback4_onehot64": {
        "max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
        "bound": k2["bound"]}}}


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
    """Device operations (kernels, copies, sets) ``fn`` runs and their
    summed device time, from a ``torch.profiler`` trace of one call, or
    "not measured"."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    n = sum(e.count for e in events)
    us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    if not n:
        return "not measured"
    return f"{n} ({us / 1e3:.3f} ms on the device)" if us else str(n)


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


def rs_phase(rng, card: str) -> None:
    """The batched RS decoder on the card against the NumPy codec, sync
    free, and its codewords/s."""
    def corrupt(cw, errs):
        bad = cw.copy()
        for row, k in enumerate(errs):
            for p in rng.choice(cw.shape[1], size=k, replace=False):
                bad[row, p] ^= rng.integers(1, 256)
        return bad

    # RS(120,110) as bench.py builds its batch; 0-5 byte errors a row,
    # every eighth row 6-8 (uncorrectable, or miscorrected alike)
    errs = rng.integers(0, RS_T + 1, size=RS_BATCH)
    errs[::8] = rng.integers(RS_T + 1, RS_T + 4, size=RS_BATCH // 8)
    data = rng.integers(0, 256, size=(RS_BATCH, RS_K), dtype=np.uint8)
    bad = corrupt(rs_encode(data), errs)
    # RS(204,188), t=8: 0-8 errors, every fourth row 9-12
    errs2 = rng.integers(0, 9, size=RS2_BATCH)
    errs2[::4] = rng.integers(9, 13, size=RS2_BATCH // 4)
    data2 = rng.integers(0, 256, size=(RS2_BATCH, 188), dtype=np.uint8)
    bad2 = corrupt(np.concatenate([data2, rs_parity(data2, 16)], axis=1),
                   errs2)
    t0 = time.perf_counter()
    want = rs_decode(bad), rs_decode(bad2, n_parity=16)
    print(f"NumPy codec: {RS_BATCH} + {RS2_BATCH} codewords in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    cw = torch.from_numpy(bad).cuda()
    for (n, k), x, (ref_data, ref_n), e in (
            ((RS_N, RS_K), cw, want[0], errs),
            ((204, 188), torch.from_numpy(bad2).cuda(), want[1], errs2)):
        got_data, got_n = make_rs_decoder(n, k)(x)
        got_data, got_n = got_data.cpu().numpy(), got_n.cpu().numpy()
        if not (np.array_equal(got_data, ref_data)
                and np.array_equal(got_n, ref_n)):
            raise AssertionError(f"RS({n},{k}) on the card differs from "
                                 f"the NumPy codec")
        print(f"RS({n},{k}): {x.shape[0]} codewords, {int((e > 0).sum())} "
              f"with errors, {int((got_n < 0).sum())} flagged "
              f"uncorrectable; data and counts equal the NumPy codec's")
    dec = make_rs_decoder()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dec(cw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("rs_decode_batch: no host synchronization inside (sync debug "
          "mode 'error')")
    ms = time_ms(lambda: dec(cw), 10, KERNEL_RUN)
    # one 128 kbit/s DAB+ service: 16 columns per 120 ms superframe
    print(f"RS(120,110): {ms:.4f} ms per batch of {RS_BATCH} = "
          f"{RS_BATCH / ms * 1e3:.0f} codewords/s = "
          f"{RS_BATCH / 16 / (ms * 1e-3) * 0.12:.0f}x real time in 128 "
          f"kbit/s services (CUDA events around {KERNEL_RUN} decodes "
          f"back to back, median of 10) on {card}")
    ops = _device_ops(lambda: dec(cw))
    print(f"device operations per RS(120,110) decode: {ops} "
          f"(torch.profiler)")


def mixed_phase(rng) -> None:
    """The mixed mux (EEP, UEP, DAB+) end to end from u8 on the card.

    The stream starts ``TIMING_OFFSET`` samples into frame 0, as phase 5's
    does: the receiver is given the ensemble, so its first block already
    decodes, and on a run of leading zeros its coarse sync would lock at
    0."""
    mix = S.mixed_ensemble()
    rows, aus = S.dabplus_superframes(MIX_FRAMES * 4, rng)
    x, payload = S.modulate(mix, MIX_FRAMES, rng,
                            rows={S.MIXED_DABPLUS: rows})
    u8 = S.impaired_u8(x, rng, SNR_DB, CFO_HZ, -TIMING_OFFSET)
    rx = DabReceiver(n_frames=BLOCK_FRAMES, ensemble=mix, device="cuda")
    _reset_counts()
    eti = rx.feed(u8)
    launches = _counts()
    raw = b"".join(eti)
    n = S.check_eti_payloads(eti, payload, S.first_payload_cif(raw, payload))
    if n < 32:
        raise AssertionError(f"mixed mux: only {n} ETI frames")
    print(f"mixed mux: {MIX_FRAMES} frames u8 (AWGN {SNR_DB} dB, CFO "
          f"{CFO_HZ} Hz, from sample {TIMING_OFFSET}); {n} ETI frames, all 8 "
          f"payloads (6 x EEP, UEP idx 16, DAB+) byte-identical to the "
          f"modulator's")
    frames = list(EtiParser().feed(raw))
    n_au = S.check_dabplus(
        [f.subchannel_data(S.MIXED_DABPLUS) for f in frames], aus)
    print(f"DAB+ sub-channel: {n_au} access units, every CRC good, a run "
          f"of the builder's")
    for name in ("acs4", "traceback4"):
        if launches[name] != rx.device_steps:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {rx.device_steps} device steps")
    print(f"mixed mux launches: {launches} in {rx.device_steps} device "
          f"steps")


def timeblock_phase(rng, card: str) -> dict:
    """The mixed mux as a 2 x 4 time-block span on one card; returns the
    span's inputs, its output on the host and its ms per span."""
    mix = S.mixed_ensemble()
    n_ch, n_time, f_own, warm = 2, 4, TB_FRAMES, TB_WARMUP
    g0 = warm + 1
    n_total = g0 + n_time * f_own + 1
    rows, aus = S.dabplus_superframes(n_total * 4, rng)
    x, payload = S.modulate(mix, n_total, rng, rows={S.MIXED_DABPLUS: rows})
    lh, rh = halo_sizes(warm)
    s0, sl = g0 * FRAME_SIZE, n_time * f_own * FRAME_SIZE

    def tile(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(a, (n_ch, a.size)))).cuda()

    span, prefix, suffix = (tile(x[s0:s0 + sl]), tile(x[s0 - lh:s0]),
                            tile(x[s0 + sl:s0 + sl + rh]))
    mesh = make_receiver_mesh(n_channels=n_ch, n_time=n_time,
                              devices=[torch.device("cuda", 0)] * 8)
    fn = timeblock_receiver(mesh, mix, frames_per_shard=f_own,
                            warmup_frames=warm)

    def run():
        return fn(span, prefix, suffix, g0)

    _reset_counts()
    out = to_host(run())
    launches = _counts()
    print(f"time-block span: mesh {mesh.shape} on one card, {f_own} own + "
          f"{warm} warmup frames per shard, g0 {g0}; launches {launches}")
    if (launches["acs4"], launches["traceback4"]) != (1, 1):
        raise AssertionError("the span is not one K1 and one K2 launch")

    n_frames = n_time * f_own
    n_rows = n_frames * 4
    fib = out["fib_bytes"]
    if fib.shape != (n_ch, n_frames, 12, 32):
        raise AssertionError(f"fib_bytes shape {fib.shape}")
    if not crc16_ok_batch(fib.reshape(-1, 32)).all():
        raise AssertionError("FIB CRC failures in the span")
    order = [s.subchid for s in mix.sorted_subchannels()]
    # the sequential receiver over frames 0..g0+n_frames-1 of channel 0
    seq, _, _ = pipeline_core(
        torch.from_numpy(x).cuda(),
        torch.arange(g0 + n_frames, dtype=torch.int32,
                     device="cuda") * FRAME_SIZE,
        {str(s.subchid): init_deinterleave_ring(s.profile.tx_bits, "cuda")
         for s in mix.subchannels},
        torch.zeros((), dtype=torch.int32, device="cuda"), ensemble=mix)
    seq = to_host(seq)
    for sc in order:
        got = out["subch"][str(sc)]
        want_seq = seq["subch"][str(sc)][g0 * 4: g0 * 4 + n_rows]
        for c in range(n_ch):
            if not np.array_equal(got[c], want_seq):
                raise AssertionError(f"subch {sc} channel {c}: rows differ "
                                     f"from the sequential decode")
            for j in range(n_rows):
                if (got[c, j].tobytes()
                        != payload[sc][g0 * 4 + j - 15].tobytes()):
                    raise AssertionError(f"subch {sc} channel {c} row {j} "
                                         f"differs from the modulator's")
    print(f"time-block span: every FIB CRC good; {n_rows} rows x "
          f"{len(order)} sub-channels x {n_ch} channels equal the "
          f"modulator's payload and the sequential decode's rows")

    # the host half: ETI frames -> parse -> payloads -> DAB+ access units
    asm = EtiAssembler(mix)
    fibs_list, subch_list, cif_ns = [], [], []
    for j in range(15, n_rows):
        n = g0 * 4 + j - 15
        fi, ci = n // 4 - g0, n % 4
        fibs_list.append([fib[0, fi, 3 * ci + k].tobytes()
                          for k in range(3)])
        subch_list.append({sc: out["subch"][str(sc)][0, j].tobytes()
                           for sc in order})
        cif_ns.append(n)
    frames = list(EtiParser().feed(b"".join(
        asm.frame_batch(fibs_list, subch_list))))
    if len(frames) != len(cif_ns):
        raise AssertionError("assembled ETI frames do not parse back")
    for k, f in enumerate(frames):
        if f.fic != b"".join(fibs_list[k]) or any(
                f.subchannel_data(sc) != payload[sc][cif_ns[k]].tobytes()
                for sc in order):
            raise AssertionError(f"ETI round trip differs at CIF "
                                 f"{cif_ns[k]}")
    n_au = S.check_dabplus(
        [f.subchannel_data(S.MIXED_DABPLUS) for f in frames], aus)
    print(f"time-block host half: {len(frames)} assembled ETI frames parse "
          f"back with their FIBs and payloads; {n_au} DAB+ access units "
          f"with good CRCs, a run of the builder's")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("time-block span: no host synchronization inside (sync debug "
          "mode 'error')")

    # K1/K2 against their plain versions at the span's lane batch, as
    # the receiver builds it: cell (c, i) reads samples [i*F*fr,
    # i*F*fr + LH + F*fr + RH) of prefix + span + suffix
    full = torch.cat([prefix, span, suffix], dim=1)
    guesses = (lh - warm * FRAME_SIZE) + torch.arange(
        warm + f_own, dtype=torch.int32, device="cuda") * FRAME_SIZE

    def cell(c, i):
        o = i * f_own * FRAME_SIZE
        rings = {str(s.subchid): init_deinterleave_ring(s.profile.tx_bits,
                                                        "cuda")
                 for s in mix.subchannels}
        cif0 = torch.tensor((g0 + i * f_own - warm) * 4, dtype=torch.int32,
                            device="cuda")
        return pre_viterbi(full[c, o: o + lh + f_own * FRAME_SIZE + rh],
                           guesses, rings, cif0, ensemble=mix)

    jobs = [j for c in range(n_ch) for i in range(n_time)
            for j in cell(c, i)[2]]
    soft, lengths = V.ragged_lanes(jobs)
    b, n4 = soft.shape
    soft8 = soft.reshape(b, n4 // 8, 8)
    t2 = torch.from_numpy((lengths // 2).astype(np.int32)).cuda()
    ws4 = V._ws4(soft.device)
    dec_k, bits_k, *_ = hold_k1k2(soft8, t2, ws4, f"time-block span, {b} "
                                  f"lanes of {sorted(set(lengths.tolist()))} "
                                  f"steps")
    acs_ms = time_ms(lambda: K.acs4(soft8, t2, ws4), 10, KERNEL_RUN)
    tb_ms = time_ms(lambda: K.traceback4(dec_k), 10, KERNEL_RUN)
    acs_bound, tb_bound = _k1k2_bounds(lengths, dec_k, bits_k, ws4)
    print(f"K1 acs4 at {b} lanes: {acs_ms:.4f} ms, bound "
          f"{acs_bound[0]:.4f} ms by {acs_bound[1]}; K2 traceback4: "
          f"{tb_ms:.4f} ms, bound {tb_bound[0]:.4f} ms by {tb_bound[1]}; "
          f"on {card}")

    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        to_host(run())
        walls.append(time.perf_counter() - t0)
    ms = statistics.median(walls[1:]) * 1e3
    sig = n_ch * n_frames * 96.0                   # ms of signal
    one = _device_ops(lambda: cell(0, 1))
    print(f"time-block span: {ms:.2f} ms per span of {n_ch} x {n_frames} "
          f"frames (+{warm} warmup frames per shard) = {sig / ms:.1f}x real "
          f"time aggregate (host clock, median of 5 after a warm-up, "
          f"device-resident complex64 input, ending in the one download) "
          f"on {card}")
    print(f"device operations per span: {_device_ops(run)} "
          f"(torch.profiler); one cell's pre_viterbi: {one}, x "
          f"{n_ch * n_time} cells")
    return {"inputs": {"span": span.cpu().numpy(),
                       "prefix": prefix.cpu().numpy(),
                       "suffix": suffix.cpu().numpy(), "g0": g0},
            "out": out, "ms": ms}


def _flat(tree: dict, prefix: str = "") -> dict:
    """A nested dict of arrays -> one level, keyed by path (``subch/1``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multiprocess_phase(tb: dict, card: str) -> None:
    """Phase 11's span on two processes of one card: shards 0-1 on rank
    0, 2-3 on rank 1, each rank a ``--span-worker`` run of this script.
    Their gathered bytes must equal phase 11's."""
    # The workers load the kernels and libdabhost.so that this process
    # built: nothing may build them again (utils/native.py builds with
    # make in any process that finds no library).
    K.build()
    if native.lib() is None:
        raise AssertionError("libdabhost.so is not built")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        np.savez(tmp / "span.npz", **tb["inputs"])
        port = str(_free_port())
        procs = [subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--span-worker", str(rank), port, str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(SPAN_RANKS)]
        deadline = time.monotonic() + SPAN_WORKER_TIMEOUT_S
        try:
            logs = [p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            for line in log.splitlines():
                print(f"  rank {rank}: {line}")
            if p.returncode:
                raise AssertionError(f"span worker {rank} exited "
                                     f"{p.returncode}")
        want = _flat(tb["out"])
        res = []
        for rank in range(SPAN_RANKS):
            got = np.load(tmp / f"rank{rank}.npz")
            differ = sorted(k for k in set(want) | set(got.files)
                            if k not in want or k not in got.files
                            or got[k].dtype != want[k].dtype
                            or got[k].shape != want[k].shape
                            or got[k].tobytes() != want[k].tobytes())
            if differ:
                raise AssertionError(f"rank {rank}: gathered span differs "
                                     f"from phase 11's in {differ}")
            res.append(json.loads((tmp / f"rank{rank}.json").read_text()))
    print(f"span across processes: both ranks' gather_span equals phase "
          f"11's one-process output byte for byte ({len(want)} leaves)")
    span_ms = ", ".join(f"{r['span_ms']:.2f}" for r in res)
    halo_ms = ", ".join(f"{r['halo_ms']:.2f}" for r in res)
    worst = max(r["span_ms"] for r in res)
    print(f"span across processes: {worst:.2f} ms per span on "
          f"{SPAN_RANKS} processes (the slower rank; ranks {span_ms}) "
          f"against {tb['ms']:.2f} ms in one process (phase 11, this "
          f"call); the halo exchange alone {halo_ms} ms (host clock "
          f"between barriers, median of 5 after a warm-up; gloo through "
          f"host memory, both ranks on cuda:0) on {card}")
    print(f"span across processes: the whole span in one process again, "
          f"in rank 0's fresh process (rank 1 waiting): "
          f"{res[0]['one_ms']:.2f} ms; 2 processes / 1 = "
          f"{worst / res[0]['one_ms']:.3f} (same clock and statistic)")
    for r in res:
        print(f"span across processes: rank {r['rank']} cells "
              f"{r['cells']}, launches {r['launches']}, device operations "
              f"per span {r['device_ops']} (torch.profiler); halo bytes "
              f"sent {r['halo_sent']}, received {r['halo_received']}")


def span_worker(rank: int, port: str, tmp: pathlib.Path) -> None:
    """One rank of phase 12 (``--span-worker RANK PORT DIR``)."""
    torch.cuda.set_device(0)
    # NCCL does not put two ranks on one GPU, so on a one-card machine
    # the halos travel through host memory under gloo.
    init_multihost(f"127.0.0.1:{port}", SPAN_RANKS, rank, backend="gloo")
    K.build()
    data = np.load(tmp / "span.npz")
    mix = S.mixed_ensemble()
    n_ch, n_time = data["span"].shape[0], 4
    cuda = torch.device("cuda", 0)
    mesh = make_receiver_mesh(
        n_channels=n_ch, n_time=n_time,
        devices=[(i // 2, cuda) for _ in range(n_ch) for i in range(n_time)])
    span, prefix, suffix = (data[k].copy() for k in ("span", "prefix",
                                                     "suffix"))
    shard = TB_FRAMES * FRAME_SIZE
    for c in range(n_ch):
        for i in range(n_time):
            if mesh.ranks[c][i] != rank:
                span[c, i * shard:(i + 1) * shard] = 0
        if mesh.ranks[c][0] != rank:
            prefix[c] = 0
        if mesh.ranks[c][-1] != rank:
            suffix[c] = 0
    span, prefix, suffix = (torch.from_numpy(a).to(cuda)
                            for a in (span, prefix, suffix))
    g0 = int(data["g0"])
    fn = timeblock_receiver(mesh, mix, frames_per_shard=TB_FRAMES,
                            warmup_frames=TB_WARMUP)

    def run():
        return fn(span, prefix, suffix, g0)

    _reset_counts()
    out = run()
    torch.cuda.synchronize()
    launches = _counts()
    if (launches["acs4"], launches["traceback4"]) != (1, 1):
        raise AssertionError(f"rank {rank}: the span is not one K1 and one "
                             f"K2 launch: {launches}")
    got = to_host(gather_span(out, mesh))
    if not crc16_ok_batch(got["fib_bytes"].reshape(-1, 32)).all():
        raise AssertionError(f"rank {rank}: FIB CRC failures in the span")
    np.savez(tmp / f"rank{rank}.npz", **_flat(got))
    print(f"launches {launches}; every FIB CRC of the gathered span good")
    print("the sync-free check is not applied here: the gloo halo "
          "exchange copies to the host by design")

    lh, rh = halo_sizes(TB_WARMUP)

    def between_barriers(fn) -> float:
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            dist.barrier()
            walls.append(time.perf_counter() - t0)
        return statistics.median(walls[1:]) * 1e3

    halo_ms = between_barriers(lambda: exchange_halos(
        mesh, span, prefix, suffix, shard, lh, rh))
    span_ms = between_barriers(lambda: to_host(run()))
    ops = _device_ops(run)
    # The whole span in one process again, timed as phase 11 times it but
    # in this fresh process (rank 1 waits): the parent has run ten phases
    # before phase 11.
    one_ms = None
    if rank == 0:
        whole = [torch.from_numpy(data[k]).to(cuda)
                 for k in ("span", "prefix", "suffix")]
        # every cell named rank 0's: a plain device list would be this
        # rank's share of a mesh gathered from both ranks
        one = timeblock_receiver(
            make_receiver_mesh(n_channels=n_ch, n_time=n_time,
                               devices=[(0, cuda)] * (n_ch * n_time)),
            mix, frames_per_shard=TB_FRAMES, warmup_frames=TB_WARMUP)
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            to_host(one(*whole, g0))
            walls.append(time.perf_counter() - t0)
        one_ms = statistics.median(walls[1:]) * 1e3
    dist.barrier()
    # across the one boundary between the ranks, rank 0 sends shard 2's
    # left halo and rank 1 shard 1's right halo, for each channel
    sent, received = ((lh, rh) if rank == 0 else (rh, lh))
    (tmp / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "cells": sorted(out), "launches": launches,
        "span_ms": span_ms, "halo_ms": halo_ms, "one_ms": one_ms,
        "device_ops": ops,
        "halo_sent": n_ch * sent * span.element_size(),
        "halo_received": n_ch * received * span.element_size()}))
    dist.destroy_process_group()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if argv[:1] == ["--span-worker"]:
        span_worker(int(argv[1]), argv[2], pathlib.Path(argv[3]))
        return 0
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
    phase("RS", rs_phase, rng, card)
    phase("mixed mux", mixed_phase, rng)
    tb = phase("time-block span", timeblock_phase, rng, card)
    phase("span across processes", multiprocess_phase, tb, card)
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
    sys.exit(main(sys.argv[1:]))

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
   modulator's bytes, and K1/K2 must have run once per device step on the
   device (counted in a device trace, so the blocks replayed as a CUDA
   graph count) and launched from Python once per block run op by op and
   twice per capture.  The device operations of one stream's 8-frame complex64 block (the
   count phase 8's batch is held against; it must stay within 5 of the
   403 it had before the demod chain took a stream axis) and of a 16-frame
   u8 block.  Then one warm ``process_block`` under PyTorch's sync debug
   mode 'error' (nothing inside may wait for the device).
5. TII: the flagship with TII (sub id 7, main id 31) in its null symbols,
   impaired to u8 as in phase 4, through ``DabReceiver(n_frames=16,
   tii=True)``: ``rx.tii()`` must give main id 31 and sub id 7, every ETI
   payload must stay the modulator's, ``process_block(tii=True)`` must
   pass the sync-free check, and phase 4's stream (no TII) must give
   None.
6. resampler: the flagship at 2.4 Msps (exact spectral resample) through
   ``Resampler(2_400_000)`` and the receiver, which takes the
   resampler's output on the card (``input_counts``: every block from
   the card): ETI payloads must be the
   modulator's; the resampler's input Msamples/s; one launch of its
   kernel (``csrc/resample.cu``) per call; the kernel against
   ``resample_plain`` at an 8-frame block (1,843,200 inputs, 1,572,864
   outputs), within 1e-5, and both their median times beside the
   kernel's bytes bound.
7. wideband + dabscan: one 8.192 Msps u8 capture at 184.5 MHz with a
   flagship-shaped mux of its own EId and label in 6A, 6C and 6D and
   nothing in 6B.  ``Channelizer`` fft against direct with TF32 on
   process-wide (within the JAX test's atol=2e-5) and each method's input
   Msamples/s; ``dab2eti --wideband`` must write three ETI files with
   each mux's payloads; ``dabscan`` (JSON and text) must find exactly the
   three EIds and labels, ``--`` for 6B, with one K1 and one K2 launch
   for all four candidate blocks.
8. channel batch: 8 flagship streams (one modulation; each its own CFO,
   start and noise seed) as one 8-frame ``channel_parallel_block``, which
   runs the demod chain once (one ``pre_viterbi`` over the 8 streams):
   one K1 and one K2 launch for 2560 lanes = 8 x (32 FIC + 288 MSC);
   each stream's FIB and sub-channel bytes equal its own
   ``process_block``, rows >= 15 equal the modulator's payload; the
   batched block passes the sync-free check.  Then the hard batch (3
   streams with integer CFOs of -2.4, +0.3 and +3.3 carriers, drifts of
   -50, 0 and +50 ppm, the last through TU6), checked the same way, each
   CFO estimate within 0.05 carriers of its own.  K1/K2 held against
   their plain versions at the 2560-lane batch and timed; the batched ms
   per block beside a single-stream 8-frame block, the device operations
   of each (``torch.profiler``; the batch must stay within 1.5x the
   single stream's) beside the 3142 the batch had stream by stream, and
   each one's peak memory (``max_memory_allocated``).
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
   the aggregate real-time multiple, the device operations per span (at
   most ``SPAN_OPS_MAX``; 3164 cell by cell) beside ``pre_viterbi`` over
   the 8 cells and over one, and the span's peak memory.
12. span across processes: once the kernels and ``libdabhost.so`` are
   built, the script starts itself twice (``--span-worker RANK PORT
   DIR``, by ``subprocess``); both ranks use ``cuda:0`` and join a
   ``gloo`` group with ``init_multihost`` (NCCL will not put two ranks
   on one GPU, so the halos travel through host memory).  Phase 11's
   span with shards 0-1 on rank 0 and 2-3 on rank 1, each rank's input
   zero outside its own cells: one K1 and one K2 launch per rank, every
   FIB CRC good, and ``gather_span``'s output on both ranks equal to
   phase 11's byte for byte, but for ``cfo_carriers`` within
   ``SPAN_FLOAT_TOL`` (a rank's batch of 4 cells sums its guard
   correlation in another order than phase 11's batch of 8).  The sync-free check is not
   applied: the gloo exchange copies to the host by design.  Each
   rank's ms per span and the halo exchange's ms (host clock between
   barriers), beside phase 11's ms and the whole span in one process
   again in rank 0's fresh process; device operations per rank (1559
   cell by cell) and its peak memory.  A worker that exits non-zero or
   outlasts ``SPAN_WORKER_TIMEOUT_S`` fails the run.
13. lab chain: the everything-mux of ``tests/test_everything_mux.py``
   (MP2 64 kbit/s with DLS and DL Plus, DAB+ 72 kbit/s, a 32 kbit/s FEC
   packet service carrying a 700-byte MOT object, language/PTy, linkage,
   FI, OE and time) through the port's commands only, in this process
   (``testsignal.lab_chain``): ``dabmux --cifs 100`` -> ``eti2iq
   --format u8 --snr 16 --cfo-hz 420`` -> ``dab2eti --format u8`` on
   the card (16-frame blocks) -> ``etiinfo``, ``eti2audio --all`` and
   ``eti2audio --sid 0x1111 --labels``.  Every off-air ETI frame's CRCs
   good and sub-channels 1-3 equal to the dabmux ETI's from the
   activation CIF on, FIG 0/14 through, ``epg.bin`` the object byte for
   byte beside an ``.mp2`` and an ``.aac`` file, the DLS, DL Plus and
   ``etiinfo`` metadata lines; K1 and K2 launch once per device step of
   ``dab2eti``'s receiver.  ``dab2eti``'s seconds and real-time multiple
   (host clock, file to file).
14. BER waterfall: ``tools/torch_ber_sweep.py``'s ``run_point`` on the
   card at 3, 4, 5, 6 and 8 dB SNR (AWGN) x 2 seeds x 12 frames of the
   closed-loop ensemble (EEP 3-A 64 kbit/s): acquisition and a frame
   decode rate of 1.0 at 6 and 8 dB for every seed; the curve on a line
   of its own beside the card's name and power limit.
15. impairments: the JAX package's robustness set on the card, its
   signals built by ``testsignal`` and ``mod.impairments`` (the same
   samples as the JAX tests'), each stream through
   ``DabReceiver(device="cuda")`` with K1/K2 launched once per device
   step.  Sync loss (``tests/test_robustness.py``: 8 frames, 4 of noise,
   8): against the port's CPU decode of the same samples, ERR bytes
   equal in count and place, FIC, FCT and streams equal on every frame,
   every ERR 0xFF frame byte-identical, the last frame 0xFF; then the
   gap block's dispatch (16 FIC and 16 noise codewords) through K1/K2
   against the plain versions and ``viterbi_decode4`` on the CPU, bits
   exact (ties decide there).  CFOs of 4300, 2500, -3500 and 1499 Hz:
   every payload the modulator's, the estimate within 0.05 carriers,
   every ERR 0xFF frame equal to the CPU decode.  Multipath
   (``tests/test_multipath.py``): the SFN echo, TU6 static, TU6 with 10
   Hz fading plus 300 Hz, RA4; payloads exact and the echo's and TU6's
   delay-spread windows.  The impaired span and batch
   (``tests/test_sharding_impaired.py``: TU6, 2.5 carriers, 50 ppm, 22
   dB; PRS search 448): the 2 x 4 span on ``cuda:0`` and 8 streams as
   one channel batch, one K1 and one K2 launch each, every row the
   modulator's, CFOs within 0.15 carriers of 2.5 (the span's spread under
   0.1).  The soak (``tests/test_soak.py``: 625 frames, 180 Hz, 14 dB,
   chunks of 1,000,003 samples) through ``DabReceiver(n_frames=8)``: no
   payload mismatch, FCT continuous, the host state's bounds, and
   ``memory_allocated`` after the last block at most 1 MiB above its
   value after the 10th device step; its real-time multiple (host clock,
   feed included) and ``max_memory_allocated``.
16. dabplus17: an all-DAB+ test multiplex (17 EEP sub-channels of
   16-128 kbit/s in 9 puncturing profiles, options A and B, 864/864 CUs;
   ``testsignal.dabplus17_ensemble``) modulated for 48 frames, impaired
   to u8 as in phase 4, through ``DabReceiver(n_frames=8)`` as
   ``dab2eti`` runs it: acquisition of the 17 sub-channels, every ETI
   frame's 17 payloads the modulator's, K1/K2 once per device step.
   Then one warm 8-frame ``process_block`` with the acquired state: its
   Viterbi jobs as ``ops.viterbi.ragged_lanes`` lays them out (lanes, live
   and padded trellis steps) must read 576 / 888,192 / 1,772,928, as the
   bit rates give them, and K1/K2 must equal ``acs4_plain`` /
   ``traceback4_plain`` on that block's 576 lanes of 9 lengths.

Every path starts with all five kernels' counts in ``cudalib.launches``
at 0 and reads them when it ends.  A path through ``DabReceiver`` also
counts K1 and K2 in a ``torch.profiler`` trace of the card: a block that
the receiver replays as a CUDA graph launches nothing from Python.  Each phase prints its seconds.  The line before the last
is the kernels' JSON record, with each kernel's bound: the larger of
the bytes it must move over the
card's memory rate and the operations it must do over its float32 rate
(counted from this run's inputs; see :func:`_bound`).  The last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import json
import pathlib
import re
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
from dabtools_tpu_torch.constants import (
    FIBS_PER_CODEWORD,
    FIC_INFO_BITS,
    MODE_I,
    RS_K,
    RS_N,
    RS_T,
    TAIL_BITS,
)
from dabtools_tpu_torch.eti.assemble import EtiAssembler
from dabtools_tpu_torch.eti.parse import EtiParser
from dabtools_tpu_torch.mod.convcode import conv_encode
from dabtools_tpu_torch.mod.impairments import (
    RA4,
    TU6,
    awgn,
    carrier_offset,
    multipath,
    quantize_u8,
    sfn_echo,
    u8_to_complex,
)
from dabtools_tpu_torch.models import receiver as R
from dabtools_tpu_torch.models.receiver import (
    DabReceiver,
    block_samples,
    pipeline_core,
    pre_viterbi,
    process_block,
    to_host,
)
from dabtools_tpu_torch.ops import cudalib
from dabtools_tpu_torch.ops import resample as RES
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
# Device operations when the batch and the span ran the demod chain
# stream by stream (torch.profiler on an NVIDIA H100 80GB HBM3, 700 W):
# one stream's 8-frame block, the 8-stream batch, the 2 x 4 span, one
# rank of the span on 2 ranks.
SINGLE_OPS_BEFORE = 403
BATCH_OPS_BEFORE = 3142
SPAN_OPS_BEFORE = 3164
RANK_OPS_BEFORE = 1559
SPAN_OPS_MAX = 800              # the span's bound with the stream axis
# A rank decodes its 4 cells as one batch and phase 11 all 8: the card
# sums the guard correlation behind ``cfo_carriers`` over a batch of 4
# and of 8 in another order (5.2e-18 apart on an NVIDIA H100 80GB HBM3,
# 700 W), so phase 12 holds that leaf to float32 rounding and every
# other leaf byte for byte.
SPAN_FLOAT_TOL = {"cfo_carriers": {"atol": 1e-9, "rtol": 1e-6}}
RS_BATCH = 2048                 # phase 9: RS(120,110) codewords, as bench.py
RS2_BATCH = 256                 # RS(204,188) codewords
MIX_FRAMES = 40                 # phase 10: 2 device steps of 16 frames
TB_FRAMES = 6                   # phase 11: own frames per time shard
TB_WARMUP = 5                   # warmup frames re-priming each shard
SPAN_RANKS = 2                  # phase 12: processes sharing the span
SPAN_WORKER_TIMEOUT_S = 300     # both ranks' whole runs, from the spawn
BER_SNRS = (3.0, 4.0, 5.0, 6.0, 8.0)  # phase 14: the waterfall's points
BER_CLEAN_SNRS = (6.0, 8.0)     # ... where every frame must decode
BER_SEEDS = 2
BER_FRAMES = 12
# phase 15: tests/test_robustness.py's CFO cases as (Hz, modulation seed,
# noise seed, SNR dB), tests/test_sharding_impaired.py's widened PRS
# search and batch, tests/test_soak.py's stream
IMP_CFO_CASES = ((4300.0, 3, 3, 16.0), (2500.0, 5, 7, 18.0),
                 (-3500.0, 5, 7, 18.0), (1499.0, 5, 7, 18.0))
IMP_SEARCH = 448
IMP_STREAMS = 8
SOAK_FRAMES = 625               # 60 s of stream
SOAK_STEP = 1_000_003           # ragged, prime-sized chunks
SOAK_MEM_SLACK = 2 ** 20        # memory_allocated growth allowed, bytes
DP17_FRAMES = 48                # phase 16: the all-DAB+ multiplex's frames
DP17_BLOCK = 8                  # ... in dab2eti's default blocks
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
    cudalib.build()
    dt = time.perf_counter() - t0
    print(f"build: {cudalib.library_path().name} in {dt:.2f} s")
    for line in cudalib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def _reset_counts() -> None:
    for name in KERNELS:
        cudalib.launches[f"dab_{name}"] = 0


def _counts() -> dict:
    return {name: cudalib.launches[f"dab_{name}"] for name in KERNELS}


def _launched_per_step(what: str, launches: dict, steps: int,
                       unit: str = "device steps") -> None:
    """K1 and K2 launched once per device step of ``what`` (or once per
    ``unit``)."""
    for name in ("acs4", "traceback4"):
        if launches[name] != steps:
            raise AssertionError(f"{what}: {name} launched "
                                 f"{launches[name]} times in {steps} "
                                 f"{unit}")


@contextlib.contextmanager
def _device_kernels():
    """A ``torch.profiler`` trace of the card around the ``with`` block.
    The dict it yields is filled on exit: how many times the device ran
    each of ``KERNELS``, counted by the kernel's name in the trace (a CUDA
    graph's replays included).  A trace with no device operation fails,
    so every count is measured."""
    from torch.profiler import ProfilerActivity, profile
    ran = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield ran
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    _measured((sum(e.count for e in events), 0.0), "kernel count")
    by_name = collections.Counter()
    for e in events:
        m = re.search(r"(\w+)_kernel\(", e.key)
        if m:
            by_name[m.group(1)] += e.count
    ran.update({name: by_name[name] for name in KERNELS})


def _passes(rx) -> collections.Counter:
    """``rx``'s device steps by how its chain ran: ``eager`` (op by op),
    ``captures`` (recorded as two CUDA graphs, then replayed) and
    ``replays``, after checking that they add up to its device steps."""
    c = collections.Counter({"eager": rx.device_steps} if rx.graphs is None
                            else rx.graphs.counts)
    if c["eager"] + c["captures"] + c["replays"] != rx.device_steps:
        raise AssertionError(f"graph passes {dict(c)} are not the "
                             f"{rx.device_steps} device steps")
    return c


def _receiver_launched(what: str, rx, launches: dict, ran: dict) -> None:
    """K1 and K2 of receiver ``rx``'s run: once per device step on the
    device (``ran``, from :func:`_device_kernels`), and from Python
    (``launches``) once per pass that launched the chain: each op-by-op
    pass and each of a capture's two recordings."""
    c = _passes(rx)
    _launched_per_step(f"{what}, on the device", ran, rx.device_steps)
    _launched_per_step(f"{what}, from Python", launches,
                       c["eager"] + 2 * c["captures"],
                       "passes that launched the chain")


def _graph_text(rx) -> str:
    """``rx``'s CUDA graph passes, in words."""
    c = _passes(rx)
    return (f"{c['replays']} of {rx.device_steps} device steps replayed as "
            f"a CUDA graph ({c['captures']} captures, {c['eager']} op by "
            f"op)")


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
    kernels' runs on the device in that decode, the u8 signal and the
    ensemble."""
    ens = S.flagship_ensemble()
    t0 = time.perf_counter()
    x, payload = S.modulate(ens, E2E_FRAMES, rng)
    u8 = S.impaired_u8(x, rng, SNR_DB, CFO_HZ, TIMING_OFFSET)
    print(f"signal: {E2E_FRAMES} frames, {u8.size // 2} samples u8, "
          f"AWGN {SNR_DB} dB, CFO {CFO_HZ} Hz, timing +{TIMING_OFFSET} "
          f"({time.perf_counter() - t0:.1f} s to modulate)")

    rx = DabReceiver(n_frames=BLOCK_FRAMES, device="cuda")
    _reset_counts()
    with _device_kernels() as ran:
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
    _receiver_launched("end to end", rx, launches, ran)
    print(f"kernels run on the device: {ran}, launched from Python: "
          f"{launches}, in {rx.device_steps} device steps; "
          f"{_graph_text(rx)}")
    if not rx.graphs.counts["replays"]:
        raise AssertionError("end to end: no block replayed")
    single_stream_ops(u8, ens)
    sync_free_check(rx, u8[: 2 * block_samples(BLOCK_FRAMES)])
    return {"launches": ran, "u8": u8, "ensemble": ens}


def single_stream_ops(u8: np.ndarray, ens) -> None:
    """Device operations of one stream's block: a ``BATCH_FRAMES``-frame
    complex64 block as phase 8's single stream runs it (the count the
    batch is held against), and a block as ``DabReceiver`` runs it."""
    dec = ens.decode_config()
    cif0 = torch.tensor(0, dtype=torch.int32, device="cuda")

    def rings():
        return {str(s.subchid): init_deinterleave_ring(s.profile.tx_bits,
                                                       "cuda")
                for s in dec.subchannels}

    xc = torch.from_numpy(
        u8_to_complex(u8[: 2 * block_samples(BATCH_FRAMES)])).cuda()
    xu = torch.from_numpy(u8[: 2 * block_samples(BLOCK_FRAMES)]).cuda()
    def block(x, n_frames):
        return to_host(process_block(x, rings(), cif0, ensemble=dec,
                                     n_frames=n_frames)[0])

    block(xc, BATCH_FRAMES)          # warm: the block's cached tables
    ops = _device_ops(lambda: block(xc, BATCH_FRAMES))
    u8_ops = _device_ops(lambda: block(xu, BLOCK_FRAMES))
    print(f"single stream: device operations per {BATCH_FRAMES}-frame "
          f"complex64 block {_ops_text(ops)}, per {BLOCK_FRAMES}-frame u8 "
          f"block as the receiver runs it {_ops_text(u8_ops)} "
          f"(torch.profiler; each ending in the one download); "
          f"{SINGLE_OPS_BEFORE} before the stream axis")
    if _measured(ops, "single stream") > SINGLE_OPS_BEFORE + 5:
        raise AssertionError(f"the single-stream block grew to {ops[0]} "
                             f"device operations")


def sync_free_check(rx, block_u8: np.ndarray) -> None:
    """One warm ``process_block`` on the card, as ``rx`` runs it (TII
    included if ``rx`` has it on), under PyTorch's sync debug mode
    'error': any op inside that waits for the device (a device->host
    read, a pageable upload) raises.  The block's one upload happens
    before, its one download after.  Then the same block as one replay
    of ``rx``'s CUDA graph, under the same mode (two warm calls before
    it capture the graph where ``rx`` has not yet)."""
    x = rx._upload(block_u8)
    what = f"process_block{' with TII' if rx._tii_enabled else ''}"

    def block(graphs=None):
        return process_block(
            x, rx._rings, rx._cif_count, ensemble=rx._decode.decode_config(),
            mode=rx.mode, n_frames=rx.n_frames, probe_subs=rx._probe_subs,
            tii=rx._tii_enabled, graphs=graphs)

    _sync_free(what, block)
    for _ in range(2):
        block(rx.graphs)
    replays = rx.graphs.counts["replays"]
    _sync_free(f"{what} replayed as a CUDA graph",
               lambda: block(rx.graphs))
    if rx.graphs.counts["replays"] != replays + 1:
        raise AssertionError(f"{what}: no graph replay "
                             f"({dict(rx.graphs.counts)})")


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


def _resample_kernel_time(rs: Resampler) -> None:
    """``csrc/resample.cu`` against ``resample_plain`` at the main path's
    shape, an 8-frame block at 2.4 Msps: equal within float32 rounding,
    then both timed, beside the kernel's bound.  Its own noise, so the
    later phases' draws stay as they were."""
    rng = np.random.default_rng(SEED + 6)
    keep = rs.taps_per_phase - 1
    n_out = 8 * FRAME_SIZE
    n_x = n_out * rs.down // rs.up
    tail, x = (torch.from_numpy(((rng.normal(size=n) + 1j * rng.normal(
        size=n)) / np.sqrt(2)).astype(np.complex64)).to("cuda")
               for n in (keep, n_x))
    args = (tail, x, rs._bank_dev, 0, 0, n_out, rs.down)
    got = RES.resample_cuda(*args)
    err = float((got - RES.resample_plain(*args)).abs().max())
    if err > 1e-5:
        raise AssertionError(f"resample kernel: max abs error {err}")
    ms = time_ms(lambda: RES.resample_cuda(*args), 10, KERNEL_RUN)
    plain = time_ms(lambda: RES.resample_plain(*args), 5)
    bound, by = _bound((n_x + keep + n_out) * 8 + rs.bank.nbytes,
                       4 * n_out * rs.taps_per_phase)
    print(f"resample kernel: {n_x} -> {n_out} samples {ms:.4f} ms "
          f"(bound {bound:.4f} ms by {by}, {ms / bound:.1f}x; max abs "
          f"error {err:.2e}), plain {plain:.4f} ms")


def resampler_phase(rng, card: str) -> None:
    """The flagship at 2.4 Msps through the resampler and the receiver."""
    ens = S.flagship_ensemble()
    x, payload = S.modulate(ens, RS_FRAMES, rng)
    x24 = S.fft_resample(awgn(x, SNR_DB, rng), int(round(x.size * 75 / 64)))
    rs = Resampler(2_400_000, device="cuda")
    rs(x24[:100_000])                                # warm-up, own stream
    rs = Resampler(2_400_000, device="cuda")
    launches = cudalib.launches["dab_resample"]
    t0 = time.perf_counter()
    y = rs(x24)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = cudalib.launches["dab_resample"] - launches
    if launches != 1:
        raise AssertionError(f"resampler: {launches} kernel launches in "
                             f"one call")
    if not (y.is_cuda and y.dtype == torch.complex64):
        raise AssertionError(f"resampler returned {y.dtype} on {y.device}")
    print(f"resampler: {x24.size} samples at 2.4 Msps -> {y.numel()} in "
          f"{dt * 1e3:.1f} ms = {x24.size / dt / 1e6:.1f} input Msamples/s "
          f"(host clock, upload and kernel included; the output stays on "
          f"the card) on {card}")
    _resample_kernel_time(rs)
    rx = DabReceiver(n_frames=BLOCK_FRAMES, device="cuda")
    eti = rx.feed(y)
    if rx.ensemble is None:
        raise AssertionError("resampled stream: no ensemble acquired")
    if rx.input_counts != {"host": 0, "card": rx.device_steps}:
        raise AssertionError(f"resampled stream: input counts "
                             f"{rx.input_counts}, {rx.device_steps} steps")
    raw = b"".join(eti)
    n = S.check_eti_payloads(eti, payload, S.first_payload_cif(raw, payload))
    print(f"resampled stream: {n} ETI frames, all 9 payloads "
          f"byte-identical to the modulator's")


def _channelizer_rate(x: np.ndarray,
                      method: str) -> tuple[torch.Tensor, float]:
    """One call of a fresh channelizer of the capture's 4 blocks on the
    whole capture (after a warm-up instance): (output on the card, input
    Msamples/s, host clock, upload and kernels included)."""
    offs = [f - WB_CENTER for f in (BAND[b] for b in ("6A", "6B", "6C",
                                                      "6D"))]
    Channelizer(WB_RATE, offs, method=method, device="cuda")(x[:1 << 20])
    ch = Channelizer(WB_RATE, offs, method=method, device="cuda")
    t0 = time.perf_counter()
    y = ch(x)
    torch.cuda.synchronize()
    return y, x.size / (time.perf_counter() - t0) / 1e6


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
    err = float((yf[:, :n] - yd[:, :n]).abs().max())
    print(f"channelizer, TF32 on process-wide: fft vs direct max |diff| "
          f"{err:.3g} (limit 2e-05); input Msamples/s: fft {rate_f:.1f}, "
          f"direct {rate_d:.1f} (host clock, one call on the whole capture, "
          f"upload and kernels included) on {card}")
    if not err <= 2e-5:
        raise AssertionError("channelizer fft and direct disagree")

    with tempfile.TemporaryDirectory() as tmp:
        cap = pathlib.Path(tmp) / "wide.u8"
        quantize_u8(wide).tofile(cap)
        outdir = pathlib.Path(tmp) / "eti"
        t0 = time.perf_counter()
        S.run_cli(dab2eti.main, [
            "--torch-device", "cuda", "--format", "u8", "--wideband",
            str(WB_CENTER), "--rate", str(WB_RATE), str(cap), "-o",
            str(outdir)])
        dt = time.perf_counter() - t0
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
        out, _ = S.run_cli(dabscan.main, ["--json", *scan])
        launches = _counts()
        lines = out.splitlines()
        recs = {r["block"]: r for r in map(json.loads, lines)}
        print("dabscan --json: " + ", ".join(
            f"{b} {r.get('eid', '--')} {r.get('label', '')}".strip()
            for b, r in sorted(recs.items())))
        print(f"dabscan launches: {launches}")
        if set(recs) != {"6A", "6B", "6C", "6D"}:
            raise AssertionError(f"dabscan: blocks {sorted(recs)}")
        for block, (eid, label) in WB_MUXES.items():
            if (recs[block].get("eid"), recs[block].get("label")) != (
                    f"0x{eid:04X}", label):
                raise AssertionError(f"dabscan {block}: {recs[block]}")
        if "eid" in recs["6B"]:
            raise AssertionError("dabscan found an ensemble in 6B")
        _launched_per_step("dabscan's FIC pass", launches, 1)
        lines = S.run_cli(dabscan.main, scan)[0].splitlines()
        b_line = next(line for line in lines if line.startswith("6B"))
        print(f"dabscan: {' | '.join(lines)}")
        if "--" not in b_line:
            raise AssertionError("dabscan text output")


def _device_ops(fn) -> tuple[int, float]:
    """Device operations (kernels, copies, sets) ``fn`` runs and their
    summed device time in us, from a ``torch.profiler`` trace of one
    call; (0, 0.0) where the trace shows none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.count for e in events),
            sum(getattr(e, "self_device_time_total", 0) for e in events))


def _measured(ops: tuple[int, float], what: str) -> int:
    """The operation count of ``ops``; a count of 0 (the trace showed no
    device operation) fails the check that needs it."""
    if not ops[0]:
        raise AssertionError(f"{what}: torch.profiler recorded no device "
                             f"operations, so its bound is not measured")
    return ops[0]


def _ops_text(ops: tuple[int, float]) -> str:
    n, us = ops
    if not n:
        return "not measured"
    return f"{n} ({us / 1e3:.3f} ms on the device)" if us else str(n)


def _peak_mib(fn) -> float:
    """``torch.cuda.max_memory_allocated`` over one call of ``fn``, MiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 20


def _sync_free(what: str, fn) -> None:
    """``fn`` under PyTorch's sync debug mode 'error': any op inside that
    waits for the device raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print(f"{what}: no host synchronization inside (sync debug mode "
          f"'error')")


def channel_batch_phase(rng, card: str) -> None:
    """8 flagship streams as one batched block, then the hard batch."""
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

    def batched(xb=xd):
        out, _, _ = channel_parallel_block(xb, rings((xb.shape[0],)), cif0,
                                           ensemble=dec,
                                           n_frames=BATCH_FRAMES)
        return to_host(out)

    def single(c=0, xb=xd):
        out, _, _ = process_block(xb[c], rings(), cif0, ensemble=dec,
                                  n_frames=BATCH_FRAMES)
        return to_host(out)

    def check_batch(what, xb, first_row):
        """``xb``'s batch against each stream's own ``process_block``
        and, from row 15, the modulator's payload (row ``j`` is CIF
        ``first_row + j - 15``); one K1 and one K2 launch."""
        _reset_counts()
        out = batched(xb)
        launches = _counts()
        print(f"{what} launches: {launches}")
        _launched_per_step(what, launches, 1)
        for c in range(xb.shape[0]):
            ref = single(c, xb)
            if not np.array_equal(out["fib_bytes"][c], ref["fib_bytes"]):
                raise AssertionError(f"{what} stream {c}: FIB bytes differ "
                                     f"from its process_block")
            for s in subs:
                key = str(s.subchid)
                if not np.array_equal(out["subch"][key][c],
                                      ref["subch"][key]):
                    raise AssertionError(f"{what} stream {c} subch {key}: "
                                         f"bytes differ from its "
                                         f"process_block")
                for j in range(15, n_rows):
                    if (out["subch"][key][c, j].tobytes()
                            != payload[s.subchid][first_row + j - 15]
                            .tobytes()):
                        raise AssertionError(f"{what} stream {c} subch "
                                             f"{key} row {j} differs from "
                                             f"the modulator's")
        print(f"{what}: {xb.shape[0]} streams' FIB and sub-channel bytes "
              f"equal their own process_block; rows 15-{n_rows - 1} of all "
              f"9 sub-channels equal the modulator's payload")
        return out

    n_rows = BATCH_FRAMES * 4
    # every stream starts inside frame 0: its CIF 0 is frame 1's
    check_batch("channel batch", xd, 4)
    _sync_free("channel_parallel_block", lambda: channel_parallel_block(
        xd, rings((BATCH,)), cif0, ensemble=dec, n_frames=BATCH_FRAMES))

    # the hard batch: integer CFO bins, drifts and a TU6 channel per stream
    hard = torch.from_numpy(S.hard_batch(x, n, SNR_DB, rng)).cuda()
    out = check_batch("hard batch", hard, 4)
    cfo = out["cfo_carriers"]
    print(f"hard batch: CFO {', '.join(f'{v:+.3f}' for v in cfo)} carriers "
          f"(sent {', '.join(f'{v:+.1f}' for v in S.HARD_CFO_CARRIERS)}), "
          f"drift {', '.join(f'{v:+g}' for v in S.HARD_PPM)} ppm, PRS "
          f"offsets spread {np.ptp(out['prs_offset'], axis=1).tolist()} "
          f"samples over {BATCH_FRAMES} frames, TU6 on stream 2")
    if np.abs(cfo - np.asarray(S.HARD_CFO_CARRIERS)).max() > 0.05:
        raise AssertionError("hard batch: a stream's CFO estimate is off")

    # the batch's one lane batch, as channel_parallel_block builds it
    ns = coarse_null_sync(xd)["null_start"]
    off = torch.arange(BATCH_FRAMES, dtype=torch.int32,
                       device="cuda") * FRAME_SIZE
    jobs = pre_viterbi(xd, ns[:, None] + off, rings((BATCH,)), cif0,
                       ensemble=dec)[2]
    soft, lengths = V.ragged_lanes(jobs)
    print(f"channel batch lanes: {soft.shape[0]} = {BATCH} x (32 FIC + 288 "
          f"MSC), {soft.shape[1] // 8} double steps")
    if soft.shape[0] != BATCH * (32 + 288):
        raise AssertionError("unexpected lane count")

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
    ops_b, ops_1 = _device_ops(batched), _device_ops(single)
    peak_b, peak_1 = _peak_mib(batched), _peak_mib(single)
    print(f"device operations per block: batched {_ops_text(ops_b)}, "
          f"single {_ops_text(ops_1)} (torch.profiler), batched / single "
          f"{ops_b[0] / max(ops_1[0], 1):.2f}; {BATCH_OPS_BEFORE} batched "
          f"and {SINGLE_OPS_BEFORE} single stream by stream; peak memory "
          f"batched {peak_b:.1f} MiB, single {peak_1:.1f} MiB "
          f"(max_memory_allocated) on {card}")
    if (_measured(ops_b, "channel batch")
            > 1.5 * _measured(ops_1, "single stream")):
        raise AssertionError(f"the batch runs {ops_b[0]} device operations, "
                             f"over 1.5x the single stream's {ops_1[0]}")


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
    _sync_free("rs_decode_batch", lambda: dec(cw))
    ms = time_ms(lambda: dec(cw), 10, KERNEL_RUN)
    # one 128 kbit/s DAB+ service: 16 columns per 120 ms superframe
    print(f"RS(120,110): {ms:.4f} ms per batch of {RS_BATCH} = "
          f"{RS_BATCH / ms * 1e3:.0f} codewords/s = "
          f"{RS_BATCH / 16 / (ms * 1e-3) * 0.12:.0f}x real time in 128 "
          f"kbit/s services (CUDA events around {KERNEL_RUN} decodes "
          f"back to back, median of 10) on {card}")
    ops = _ops_text(_device_ops(lambda: dec(cw)))
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
    with _device_kernels() as ran:
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
    _receiver_launched("mixed mux", rx, launches, ran)
    print(f"mixed mux: kernels run on the device {ran}, launched from "
          f"Python {launches}, in {rx.device_steps} device steps; "
          f"{_graph_text(rx)}")


def dabplus17_phase(rng) -> None:
    """The all-DAB+ multiplex end to end from u8 on the card in 8-frame
    blocks; then one warm block's ragged lanes, and K1/K2 against
    their plain versions on its lanes."""
    ens = S.dabplus17_ensemble()
    x, payload = S.modulate(ens, DP17_FRAMES, rng)
    u8 = S.impaired_u8(x, rng, SNR_DB, CFO_HZ, TIMING_OFFSET)
    rx, eti = _card_rx(u8, n_frames=DP17_BLOCK)
    if rx.ensemble.subchannels != ens.subchannels:
        raise AssertionError("dabplus17: acquired sub-channels differ")
    n = S.check_eti_payloads(eti, payload, rx._activation_cif)
    if n < 64:
        raise AssertionError(f"dabplus17: only {n} ETI frames")
    print(f"dabplus17: {DP17_FRAMES} frames u8 (AWGN {SNR_DB} dB, CFO "
          f"{CFO_HZ} Hz); {_graph_text(rx)}; {n} ETI frames, "
          f"all 17 payloads byte-identical to the modulator's")

    # one block as the receiver runs it, its Viterbi jobs recorded
    fic = MODE_I.n_fibs // FIBS_PER_CODEWORD * DP17_BLOCK
    cifs = MODE_I.n_cifs * DP17_BLOCK
    steps = ([FIC_INFO_BITS + TAIL_BITS] * fic
             + [s.bitrate_kbps * 24 + TAIL_BITS
                for s in ens.subchannels for _ in range(cifs)])
    lanes = len(steps)
    want = (lanes, sum(steps), lanes * max(steps))
    dispatches = []
    block = rx._upload(u8[: 2 * block_samples(DP17_BLOCK)])
    with _recording_dispatches(dispatches):
        to_host(process_block(
            block, rx._rings, rx._cif_count,
            ensemble=rx._decode.decode_config(), n_frames=DP17_BLOCK)[0])
    (jobs,) = dispatches
    soft, lengths = V.ragged_lanes(jobs)
    got = (len(lengths), int(lengths.sum()), len(lengths) * int(lengths.max()))
    print(f"dabplus17 block: ragged lanes {got[0]}, live steps {got[1]}, "
          f"padded steps {got[2]} ({want} from the bit rates; "
          f"{100 * (1 - got[1] / got[2]):.1f}% padding)")
    if got != want:
        raise AssertionError(f"dabplus17: ragged lanes {got}, not {want}")
    b, n4 = soft.shape
    print(f"dabplus17 lanes: {b} in {len(jobs)} jobs, trellis lengths "
          f"{sorted(set(lengths.tolist()))}")
    if b != lanes or len(set(lengths.tolist())) != 9:
        raise AssertionError("dabplus17: not 576 lanes of 9 lengths")
    hold_k1k2(soft.reshape(b, n4 // 8, 8),
              torch.from_numpy((lengths // 2).astype(np.int32)).cuda(),
              V._ws4(soft.device), f"dabplus17 block, {b} lanes")


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
    _launched_per_step("time-block span", launches, 1)

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

    _sync_free("time-block span", run)

    # K1/K2 against their plain versions at the span's lane batch, as
    # the receiver builds it: cell (c, i) reads samples [i*F*fr,
    # i*F*fr + LH + F*fr + RH) of prefix + span + suffix
    full = torch.cat([prefix, span, suffix], dim=1)
    guesses = (lh - warm * FRAME_SIZE) + torch.arange(
        warm + f_own, dtype=torch.int32, device="cuda") * FRAME_SIZE
    cells = [(c, i) for c in range(n_ch) for i in range(n_time)]

    def cell_batch(cells):
        """``pre_viterbi`` over ``cells``, one row each, as the span
        runs it."""
        rings = {str(s.subchid): torch.zeros(
            (len(cells), 16, s.profile.tx_bits), device="cuda")
            for s in mix.subchannels}
        cif0 = torch.tensor([(g0 + i * f_own - warm) * 4 for _, i in cells],
                            dtype=torch.int32, device="cuda")
        w = lh + f_own * FRAME_SIZE + rh
        xe = torch.stack([full[c, i * f_own * FRAME_SIZE:][:w]
                          for c, i in cells])
        return pre_viterbi(xe, guesses.expand(len(cells), -1), rings, cif0,
                           ensemble=mix)

    jobs = cell_batch(cells)[2]
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
    one = _device_ops(lambda: cell_batch([(0, 1)]))
    all_cells = _device_ops(lambda: cell_batch(cells))
    ops = _device_ops(run)
    peak = _peak_mib(run)
    print(f"time-block span: {ms:.2f} ms per span of {n_ch} x {n_frames} "
          f"frames (+{warm} warmup frames per shard) = {sig / ms:.1f}x real "
          f"time aggregate (host clock, median of 5 after a warm-up, "
          f"device-resident complex64 input, ending in the one download) "
          f"on {card}")
    print(f"device operations per span: {_ops_text(ops)} (torch.profiler; "
          f"{SPAN_OPS_BEFORE} cell by cell); pre_viterbi over its "
          f"{len(cells)} cells {_ops_text(all_cells)}, over one cell "
          f"{_ops_text(one)}; peak memory of the span {peak:.1f} MiB "
          f"(max_memory_allocated) on {card}")
    if _measured(ops, "time-block span") > SPAN_OPS_MAX:
        raise AssertionError(f"the span runs {ops[0]} device operations, "
                             f"over {SPAN_OPS_MAX}")
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
    cudalib.build()
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
        res, float_err = [], {}
        for rank in range(SPAN_RANKS):
            got = np.load(tmp / f"rank{rank}.npz")
            differ = sorted(k for k in set(want) | set(got.files)
                            if k not in want or k not in got.files
                            or got[k].dtype != want[k].dtype
                            or got[k].shape != want[k].shape
                            or (got[k].tobytes() != want[k].tobytes()
                                and (k not in SPAN_FLOAT_TOL
                                     or not np.allclose(got[k], want[k],
                                                        **SPAN_FLOAT_TOL[k]))))
            if differ:
                raise AssertionError(f"rank {rank}: gathered span differs "
                                     f"from phase 11's in {differ}")
            for k in SPAN_FLOAT_TOL:
                float_err[k] = max(float_err.get(k, 0.0), float(
                    np.abs(got[k] - want[k]).max()))
            res.append(json.loads((tmp / f"rank{rank}.json").read_text()))
    tol = ", ".join(f"{k} within atol={t['atol']}, rtol={t['rtol']} "
                    f"(max |diff| {float_err[k]:.3g})"
                    for k, t in SPAN_FLOAT_TOL.items())
    print(f"span across processes: both ranks' gather_span equals phase "
          f"11's one-process output byte for byte in "
          f"{len(want) - len(SPAN_FLOAT_TOL)} leaves, {tol}")
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
              f"per span {r['device_ops']} (torch.profiler; "
              f"{RANK_OPS_BEFORE} cell by cell), peak memory "
              f"{r['peak_mib']:.1f} MiB (max_memory_allocated); halo bytes "
              f"sent {r['halo_sent']}, received {r['halo_received']}")


def span_worker(rank: int, port: str, tmp: pathlib.Path) -> None:
    """One rank of phase 12 (``--span-worker RANK PORT DIR``)."""
    torch.cuda.set_device(0)
    # NCCL does not put two ranks on one GPU, so on a one-card machine
    # the halos travel through host memory under gloo.
    init_multihost(f"127.0.0.1:{port}", SPAN_RANKS, rank, backend="gloo")
    cudalib.build()
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
    _launched_per_step(f"rank {rank}'s span", launches, 1)
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
    peak = _peak_mib(run)
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
        "device_ops": _ops_text(ops), "peak_mib": peak,
        "halo_sent": n_ch * sent * span.element_size(),
        "halo_received": n_ch * received * span.element_size()}))
    dist.destroy_process_group()


def lab_chain_phase(card: str) -> None:
    """The everything-mux's lab chain through the port's commands, with
    ``dab2eti`` on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        _reset_counts()
        with _device_kernels() as ran:
            res = S.lab_chain(pathlib.Path(tmp), "cuda")
        launches = _counts()
    print(f"lab chain: dabmux -> eti2iq -> dab2eti (cuda) -> etiinfo, "
          f"eti2audio: {res['frames']} off-air ETI frames, sub-channels "
          f"1-3 equal to the dabmux ETI's; FIG 0/14, epg.bin, .mp2, .aac, "
          f"DLS, DL Plus and the etiinfo metadata all through")
    _receiver_launched("lab chain", res["receiver"], launches, ran)
    print(f"lab chain: kernels run on the device {ran}, launched from "
          f"Python {launches}, in {res['device_steps']} device steps; "
          f"{_graph_text(res['receiver'])}")
    print(f"lab chain: dab2eti {res['dab2eti_s']:.3f} s (under a device "
          f"trace) for a capture "
          f"of {res['air_s']:.3f} s of air = "
          f"{res['air_s'] / res['dab2eti_s']:.2f}x real time (host clock, "
          f"u8 file to ETI file, the receiver's set-up and acquisition "
          f"included; {res['frames']} ETI frames out, the capture's last "
          f"partial block undecoded) on {card}")


def ber_phase(card: str) -> None:
    """The decode-rate waterfall of the closed-loop ensemble on the
    card."""
    # by its path: an installed package named ``tools`` would shadow the
    # repo's directory, which has no ``__init__.py``
    path = pathlib.Path(__file__).resolve().parent / "tools" / \
        "torch_ber_sweep.py"
    spec = importlib.util.spec_from_file_location("torch_ber_sweep", path)
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    recs = []
    for snr in BER_SNRS:
        for seed in range(BER_SEEDS):
            rec = sweep.run_point(snr, 0.0, BER_FRAMES, seed, device="cuda")
            recs.append(rec)
            print(f"BER waterfall: SNR {snr:g} dB seed {seed}: "
                  f"acquired {rec['acquired']}, FIB CRC rate "
                  f"{rec['fib_crc_rate']:.3f}, {rec['eti_frames']} ETI "
                  f"frames, frame decode rate "
                  f"{rec['frame_decode_rate']:.3f}, {rec['wall_s']} s")
    rate = {snr: np.mean([r["frame_decode_rate"] for r in recs
                          if r["snr_db"] == snr]) for snr in BER_SNRS}
    curve = " ".join(f"{snr:g}dB={rate[snr]:.3f}" for snr in BER_SNRS)
    print(f"BER waterfall (frame decode rate, mean of {BER_SEEDS} seeds x "
          f"{BER_FRAMES} frames; AWGN, EEP 3-A 64 kbit/s, "
          f"tools/torch_ber_sweep.py): {curve} on {card}")
    for r in recs:
        if r["snr_db"] in BER_CLEAN_SNRS and not (
                r["acquired"] and r["frame_decode_rate"] == 1.0):
            raise AssertionError(f"BER waterfall: {r}")


@contextlib.contextmanager
def _recording_dispatches(dispatches):
    """Inside the block, each Viterbi dispatch's soft jobs (cloned) are
    appended to the list ``dispatches``; with None nothing is recorded."""
    real = R.viterbi_decode_ragged

    def recording(jobs):
        dispatches.append([j.clone() for j in jobs])
        return real(jobs)

    if dispatches is not None:
        R.viterbi_decode_ragged = recording
    try:
        yield
    finally:
        R.viterbi_decode_ragged = real


def _card_rx(x: np.ndarray, n_frames: int = 4, dispatches=None):
    """``x`` through ``DabReceiver(n_frames, device="cuda")``; returns
    (rx, its ETI) after checking K1/K2 ran once per device step (see
    :func:`_receiver_launched`).  With a list ``dispatches``, the
    receiver launches op by op (a replay runs no Python) and each device
    step's Viterbi dispatch's soft jobs are appended to it."""
    rx = DabReceiver(n_frames=n_frames, device="cuda")
    if dispatches is not None:
        rx.graphs = None
    _reset_counts()
    with _recording_dispatches(dispatches), _device_kernels() as ran:
        eti = rx.feed(x)
    _receiver_launched("receiver", rx, _counts(), ran)
    if dispatches is not None and len(dispatches) != rx.device_steps:
        raise AssertionError(f"{len(dispatches)} Viterbi dispatches in "
                             f"{rx.device_steps} device steps")
    if rx.ensemble is None:
        raise AssertionError("no ensemble acquired")
    return rx, eti


def _clean_frames_as_cpu(what: str, eti, x: np.ndarray) -> list:
    """The port's CPU decode of ``x`` against the card's ETI ``eti``: the
    same number of frames, the same ERR bytes in the same places, FIC
    bytes, FCT and streams equal on every frame, and every frame with ERR
    0xFF byte for byte.  Returns the ERR bytes."""
    ref = DabReceiver(n_frames=4, device="cpu").feed(x)
    if len(eti) != len(ref):
        raise AssertionError(f"{what}: {len(eti)} ETI frames on the card, "
                             f"{len(ref)} on the CPU")
    errs = []
    for k, (raw_c, raw_h, fc, fh) in enumerate(zip(
            eti, ref, EtiParser().feed(b"".join(eti)),
            EtiParser().feed(b"".join(ref)))):
        if (fc.err, fc.fic, fc.fct, set(fc.streams)) != (
                fh.err, fh.fic, fh.fct, set(fh.streams)):
            raise AssertionError(f"{what}: ETI frame {k}'s ERR, FIC, FCT "
                                 f"or streams differ from the CPU decode")
        if fc.err == 0xFF and raw_c != raw_h:
            raise AssertionError(f"{what}: ETI frame {k} (ERR 0xFF) "
                                 f"differs from the CPU decode")
        errs.append(fc.err)
    return errs


def _sync_loss_check() -> None:
    """The sync-loss stream on the card against the CPU decode, then the
    gap block's noise codewords through K1/K2 against the plain
    versions."""
    x, sent = S.sync_loss_stream()
    dispatches = []
    rx, eti = _card_rx(x, dispatches=dispatches)
    errs = _clean_frames_as_cpu("sync loss", eti, x)
    flagged = [k for k, e in enumerate(errs) if e != 0xFF]
    if not flagged or errs[-1] != 0xFF or 0xFF not in errs:
        raise AssertionError(f"sync loss: ERR bytes {errs}")
    noise = sum(f.subchannel_data(1) not in sent
                for f in EtiParser().feed(b"".join(eti)))
    print(f"sync loss (8 frames, 4 of noise, 8): {len(eti)} ETI frames, "
          f"ERR-flagged {flagged[0]}-{flagged[-1]} ({len(flagged)}), the "
          f"last 0xFF; ERR, FIC, FCT and streams equal to the CPU decode "
          f"on every frame, every 0xFF frame byte-identical; {noise} "
          f"payloads decoded from noise (not compared)")
    # the last dispatch decodes the gap: 16 FIC + 16 noise codewords
    jobs = dispatches[-1]
    if [tuple(j.shape) for j in jobs] != [(16, 3096), (16, 6168)]:
        raise AssertionError(f"sync loss: gap block jobs "
                             f"{[tuple(j.shape) for j in jobs]}")
    soft, lengths = V.ragged_lanes(jobs)
    b, n4 = soft.shape
    t2 = torch.from_numpy((lengths // 2).astype(np.int32)).cuda()
    _, bits_k, *_ = hold_k1k2(soft.reshape(b, n4 // 8, 8), t2,
                              V._ws4(soft.device),
                              "sync-loss gap block (16 FIC + 16 noise "
                              "codewords)")
    plain, _ = V.viterbi_decode4(soft.cpu(), lengths)
    if not torch.equal(bits_k[:, :plain.shape[1]].cpu(), plain):
        raise AssertionError("sync loss: K1/K2 bits differ from "
                             "viterbi_decode4 on the CPU")
    print("sync-loss gap block: K1/K2 bits equal viterbi_decode4's plain "
          "decode on the CPU bit for bit")


def _cfo_check() -> None:
    """4300 Hz and the half-carrier boundary: payloads exact, CFO within
    0.05 carriers, ERR 0xFF frames equal to the CPU decode."""
    ens = S.closed_loop_ensemble()
    for cfo_hz, seed, noise_seed, snr in IMP_CFO_CASES:
        x, payload = S.modulate(ens, 12, np.random.default_rng(seed))
        x = awgn(carrier_offset(x, cfo_hz), snr,
                 np.random.default_rng(noise_seed))
        rx, eti = _card_rx(x)
        n = S.check_eti_payloads(eti, payload, rx._activation_cif)
        errs = _clean_frames_as_cpu(f"CFO {cfo_hz:g} Hz", eti, x)
        cfo = rx.stats[-1].cfo_carriers
        print(f"CFO {cfo_hz:+g} Hz, {snr:g} dB: {n} ETI frames, payloads "
              f"exact, {errs.count(0xFF)} with ERR 0xFF byte-identical to "
              f"the CPU decode; estimate {cfo:+.4f} carriers")
        if abs(cfo - cfo_hz / 1000.0) > 0.05:
            raise AssertionError(f"CFO {cfo_hz:g} Hz: estimate {cfo}")


def _multipath_check() -> None:
    """The SFN echo, TU6 static, TU6 fading with 300 Hz, RA4: payloads
    exact and the delay-spread windows."""
    ens = S.closed_loop_ensemble()
    x, payload = S.modulate(ens, 14, np.random.default_rng(0))
    want = payload[1].tobytes()

    def noisy():
        return awgn(x, 20.0, np.random.default_rng(5))

    cases = {
        "SFN echo -2 dB at 150 us": (
            sfn_echo(noisy(), 150.0, -2.0, phase=1.1), (69.1, 77.1)),
        "TU6 static": (multipath(noisy(), TU6,
                                 rng=np.random.default_rng(11)), (0.7, 1.8)),
        "TU6 10 Hz fading + 300 Hz": (carrier_offset(multipath(
            awgn(x, 24.0, np.random.default_rng(5)), TU6, doppler_hz=10.0,
            rng=np.random.default_rng(11)), 300.0), None),
        "RA4": (multipath(noisy(), RA4, rng=np.random.default_rng(2)),
                None),
    }
    for what, (y, window) in cases.items():
        rx, eti = _card_rx(y)
        got = b"".join(f.streams[1].data for f in EtiParser().feed(
            b"".join(eti)) if 1 in f.streams)
        if len(got) < 4000 or want[:len(got)] != got:
            raise AssertionError(f"{what}: sub-channel 1 not bit-exact "
                                 f"({len(got)} bytes)")
        last = rx.stats[-1]
        if last.fib_crc_bad:
            raise AssertionError(f"{what}: FIB CRC failures")
        ds = last.delay_spread_us
        print(f"{what}: {len(got)} payload bytes exact, delay spread "
              f"{ds:.3f} us" + (f" (window {window[0]}-{window[1]})"
                                if window else ""))
        if window and not window[0] < ds < window[1]:
            raise AssertionError(f"{what}: delay spread {ds} us")


def _impaired_span_check() -> None:
    """The 2 x 4 span and an 8-stream channel batch under TU6, 2.5
    carriers, 50 ppm and AWGN, with the PRS search at ``IMP_SEARCH``."""
    ens = S.closed_loop_ensemble()
    n_ch, n_time, f_own, warm = 2, 4, TB_FRAMES, TB_WARMUP
    g0 = warm + 1
    x, payload = S.modulate(ens, g0 + n_time * f_own + 1,
                            np.random.default_rng(21))
    x = S.impaired_span_signal(x, 42)
    lh, rh = halo_sizes(warm)
    s0, sl = g0 * FRAME_SIZE, n_time * f_own * FRAME_SIZE

    def tile(a):
        return torch.from_numpy(np.ascontiguousarray(
            np.broadcast_to(a, (n_ch, a.size)))).cuda()

    mesh = make_receiver_mesh(n_channels=n_ch, n_time=n_time,
                              devices=[torch.device("cuda", 0)] * 8)
    fn = timeblock_receiver(mesh, ens, frames_per_shard=f_own,
                            warmup_frames=warm, search=IMP_SEARCH)
    _reset_counts()
    out = to_host(fn(tile(x[s0:s0 + sl]), tile(x[s0 - lh:s0]),
                     tile(x[s0 + sl:s0 + sl + rh]), g0))
    _launched_per_step("impaired span", _counts(), 1)
    cfo = out["cfo_carriers"].ravel()
    truth = S.SPAN_CFO_HZ / 1000.0
    if np.abs(cfo - truth).max() >= 0.15 or np.ptp(cfo) >= 0.1:
        raise AssertionError(f"impaired span: per-shard CFO {cfo}")
    if not crc16_ok_batch(out["fib_bytes"].reshape(-1, 32)).all():
        raise AssertionError("impaired span: FIB CRC failures")
    n_rows = n_time * f_own * 4
    for c in range(n_ch):
        for j in range(n_rows):
            n = g0 * 4 + j - 15
            if n >= 0 and (out["subch"]["1"][c, j].tobytes()
                           != payload[1][n].tobytes()):
                raise AssertionError(f"impaired span: channel {c} row {j} "
                                     f"differs from the modulator's")
    print(f"impaired span (TU6, {truth} carriers, {S.SPAN_PPM:g} ppm, 22 "
          f"dB; {n_ch} x {n_time} on cuda:0, search {IMP_SEARCH}): one K1 "
          f"and one K2 launch, every FIB CRC good, all {n_ch} x {n_rows} "
          f"rows the modulator's; per-shard CFO "
          f"{cfo.min():.4f}-{cfo.max():.4f} carriers (spread "
          f"{np.ptp(cfo):.4f})")

    n_frames = 6
    xs, payloads = [], []
    for c in range(IMP_STREAMS):
        y, p = S.modulate(ens, n_frames + 2,
                          np.random.default_rng(300 + c))
        xs.append(S.impaired_span_signal(y, 500 + c)[
            :block_samples(n_frames)])
        payloads.append(p)
    nb = ens.subchannel(1).profile.tx_bits
    _reset_counts()
    out, _, _ = channel_parallel_block(
        torch.from_numpy(np.stack(xs)).cuda(),
        {"1": torch.zeros((IMP_STREAMS, 16, nb), device="cuda")},
        torch.tensor(0, dtype=torch.int32, device="cuda"), ensemble=ens,
        n_frames=n_frames, search=IMP_SEARCH,
        mesh=make_receiver_mesh(n_channels=IMP_STREAMS, n_time=1,
                                devices=[torch.device("cuda", 0)]
                                * IMP_STREAMS))
    out = to_host(out)
    _launched_per_step("impaired batch", _counts(), 1)
    cfo = out["cfo_carriers"]
    if np.abs(cfo - truth).max() >= 0.15:
        raise AssertionError(f"impaired batch: CFOs {cfo}")
    for c in range(IMP_STREAMS):
        for j in range(15, n_frames * 4):
            if (out["subch"]["1"][c, j].tobytes()
                    != payloads[c][1][j - 15].tobytes()):
                raise AssertionError(f"impaired batch: stream {c} row {j} "
                                     f"differs from the modulator's")
    print(f"impaired batch: {IMP_STREAMS} streams, each its own TU6 and "
          f"noise, one {n_frames}-frame channel_parallel_block: one K1 and "
          f"one K2 launch, rows 15-{n_frames * 4 - 1} the modulator's; CFO "
          f"{cfo.min():.4f}-{cfo.max():.4f} carriers")


def _soak_check(card: str) -> None:
    """60 s of stream in ragged chunks through one receiver on the card:
    payloads, continuity, host-state bounds, one K1/K2 launch per device
    step, and no growth of the card's allocated memory."""
    t0 = time.perf_counter()
    x, payload = S.modulate(S.closed_loop_ensemble(), SOAK_FRAMES,
                            np.random.default_rng(42))
    x = awgn(carrier_offset(x, 180.0), 14.0, np.random.default_rng(7))
    t_mod = time.perf_counter() - t0
    rx = DabReceiver(n_frames=8, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    eti, mem = [], []           # (device steps, memory_allocated) from 10
    t0 = time.perf_counter()
    with _device_kernels() as ran:
        for pos in range(0, x.size, SOAK_STEP):
            eti += rx.feed(x[pos:pos + SOAK_STEP])
            if rx.device_steps >= 10:
                mem.append((rx.device_steps, torch.cuda.memory_allocated()))
        wall = time.perf_counter() - t0
    mem_10, mem_end = mem[0], mem[-1][1]
    mem_mid = mem[len(mem) // 2]
    peak = torch.cuda.max_memory_allocated()
    _receiver_launched("soak", rx, _counts(), ran)
    n = S.check_eti_payloads(eti, payload, rx._activation_cif)
    frames = list(EtiParser().feed(b"".join(eti)))
    if n < (SOAK_FRAMES - 30) * MODE_I.n_cifs:
        raise AssertionError(f"soak: only {n} ETI frames")
    if any(f.fct != k % 250 for k, f in enumerate(frames)):
        raise AssertionError("soak: FCT not continuous")
    if (len(rx._fib_fifo) > rx.MAX_PENDING_CIFS + 64
            or len(rx.stats) > rx.MAX_STATS
            or sum(len(v) for v in rx._subch_fifo.values())
            > rx.MAX_PENDING_CIFS + 64):
        raise AssertionError("soak: host state past its bounds")
    if any(s.fib_crc_bad for s in rx.stats[2:]):
        raise AssertionError("soak: FIB CRC failures after the second "
                             "block")
    if mem_end > mem_10[1] + SOAK_MEM_SLACK:
        raise AssertionError(f"soak: memory_allocated grew from "
                             f"{mem_10[1]} after device step {mem_10[0]} "
                             f"to {mem_end}")
    air = x.size / (SAMPLE_RATE_MSPS * 1e6)
    print(f"soak: {SOAK_FRAMES} frames ({air:.1f} s of air, {t_mod:.1f} s "
          f"to modulate) in chunks of {SOAK_STEP} samples through "
          f"DabReceiver(n_frames=8, device='cuda'): {n} ETI frames, 0 "
          f"payload mismatches, FCT continuous, host state within its "
          f"bounds, K1/K2 once per each of {rx.device_steps} device steps; "
          f"{_graph_text(rx)}")
    print(f"soak: {wall:.3f} s = {air / wall:.2f}x real time (host clock, "
          f"feed included, under a device trace); memory_allocated {mem_10[1] / 2**20:.3f} MiB "
          f"after device step {mem_10[0]}, {mem_mid[1] / 2**20:.3f} after "
          f"step {mem_mid[0]}, {mem_end / 2**20:.3f} after the last "
          f"({min(m for _, m in mem) / 2**20:.3f}-"
          f"{max(m for _, m in mem) / 2**20:.3f} after each feed from step "
          f"10 on); max_memory_allocated {peak / 2**20:.1f} MiB on {card}")


def impairments_phase(card: str) -> None:
    """The receiver under the robustness set's impairments on the card."""
    _sync_loss_check()
    _cfo_check()
    _multipath_check()
    _impaired_span_check()
    _soak_check(card)


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
    phase("TII", tii_phase, rng, e2e["u8"])
    phase("resampler", resampler_phase, rng, card)
    phase("wideband + dabscan", wideband_phase, rng, card)
    phase("channel batch", channel_batch_phase, rng, card)
    phase("RS", rs_phase, rng, card)
    phase("mixed mux", mixed_phase, rng)
    tb = phase("time-block span", timeblock_phase, rng, card)
    phase("span across processes", multiprocess_phase, tb, card)
    phase("lab chain", lab_chain_phase, card)
    phase("BER waterfall", ber_phase, card)
    phase("impairments", impairments_phase, card)
    phase("dabplus17", dabplus17_phase, rng)
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

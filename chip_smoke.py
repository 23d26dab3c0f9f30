#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``dabtools_tpu_torch`` (never JAX) on ``cuda:0`` in phases, each
of which raises on failure:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: the radix-4 Viterbi kernels K1 ``acs4`` and K2 ``traceback4``
   from ``dabtools_tpu_torch/csrc/`` (build seconds);
3. kernel vs plain at the flagship's ragged shape, 64 FIC codewords
   (774 trellis steps) + 576 EEP 3-A 128 kbit/s codewords (3078 steps) in
   one lane batch: K1's decisions and metrics and K2's bits must equal the
   plain PyTorch versions exactly, and the decode must equal the encoded
   messages; median times from CUDA events;
4. end to end: the flagship mux (9 x 128 kbit/s EEP 3-A, 864/864 CUs,
   Mode I) modulated for 100 frames, with AWGN, CFO and a timing offset,
   quantized to u8 and fed to ``DabReceiver(n_frames=16, device="cuda")``.
   The acquired sub-channels must equal the mux's, every FIB CRC after
   acquisition must pass, every ETI frame's 9 payloads must equal the
   modulator's bytes, and K1/K2 must have launched once per device step.
   Then one warm ``process_block`` under PyTorch's sync debug mode
   'error' (nothing inside may wait for the device), and the steady-state
   ms/block and real-time multiple.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.models.receiver import (
    DabReceiver,
    block_samples,
    process_block,
)
from dabtools_tpu_torch.ops import viterbi as V
from dabtools_tpu_torch.ops import viterbi_cuda as K

SEED = 20261016
BLOCK_FRAMES = 16
E2E_FRAMES = 100
SNR_DB = 20.0
CFO_HZ = 300.0
TIMING_OFFSET = 3000
BLOCK_SECONDS = 1.536           # 16 Mode I frames of 96 ms
SAMPLE_RATE_MSPS = 2.048


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


def _time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs (after one
    warm-up run)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_phase(rng) -> dict:
    """K1/K2 against their plain versions at the flagship ragged shape."""
    msgs, jobs = S.flagship_codewords(rng, "cuda")
    soft, lengths = V.ragged_lanes(jobs)
    b, n4 = soft.shape
    soft8 = soft.reshape(b, n4 // 8, 8)
    t2 = torch.from_numpy((lengths // 2).astype(np.int32)).cuda()
    ws4 = V._ws4(soft.device)
    print(f"lanes: {b} x {n4 // 8} double steps "
          f"(64 x 774 FIC + 576 x 3078 MSC trellis steps)")

    dec_k, metric_k = K.acs4(soft8, t2, ws4)
    dec_p, metric_p = V.acs4_plain(soft8, t2, ws4)
    bits_k = K.traceback4(dec_k)
    bits_p = V.traceback4_plain(dec_k)
    torch.cuda.synchronize()
    n_dec_diff = int((dec_k != dec_p).sum())
    acs_err = float((metric_k - metric_p).abs().max())
    tb_err = int((bits_k.int() - bits_p.int()).abs().max())
    print(f"K1 acs4 vs plain: {n_dec_diff} decision words differ, "
          f"max |metric diff| {acs_err}")
    print(f"K2 traceback4 vs plain: max |bit diff| {tb_err}")
    if n_dec_diff or acs_err or tb_err:
        raise AssertionError("kernel and plain version disagree")

    decoded = V.viterbi_decode_ragged(jobs)          # the dispatch itself
    for (bits, _), m, name in zip(decoded, msgs, ("FIC", "MSC")):
        wrong = int((bits.cpu().numpy() != m).sum())
        print(f"{name}: {m.shape[0]} codewords, {wrong} bit errors")
        if wrong:
            raise AssertionError(f"{name} decode differs from the messages")

    acs_ms = _time_ms(lambda: K.acs4(soft8, t2, ws4), 20)
    acs_plain_ms = _time_ms(lambda: V.acs4_plain(soft8, t2, ws4), 3)
    tb_ms = _time_ms(lambda: K.traceback4(dec_k), 20)
    tb_plain_ms = _time_ms(lambda: V.traceback4_plain(dec_k), 3)
    print(f"K1 acs4: {acs_ms:.4f} ms (plain {acs_plain_ms:.2f} ms); "
          f"K2 traceback4: {tb_ms:.4f} ms (plain {tb_plain_ms:.2f} ms)")
    return {"acs4": (acs_err, acs_ms, acs_plain_ms),
            "traceback4": (float(tb_err), tb_ms, tb_plain_ms)}


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
    K.acs4_launches = 0
    K.traceback4_launches = 0
    eti = rx.feed(u8)
    launches = {"acs4": K.acs4_launches, "traceback4": K.traceback4_launches}

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
    for name, n in launches.items():
        if n != rx.device_steps:
            raise AssertionError(f"{name} launched {n} times in "
                                 f"{rx.device_steps} device steps")
    print(f"launches: {launches} in {rx.device_steps} device steps")
    return {"launches": launches, "u8": u8, "ensemble": ens}


def sync_free_check(rx, block_u8: np.ndarray) -> None:
    """One warm ``process_block`` on the card under PyTorch's sync debug
    mode 'error': any op inside that waits for the device (a
    device->host read, a pageable upload) raises.  The block's one
    upload happens before, its one download after."""
    x = rx._upload(block_u8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        process_block(x, rx._rings, rx._cif_count,
                      ensemble=rx._decode.decode_config(), mode=rx.mode,
                      n_frames=rx.n_frames)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("process_block: no host synchronization inside "
          "(sync debug mode 'error')")


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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = device_phase()
    build_phase()
    rng = np.random.default_rng(SEED)
    kern = kernel_phase(rng)
    e2e = end_to_end_phase(rng)
    steady_state_phase(e2e["u8"], e2e["ensemble"], card)
    replaces = {"acs4": "dabtools_tpu/ops/viterbi_pallas4.py:29",
                "traceback4": "dabtools_tpu/ops/viterbi_pallas4.py:177"}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "dabtools_tpu_torch/csrc/viterbi4.cu",
         "replaces": replaces[name], "launches": e2e["launches"][name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in kern.items()]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

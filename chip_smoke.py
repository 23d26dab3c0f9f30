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
   messages; median times from CUDA events;
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

Every path starts with all five launch counters at 0 and reads them
when it ends.  The line before the last is the kernels' JSON record, with
each kernel's bound: the larger of the bytes it must move over the
card's memory rate and the operations it must do over its float32 rate
(counted from this run's inputs; see :func:`_bound`).  The last line is
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
from dabtools_tpu_torch.mod.convcode import conv_encode
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
R2_LANES = 640
R2_INFO_BITS = 3073             # trellis length 3079: odd, so radix-2
R2_NOISE = 0.4                  # sigma per coded bit, Es/N0 4.95 dB
R2_ERASED = 1 / 3               # share of soft bits set to exactly 0

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
    live = int(lengths.sum()) // 2                   # live lane-double-steps
    n_dec = dec_k.numel() * 4
    tb_bytes = live * 8 + bits_k.numel()             # 2 words read per step
    return {
        "records": {
            "acs4": {"max_abs_err": acs_err, "ms": acs_ms,
                     "plain_ms": acs_plain_ms, "bound": _bound(
                         live * 8 * 4 + n_dec + 4 * b + ws4.numel() * 4
                         + 4 * b, live * ACS4_OPS)},
            "traceback4": {"max_abs_err": float(tb_err), "ms": tb_ms,
                           "plain_ms": tb_plain_ms,
                           "bound": _bound(tb_bytes, 0)}},
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

    acs_ms = _time_ms(lambda: K.acs2(soft4, ws2), 20)
    acs_plain_ms = _time_ms(lambda: V.acs2_plain(soft4, ws2), 3)
    tb_ms = _time_ms(lambda: K.traceback2(dec_k), 20)
    tb_plain_ms = _time_ms(lambda: V.traceback2_plain(dec_k), 3)
    print(f"K3 acs2: {acs_ms:.4f} ms (plain {acs_plain_ms:.2f} ms); "
          f"K4 traceback2: {tb_ms:.4f} ms (plain {tb_plain_ms:.2f} ms)")
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
    ms = _time_ms(lambda: K.traceback4_onehot64(dec), 20)
    k2 = kern["records"]["traceback4"]
    print(f"K2' traceback4_onehot64: {ms:.4f} ms (K2 {k2['ms']:.4f} ms)")
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
    r2 = radix2_phase(rng)
    oh = onehot_phase(kern)
    e2e = end_to_end_phase(rng)
    steady_state_phase(e2e["u8"], e2e["ensemble"], card)
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

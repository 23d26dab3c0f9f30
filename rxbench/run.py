"""One run of one benchmark cell on one card.

    python3 -m rxbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds or loads the program's
kernels and host library, synthesizes the cell's air from the seed,
lets the receivers acquire their ensembles and warms up (all of it
set-up), then hands the air over block by block in a closed loop for
``--seconds`` and prints one JSON line: the end-to-end metrics, or with
``--trace 1`` the per-layer ones.  Where one of them reads the device
trace, ``trace_blocks`` more hand-overs are profiled after the window.
Every ETI frame the receivers emit
is held against the plain reference (``reference.py``) once the window
has closed.  ``--fault`` plants a fault in the timed path (the control
and the tests; the benchmark never passes it).

Exits 2 without enough CUDA cards, 3 where the program is missing, 4
where a module of JAX or of the JAX package was loaded, in each case
printing no result.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from rxbench import faults, trace  # noqa: E402
from rxbench.gen.pool import CIFS, synthesize  # noqa: E402
from rxbench.record import DeviceTrace, Record  # noqa: E402
from rxbench.reference import StreamCheck  # noqa: E402
from rxbench.spec import Spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dabtools_tpu")


def _process_age_s() -> float:
    """Seconds from this process's start to ``_T0`` (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    age = up - start / os.sysconf("SC_CLK_TCK")
    return max(0.0, age - (time.perf_counter() - _T0))


_AGE0 = _process_age_s()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"
    return out[0] if out else "nvidia-smi: no card"


def run_cell(spec: Spec, cell: dict, seed: int, seconds: float,
             traced: bool, device: str = "cuda", fault: str | None = None,
             log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    from rxbench import drive

    cuda = device == "cuda"
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    fpb = int(traffic["frames_per_block"])
    stamps = [time.perf_counter()]
    drive.build(device)
    stamps.append(time.perf_counter())
    pool = synthesize(config, traffic, seed)
    stamps.append(time.perf_counter())
    path = drive.Path(config, traffic, device)
    undo = faults.install(fault) if fault else None
    checks = [StreamCheck(t) for t in pool.truth]
    want = [t.spec is not None for t in pool.truth]
    k = 0

    def hand() -> None:
        nonlocal k
        for c, frames in zip(checks, path(pool.chunk(k))):
            c.add(frames)
        k += 1

    for _ in range(traffic["acquire_blocks"]):
        hand()
        if all(c.count or not w for c, w in zip(checks, want)):
            break
    for _ in range(traffic["warmup_blocks"]):
        hand()
    if cuda:
        torch.cuda.synchronize()
    stamps.append(time.perf_counter())

    spans = trace.HostSpans(drive.SPAN_TARGETS) if traced else None
    base = [c.count for c in checks]
    gc.collect()
    gc.freeze()         # set-up's objects out of the collector's way
    hos: list[tuple[int, int]] = []
    clock = time.perf_counter_ns

    def timed(into: list) -> None:
        nonlocal k
        chunk = pool.chunk(k)
        t0 = clock()
        outs = path(chunk)
        into.append((t0, clock()))
        k += 1
        for c, frames in zip(checks, outs):
            c.add(frames)

    deadline = clock() + int(seconds * 1e9)
    while not hos or hos[-1][1] < deadline:
        timed(hos)
    # the device trace, where a metric of this run reads it: a
    # sub-window after the window, so that the profiler's cost stays out
    # of the window and its host spans
    metrics = spec.metrics(cell["name"], traced)
    profiled: list[tuple[int, int]] = []
    if cuda and any(m["source"] == "device_trace" for m in metrics):
        dev = trace.DeviceWindow()
        steps0 = path.steps()
        dev.start()
        for _ in range(traffic["trace_blocks"]):
            timed(profiled)
        dev.stop()
        steps1 = path.steps()
    setup_s = _AGE0 + hos[0][0] / 1e9 - _T0
    gc.unfreeze()
    if spans:
        spans.remove()

    # the frames due for the window's air, waited for with more air
    due = (len(hos) + len(profiled)) * CIFS * fpb
    for _ in range(traffic["flush_blocks"]):
        if all(c.count - b >= due or not w
               for c, b, w in zip(checks, base, want)):
            break
        hand()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if undo:
        undo()
    acquired = path.acquired()
    del path
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    record = Record(config=config, traffic=traffic, setup_s=setup_s,
                    air_s=pool.air_s, ensembles=sum(want),
                    window=(hos[0][0], hos[-1][1]), handovers=hos)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    result_extra = {}
    if profiled:
        record.device = DeviceTrace(
            events=dev.events,
            window=(profiled[0][0] + dev.offset,
                    profiled[-1][1] + dev.offset),
            offset=dev.offset, handovers=len(profiled),
            steps=[(r["ensemble"] if a else None, s1 - s0)
                   for r, a, s0, s1 in zip(config["receivers"],
                                           acquired, steps0, steps1)])
    if traced:
        record.layers = trace.layer_ms(hos, spans.spans)
        if profiled:
            device_info["busy_s"] = record.device.busy_ns() / 1e9
            device_info["window_s"] = record.device.window_s
            result_extra["breakdown"] = trace.breakdown(
                record.device, profiled, spans.spans)
    values = {}
    for entry in metrics:
        value = spec.reader(entry["name"]).read(record)
        if value is not None:
            values[entry["name"]] = {"value": value, "unit": entry["unit"]}

    bad, missing, lines = 0, 0, []
    for i, (c, b, w) in enumerate(zip(checks, base, want)):
        n_bad, first_bad = c.bad_frames()
        bad += n_bad
        if w:
            missing += max(0, due - (c.count - b))
        name = c.truth.block or (f"stream {i}" if len(checks) > 1
                                 else "ensemble")
        lines.append(f"{name}: {c.count} frames, {n_bad} differ from the "
                     f"reference" + (f"; {first_bad}" if first_bad else ""))
    checked = sum(c.count for c in checks)
    lat = sorted((t1 - t0) / 1e6 for t0, t1 in hos)
    print(f"{cell['name']} seed {seed}: {len(hos)} hand-overs of "
          f"{pool.air_s:.3f} s of air x {sum(want)} ensembles in "
          f"{(hos[-1][1] - hos[0][0]) / 1e9:.3f} s; set-up {setup_s:.3f} s "
          f"(to the build {_AGE0 + stamps[0] - _T0:.3f}, build "
          f"{stamps[1] - stamps[0]:.3f}, synthesis {stamps[2] - stamps[1]:.3f}"
          f", acquisition and warm-up {stamps[3] - stamps[2]:.3f}, "
          f"{k - len(hos)} hand-overs outside the window); hand-over ms "
          f"min/median/max {lat[0]:.3f}/{lat[len(lat) // 2]:.3f}/"
          f"{lat[-1]:.3f}; "
          f"CFO/delay " + ", ".join(
              f"{t.cfo_hz:+.3f} Hz/{t.delay}" for t in pool.truth if t.spec),
          file=log)
    for line in lines:
        print(line, file=log)
    return {"correct": bad == 0 and missing == 0,
            "attempted": checked + missing, "failed": bad + missing,
            "metrics": values, "device": device_info, **result_extra,
            "checks": {"bad_frames": {"value": bad, "limit": 0},
                       "missing_frames": {"value": missing, "limit": 0}}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rxbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", choices=faults.NAMES, default=None,
                   help="plant a fault in the timed path (control, tests)")
    args = p.parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    cache = spec.root / ".rxbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    try:
        import torch
    except ImportError:
        print("rxbench: PyTorch is not installed", file=sys.stderr)
        return 3
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < int(cell["chips"])):
        print(f"rxbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import rxbench.drive  # noqa: F401
    except ImportError as e:
        print(f"rxbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 3
    result = run_cell(spec, cell, args.seed, args.seconds, bool(args.trace),
                      fault=args.fault)
    bad = forbidden_modules()
    if bad:
        print(f"rxbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    print(f"card: {_card()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The program's own spans in a traced run.

    python3 -m rxbench.spans --workload <cell> --seed <n> --seconds <s>

runs one cell as ``python3 -m rxbench.run ... --trace 1`` does, with the
program's tracer (``dabtools_tpu_torch/utils/spans.py``) on exactly where
that run installs its host spans: over the window and the profiled
sub-window.  A run with ``--trace 0`` never turns it on.  The result line
is ``run.py``'s, with four more per-layer values, each a mean per
hand-over over the window's hand-overs:

* ``h2d_ms`` and ``d2h_ms``: host ms inside the copy spans of each
  direction (``rx.h2d`` and ``frontend.h2d``; ``rx.d2h`` and
  ``frontend.d2h``);
* ``copy_mb_per_block``: the MB those spans moved, both directions;
* ``frontend_host_ms``: the self time of the ``frontend`` spans (the
  front end's host work, its copies, launches and wait left out);

and a third breakdown, ``idle_by_span``: the profiled sub-window's idle
device time split at span edges and given to the innermost open span
("loop" where none is open: the per-chunk loop and the harness).  On
stderr: each span's self ms per hand-over, the loop's conversion (from
the hand-over's start to the ``frontend`` span), and the clock check:
how many pageable copies of the sub-window start inside a copy span of
their direction, within ``TOLERANCE_NS``, and the largest miss.

This module and ``drive.py`` are the benchmark's only modules that touch
the program; the arithmetic here reads span tuples alone.
"""

from __future__ import annotations

import bisect
import sys

from rxbench import run, trace

COPY_SPANS = {"h2d": ("rx.h2d", "frontend.h2d"),
              "d2h": ("rx.d2h", "frontend.d2h")}
# a pageable copy's device event, by direction
PAGEABLE = {"h2d": ("Memcpy HtoD", "Pageable"),
            "d2h": ("Memcpy DtoH", "Pageable")}
TOLERANCE_NS = 20_000
TOP = 10
UNITS = {"h2d_ms": "ms", "d2h_ms": "ms", "copy_mb_per_block": "MB",
         "frontend_host_ms": "ms"}
_RUN_CELL = run.run_cell


def per_handover(handovers: list, spans: list) -> list[dict]:
    """Per hand-over of ``handovers`` ((start, end) ns), from the spans
    (``(name, t0, t1, parent, nbytes)``) that start inside it: ``self``
    ({name: self ns}), ``count`` ({name: spans}), ``h2d`` and ``d2h``
    (ns in copy spans), ``bytes`` (bytes they moved) and ``conversion``
    (ns from the hand-over's start to its first ``frontend`` span, or
    None)."""
    starts = [h0 for h0, _ in handovers]
    out = [{"self": {}, "count": {}, "h2d": 0, "d2h": 0, "bytes": 0,
            "conversion": None} for _ in handovers]
    for name, t0, t1, parent, nbytes in spans:
        k = bisect.bisect_right(starts, t0) - 1
        if k < 0 or t0 > handovers[k][1]:
            continue
        d, dur = out[k], t1 - t0
        d["self"][name] = d["self"].get(name, 0) + dur
        d["count"][name] = d["count"].get(name, 0) + 1
        if parent is not None:
            p = spans[parent][0]
            d["self"][p] = d["self"].get(p, 0) - dur
        for way, names in COPY_SPANS.items():
            if name in names:
                d[way] += dur
                d["bytes"] += nbytes
        if name == "frontend" and d["conversion"] is None:
            d["conversion"] = t0 - handovers[k][0]
    return out


def metrics(per: list[dict]) -> dict:
    """The four per-layer values from :func:`per_handover`'s tallies;
    a value whose spans never ran is left out."""
    if not per:
        return {}
    n = len(per)
    out = {}
    copies = COPY_SPANS["h2d"] + COPY_SPANS["d2h"]
    if any(k in d["count"] for d in per for k in copies):
        out["h2d_ms"] = sum(d["h2d"] for d in per) / n / 1e6
        out["d2h_ms"] = sum(d["d2h"] for d in per) / n / 1e6
        out["copy_mb_per_block"] = sum(d["bytes"] for d in per) / n / 1e6
    if any("frontend" in d["count"] for d in per):
        out["frontend_host_ms"] = sum(
            d["self"].get("frontend", 0) for d in per) / n / 1e6
    return out


def _pieces(spans: list, offset: int) -> list[tuple[int, int, str]]:
    """The stretches between span edges, on the device's clock (``t +
    offset``), each with the innermost span open there."""
    depth = []
    for _, _, _, parent, _ in spans:
        depth.append(0 if parent is None else depth[parent] + 1)
    edges = sorted([(t0 + offset, 1, d, i) for i, ((_, t0, _, _, _), d)
                    in enumerate(zip(spans, depth))]
                   + [(t1 + offset, 0, -d, i) for i, ((_, _, t1, _, _), d)
                      in enumerate(zip(spans, depth))])
    out, stack, last = [], [], None
    for t, opens, _, i in edges:
        if last is not None and t > last:
            out.append((last, t, spans[stack[-1]][0] if stack else "loop"))
        last = t
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
    return out


def idle_by_span(device, spans: list) -> list:
    """The profiled sub-window's idle device time, in s, by the
    innermost program span open at it, as ``[["idle in <span>", s],
    ...]``, largest first, ``TOP`` of them.  ``device`` has
    ``busy()``, ``window`` (device clock, ns) and ``offset`` (device
    clock minus ``perf_counter_ns``)."""
    w0, w1 = device.window
    busy = device.busy()
    gaps = [(a, b) for a, b in zip([w0] + [e for _, e in busy],
                                   [s for s, _ in busy] + [w1]) if b > a]
    pieces = [(w0, w1, "loop")] if not spans else _pieces(
        spans, device.offset)
    # time outside every span counts as the loop's
    if pieces and pieces[0][0] > w0:
        pieces.insert(0, (w0, pieces[0][0], "loop"))
    if pieces and pieces[-1][1] < w1:
        pieces.append((pieces[-1][1], w1, "loop"))
    idle: dict[str, int] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b = max(g0, pieces[k][0]), min(g1, pieces[k][1])
            if b > a:
                idle[pieces[k][2]] = idle.get(pieces[k][2], 0) + b - a
            k += 1
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return [[f"idle in {n}", v / 1e9] for n, v in top]


def clock_check(device, spans: list, tol: int = TOLERANCE_NS) -> dict:
    """Per direction: (pageable copies that start inside the sub-window,
    those that start inside a copy span of their direction within
    ``tol`` ns, the largest miss in us)."""
    w0, w1 = device.window
    out = {}
    for way, (head, kind) in PAGEABLE.items():
        edges = sorted((t0 + device.offset, t1 + device.offset)
                       for name, t0, t1, _, _ in spans
                       if name in COPY_SPANS[way])
        starts = [a for a, _ in edges]
        copies = sorted(s0 for name, s0, _ in device.events
                        if name.startswith(head) and kind in name
                        and w0 <= s0 <= w1)
        within = worst = 0
        for s0 in copies:
            # the last span to start at or before the copy, and the next
            k = bisect.bisect_right(starts, s0)
            miss = max(0, s0 - edges[k - 1][1]) if k else float("inf")
            if k < len(edges):
                miss = min(miss, edges[k][0] - s0)
            within += miss <= tol
            worst = max(worst, miss)
        out[way] = (len(copies), within, worst / 1e3)
    return out


def report(per: list[dict], check: dict | None, log) -> None:
    """Each span's self ms and count per hand-over, the conversion, and
    the clock check, on ``log``."""
    n = len(per)
    if not n:
        return
    names = sorted({k for d in per for k in d["self"]},
                   key=lambda k: -sum(d["self"].get(k, 0) for d in per))
    print(f"program spans over {n} hand-overs: self ms a hand-over "
          f"(spans a hand-over)", file=log)
    for k in names:
        print(f"  {k}: {sum(d['self'].get(k, 0) for d in per) / n / 1e6:.4f}"
              f" ({sum(d['count'].get(k, 0) for d in per) / n:.2f})",
              file=log)
    conv = [d["conversion"] for d in per if d["conversion"] is not None]
    if conv:
        print(f"  loop conversion (hand-over start to frontend): "
              f"{sum(conv) / len(conv) / 1e6:.4f}", file=log)
    for way, (total, within, worst) in (check or {}).items():
        print(f"clock check {way}: {within} of {total} pageable copies "
              f"start inside a *.{way} span (within "
              f"{TOLERANCE_NS / 1e3:.0f} us); largest miss {worst:.3f} us",
              file=log)


def run_cell(spec, cell: dict, seed: int, seconds: float,
             device: str = "cuda", fault: str | None = None,
             log=sys.stderr) -> dict:
    """``run.run_cell`` traced, with the program's tracer on over its
    host spans' window; returns its result with this module's values."""
    got: dict = {"spans": []}
    real = (trace.HostSpans, trace.layer_ms, trace.breakdown)

    class Spans(trace.HostSpans):
        def __init__(self, targets):
            super().__init__(targets)
            try:
                from dabtools_tpu_torch.utils import spans as tracer
            except ImportError:         # a program without its own spans
                tracer = None
            self.tracer = tracer
            if tracer:
                tracer.drain()
                tracer.enable()

        def remove(self):
            if self.tracer:
                self.tracer.disable()
                got["spans"] = self.tracer.drain()
            super().remove()

    def layer_ms(handovers, host_spans):
        got["handovers"] = list(handovers)
        return real[1](handovers, host_spans)

    def breakdown(dev, handovers, host_spans):
        out = real[2](dev, handovers, host_spans)
        out["idle_by_span"] = idle_by_span(dev, got["spans"])
        got["check"] = clock_check(dev, got["spans"])
        return out

    trace.HostSpans, trace.layer_ms, trace.breakdown = (Spans, layer_ms,
                                                        breakdown)
    try:
        res = _RUN_CELL(spec, cell, seed, seconds, True, device=device,
                        fault=fault, log=log)
    finally:
        trace.HostSpans, trace.layer_ms, trace.breakdown = real
    per = per_handover(got.get("handovers", []), got["spans"])
    for name, value in metrics(per).items():
        res["metrics"][name] = {"value": value, "unit": UNITS[name]}
    report(per, got.get("check"), log)
    return res


def main(argv=None) -> int:
    """``run.main`` with ``--trace 1`` and :func:`run_cell`."""
    run.run_cell = (lambda spec, cell, seed, seconds, traced, **kw:
                    run_cell(spec, cell, seed, seconds, **kw))
    try:
        return run.main([*(sys.argv[1:] if argv is None else argv),
                         "--trace", "1"])
    finally:
        run.run_cell = _RUN_CELL


if __name__ == "__main__":
    sys.exit(main())

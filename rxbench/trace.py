"""The instruments: in a traced run, host spans from wrappers around
the program's public entries, over the whole window; in any run whose
metrics read it, a ``torch.profiler`` trace of the device over
``trace_blocks`` more hand-overs right after the window (the profiler
slows the host's launches, and CUPTI keeps some of that cost once it
has run, so the window and its host spans come before it starts).

Host spans (``time.perf_counter_ns``): ``feed`` (``DabReceiver.feed``),
``process_block`` and ``to_host`` (the module-level functions of
``models/receiver.py`` that ``DabReceiver`` calls), ``frontend``
(``Resampler.__call__``, ``Channelizer.__call__``).  Per hand-over they
split into the layers' host times (ms, summed over the receivers):

* ``frontend``: from the hand-over to the front end's return, the
  conversion of the u8 input included;
* ``ingest``: from ``feed``'s entry to ``process_block``'s (the input
  ring and the pageable upload); a ``feed`` that runs no block counts
  here whole;
* ``enqueue``: inside ``process_block`` (the device chain's launches);
* ``download``: inside ``to_host`` (the wait for the device and the one
  device-to-host copy);
* ``host_eti``: from ``to_host``'s return to ``feed``'s return (FIB
  CRCs, FIG parsing, ETI assembly); where one ``feed`` runs two blocks,
  the stretch between the first block's ``to_host`` and the second's
  ``process_block`` counts here.

The profiler records device operations only (kernels, copies, sets).
Its events carry the wall clock (``time.time_ns``); the host spans are
mapped onto it by the offset of the two clocks read together.
"""

from __future__ import annotations

import time

LAYERS = ("frontend", "ingest", "enqueue", "download", "host_eti")
TOP = 10                  # entries of each breakdown list


class HostSpans:
    """Wrappers that record a span around each call of ``targets``
    ({kind: [(owner, attribute), ...]})."""

    def __init__(self, targets: dict):
        self.spans: list[tuple[str, int, int]] = []
        self._undo = []
        for kind, attrs in targets.items():
            for owner, attr in attrs:
                self._wrap(kind, owner, attr)

    def _wrap(self, kind, owner, attr):
        real = getattr(owner, attr)
        spans = self.spans
        clock = time.perf_counter_ns

        def spanned(*args, **kwargs):
            t0 = clock()
            try:
                return real(*args, **kwargs)
            finally:
                spans.append((kind, t0, clock()))

        setattr(owner, attr, spanned)
        self._undo.append((owner, attr, real))

    def remove(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()


def layer_ms(handovers: list, spans: list) -> list[dict]:
    """Each hand-over's host ms by layer, from the spans inside it."""
    out, spans = [], sorted(spans, key=lambda s: s[1])
    i = 0
    for h0, h1 in handovers:
        while i < len(spans) and spans[i][1] < h0:
            i += 1
        inside = []
        while i < len(spans) and spans[i][1] <= h1:
            inside.append(spans[i])
            i += 1
        d = dict.fromkeys(LAYERS[1:], 0)
        fronts = [s for s in inside if s[0] == "frontend"]
        if fronts:
            d["frontend"] = max(s[2] for s in fronts) - h0
        for kind, f0, f1 in inside:
            if kind != "feed":
                continue
            state, cursor = "ingest", f0
            for k, s0, s1 in inside:
                if k not in ("process_block", "to_host") or not f0 <= s0 < f1:
                    continue
                d[state] += s0 - cursor
                d["enqueue" if k == "process_block" else "download"] += s1 - s0
                state = "enqueue" if k == "process_block" else "host_eti"
                cursor = s1
            d[state] += f1 - cursor
        out.append({k: v / 1e6 for k, v in d.items()})
    return out


class Labeller:
    """The layer the host was in at a time (``perf_counter_ns``), from
    the hand-overs and the spans inside them."""

    def __init__(self, handovers: list, spans: list):
        import bisect
        self._bisect = bisect.bisect_right
        self.starts = [h0 for h0, _ in handovers]
        self.handovers = handovers
        spans = sorted(spans, key=lambda s: s[1])
        self.inside = [[s for s in spans if h0 <= s[1] <= h1]
                       for h0, h1 in handovers]

    def __call__(self, t: int) -> str:
        i = self._bisect(self.starts, t) - 1
        if i < 0 or t > self.handovers[i][1]:
            return "harness"
        inside = self.inside[i]
        best = None
        for span in inside:
            if span[1] <= t <= span[2] and (best is None
                                            or span[1] >= best[1]):
                best = span
        if best is None:
            return "frontend"       # the u8 conversion before the front end
        if best[0] == "feed":
            ran = any(k == "process_block" and best[1] <= s0 <= t
                      for k, s0, _ in inside)
            return "host_eti" if ran else "ingest"
        return {"process_block": "enqueue",
                "to_host": "download"}.get(best[0], best[0])


class DeviceWindow:
    """``torch.profiler`` over a sub-window of hand-overs: device
    operations only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.events: list[tuple[str, int, int]] = []

    def start(self) -> None:
        self.offset = time.time_ns() - time.perf_counter_ns()
        self.prof.__enter__()

    def stop(self) -> None:
        import warnings

        import torch
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # "clears events each cycle"
            self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events():
            dt = e.device_type()
            if getattr(dt, "name", str(dt)).endswith("CUDA"):
                self.events.append((e.name(), e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
        self.events.sort(key=lambda e: e[1])


def breakdown(device, handovers: list, spans: list) -> dict:
    """The device operations that took most time, and the idle time of
    the sub-window by what the host was doing, in seconds.  ``device``
    has ``events``, ``window`` (wall-clock ns) and ``offset`` (wall clock
    minus ``perf_counter_ns``)."""
    ops: dict[str, int] = {}
    for name, s0, s1 in device.events:
        ops[name] = ops.get(name, 0) + s1 - s0
    idle: dict[str, int] = {}
    label = Labeller(handovers, spans)
    busy = device.busy()
    edges = [device.window[0]] + [t for b in busy for t in b] \
        + [device.window[1]]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            at = label((g0 + g1) // 2 - device.offset)
            idle[at] = idle.get(at, 0) + g1 - g0
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n[:120], v / 1e9] for n, v in top],
            "idle_gaps": [[f"idle in {n}", v / 1e9] for n, v in gaps]}

"""What a run recorded, for the metric readers (``metrics/<name>.py``).
Times are ``time.perf_counter_ns`` unless a field says otherwise."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DeviceTrace:
    """The traced sub-window: device operations as (name, start, end) on
    the wall clock (ns), the sub-window on that clock, the offset of the
    wall clock from ``perf_counter_ns``, the hand-overs in it, and per
    receiver (its ensemble's configuration entry, or None while it has
    none) the device steps it ran there."""

    events: list
    window: tuple
    offset: int
    handovers: int
    steps: list

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        """The union of the operations' intervals inside the window."""
        out = []
        w0, w1 = self.window
        for _, s0, s1 in sorted(self.events, key=lambda e: e[1]):
            s0, s1 = max(s0, w0), min(s1, w1)
            if s1 <= s0:
                continue
            if out and s0 <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], s1))
            else:
                out.append((s0, s1))
        return out

    def busy_ns(self) -> int:
        return sum(b - a for a, b in self.busy())


@dataclasses.dataclass
class Record:
    config: dict
    traffic: dict
    setup_s: float
    air_s: float               # seconds of air per hand-over, per ensemble
    ensembles: int             # ensembles the cell decodes
    window: tuple              # the measured window
    handovers: list            # (start, end) of each hand-over in it
    layers: list | None = None          # traced: host ms per hand-over
    device: DeviceTrace | None = None   # traced: the profiled sub-window

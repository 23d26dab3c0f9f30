"""kernel_ms_per_air_s (ms/s, device trace): milliseconds in which the
card runs a kernel, per second of air decoded, summed over the cell's
ensembles: the compute that each ensemble-second costs the card, which
sets how many ensembles one card carries for receivers that share it.
It is taken over the profiled sub-window after the window.  Copies and
sets (``Memcpy ...``, ``Memset ...``) are left out: a pageable copy
lasts as long as the host takes to stage it, so it is the host's time."""

import dataclasses

COPIES = ("Memcpy", "Memset")


def read(r):
    d = r.device
    if d is None or not d.handovers or not r.ensembles:
        return None
    kernels = [e for e in d.events if not e[0].startswith(COPIES)]
    if not kernels:
        return None
    busy_ms = dataclasses.replace(d, events=kernels).busy_ns() / 1e6
    return busy_ms / (d.handovers * r.air_s * r.ensembles)

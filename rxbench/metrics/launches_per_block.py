"""launches_per_block (ops/block, device trace): device operations
(kernels, copies and sets) per hand-over in the profiled sub-window,
over all of the cell's receivers and its front end."""


def read(r):
    d = r.device
    if d is None or not d.events or not d.handovers:
        return None
    return len(d.events) / d.handovers

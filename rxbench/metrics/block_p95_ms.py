"""block_p95_ms (ms, host clock): the 95th percentile, over every
hand-over of the window, of the wall time from handing a block of air
to the path to the return of the ETI frames it completes (linear
interpolation between order statistics, as numpy's default)."""

import statistics


def read(r):
    ms = [(t1 - t0) / 1e6 for t0, t1 in r.handovers]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]

"""device_idle_pct (%, device trace): the share of the profiled
sub-window in which the card runs no kernel, copy or set."""


def read(r):
    d = r.device
    if d is None or not d.events:
        return None
    return 100.0 * (1.0 - d.busy_ns() / (d.window[1] - d.window[0]))

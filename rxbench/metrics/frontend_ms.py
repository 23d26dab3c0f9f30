"""frontend_ms (ms, program span): front end (ops/resample.py Resampler,
ops/fir.py Channelizer): host ms per hand-over from the hand-over to the
front end's return, the u8 to complex conversion included; the mean over
the traced window's hand-overs outside the profiled sub-window (see
trace.py)."""


def read(r):
    vals = [d["frontend"] for d in r.layers or () if "frontend" in d]
    return sum(vals) / len(vals) if vals else None

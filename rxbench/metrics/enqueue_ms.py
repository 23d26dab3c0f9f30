"""enqueue_ms (ms, program span): device chain launch (models/receiver.py
process_block): host ms per hand-over inside process_block, summed over
the receivers; the mean over the traced window's hand-overs outside the
profiled sub-window (see trace.py)."""


def read(r):
    vals = [d["enqueue"] for d in r.layers or () if "enqueue" in d]
    return sum(vals) / len(vals) if vals else None

"""ingest_ms (ms, program span): receiver host ring and upload
(models/receiver.py DabReceiver.feed up to process_block): host ms per
hand-over from feed's entry to process_block's, summed over the
receivers; the mean over the traced window's hand-overs outside the
profiled sub-window (see trace.py)."""


def read(r):
    vals = [d["ingest"] for d in r.layers or () if "ingest" in d]
    return sum(vals) / len(vals) if vals else None

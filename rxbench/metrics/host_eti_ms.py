"""host_eti_ms (ms, program span): host FIC/ETI (fic/fig.py,
eti/assemble.py, native/dabhost.cc through DabReceiver): host ms per
hand-over from to_host's return to feed's return, summed over the
receivers; the mean over the traced window's hand-overs outside the
profiled sub-window (see trace.py)."""


def read(r):
    vals = [d["host_eti"] for d in r.layers or () if "host_eti" in d]
    return sum(vals) / len(vals) if vals else None

"""Faults planted in the timed path, for the control and the tests that
show a broken run reads as not correct.  The benchmark's own runs plant
none.

* ``flip``: an answer altered where it is produced: one payload bit of
  one sub-channel flipped in every decoded block on the device.  This is
  also the control: it breaks the deployment's one stated guarantee,
  byte-exact ETI, by the least amount.
* ``stale``: a step that returns its state unchanged: each block hands
  back the time deinterleaver's rings it was given.
* ``half``: half of the batch left out: the decoded rows of half of the
  sub-channels (rounded up) zeroed.
"""

from __future__ import annotations

NAMES = ("flip", "stale", "half")


def install(name: str):
    """Wrap the program's ``process_block`` with fault ``name``; returns
    the function that takes it out again."""
    from dabtools_tpu_torch.models import receiver
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}")
    real = receiver.process_block

    def broken(x, rings, cif_count, **kw):
        out, new_rings, cif_next = real(x, rings, cif_count, **kw)
        keys = sorted(out["subch"], key=int)
        if name == "stale":
            return out, rings, cif_next
        if keys and name == "flip":
            out["subch"][keys[0]][..., 0, 0] ^= 1
        if keys and name == "half":
            for k in keys[: (len(keys) + 1) // 2]:
                out["subch"][k].zero_()
        return out, new_rings, cif_next

    receiver.process_block = broken
    return lambda: setattr(receiver, "process_block", real)

"""The system under test: the port's ``dab2eti`` path for one cell, built
from its configuration and traffic, driven one hand-over at a time.

The only module of the benchmark that imports the program.
"""

from __future__ import annotations

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.mod.impairments import u8_to_complex
from dabtools_tpu_torch.models import receiver
from dabtools_tpu_torch.models.receiver import DabReceiver
from dabtools_tpu_torch.ops import cudalib
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.resample import Resampler
from dabtools_tpu_torch.tables.bandiii import blocks_within
from dabtools_tpu_torch.utils import native

from rxbench.gen.pool import stream_count

# what the traced run wraps, by the name of its span
SPAN_TARGETS = {"feed": [(DabReceiver, "feed")],
                "process_block": [(receiver, "process_block")],
                "to_host": [(receiver, "to_host")],
                "frontend": [(Resampler, "__call__"),
                             (Channelizer, "__call__")]}


def build(device: str) -> None:
    """Build or load the native host library and, on a card, the port's
    CUDA library, the Viterbi and resampler kernels (both cached inside
    the checkout)."""
    native.lib()
    if device == "cuda":
        cudalib.build()


class Receivers:
    """The port's multi-stream entry, ``parallel/channel.py::
    ChannelReceiver(n_streams, n_frames, mode, *, device)``, as first
    realized, for a port that does not have it: N ``DabReceiver``s fed in
    turn, as ``dab2eti --wideband`` feeds its blocks.  ``feed(chunks)``
    takes one chunk per stream (a sequence, or the rows of an (N, n)
    array or tensor) and returns each stream's ETI frames in stream
    order; an empty or None chunk leaves its stream as it is.
    ``device_steps`` and ``ensembles`` are per-stream lists."""

    def __init__(self, n_streams: int, n_frames: int = 8, mode=C.MODE_I,
                 *, device):
        self.receivers = [DabReceiver(n_frames=n_frames, mode=mode,
                                      device=device)
                          for _ in range(n_streams)]

    def feed(self, chunks) -> list[list[bytes]]:
        if len(chunks) != len(self.receivers):
            raise ValueError(f"{len(chunks)} chunks for "
                             f"{len(self.receivers)} streams")
        return [rx.feed(c) if c is not None and len(c) else []
                for rx, c in zip(self.receivers, chunks)]

    @property
    def device_steps(self) -> list[int]:
        return [rx.device_steps for rx in self.receivers]

    @property
    def ensembles(self) -> list:
        return [rx.ensemble for rx in self.receivers]


def channel_receiver():
    """The port's ``parallel.channel.ChannelReceiver`` where it has one,
    else :class:`Receivers` (imported here, so that a single-stream cell
    does not load the channel module)."""
    from dabtools_tpu_torch.parallel import channel
    return getattr(channel, "ChannelReceiver", Receivers)


class Path:
    """The receivers and the front end of a cell, as ``dab2eti`` builds
    them; calling it with one hand-over of raw u8 input (one row per
    stream where there are several) returns each receiver's ETI frames.
    A wideband capture's blocks and independent streams go through one
    ``ChannelReceiver``; a single stream through one ``DabReceiver``."""

    def __init__(self, config: dict, traffic: dict, device: str):
        n = int(traffic["frames_per_block"])
        rate = int(traffic.get("rate_hz") or config["rate_hz"])
        blocks = [r.get("block") for r in config["receivers"]]
        self.front = self.rx = self.bank = None
        center = config.get("center_hz")
        if center is not None or stream_count(config, traffic) > 1:
            self.bank = channel_receiver()(len(blocks), n_frames=n,
                                           device=device)
        else:
            self.rx = DabReceiver(n_frames=n, device=device)
        if center is not None:
            cands = blocks_within(center, rate)
            if [b for b, _ in cands] != blocks:
                raise ValueError(f"blocks {blocks} are not the capture's "
                                 f"{[b for b, _ in cands]}")
            self.front = Channelizer(
                rate, offsets_hz=[int(f - center) for _, f in cands],
                device=device)
        elif rate != C.SAMPLE_RATE:
            self.front = Resampler(rate, device=device)

    def __call__(self, chunk) -> list[list[bytes]]:
        # cli/dab2eti.py's per-chunk loop (and _wideband's)
        if self.bank is not None:
            if self.front is not None:
                chunk = self.front(u8_to_complex(chunk))  # (blocks, n)
            return self.bank.feed(chunk)
        if self.front is None:
            return [self.rx.feed(chunk)]
        x = self.front(u8_to_complex(chunk))
        return [self.rx.feed(x) if x.numel() else []]

    @property
    def receivers(self) -> list:
        """The ``DabReceiver``s behind the path where its entry has them,
        for tests that drive them one by one; the harness reads none."""
        if self.bank is None:
            return [self.rx]
        return getattr(self.bank, "receivers", [])

    def steps(self) -> list[int]:
        """Device steps each receiver has run (replays included)."""
        if self.bank is not None:
            return list(self.bank.device_steps)
        return [self.rx.device_steps]

    def acquired(self) -> list[bool]:
        ensembles = (self.bank.ensembles if self.bank is not None
                     else [self.rx.ensemble])
        return [e is not None for e in ensembles]

"""The system under test: the port's ``dab2eti`` path for one cell, built
from its configuration and traffic, driven one hand-over at a time.

The only module of the benchmark that imports the program.
"""

from __future__ import annotations

import numpy as np

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.mod.impairments import u8_to_complex
from dabtools_tpu_torch.models import receiver
from dabtools_tpu_torch.models.receiver import DabReceiver
from dabtools_tpu_torch.ops import viterbi_cuda
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.resample import Resampler
from dabtools_tpu_torch.tables.bandiii import blocks_within
from dabtools_tpu_torch.utils import native

# what the traced run wraps, by the name of its span
SPAN_TARGETS = {"feed": [(DabReceiver, "feed")],
                "process_block": [(receiver, "process_block")],
                "to_host": [(receiver, "to_host")],
                "frontend": [(Resampler, "__call__"),
                             (Channelizer, "__call__")]}


def build(device: str) -> None:
    """Build or load the native host library and, on a card, the Viterbi
    kernels (both cached inside the checkout)."""
    native.lib()
    if device == "cuda":
        viterbi_cuda.build()


class Path:
    """The receivers and the front end of a cell, as ``dab2eti`` builds
    them; calling it with one hand-over of raw u8 input returns each
    receiver's ETI frames."""

    def __init__(self, config: dict, traffic: dict, device: str):
        n = int(traffic["frames_per_block"])
        rate = int(traffic.get("rate_hz") or config["rate_hz"])
        blocks = [r.get("block") for r in config["receivers"]]
        self.receivers = [DabReceiver(n_frames=n, device=device)
                          for _ in blocks]
        self.front = None
        center = config.get("center_hz")
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

    def __call__(self, chunk: np.ndarray) -> list[list[bytes]]:
        # cli/dab2eti.py's per-chunk loop (and _wideband's)
        if self.front is None:
            return [self.receivers[0].feed(chunk)]
        x = self.front(u8_to_complex(chunk))
        if isinstance(self.front, Resampler):
            return [self.receivers[0].feed(x) if x.size else []]
        return [rx.feed(x[i]) for i, rx in enumerate(self.receivers)]

    def steps(self) -> list[int]:
        """Device steps each receiver has run (replays included)."""
        return [rx.device_steps for rx in self.receivers]

    def acquired(self) -> list[bool]:
        return [rx.ensemble is not None for rx in self.receivers]

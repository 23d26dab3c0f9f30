"""VHF Band III DAB channel grid (ETSI EN 300 401 / ITU assignment).

Block labels 5A..13F with centre frequencies in Hz.  [K-med: reconstructed
from knowledge of the public table — 1.712 MHz spacing within a channel
number, 1.872 MHz guard crossing most channel numbers, irregular channel
13; verify against an official table when reachable.]
"""

from __future__ import annotations

BAND_III: dict[str, int] = {}


def _build() -> None:
    freq = 174_928_000
    for ch in range(5, 13):
        for letter in "ABCD":
            BAND_III[f"{ch}{letter}"] = freq
            freq += 1_712_000
        freq += 1_872_000 - 1_712_000  # inter-channel guard
    # channel 13 is irregular (six blocks, tighter packing at 13D)
    freq = 230_784_000
    for letter, f in (("A", 230_784_000), ("B", 232_496_000),
                      ("C", 234_208_000), ("D", 235_776_000),
                      ("E", 237_488_000), ("F", 239_200_000)):
        BAND_III[f"13{letter}"] = f


_build()


def blocks_within(center_hz: float, bandwidth_hz: float,
                  margin_hz: float = 1_000_000) -> list[tuple[str, int]]:
    """Band III blocks whose full 1.536 MHz occupancy fits the capture."""
    lo = center_hz - bandwidth_hz / 2 + margin_hz
    hi = center_hz + bandwidth_hz / 2 - margin_hz
    return [(label, f) for label, f in sorted(BAND_III.items(),
                                              key=lambda kv: kv[1])
            if lo <= f <= hi]

"""The EEP deployments, pinned: for ``flagship``, ``wideband3`` and
``dabplus17`` at the tiny cell's traffic (a 6-frame pool) and two seeds,
the pool's samples and truth, the reference's STC bytes and the Viterbi
lanes of ``viterbi_roofline_pct`` stay as they were before the harness
learned UEP sub-channels.

The truth, the STC bytes and the lanes are pinned exactly.  The samples
are pinned by their length and two weighted sums, within 16 samples
moved by one step: numpy builds differ in the last bit of their
transcendental functions and FFTs, and that moves a handful of samples
across a u8 boundary (0-4 of 2.4-9.4 million between numpy 2.0.2 and
2.3.5 on these pools).  Any other change to a pool moves the sums by
millions: rotating one by a single sample moves them by 7.5 million or
more."""

import hashlib
import json

import numpy as np
import pytest

from rxbench.gen import pool as P
from rxbench.reference import Expected
from rxbench.spec import Spec

from tiny import TRAFFIC

FLIPS = 16                  # samples moved by one step, at most
WEIGHT = 1023               # the weights' largest magnitude

FLAGSHIP_STC = ("000c8830043c8830086c88300c9c883010cc883014fc8830192c8830"
                "1d5c8830218c8830")
DABPLUS17_STC = ("000c8830043c8824086088240c84881e10a2881e14c0881e18de8818"
                 "1cf68818210e881825268818293e88122d5088123162841b357d8415"
                 "3992980c3d9e980c41aa8406")

# (period, samples' size, weighted sums, truth sha256) by configuration
# and seed
POOLS = {
    ("flagship", 5): (
        2359296, 7077888, (11802040, -336923713),
        "b6aba27ffbc168d119d21fa386afb95a97786b3765e7d8ed50dbdcf4115f71ee"),
    ("flagship", 2**31 + 7): (
        2359296, 7077888, (66168147, -323865436),
        "2336b4194a60e34fcae9acdf6bf9df0e8c1284c06fd58da24de28f4d96e1afcc"),
    ("wideband3", 5): (
        9437184, 28311552, (-571509099, -195668946),
        "b61b012c6af97c717ba4c17c394bc84f2069323e8ceecc0ba2df3660c410a20a"),
    ("wideband3", 2**31 + 7): (
        9437184, 28311552, (-607709013, -264518747),
        "6bbd4059157e6d580c4f0763c24a2f356917f452bea0aea51316bea92295971f"),
    ("dabplus17", 5): (
        2359296, 7077888, (83738291, -334419109),
        "b72d33bf93af008796a22f9a0b95854962ba5a8357b2911b6323ac85c5c97d61"),
    ("dabplus17", 2**31 + 7): (
        2359296, 7077888, (136633436, -366957095),
        "e97ec097e4bb333f8bb4753576ddbc26683540f15f17e10398023d95462a4054"),
}
STC = {"flagship": [FLAGSHIP_STC], "wideband3": [FLAGSHIP_STC] * 3,
       "dabplus17": [DABPLUS17_STC]}
# sha256 of the JSON of [lanes(ensemble, 8) for each receiver]
LANES = {
    "flagship":
        "23d87c52b34bd58cb17025b0f6cf965799f3377934184918dc80b5c6b6ed8d61",
    "wideband3":
        "a553498a8575e1bcfe8ffc5db63d2790e2680a58c8994f7b3d62d28d2ccca6cc",
    "dabplus17":
        "3b656369b491491702d856e33417c9f78bdf4732bb6108d28c7f1056f1447dcf",
}


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _sums(samples: np.ndarray) -> tuple[int, ...]:
    """Two sums of the samples under fixed random weights in
    [-WEIGHT, WEIGHT]."""
    rng = np.random.default_rng(0x5EED)
    return tuple(int(rng.integers(-WEIGHT, WEIGHT + 1, size=samples.size,
                                  dtype=np.int64) @ samples.astype(np.int64))
                 for _ in range(2))


def _truth_sha(truth) -> str:
    h = hashlib.sha256()
    for t in truth:
        for fib in t.fic:
            h.update(fib)
        for sc in sorted(t.payload):
            h.update(bytes([sc]))
            h.update(t.payload[sc].tobytes())
        h.update(repr((t.cfo_hz, t.delay)).encode())
    return h.hexdigest()


@pytest.mark.parametrize("name,seed", sorted(POOLS))
def test_pool_truth_and_stc_unchanged(name, seed):
    period, size, sums, truth = POOLS[name, seed]
    pool = P.synthesize(Spec().config(name), TRAFFIC, seed)
    assert (pool.period, pool.samples.size) == (period, size)
    got = _sums(pool.samples[:period])
    assert all(abs(g - w) <= FLIPS * WEIGHT for g, w in zip(got, sums)), \
        (got, sums)
    assert _truth_sha(pool.truth) == truth
    assert [Expected(t).stc.hex() for t in pool.truth
            if t.spec is not None] == STC[name]


@pytest.mark.parametrize("name", sorted(LANES))
def test_viterbi_lanes_unchanged(name):
    v = Spec().reader("viterbi_roofline_pct")
    lanes = [v.lanes(r["ensemble"], 8)
             for r in Spec().config(name)["receivers"]]
    assert _sha(json.dumps(lanes).encode()) == LANES[name]

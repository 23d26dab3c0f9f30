"""The benchmark's ``dabplus17`` configuration through the port on the
CPU: an all-DAB+ Mode I multiplex of 17 EEP sub-channels in 9 puncturing
profiles, options A and B, over all 864 CUs.

* the configuration file's layout against EN 300 401 Tables 7-8, from a
  hand table here, and its ensemble against the port's test multiplex
  (``testsignal.dabplus17_ensemble``);
* the port's ``DabReceiver`` driven as ``rxbench/drive.Path`` drives it,
  held against the benchmark's plain reference (``rxbench/reference``),
  clean and under the control fault;
* the same u8 through the JAX receiver and the port: the same ETI;
* the ragged Viterbi lanes of one 8-frame block, for this multiplex,
  the flagship and the mixed MP2 + DAB+ ``mixed11`` (UEP lanes count as
  EEP ones: kbit/s x 24 data bits and the tail), against lanes and
  trellis steps counted from the bit rates alone, and the batch-by-batch
  decode of an odd-length mix;
* the demod chain's per-sub-channel and per-job spans.

Blocks are 4 frames (8 where the lanes are pinned) and the pool is
the benchmark's own generator at a small ``pool_frames``.
"""

import functools

import numpy as np
import pytest
import torch

from dabtools_tpu.models import receiver as jrx
from dabtools_tpu_torch import testsignal as S
from dabtools_tpu_torch.eti.assemble import tpl_for_subchannel
from dabtools_tpu_torch.fic.config import Ensemble
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.ops import fec
from dabtools_tpu_torch.ops import viterbi as V
from dabtools_tpu_torch.utils import spans
from rxbench import drive, faults
from rxbench.gen.pool import ensemble_from_spec, synthesize
from rxbench.reference import Expected, StreamCheck
from rxbench.spec import Spec

torch.set_num_threads(2)

SEED = 2**31 + 1817
HANDOVERS = 4               # 4-frame blocks: acquisition, then 33 frames

# EN 300 401 Table 7 (option A, n = kbit/s / 8) and Table 8 (option B,
# n = kbit/s / 32): CUs of each of the multiplex's (kbit/s, protection)
HAND_CUS = {(128, "EEP-3A"): 96, (96, "EEP-3A"): 72, (80, "EEP-3A"): 60,
            (64, "EEP-3A"): 48, (48, "EEP-3A"): 36, (72, "EEP-2A"): 72,
            (56, "EEP-2A"): 56, (32, "EEP-3B"): 18, (16, "EEP-2A"): 16}
# ETS 300 799 TPL of an EEP sub-channel: 0b1, option (3 bits), level - 1
HAND_TPL = {"EEP-3A": 0b100010, "EEP-2A": 0b100001, "EEP-3B": 0b100110}

FIC_LANES_PER_FRAME = 4     # 12 FIBs a Mode I frame, 3 a codeword
FIC_DATA_BITS = 768
TAIL = 6                    # the K = 7 code's zero tail
# (lanes, live steps, padded steps) of one 8-frame block
PER_BLOCK = {"flagship": (320, 911_232, 984_960),
             "dabplus17": (576, 888_192, 1_772_928),
             "mixed11": (384, 917_760, 1_771_776)}


def _config(name: str) -> dict:
    return Spec().config(name)


def _spec(name: str) -> dict:
    return _config(name)["receivers"][0]["ensemble"]


def _ensemble(name: str) -> Ensemble:
    """The configuration's ensemble in the port's classes."""
    return Ensemble.from_dict(ensemble_from_spec(_spec(name)).to_dict())


def _traffic(frames_per_block: int) -> dict:
    return dict(Spec().traffic("dab2eti"), pool_frames=6,
                frames_per_block=frames_per_block)


@functools.cache
def _pool(name: str, frames_per_block: int):
    return synthesize(_config(name), _traffic(frames_per_block), SEED)


def _u8(name: str, frames_per_block: int) -> np.ndarray:
    """The first HANDOVERS hand-overs of the pool, as one u8 stream."""
    pool = _pool(name, frames_per_block)
    return np.concatenate([pool.chunk(k) for k in range(HANDOVERS)])


def test_layout_follows_tables_7_and_8():
    subs = sorted(_spec("dabplus17")["subchannels"],
                  key=lambda s: s["start_cu"])
    assert [s["id"] for s in subs] == list(range(17))
    end = 0
    for s in subs:
        assert s["start_cu"] == end             # contiguous, no overlap
        end += HAND_CUS[s["kbps"], s["protection"]]
    assert end == 864
    ens = _ensemble("dabplus17")
    for s, want in zip(ens.sorted_subchannels(), subs):
        assert s.size_cus == HAND_CUS[want["kbps"], want["protection"]]
        assert tpl_for_subchannel(s) == HAND_TPL[want["protection"]]
    assert len({s.profile for s in ens.subchannels}) == 9
    assert {s.eep_option for s in ens.subchannels} == {"A", "B"}
    # the reference's STC carries the same TPLs, option bit included
    stc = Expected(_pool("dabplus17", 4).truth[0]).stc
    assert [stc[4 * k + 2] >> 2 for k in range(17)] == [
        HAND_TPL[s["protection"]] for s in subs]
    # the configuration holds the port's test multiplex
    assert S.dabplus17_ensemble() == ens
    assert (ens.eid, ens.label) == (0x1ABC, "DABPLUS17")


@pytest.mark.parametrize("fault", [None, "flip"])
def test_receiver_against_the_reference(fault):
    """``DabReceiver`` on the CPU, fed as ``drive.Path`` feeds it: every
    ETI frame byte-exact, every sub-channel; the control fault (one
    payload bit flipped per block) reads as bad frames."""
    pool = _pool("dabplus17", 4)
    path = drive.Path(_config("dabplus17"), _traffic(4), "cpu")
    check = StreamCheck(pool.truth[0])
    undo = faults.install(fault) if fault else None
    try:
        for k in range(HANDOVERS):
            check.add(path(pool.chunk(k))[0])
    finally:
        if undo:
            undo()
    assert path.acquired() == [True]
    assert check.count >= 2 * 16
    bad, first = check.bad_frames()
    if fault is None:
        assert (bad, first) == (0, "")
    else:
        # one payload bit of one CIF a block: some frames, not all
        assert 0 < bad < check.count and first


def test_eti_stream_identical_to_jax():
    x = _u8("dabplus17", 4)
    ref = tuple(jrx.DabReceiver(n_frames=4).feed(x))
    rx = trx.DabReceiver(n_frames=4, device="cpu")
    eti = tuple(rx.feed(x))
    assert len(ref) >= 2 * 16
    assert eti == ref
    assert rx.ensemble.subchannels == _ensemble("dabplus17").subchannels


def _rings(ens: Ensemble) -> dict:
    return {str(s.subchid): fec.init_deinterleave_ring(s.profile.tx_bits,
                                                       "cpu")
            for s in ens.subchannels}


def _block(name: str, n_frames: int):
    """One ``process_block`` of ``n_frames`` frames of the configuration's
    air, with its ensemble, on the CPU."""
    ens = _ensemble(name).decode_config()
    x = _pool(name, n_frames).samples[: 2 * trx.block_samples(n_frames)]
    return trx.process_block(torch.from_numpy(x.copy()), _rings(ens),
                             torch.tensor(0, dtype=torch.int32),
                             ensemble=ens, n_frames=n_frames)


@pytest.mark.parametrize("name", sorted(PER_BLOCK))
def test_ragged_counters_per_block(name, monkeypatch):
    """The lanes of one 8-frame block's Viterbi jobs (``pre_viterbi``'s,
    as ``ragged_lanes`` lays them out): FIC and MSC lanes, their live
    trellis steps (data bits + tail) and the steps padded to the longest
    lane, against kbit/s x 24 + 6 and nothing of the code under test."""
    n = 8
    steps = [FIC_DATA_BITS + TAIL] * (FIC_LANES_PER_FRAME * n)
    for s in _spec(name)["subchannels"]:
        steps += [s["kbps"] * 24 + TAIL] * (4 * n)     # 4 CIFs a frame
    want = (len(steps), sum(steps), len(steps) * max(steps))
    assert want == PER_BLOCK[name]
    dispatches = []

    def recording(jobs):
        dispatches.append(jobs)
        return V.viterbi_decode_ragged(jobs)

    monkeypatch.setattr(trx, "viterbi_decode_ragged", recording)
    _block(name, n)
    (jobs,) = dispatches
    _, lengths = V.ragged_lanes(jobs)
    got = (len(lengths), lengths.sum(), len(lengths) * lengths.max())
    assert got == want


def test_ragged_counters_in_the_batch_by_batch_fallback():
    """A mix that holds an odd T decodes batch by batch: each batch's bits
    and metrics exactly those of ``viterbi_decode`` of it alone."""
    rng = np.random.default_rng(13)
    jobs = [torch.from_numpy(rng.normal(size=(3, 4 * t)).astype(np.float32))
            for t in (13, 8)]
    got = V.viterbi_decode_ragged(jobs)
    assert len(got) == len(jobs)
    for (bits, metric), job in zip(got, jobs):
        want_bits, want_metric = V.viterbi_decode(job)
        torch.testing.assert_close(bits, want_bits, rtol=0, atol=0)
        torch.testing.assert_close(metric, want_metric, rtol=0, atol=0)


def demod_span_names(name: str) -> list[str]:
    """The spans of one op-by-op 4-frame block of the configuration
    ``name`` with spans on, after one with spans off that records
    nothing; every ``demod.*`` span inside its ``enqueue.demod``."""
    spans.drain()
    _block(name, 4)
    assert spans.drain() == []
    spans.enable()
    try:
        _block(name, 4)
    finally:
        spans.disable()
    got = spans.drain()
    for span, t0, t1, parent, nbytes in got:
        if span.startswith("demod."):
            assert got[parent][0] == "enqueue.demod"
            assert got[parent][1] <= t0 <= t1 <= got[parent][2]
            assert nbytes == 0
    return [s[0] for s in got]


def test_demod_spans_per_subchannel_and_job():
    """With spans on, one block gives a ``demod.deinterleave`` span per
    sub-channel and a ``demod.depuncture`` span per Viterbi job (the FIC
    and the 9 profile groups), all under ``enqueue.demod``; with spans
    off it records nothing."""
    names = demod_span_names("dabplus17")
    assert names.count("demod.deinterleave") == 17
    assert names.count("demod.depuncture") == 10

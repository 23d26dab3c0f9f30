"""The benchmark's ``mixed11`` configuration through the port on the CPU: a
mixed MP2 + DAB+ Mode I multiplex, six MP2 sub-channels at UEP-3 (FIG
0/1 short form, EN 300 401 Table 31) beside five DAB+ sub-channels at
EEP-3A (Table 7), over all 864 CUs.

* the configuration file's layout against a hand table of Table 31 rows
  and Table 7 sizes;
* the STC TPL of a UEP sub-channel, ``0x10 | (level - 1)`` for every
  level and for Table 31 indices past 31, and of each entry here;
* the port's ``DabReceiver`` driven as ``rxbench/drive.Path`` drives it,
  held against the benchmark's plain reference (``rxbench/reference``),
  clean and under the control fault;
* the same u8 through the JAX receiver: the same ETI but for the six UEP
  entries' TPL, which the JAX package writes as the Table 31 index
  clamped to 31, and the header CRC over them;
* the demod chain's per-sub-channel and per-job spans.

One 8-frame block's ragged Viterbi lanes are pinned beside the other
configurations' in ``tests/test_torch_dabplus17.py``.  Blocks are 4
frames and the pool is the benchmark's own generator at a small
``pool_frames``, as there.
"""

import logging

import pytest
import torch

from dabtools_tpu.models import receiver as jrx
from dabtools_tpu_torch.eti.assemble import tpl_for_subchannel
from dabtools_tpu_torch.fic.config import Subchannel
from dabtools_tpu_torch.models import receiver as trx
from dabtools_tpu_torch.tables.puncturing import UEP_PROFILES, UEP_TABLE_31
from rxbench import drive, faults
from rxbench.reference import Expected, StreamCheck
from tests.test_torch_dabplus17 import (HANDOVERS, _config, _ensemble,
                                        _pool, _spec, _traffic, _u8,
                                        demod_span_names)
from tests.test_torch_host_copies import as_port_tpl

torch.set_num_threads(2)

NAME = "mixed11"
# (kbit/s, protection) -> (EN 300 401 Table 31 index or None for EEP,
# CUs): Table 31 rows for UEP, Table 7 (option A, n = kbit/s / 8) for EEP
HAND = {(128, "UEP-3"): (35, 96), (192, "UEP-3"): (45, 140),
        (80, "UEP-3"): (21, 58), (96, "EEP-3A"): (None, 72),
        (64, "EEP-3A"): (None, 48), (56, "EEP-3A"): (None, 42)}
# ETS 300 799 TPL as docs/INTEROP.md row 8 reads it: UEP 0b010 + level - 1,
# EEP 0b1 + option (3 bits) + level - 1
HAND_TPL = {"UEP-3": 0x12, "EEP-3A": 0x22}
UEP_SUBCHIDS = range(6)
# frame bytes: the UEP entries' TPL (STC entry k at 8 + 4k, TPL in its
# third byte) and the header CRC after 11 entries and MNSC
TPL_BYTES = [8 + 4 * k + 2 for k in UEP_SUBCHIDS]
HEADER_CRC = [8 + 4 * 11 + 2, 8 + 4 * 11 + 3]


def test_layout_follows_tables_31_and_7():
    subs = sorted(_spec(NAME)["subchannels"], key=lambda s: s["start_cu"])
    assert [s["id"] for s in subs] == list(range(11))
    end = 0
    for s in subs:
        assert s["start_cu"] == end             # contiguous, no overlap
        end += HAND[s["kbps"], s["protection"]][1]
    assert end == 864
    ens = _ensemble(NAME)
    for s, want in zip(ens.sorted_subchannels(), subs):
        index, cus = HAND[want["kbps"], want["protection"]]
        assert s.size_cus == cus
        assert s.protection_type == want["protection"][:3]
        if index is not None:
            assert s.uep_table_index == index
            assert UEP_TABLE_31[index] == (cus, 3, want["kbps"])
        assert tpl_for_subchannel(s) == HAND_TPL[want["protection"]]
    assert [s.protection_type for s in ens.sorted_subchannels()] == \
        ["UEP"] * 6 + ["EEP"] * 5
    assert len({s.profile for s in ens.subchannels}) == 6
    assert UEP_PROFILES[128, 3].padding_bits == 4
    # one service a sub-channel, each with an SId of its own
    services = _spec(NAME)["services"]
    assert sorted(v["subchid"] for v in services) == list(range(11))
    assert len({v["sid"] for v in services}) == 11
    # the reference's STC carries the same TPLs
    stc = Expected(_pool(NAME, 4).truth[0]).stc
    assert [stc[4 * k + 2] >> 2 for k in range(11)] == [
        HAND_TPL[s["protection"]] for s in subs]
    config = _config(NAME)
    assert config["reduced"] == [] and len(config["assumed"]) == 3


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_uep_tpl_is_the_level(level, caplog):
    """Every Table 31 row of ``level`` gets TPL ``0x10 | (level - 1)``,
    rows past index 31 included, with nothing logged."""
    rows = [i for i, (_, lv, _) in enumerate(UEP_TABLE_31) if lv == level]
    assert max(rows) >= 32
    with caplog.at_level(logging.DEBUG):
        got = {tpl_for_subchannel(Subchannel.uep(1, 0, table_index=i))
               for i in rows}
    assert got == {0x10 | (level - 1)}
    assert caplog.records == []


@pytest.mark.parametrize("fault", [None, "flip"])
def test_receiver_against_the_reference(fault):
    """``DabReceiver`` on the CPU, fed as ``drive.Path`` feeds it: every
    ETI frame byte-exact, the UEP entries' TPL included; the control
    fault (one payload bit flipped per block) reads as bad frames."""
    pool = _pool(NAME, 4)
    path = drive.Path(_config(NAME), _traffic(4), "cpu")
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
        assert 0 < bad < check.count and first


def test_eti_stream_against_jax():
    """The JAX receiver's ETI from the same u8, with the six UEP entries'
    TPL set to the port's rule and the header CRC computed again, is the
    port's byte for byte; those eight bytes are all that differ."""
    x = _u8(NAME, 4)
    ref = tuple(jrx.DabReceiver(n_frames=4).feed(x))
    rx = trx.DabReceiver(n_frames=4, device="cpu")
    eti = tuple(rx.feed(x))
    assert len(ref) >= 2 * 16
    assert rx.ensemble.subchannels == _ensemble(NAME).subchannels
    assert {tuple(f[b] >> 2 for b in TPL_BYTES) for f in eti} == {
        (0x12,) * 6}
    # the JAX package's Table 31 index clamped to 31: 35, 45 -> 31; 21
    assert {tuple(f[b] >> 2 for b in TPL_BYTES) for f in ref} == {
        (31,) * 5 + (21,)}
    diff = {i for got, want in zip(eti, ref)
            for i in range(len(want)) if got[i] != want[i]}
    assert diff <= set(TPL_BYTES + HEADER_CRC)
    assert set(TPL_BYTES) <= diff
    assert eti == tuple(as_port_tpl(f, dict.fromkeys(UEP_SUBCHIDS, 3))
                        for f in ref)


def test_demod_spans_per_subchannel_and_job():
    """One block: a ``demod.deinterleave`` span per sub-channel (11) and a
    ``demod.depuncture`` span per Viterbi job: the FIC, the 3 UEP profile
    groups (128, 192 and 80 kbit/s) and the 3 EEP-3A ones."""
    names = demod_span_names(NAME)
    assert names.count("demod.deinterleave") == 11
    assert names.count("demod.depuncture") == 7

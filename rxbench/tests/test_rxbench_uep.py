"""UEP sub-channels in the harness: a configuration's "UEP-<level>" entry
read by the generator, the reference's STC entry for it, and a tiny
mixed UEP + EEP deployment synthesized and decoded by the port's
receiver on the CPU across the pool's seams."""

import numpy as np
import pytest

from rxbench.gen import pool as P
from rxbench.gen.puncturing import UEP_PROFILES, UEP_TABLE_31
from rxbench.reference import Expected, StreamCheck

from tiny import TRAFFIC

BUNDLED = [i for i, (_, level, kbps) in enumerate(UEP_TABLE_31)
           if (kbps, level) in UEP_PROFILES]

MIXED = {
    "name": "mixed", "mode": "I", "rate_hz": 2048000, "format": "u8",
    "center_hz": None,
    "receivers": [{"block": None, "ensemble": {
        "eid": 0x4FFE, "label": "MIXED",
        "subchannels": [
            {"id": 1, "start_cu": 0, "protection": "UEP-3", "kbps": 128},
            {"id": 2, "start_cu": 96, "protection": "EEP-3A", "kbps": 64}],
        "services": [{"sid": 0x1235, "label": "MP2 ONE", "subchid": 1},
                     {"sid": 0x1236, "label": "DAB+ TWO", "subchid": 2}]}}],
}


def _entry(protection, kbps, subchid=7, start_cu=0):
    return {"id": subchid, "start_cu": start_cu, "protection": protection,
            "kbps": kbps}


def _ensemble(*subs):
    return {"eid": 1, "label": "E", "subchannels": list(subs),
            "services": []}


def test_every_bundled_row_is_one_entry():
    assert len(BUNDLED) == 63
    for i in BUNDLED:
        size, level, kbps = UEP_TABLE_31[i]
        (s,) = P.ensemble_from_spec(
            _ensemble(_entry(f"UEP-{level}", kbps))).subchannels
        assert (s.protection_type, s.uep_table_index) == ("UEP", i)
        assert (s.protection_level, s.bitrate_kbps, s.size_cus) == \
            (level, kbps, size)
        assert s.profile is UEP_PROFILES[kbps, level]


@pytest.mark.parametrize("protection,kbps,why", [
    ("UEP-3", 320, "no EN 300 401 Table 31 row"),
    ("UEP-1", 112, "no EN 300 401 Table 31 row"),
    ("UEP-6", 128, "no EN 300 401 Table 31 row"),
    ("UEP-3A", 128, "no EN 300 401 Table 31 row"),
    ("UEP-3", 100, "no EN 300 401 Table 31 row"),
    ("UEP-2", 192, "not bundled"),
    ("XEP-3", 128, "neither EEP nor UEP"),
])
def test_an_entry_without_a_profile_is_refused(protection, kbps, why):
    entry = _entry(protection, kbps)
    with pytest.raises(ValueError, match=why) as e:
        P.ensemble_from_spec(_ensemble(entry))
    assert str(entry) in str(e.value)


def test_a_hand_built_uep_stc_entry():
    """SCID(6) SAD(10) TPL(6) STL(10): a 128 kbit/s UEP-3 sub-channel 5
    first in the MST (SAD 12, after the FIC), TPL 0x10 | 2, STL 48
    words; then a 64 kbit/s EEP-3A one (SAD 60, TPL 0x22, STL 24) and a
    32 kbit/s UEP-5 one (SAD 84, TPL 0x14, STL 12)."""
    spec = _ensemble(_entry("UEP-3", 128, subchid=5),
                     _entry("UEP-5", 32, subchid=9, start_cu=144),
                     _entry("EEP-3A", 64, subchid=1, start_cu=96))
    truth = P.Truth(None, spec, fic=[bytes(96)], payload={
        5: np.zeros((1, 384), np.uint8), 1: np.zeros((1, 192), np.uint8),
        9: np.zeros((1, 96), np.uint8)})
    ref = Expected(truth)
    assert ref.stc == bytes([0x14, 0x0C, 0x48, 0x30,
                             0x04, 0x3C, 0x88, 0x18,
                             0x24, 0x54, 0x50, 0x0C])
    assert ref.nst == 3 and len(ref.mst[0]) == 96 + 384 + 192 + 96


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_uep_tpl_is_the_level(level):
    truth = P.Truth(None, _ensemble(_entry(f"UEP-{level}", 64)),
                    fic=[bytes(96)], payload={7: np.zeros((1, 192),
                                                          np.uint8)})
    assert Expected(truth).stc[2] >> 2 == 0x10 | (level - 1)


@pytest.fixture(scope="module")
def mixed_stream():
    """The tiny mixed deployment's pool and the ETI frames the port's
    receiver emits over seven 8-frame hand-overs of a 6-frame pool."""
    from dabtools_tpu_torch.models.receiver import DabReceiver
    pool = P.synthesize(MIXED, TRAFFIC, 2**31 + 23)
    rx = DabReceiver(n_frames=8, device="cpu")
    frames = []
    for k in range(7):
        frames += rx.feed(pool.chunk(k))
    return pool, frames


def test_mixed_pool_decodes_but_for_the_uep_tpl(mixed_stream):
    """Every frame over more than two seams carries the reference's MST
    and EOF; its header differs at most in the UEP entry's TPL bits and
    in the header CRC that covers them."""
    pool, frames = mixed_stream
    ref = Expected(pool.truth[0])
    assert len(frames) > 2 * TRAFFIC["pool_frames"] * P.CIFS
    j0, c0 = ref.locate(frames[0])
    tpl_byte, crc = 4 + 4 + 2, 4 + 4 + 4 * ref.nst + 2
    for k, got in enumerate(frames):
        want = ref.frame((j0 + k) % ref.n, c0 + k)
        assert len(got) == len(want)
        diff = [i for i in range(len(want)) if got[i] != want[i]]
        assert set(diff) <= {tpl_byte, crc, crc + 1}, (k, diff)
        assert got[tpl_byte] & 0x03 == want[tpl_byte] & 0x03


def test_mixed_stream_is_byte_exact(mixed_stream):
    pool, frames = mixed_stream
    check = StreamCheck(pool.truth[0])
    check.add(frames)
    assert check.bad_frames() == (0, "")

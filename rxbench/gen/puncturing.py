"""Convolutional-code puncturing tables (ETSI EN 300 401 s11).

Reference counterpart: `upstream:dab_tables.c` / inline tables in
`upstream:input_sdr.c` (R11/R14 in SURVEY.md).  Rebuilt from the standard:

* The rate-1/4 mother code emits 4 bits per input bit.  Puncturing operates
  on blocks of 32 mother bits (8 input bits x 4).  Vector PI_i keeps
  ``8 + i`` of every 32 bits: the first output (g1) of every input bit is
  always kept, and the g2/g3/g4 outputs are enabled for input-bit groups in
  bit-reversed order ``0,4,2,6,1,5,3,7`` as *i* grows (EN 300 401
  Table "puncturing vectors").
* The 24 tail mother bits (6 zero tail bits x 4) are punctured with
  VT = ``1100`` x 6, keeping 12 bits.
* FIC: 2016 bits at PI=16 (21 blocks of 128), 276 at PI=15 (3 blocks),
  12 tail -> 2304-bit codeword from a 3096-bit mother word (s11.2).
* EEP profiles A/B (s11.3.2) are generated from the standard's block-count
  formulas and self-checked against their nominal code rates in tests.
* UEP profiles (s11.3.1, Table of 64 audio profiles): the *mechanism*
  (4 regions L1..L4 with PI1..PI4 + tail) is implemented; the 64-row data
  table requires the standard text and is NOT bundled (see
  ``UEP_PROFILES``) — a documented round-1 gap (tests use EEP).

Everything returns NumPy arrays; the receiver turns masks into static
gather/scatter index maps at trace time.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from . import constants as C

# Order in which g2/g3/g4 taps are enabled as the puncturing index grows.
_GROUP_ORDER = (0, 4, 2, 6, 1, 5, 3, 7)

# Tail puncturing vector VT: keep g1,g2 of each of the 6 tail bits.
TAIL_VECTOR = np.tile(np.array([1, 1, 0, 0], dtype=np.uint8), C.TAIL_BITS)


def pi_vector(pi: int) -> np.ndarray:
    """32-element 0/1 keep-mask for puncturing index ``pi`` (1..24)."""
    if not 1 <= pi <= 24:
        raise ValueError(f"puncturing index out of range: {pi}")
    v = np.zeros(32, dtype=np.uint8)
    v[0::4] = 1  # g1 output always kept
    for tap in range(3):  # g2, g3, g4
        n_groups = min(max(pi - 8 * tap, 0), 8)
        for g in _GROUP_ORDER[:n_groups]:
            v[4 * g + 1 + tap] = 1
    assert int(v.sum()) == 8 + pi
    return v


@dataclasses.dataclass(frozen=True)
class PuncturingProfile:
    """A sequence of (n_blocks, PI) regions + tail, as used by FIC/UEP/EEP.

    One *block* covers 32 data bits = 128 mother bits.
    """

    name: str
    regions: tuple[tuple[int, int], ...]  # ((n_blocks, pi), ...)
    padding_bits: int = 0                 # UEP only

    @property
    def n_blocks(self) -> int:
        return sum(n for n, _ in self.regions)

    @property
    def data_bits(self) -> int:
        return 32 * self.n_blocks

    @property
    def mother_bits(self) -> int:
        return 4 * (self.data_bits + C.TAIL_BITS)

    @property
    def tx_bits(self) -> int:
        kept = sum(n * 4 * (8 + pi) for n, pi in self.regions)
        return kept + int(TAIL_VECTOR.sum()) + self.padding_bits

    def mask(self) -> np.ndarray:
        """0/1 keep-mask over the mother codeword (length ``mother_bits``)."""
        parts = [np.tile(pi_vector(pi), 4 * n) for n, pi in self.regions]
        parts.append(TAIL_VECTOR)
        m = np.concatenate(parts)
        assert m.size == self.mother_bits, (m.size, self.mother_bits)
        return m


@functools.cache
def puncture_mask_for_profile(profile: PuncturingProfile) -> np.ndarray:
    return profile.mask()


# ------------------------------------------------------------------- FIC
FIC_PROFILE = PuncturingProfile("FIC", regions=((21, 16), (3, 15)))
assert FIC_PROFILE.data_bits == C.FIC_INFO_BITS
assert FIC_PROFILE.tx_bits == C.FIC_PUNCTURED_BITS
assert FIC_PROFILE.mother_bits == C.FIC_MOTHER_BITS


def fic_puncture_mask() -> np.ndarray:
    return puncture_mask_for_profile(FIC_PROFILE)


# ------------------------------------------------------------------- EEP
# (option, level) -> (PI_a, PI_b, block-count formulas); bitrate units:
# set A: 8n kbit/s, set B: 32n kbit/s.  EN 300 401 s11.3.2.
_EEP_A = {  # level -> (pi1, pi2, l1(n), l2(n))
    1: (24, 23, lambda n: 6 * n - 3, lambda n: 3),
    2: (14, 13, lambda n: 2 * n - 3, lambda n: 4 * n + 3),
    3: (8, 7, lambda n: 6 * n - 3, lambda n: 3),
    4: (3, 2, lambda n: 4 * n - 3, lambda n: 2 * n + 3),
}
_EEP_B = {
    1: (10, 9, lambda n: 24 * n - 3, lambda n: 3),
    2: (6, 5, lambda n: 24 * n - 3, lambda n: 3),
    3: (4, 3, lambda n: 24 * n - 3, lambda n: 3),
    4: (2, 1, lambda n: 24 * n - 3, lambda n: 3),
}
# CUs occupied per unit n, by (set, level):
EEP_CUS_PER_N = {("A", 1): 12, ("A", 2): 8, ("A", 3): 6, ("A", 4): 4,
                 ("B", 1): 27, ("B", 2): 21, ("B", 3): 18, ("B", 4): 15}
EEP_KBPS_PER_N = {"A": 8, "B": 32}


def eep_profile(level: int, option: str, bitrate_kbps: int) -> PuncturingProfile:
    """EEP profile ``<level>-<option>`` for the given sub-channel bitrate."""
    option = option.upper()
    table = {"A": _EEP_A, "B": _EEP_B}[option]
    if level not in table:
        raise ValueError(f"EEP level must be 1..4, got {level}")
    unit = EEP_KBPS_PER_N[option]
    if bitrate_kbps % unit:
        raise ValueError(
            f"EEP-{option} bitrate must be a multiple of {unit} kbit/s")
    n = bitrate_kbps // unit
    pi1, pi2, l1f, l2f = table[level]
    l1, l2 = l1f(n), l2f(n)
    if option == "A" and level == 2 and n == 1:
        # Standard-mandated exception for 8 kbit/s EEP 2-A (L1 = 2n-3
        # would be negative).
        l1, l2 = 5, 1
        pi1, pi2 = 13, 12
    if min(l1, l2) < 0:
        raise ValueError(f"EEP {level}-{option} undefined at {bitrate_kbps} kbit/s")
    prof = PuncturingProfile(f"EEP-{level}{option}-{bitrate_kbps}k",
                             regions=((l1, pi1), (l2, pi2)))
    assert prof.data_bits == bitrate_kbps * 24  # bits per 24 ms logical frame
    return prof


def eep_subchannel_cus(level: int, option: str, bitrate_kbps: int) -> int:
    n = bitrate_kbps // EEP_KBPS_PER_N[option.upper()]
    return EEP_CUS_PER_N[(option.upper(), level)] * n


# ------------------------------------------------------------------- UEP
# FIG 0/1 short-form sub-channel size table (EN 300 401 Table 31):
# index -> (size_cus, protection_level 1..5, bitrate_kbps).
# NOTE [K-med, SURVEY.md availability notice]: reconstructed from knowledge
# of the public standard; re-verify against a reference capture when one is
# available.
UEP_TABLE_31: tuple[tuple[int, int, int], ...] = (
    (16, 5, 32), (21, 4, 32), (24, 3, 32), (29, 2, 32), (35, 1, 32),
    (24, 5, 48), (29, 4, 48), (35, 3, 48), (42, 2, 48), (52, 1, 48),
    (29, 5, 56), (35, 4, 56), (42, 3, 56), (52, 2, 56),
    (32, 5, 64), (42, 4, 64), (48, 3, 64), (58, 2, 64), (70, 1, 64),
    (40, 5, 80), (52, 4, 80), (58, 3, 80), (70, 2, 80), (84, 1, 80),
    (48, 5, 96), (58, 4, 96), (70, 3, 96), (84, 2, 96), (104, 1, 96),
    (58, 5, 112), (70, 4, 112), (84, 3, 112), (104, 2, 112),
    (64, 5, 128), (84, 4, 128), (96, 3, 128), (116, 2, 128), (140, 1, 128),
    (80, 5, 160), (104, 4, 160), (116, 3, 160), (140, 2, 160), (168, 1, 160),
    (96, 5, 192), (116, 4, 192), (140, 3, 192), (168, 2, 192), (208, 1, 192),
    (116, 5, 224), (140, 4, 224), (168, 3, 224), (208, 2, 224), (232, 1, 224),
    (128, 5, 256), (168, 4, 256), (192, 3, 256), (232, 2, 256), (280, 1, 256),
    (160, 5, 320), (208, 4, 320), (280, 2, 320),
    (192, 5, 384), (280, 3, 384), (416, 1, 384),
)

# UEP protection profiles (EN 300 401 Table 33): (bitrate_kbps, level) ->
# (L1, L2, L3, L4, PI1, PI2, PI3, PI4, padding_bits).
#
# PROVENANCE [docs/INTEROP.md row 21]: reconstructed from knowledge of the
# public standard (the text itself is unavailable offline) and validated
# against two independent hard constraints per row:
#   (a) L1+L2+L3+L4 blocks x 32 bits == bitrate_kbps * 24 (one logical frame);
#   (b) sum(L_i * 4 * (8+PI_i)) + 12 tail bits + padding == Table 31 CUs * 64.
# 43 rows satisfy both with padding == 0 and 20 with the standard's small
# padding values (4 or 8 bits); a randomly mis-remembered row would satisfy
# (b) with probability of order 1/100, so bundled rows are [K-high] on (a)/(b)
# consistency, [K-med] on PI placement within the constraint.  The 64th row
# (192 kbit/s, protection level 2) FAILED validation and is deliberately NOT
# bundled — the receiver skips such sub-channels gracefully; supply it via
# ``register_uep_profile()`` from the standard text.
_UEP_TABLE_33: dict[tuple[int, int], tuple[int, ...]] = {
    (32, 5): (3, 4, 17, 0, 5, 3, 2, 0, 0),
    (32, 4): (3, 3, 18, 0, 11, 6, 5, 0, 0),
    (32, 3): (3, 4, 14, 3, 15, 9, 6, 8, 0),
    (32, 2): (3, 4, 14, 3, 22, 13, 8, 13, 0),
    (32, 1): (3, 5, 13, 3, 24, 17, 12, 17, 4),
    (48, 5): (4, 3, 26, 3, 5, 4, 2, 3, 0),
    (48, 4): (3, 4, 26, 3, 9, 6, 4, 6, 0),
    (48, 3): (3, 4, 26, 3, 15, 10, 6, 9, 4),
    (48, 2): (3, 4, 26, 3, 24, 14, 8, 15, 0),
    (48, 1): (3, 5, 25, 3, 24, 18, 13, 18, 0),
    (56, 5): (6, 10, 23, 3, 5, 4, 2, 3, 0),
    (56, 4): (6, 10, 23, 3, 9, 6, 4, 5, 0),
    (56, 3): (6, 12, 21, 3, 16, 7, 6, 9, 0),
    (56, 2): (6, 10, 23, 3, 23, 13, 8, 13, 8),
    (64, 5): (6, 9, 31, 2, 5, 3, 2, 3, 0),
    (64, 4): (6, 9, 33, 0, 11, 6, 5, 0, 0),
    (64, 3): (6, 12, 27, 3, 16, 8, 6, 9, 0),
    (64, 2): (6, 10, 29, 3, 23, 13, 8, 13, 8),
    (64, 1): (6, 11, 28, 3, 24, 18, 12, 18, 4),
    (80, 5): (6, 10, 41, 3, 6, 3, 2, 3, 0),
    (80, 4): (6, 10, 41, 3, 11, 6, 5, 6, 0),
    (80, 3): (6, 11, 40, 3, 16, 8, 6, 7, 0),
    (80, 2): (6, 10, 41, 3, 23, 13, 8, 13, 8),
    (80, 1): (6, 10, 41, 3, 24, 17, 12, 18, 4),
    (96, 5): (7, 9, 53, 3, 5, 4, 2, 4, 0),
    (96, 4): (7, 10, 52, 3, 9, 6, 4, 6, 0),
    (96, 3): (6, 12, 51, 3, 16, 9, 6, 10, 4),
    (96, 2): (6, 10, 53, 3, 22, 12, 9, 12, 0),
    (96, 1): (6, 13, 50, 3, 24, 18, 13, 19, 0),
    (112, 5): (14, 17, 50, 3, 5, 4, 2, 5, 0),
    (112, 4): (11, 21, 49, 3, 9, 6, 4, 8, 0),
    (112, 3): (11, 23, 47, 3, 16, 8, 6, 9, 0),
    (112, 2): (11, 21, 49, 3, 23, 12, 9, 14, 4),
    (128, 5): (12, 19, 62, 3, 5, 3, 2, 4, 0),
    (128, 4): (11, 21, 61, 3, 11, 6, 5, 7, 0),
    (128, 3): (11, 22, 60, 3, 16, 9, 6, 10, 4),
    (128, 2): (11, 21, 61, 3, 22, 12, 9, 14, 0),
    (128, 1): (11, 20, 62, 3, 24, 17, 13, 19, 8),
    (160, 5): (11, 19, 87, 3, 5, 4, 2, 4, 0),
    (160, 4): (11, 23, 83, 3, 11, 6, 5, 9, 0),
    (160, 3): (11, 24, 82, 3, 16, 8, 6, 11, 0),
    (160, 2): (11, 21, 85, 3, 22, 11, 9, 13, 0),
    (160, 1): (11, 22, 84, 3, 24, 18, 12, 19, 0),
    (192, 5): (11, 20, 110, 3, 6, 4, 2, 5, 0),
    (192, 4): (11, 22, 108, 3, 10, 6, 4, 9, 0),
    (192, 3): (11, 24, 106, 3, 16, 10, 6, 11, 0),
    # (192, 2): NOT BUNDLED — recalled row failed constraint (b) by -24
    # bits; rather than guess, the receiver degrades gracefully.
    (192, 1): (11, 21, 109, 3, 24, 20, 13, 24, 0),
    (224, 5): (12, 22, 131, 3, 8, 6, 2, 6, 4),
    (224, 4): (12, 26, 127, 3, 12, 8, 4, 11, 0),
    (224, 3): (11, 20, 134, 3, 16, 10, 7, 9, 0),
    (224, 2): (11, 22, 132, 3, 24, 16, 10, 15, 0),
    (224, 1): (11, 24, 130, 3, 24, 20, 12, 20, 4),
    (256, 5): (11, 24, 154, 3, 6, 5, 2, 5, 0),
    (256, 4): (11, 24, 154, 3, 12, 9, 5, 10, 4),
    (256, 3): (11, 27, 151, 3, 16, 10, 7, 10, 0),
    (256, 2): (11, 22, 156, 3, 24, 14, 10, 13, 8),
    (256, 1): (11, 26, 152, 3, 24, 19, 14, 18, 4),
    (320, 5): (11, 26, 200, 3, 8, 5, 2, 6, 4),
    (320, 4): (11, 25, 201, 3, 13, 9, 5, 10, 8),
    (320, 2): (11, 26, 200, 3, 24, 17, 9, 17, 0),
    (384, 5): (11, 27, 247, 3, 8, 6, 2, 7, 0),
    (384, 3): (11, 24, 250, 3, 16, 9, 7, 10, 4),
    (384, 1): (12, 28, 245, 3, 24, 20, 14, 23, 8),
}

UEP_PROFILES: dict[tuple[int, int], PuncturingProfile] = {}


def register_uep_profile(bitrate_kbps: int, level: int,
                         regions: tuple[tuple[int, int], ...],
                         padding_bits: int = 0) -> PuncturingProfile:
    """Register a UEP protection profile (EN 300 401 Table 33 row).

    The 64-row data table is not bundled (offline build); users with the
    standard text supply rows here — the 4-region mechanism, padding,
    modulator, and receiver all support them (tested with synthetic rows).
    The profile must fit the Table 31 sub-channel size for the
    (bitrate, level) pair.
    """
    prof = PuncturingProfile(f"UEP-{bitrate_kbps}k-P{level}",
                             regions=tuple(regions),
                             padding_bits=padding_bits)
    if prof.data_bits != bitrate_kbps * 24:
        raise ValueError(
            f"regions carry {prof.data_bits} bits per logical frame; "
            f"{bitrate_kbps} kbit/s requires {bitrate_kbps * 24}")
    expect = next((size for size, lv, kb in UEP_TABLE_31
                   if lv == level and kb == bitrate_kbps), None)
    if expect is not None and prof.tx_bits != expect * 64:
        raise ValueError(
            f"profile transmits {prof.tx_bits} bits but Table 31 gives "
            f"{expect} CUs = {expect * 64} bits for "
            f"{bitrate_kbps} kbit/s P{level}")
    UEP_PROFILES[(bitrate_kbps, level)] = prof
    return prof


for (_kb, _lv), (_l1, _l2, _l3, _l4, _p1, _p2, _p3, _p4,
                 _pad) in _UEP_TABLE_33.items():
    register_uep_profile(
        _kb, _lv,
        tuple((n, pi) for n, pi in
              ((_l1, _p1), (_l2, _p2), (_l3, _p3), (_l4, _p4)) if n),
        padding_bits=_pad)


@functools.cache
def enumerate_uep_candidates(bitrate_kbps: int, level: int
                             ) -> tuple[PuncturingProfile, ...]:
    """All Table-33-shaped rows for a NON-bundled (bitrate, level) pair
    that satisfy the two hard constraints (see ``_UEP_TABLE_33`` header)
    within the structural template every bundled level-1..3 row obeys:

    * four regions with L4 = 3 tail blocks;
    * PI1 > PI2 > PI3 < PI4 <= min(24, PI1);
    * padding in {0, 4, 8};
    * L1/L2 bracketed by the bitrate family's bundled rows, PI1..3 by
      the protection level's bundled rows across bitrates, each with an
      envelope margin CALIBRATED BY LEAVE-ONE-OUT: de-bundling any of
      the 59 template-conforming Table 33 rows, the enumeration with
      these margins always contains it (tests/test_uep_autoprobe.py
      pins this).  (The 4 non-conforming rows are low-protection P4/P5
      rows with L4 != 3 — a different template than the missing
      (192 kbit/s, P2), whose 16 family/level neighbors ALL conform.)

    Which member the standard's row is can be *identified from a real
    signal*: the correct PI layout is the only one whose depuncture
    keeps the Viterbi decode aligned (``ops.uep_probe``).  For
    (192 kbit/s, P2) this yields ~2.4k candidates — one batched
    chunked Viterbi call on TPU.
    """
    if (bitrate_kbps, level) in UEP_PROFILES:
        raise ValueError(f"({bitrate_kbps}, P{level}) is bundled; "
                         "candidates are for missing rows only")
    size = next((sz for sz, lv, kb in UEP_TABLE_31
                 if lv == level and kb == bitrate_kbps), None)
    if size is None:
        raise ValueError(f"no Table 31 entry for {bitrate_kbps} kbit/s "
                         f"P{level}")
    fam = [row for (kb, _lv), row in _UEP_TABLE_33.items()
           if kb == bitrate_kbps]
    if not fam:
        raise ValueError(f"no bundled rows in the {bitrate_kbps} kbit/s "
                         "family to bound the search")
    n_blocks = bitrate_kbps * 24 // 32
    lv_rows = [row for (_kb, lv), row in _UEP_TABLE_33.items()
               if lv == level]
    l1s = [r[0] for r in fam]
    l2s = [r[1] for r in fam]
    p1s = [r[4] for r in lv_rows]
    p2s = [r[5] for r in lv_rows]
    p3s = [r[6] for r in lv_rows]
    out = []
    for pad in (0, 4, 8):
        if (size * 64 - 12 - pad) % 4:
            continue
        target = (size * 64 - 12 - pad) // 4 - 8 * n_blocks
        # Envelope margins: the smallest per-bound widening under which
        # leave-one-out never misses (observed worst cases: L1 +3 at
        # (112,5), L2 -4 at (384,3), PI1 -4 at (224,1)).
        for l1 in range(max(1, min(l1s) - 1), max(l1s) + 4):
            for l2 in range(max(1, min(l2s) - 4), max(l2s) + 5):
                l3 = n_blocks - l1 - l2 - 3
                if l3 <= 0:
                    continue
                for p1 in range(max(1, min(p1s) - 4),
                                min(24, max(p1s) + 2) + 1):
                    for p2 in range(max(1, min(p2s) - 2),
                                    min(max(p2s) + 2, p1 - 1) + 1):
                        for p3 in range(max(1, min(p3s) - 2),
                                        min(max(p3s) + 2, p2 - 1) + 1):
                            rem = target - l1 * p1 - l2 * p2 - l3 * p3
                            if rem % 3:
                                continue
                            p4 = rem // 3
                            if not (p3 < p4 <= min(24, p1)):
                                continue
                            out.append(PuncturingProfile(
                                f"UEP-{bitrate_kbps}k-P{level}-cand"
                                f"{len(out)}",
                                regions=((l1, p1), (l2, p2), (l3, p3),
                                         (3, p4)),
                                padding_bits=pad))
    return tuple(out)


def uep_profile(bitrate_kbps: int, level: int) -> PuncturingProfile:
    try:
        return UEP_PROFILES[(bitrate_kbps, level)]
    except KeyError:
        raise NotImplementedError(
            f"UEP profile data for {bitrate_kbps} kbit/s P{level} is not "
            "bundled (row failed offline reconstruction validation — see "
            "_UEP_TABLE_33); register the standard's row via "
            "register_uep_profile().  All other 63 Table 33 rows are "
            "bundled; see tables/puncturing.py."
        ) from None


def profile_for_subchannel(sub) -> PuncturingProfile:
    """Profile for a parsed sub-channel description (fic.config.Subchannel)."""
    if sub.protection_type == "EEP":
        return eep_profile(sub.protection_level, sub.eep_option, sub.bitrate_kbps)
    return uep_profile(sub.bitrate_kbps, sub.protection_level)

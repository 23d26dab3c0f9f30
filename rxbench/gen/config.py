"""Ensemble configuration model (the MCI) — frozen, hashable dataclasses.

Reference counterpart: the ensemble/sub-channel structs filled by
`upstream:dab.c` `fib_parse` (R10).  Frozen + tuples so an ``Ensemble`` can
be a *static* jit argument: the MSC decode specializes (shapes, puncturing
maps, CU slices) per configuration at trace time.
"""

from __future__ import annotations

import dataclasses

from . import constants as C
from .puncturing import (
    PuncturingProfile,
    UEP_TABLE_31,
    eep_profile,
    eep_subchannel_cus,
    uep_profile,
)


@dataclasses.dataclass(frozen=True)
class Subchannel:
    subchid: int                 # 0..63
    start_cu: int                # 0..863
    protection_type: str         # "EEP" | "UEP"
    protection_level: int        # EEP 1..4, UEP 1..5
    bitrate_kbps: int
    eep_option: str = "A"        # EEP only
    uep_table_index: int = -1    # UEP only (FIG 0/1 short form)

    @property
    def profile(self) -> PuncturingProfile:
        if self.protection_type == "EEP":
            return eep_profile(self.protection_level, self.eep_option,
                               self.bitrate_kbps)
        return uep_profile(self.bitrate_kbps, self.protection_level)

    @property
    def decodable(self) -> bool:
        """False when the puncturing profile data is unavailable (e.g. the
        one non-bundled UEP Table 33 row); the receiver then skips this
        sub-channel instead of dying mid-stream (ADVICE r1)."""
        try:
            self.profile
        except NotImplementedError:
            return False
        return True

    @property
    def size_cus(self) -> int:
        if self.protection_type == "EEP":
            return eep_subchannel_cus(self.protection_level, self.eep_option,
                                      self.bitrate_kbps)
        return UEP_TABLE_31[self.uep_table_index][0]

    @property
    def data_bits(self) -> int:   # bits per 24 ms logical frame
        return self.bitrate_kbps * 24

    @property
    def data_bytes(self) -> int:
        return self.data_bits // 8

    @classmethod
    def eep(cls, subchid: int, start_cu: int, level: int, option: str,
            bitrate_kbps: int) -> "Subchannel":
        return cls(subchid=subchid, start_cu=start_cu, protection_type="EEP",
                   protection_level=level, bitrate_kbps=bitrate_kbps,
                   eep_option=option.upper())

    @classmethod
    def uep(cls, subchid: int, start_cu: int, table_index: int) -> "Subchannel":
        size, level, kbps = UEP_TABLE_31[table_index]
        del size
        return cls(subchid=subchid, start_cu=start_cu, protection_type="UEP",
                   protection_level=level, bitrate_kbps=kbps,
                   uep_table_index=table_index)


@dataclasses.dataclass(frozen=True)
class ServiceComponent:
    tmid: int                    # 0 = MSC stream audio, 3 = MSC packet data
    subchid: int                 # -1 for tmid=3 (resolved via scid/FIG 0/3)
    ascty: int = 0               # 0 = DAB (MP2), 63 = DAB+ (AAC)
    primary: bool = True
    user_apps: tuple = ()        # FIG 0/13 user application types
                                 # (2 = MOT slideshow, TS 101 756)
    scid: int = -1               # tmid=3: 12-bit service component id
    label: str = ""              # FIG 1/4 service component label

    @property
    def is_dabplus(self) -> bool:
        return self.ascty == 63


@dataclasses.dataclass(frozen=True)
class PacketComponent:
    """FIG 0/3 packet-mode description: SCId -> transport parameters."""

    scid: int                    # 12-bit service component id
    subchid: int
    address: int                 # 10-bit packet address
    dscty: int = 60              # TS 101 756: 60 = MOT
    dg: bool = True              # FIG 0/3 DG flag 0 = data groups used


@dataclasses.dataclass(frozen=True)
class Service:
    sid: int
    components: tuple[ServiceComponent, ...]
    label: str = ""


@dataclasses.dataclass(frozen=True)
class Ensemble:
    eid: int
    subchannels: tuple[Subchannel, ...]
    services: tuple[Service, ...] = ()
    label: str = ""
    packet_components: tuple[PacketComponent, ...] = ()
    # FIG 0/14: (subchid, FEC scheme) pairs; scheme 1 = the RS(204,188)
    # enhanced packet mode of EN 300 401 s5.3.5 (eti.pfec).  Host-side
    # only — deliberately NOT part of decode_config(): the outer FEC sits
    # above the device seam, so a late FIG 0/14 must not retrace the jit.
    fec_schemes: tuple[tuple[int, int], ...] = ()

    def __post_init__(self):
        ends = [s.start_cu + s.size_cus for s in self.subchannels]
        if any(e > C.CIF_CUS for e in ends):
            raise ValueError("sub-channel exceeds CIF capacity")

    def decode_config(self) -> "Ensemble":
        """The jit-relevant projection: sub-channel organization only.

        Labels/services/eid don't shape the device program; keying the jit
        on this stripped config avoids retraces (and spurious pipeline
        resets) when mux metadata arrives late or changes.
        """
        return Ensemble(eid=0, subchannels=self.subchannels)

    def subchannel(self, subchid: int) -> Subchannel:
        for s in self.subchannels:
            if s.subchid == subchid:
                return s
        raise KeyError(f"no sub-channel {subchid}")

    def packet_component(self, scid: int) -> PacketComponent:
        for pc in self.packet_components:
            if pc.scid == scid:
                return pc
        raise KeyError(f"no packet component SCId {scid}")

    def fec_scheme(self, subchid: int) -> int:
        """FIG 0/14 FEC scheme for a sub-channel (0 = none)."""
        for sc, scheme in self.fec_schemes:
            if sc == subchid:
                return scheme
        return 0

    def sorted_subchannels(self) -> tuple[Subchannel, ...]:
        return tuple(sorted(self.subchannels, key=lambda s: s.start_cu))

    def to_dict(self) -> dict:
        """JSON-safe representation (pickle-free checkpointing)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Ensemble":
        return cls(
            eid=d["eid"], label=d.get("label", ""),
            subchannels=tuple(Subchannel(**s) for s in d["subchannels"]),
            services=tuple(
                Service(sid=s["sid"], label=s.get("label", ""),
                        components=tuple(
                            ServiceComponent(
                                **{**c, "user_apps": tuple(c["user_apps"])})
                            for c in s["components"]))
                for s in d.get("services", ())),
            packet_components=tuple(
                PacketComponent(**p)
                for p in d.get("packet_components", ())),
            fec_schemes=tuple(
                (int(sc), int(scheme))
                for sc, scheme in d.get("fec_schemes", ())))

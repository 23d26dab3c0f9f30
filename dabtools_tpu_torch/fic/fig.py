"""FIG build + parse (ETSI EN 300 401 s5.2, s6, s8).

Reference counterpart: `upstream:dab.c` `fib_parse` (R10) — parse only.
We implement both directions: the *builder* feeds the golden modulator so
FIG parsing is tested closed-loop (the reference could only test against
live broadcasts); the *parser* produces the `Ensemble` config that
specializes the jitted MSC decode.

Supported FIGs (the MCI/label set dabtools handles [K-med], plus the
packet-mode, user-application, announcement and FEC signalling it lacks):
  0/0 ensemble info, 0/1 sub-channel organization (short+long form),
  0/2 service organization (pd=0 programme + pd=1 data services),
  0/3 service component in packet mode, 0/7 configuration information,
  0/8 service component global definition, 0/9 country/LTO,
  0/10 date & time, 0/13 user application info, 0/14 packet-mode FEC,
  0/18 + 0/19 announcements, 0/5 language, 0/17 programme type,
  0/6 service linking, 0/21 frequency information, 0/24 OE services,
  1/0 ensemble label, 1/1 programme service label, 1/5 data service
  label.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.fic.config import (
    Ensemble,
    PacketComponent,
    Service,
    ServiceComponent,
    Subchannel,
)
from dabtools_tpu_torch.utils.crc import crc16_ccitt, crc16_ok


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        return np.packbits(np.array(self.bits, dtype=np.uint8)).tobytes()


class _BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self.pos = 0

    def get(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v


# ------------------------------------------------------------------ build
def _fig_0_0(ens: Ensemble, cif_count: int) -> bytes:
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(0, 5)   # CN, OE, PD, ext=0
    w.put(ens.eid, 16)
    w.put(0, 2)                    # change flags
    w.put(0, 1)                    # Al flag
    w.put((cif_count // 250) % 20, 5)
    w.put(cif_count % 250, 8)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def _chunks(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]


def _fig_0_7(n_services: int, config_count: int) -> bytes:
    """Configuration information (EN 300 401 v2 s6.4.2) [K-med]:
    Services(6) = total service count, Count(10) = configuration counter
    incremented on each reconfiguration."""
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(7, 5)
    w.put(min(n_services, 63), 6)
    w.put(config_count & 0x3FF, 10)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def _fig_0_1(subchannels: tuple[Subchannel, ...]) -> list[bytes]:
    # A FIB carries <= 30 bytes; long-form entries are 4 bytes, so split
    # the sub-channel org over multiple FIG 0/1s (as real muxes do).
    figs = []
    for group in _chunks(subchannels, 6):
        w = _BitWriter()
        w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(1, 5)   # ext=1
        for s in group:
            w.put(s.subchid, 6)
            w.put(s.start_cu, 10)
            if s.protection_type == "UEP":
                w.put(0, 1)            # short form
                w.put(0, 1)            # table switch
                w.put(s.uep_table_index, 6)
            else:
                w.put(1, 1)            # long form
                option = 0 if s.eep_option == "A" else 1
                w.put(option, 3)
                w.put(s.protection_level - 1, 2)
                w.put(s.size_cus, 10)
        body = w.bytes()
        figs.append(bytes([0x00 | len(body)]) + body)
    return figs


def _is_data_service(svc: Service) -> bool:
    return svc.sid > 0xFFFF or any(c.tmid == 3 for c in svc.components)


def _fig_0_2(services: tuple[Service, ...]) -> list[bytes]:
    figs = []
    prog = tuple(s for s in services if not _is_data_service(s))
    data = tuple(s for s in services if _is_data_service(s))
    # pd=0: programme services, 16-bit SIds; pd=1: data services, 32-bit.
    for pd, svcs, sid_bits in ((0, prog, 16), (1, data, 32)):
        # Greedy BYTE-budget chunking (not a fixed per-FIG count): a FIG
        # body is capped at 29 bytes and component counts vary, so a
        # fixed count can overflow the 5-bit length field and corrupt
        # the whole FIB.
        groups: list[list[Service]] = []
        cur: list[Service] = []
        used = 0
        for svc in svcs:
            size = sid_bits // 8 + 1 + 2 * len(svc.components)
            if 1 + size > 29:
                raise ValueError(
                    f"service 0x{svc.sid:X}: too many components for one "
                    f"FIG 0/2")
            if cur and used + size > 28:   # 1 FIG-0 header byte + 28
                groups.append(cur)
                cur, used = [], 0
            cur.append(svc)
            used += size
        if cur:
            groups.append(cur)
        for group in groups:
            w = _BitWriter()
            w.put(0, 1); w.put(0, 1); w.put(pd, 1); w.put(2, 5)   # ext=2
            for svc in group:
                w.put(svc.sid, sid_bits)
                w.put(0, 1)                # local flag
                w.put(0, 3)                # CAId
                w.put(len(svc.components), 4)
                for comp in svc.components:
                    w.put(comp.tmid, 2)
                    if comp.tmid == 3:     # packet data: SCId reference
                        w.put(comp.scid, 12)
                    else:
                        w.put(comp.ascty, 6)
                        w.put(comp.subchid, 6)
                    w.put(1 if comp.primary else 0, 1)
                    w.put(0, 1)            # CA flag
            body = w.bytes()
            figs.append(bytes([0x00 | len(body)]) + body)
    return figs


def _fig_0_3(pcs) -> list[bytes]:
    """Service component in packet mode (EN 300 401 s6.3.2) [K-med]:
    SCId(12) rfa(3) CAOrg-flag(1)=0 DG-flag(1) rfu(1) DSCTy(6)
    SubChId(6) packet address(10) = 5 bytes/entry."""
    figs = []
    for group in _chunks(pcs, 5):
        w = _BitWriter()
        w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(3, 5)   # ext=3
        for pc in group:
            w.put(pc.scid, 12)
            w.put(0, 3); w.put(0, 1)
            w.put(0 if pc.dg else 1, 1)
            w.put(0, 1)
            w.put(pc.dscty, 6)
            w.put(pc.subchid, 6)
            w.put(pc.address, 10)
        body = w.bytes()
        figs.append(bytes([0x00 | len(body)]) + body)
    return figs


def _fig_0_14(fec_schemes) -> list[bytes]:
    """FEC sub-channel organization (EN 300 401 s6.2.2) [K-med]: one byte
    per packet-mode sub-channel, SubChId(6) FEC-scheme(2); scheme 1 =
    the RS(204,188) enhanced packet mode (`eti.pfec`)."""
    entries = [(sc, scheme) for sc, scheme in fec_schemes if scheme]
    figs = []
    for group in _chunks(entries, 28):
        w = _BitWriter()
        w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(14, 5)   # ext=14
        for sc, scheme in group:
            w.put(sc, 6)
            w.put(scheme, 2)
        body = w.bytes()
        figs.append(bytes([0x00 | len(body)]) + body)
    return figs


def _fig_0_13(services: tuple[Service, ...]) -> list[bytes]:
    """User application information (EN 300 401 s6.3.6) [K-med packing]:
    per service: SId(16 / 32 for pd=1) SCIdS(4) NumApps(4); per app:
    AppType(11) AppDataLength(5) (+ data, none emitted)."""
    figs = []
    for svc in services:
        comp = next((c for c in svc.components if c.user_apps), None)
        if comp is None:
            continue
        pd = 1 if _is_data_service(svc) else 0
        w = _BitWriter()
        w.put(0, 1); w.put(0, 1); w.put(pd, 1); w.put(13, 5)
        w.put(svc.sid, 32 if pd else 16)
        w.put(0, 4)                    # SCIdS (primary component)
        w.put(len(comp.user_apps), 4)
        for app in comp.user_apps:
            w.put(app, 11)
            w.put(0, 5)
        body = w.bytes()
        figs.append(bytes([0x00 | len(body)]) + body)
    return figs


def _fig_0_8(services: tuple[Service, ...]) -> list[bytes]:
    """Service component global definition (EN 300 401 s6.3.5) [K-med]:
    SId(16/32) ext-flag(1) rfa(3) SCIdS(4), then long form rfa(3)+SCId(12)
    for packet components or short form rfa(1)+SubChId(6).  Links the
    SCIdS used by FIG 0/13 to the transport (FIG 0/3's SCId)."""
    figs = []
    for svc in services:
        comp = next((c for c in svc.components if c.primary), None)
        if comp is None or comp.tmid != 3:
            continue                   # only needed for packet components
        pd = 1 if _is_data_service(svc) else 0
        w = _BitWriter()
        w.put(0, 1); w.put(0, 1); w.put(pd, 1); w.put(8, 5)
        w.put(svc.sid, 32 if pd else 16)
        w.put(0, 1)                    # ext flag (no rfa byte)
        w.put(0, 3)
        w.put(0, 4)                    # SCIdS 0 = primary
        w.put(1, 1)                    # LS flag: long form
        w.put(0, 3)
        w.put(comp.scid, 12)
        body = w.bytes()
        figs.append(bytes([0x00 | len(body)]) + body)
    return figs


_MJD_EPOCH_ORDINAL = 678576        # 1858-11-17 (MJD 0) as date.toordinal()


def fig_0_18(sid: int, asu_flags: int, clusters: tuple[int, ...]) -> bytes:
    """Announcement support (EN 300 401 s8.1.6.1) [K-med]: SId(16)
    ASu-flags(16) rfa(5) n-clusters(3) + cluster ids (8 each).
    ``asu_flags`` bit 0 = alarm, bit 1 = traffic, ... (TS 101 756)."""
    if len(clusters) > 7:
        raise ValueError("FIG 0/18 carries at most 7 cluster ids")
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(18, 5)
    w.put(sid, 16)
    w.put(asu_flags, 16)
    w.put(0, 5)
    w.put(len(clusters), 3)
    for c in clusters:
        w.put(c, 8)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_19(cluster: int, asw_flags: int, subchid: int,
             new_flag: bool = True) -> bytes:
    """Announcement switching (EN 300 401 s8.1.6.2) [K-med]: ClusterId(8)
    ASw-flags(16) NewFlag(1) RegionFlag(1)=0 SubChId(6).  ``asw_flags``
    == 0 signals the announcement has ENDED for this cluster."""
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(19, 5)
    w.put(cluster, 8)
    w.put(asw_flags, 16)
    w.put(1 if new_flag else 0, 1)
    w.put(0, 1)                    # region flag (no region id follows)
    w.put(subchid, 6)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_5(subchid: int, language: int) -> bytes:
    """Service component language, short form (EN 300 401 s8.1.8) [K-med]:
    per entry LS(1)=0 rfu(1) SubChId(6) Language(8); the long form
    (LS=1, rfa(3)+SCId(12)) addresses packet components.  Language codes
    per TS 101 756 table 9 (`tables.meta.LANGUAGES`)."""
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(5, 5)   # ext=5
    w.put(0, 1)                    # LS: short form
    w.put(0, 1)
    w.put(subchid, 6)
    w.put(language, 8)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_17(sid: int, pty: int, static: bool = True) -> bytes:
    """Programme type (EN 300 401 v2 s8.1.5) [K-med]: per entry SId(16)
    S/D(1) rfa(1) rfu(2) + rfu? — reconstructed as the v2 3-byte entry
    SId(16) S/D(1) rfa(1) rfu(1) IntCode(5).  PTy names per TS 101 756
    table 12 (`tables.meta.PROGRAMME_TYPES`)."""
    if sid > 0xFFFF:
        raise ValueError("FIG 0/17 carries programme types for PROGRAMME "
                         "services (16-bit SIds); data services have none")
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(17, 5)   # ext=17
    w.put(sid, 16)
    w.put(1 if static else 0, 1)
    w.put(0, 1)
    w.put(0, 1)
    w.put(pty, 5)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_6(lsn: int, ids: tuple[int, ...], idlq: int = 0,
            active: bool = True, hard: bool = True,
            international: bool = False) -> bytes:
    """Service linking information (EN 300 401 s8.1.15) [K-med]:
    IdListFlag(1) LA(1) S/H(1) ILS(1) LSN(12), then (IdListFlag=1)
    rfa(1) IdLQ(2) rfa(1) NumIds(4) + ids.  ``idlq`` 0 = DAB SIds,
    1 = RDS PI codes.  ``international=True`` (ILS=1) takes ECC-prefixed
    24-bit ids (ECC << 16 | SId)."""
    if len(ids) > 15:
        raise ValueError("FIG 0/6 carries at most 15 ids")
    id_bits = 24 if international else 16
    if any(i >> id_bits for i in ids):
        raise ValueError(f"FIG 0/6 ids must fit {id_bits} bits "
                         f"(ILS={int(international)})")
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(6, 5)   # ext=6
    w.put(1, 1)                    # id list follows
    w.put(1 if active else 0, 1)
    w.put(1 if hard else 0, 1)
    w.put(1 if international else 0, 1)
    w.put(lsn, 12)
    w.put(0, 1)
    w.put(idlq, 2)
    w.put(0, 1)
    w.put(len(ids), 4)
    for i in ids:
        w.put(i, id_bits)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_21(ident: int, freqs_hz: tuple[int, ...], rm: int = 0,
             region: int = 0, continuous: bool = False) -> bytes:
    """Frequency information (EN 300 401 s8.1.8) [K-med]: RegionId(11)
    FI-list-length(5); per FI entry Id(16) R&M(4) Continuity(1)
    freq-list-length(3); R&M=0 (DAB ensemble) frequencies are 3 bytes of
    Control(5) + freq(19) in 16 kHz units, R&M=8 (FM RDS) 1 byte of
    (MHz - 87.5) / 0.1."""
    if rm not in (0, 8):
        raise ValueError("only R&M 0 (DAB) and 8 (FM RDS) are built")
    freq_bytes = 3 if rm == 0 else 1
    if freq_bytes * len(freqs_hz) > 7:     # 3-bit byte count
        raise ValueError("too many frequencies for one FIG 0/21 entry "
                         f"(max {7 // freq_bytes} at R&M {rm}); emit "
                         "multiple FIGs")
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(21, 5)   # ext=21
    w.put(region, 11)
    w.put(3 + freq_bytes * len(freqs_hz), 5)   # FI list length in bytes
    w.put(ident, 16)
    w.put(rm, 4)
    w.put(1 if continuous else 0, 1)
    w.put(freq_bytes * len(freqs_hz), 3)       # freq list length in bytes
    for f in freqs_hz:
        if rm == 0:
            w.put(0, 5)                        # control field
            w.put(round(f / 16_000), 19)
        else:
            w.put(round((f / 1e6 - 87.5) / 0.1), 8)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_24(sid: int, eids: tuple[int, ...], oe: bool = True) -> bytes:
    """OE services (EN 300 401 s8.1.10) [K-med]: where else a service is
    carried.  Per entry: SId(16, or 32 with the header pd bit for data
    services) rfa(1) CAId(3) NumEIds(4) + EId(16) list.  ``oe=True``
    sets the header OE bit (the service belongs to ANOTHER ensemble;
    False = this ensemble's service is also found in the listed
    ensembles).  The parser merges multiple FIGs for one service, so
    emit several for >12 ensembles (the 29-byte body cap)."""
    pd = 1 if sid > 0xFFFF else 0
    # body cap: 29 bytes = ext hdr(1) + SId(2 or 4) + 1 + 2*n
    #   -> n <= 12 (pd=0) / 11 (pd=1)
    max_eids = (29 - 1 - (4 if pd else 2) - 1) // 2
    if len(eids) > max_eids:
        raise ValueError(f"FIG 0/24 carries at most {max_eids} ensemble "
                         f"ids per FIG; emit multiple FIGs")
    if any(e >> 16 for e in eids):
        raise ValueError("EIds are 16 bits")
    w = _BitWriter()
    w.put(0, 1); w.put(1 if oe else 0, 1); w.put(pd, 1); w.put(24, 5)
    w.put(sid, 32 if pd else 16)
    w.put(0, 1)
    w.put(0, 3)                    # CAId
    w.put(len(eids), 4)
    for e in eids:
        w.put(e, 16)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_25(sid: int, asu_flags: int, eids: tuple[int, ...]) -> bytes:
    """OE announcement support (EN 300 401 s8.1.10.5.1) [K-med]: this
    ensemble's service ``sid`` supports announcements (``asu_flags``)
    carried in the OTHER ensembles listed.  Entry: SId(16) ASu(16)
    rfa(4) NumEIds(4) + EId(16) list."""
    # body cap: 29 bytes = ext hdr(1) + SId(2) + ASu(2) + 1 + 2*n -> n <= 11
    if len(eids) > 11:
        raise ValueError("FIG 0/25 carries at most 11 ensemble ids per "
                         "FIG; emit multiple FIGs (the parser merges)")
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(25, 5)   # ext=25
    w.put(sid, 16)
    w.put(asu_flags, 16)
    w.put(0, 4)
    w.put(len(eids), 4)
    for e in eids:
        w.put(e, 16)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_26(cluster_current: int, asw_flags: int, eid_other: int,
             cluster_other: int, new_flag: bool = True) -> bytes:
    """OE announcement switching (EN 300 401 s8.1.10.5.2) [K-low field
    packing — reconstructed]: an announcement for local cluster
    ``cluster_current`` is running in ensemble ``eid_other`` under its
    ``cluster_other``.  Entry: ClusterIdCurrent(8) ASw(16) NewFlag(1)
    rfa(7) EId(16) ClusterIdOther(8)."""
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(26, 5)   # ext=26
    w.put(cluster_current, 8)
    w.put(asw_flags, 16)
    w.put(1 if new_flag else 0, 1)
    w.put(0, 7)
    w.put(eid_other, 16)
    w.put(cluster_other, 8)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_9(lto_half_hours: int = 0, ecc: int = 0,
            table_id: int = 1) -> bytes:
    """Country, LTO and international table (EN 300 401 s8.1.3.2) [K-med]:
    ext-flag(1) rfa(1) ensemble-LTO(6, sign + half-hours) ECC(8)
    table-id(8).  ``table_id`` 1 = the TS 101 756 PTy table."""
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(9, 5)
    w.put(0, 1)                    # extended field flag
    w.put(0, 1)                    # rfa
    w.put((0x20 if lto_half_hours < 0 else 0) | min(abs(lto_half_hours), 31),
          6)
    w.put(ecc, 8)
    w.put(table_id, 8)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def fig_0_10(utc) -> bytes:
    """Date and time (EN 300 401 s8.1.3.1) [K-med]: rfu(1) MJD(17) LSI(1)
    rfa(1) UTC-flag(1), then long-form UTC h(5) m(6) s(6) ms(10).
    ``utc``: a ``datetime.datetime`` (naive = UTC)."""
    mjd = utc.date().toordinal() - _MJD_EPOCH_ORDINAL
    w = _BitWriter()
    w.put(0, 1); w.put(0, 1); w.put(0, 1); w.put(10, 5)
    w.put(0, 1)                    # rfu
    w.put(mjd, 17)
    w.put(0, 1)                    # leap second indicator
    w.put(0, 1)                    # rfa
    w.put(1, 1)                    # UTC flag: long form (with seconds)
    w.put(utc.hour, 5)
    w.put(utc.minute, 6)
    w.put(utc.second, 6)
    w.put(utc.microsecond // 1000, 10)
    body = w.bytes()
    return bytes([0x00 | len(body)]) + body


def _fig_1(ext: int, ident: int, label: str) -> bytes:
    lab = label.encode("latin-1", "replace")[:16].ljust(16)
    w = _BitWriter()
    w.put(0, 4)                    # charset: EBU Latin
    w.put(0, 1)                    # OE / Rfu
    w.put(ext, 3)
    # ext 5 = data service label: 32-bit SId (EN 300 401 s8.1.14.2)
    w.put(ident, 32 if ext == 5 else 16)
    body = w.bytes() + lab + b"\xff\x00"   # char flag field
    return bytes([0x20 | len(body)]) + body


def fig_1_4(sid: int, label: str, scids: int = 0,
            pd: bool = False) -> bytes:
    """Service component label (EN 300 401 s8.1.14.3) [K-med packing]:
    charset(4) OE(1) ext(3)=4, then P/D(1) rfa(3) SCIdS(4), SId(16/32),
    16-char label + character flag field."""
    lab = label.encode("latin-1", "replace")[:16].ljust(16)
    w = _BitWriter()
    w.put(0, 4); w.put(0, 1); w.put(4, 3)
    w.put(1 if pd else 0, 1); w.put(0, 3); w.put(scids, 4)
    w.put(sid, 32 if pd else 16)
    body = w.bytes() + lab + b"\xff\x00"
    return bytes([0x20 | len(body)]) + body


def fig_1_6(sid: int, appty: int, label: str, scids: int = 0,
            pd: bool = False) -> bytes:
    """X-PAD user application label (EN 300 401 s8.1.14.4) [K-med
    packing]: as FIG 1/4 plus one byte rfa(2) rfu(1) X-PAD-AppTy(5)
    between the SId and the label.  ``appty`` is the X-PAD application
    type (TS 101 756, e.g. 2 = dynamic label, 12 = MOT slideshow)."""
    lab = label.encode("latin-1", "replace")[:16].ljust(16)
    w = _BitWriter()
    w.put(0, 4); w.put(0, 1); w.put(6, 3)
    w.put(1 if pd else 0, 1); w.put(0, 3); w.put(scids, 4)
    w.put(sid, 32 if pd else 16)
    w.put(0, 2); w.put(0, 1); w.put(appty, 5)
    body = w.bytes() + lab + b"\xff\x00"
    return bytes([0x20 | len(body)]) + body


def _fits_one_frame(figs: list[bytes], n_fibs: int) -> bool:
    """Would the greedy FIB packer fit ``figs`` into ``n_fibs`` FIBs?"""
    fib_idx, used = 0, 0
    for fig in figs:
        if used + len(fig) > 30:
            fib_idx += 1
            used = 0
            if fib_idx >= n_fibs:
                return False
        used += len(fig)
    return True


def build_fibs_for_ensemble(ens: Ensemble, frame_idx: int,
                            n_fibs: int = C.MODE_I.n_fibs,
                            extra_figs: tuple = (),
                            config_count: int | None = None) -> np.ndarray:
    """Build one transmission frame's FIBs carrying the full MCI.

    FIG 0/0 (ensemble id + CIF counter) goes in EVERY frame; the rest of
    the MCI/label FIGs are packed greedily and — when the mux is too big
    for one frame's FIBs, as real muxes routinely are — split into groups
    spread round-robin over consecutive frames (the parser accumulates
    across frames).  Unused space is end-marked (0xFF) and zero-padded;
    each FIB gets its CRC.  Returns (n_fibs, 32) uint8.
    """
    head = _fig_0_0(ens, cif_count=frame_idx * C.MODE_I.n_cifs)
    rest: list[bytes] = []
    if config_count is not None:   # FIG 0/7 rides right after FIG 0/0
        rest.append(_fig_0_7(len(ens.services), config_count))
    rest += _fig_0_1(ens.subchannels)
    if ens.services:
        rest += _fig_0_2(ens.services)
        rest += _fig_0_13(ens.services)
    if ens.packet_components:
        rest += _fig_0_3(ens.packet_components)
        rest += _fig_0_8(ens.services)
    if ens.fec_schemes:
        rest += _fig_0_14(ens.fec_schemes)
    rest += list(extra_figs)       # e.g. fig_0_9 / fig_0_10
    # Labels are rotated across frames (each is ~21 B, most of a FIB; real
    # muxes repeat them at low rate).  Up to 3 label FIGs per frame.
    labels = []
    if ens.label:
        labels.append(_fig_1(0, ens.eid, ens.label))
    for svc in ens.services:
        if svc.label:
            labels.append(_fig_1(5 if svc.sid > 0xFFFF else 1,
                                 svc.sid, svc.label))
        # FIG 1/4 component labels; SCIdS = the component's index in the
        # service's FIG 0/2 order (0 = primary) — the same convention the
        # parser uses to attach them back.
        for k, comp in enumerate(svc.components):
            if comp.label:
                labels.append(fig_1_4(svc.sid, comp.label, scids=k,
                                      pd=svc.sid > 0xFFFF))
    if labels:
        start = (3 * frame_idx) % len(labels)
        rest += (labels[start:] + labels[:start])[:3]

    for fig in rest:
        if len(fig) > 30:
            raise ValueError("FIG too large for a FIB")
    # Greedy split into frame-sized groups; most muxes yield one group
    # (everything in every frame, the round-1 behavior).
    groups: list[list[bytes]] = []
    cur: list[bytes] = []
    for fig in rest:
        if _fits_one_frame([head] + cur + [fig], n_fibs):
            cur.append(fig)
        else:
            if not cur:
                raise ValueError("FIG too large for a frame's FIBs")
            groups.append(cur)
            cur = [fig]
    groups.append(cur)
    figs = [head] + groups[frame_idx % len(groups)]

    fibs = np.zeros((n_fibs, C.FIB_BYTES), dtype=np.uint8)
    fib_idx = 0
    payload = b""
    for fig in figs:
        if len(payload) + len(fig) > 30:
            fibs[fib_idx] = _finish_fib(payload)
            fib_idx += 1
            payload = b""
        payload += fig
    fibs[fib_idx] = _finish_fib(payload)
    for i in range(fib_idx + 1, n_fibs):
        fibs[i] = _finish_fib(b"")
    return fibs


def _finish_fib(payload: bytes) -> np.ndarray:
    if len(payload) < 30:
        payload += b"\xff"          # end marker
    payload = payload.ljust(30, b"\x00")
    crc = crc16_ccitt(payload)
    return np.frombuffer(payload + crc.to_bytes(2, "big"), dtype=np.uint8)


# ------------------------------------------------------------------ parse
@dataclasses.dataclass
class FigParser:
    """Accumulates FIG info from FIBs until a complete MCI is available.

    Mirrors the reference's incremental `fib_parse` (R10): feed every
    CRC-valid FIB; ``ensemble()`` returns a config once FIG 0/1 has been
    seen (services/labels attached as they arrive).
    """

    eid: int | None = None
    cif_count: int | None = None
    ensemble_label: str = ""
    subchannels: dict = dataclasses.field(default_factory=dict)
    services: dict = dataclasses.field(default_factory=dict)
    service_labels: dict = dataclasses.field(default_factory=dict)
    # FIG 1/4: (SId, SCIdS) -> service component label
    component_labels: dict = dataclasses.field(default_factory=dict)
    # FIG 1/6: (SId, SCIdS, X-PAD AppTy) -> user application label
    xpad_labels: dict = dataclasses.field(default_factory=dict)
    user_apps: dict = dataclasses.field(default_factory=dict)
    packet_comps: dict = dataclasses.field(default_factory=dict)
    # FIG 0/14: subchid -> FEC scheme (1 = RS(204,188) packet-mode FEC)
    fec_schemes: dict = dataclasses.field(default_factory=dict)
    # FIG 0/5: ("subch", SubChId) | ("scid", SCId) -> TS 101 756 language
    languages: dict = dataclasses.field(default_factory=dict)
    # FIG 0/17: SId -> (PTy int. code, static flag)
    ptys: dict = dataclasses.field(default_factory=dict)
    # FIG 0/6: LSN -> dict(active, hard, international, idlq, ids)
    linkage_sets: dict = dataclasses.field(default_factory=dict)
    # FIG 0/21: (region, Id, R&M) -> tuple of frequencies in Hz
    freq_info: dict = dataclasses.field(default_factory=dict)
    # FIG 0/24: (SId, oe flag) -> tuple of EIds the service is also in
    # (merged across FIGs; this-ensemble and other-ensemble info are
    # distinct databases, hence the oe key)
    oe_services: dict = dataclasses.field(default_factory=dict)
    # FIG 0/25: SId -> (ASu flags, tuple of EIds carrying the support)
    oe_announce_support: dict = dataclasses.field(default_factory=dict)
    # FIG 0/26: local cluster -> (ASw, other EId, other cluster, tick)
    oe_announce_active: dict = dataclasses.field(default_factory=dict)
    # FIG 0/8: (sid, SCIdS) -> ("scid", SCId) | ("subch", SubChId)
    scids_map: dict = dataclasses.field(default_factory=dict)
    _user_apps_scids: dict = dataclasses.field(default_factory=dict)
    # FIG 0/18 + 0/19 announcements: sid -> (ASu flags, cluster ids);
    # cluster -> (ASw flags, subchid) while an announcement is active.
    announce_support: dict = dataclasses.field(default_factory=dict)
    announce_active: dict = dataclasses.field(default_factory=dict)
    # FIG 0/7: expected service count + reconfiguration counter
    n_services_signalled: int | None = None
    config_count: int | None = None
    # FIG 0/9 + 0/10 (informational, not part of the Ensemble config)
    ecc: int | None = None
    lto_half_hours: int | None = None
    intl_table: int | None = None
    utc: "object | None" = None    # datetime.datetime of the last FIG 0/10
    fibs_ok: int = 0
    fibs_bad: int = 0
    figs_malformed: int = 0
    # Mux reconfiguration support: FIG 0/1 entries must be re-signalled to
    # stay live (real multiplexes repeat the MCI every frame); stale
    # sub-channels age out so a reconfigured ensemble replaces, not merges.
    max_subch_age_fibs: int = 120
    # FIG 0/19 repeats at least once per second while an announcement is
    # live (EN 300 401 s8.1.6.2); ~2.5 s of FIBs without a re-signal
    # means it ended and we missed the ASw=0.
    max_announce_age_fibs: int = 300
    _tick: int = 0
    _subch_seen: dict = dataclasses.field(default_factory=dict)

    def tick(self, subchids: tuple[int, ...] = ()) -> None:
        """Advance the staleness clock for a FIB known to repeat earlier
        content (dedup fast path), refreshing the given sub-channels."""
        self._tick += 1
        for sc in subchids:
            self._subch_seen[sc] = self._tick

    def feed_fib(self, fib: bytes | np.ndarray) -> tuple[int, ...]:
        """Parse one FIB; returns the sub-channel ids it (re)signalled."""
        fib = bytes(fib)
        if len(fib) != C.FIB_BYTES:
            raise ValueError("FIB must be 32 bytes")
        if not crc16_ok(fib):
            self.fibs_bad += 1
            return ()
        self.fibs_ok += 1
        self._tick += 1
        self._touched: list[int] = []
        pos = 0
        data = fib[:30]
        while pos < 30:
            header = data[pos]
            if header == 0xFF:      # end marker
                break
            fig_type = header >> 5
            length = header & 0x1F
            body = data[pos + 1: pos + 1 + length]
            try:
                if fig_type == 0:
                    self._parse_fig0(body)
                elif fig_type == 1:
                    self._parse_fig1(body)
            except Exception:
                # A corrupt FIB can pass CRC16 (~2^-16), and real muxes may
                # signal combinations we don't model; a malformed FIG must
                # degrade to a counter, never kill the stream.
                self.figs_malformed += 1
            pos += 1 + length
        return tuple(self._touched)

    def _parse_fig0(self, body: bytes) -> None:
        r = _BitReader(body)
        r.get(1)
        oe = r.get(1)
        pd = r.get(1)
        ext = r.get(5)
        remaining_bits = lambda: len(body) * 8 - r.pos  # noqa: E731
        if ext == 0:
            self.eid = r.get(16)
            r.get(2); r.get(1)
            hi = r.get(5); lo = r.get(8)
            self.cif_count = hi * 250 + lo
        elif ext == 1:
            while remaining_bits() >= 24:   # smallest complete entry
                subchid = r.get(6)
                start = r.get(10)
                long_form = r.get(1)
                if long_form and remaining_bits() < 15:
                    break
                if long_form:
                    option = r.get(3)
                    level = r.get(2) + 1
                    size = r.get(10)
                    sub = Subchannel.eep(
                        subchid, start, level,
                        "A" if option == 0 else "B",
                        bitrate_kbps=_eep_bitrate_from_size(
                            size, level, option))
                else:
                    r.get(1)
                    index = r.get(6)
                    sub = Subchannel.uep(subchid, start, index)
                self.subchannels[subchid] = sub
                self._subch_seen[subchid] = self._tick
                self._touched.append(subchid)
        elif ext == 2:
            sid_bits = 32 if pd else 16
            while remaining_bits() >= sid_bits + 8:
                sid = r.get(sid_bits)
                r.get(1); r.get(3)
                n_comp = r.get(4)
                comps = []
                for _ in range(n_comp):
                    tmid = r.get(2)
                    if tmid == 3:                # packet data: SCId ref
                        scid = r.get(12)
                        primary = bool(r.get(1))
                        r.get(1)
                        comps.append(ServiceComponent(
                            tmid=3, subchid=-1, scid=scid, primary=primary))
                        continue
                    ascty = r.get(6)
                    subchid = r.get(6)
                    primary = bool(r.get(1))
                    r.get(1)
                    comps.append(ServiceComponent(
                        tmid=tmid, subchid=subchid, ascty=ascty,
                        primary=primary))
                self.services[sid] = tuple(comps)
                if sid in self.user_apps:        # re-attach on re-signal
                    self._attach_user_apps(sid)
        elif ext == 3:
            while remaining_bits() >= 40:
                scid = r.get(12)
                r.get(3)
                ca_org = r.get(1)
                dg = r.get(1)
                r.get(1)
                dscty = r.get(6)
                subchid = r.get(6)
                address = r.get(10)
                if ca_org:
                    if remaining_bits() < 16:
                        break
                    r.get(16)
                self.packet_comps[scid] = PacketComponent(
                    scid=scid, subchid=subchid, address=address,
                    dscty=dscty, dg=(dg == 0))
        elif ext == 9:
            r.get(1); r.get(1)
            lto = r.get(6)
            self.lto_half_hours = -(lto & 0x1F) if lto & 0x20 else lto
            self.ecc = r.get(8)
            self.intl_table = r.get(8)
        elif ext == 10:
            r.get(1)
            mjd = r.get(17)
            r.get(1); r.get(1)
            long_form = r.get(1)
            h, m = r.get(5), r.get(6)
            s, ms = (r.get(6), r.get(10)) if long_form else (0, 0)
            import datetime
            self.utc = datetime.datetime.fromordinal(
                mjd + _MJD_EPOCH_ORDINAL).replace(
                hour=h, minute=m, second=s, microsecond=ms * 1000)
        elif ext == 18:
            while remaining_bits() >= 40:
                sid = r.get(16)
                asu = r.get(16)
                r.get(5)
                n_cl = r.get(3)
                if remaining_bits() < 8 * n_cl:
                    break
                clusters = tuple(r.get(8) for _ in range(n_cl))
                self.announce_support[sid] = (asu, clusters)
        elif ext == 19:
            while remaining_bits() >= 32:
                cluster = r.get(8)
                asw = r.get(16)
                r.get(1)                         # new flag
                region = r.get(1)
                subchid = r.get(6)
                if region:
                    if remaining_bits() < 8:
                        break
                    r.get(8)                     # region id lower + rfa
                if asw:
                    self.announce_active[cluster] = (asw, subchid,
                                                     self._tick)
                else:
                    self.announce_active.pop(cluster, None)
        elif ext == 7:
            self.n_services_signalled = r.get(6)
            self.config_count = r.get(10)
        elif ext == 14:
            while remaining_bits() >= 8:
                subchid = r.get(6)
                self.fec_schemes[subchid] = r.get(2)
        elif ext == 6:
            while remaining_bits() >= 16:
                id_list = r.get(1)
                la, sh, ils = r.get(1), r.get(1), r.get(1)
                lsn = r.get(12)
                entry = self.linkage_sets.setdefault(
                    lsn, {"active": bool(la), "hard": bool(sh),
                          "international": bool(ils), "idlq": 0,
                          "ids": ()})
                entry.update(active=bool(la), hard=bool(sh),
                             international=bool(ils))
                if not id_list:
                    continue         # change-event form: flags only
                if remaining_bits() < 8:
                    break
                r.get(1)
                idlq = r.get(2)
                r.get(1)
                n_ids = r.get(4)
                id_bits = 24 if ils else 16   # ILS: ECC(8) + SId(16)
                if remaining_bits() < id_bits * n_ids:
                    break
                entry["idlq"] = idlq
                entry["ids"] = tuple(r.get(id_bits) for _ in range(n_ids))
        elif ext == 21:
            while remaining_bits() >= 16:
                region = r.get(11)
                fi_len = r.get(5)
                if remaining_bits() < 8 * fi_len:
                    break
                end = r.pos + 8 * fi_len
                while end - r.pos >= 24:
                    ident = r.get(16)
                    rm = r.get(4)
                    r.get(1)          # continuity flag
                    n_bytes = r.get(3)
                    if 8 * n_bytes > end - r.pos:
                        break         # malformed entry: don't overrun
                    freqs = []
                    if rm == 0:       # DAB ensemble: Control(5) + f(19)
                        for _ in range(n_bytes // 3):
                            r.get(5)
                            freqs.append(r.get(19) * 16_000)
                        r.pos += 8 * (n_bytes % 3)
                    elif rm == 8:     # FM RDS: (MHz - 87.5) / 0.1
                        for _ in range(n_bytes):
                            freqs.append(
                                round((87.5 + 0.1 * r.get(8)) * 1e6))
                    else:             # unmodelled R&M: skip the bytes
                        r.pos += 8 * n_bytes
                    if freqs:
                        self.freq_info[(region, ident, rm)] = tuple(freqs)
                r.pos = end
        elif ext == 5:
            while remaining_bits() >= 16:
                if r.get(1):                     # LS=1: long form (SCId)
                    if remaining_bits() < 23:
                        break
                    r.get(3)
                    key = ("scid", r.get(12))
                else:
                    r.get(1)
                    key = ("subch", r.get(6))
                self.languages[key] = r.get(8)
        elif ext == 17:
            while remaining_bits() >= 24:
                sid = r.get(16)
                static = bool(r.get(1))
                r.get(1); r.get(1)
                self.ptys[sid] = (r.get(5), static)
        elif ext == 25:
            while remaining_bits() >= 40:
                sid = r.get(16)
                asu = r.get(16)
                r.get(4)
                n_eids = r.get(4)
                if remaining_bits() < 16 * n_eids:
                    break
                eids = tuple(r.get(16) for _ in range(n_eids))
                # >11 ensembles span multiple FIGs: merge, like ext 24.
                old_asu, have = self.oe_announce_support.get(sid, (0, ()))
                self.oe_announce_support[sid] = (
                    asu | old_asu, have + tuple(
                        e for e in eids if e not in have))
        elif ext == 26:
            while remaining_bits() >= 56:
                cluster = r.get(8)
                asw = r.get(16)
                r.get(1)                     # new flag
                r.get(7)
                eid_other = r.get(16)
                cluster_other = r.get(8)
                if asw:
                    self.oe_announce_active[cluster] = (
                        asw, eid_other, cluster_other, self._tick)
                else:
                    self.oe_announce_active.pop(cluster, None)
        elif ext == 24:
            sid_bits = 32 if pd else 16
            while remaining_bits() >= sid_bits + 8:
                sid = r.get(sid_bits)
                r.get(1); r.get(3)           # rfa, CAId
                n_eids = r.get(4)
                if remaining_bits() < 16 * n_eids:
                    break
                eids = tuple(r.get(16) for _ in range(n_eids))
                key = (sid, bool(oe))
                have = self.oe_services.get(key, ())
                self.oe_services[key] = have + tuple(
                    e for e in eids if e not in have)
        elif ext == 8:
            # Service component global definition: SCIdS -> transport
            sid_bits = 32 if pd else 16
            while remaining_bits() >= sid_bits + 16:
                sid = r.get(sid_bits)
                ext_flag = r.get(1)
                r.get(3)
                scids = r.get(4)
                if r.get(1):                     # LS=1: long form (SCId)
                    if remaining_bits() < 15:    # truncated final entry
                        break
                    r.get(3)
                    self.scids_map[(sid, scids)] = ("scid", r.get(12))
                else:                            # short form (SubChId)
                    r.get(1)
                    self.scids_map[(sid, scids)] = ("subch", r.get(6))
                if ext_flag:
                    if remaining_bits() < 8:
                        break
                    r.get(8)                     # rfa byte
                self._attach_user_apps(sid)
        elif ext == 13:
            sid_bits = 32 if pd else 16
            while remaining_bits() >= sid_bits + 8:
                sid = r.get(sid_bits)
                scids = r.get(4)
                n_apps = r.get(4)
                apps = []
                for _ in range(n_apps):
                    if remaining_bits() < 16:
                        break
                    apps.append(r.get(11))
                    dlen = r.get(5)
                    for _ in range(dlen):        # skip app data bytes
                        r.get(8)
                self.user_apps[sid] = tuple(apps)
                self._user_apps_scids[(sid, scids)] = tuple(apps)
                self._attach_user_apps(sid)

    def _attach_user_apps(self, sid: int) -> None:
        comps = self.services.get(sid)
        apps = self.user_apps.get(sid)
        if not comps or not apps:
            return
        # FIG 0/8 tells which component each SCIdS's apps belong to
        # (matched via SCId for packet components, SubChId for stream);
        # without a mapping, the reference-era assumption: primary.
        new = list(comps)
        attached = False
        for (s, scids), apps2 in self._user_apps_scids.items():
            if s != sid:
                continue
            m = self.scids_map.get((sid, scids))
            if m is None:
                continue
            kind, ident = m
            for i, c in enumerate(new):
                if ((kind == "scid" and c.scid == ident)
                        or (kind == "subch" and c.subchid == ident)):
                    new[i] = dataclasses.replace(c, user_apps=apps2)
                    attached = True
        if not attached:
            new = [dataclasses.replace(c, user_apps=apps)
                   if c.primary else c for c in new]
        self.services[sid] = tuple(new)

    def _parse_fig1(self, body: bytes) -> None:
        r = _BitReader(body)
        r.get(4); r.get(1)
        ext = r.get(3)
        scids = appty = None
        if ext in (4, 6):                  # P/D(1) rfa(3) SCIdS(4) lead-in
            pd = r.get(1)
            r.get(3)
            scids = r.get(4)
        else:
            pd = 1 if ext == 5 else 0      # 1/5: 32-bit data-service SId
        ident = r.get(32 if pd else 16)
        if ext == 6:                       # rfa(2) rfu(1) X-PAD AppTy(5)
            r.get(3)
            appty = r.get(5)
        off = r.pos // 8
        label = body[off:off + 16].decode("latin-1", "replace").rstrip()
        if ext == 0:
            self.ensemble_label = label
        elif ext in (1, 5):
            self.service_labels[ident] = label
        elif ext == 4:
            self.component_labels[(ident, scids)] = label
        elif ext == 6:
            self.xpad_labels[(ident, scids, appty)] = label

    def announcement_for(self, sid: int) -> tuple[int, int] | None:
        """(ASw flags, subchid) of an active announcement this service
        supports and should switch to, else None (EN 300 401 s8.1.6).

        An active cluster must keep being re-signalled: if its FIG 0/19
        stops repeating (or the single ASw=0 end marker is lost to a FIB
        CRC failure) it ages out after ``max_announce_age_fibs`` instead
        of pinning the receiver to the announcement forever."""
        sup = self.announce_support.get(sid)
        if not sup:
            return None
        asu, clusters = sup
        horizon = self._tick - self.max_announce_age_fibs
        for c in clusters:
            act = self.announce_active.get(c)
            if act is None:
                continue
            asw, subchid, seen = act
            if seen <= horizon:
                del self.announce_active[c]
                continue
            if asw & asu:
                return asw, subchid
        return None

    def _with_component_labels(self, sid: int, comps: tuple) -> tuple:
        """Attach FIG 1/4 labels to a service's components.  A label is
        keyed (SId, SCIdS); the SCIdS resolves to a transport via FIG 0/8
        when one was signalled (as `_attach_user_apps` does), else by the
        builder's convention SCIdS = index in FIG 0/2 order."""
        if not self.component_labels:
            return comps
        new = list(comps)
        for (s, scids), label in self.component_labels.items():
            if s != sid:
                continue
            m = self.scids_map.get((sid, scids))
            if m is not None:
                kind, ident = m
                for i, c in enumerate(new):
                    if ((kind == "scid" and c.scid == ident)
                            or (kind == "subch" and c.subchid == ident)):
                        new[i] = dataclasses.replace(c, label=label)
                        break
            elif scids < len(new):
                new[scids] = dataclasses.replace(new[scids], label=label)
        return tuple(new)

    def _live_subchannels(self) -> dict:
        horizon = self._tick - self.max_subch_age_fibs
        return {sc: sub for sc, sub in self.subchannels.items()
                if self._subch_seen.get(sc, 0) > horizon}

    def have_mci(self) -> bool:
        return bool(self._live_subchannels())

    def ensemble(self) -> Ensemble | None:
        live = self._live_subchannels()
        if not live:
            return None
        services = tuple(
            Service(sid=sid, components=self._with_component_labels(
                        sid, comps),
                    label=self.service_labels.get(sid, ""))
            for sid, comps in sorted(self.services.items())
            if all(c.subchid in live for c in comps if c.tmid == 0))
        return Ensemble(
            eid=self.eid or 0,
            subchannels=tuple(sorted(live.values(),
                                     key=lambda s: s.start_cu)),
            services=services,
            label=self.ensemble_label,
            packet_components=tuple(
                pc for _, pc in sorted(self.packet_comps.items())
                if pc.subchid in live),
            fec_schemes=tuple(
                (sc, scheme) for sc, scheme in sorted(self.fec_schemes.items())
                if scheme and sc in live))


def _eep_bitrate_from_size(size_cus: int, level: int, option: int) -> int:
    """Invert the EEP CU tables: sub-channel size -> bitrate."""
    from dabtools_tpu_torch.tables.puncturing import EEP_CUS_PER_N, EEP_KBPS_PER_N

    opt = "A" if option == 0 else "B"
    per_n = EEP_CUS_PER_N[(opt, level)]
    if size_cus % per_n:
        raise ValueError(
            f"EEP {level}-{opt} sub-channel size {size_cus} CUs is not a "
            f"multiple of {per_n}")
    return (size_cus // per_n) * EEP_KBPS_PER_N[opt]

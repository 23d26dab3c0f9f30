"""FIG builder (EN 300 401 s5.2, s6, s8): one transmission frame's FIBs
carrying an ensemble's MCI and labels.

Frozen copy of the builder half of the port's ``fic/fig.py`` (the
parser and the optional FIGs the benchmark's ensembles do not carry are
left out); every kept definition is verbatim.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from .config import Ensemble, Service, Subchannel
from .crc import crc16_ccitt


class _BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        return np.packbits(np.array(self.bits, dtype=np.uint8)).tobytes()


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

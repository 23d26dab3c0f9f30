"""``dabmux``: JSON mux configuration in, ETI(NI) stream out (the
`ODR-DabMux` role in the dabtools ecosystem).

Builds a standards-complete ensemble from the framework's own encoders:
FIG MCI/labels (fic.fig), MP2 stream with optional X-PAD dynamic labels
(eti.pad), DAB+ superframes (eti.dabplus), packet-mode MOT object
carousels (eti.packet + eti.mot), FIG 0/9 / 0/10 time signalling — then
frames everything with the ETI assembler.  Together with ``eti2iq`` the
framework covers the full lab chain: config -> ETI -> IQ -> (receiver)
-> ETI -> audio/objects.

Config example (JSON)::

    {"eid": "0x4FFF", "label": "MY MUX", "time": true,
     "services": [
       {"sid": "0x1111", "label": "POP", "type": "mp2",
        "subch": {"id": 1, "start_cu": 0, "protection": "EEP-3A",
                  "bitrate": 128},
        "source": "prbs", "dls": "Now playing: demo"},
       {"sid": "0x2222", "label": "NEWS+", "type": "dab+",
        "subch": {"id": 2, "start_cu": 96, "protection": "EEP-3A",
                  "bitrate": 72}, "source": "prbs"},
       {"sid": "0xE1C00042", "label": "EPG", "type": "packet",
        "subch": {"id": 3, "start_cu": 123, "protection": "EEP-3A",
                  "bitrate": 32},
        "scid": 7, "address": 33, "objects": ["logo.png"],
        "fec": true}]}

``"fec": true`` (packet services) applies the RS(204,188) packet-mode
FEC of EN 300 401 s5.3.5 and signals it via FIG 0/14.  Optional
per-service ``"language"`` (TS 101 756 table 9 code -> FIG 0/5),
``"pty"`` (table 12 programme type -> FIG 0/17), ``"component_label"``
(FIG 1/4) and ``"xpad_label"`` (FIG 1/6, labels the DLS X-PAD app)
metadata.

``source``: "prbs" (deterministic pseudo-random payload) or a file path
whose bytes fill the sub-channel's logical frames (e.g. an MP2 elementary
stream, or raw DAB+ superframe bytes from ``eti2audio``-style capture).

Usage: python -m dabtools_tpu.cli.dabmux mux.json --cifs 400 -o out.eti
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np

log = logging.getLogger("dabtools_tpu.dabmux")


def _parse_protection(spec: str):
    """'EEP-3A' / 'UEP-12' -> kwargs for the Subchannel constructors."""
    kind, _, rest = spec.partition("-")
    kind = kind.upper()
    if kind == "EEP":
        return {"level": int(rest[:-1]), "option": rest[-1].upper()}
    if kind == "UEP":
        return {"table_index": int(rest)}
    raise ValueError(f"unknown protection {spec!r} (use EEP-3A / UEP-12)")


def _take_wrapped(data: bytes, pos: int, n: int) -> tuple[bytes, int]:
    """``n`` bytes from a circular view of ``data`` starting at ``pos``
    (contiguous wraparound — no zero-padding, no skipped bytes, so
    MP2/superframe byte alignment survives the loop point)."""
    out = bytearray()
    while len(out) < n:
        chunk = data[pos:pos + n - len(out)]
        out += chunk
        pos = (pos + len(chunk)) % len(data)
    return bytes(out), pos


_DLPLUS_KEYS = {"title": 1, "album": 2, "artist": 4, "band": 9,
                "comment": 10, "genre": 11, "now": 33, "next": 34,
                "homepage": 39}


def _label_groups(dls: str | None, dlplus: dict | None):
    """DLS (+ DL Plus tags) config -> rotating group list, or None."""
    if dlplus and not dls:         # compose "artist - title"-style label
        dls = " - ".join(str(v) for v in dlplus.values())
    if not dls:
        return None
    from dabtools_tpu_torch.eti.pad import dls_data_groups, dlplus_command
    groups = dls_data_groups(dls, toggle=0)
    if dlplus:                     # TS 102 980 tags into the rotation
        tags = []
        for key, val in dlplus.items():
            ct = _DLPLUS_KEYS.get(str(key).lower())
            if ct is None:
                raise SystemExit(f"unknown dlplus key {key!r} "
                                 f"(use {sorted(_DLPLUS_KEYS)})")
            start = dls.find(str(val))
            if start < 0:
                raise SystemExit(f"dlplus {key}={val!r} is not a substring "
                                 f"of the dls label {dls!r}")
            tags.append((ct, start, len(str(val))))
        groups.append(dlplus_command(tags, toggle=0, item_running=True))
    return groups


class _Mp2Source:
    """Raw MP2 bytes (file or PRBS) sliced per logical frame, with an
    optional rotating X-PAD dynamic label (+ DL Plus tags)."""

    def __init__(self, frame_bytes: int, data: bytes | None, dls: str | None,
                 rng, dlplus: dict | None = None,
                 sample_rate: int = 48000):
        self.frame_bytes = frame_bytes
        self.data = data or None
        self.rng = rng
        self.sample_rate = sample_rate
        self.pos = 0
        # Half-rate (24 kHz MPEG-2 LSF) audio frames span TWO 24 ms
        # logical frames: stamp a header on even rows only.
        if sample_rate not in (48000, 24000):
            # DAB audio is 48 kHz MPEG-1 or 24 kHz MPEG-2 LSF Layer II
            # (EN 300 401 s7); any other rate would stamp headers that
            # contradict the 24 ms row cadence.
            raise SystemExit(f"sample_rate {sample_rate} not valid for "
                             f"DAB audio (use 48000 or 24000)")
        self._lsf = sample_rate == 24000
        self._row = 0
        self.groups = _label_groups(dls, dlplus)
        if self._lsf and self.groups is not None:
            # F-PAD/X-PAD sit at the tail of each AUDIO frame; LSF audio
            # frames span two logical frames, which the per-row DLS
            # attachment here doesn't model.
            raise SystemExit("dls/dlplus with sample_rate 24000 (LSF) is "
                             "not supported; use 48 kHz for labels")
        self.n = 0

    def frame(self) -> bytes:
        if self.data is not None:
            chunk, self.pos = _take_wrapped(self.data, self.pos,
                                            self.frame_bytes)
            row = bytearray(chunk)
        else:
            row = bytearray(self.rng.integers(
                0, 256, self.frame_bytes, dtype=np.uint8).tobytes())
            # Filler carries real Layer II framing (one header per 24 ms
            # frame at 48 kHz, or per 48 ms frame pair at 24 kHz LSF) so
            # downstream header checks/sniffers see a self-consistent
            # elementary stream (eti2audio --verify).
            from dabtools_tpu_torch.eti.mp2 import build_mp2_header
            if not self._lsf or self._row % 2 == 0:
                hdr = build_mp2_header(self.frame_bytes // 3,
                                       sample_rate=self.sample_rate)
                if hdr is not None:
                    row[:4] = hdr
            self._row += 1
        if self.groups is not None:
            from dabtools_tpu_torch.eti.pad import (APP_DLS_START, attach_pad_mp2,
                                              build_xpad)
            xpad, fpad = build_xpad(
                [(APP_DLS_START, self.groups[self.n % len(self.groups)])])
            attach_pad_mp2(row, xpad, fpad)
            self.n += 1
        return bytes(row)


class _DabPlusSource:
    """DAB+ superframes: file bytes pass through verbatim (already
    superframe-formatted); PRBS AUs are built via SuperframeBuilder,
    optionally carrying DLS/DL Plus as an AU-leading PAD DSE
    (TS 102 563 s5.4.3 — what eti2audio --labels decodes)."""

    def __init__(self, bitrate_kbps: int, data: bytes | None, rng,
                 dls: str | None = None, dlplus: dict | None = None):
        self.frame_bytes = bitrate_kbps * 3
        self.data = data or None
        self.pos = 0
        self.rng = rng
        self.pending: list[bytes] = []
        self.groups = _label_groups(dls, dlplus)
        if self.data is None:
            from dabtools_tpu_torch.eti.dabplus import SuperframeBuilder
            self.sb = SuperframeBuilder(bitrate_kbps)
        elif self.groups is not None:
            raise SystemExit("dls/dlplus on a dab+ service needs "
                             "source=prbs (file superframes pass through "
                             "verbatim)")
        self.n = 0

    def frame(self) -> bytes:
        if self.data is not None:
            chunk, self.pos = _take_wrapped(self.data, self.pos,
                                            self.frame_bytes)
            return chunk
        if not self.pending:
            aus = []
            for size in self.sb.au_sizes():
                head = b""
                if self.groups is not None:
                    from dabtools_tpu_torch.eti.pad import (APP_DLS_START,
                                                      build_xpad,
                                                      wrap_pad_dse)
                    xpad, fpad = build_xpad([(
                        APP_DLS_START,
                        self.groups[self.n % len(self.groups)])])
                    head = wrap_pad_dse(xpad, fpad)
                    self.n += 1
                aus.append(head + self.rng.integers(
                    0, 256, size - len(head), dtype=np.uint8).tobytes())
            self.pending = [r.tobytes() for r in self.sb.build(aus)]
        return self.pending.pop(0)


class _PacketSource:
    """MOT carousel of files over packet mode; re-queues the carousel
    whenever the encoder runs dry (continuous transmission).  With
    ``fec=True`` the stream is FEC-framed (RS(204,188), EN 300 401
    s5.3.5) and the mux signals FIG 0/14 scheme 1."""

    def __init__(self, frame_bytes: int, address: int,
                 objects: list[tuple[str, bytes]], fec: bool = False):
        from dabtools_tpu_torch.eti.mot import MotEncoder
        from dabtools_tpu_torch.eti.packet import PACKET_SIZES, PacketEncoder
        self.frame_bytes = frame_bytes
        size = max(s for s in PACKET_SIZES if s <= frame_bytes)
        self.enc = PacketEncoder(address=address, packet_size=size)
        self.mot = MotEncoder(seg_size=64)
        self.objects = objects
        self.fec = None
        if fec:
            from dabtools_tpu_torch.eti.pfec import FecEncoder
            self.fec = FecEncoder()

    def frame(self) -> bytes:
        if not self.enc.pending_bytes and self.objects:
            for dg in self.mot.carousel_groups(self.objects):
                self.enc.add_data_group(dg)
        if self.fec is None:
            return self.enc.take_frame(self.frame_bytes)
        while self.fec.pending_bytes < self.frame_bytes:
            pkt = self.enc.take_packet()
            if pkt is None:
                break                # FecEncoder pads the remainder
            self.fec.add_packet(pkt)
        return self.fec.take_frame(self.frame_bytes)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dabmux", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="mux configuration JSON file")
    p.add_argument("--cifs", type=int, default=None,
                   help="number of 24 ms CIFs to generate")
    p.add_argument("--seconds", type=float, default=None,
                   help="stream duration (alternative to --cifs)")
    p.add_argument("--output", "-o", default="-")
    p.add_argument("--tist", action="store_true",
                   help="stamp ETI frames with TIST timestamps")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I",
                   help="DAB transmission mode (sets the FIC geometry "
                        "carried per ETI frame)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")

    from dabtools_tpu_torch.eti.assemble import EtiAssembler
    from dabtools_tpu_torch.fic.config import (
        Ensemble,
        PacketComponent,
        Service,
        ServiceComponent,
        Subchannel,
    )
    from dabtools_tpu_torch.fic.fig import (build_fibs_for_ensemble, fig_0_5,
                                      fig_0_6, fig_0_9, fig_0_10, fig_0_17,
                                      fig_0_21, fig_0_24, fig_1_6)

    with open(args.config) as f:
        cfg = json.load(f)
    n_cifs = args.cifs if args.cifs is not None else int(
        (args.seconds or 2.4) / 0.024)

    rng = np.random.default_rng(int(cfg.get("seed", 0)))
    subchannels, services, pcs, sources = [], [], [], {}
    fec_schemes, meta_figs = [], []
    for svc in cfg["services"]:
        sc = svc["subch"]
        prot = _parse_protection(sc["protection"])
        if "table_index" in prot:
            sub = Subchannel.uep(sc["id"], sc["start_cu"],
                                 prot["table_index"])
        else:
            sub = Subchannel.eep(sc["id"], sc["start_cu"], prot["level"],
                                 prot["option"], sc["bitrate"])
        subchannels.append(sub)
        sid = int(str(svc["sid"]), 0)
        kind = svc.get("type", "mp2")
        if "language" in svc:          # FIG 0/5 (TS 101 756 table 9 code)
            meta_figs.append(fig_0_5(sub.subchid, int(svc["language"])))
        if "also_in_ensembles" in svc:   # FIG 0/24 (service following)
            eids = tuple(int(str(e), 0) for e in svc["also_in_ensembles"])
            per_fig = 11 if sid > 0xFFFF else 12   # 29-byte body cap
            for i in range(0, len(eids), per_fig):   # parser merges
                meta_figs.append(
                    fig_0_24(sid, eids[i:i + per_fig], oe=False))
        if "pty" in svc:               # FIG 0/17 (table 12 int. code)
            if sid > 0xFFFF:
                raise SystemExit(
                    f"service {svc['sid']}: \"pty\" applies to programme "
                    f"services (16-bit SIds) only — FIG 0/17 cannot carry "
                    f"a 32-bit data-service SId")
            meta_figs.append(fig_0_17(sid, int(svc["pty"])))
        if "xpad_label" in svc:        # FIG 1/6 label for the DLS X-PAD
            meta_figs.append(fig_1_6(sid, 2, str(svc["xpad_label"]),
                                     pd=sid > 0xFFFF))
        comp_label = str(svc.get("component_label", ""))   # FIG 1/4
        src = svc.get("source", "prbs")
        data = None if src == "prbs" else open(src, "rb").read()
        if kind == "packet":
            if data is not None:
                raise SystemExit(
                    f"service {svc['sid']}: packet services transmit an "
                    f"MOT carousel built from 'objects'; a raw 'source' "
                    f"file is not supported")
            scid = int(svc.get("scid", len(pcs) + 1))
            address = int(svc.get("address", len(pcs) + 1))
            apptype = int(svc.get("apptype", 7))   # TS 101 756: 7 = EPG
            pcs.append(PacketComponent(scid=scid, subchid=sub.subchid,
                                       address=address))
            services.append(Service(
                sid=sid, label=svc.get("label", ""),
                components=(ServiceComponent(tmid=3, subchid=-1, scid=scid,
                                             user_apps=(apptype,),
                                             label=comp_label),)))
            objs = [(name.rsplit("/", 1)[-1], open(name, "rb").read())
                    for name in svc.get("objects", [])]
            fec = bool(svc.get("fec", False))
            if fec:
                fec_schemes.append((sub.subchid, 1))   # FIG 0/14 scheme 1
            sources[sub.subchid] = _PacketSource(sub.data_bytes, address,
                                                 objs, fec=fec)
        elif kind == "dab+":
            services.append(Service(
                sid=sid, label=svc.get("label", ""),
                components=(ServiceComponent(tmid=0, subchid=sub.subchid,
                                             ascty=63,
                                             label=comp_label),)))
            sources[sub.subchid] = _DabPlusSource(sub.bitrate_kbps, data,
                                                  rng, dls=svc.get("dls"),
                                                  dlplus=svc.get("dlplus"))
        else:
            services.append(Service(
                sid=sid, label=svc.get("label", ""),
                components=(ServiceComponent(tmid=0, subchid=sub.subchid,
                                             ascty=0,
                                             label=comp_label),)))
            sources[sub.subchid] = _Mp2Source(
                sub.data_bytes, data, svc.get("dls"), rng,
                dlplus=svc.get("dlplus"),
                sample_rate=int(svc.get("sample_rate", 48000)))

    # Ensemble-level service following: FIG 0/21 alternative frequencies
    # and FIG 0/6 linkage sets.
    for fi in cfg.get("frequency_info", ()):
        meta_figs.append(fig_0_21(
            int(str(fi["id"]), 0), tuple(int(f) for f in fi["frequencies_hz"]),
            rm=int(fi.get("rm", 0)), region=int(fi.get("region", 0))))
    for ls in cfg.get("linkage", ()):
        meta_figs.append(fig_0_6(
            int(str(ls["lsn"]), 0),
            tuple(int(str(i), 0) for i in ls.get("ids", ())),
            idlq=int(ls.get("idlq", 0)), active=bool(ls.get("active", True)),
            hard=bool(ls.get("hard", True))))

    ens = Ensemble(eid=int(str(cfg.get("eid", "0xC0FE")), 0),
                   label=cfg.get("label", ""),
                   subchannels=tuple(subchannels),
                   services=tuple(services),
                   packet_components=tuple(pcs),
                   fec_schemes=tuple(fec_schemes))
    from dabtools_tpu_torch import constants as C
    mode = C.MODES[args.mode]
    fibs_per_cif = mode.n_fibs // mode.n_cifs
    asm = EtiAssembler(ens, mode=mode,
                       tist_start=0.0 if args.tist else None)
    out = sys.stdout.buffer if args.output == "-" else open(args.output,
                                                            "wb")
    extra: tuple = tuple(meta_figs)
    if cfg.get("time"):
        import datetime
        extra += (fig_0_9(int(cfg.get("lto_half_hours", 0)),
                          int(str(cfg.get("ecc", "0xE1")), 0)),)
        base_time = datetime.datetime(2026, 1, 1)

    last_t, fibs_frame = -1, None
    for n in range(n_cifs):
        t, c = divmod(n, mode.n_cifs)
        if t != last_t:              # FIBs built once per transmission frame
            cc = int(cfg.get("config_count", 1))
            if cfg.get("time"):
                import datetime
                figs = extra + (fig_0_10(
                    base_time + datetime.timedelta(milliseconds=24 * n)),)
                fibs_frame = build_fibs_for_ensemble(
                    ens, t, n_fibs=mode.n_fibs, extra_figs=figs,
                    config_count=cc)
            else:
                fibs_frame = build_fibs_for_ensemble(
                    ens, t, n_fibs=mode.n_fibs, extra_figs=extra,
                    config_count=cc)
            last_t = t
        fibs = [f.tobytes() for f in
                fibs_frame[fibs_per_cif * c: fibs_per_cif * (c + 1)]]
        out.write(asm.frame(
            fibs, {sc: src.frame() for sc, src in sources.items()}))
    out.flush()
    if args.output != "-":
        out.close()
    log.info("wrote %d ETI frames (%.2f s), ensemble 0x%04X %r, "
             "%d services", n_cifs, n_cifs * 0.024, ens.eid, ens.label,
             len(services))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``eti2audio``: ETI(NI) in, audio elementary stream out.

Superset of the reference's `eti2mpa` (`upstream:eti2mpa.c`): parses the
FIC carried inside the ETI to find the requested service/sub-channel and
its audio type, then emits either the MP2 elementary stream (DAB) or the
AAC access units (DAB+, raw or ADTS-wrapped, via the RS(120,110)
superframe decoder).  A packet-mode data service (FIG 0/3) emits its
reassembled MSC data groups instead, with optional MOT object decoding
(``--objects DIR``).

Frames are processed in ONE streaming pass (like the reference): only
the frames seen before the MCI resolves the target are buffered, so a
multi-hour stdin stream runs in constant memory.

Usage:
  python -m dabtools_tpu.cli.eti2audio --sid 0x1234 in.eti > audio.mp2
  python -m dabtools_tpu.cli.eti2audio --subch 2 --adts in.eti > out.aac
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("dabtools_tpu.eti2audio")

# Frames buffered while waiting for the MCI (~98 s of stream) before
# giving up; the reference would simply never emit in that case too.
MAX_PENDING_FRAMES = 4096


def safe_mot_filename(name: str | None, transport_id: int) -> str:
    """Sanitize a broadcast-supplied MOT ContentName for local writing.

    The name is untrusted over-the-air data: strip directory components
    and leading dots so it can neither escape the output directory nor
    hide/collide with special files (ADVICE r1).
    """
    name = (name or "").replace("\\", "/")
    name = os.path.basename(name).lstrip(".").strip()
    return name or f"slide_{transport_id}"


def _app_name(a: int) -> str:
    """TS 101 756 user application type -> short display name."""
    return {2: "SLS", 7: "EPG"}.get(a, f"uapp{a}")


def _write_mot_object(outdir, written: dict, obj) -> bool:
    """Write a completed MOT object unless an identical body for that
    name is already on disk (carousel repetitions re-complete objects);
    returns True when written.  Bounded memory: one digest per name."""
    import hashlib
    import pathlib
    name = safe_mot_filename(obj.name, obj.transport_id)
    digest = hashlib.sha256(obj.body).hexdigest()
    if written.get(name) == digest:
        return False
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / name).write_bytes(obj.body)
    written[name] = digest
    log.info("MOT object: %s (%d bytes, type %d/%d)", outdir / name,
             len(obj.body), obj.content_type, obj.subtype)
    return True


def _safe_label(label: str, sid: int) -> str:
    import re
    s = re.sub(r"[^A-Za-z0-9._-]+", "_", (label or "").strip()).strip("_.")
    return f"0x{sid:X}" + (f"_{s}" if s else "")


def _write_stats(args, rec: dict) -> None:
    """``--stats-json``: one machine-readable summary per run, written on
    every exit path (including errors, with an ``error`` key) so
    automation never reads a stale file."""
    if not args.stats_json:
        return
    import json
    with open(args.stats_json, "w") as sf:
        json.dump(rec, sf, indent=1)
    log.info("stats written to %s", args.stats_json)


from dabtools_tpu_torch.eti.edi import iter_eti_chunks as _iter_eti_chunks  # noqa: E402


def _extract_all(args, f, parser, fig) -> int:
    """One-pass whole-mux extraction (``--all DIR``): every audio service
    to its own elementary-stream file, every packet data service's MOT
    objects to a per-service directory.  The reference needs one
    `eti2mpa` process per service; this is the single-pass equivalent."""
    import pathlib

    from dabtools_tpu_torch.eti.dabplus import SuperframeDecoder, adts_wrap
    from dabtools_tpu_torch.eti.pfec import FecDecoder

    outdir = pathlib.Path(args.all)
    outdir.mkdir(parents=True, exist_ok=True)
    sinks: dict[int, dict] = {}
    # Bounded replay history: a sink created LATE (FIG 0/3 or a rotated
    # FIG 0/2 group arriving after the first sinks) still gets the
    # stream from the beginning, not from its creation point.
    history: list = []
    trimmed = False
    n_frames = 0

    def ensure_sinks(force: bool = False) -> list[int]:
        """Create sinks for newly-resolvable services; returns their sids."""
        ens = fig.ensemble()
        if ens is None:
            return []
        # Filenames carry the service labels, which rotate in at a lower
        # FIG rate than the MCI: hold off until every service is labeled
        # (or ~1.5 s / EOF) — the replay history makes the wait lossless.
        if (not sinks and not force and n_frames < 16
                and not all(s.label for s in ens.services)):
            return []
        new: list[int] = []
        for svc in ens.services:
            if svc.sid in sinks:
                continue
            comp = next((c for c in svc.components if c.primary), None)
            if comp is None:
                continue
            if comp.tmid == 3:
                try:
                    pc = ens.packet_component(comp.scid)
                except KeyError:
                    continue         # FIG 0/3 may still arrive
                from dabtools_tpu_torch.eti.mot import MotDecoder
                from dabtools_tpu_torch.eti.packet import PacketDecoder
                from dabtools_tpu_torch.eti.pfec import FecDecoder
                fec = ens.fec_scheme(pc.subchid) == 1    # FIG 0/14
                sinks[svc.sid] = {
                    "kind": "packet", "subchid": pc.subchid,
                    "address": pc.address,
                    "pkt": FecDecoder() if fec else PacketDecoder(),
                    "mot": MotDecoder(), "written": {}, "count": 0,
                    "dir": outdir
                           / f"{_safe_label(svc.label, svc.sid)}_objects"}
            elif comp.tmid == 0:
                ext = "aac" if comp.is_dabplus else "mp2"
                path = outdir / f"{_safe_label(svc.label, svc.sid)}.{ext}"
                check = None
                if args.verify and not comp.is_dabplus:
                    from dabtools_tpu_torch.eti.mp2 import Mp2HealthChecker
                    check = Mp2HealthChecker()
                sinks[svc.sid] = {
                    "kind": "dab+" if comp.is_dabplus else "mp2",
                    "subchid": comp.subchid, "out": open(path, "wb"),
                    "path": path, "dec": None, "count": 0, "check": check}
            else:
                continue
            new.append(svc.sid)
            if trimmed:
                log.warning("service 0x%X resolved after the replay "
                            "history overflowed; its prefix is lost",
                            svc.sid)
            log.info("service 0x%X %r -> %s", svc.sid, svc.label,
                     sinks[svc.sid].get("path")
                     or sinks[svc.sid].get("dir"))
        return new

    def feed_one(s: dict, frame) -> None:
        if s["subchid"] not in frame.streams:
            return
        d = frame.subchannel_data(s["subchid"])
        if s["kind"] == "mp2":
            s["out"].write(d)
            s["count"] += len(d)
            if s.get("check") is not None:
                s["check"].feed(d)
        elif s["kind"] == "dab+":
            if s["dec"] is None:
                s["dec"] = SuperframeDecoder(len(d) // 3)
            for au in s["dec"].feed(d):
                if not au.crc_ok:
                    continue
                s["out"].write(adts_wrap(au.data, s["dec"].config)
                               if args.adts else au.data)
                s["count"] += 1
        else:                        # packet-mode data service
            for addr, dg in s["pkt"].feed(d):
                if addr != s["address"]:
                    continue
                for obj in s["mot"].feed_data_group(dg):
                    s["count"] += _write_mot_object(s["dir"], s["written"],
                                                    obj)

    def ensure_fec(s) -> None:
        """FIG 0/14 arriving after the sink was created: swap in the FEC
        decoder and replay history through it (MOT writes are deduped,
        so the replay is idempotent)."""
        if (s["kind"] == "packet"
                and fig.fec_schemes.get(s["subchid"], 0) == 1
                and not isinstance(s["pkt"], FecDecoder)):
            log.info("sub-channel %d: FIG 0/14 arrived late; switching "
                     "to the FEC decoder", s["subchid"])
            s["pkt"] = FecDecoder()
            for fr in history:
                feed_one(s, fr)

    for chunk in _iter_eti_chunks(f, parser.mode):
        for frame in parser.feed(chunk):
            n_frames += 1
            for i in range(0, len(frame.fic), 32):
                fig.feed_fib(frame.fic[i:i + 32])
            for sid in ensure_sinks():
                for fr in history:   # late sink: replay from the start
                    feed_one(sinks[sid], fr)
            for s in sinks.values():
                ensure_fec(s)
                feed_one(s, frame)
            history.append(frame)
            if len(history) > MAX_PENDING_FRAMES:
                history.pop(0)
                trimmed = True

    if not n_frames:
        log.error("no ETI frames found")
        _write_stats(args, {"frames": 0, "error": "no ETI frames found"})
        return 1
    if not sinks:                    # short stream: create sinks at EOF
        for sid in ensure_sinks(force=True):
            for fr in history:
                feed_one(sinks[sid], fr)
    if not sinks:
        log.error("no MCI decoded from FIC; nothing extracted")
        _write_stats(args, {"frames": n_frames,
                            "error": "no MCI decoded from FIC"})
        return 1
    svc_stats: dict[str, dict] = {}
    for sid, s in sinks.items():
        if s["kind"] == "mp2":
            log.info("0x%X: %d MP2 bytes -> %s", sid, s["count"], s["path"])
            s["out"].close()
        elif s["kind"] == "dab+":
            log.info("0x%X: %d AAC AUs -> %s", sid, s["count"], s["path"])
            s["out"].close()
        else:
            log.info("0x%X: %d MOT objects -> %s (packet stats=%s)",
                     sid, s["count"], s["dir"], s["pkt"].stats)
        svc_stats[f"0x{sid:X}"] = {"kind": s["kind"], "count": s["count"]}
        if s["kind"] == "packet":
            svc_stats[f"0x{sid:X}"]["packet"] = s["pkt"].stats
        if s.get("check") is not None and s["check"].stats["frames"]:
            log.info("0x%X: MP2 health: %s", sid, s["check"].summary())
            svc_stats[f"0x{sid:X}"]["mp2_health"] = s["check"].stats
    _write_stats(args, {"frames": n_frames, "services": svc_stats})
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eti2audio", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="ETI(NI) file, or '-' for stdin")
    sel = p.add_mutually_exclusive_group()
    sel.add_argument("--sid", type=lambda s: int(s, 0),
                     help="service id (hex ok); default: first audio service")
    sel.add_argument("--subch", type=int, help="sub-channel id")
    sel.add_argument("--all", metavar="DIR", default=None,
                     help="extract EVERY service in one pass: audio to "
                          "DIR/<sid>_<label>.mp2/.aac, packet services' "
                          "MOT objects to DIR/<sid>_objects/")
    p.add_argument("--list", action="store_true",
                   help="list the ensemble's services and exit")
    p.add_argument("--adts", action="store_true",
                   help="wrap DAB+ AAC AUs in ADTS headers")
    p.add_argument("--dabplus", action="store_true",
                   help="force DAB+ decoding even without FIG 0/2 info")
    p.add_argument("--labels", action="store_true",
                   help="decode PAD dynamic labels (DLS) to stderr")
    p.add_argument("--slides", metavar="DIR", default=None,
                   help="decode MOT slideshow images from PAD into DIR")
    p.add_argument("--objects", metavar="DIR", default=None,
                   help="packet-mode service: decode MOT objects into DIR")
    p.add_argument("--verify", action="store_true",
                   help="report elementary-stream health: MP2 header "
                        "cadence/consistency (syncword every frame, CBR, "
                        "DAB-legal rate) or DAB+ AU-CRC/RS summary")
    p.add_argument("--follow-announcements", action="store_true",
                   help="switch to the announcement sub-channel while the "
                        "service's cluster signals one (FIG 0/18, 0/19)")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I",
                   help="DAB transmission mode of the ETI source")
    p.add_argument("--output", "-o", default="-")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write a machine-readable JSON summary of the "
                        "decode (frame/AU/data-group/RS/DLS counters)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")

    from dabtools_tpu_torch.eti.parse import EtiParser
    from dabtools_tpu_torch.fic.fig import FigParser

    f = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")

    from dabtools_tpu_torch import constants as C
    parser = EtiParser(mode=C.MODES[args.mode])
    fig = FigParser()

    if args.all is not None:
        rc = _extract_all(args, f, parser, fig)
        if args.input != "-":
            f.close()
        return rc

    out = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")

    if args.list:
        # FIC-only scan: no frame retention at all.
        n_frames = 0
        for chunk in _iter_eti_chunks(f, parser.mode):
            for frame in parser.feed(chunk):
                n_frames += 1
                for i in range(0, len(frame.fic), 32):
                    fig.feed_fib(frame.fic[i:i + 32])
        if args.input != "-":
            f.close()
        if not n_frames:
            log.error("no ETI frames found")
            _write_stats(args, {"frames": 0, "error": "no ETI frames found"})
            return 1
        ens = fig.ensemble()
        if ens is None:
            print("no MCI decoded")
            _write_stats(args, {"frames": n_frames,
                                "error": "no MCI decoded"})
            return 1
        _write_stats(args, {
            "frames": n_frames, "ensemble": f"0x{ens.eid:04X}",
            "label": ens.label,
            "services": [f"0x{s.sid:X}" for s in ens.services]})
        print(f"ensemble 0x{ens.eid:04X} {ens.label!r}")
        if fig.ecc is not None:
            print(f"  ECC 0x{fig.ecc:02X}  LTO "
                  f"{fig.lto_half_hours * 30:+d} min  "
                  f"(table {fig.intl_table})")
        if fig.utc is not None:
            print(f"  ensemble time {fig.utc.isoformat(sep=' ')} UTC "
                  f"(FIG 0/10)")
        for svc in ens.services:
            for c in svc.components:
                if c.tmid == 3:          # packet data service (FIG 0/3)
                    try:
                        pc = ens.packet_component(c.scid)
                        where = (f"subch {pc.subchid:2d}  addr 0x{pc.address:03X}"
                                 f"  DSCTy {pc.dscty}")
                        sub = pc.subchid
                    except KeyError:
                        where = f"SCId {c.scid} (FIG 0/3 pending)"
                        sub = -1
                    apps = "".join(f" +{_app_name(a)}"
                                   for a in c.user_apps)
                    if ens.fec_scheme(sub) == 1:     # FIG 0/14
                        apps += " +FEC"
                    lang = fig.languages.get(
                        ("subch", sub), fig.languages.get(("scid", c.scid)))
                    if lang is not None:             # FIG 0/5
                        from dabtools_tpu_torch.tables.meta import language_name
                        apps += f" [{language_name(lang)}]"
                    print(f"  0x{svc.sid:08X} {svc.label or '':16s} {where}  "
                          f"packet{apps}")
                    continue
                try:
                    rate = f"{ens.subchannel(c.subchid).bitrate_kbps:3d} kbit/s"
                except KeyError:
                    rate = "(unsignalled)"
                apps = "".join(f" +{_app_name(a)}" for a in c.user_apps)
                ann = fig.announce_support.get(svc.sid)
                if ann is not None:
                    apps += (f" +ann(0x{ann[0]:04X} clusters "
                             f"{','.join(map(str, ann[1]))})")
                from dabtools_tpu_torch.tables.meta import (language_name,
                                                      programme_type_name)
                lang = fig.languages.get(("subch", c.subchid))
                if lang is not None:          # FIG 0/5
                    apps += f" [{language_name(lang)}]"
                pty = fig.ptys.get(svc.sid)
                if pty is not None:           # FIG 0/17
                    apps += f" [{programme_type_name(pty[0])}]"
                print(f"  0x{svc.sid:04X} {svc.label or '':16s} subch "
                      f"{c.subchid:2d}  {rate}  "
                      f"{'DAB+' if c.is_dabplus else 'MP2'}{apps}")
        return 0

    def try_resolve(final: bool) -> tuple[int, bool, int | None] | None:
        """(subchid, is_dabplus, packet_address|None), or None if not
        determinable (yet).

        ``final``: end of stream — report errors instead of waiting.
        """
        ens = fig.ensemble()
        if args.subch is not None:
            if args.dabplus:         # explicit type: no MCI needed at all
                return args.subch, True, None
            # Audio-type sniff from FIG 0/2: resolve the moment any
            # component references this sub-channel (FIG 0/1 alone makes
            # ensemble() non-None while services are still pending, and
            # big muxes rotate FIG 0/2 across frames); without MCI,
            # default to MP2 after a bounded ~1.5 s instead of buffering
            # the whole stream.
            if ens is not None:
                for svc in ens.services:
                    for c in svc.components:
                        if c.subchid == args.subch:
                            return args.subch, c.is_dabplus, None
            if final or stats["frames"] >= 64:
                return args.subch, False, None
            return None
        if ens is None:
            if final:
                log.error("no MCI in the ETI FIC; use --subch")
            return None
        services = [s for s in ens.services
                    if any(c.tmid == 0 for c in s.components)] or ens.services
        if args.sid is not None:
            matches = [s for s in ens.services if s.sid == args.sid]
            if not matches:
                if final:
                    log.error("service 0x%04X not found; have %s", args.sid,
                              [hex(s.sid) for s in ens.services])
                return None          # the service's FIG 0/2 may be pending
            svc = matches[0]
        elif services:
            svc = services[0]
        else:
            if final:
                log.error("no services signalled; use --subch")
            return None
        comp = next(c for c in svc.components if c.primary)
        resolved_sid[0] = svc.sid
        if comp.tmid == 3:           # packet-mode data service
            try:
                pc = ens.packet_component(comp.scid)
            except KeyError:
                if final:
                    log.error("no FIG 0/3 for SCId %d", comp.scid)
                return None          # FIG 0/3 may still arrive
            log.info("service 0x%08X %r -> packet sub-channel %d "
                     "address 0x%03X (DSCTy %d)", svc.sid, svc.label,
                     pc.subchid, pc.address, pc.dscty)
            return pc.subchid, False, pc.address
        log.info("service 0x%04X %r -> sub-channel %d (%s)", svc.sid,
                 svc.label, comp.subchid,
                 "DAB+" if (args.dabplus or comp.is_dabplus) else "DAB/MP2")
        return comp.subchid, args.dabplus or comp.is_dabplus, None

    pad = None
    if args.labels or args.slides:
        from dabtools_tpu_torch.eti.pad import PadDecoder
        pad = PadDecoder(mot=args.slides is not None)

    mp2check = None
    if args.verify:
        from dabtools_tpu_torch.eti.mp2 import Mp2HealthChecker
        mp2check = Mp2HealthChecker()

    def show(labels):
        for lab in labels:
            log.info("dynamic label: %r (charset %d)", lab.text, lab.charset)
        if pad is None:
            return
        for info in pad.take_dlplus():      # TS 102 980 DL Plus tags
            from dabtools_tpu_torch.tables.meta import dlplus_type_name
            tags = ", ".join(f"{dlplus_type_name(t.content_type)}={t.text!r}"
                             for t in info.tags)
            log.info("DL+%s: %s",
                     " (item running)" if info.item_running else "", tags)

    # Streaming state, filled once the target resolves.
    target: tuple[int, bool, int | None] | None = None
    resolved_sid: list = [None]      # service id behind `target`, if any
    ann_current: list = [None]       # announcement sub-channel in effect
    decs: dict = {}                  # DAB+ SuperframeDecoder per subchid
    pkt = None                       # packet-mode PacketDecoder
    mot = None                       # packet-mode MotDecoder
    mot_written: dict = {}           # name -> body hash already on disk
    stats = {"frames": 0, "with_sub": 0, "mp2_bytes": 0, "aus": 0,
             "aus_bad": 0, "data_groups": 0, "switches": 0, "objects": 0}

    def write_mot_objects(objs) -> None:
        """Write completed MOT objects AS THEY ARRIVE (a live stream has
        no EOF) and dedupe carousel repetitions (header-mode objects
        re-complete every cycle) so memory and disk stay bounded."""
        for obj in objs:
            stats["objects"] += _write_mot_object(args.objects, mot_written,
                                                  obj)

    def subch_is_dabplus(subchid: int) -> bool:
        ens = fig.ensemble()
        return ens is not None and any(
            c.subchid == subchid and c.is_dabplus
            for svc in ens.services for c in svc.components)

    def sink(frame) -> None:
        subchid, is_dabplus, pkt_addr = target
        if (args.follow_announcements and pkt_addr is None
                and resolved_sid[0] is not None):
            ann = fig.announcement_for(resolved_sid[0])
            asub = ann[1] if ann is not None else None
            if (asub is not None and asub != subchid
                    and asub in frame.streams):
                if ann_current[0] != asub:
                    log.info("announcement active: switching to "
                             "sub-channel %d (ASw 0x%04X)", asub, ann[0])
                    stats["switches"] += 1
                    ann_current[0] = asub
                subchid, is_dabplus = asub, subch_is_dabplus(asub)
            elif asub is None and ann_current[0] is not None:
                log.info("announcement ended: back to sub-channel %d",
                         subchid)
                ann_current[0] = None
        if subchid not in frame.streams:
            return
        stats["with_sub"] += 1
        d = frame.subchannel_data(subchid)
        if pkt_addr is not None:
            nonlocal pkt, mot
            from dabtools_tpu_torch.eti.pfec import FecDecoder
            fec = fig.fec_schemes.get(subchid, 0) == 1       # FIG 0/14
            if pkt is None or (fec and not isinstance(pkt, FecDecoder)):
                from dabtools_tpu_torch.eti.mot import MotDecoder
                from dabtools_tpu_torch.eti.packet import PacketDecoder
                if pkt is not None:
                    # FIG 0/14 arrived after the first MSC frame: a plain
                    # PacketDecoder on a FEC stream slips on every FEC
                    # packet; the FecDecoder re-syncs mid-stream.
                    log.info("sub-channel %d: FIG 0/14 arrived late; "
                             "switching to the FEC decoder", subchid)
                pkt = FecDecoder() if fec else PacketDecoder()
                if mot is None:
                    mot = MotDecoder()
                if fec:
                    log.info("sub-channel %d: packet-mode FEC "
                             "(RS(204,188), FIG 0/14 scheme 1)", subchid)
            for addr, dg in pkt.feed(d):
                if addr != pkt_addr:
                    continue
                stats["data_groups"] += 1
                out.write(dg)        # concatenated MSC data groups
                if args.objects is not None:
                    write_mot_objects(mot.feed_data_group(dg))
            return
        if not is_dabplus:
            out.write(d)
            stats["mp2_bytes"] += len(d)
            if mp2check is not None:
                mp2check.feed(d)
            if pad is not None:
                show(pad.feed_mp2_frame(d))
            return
        from dabtools_tpu_torch.eti.dabplus import SuperframeDecoder, adts_wrap
        dec = decs.get(subchid)
        if dec is None:
            dec = decs[subchid] = SuperframeDecoder(len(d) // 3)
        for au in dec.feed(d):
            if not au.crc_ok:
                stats["aus_bad"] += 1
                continue
            stats["aus"] += 1
            if pad is not None:
                show(pad.feed_dabplus_au(au.data))
            out.write(adts_wrap(au.data, dec.config) if args.adts else au.data)

    pending: list = []
    overflowed = False
    for chunk in _iter_eti_chunks(f, parser.mode):
        for frame in parser.feed(chunk):
            stats["frames"] += 1
            for i in range(0, len(frame.fic), 32):
                fig.feed_fib(frame.fic[i:i + 32])
            if target is None:
                target = try_resolve(final=False)
                if target is not None:
                    for fr in pending:
                        sink(fr)
                    pending.clear()
            if target is not None:
                sink(frame)
            else:
                pending.append(frame)
                if len(pending) > MAX_PENDING_FRAMES:
                    pending.pop(0)   # constant memory on endless no-MCI input
                    overflowed = True
    if args.input != "-":
        f.close()
    if not stats["frames"]:
        log.error("no ETI frames found")
        _write_stats(args, dict(stats, error="no ETI frames found"))
        return 1
    if target is None:
        target = try_resolve(final=True)
        if target is None:
            _write_stats(args, dict(stats, error="target not resolved"))
            return 1
        if overflowed:
            log.warning("target resolved only at EOF after >%d frames; "
                        "earliest frames were dropped", MAX_PENDING_FRAMES)
        for fr in pending:
            sink(fr)
        pending.clear()

    if not stats["with_sub"]:
        log.error("sub-channel %d not present in ETI", target[0])
        _write_stats(args, dict(
            stats, error=f"sub-channel {target[0]} not present in ETI"))
        return 1
    if target[2] is not None:
        if args.objects is not None and mot is not None:
            write_mot_objects(mot.flush())
        log.info("wrote %d MSC data groups, %d MOT objects; "
                 "packet stats=%s", stats["data_groups"], stats["objects"],
                 pkt.stats if pkt else {})
    elif not target[1]:
        log.info("wrote %d bytes MP2 from %d frames",
                 stats["mp2_bytes"], stats["with_sub"])
        if mp2check is not None:
            log.info("MP2 health: %s", mp2check.summary())
    else:
        log.info("wrote %d AAC AUs (%d failed CRC); stats=%s",
                 stats["aus"], stats["aus_bad"],
                 {sc: d.stats for sc, d in decs.items()})
        if mp2check is not None:
            bad, tot = stats["aus_bad"], stats["aus"] + stats["aus_bad"]
            rsf = sum(d.stats["rs_failures"] for d in decs.values())
            log.info("DAB+ health: %d/%d AUs pass CRC, %d RS failures%s",
                     tot - bad, tot, rsf,
                     " [healthy]" if not bad and not rsf else "")
    if args.follow_announcements and stats["switches"]:
        log.info("announcement switches: %d", stats["switches"])
    if pad is not None:
        pad.flush()
        if args.labels:
            log.info("DLS stats: %s", pad.dls.stats)
        if args.slides is not None:
            import pathlib
            outdir = pathlib.Path(args.slides)
            outdir.mkdir(parents=True, exist_ok=True)
            for i, obj in enumerate(pad.objects):
                name = safe_mot_filename(obj.name, obj.transport_id)
                path = outdir / f"{i:03d}_{name}"
                path.write_bytes(obj.body)
                log.info("MOT object: %s (%d bytes, type %d/%d)",
                         path, len(obj.body), obj.content_type, obj.subtype)
            log.info("MOT stats: %s", pad.mot.stats)
    out.flush()
    if args.output != "-":
        out.close()
    rec = dict(stats)
    if mp2check is not None and mp2check.stats["frames"]:
        rec["mp2_health"] = mp2check.stats
    if pkt is not None:
        rec["packet"] = pkt.stats
    if decs:
        rec["dabplus"] = {sc: d.stats for sc, d in decs.items()}
    if pad is not None:
        rec["dls"] = pad.dls.stats
    _write_stats(args, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())

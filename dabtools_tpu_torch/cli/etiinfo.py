"""``etiinfo``: inspect an ETI(NI) stream (etisnoop-style summary).

Prints per-stream layout, FIC-derived ensemble info, CRC/continuity
health.  Useful for validating interop artifacts (SURVEY.md s4 item 3).

Usage: python -m dabtools_tpu.cli.etiinfo mux.eti [--frames N] [--verbose]
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter

from dabtools_tpu_torch.eti.parse import EtiParser
from dabtools_tpu_torch.fic.fig import FigParser
from dabtools_tpu_torch.utils.crc import crc16_ok


def _sniff_payload(frames: list[bytes] | None, subch) -> str:
    """Detect the codec actually riding a sub-channel from its first
    frames and cross-check against the FIC-signalled capacity: MP2 by
    per-frame Layer II headers, DAB+ by achieving superframe sync
    (firecode + RS).  Empty string when nothing is recognizable (e.g.
    packet data) — the signalled info stands alone then."""
    if not frames:
        return ""
    from dabtools_tpu_torch.eti.mp2 import parse_mp2_header
    ok = [h for h in (parse_mp2_header(b) for b in frames)
          if h is not None]
    # Full-rate (48 kHz MPEG-1) audio has a header on EVERY 24 ms logical
    # frame; half-rate (24 kHz MPEG-2 LSF) frames span TWO logical frames
    # so only ~half carry one.  Thresholds per family, version-majority.
    lsf = ok and sum(h.version == 2 for h in ok) > len(ok) // 2
    need = int((0.4 if lsf else 0.8) * len(frames))
    if len(ok) >= max(2, need):
        h = ok[-1]
        # an MP2 frame must fill exactly 1 (full-rate) or 2 (LSF) logical
        # frames; a parseable header at the wrong rate/cadence is a
        # mux-configuration bug
        span = 2 if h.version == 2 else 1
        note = ("" if h.bitrate_kbps == subch.bitrate_kbps
                and h.frame_bytes == span * len(frames[-1])
                else f" [MISMATCH vs signalled {subch.bitrate_kbps}]")
        return (f" — payload: MP2 {h.bitrate_kbps} kbit/s "
                f"{h.sample_rate // 1000} kHz {h.mode}"
                f"{' LSF' if h.version == 2 else ''}{note}")
    try:
        from dabtools_tpu_torch.eti.dabplus import SuperframeDecoder
        dec = SuperframeDecoder(len(frames[0]) // 3)
        aus = []
        for b in frames:
            aus += dec.feed(b)
        if dec.stats["superframes"]:
            good = sum(a.crc_ok for a in aus)
            return (f" — payload: DAB+ superframes "
                    f"({good}/{len(aus)} AU CRCs pass)")
    except Exception:  # noqa: BLE001 — sniffing must never break etiinfo
        pass
    return ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="etiinfo", description=__doc__)
    p.add_argument("input", help="ETI file, or '-' for stdin")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="per-frame lines")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I",
                   help="DAB transmission mode of the ETI source")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (one JSON object): "
                        "transport health + full ensemble configuration "
                        "+ per-sub-channel payload sniff")
    args = p.parse_args(argv)

    f = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    from dabtools_tpu_torch import constants as C
    parser = EtiParser(mode=C.MODES[args.mode])
    fig = FigParser()
    n = 0
    err_counter: Counter = Counter()
    hdr_bad = mst_bad = fct_jumps = fib_bad = 0
    tist_seen = tist_jumps = 0
    last_fct = last_tist = None
    stream_layout = None
    SNIFF_FRAMES = 25               # payload-codec sniff window (bounded)
    sniff: dict[int, list[bytes]] = {}
    from dabtools_tpu_torch.eti.edi import iter_eti_chunks
    try:
        for chunk in iter_eti_chunks(f, parser.mode):
            for frame in parser.feed(chunk):
                n += 1
                err_counter[frame.err] += 1
                hdr_bad += not frame.header_crc_ok
                mst_bad += not frame.mst_crc_ok
                if last_fct is not None and frame.fct != (last_fct + 1) % 250:
                    fct_jumps += 1
                last_fct = frame.fct
                if frame.tist is not None:
                    from dabtools_tpu_torch.eti.assemble import (
                        TIST_TICKS_PER_FRAME, TIST_TICKS_PER_SEC)
                    tist_seen += 1
                    if last_tist is not None and frame.tist != (
                            last_tist + TIST_TICKS_PER_FRAME) % TIST_TICKS_PER_SEC:
                        tist_jumps += 1
                    last_tist = frame.tist
                for i in range(0, len(frame.fic), 32):
                    fib = frame.fic[i:i + 32]
                    if crc16_ok(fib):
                        fig.feed_fib(fib)
                    else:
                        fib_bad += 1
                if n <= SNIFF_FRAMES:
                    for sc, s in frame.streams.items():
                        sniff.setdefault(sc, []).append(s.data)
                layout = tuple(sorted(
                    (s.subchid, s.sad_words, s.stl_words, s.tpl)
                    for s in frame.streams.values()))
                if stream_layout is None:
                    stream_layout = layout
                elif layout != stream_layout:
                    print(f"frame {n}: stream layout changed")
                    stream_layout = layout
                if args.verbose:
                    print(f"frame {n - 1}: FCT={frame.fct} FP={frame.fp} "
                          f"ERR=0x{frame.err:02X} "
                          f"hdrCRC={'ok' if frame.header_crc_ok else 'BAD'} "
                          f"mstCRC={'ok' if frame.mst_crc_ok else 'BAD'}"
                          + (f" TIST={frame.tist_seconds*1e3:.3f}ms"
                             if frame.tist is not None else ""))
                if args.frames and n >= args.frames:
                    raise StopIteration
    except StopIteration:
        pass
    finally:
        if args.input != "-":
            f.close()

    if n == 0:
        if args.json:
            import json as _json
            print(_json.dumps({"frames": 0, "error": "no ETI frames found"}))
        else:
            print("no ETI frames found")
        return 1
    if args.json:
        import json as _json
        ens = fig.ensemble()
        rep = {
            "frames": n, "seconds": round(n * 0.024, 3),
            "resyncs": parser.resyncs,
            "err_bytes": {f"0x{e:02X}": c
                          for e, c in sorted(err_counter.items())},
            "header_crc_failures": hdr_bad, "mst_crc_failures": mst_bad,
            "fct_discontinuities": fct_jumps, "bad_fibs": fib_bad,
            "tist": ({"stamped": tist_seen, "discontinuities": tist_jumps}
                     if tist_seen else None),
        }
        if ens is not None:
            rep["ensemble"] = ens.to_dict()
            rep["ensemble"]["eid"] = f"0x{ens.eid:04X}"
            if fig.config_count is not None:
                rep["config_count"] = fig.config_count
                rep["services_signalled"] = fig.n_services_signalled
            if fig.ecc is not None:
                rep["ecc"] = f"0x{fig.ecc:02X}"
                rep["lto_minutes"] = fig.lto_half_hours * 30
            if fig.utc is not None:
                rep["utc"] = fig.utc.isoformat(sep=" ")
            rep["payload_sniff"] = {
                str(s.subchid):
                    _sniff_payload(sniff.get(s.subchid), s).lstrip(" —") or
                    None
                for s in ens.sorted_subchannels()}
        else:
            rep["ensemble"] = None
        print(_json.dumps(rep))
        return 0
    print(f"frames: {n} ({n * 0.024:.2f} s), resyncs: {parser.resyncs}")
    errs = ", ".join(f"0x{e:02X} x{c}" for e, c in sorted(err_counter.items()))
    print(f"ERR bytes: {errs}")
    print(f"header CRC failures: {hdr_bad}, MST CRC failures: {mst_bad}, "
          f"FCT discontinuities: {fct_jumps}, bad FIBs: {fib_bad}")
    if tist_seen:
        print(f"TIST: {tist_seen}/{n} frames stamped, "
              f"{tist_jumps} discontinuities")
    else:
        print("TIST: not in use")

    ens = fig.ensemble()
    if ens is None:
        print("no MCI decoded from FIC")
    else:
        print(f"ensemble: 0x{ens.eid:04X} {ens.label!r}")
        if fig.config_count is not None:
            note = ("" if fig.n_services_signalled == len(ens.services)
                    else f" (FIC still partial: {len(ens.services)} of "
                         f"{fig.n_services_signalled} services parsed)")
            print(f"  configuration {fig.config_count}, "
                  f"{fig.n_services_signalled} services{note}")
        if fig.ecc is not None:
            print(f"  ECC 0x{fig.ecc:02X}, LTO {fig.lto_half_hours * 30:+d}"
                  f" min, international table {fig.intl_table}")
        if fig.utc is not None:
            print(f"  time {fig.utc.isoformat(sep=' ')} UTC (FIG 0/10)")
        for s in ens.sorted_subchannels():
            print(f"  subch {s.subchid:2d}: CU {s.start_cu:3d}+{s.size_cus:<3d}"
                  f" {s.protection_type}-{s.protection_level}"
                  f"{s.eep_option if s.protection_type == 'EEP' else ''}"
                  f" {s.bitrate_kbps} kbit/s"
                  f"{_sniff_payload(sniff.get(s.subchid), s)}")
        from dabtools_tpu_torch.tables.meta import (language_name,
                                              programme_type_name)
        for svc in ens.services:
            comps = ", ".join(
                (f"SCId {c.scid} (packet)" if c.tmid == 3 else
                 f"subch {c.subchid} ({'DAB+' if c.is_dabplus else 'MP2'})")
                + (f" {c.label!r}" if c.label else "")   # FIG 1/4
                for c in svc.components)
            meta = ""
            pty = fig.ptys.get(svc.sid)
            if pty is not None:              # FIG 0/17
                meta += f", PTy {programme_type_name(pty[0])}"
            for c in svc.components:
                sub = c.subchid
                if c.tmid == 3:              # resolve via FIG 0/3
                    try:
                        sub = ens.packet_component(c.scid).subchid
                    except KeyError:
                        sub = -1
                lang = fig.languages.get(("subch", sub))
                if lang is None and c.tmid == 3:
                    lang = fig.languages.get(("scid", c.scid))
                if lang is not None:         # FIG 0/5
                    meta += f", {language_name(lang)}"
            print(f"  service 0x{svc.sid:04X} {svc.label!r}: {comps}{meta}")
        for (sid, scids, appty), lab in sorted(
                fig.xpad_labels.items()):                   # FIG 1/6
            print(f"  X-PAD app label: service 0x{sid:04X} SCIdS {scids} "
                  f"AppTy {appty}: {lab!r}")
        for pc in ens.packet_components:
            fec = (", FEC RS(204,188)"
                   if ens.fec_scheme(pc.subchid) == 1 else "")
            print(f"  packet SCId {pc.scid}: subch {pc.subchid}, "
                  f"address 0x{pc.address:03X}, DSCTy {pc.dscty}, "
                  f"{'data groups' if pc.dg else 'no data groups'}{fec}")
        for lsn, ls in sorted(fig.linkage_sets.items()):   # FIG 0/6
            kind = {0: "DAB SIds", 1: "RDS PIs"}.get(
                ls["idlq"], f"IdLQ {ls['idlq']}")
            ids = " ".join(f"0x{i:04X}" for i in ls["ids"])
            print(f"  linkage set 0x{lsn:03X}: "
                  f"{'hard' if ls['hard'] else 'soft'} "
                  f"{'active' if ls['active'] else 'inactive'}"
                  f"{' intl' if ls['international'] else ''}, "
                  f"{kind}: {ids or '(none)'}")
        for (sid, oe), eids in sorted(fig.oe_services.items()):  # FIG 0/24
            ens_list = " ".join(f"0x{e:04X}" for e in eids)
            print(f"  service 0x{sid:04X} also in ensemble(s): {ens_list}"
                  + (" (OE)" if oe else ""))
        for sid, (asu, eids) in sorted(
                fig.oe_announce_support.items()):          # FIG 0/25
            ens_list = " ".join(f"0x{e:04X}" for e in eids)
            print(f"  service 0x{sid:04X} announcements (ASu 0x{asu:04X}) "
                  f"also in: {ens_list}")
        for cluster, (asw, eid_o, cl_o, _) in sorted(
                fig.oe_announce_active.items()):           # FIG 0/26
            print(f"  announcement active in other ensemble: cluster "
                  f"{cluster} -> EId 0x{eid_o:04X} cluster {cl_o} "
                  f"(ASw 0x{asw:04X})")
        for (region, ident, rm), freqs in sorted(
                fig.freq_info.items()):                    # FIG 0/21
            what = {0: f"DAB ensemble 0x{ident:04X}",
                    8: f"FM RDS PI 0x{ident:04X}"}.get(
                rm, f"Id 0x{ident:04X} (R&M {rm})")
            mhz = " ".join(f"{f/1e6:.3f}" for f in freqs)
            print(f"  frequency info (region {region}): {what} -> "
                  f"{mhz} MHz")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``etiremux``: re-multiplex an ETI(NI) stream to a subset of its
sub-channels (the `ODR-ZMQ2EDI`-style stream-surgery role; exercises
parse -> assemble symmetry end to end).

Keeps the selected sub-channels' bytes VERBATIM (no re-decode), rebuilds
the FIC from the parsed ensemble configuration restricted to the kept
set (MCI, service/component labels, packet descriptions, FIG 0/14 FEC
signalling), and re-assembles standard 6144-byte frames.  Services whose
audio/data components all reference dropped sub-channels are dropped
with them.

Note: the output FIC is REGENERATED from configuration, so FIGs outside
the rebuilt set (e.g. date/time FIG 0/10, announcements) are not carried
over; in-PAD data (DLS, X-PAD MOT) lives inside the sub-channel bytes
and survives untouched.

Usage:
  python -m dabtools_tpu.cli.etiremux mux.eti --keep 1,5 -o small.eti
  python -m dabtools_tpu.cli.etiremux mux.eti --drop 3 -o rest.eti
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

import numpy as np

log = logging.getLogger("dabtools_tpu.etiremux")

MAX_PENDING_FRAMES = 4096            # pre-MCI buffer cap (~98 s)


def filter_ensemble(ens, keep: set[int]):
    """Project an Ensemble onto a sub-channel subset.

    A service survives if at least one of its components still resolves
    (stream components by subchid; packet components via their SCId's
    FIG 0/3 record), and keeps only its surviving components.
    """
    missing = keep - {s.subchid for s in ens.subchannels}
    if missing:
        raise ValueError(f"sub-channels not in the mux: {sorted(missing)}")
    pcs = tuple(pc for pc in ens.packet_components if pc.subchid in keep)
    live_scids = {pc.scid for pc in pcs}

    def component_lives(c) -> bool:
        if c.tmid == 3:
            return c.scid in live_scids
        return c.subchid in keep

    services = []
    for svc in ens.services:
        comps = tuple(c for c in svc.components if component_lives(c))
        if comps:
            services.append(dataclasses.replace(svc, components=comps))
    return dataclasses.replace(
        ens,
        subchannels=tuple(s for s in ens.subchannels if s.subchid in keep),
        services=tuple(services),
        packet_components=pcs,
        fec_schemes=tuple((sc, sch) for sc, sch in ens.fec_schemes
                          if sc in keep))


def _parse_ids(text: str) -> set[int]:
    try:
        return {int(t, 0) for t in text.replace(",", " ").split()}
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"bad sub-channel id list: {e}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="etiremux", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="ETI(NI) file, or '-' for stdin")
    p.add_argument("--output", "-o", default="-",
                   help="ETI output ('-' = stdout)")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--keep", type=_parse_ids, default=None,
                   help="comma/space-separated sub-channel ids to keep")
    g.add_argument("--drop", type=_parse_ids, default=None,
                   help="sub-channel ids to remove (keep the rest)")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")

    from dabtools_tpu_torch import constants as C
    from dabtools_tpu_torch.eti.assemble import EtiAssembler
    from dabtools_tpu_torch.eti.parse import EtiParser
    from dabtools_tpu_torch.fic.fig import FigParser, build_fibs_for_ensemble

    mode = C.MODES[args.mode]
    f = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    out = sys.stdout.buffer if args.output == "-" else open(args.output,
                                                            "wb")
    parser = EtiParser(mode=mode)
    fig = FigParser()
    fibs_per_cif = mode.n_fibs // mode.n_cifs
    st = {"asm": None, "ens": None, "n_in": 0, "n_out": 0, "dropped": False}
    buf: list = []

    def flush() -> None:
        if st["asm"] is None:
            full = fig.ensemble()
            if full is None:
                return
            keep = (set(args.keep) if args.keep is not None
                    else {s.subchid for s in full.subchannels} - args.drop)
            try:
                ens = filter_ensemble(full, keep)
            except ValueError as e:
                p.error(str(e))     # e.g. --keep id absent from the mux
            if not ens.subchannels:
                p.error("no sub-channels left after filtering")
            log.info("keeping %d/%d sub-channels (%s), %d/%d services",
                     len(ens.subchannels), len(full.subchannels),
                     sorted(keep), len(ens.services), len(full.services))
            st["ens"], st["asm"] = ens, EtiAssembler(ens)
        ens, asm = st["ens"], st["asm"]
        kept = [s.subchid for s in ens.subchannels]
        from dabtools_tpu_torch.eti.assemble import ERR_LADDER
        while buf:
            fr = buf.pop(0)
            n = st["n_out"]
            # One FIB-carousel build per transmission frame, not per CIF
            # (the builder returns the whole frame's n_fibs at once).
            tx = n // mode.n_cifs
            if st.get("fib_tx") != tx:
                st["fib_tx"], st["fib_frame"] = tx, build_fibs_for_ensemble(
                    ens, tx)
            fibs = [np.asarray(fb).tobytes() for fb in
                    st["fib_frame"][fibs_per_cif * (n % mode.n_cifs):
                                    fibs_per_cif * (n % mode.n_cifs)
                                    + fibs_per_cif]]
            data = {}
            for sc in kept:
                if sc in fr.streams:
                    data[sc] = fr.subchannel_data(sc)
                else:       # stream absent mid-run: pad, don't crash
                    data[sc] = bytes(ens.subchannel(sc).data_bytes)
            # Propagate the input frame's error severity (invert the
            # ERR ladder: 0xFF = error-free ... 0x00 = unusable).
            level = min((lv for lv, b in enumerate(ERR_LADDER)
                         if fr.err >= b), default=3)
            out.write(asm.frame(fibs, data, error_level=level))
            st["n_out"] += 1

    from dabtools_tpu_torch.eti.edi import iter_eti_chunks
    for data in iter_eti_chunks(f, mode):   # ETI, or EDI transcoded
        for frame in parser.feed(data):
            st["n_in"] += 1
            for i in range(0, len(frame.fic), 32):
                fig.feed_fib(frame.fic[i:i + 32])
            buf.append(frame)
            if st["asm"] is None and len(buf) > MAX_PENDING_FRAMES:
                buf.pop(0)
                st["dropped"] = True
        flush()
    flush()
    if args.input != "-":
        f.close()
    out.flush()
    if args.output != "-":
        out.close()
    if not st["n_in"]:
        log.error("no ETI frames found")
        return 1
    if st["asm"] is None:
        log.error("no MCI in the ETI FIC; cannot re-multiplex%s",
                  " (input overran the pre-MCI buffer)"
                  if st["dropped"] else "")
        return 1
    log.info("wrote %d frames (%d read)", st["n_out"], st["n_in"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``eti2iq``: ETI(NI) in, modulated baseband IQ out (a DAB test
transmitter — the `ODR-DabMod` role in the dabtools ecosystem).

Replays any ETI artifact as RF: sub-channel organization comes from the
FIC carried in the stream itself (FIG 0/1), the FIBs and MST bytes are
re-modulated verbatim with the standard-exact modulator (N17), so
``dab2eti(eti2iq(mux.eti))`` closes the loop bit-exactly.  Optional
calibrated impairments (AWGN / carrier offset / timing offset / COST 207
multipath with Rayleigh fading / SFN echoes) make it a receiver-test
signal generator.

Streaming: frames are modulated and written in 6-transmission-frame
chunks (the modulator's time-interleaver state carries across chunks and
the CFO rotation stays phase-continuous), so an hours-long replay runs
in constant memory; only the pre-MCI prefix is buffered.

Usage:
  python -m dabtools_tpu.cli.eti2iq mux.eti -o out.cf32
  python -m dabtools_tpu.cli.eti2iq --format u8 --snr 12 --cfo-hz 350 mux.eti -o out.u8
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

log = logging.getLogger("dabtools_tpu.eti2iq")

MAX_PENDING_FRAMES = 4096            # pre-MCI buffer cap (~98 s)
CHUNK_TX = 6                         # multiple of 3 for Mode III FIC spans


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eti2iq", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", help="ETI(NI) file, or '-' for stdin")
    p.add_argument("--output", "-o", default="-",
                   help="IQ output file ('-' = stdout)")
    p.add_argument("--format", choices=("cf32", "u8"), default="cf32",
                   help="complex64, or u8 offset-128 interleaved (the "
                        "RTL-SDR wire format)")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I",
                   help="DAB transmission mode to modulate")
    p.add_argument("--snr", type=float, default=None,
                   help="add AWGN at this SNR (dB)")
    p.add_argument("--cfo-hz", type=float, default=0.0,
                   help="apply a carrier frequency offset")
    p.add_argument("--timing-offset", type=int, default=0,
                   help="prepend this many zero samples")
    p.add_argument("--multipath", default=None, metavar="PROFILE",
                   help="tapped-delay-line channel: 'tu6' / 'ra4' "
                        "(COST 207), or custom 'delay_us:power_db,...' "
                        "taps")
    p.add_argument("--doppler-hz", type=float, default=0.0,
                   help="Rayleigh-fade the --multipath taps at this "
                        "max Doppler (0 = static channel)")
    p.add_argument("--echo-us", type=float, default=None,
                   help="add an SFN echo at this delay (us)")
    p.add_argument("--echo-db", type=float, default=-3.0,
                   help="SFN echo power relative to the main path (dB)")
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N transmission frames")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")

    from dabtools_tpu_torch import constants as C
    from dabtools_tpu_torch.eti.parse import EtiParser
    from dabtools_tpu_torch.fic.fig import FigParser
    from dabtools_tpu_torch.mod.impairments import (
        PROFILES,
        MultipathChannel,
        awgn,
        carrier_offset,
        quantize_u8,
    )
    from dabtools_tpu_torch.mod.modulator import Modulator, SubchannelSource

    mode = C.MODES[args.mode]
    f = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    out = sys.stdout.buffer if args.output == "-" else open(args.output,
                                                            "wb")
    parser = EtiParser(mode=mode)
    fig = FigParser()
    rng = np.random.default_rng(0)
    st = {"mod": None, "subs": None, "sample0": 0, "n_tx": 0,
          "dropped": False}
    buf: list = []

    channel = None
    taps: list = []
    if args.multipath:
        if args.multipath.lower() in PROFILES:
            taps += list(PROFILES[args.multipath.lower()])
        else:
            try:
                for t in args.multipath.split(","):
                    d, pw = t.split(":")
                    d, pw = float(d), float(pw)
                    if d < 0:
                        raise ValueError(f"negative tap delay {d}")
                    taps.append((d, pw))
            except ValueError as e:
                p.error(f"--multipath: {e}; expected 'tu6', 'ra4', or "
                        f"'delay_us:power_db,...' taps (e.g. "
                        f"'0:0,5.4:-3')")
    if args.echo_us is not None:
        # An SFN echo is just a 2nd transmitter: main path at 0 dB plus
        # the delayed tap (composable with a --multipath profile).
        if args.echo_us < 0:
            p.error("--echo-us must be >= 0")
        if not taps:
            taps.append((0.0, 0.0))
        taps.append((float(args.echo_us), float(args.echo_db)))
    if not taps:
        # Fading/echo qualifiers without a channel would silently produce
        # a clean channel; refuse rather than mislead the test.
        if args.doppler_hz:
            p.error("--doppler-hz needs a channel: add --multipath "
                    "and/or --echo-us")
        if args.echo_db != p.get_default("echo_db"):
            p.error("--echo-db has no effect without --echo-us")
    else:
        channel = MultipathChannel(taps, doppler_hz=args.doppler_hz,
                                   rng=np.random.default_rng(1))
        log.info("channel: %d taps, %s",
                 len(taps), f"{args.doppler_hz:g} Hz Doppler"
                 if args.doppler_hz else "static")

    def emit(x: np.ndarray) -> None:
        if channel is not None:     # propagation first, then receiver LO
            x = channel(x)
        if args.cfo_hz:
            x = carrier_offset(x, args.cfo_hz,
                               start_sample=st["sample0"])
        if args.snr is not None:
            x = awgn(x, args.snr, rng)
        st["sample0"] += x.size
        out.write(quantize_u8(x).tobytes() if args.format == "u8"
                  else x.astype(np.complex64).tobytes())

    if args.timing_offset:
        emit(np.zeros(args.timing_offset, dtype=np.complex64))

    fibs_per_cif = mode.n_fibs // mode.n_cifs

    def flush(final: bool = False) -> None:
        if st["mod"] is None:
            ens = fig.ensemble()
            if ens is None:
                return
            st["subs"] = ens.sorted_subchannels()
            missing = [s.subchid for s in st["subs"]
                       if buf and s.subchid not in buf[0].streams]
            if missing:
                log.warning("sub-channels %s signalled in FIC but absent "
                            "from the MST; modulating zeros", missing)
            log.info("modulating Mode %s, %d sub-channels "
                     "(ensemble 0x%04X %r)", mode.name, len(st["subs"]),
                     ens.eid, ens.label)
            st["mod"] = Modulator(
                [SubchannelSource(s.start_cu, s.profile)
                 for s in st["subs"]], mode=mode)
        while True:
            n = len(buf) // mode.n_cifs
            if args.frames is not None:
                n = min(n, args.frames - st["n_tx"])
            n = min(n, CHUNK_TX)
            if not final and n < CHUNK_TX:
                return
            if mode.name == "III":
                n -= n % 3           # FIC codewords span 3 Mode III frames
            if n <= 0:
                return
            chunk = buf[: n * mode.n_cifs]
            del buf[: n * mode.n_cifs]

            def fibs_fn(t):
                rows = []
                for c in range(mode.n_cifs):
                    fic = chunk[t * mode.n_cifs + c].fic
                    rows += [np.frombuffer(fic[32 * i:32 * (i + 1)],
                                           np.uint8)
                             for i in range(fibs_per_cif)]
                return np.stack(rows)

            def payload_fn(t, i):
                s = st["subs"][i]
                rows = []
                for c in range(mode.n_cifs):
                    fr = chunk[t * mode.n_cifs + c]
                    if s.subchid in fr.streams:
                        d = np.frombuffer(fr.subchannel_data(s.subchid),
                                          np.uint8)
                    else:
                        d = np.zeros(s.data_bytes, np.uint8)
                    rows.append(np.unpackbits(d))
                return np.stack(rows)

            emit(st["mod"].frames(n, fibs_fn, payload_fn))
            st["n_tx"] += n

    n_in = 0
    from dabtools_tpu_torch.eti.edi import iter_eti_chunks
    chunks = iter_eti_chunks(f, mode)       # ETI, or EDI transcoded
    # Check the frame target BEFORE pulling the next chunk: the
    # generator blocks in read(), so checking after would hang a live
    # stdin pipe once --frames is already satisfied (review r3b).
    while st["n_tx"] != args.frames:
        data = next(chunks, None)
        if data is None:
            break
        for frame in parser.feed(data):
            n_in += 1
            for i in range(0, len(frame.fic), 32):
                fig.feed_fib(frame.fic[i:i + 32])
            buf.append(frame)
            if st["mod"] is None and len(buf) > MAX_PENDING_FRAMES:
                buf.pop(0)           # endless no-MCI input: stay bounded
                st["dropped"] = True
        flush()
    flush(final=True)
    if args.input != "-":
        f.close()
    out.flush()
    if args.output != "-":
        out.close()
    if not n_in:
        log.error("no ETI frames found")
        return 1
    if st["mod"] is None:
        log.error("no MCI in the ETI FIC; cannot derive the sub-channel "
                  "organization%s",
                  " (input overran the pre-MCI buffer)"
                  if st["dropped"] else "")
        return 1
    log.info("wrote %d samples (%.2f s at %.3f Msps) from %d transmission "
             "frames", st["sample0"], st["sample0"] / C.SAMPLE_RATE,
             C.SAMPLE_RATE / 1e6, st["n_tx"])
    return 0


if __name__ == "__main__":
    sys.exit(main())

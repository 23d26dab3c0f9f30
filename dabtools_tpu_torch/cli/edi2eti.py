"""``edi2eti``: EDI (AF-framed TAG items) in, ETI(NI) out.

Usage: python -m dabtools_tpu.cli.edi2eti mux.edi > mux.eti
Input can be a file/stdin or a UDP listener (``udp://[host]:port``, one
PFT fragment or AF packet per datagram; stops after ``--udp-idle``
seconds without traffic).  Inverse of eti2edi; resynchronises on the AF
sync word and drops CRC-failed packets (counts reported at exit).
"""

from __future__ import annotations

import argparse
import logging
import sys

log = logging.getLogger("dabtools_tpu.edi2eti")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="edi2eti", description=__doc__)
    p.add_argument("input", help="EDI file, or '-' for stdin")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I")
    p.add_argument("--pft-dest", default=None, metavar="ADDR",
                   help="accept only PFT fragments addressed to this 16-bit "
                        "destination (e.g. 0xBEEF)")
    p.add_argument("--udp-idle", type=float, default=5.0, metavar="SECONDS",
                   help="with a udp:// input: exit after this long without "
                        "a datagram (0 = run forever)")
    p.add_argument("--output", "-o", default="-")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")

    from dabtools_tpu_torch import constants as C
    from dabtools_tpu_torch.eti.edi import PFT_SYNC, EdiReader, PftReassembler

    if args.input.startswith("udp://"):
        import socket
        host, _, port = args.input[6:].rpartition(":")
        f = None
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind((host or "0.0.0.0", int(port)))
        if args.udp_idle:
            sock.settimeout(args.udp_idle)

        def read_chunk():
            import socket as _s
            try:
                return sock.recvfrom(65536)[0]
            except (_s.timeout, TimeoutError):
                return b""
    else:
        sock = None
        f = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
        read_chunk = lambda: f.read(1 << 20)  # noqa: E731

    out = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    r = EdiReader(mode=C.MODES[args.mode])
    pft = None
    n = 0
    oversized = 0
    first = True

    def write_frames(frames) -> int:
        nonlocal oversized
        k = 0
        for frame in frames:
            try:
                out.write(r.to_eti_bytes(frame))
                k += 1
            except ValueError:   # oversized frame: skip, keep the stream
                oversized += 1
        return k

    while True:
        chunk = read_chunk()
        if not chunk:
            break
        if first:
            first = False
            if chunk[:2] == PFT_SYNC:      # PFT-fragmented stream
                dest = int(args.pft_dest, 0) if args.pft_dest else None
                pft = PftReassembler(dest=dest)
        if pft is not None:
            chunk = b"".join(pft.feed(chunk))
        n += write_frames(r.feed(chunk))
    if pft is not None:     # end of stream: close pending groups (RS FEC
        for af in pft.flush():     # recovery for incomplete ones)
            n += write_frames(r.feed(af))
    out.flush()
    if sock is not None:
        sock.close()
    elif args.input != "-":
        f.close()
    if args.output != "-":
        out.close()
    log.info("wrote %d ETI frames (AF resyncs=%d, CRC failures=%d, "
             "oversized skipped=%d%s)",
             n, r.af.resyncs, r.af.crc_failures, oversized,
             f", PFT dropped={pft.dropped_groups} "
             f"recovered={pft.recovered_groups}" if pft else "")
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())

"""``eti2edi``: ETI(NI) in, EDI (TAG items over AF framing) out.

Usage: python -m dabtools_tpu.cli.eti2edi mux.eti > mux.edi
Output can be a file/stdout or a UDP destination (``-o udp://host:port``,
the usual EDI transport — implies PFT fragmentation to the MTU, one
fragment per datagram).  See dabtools_tpu/eti/edi.py for the framing.
"""

from __future__ import annotations

import argparse
import logging
import sys

log = logging.getLogger("dabtools_tpu.eti2edi")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="eti2edi", description=__doc__)
    p.add_argument("input", help="ETI(NI) file, or '-' for stdin")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I")
    p.add_argument("--pft-mtu", type=int, default=None, metavar="BYTES",
                   help="fragment AF packets with the PFT layer to this MTU "
                        "(for datagram/lossy transports)")
    p.add_argument("--pft-fec", action="store_true",
                   help="add RS(k+48,k) erasure protection to PFT fragments "
                        "(up to 48 lost matrix columns per AF packet "
                        "recovered at the receiver); implies --pft-mtu 1400 "
                        "unless given")
    p.add_argument("--pft-addr", default=None, metavar="SRC:DST",
                   help="carry 16-bit source/dest addresses in PFT headers, "
                        "e.g. 0x1234:0xBEEF")
    p.add_argument("--output", "-o", default="-")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")

    from dabtools_tpu_torch import constants as C
    from dabtools_tpu_torch.eti.edi import EdiWriter, pft_fragments

    addr = None
    if args.pft_addr:
        src, sep, dst = args.pft_addr.partition(":")
        try:
            if not sep:
                raise ValueError
            addr = (int(src, 0), int(dst, 0))
        except ValueError:
            p.error(f"--pft-addr must be SRC:DST (numbers, hex ok); "
                    f"got {args.pft_addr!r}")

    sock = None
    if args.output.startswith("udp://"):
        import socket
        host, _, port = args.output[6:].rpartition(":")
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        dest = (host or "127.0.0.1", int(port))
        out = None
        mtu = args.pft_mtu or 1400      # UDP always fragments via PFT
    else:
        out = (sys.stdout.buffer if args.output == "-"
               else open(args.output, "wb"))
        mtu = args.pft_mtu or (1400 if args.pft_fec or addr else None)

    def emit(frag: bytes) -> None:
        if sock is not None:
            sock.sendto(frag, dest)     # one PFT fragment per datagram
        else:
            out.write(frag)

    f = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    w = EdiWriter(mode=C.MODES[args.mode])
    n = 0
    while True:
        chunk = f.read(1 << 20)
        if not chunk:
            break
        for pkt in w.from_eti_bytes(chunk):
            if mtu:
                for frag in pft_fragments(pkt, n, mtu, fec=args.pft_fec,
                                          addr=addr):
                    emit(frag)
            else:
                emit(pkt)
            n += 1
    if out is not None:
        out.flush()
        if args.output != "-":
            out.close()
    if sock is not None:
        sock.close()
    if args.input != "-":
        f.close()
    log.info("wrote %d EDI AF packets", n)
    return 0 if n else 1


if __name__ == "__main__":
    sys.exit(main())

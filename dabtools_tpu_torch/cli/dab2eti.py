"""``dab2eti`` on the PyTorch port: IQ samples in, ETI(NI) stream out.

Usage:
  python -m dabtools_tpu_torch.cli.dab2eti capture.iq > out.eti
  python -m dabtools_tpu_torch.cli.dab2eti --format cf32 - < cap.cf32 > out.eti

Reads 2.048 Msps IQ from a file or stdin (u8 offset-128 interleaved, s8,
s16 or complex64) and decodes on ``--torch-device`` (default ``cuda``;
without CUDA the command fails rather than running on the CPU).  Port of
``dabtools_tpu/cli/dab2eti.py``'s file/stdin path; its input readers
(``CHUNK``, ``_FORMATS``, ``decode_iq``, ``iter_samples``) are verbatim
copies.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.eti.edi import EdiWriter
from dabtools_tpu_torch.models.receiver import DabReceiver

log = logging.getLogger("dabtools_tpu_torch.dab2eti")

_NOT_PORTED = "is not ported to the PyTorch receiver yet (see ROADMAP.md)"

CHUNK = 1 << 22


_FORMATS = {        # bytes per complex sample
    "u8": 2,        # RTL-SDR: unsigned 8-bit interleaved, offset 128
    "s8": 2,        # HackRF: signed 8-bit interleaved
    "s16": 4,       # Airspy/SDRplay: signed 16-bit interleaved
    "cf32": 8,      # complex64
}


def decode_iq(raw: bytes, fmt: str) -> np.ndarray:
    """Wire bytes -> samples.  u8 stays uint8 (converted on device —
    4x less host->device traffic than cf32); the rest become complex64.

    Truncated captures are tolerated: a trailing partial sample is
    dropped rather than raising (interrupted SDR recordings)."""
    raw = raw[:len(raw) // _FORMATS[fmt] * _FORMATS[fmt]]
    if fmt == "u8":
        return np.frombuffer(raw, dtype=np.uint8)
    if fmt == "s8":
        a = np.frombuffer(raw, dtype=np.int8).astype(np.float32)
        return (a[0::2] + 1j * a[1::2]).astype(np.complex64) / 128.0
    if fmt == "s16":
        a = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        return (a[0::2] + 1j * a[1::2]).astype(np.complex64) / 32768.0
    return np.frombuffer(raw, dtype=np.complex64)


def iter_samples(path: str, fmt: str):
    f = sys.stdin.buffer if path == "-" else open(path, "rb")
    itemsize = _FORMATS[fmt]
    carry = b""   # pipes deliver arbitrary read sizes; keep partial samples
    try:
        while True:
            raw = f.read(CHUNK)
            if not raw:
                return
            raw = carry + raw
            usable = len(raw) // itemsize * itemsize
            raw, carry = raw[:usable], raw[usable:]
            if raw:
                yield decode_iq(raw, fmt)
    finally:
        if path != "-":
            f.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dab2eti", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", nargs="?", default="-",
                   help="IQ file path, or '-' for stdin")
    p.add_argument("--format", choices=("u8", "s8", "s16", "cf32"),
                   default="u8",
                   help="u8: RTL-SDR unsigned 8-bit interleaved IQ; "
                        "s8: HackRF signed 8-bit; s16: Airspy/SDRplay "
                        "signed 16-bit (little-endian); cf32: complex64")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="device the receiver runs on (default cuda)")
    p.add_argument("--device", choices=("file", "rtlsdr"), default="file",
                   help="input source; only 'file' (path/stdin) is ported")
    p.add_argument("--rate", type=float, default=2_048_000,
                   help="input sample rate; only 2.048 Msps is ported")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I",
                   help="DAB transmission mode (Mode III requires "
                        "--frames-per-block to be a multiple of 3)")
    p.add_argument("--frames-per-block", type=int, default=None,
                   help="transmission frames decoded per device call "
                        "(default 8; 6 in Mode III)")
    p.add_argument("--output", "-o", default="-",
                   help="ETI output path ('-' = stdout)")
    p.add_argument("--stats", action="store_true",
                   help="log per-block sync/CRC stats to stderr")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="append one JSON object per block (sync confidence, "
                        "CFO, CRC rates, Viterbi metrics) to PATH")
    p.add_argument("--edi", action="store_true",
                   help="emit EDI (AF-framed TAG packets, TS 102 693) "
                        "instead of raw ETI(NI)")
    p.add_argument("--tist", action="store_true",
                   help="stamp ETI frames with TIST timestamps "
                        "(stream-relative, 24 ms per frame)")
    p.add_argument("--tist-utc", action="store_true",
                   help="TIST anchored to this host's wall clock")
    p.add_argument("--tist-epoch", type=float, default=None,
                   metavar="SECONDS",
                   help="TIST from an external time source: UTC/GPS "
                        "seconds timestamp of the capture's first sample")
    p.add_argument("--tii", action="store_true",
                   help="transmitter identification (not ported yet)")
    p.add_argument("--wideband", type=float, default=None,
                   metavar="CENTER_HZ",
                   help="wideband channelizer input (not ported yet)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")
    if args.device != "file":
        p.error(f"--device {args.device} {_NOT_PORTED}")
    if int(args.rate) != 2_048_000:
        p.error(f"--rate other than 2.048e6 (the resampler) {_NOT_PORTED}")
    if args.tii:
        p.error(f"--tii {_NOT_PORTED}")
    if args.wideband is not None:
        p.error(f"--wideband {_NOT_PORTED}")
    if sum((args.tist, args.tist_utc, args.tist_epoch is not None)) > 1:
        p.error("--tist, --tist-utc and --tist-epoch are mutually "
                "exclusive (each picks a different timestamp anchor)")

    if args.torch_device == "cuda" and not torch.cuda.is_available():
        p.error("--torch-device cuda: no CUDA device is available "
                "(pass --torch-device cpu to decode on the CPU)")

    mode = C.MODES[args.mode]
    n_frames = args.frames_per_block or (6 if args.mode == "III" else 8)
    tist = (args.tist_epoch if args.tist_epoch is not None
            else "utc" if args.tist_utc else args.tist)
    out = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    rx = DabReceiver(n_frames=n_frames, mode=mode,
                     stats_jsonl=args.stats_json, tist=tist,
                     device=args.torch_device)
    edi = None
    if args.edi:
        edi = EdiWriter(mode=mode)
    n_eti = 0
    try:
        for chunk in iter_samples(args.input, args.format):
            for frame in rx.feed(chunk):
                if edi is not None:
                    for pkt in edi.from_eti_bytes(frame):
                        out.write(pkt)
                else:
                    out.write(frame)
                n_eti += 1
            if args.stats and rx.stats:
                s = rx.stats[-1]
                log.info("cif=%d null@%d snr=%.1fdB cfo=%+.1fHz "
                         "delay_spread=%.1fus fib_ok=%d fib_bad=%d",
                         s.cif_count, s.null_start, s.snr_db,
                         s.cfo_carriers * 1000.0, s.delay_spread_us,
                         s.fib_crc_ok, s.fib_crc_bad)
        out.flush()
    finally:
        if args.output != "-":
            out.close()
    if rx.ensemble is None:
        log.error("no ensemble acquired (insufficient or undecodable input)")
        return 1
    log.info("wrote %d %s frames; ensemble 0x%04X %r", n_eti,
             "EDI" if args.edi else "ETI", rx.ensemble.eid, rx.ensemble.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``dab2eti`` on the PyTorch port: IQ samples in, ETI(NI) stream out.

Usage:
  python -m dabtools_tpu_torch.cli.dab2eti capture.iq > out.eti
  python -m dabtools_tpu_torch.cli.dab2eti --format cf32 - < cap.cf32 > out.eti

Reads IQ from a file or stdin (u8 offset-128 interleaved, s8, s16 or
complex64) or a live RTL-SDR (``--device rtlsdr``), and decodes on
``--torch-device`` (default ``cuda``; without CUDA the command fails
rather than running on the CPU).  Other rates than 2.048 Msps go through
the polyphase resampler (``--rate``); ``--wideband`` channelizes every
Band III block inside the capture and writes one file per block.  Port
of ``dabtools_tpu/cli/dab2eti.py``, with its argument checks and log
lines; its input readers (``CHUNK``, ``_FORMATS``, ``decode_iq``,
``iter_samples``) are verbatim copies.
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import sys

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.eti.edi import EdiWriter
from dabtools_tpu_torch.frontend.rtlsdr import RtlSdrSource
from dabtools_tpu_torch.mod.impairments import u8_to_complex
from dabtools_tpu_torch.models.receiver import DabReceiver
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.resample import Resampler
from dabtools_tpu_torch.tables.bandiii import blocks_within
from dabtools_tpu_torch.utils import spans

log = logging.getLogger("dabtools_tpu_torch.dab2eti")

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


def _wideband(args, mode, n_frames) -> int:
    """Wideband capture -> channelizer -> one ETI/EDI file per Band III
    block under the -o directory; each block runs through its own
    streaming DabReceiver for per-block sync state."""
    fs = int(args.rate)
    if fs % C.SAMPLE_RATE:
        log.error("--wideband needs --rate = n x 2.048 MHz (got %.4f MHz)",
                  fs / 1e6)
        return 2
    if args.output == "-":
        log.error("--wideband writes one file per block; -o must be a "
                  "directory")
        return 2
    cands = blocks_within(args.wideband, fs)
    if args.blocks:
        want = {b.strip().upper() for b in args.blocks.split(",")}
        unknown = want - {n for n, _ in cands}
        if unknown:
            log.error("blocks %s not inside the capture band (have %s)",
                      sorted(unknown), [n for n, _ in cands])
            return 2
        cands = [(n, f) for n, f in cands if n in want]
    if not cands:
        log.error("no Band III blocks inside the capture bandwidth")
        return 1
    outdir = pathlib.Path(args.output)
    outdir.mkdir(parents=True, exist_ok=True)
    ch = Channelizer(fs, offsets_hz=[int(f - args.wideband)
                                     for _, f in cands],
                     device=args.torch_device)
    log.info("channelizing %.4f Msps -> %d blocks: %s (%d taps)",
             fs / 1e6, len(cands), [n for n, _ in cands], ch.num_taps)
    ext = "edi" if args.edi else "eti"
    rxs, outs, edis, counts = {}, {}, {}, {}
    for name, _ in cands:
        rxs[name] = DabReceiver(n_frames=n_frames, mode=mode,
                                device=args.torch_device)
        outs[name] = open(outdir / f"{name}.{ext}", "wb")
        counts[name] = 0
        if args.edi:
            edis[name] = EdiWriter(mode=mode)
    try:
        for chunk in iter_samples(args.input, args.format):
            if chunk.dtype == np.uint8:
                chunk = u8_to_complex(chunk)
            y = ch(chunk)               # (K, n) on the device
            for i, (name, _) in enumerate(cands):
                for frame in rxs[name].feed(y[i]):
                    if args.edi:
                        for pkt in edis[name].from_eti_bytes(frame):
                            outs[name].write(pkt)
                    else:
                        outs[name].write(frame)
                    counts[name] += 1
    finally:
        for f in outs.values():
            f.close()
    n_found = 0
    for name, freq in cands:
        ens = rxs[name].ensemble
        if ens is None:
            log.info("block %s (%.3f MHz): no ensemble", name, freq / 1e6)
            continue
        n_found += 1
        log.info("block %s (%.3f MHz): ensemble 0x%04X %r -> %d %s frames",
                 name, freq / 1e6, ens.eid, ens.label, counts[name],
                 ext.upper())
    return 0 if n_found else 1


def _log_spans(done: list) -> None:
    """One line for a chunk's spans: each layer's self ms, then the MB
    its copy spans moved."""
    if not done:
        return
    ms = spans.self_ns(done)
    log.info("spans ms: %s; copied %.3f MB",
             " ".join(f"{k}={v / 1e6:.3f}" for k, v in ms.items()),
             sum(s[4] for s in done) / 1e6)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dab2eti", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("input", nargs="?", default="-",
                   help="IQ file path, or '-' for stdin (ignored with "
                        "--device rtlsdr)")
    p.add_argument("--format", choices=("u8", "s8", "s16", "cf32"),
                   default="u8",
                   help="u8: RTL-SDR unsigned 8-bit interleaved IQ; "
                        "s8: HackRF signed 8-bit; s16: Airspy/SDRplay "
                        "signed 16-bit (little-endian); cf32: complex64")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="device the receiver runs on (default cuda)")
    p.add_argument("--device", choices=("file", "rtlsdr"), default="file",
                   help="input source: 'file' (default; path/stdin) or "
                        "'rtlsdr' (live librtlsdr dongle; needs "
                        "--frequency, like the reference dab2eti)")
    p.add_argument("--rtlsdr-lib", default=None, metavar="PATH",
                   help="explicit librtlsdr.so path")
    p.add_argument("--rtlsdr-index", type=int, default=0,
                   help="RTL-SDR device index")
    p.add_argument("--frequency", type=float, default=None,
                   help="RF centre frequency in Hz (tunes the dongle with "
                        "--device rtlsdr; informational for file input)")
    p.add_argument("--rate", type=float, default=2_048_000,
                   help="input sample rate; rates rationally related to "
                        "2.048 Msps (e.g. the RTL-SDR-native 2.4 Msps) are "
                        "converted by the polyphase resampler")
    p.add_argument("--gain", type=float, default=None,
                   help="tuner gain in dB with --device rtlsdr "
                        "(default: AGC)")
    p.add_argument("--mode", choices=("I", "II", "III", "IV"), default="I",
                   help="DAB transmission mode (Mode III requires "
                        "--frames-per-block to be a multiple of 3)")
    p.add_argument("--frames-per-block", type=int, default=None,
                   help="transmission frames decoded per device call "
                        "(default 8; 6 in Mode III)")
    p.add_argument("--output", "-o", default="-",
                   help="ETI output path ('-' = stdout)")
    p.add_argument("--stats", action="store_true",
                   help="log per-block sync/CRC stats to stderr, and per "
                        "chunk the host ms of each layer's span and the "
                        "MB copied to and from the device")
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
                   help="detect transmitter identification (TII) from the "
                        "null symbol and report it at exit")
    p.add_argument("--wideband", type=float, default=None,
                   metavar="CENTER_HZ",
                   help="treat the input as a wideband capture centred "
                        "here: channelize every Band III block in band "
                        "and decode each to <block>.eti under -o DIR")
    p.add_argument("--blocks", default=None, metavar="5C,5D,...",
                   help="with --wideband: decode only these blocks")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(name)s: %(message)s")
    if args.device == "rtlsdr" and args.frequency is None:
        p.error("--device rtlsdr requires --frequency")
    if args.wideband is not None and args.device != "file":
        p.error("--wideband reads a wideband capture file/stream; it does "
                "not drive an SDR frontend (the RTL-SDR samples a single "
                "2.048 MHz block)")
    if args.frequency and args.device == "file":
        log.info("frequency %.3f MHz (file/stream input; not tuning)",
                 args.frequency / 1e6)
    if sum((args.tist, args.tist_utc, args.tist_epoch is not None)) > 1:
        p.error("--tist, --tist-utc and --tist-epoch are mutually "
                "exclusive (each picks a different timestamp anchor)")

    if args.torch_device == "cuda" and not torch.cuda.is_available():
        p.error("--torch-device cuda: no CUDA device is available "
                "(pass --torch-device cpu to decode on the CPU)")

    mode = C.MODES[args.mode]
    n_frames = args.frames_per_block or (6 if args.mode == "III" else 8)
    if args.wideband is not None:
        return _wideband(args, mode, n_frames)
    tist = (args.tist_epoch if args.tist_epoch is not None
            else "utc" if args.tist_utc else args.tist)
    out = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    rx = DabReceiver(n_frames=n_frames, mode=mode,
                     stats_jsonl=args.stats_json, tii=args.tii, tist=tist,
                     device=args.torch_device)
    resampler = None
    if int(args.rate) != 2_048_000:
        resampler = Resampler(int(args.rate), device=args.torch_device)
        log.info("resampling %.4f Msps -> 2.048 Msps (L/M = %d/%d)",
                 args.rate / 1e6, resampler.up, resampler.down)
    edi = None
    if args.edi:
        edi = EdiWriter(mode=mode)

    sdr = None
    if args.device == "rtlsdr":
        # The dongle streams at --rate (e.g. the RTL-native 2.4 Msps);
        # the resampler converts to 2.048 Msps.
        sdr = RtlSdrSource(args.frequency, gain_db=args.gain,
                           device_index=args.rtlsdr_index,
                           sample_rate=int(args.rate),
                           lib_path=args.rtlsdr_lib)

        def live_blocks(block=1 << 20):
            try:
                while True:
                    chunk = sdr.read_block(block)
                    if chunk.size == 0:      # stream cancelled / unplugged
                        return
                    yield chunk
            except KeyboardInterrupt:
                return

        samples = live_blocks()
    else:
        samples = iter_samples(args.input, args.format)
    if args.stats:
        spans.enable()
    n_eti = 0
    try:
        for chunk in samples:
            if resampler is not None:
                if chunk.dtype == np.uint8:   # resampler works on cf32
                    chunk = u8_to_complex(chunk)
                chunk = resampler(chunk)    # a tensor on the device
                if chunk.numel() == 0:
                    continue
            for frame in rx.feed(chunk):
                if edi is not None:
                    for pkt in edi.from_eti_bytes(frame):
                        out.write(pkt)
                else:
                    out.write(frame)
                n_eti += 1
            if args.stats:
                if rx.stats:
                    s = rx.stats[-1]
                    log.info("cif=%d null@%d snr=%.1fdB cfo=%+.1fHz "
                             "delay_spread=%.1fus fib_ok=%d fib_bad=%d",
                             s.cif_count, s.null_start, s.snr_db,
                             s.cfo_carriers * 1000.0, s.delay_spread_us,
                             s.fib_crc_ok, s.fib_crc_bad)
                _log_spans(spans.drain())
        out.flush()
    finally:
        if args.stats:
            spans.disable()
            spans.drain()
        if sdr is not None:
            sdr.close()
            if sdr.dropped_bytes:
                log.warning("rtlsdr ring dropped %d bytes (receiver slower "
                            "than 2.048 Msps?)", sdr.dropped_bytes)
        if args.output != "-":
            out.close()
    if args.tii:
        det = rx.tii()
        if det is None:
            log.info("TII: none detected")
        else:
            log.info("TII: main id %d, sub id %d (snr %.1f)",
                     det.main_id, det.sub_id, det.snr)
    if rx.ensemble is None:
        log.error("no ensemble acquired (insufficient or undecodable input)")
        return 1
    log.info("wrote %d %s frames; ensemble 0x%04X %r", n_eti,
             "EDI" if args.edi else "ETI", rx.ensemble.eid, rx.ensemble.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())

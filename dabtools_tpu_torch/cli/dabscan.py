"""``dabscan`` on the PyTorch port: find DAB ensembles in a wideband
capture.

Channelizes every Band III block that fits inside the capture bandwidth
and runs FIC acquisition on all candidates as ONE channel-parallel block
(one Viterbi dispatch for every candidate's FIC codewords) on
``--torch-device`` (default ``cuda``; without CUDA the command fails
rather than running on the CPU); the FIG parse runs on the host.  Port
of ``dabtools_tpu/cli/dabscan.py``, with its text and ``--json`` output.

Usage:
  python -m dabtools_tpu_torch.cli.dabscan --center 184.5e6 --rate 8.192e6 cap.cf32
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.cli.dab2eti import _FORMATS, decode_iq
from dabtools_tpu_torch.fic.fig import FigParser
from dabtools_tpu_torch.mod.impairments import u8_to_complex
from dabtools_tpu_torch.models.receiver import block_samples, to_host
from dabtools_tpu_torch.ops.fir import Channelizer
from dabtools_tpu_torch.ops.sync import (
    SNR_CAVEAT,
    SNR_METHOD,
    null_ratio_to_snr_db,
)
from dabtools_tpu_torch.parallel.channel import channel_parallel_block
from dabtools_tpu_torch.tables.bandiii import blocks_within
from dabtools_tpu_torch.utils.crc import crc16_ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dabscan", description=__doc__)
    p.add_argument("input", help="wideband IQ capture (u8 or cf32), '-' stdin")
    p.add_argument("--center", type=float, required=True,
                   help="capture centre frequency, Hz")
    p.add_argument("--rate", type=float, required=True,
                   help="capture sample rate, Hz (integer multiple of "
                        "2.048 MHz)")
    p.add_argument("--format", choices=("u8", "s8", "s16", "cf32"),
                   default="cf32",
                   help="u8: RTL-SDR; s8: HackRF; s16: Airspy/SDRplay; "
                        "cf32: complex64")
    p.add_argument("--seconds", type=float, default=2.0,
                   help="how much capture to scan")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output: one JSON object per "
                        "candidate block on stdout")
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="device the scan runs on (default cuda)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    if args.torch_device == "cuda" and not torch.cuda.is_available():
        p.error("--torch-device cuda: no CUDA device is available "
                "(pass --torch-device cpu to scan on the CPU)")
    dev = torch.device(args.torch_device)

    fs = int(args.rate)
    candidates = blocks_within(args.center, fs)
    if not candidates:
        print("no Band III blocks inside the capture bandwidth")
        return 1
    offsets = [int(f - args.center) for _, f in candidates]
    print(f"scanning {len(candidates)} blocks: "
          f"{', '.join(l for l, _ in candidates)}", file=sys.stderr)

    n = int(args.seconds * fs)
    f = sys.stdin.buffer if args.input == "-" else open(args.input, "rb")
    x = decode_iq(f.read(_FORMATS[args.format] * n), args.format)
    if x.dtype == np.uint8:
        x = u8_to_complex(x)
    if args.input != "-":
        f.close()

    ch = Channelizer(fs, offsets_hz=offsets, device=dev)
    streams = ch(x)

    # All candidate blocks run FIC acquisition as ONE channel-parallel
    # block, then the per-block FIG parse happens on the host.
    n_frames = max(1, min(8, streams.shape[1]
                          // (2 * C.MODE_I.frame_size) - 1))
    need = block_samples(n_frames)
    if streams.shape[1] < need:
        print(f"capture too short: need {need} samples per block after "
              f"channelization, have {streams.shape[1]}", file=sys.stderr)
        return 1
    # the channelizer's rows are on the device already; one copy there
    # hands the chain a contiguous batch, as its other callers do
    out, _, _ = channel_parallel_block(
        streams[:, :need].contiguous(), {},
        torch.tensor(0, dtype=torch.int32, device=dev),
        ensemble=None, n_frames=n_frames)
    out = to_host(out)
    fib_bytes_all = out["fib_bytes"]                # (C, B, 12, 32)
    null_ratio = out["null_ratio"]
    # PRS channel sounding per block (SFN/multipath view): us RMS.
    delay_us = out["delay_spread"].mean(axis=1) * 1e6 / C.SAMPLE_RATE

    def snr_db(r):
        return round(null_ratio_to_snr_db(r), 1)

    found = 0
    for c, (label, freq) in enumerate(candidates):
        fig = FigParser()
        fibs = fib_bytes_all[c]
        for f in range(fibs.shape[0]):
            for i in range(fibs.shape[1]):
                fib = fibs[f, i].tobytes()
                if crc16_ok(fib):
                    fig.feed_fib(fib)
        ens = fig.ensemble()
        if ens is None:
            if args.json:
                print(json.dumps({"block": label, "freq_hz": freq,
                                  "null_ratio": float(null_ratio[c]),
                                  "snr_db": snr_db(null_ratio[c]),
                                  "snr_method": SNR_METHOD,
                                  "snr_caveat": SNR_CAVEAT}))
            else:
                print(f"{label} {freq / 1e6:8.3f} MHz: -- "
                      f"(null ratio {float(null_ratio[c]):.2f})")
            continue
        found += 1
        if args.json:
            print(json.dumps({
                "block": label, "freq_hz": freq,
                "null_ratio": float(null_ratio[c]),
                "snr_db": snr_db(null_ratio[c]),
                "snr_method": SNR_METHOD,
                "snr_caveat": SNR_CAVEAT,
                "delay_spread_us": round(float(delay_us[c]), 2),
                "eid": f"0x{ens.eid:04X}", "label": ens.label,
                "subchannels": len(ens.subchannels),
                "services": [
                    {"sid": f"0x{s.sid:X}", "label": s.label,
                     "dabplus": any(c.is_dabplus for c in s.components)}
                    for s in ens.services]}))
            continue
        svcs = ", ".join(
            f"{s.label or hex(s.sid)}"
            f"[{'DAB+' if any(c.is_dabplus for c in s.components) else 'MP2'}]"
            for s in ens.services) or "(no services signalled yet)"
        print(f"{label} {freq / 1e6:8.3f} MHz: ensemble 0x{ens.eid:04X} "
              f"{ens.label!r} — {len(ens.subchannels)} subch — "
              f"delay spread {float(delay_us[c]):.1f} us — {svcs}")
    print(f"{found} ensemble(s) found", file=sys.stderr)
    return 0 if found else 2


if __name__ == "__main__":
    sys.exit(main())

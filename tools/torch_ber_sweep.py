"""Decode-rate waterfall of the PyTorch port: the BER sweep of
``tools/ber_sweep.py`` on ``dabtools_tpu_torch``.

Sweeps SNR (and optionally CFO) over the closed loop and writes one
JSON line per point: whether the ensemble was acquired, the FIB CRC
rate and the post-FEC frame decode rate.  The signal is the JAX closed
loop's (``testsignal.closed_loop_ensemble``: EEP 3-A 64 kbit/s, payloads
from ``default_rng(seed)``, AWGN from ``default_rng(seed + 10_000)``);
the records and the resume rule are those of ``tools/ber_sweep.py``.

  python tools/torch_ber_sweep.py --snrs 3 4 5 6 8 --frames 12 -o ber.jsonl

Decodes on ``--torch-device`` (default ``cuda``; records name the card
and carry ``"platform": "cuda"``).  Without CUDA it exits 3 rather than
label CPU results as the card's; ``--torch-device cpu`` sweeps on the
CPU under ``"platform": "cpu"``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np  # noqa: E402


def run_point(snr_db: float, cfo_hz: float, n_frames: int, seed: int,
              device: str = "cuda") -> dict:
    """One point of the sweep on ``device``: the closed-loop signal of
    ``seed`` at ``snr_db`` (after a carrier offset of ``cfo_hz``) through
    ``DabReceiver(n_frames=4)``."""
    from dabtools_tpu_torch import constants as C
    from dabtools_tpu_torch import testsignal as S
    from dabtools_tpu_torch.eti.parse import EtiParser
    from dabtools_tpu_torch.mod.impairments import awgn, carrier_offset
    from dabtools_tpu_torch.models.receiver import DabReceiver

    x, payload_bytes = S.modulate(S.closed_loop_ensemble(), n_frames,
                                  np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 10_000)
    if cfo_hz:
        x = carrier_offset(x, cfo_hz)
    x = awgn(x, snr_db, rng)

    rx = DabReceiver(n_frames=4, device=device)
    t0 = time.time()
    eti = rx.feed(x)
    wall = time.time() - t0

    fib_ok = sum(s.fib_crc_ok for s in rx.stats)
    fib_bad = sum(s.fib_crc_bad for s in rx.stats)
    frames = list(EtiParser().feed(b"".join(eti))) if eti else []
    good = 0
    if rx.ensemble is not None and frames:
        a = rx._activation_cif
        # coarse lock may land on the next frame's null when the first dip
        # is clipped or tied: account via the measured position
        off = round(rx.stats[0].null_start / C.MODE_I.frame_size) * 4
        good = sum(
            f.subchannel_data(1) == payload_bytes[1][a + k + off].tobytes()
            for k, f in enumerate(frames)
            if a + k + off < len(payload_bytes[1]))
    return {
        "snr_db": snr_db,
        "cfo_hz": cfo_hz,
        "acquired": rx.ensemble is not None,
        "fib_crc_rate": fib_ok / max(fib_ok + fib_bad, 1),
        "eti_frames": len(frames),
        "frame_decode_rate": good / max(len(frames), 1),
        "wall_s": round(wall, 2),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--snrs", type=float, nargs="+",
                   default=[2, 4, 5, 6, 7, 8, 10, 14])
    p.add_argument("--cfo", type=float, default=0.0)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--torch-device", choices=("cuda", "cpu"),
                   default="cuda",
                   help="where the receiver runs (default: cuda)")
    p.add_argument("-o", "--output", default="-")
    args = p.parse_args(argv)

    import torch
    platform = args.torch_device
    kind = "cpu"
    if platform == "cuda":
        if not torch.cuda.is_available():
            print("--torch-device cuda but no CUDA device; refusing to "
                  "label CPU results as the card's", file=sys.stderr)
            return 3
        kind = torch.cuda.get_device_name(0)
    print(f"# device: {kind} ({platform})", file=sys.stderr)
    # Resume: results append as each point lands, and a restart skips the
    # points already on disk.  Records are counted per (snr, cfo,
    # platform, n_frames): seeds are written in order, so a point is done
    # when ``seed < count``.
    done: dict = {}
    if args.output != "-" and Path(args.output).exists():
        for line in Path(args.output).read_text().splitlines():
            try:
                r = json.loads(line)
                key = (r["snr_db"], r["cfo_hz"], r["platform"],
                       r.get("n_frames", 12))
            except (ValueError, KeyError):
                continue
            done[key] = done.get(key, 0) + 1
        if done:
            print(f"# resuming: {sum(done.values())} points already on "
                  f"disk", file=sys.stderr)
    out = sys.stdout if args.output == "-" else open(args.output, "a")
    try:
        for snr in args.snrs:
            for seed in range(args.seeds):
                if seed < done.get((snr, args.cfo, platform, args.frames),
                                   0):
                    continue
                rec = run_point(snr, args.cfo, args.frames, seed,
                                device=platform)
                rec["platform"] = platform
                rec["device_kind"] = kind
                rec["seed"] = seed
                rec["n_frames"] = args.frames
                out.write(json.dumps(rec) + "\n")
                out.flush()
                print(f"SNR {snr:5.1f} dB seed {seed}: "
                      f"acq={rec['acquired']} "
                      f"fib={rec['fib_crc_rate']:.2f} "
                      f"frames={rec['frame_decode_rate']:.2f}",
                      file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

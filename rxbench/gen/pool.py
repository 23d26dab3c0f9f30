"""The benchmark's one traffic generator: a looped pool of air for a
deployment (``configs/<name>.json``) under a traffic mix
(``traffic/<name>.json``), drawn from a seed.

Modulating and impairing air on the host is slow (tens of ms a frame),
and a window consumes some hundred times its length in air.  So a run
synthesizes ``pool_frames`` frames once and streams them in a loop.  The
loop is seamless:

* payloads repeat with the pool's period, and the pool is cut from a
  modulation ``WARM_FRAMES`` frames in, past the 16-CIF time
  interleaver's depth, so the interleaver sees one periodic stream across
  the seam;
* the CFO is rounded to a whole number of cycles per pool, the timing
  offset is a rotation of the pool, and the wideband up-conversion (the
  ensembles' spectra placed at their blocks, one inverse FFT) and the
  2.4 Msps resampling are spectral, so they are periodic too;
* noise is drawn once over the pool, so it repeats with it.

The FIG 0/0 CIF count jumps back at the seam; the receiver numbers CIFs
with its own counter.  The seed draws the payload bytes, the CFO and the
timing offset of each ensemble, and the noise, in that order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import constants as C
from .bandiii import BAND_III
from .config import Ensemble, Service, ServiceComponent, Subchannel
from .fig import build_fibs_for_ensemble
from .impairments import awgn, carrier_offset, quantize_u8
from .modulator import Modulator, SubchannelSource
from .signals import fft_resample

WARM_FRAMES = 4          # 16 CIFs: past the time interleaver's 15-CIF depth
MODE = C.MODE_I
CIFS = MODE.n_cifs


def ensemble_from_spec(spec: dict) -> Ensemble:
    """An ``Ensemble`` from a configuration's ensemble entry: ``eid``,
    ``label``, ``subchannels`` (``id``, ``start_cu``, ``protection``
    "EEP-<level><option>", ``kbps``) and ``services`` (``sid``,
    ``label``, ``subchid``)."""
    subs = []
    for s in spec["subchannels"]:
        kind, prot = s["protection"].split("-")
        if kind != "EEP":
            raise ValueError(f"only EEP sub-channels are generated: {s}")
        subs.append(Subchannel.eep(s["id"], start_cu=s["start_cu"],
                                   level=int(prot[0]), option=prot[1],
                                   bitrate_kbps=s["kbps"]))
    svcs = tuple(
        Service(sid=v["sid"], label=v["label"], components=(
            ServiceComponent(tmid=0, subchid=v["subchid"]),))
        for v in spec["services"])
    return Ensemble(eid=spec["eid"], subchannels=tuple(subs), services=svcs,
                    label=spec["label"])


@dataclasses.dataclass
class Truth:
    """What one receiver must emit, per CIF of the pool: the FIC (3 FIBs,
    96 bytes) and each sub-channel's logical frame.  ``spec`` is None for
    a block that carries no ensemble."""

    block: str | None
    spec: dict | None
    fic: list = dataclasses.field(default_factory=list)
    payload: dict = dataclasses.field(default_factory=dict)
    cfo_hz: float = 0.0
    delay: int = 0


@dataclasses.dataclass
class Pool:
    """The looped input: ``samples`` holds the loop's ``period`` bytes
    followed by enough of its start that every hand-over of ``handover``
    bytes is one contiguous view."""

    samples: np.ndarray
    period: int
    handover: int
    air_s: float              # seconds of air per hand-over
    truth: list

    def chunk(self, k: int) -> np.ndarray:
        """Hand-over ``k`` of the endless stream (a view)."""
        pos = (k * self.handover) % self.period
        return self.samples[pos: pos + self.handover]


def _looped(ens: Ensemble, pool_frames: int, rng):
    """``pool_frames`` frames of ``ens`` whose payloads repeat with that
    period: (baseband, FIC per pool CIF, {subchid: rows per pool CIF})."""
    subs = ens.sorted_subchannels()
    order = [s.subchid for s in subs]
    n = pool_frames * CIFS
    base = {sc: rng.integers(0, 256, size=(n, ens.subchannel(sc).data_bytes),
                             dtype=np.uint8) for sc in order}
    bits = {sc: np.unpackbits(r, axis=-1) for sc, r in base.items()}
    total = WARM_FRAMES + pool_frames
    fibs = [build_fibs_for_ensemble(ens, f) for f in range(total)]
    mod = Modulator([SubchannelSource(s.start_cu, s.profile) for s in subs])
    x = mod.frames(total, lambda f: fibs[f], lambda f, i: bits[order[i]][
        (CIFS * f + np.arange(CIFS)) % n])
    per = MODE.n_fibs // CIFS
    fic = [fibs[WARM_FRAMES + j // CIFS][per * (j % CIFS):
                                         per * (j % CIFS + 1)].tobytes()
           for j in range(n)]
    shift = CIFS * WARM_FRAMES
    rows = {sc: np.roll(r, -shift, axis=0) for sc, r in base.items()}
    return x[WARM_FRAMES * MODE.frame_size:], fic, rows


def _upconverted_bins(n: int, factor: int, shift: int) -> np.ndarray:
    """Where :func:`signals.upconvert` puts the ``n`` bins of a baseband
    spectrum in the ``n * factor`` bins of the capture, for an offset of
    ``shift`` bins: the sum of the ensembles' up-conversions is then one
    inverse FFT of the summed spectra."""
    half, m = n // 2, n * factor
    return (np.concatenate([np.arange(half), np.arange(m - n + half, m)])
            + shift) % m


def synthesize(config: dict, traffic: dict, seed: int) -> Pool:
    """The pool of ``config`` under ``traffic`` for ``seed``."""
    if config.get("mode", "I") != "I":
        raise ValueError("the generator modulates Mode I only")
    rng = np.random.default_rng(int(seed) % (1 << 63))
    p = int(traffic["pool_frames"])
    n = p * MODE.frame_size                 # baseband samples per loop
    rate = int(traffic.get("rate_hz") or config["rate_hz"])
    center = config.get("center_hz")
    truth, wide, n_ens = [], None, 0
    if center is not None:                  # one spectrum for the capture
        factor = rate // C.SAMPLE_RATE
        spec_wide = np.zeros(n * factor, dtype=np.complex128)
    for rcv in config["receivers"]:
        spec = rcv.get("ensemble")
        t = Truth(rcv.get("block"), spec)
        truth.append(t)
        if spec is None:
            continue
        n_ens += 1
        x, t.fic, t.payload = _looped(ensemble_from_spec(spec), p, rng)
        step = C.SAMPLE_RATE / n               # whole cycles per loop
        t.cfo_hz = float(np.round(rng.uniform(-1.0, 1.0)
                                  * traffic["cfo_hz_max"] / step) * step)
        t.delay = int(rng.integers(0, MODE.frame_size))
        x = np.roll(carrier_offset(x, t.cfo_hz), t.delay)
        if center is None:
            wide = x
            continue
        off = int(BAND_III[t.block] - center)
        if (off * n) % C.SAMPLE_RATE:
            raise ValueError(f"{t.block}: offset not periodic in the pool")
        spec_wide[_upconverted_bins(n, factor, off * n // C.SAMPLE_RATE)] \
            += np.fft.fft(x)
    if center is not None:
        wide = (np.fft.ifft(spec_wide) * (factor / np.sqrt(n_ens))).astype(
            np.complex64)
    elif rate != C.SAMPLE_RATE:
        if (n * rate) % C.SAMPLE_RATE:
            raise ValueError(f"{rate} Hz: the pool is no whole number of "
                             f"samples")
        wide = fft_resample(wide, n * rate // C.SAMPLE_RATE)
    u8 = quantize_u8(awgn(wide, traffic["snr_db"], rng))
    fpb = int(traffic["frames_per_block"])
    handover = 2 * fpb * MODE.frame_size * rate // C.SAMPLE_RATE
    reps = -(-(u8.size + handover) // u8.size)
    return Pool(samples=np.tile(u8, reps), period=u8.size,
                handover=handover, air_s=fpb * MODE.frame_size
                / C.SAMPLE_RATE, truth=truth)

"""Known-answer signals for exercising the port: the flagship mux as
impaired u8 IQ (optionally with TII), at another sample rate, or several
such muxes in one wideband Band III capture; an all-DAB+ multiplex of 17
sub-channels in 9 EEP profiles; the closed-loop ensemble of
the BER sweep; a hard channel batch (streams whose integer CFOs and
sample-clock drifts differ); the robustness set's sync-loss stream and
impaired-span chain; the mixed mux (EEP, UEP and a DAB+
sub-channel of real superframes); the everything-mux's configuration
for the port's ``dabmux``; and coded Viterbi lanes with their messages.

Host-side NumPy, built on the port's copies of the transmitter modules
(``mod.modulator``, ``mod.impairments``, ``mod.convcode``, ``fic``,
``tables``, ``eti.parse``); like the rest of the port it imports no
``jax`` and nothing of ``dabtools_tpu``.  Used by ``chip_smoke.py`` and
the on-card tests.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import pathlib
import time

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.eti.dabplus import SuperframeBuilder, SuperframeDecoder
from dabtools_tpu_torch.eti.parse import EtiParser
from dabtools_tpu_torch.fic.config import (
    Ensemble,
    Service,
    ServiceComponent,
    Subchannel,
)
from dabtools_tpu_torch.fic.fig import build_fibs_for_ensemble
from dabtools_tpu_torch.mod.convcode import conv_encode
from dabtools_tpu_torch.mod.impairments import (
    MultipathChannel,
    awgn,
    carrier_offset,
    multipath,
    quantize_u8,
    timing_offset,
)
from dabtools_tpu_torch.mod.modulator import Modulator, SubchannelSource
from dabtools_tpu_torch.ops.fec import depuncture
from dabtools_tpu_torch.tables.bandiii import BAND_III
from dabtools_tpu_torch.tables.puncturing import FIC_PROFILE, eep_profile


def flagship_ensemble(eid: int = 0x4FFF,
                      label: str = "FLAGSHIP") -> Ensemble:
    """A full Mode I mux: 9 x 128 kbit/s EEP 3-A = 864/864 CUs."""
    subs = tuple(
        Subchannel.eep(i, start_cu=96 * i, level=3, option="A",
                       bitrate_kbps=128)
        for i in range(9))
    svcs = tuple(
        Service(sid=0x100 + i, label=f"SVC {i}", components=(
            ServiceComponent(tmid=0, subchid=i),))
        for i in range(9))
    return Ensemble(eid=eid, subchannels=subs, services=svcs, label=label)


# An all-DAB+ test multiplex, a line-up made up to span the EEP profiles
# rather than one taken from a broadcast: (kbit/s, EEP level, option) per
# sub-channel, contiguous in id order over 864 CUs
DABPLUS17 = ((128, 3, "A"), (96, 3, "A"), (96, 3, "A"), (80, 3, "A"),
             (80, 3, "A"), (80, 3, "A"), (64, 3, "A"), (64, 3, "A"),
             (64, 3, "A"), (64, 3, "A"), (48, 3, "A"), (48, 3, "A"),
             (72, 2, "A"), (56, 2, "A"), (32, 3, "B"), (32, 3, "B"),
             (16, 2, "A"))


def dabplus17_ensemble() -> Ensemble:
    """A full Mode I multiplex of 17 EEP sub-channels in 9 puncturing
    profiles (``DABPLUS17``), one service each."""
    subs, svcs, start = [], [], 0
    for i, (kbps, level, option) in enumerate(DABPLUS17):
        subs.append(Subchannel.eep(i, start_cu=start, level=level,
                                   option=option, bitrate_kbps=kbps))
        start += subs[-1].size_cus
        kind = "DATA" if kbps <= 32 else "DAB+"     # labels of <= 16 chars
        svcs.append(Service(
            sid=0xC2A0 + i, label=f"{kind} {i:02d} {kbps}K {level}{option}",
            components=(ServiceComponent(tmid=0, subchid=i),)))
    return Ensemble(eid=0x1ABC, subchannels=tuple(subs),
                    services=tuple(svcs), label="DABPLUS17")


def closed_loop_ensemble() -> Ensemble:
    """The JAX package's closed-loop ensemble (``build_ensemble`` of
    ``tests/test_closed_loop.py``), the BER sweep's: one EEP 3-A 64
    kbit/s sub-channel.  ``modulate(closed_loop_ensemble(), n,
    np.random.default_rng(seed))`` gives that test's ``modulate(ens, n,
    seed=seed)``: the same payload draws, the same samples."""
    return Ensemble(
        eid=0x4FFF,
        label="TPU DAB",
        subchannels=(Subchannel.eep(1, 0, 3, "A", 64),),
        services=(Service(sid=0x1234, label="SVC ONE", components=(
            ServiceComponent(tmid=0, subchid=1, ascty=0),)),),
    )


MIXED_DABPLUS = 7               # the mixed mux's DAB+ sub-channel
MIXED_DABPLUS_KBPS = 72         # ... and its bitrate


def mixed_ensemble() -> Ensemble:
    """The mixed mux, every protection family in one Mode I ensemble:
    6 x 128 kbit/s EEP 3-A, one UEP sub-channel (Table 31 idx 16: 64
    kbit/s P3) and one DAB+ sub-channel (EEP 3-A 72 kbit/s, ascty=63);
    678/864 CUs."""
    subs = tuple(
        Subchannel.eep(i, start_cu=96 * i, level=3, option="A",
                       bitrate_kbps=128)
        for i in range(6)
    ) + (Subchannel.uep(6, start_cu=576, table_index=16),
         Subchannel.eep(MIXED_DABPLUS, start_cu=624, level=3, option="A",
                        bitrate_kbps=MIXED_DABPLUS_KBPS))
    svcs = tuple(
        Service(sid=0x100 + i, label=f"SVC {i}", components=(
            ServiceComponent(tmid=0, subchid=i,
                             ascty=63 if i == MIXED_DABPLUS else 0),))
        for i in range(8))
    return Ensemble(eid=0x4FFD, subchannels=subs, services=svcs,
                    label="DRYRUN")


def dabplus_superframes(n_cifs: int, rng):
    """``n_cifs`` logical frames of the mixed mux's DAB+ sub-channel: real
    superframes (firecode, RS(120,110), AU CRCs) of random AUs, from the
    port's ``SuperframeBuilder``.  Returns ((n_cifs, 216) uint8 rows, the
    AUs in transmission order)."""
    sfb = SuperframeBuilder(MIXED_DABPLUS_KBPS)
    aus_flat: list[bytes] = []
    sf_rows = []
    for _ in range(n_cifs // C.SUPERFRAME_FRAMES + 1):
        aus = [rng.integers(0, 256, sz, dtype=np.uint8).tobytes()
               for sz in sfb.au_sizes()]
        aus_flat += aus
        sf_rows.append(sfb.build(aus))
    return np.concatenate(sf_rows)[:n_cifs], aus_flat


def check_dabplus(rows: list[bytes], aus: list[bytes]) -> int:
    """Feed the mixed mux's DAB+ logical frames ``rows`` to the port's
    ``SuperframeDecoder``; raises AssertionError unless it gives a run
    of ``aus``, in order, with every CRC good.  Returns the number of
    access units."""
    dec = SuperframeDecoder(MIXED_DABPLUS_KBPS)
    got = [a for r in rows for a in dec.feed(r)]
    if not got or not all(a.crc_ok for a in got):
        raise AssertionError(f"DAB+ decode: {len(got)} AUs, "
                             f"{sum(not a.crc_ok for a in got)} bad CRCs")
    data = [a.data for a in got]
    if data[0] not in aus:
        raise AssertionError("DAB+ decode: first AU is none of the "
                             "builder's")
    k0 = aus.index(data[0])
    if data != aus[k0: k0 + len(data)]:
        raise AssertionError("DAB+ AU stream differs from the builder's")
    return len(got)


def modulate(ens: Ensemble, n_frames: int, rng, tii=None, rows=None):
    """Complex64 baseband of ``n_frames`` Mode I frames of ``ens`` with
    random payloads, and TII ``(sub_id, main_id)`` in the null symbol if
    ``tii`` is given; ``rows`` ({subchid: (>= n_cifs, data_bytes) uint8})
    replaces those sub-channels' random payloads.  Returns (samples,
    {subchid: (n_cifs, data_bytes) uint8})."""
    order = [s.subchid for s in ens.sorted_subchannels()]
    mod = Modulator([SubchannelSource(s.start_cu, s.profile)
                     for s in ens.sorted_subchannels()], tii=tii)
    n_cifs = n_frames * C.MODE_I.n_cifs
    payloads = {sc: np.unpackbits(rng.integers(
        0, 256, size=(n_cifs, ens.subchannel(sc).data_bytes),
        dtype=np.uint8), axis=-1) for sc in order}
    for sc, r in (rows or {}).items():
        payloads[sc] = np.unpackbits(r[:n_cifs], axis=-1)
    x = mod.frames(n_frames, lambda f: build_fibs_for_ensemble(ens, f),
                   lambda f, i: payloads[order[i]][f * 4:(f + 1) * 4])
    return x, {sc: np.packbits(p, axis=-1) for sc, p in payloads.items()}


def impaired_u8(x: np.ndarray, rng, snr_db: float, cfo_hz: float,
                delay: int) -> np.ndarray:
    """AWGN at ``snr_db``, a carrier offset of ``cfo_hz``, ``delay``
    samples of timing offset, then RTL-SDR style u8 interleaved IQ."""
    y = timing_offset(carrier_offset(awgn(x, snr_db, rng), cfo_hz), delay)
    return quantize_u8(y)


def resample_ppm(x: np.ndarray, ppm: float) -> np.ndarray:
    """Linear-interpolation resample modelling a sample-clock offset of
    ``ppm`` parts per million."""
    ratio = 1.0 + ppm * 1e-6
    t_out = np.arange(int(x.size / ratio)) * ratio
    re = np.interp(t_out, np.arange(x.size), x.real)
    im = np.interp(t_out, np.arange(x.size), x.imag)
    return (re + 1j * im).astype(np.complex64)


def sync_loss_stream():
    """The sync-loss stream of the JAX package's robustness tests: 8
    frames of the closed-loop ensemble (seed 5), 4 frames of complex
    Gaussian noise at 0.3 per component (seed 5) and 8 more frames (seed
    6).  Returns (complex64 samples, the set of every sub-channel 1
    payload row sent, as bytes)."""
    ens = closed_loop_ensemble()
    x1, p1 = modulate(ens, 8, np.random.default_rng(5))
    rng = np.random.default_rng(5)
    n = 4 * C.MODE_I.frame_size
    gap = (0.3 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(
        np.complex64)
    x2, p2 = modulate(ens, 8, np.random.default_rng(6))
    sent = {r.tobytes() for r in p1[1]} | {r.tobytes() for r in p2[1]}
    return np.concatenate([x1, gap, x2]), sent


SPAN_CFO_HZ = 2500.0            # the impaired span's CFO: 2.5 carriers
SPAN_PPM = 50.0                 # ... and its sample-clock drift


def impaired_span_signal(x: np.ndarray, seed: int, snr_db: float = 22.0,
                         doppler_hz: float = 0.0) -> np.ndarray:
    """The impairment chain of the JAX package's impaired-sharding tests:
    TU6 (fading at ``doppler_hz``; taps from seed + 1), a CFO of
    ``SPAN_CFO_HZ``, a drift of ``SPAN_PPM`` and AWGN at ``snr_db``
    (seed)."""
    rng = np.random.default_rng(seed)
    ch = MultipathChannel(doppler_hz=doppler_hz,
                          rng=np.random.default_rng(seed + 1))
    y = resample_ppm(carrier_offset(ch(x), SPAN_CFO_HZ), SPAN_PPM)
    return awgn(y, snr_db, rng)


# The hard batch: integer CFO bins -2, 0 and +3, drifts of -50, 0 and +50
# ppm, and the last stream through a static TU6 channel.
HARD_CFO_CARRIERS = (-2.4, 0.3, 3.3)
HARD_PPM = (-50.0, 0.0, 50.0)
HARD_START = (300, 1500, 7000)


def hard_batch(x: np.ndarray, n: int, snr_db: float, rng) -> np.ndarray:
    """The hard batch of one modulation ``x``: 3 streams of ``n``
    samples, each with its own integer CFO, sample-clock drift, start
    inside frame 0 and noise, the last through TU6; (3, n) complex64."""
    xs = []
    for c, (cfo, ppm, st) in enumerate(zip(HARD_CFO_CARRIERS, HARD_PPM,
                                           HARD_START)):
        y = carrier_offset(resample_ppm(x, ppm), cfo * 1000.0)[st:]
        if c == len(HARD_START) - 1:
            y = multipath(y, rng=rng)
        xs.append(awgn(y, snr_db, rng)[:n])
    return np.stack(xs)


def upconvert(baseband: np.ndarray, factor: int, offset_hz: int,
              fs_out: float) -> np.ndarray:
    """Frequency-domain upsample + shift (test synthesis only)."""
    n = baseband.size
    spec = np.fft.fft(baseband)
    wide = np.zeros(n * factor, dtype=np.complex128)
    half = n // 2
    wide[:half] = spec[:half]
    wide[-(n - half):] = spec[half:]
    x = np.fft.ifft(wide) * factor
    t = np.arange(x.size)
    return (x * np.exp(2j * np.pi * offset_hz * t / fs_out)).astype(
        np.complex64)


def fft_resample(x: np.ndarray, n_out: int) -> np.ndarray:
    """Exact spectral resample (test synthesis only)."""
    spec = np.fft.fft(x)
    out = np.zeros(n_out, dtype=np.complex128)
    half = min(x.size, n_out) // 2
    out[:half] = spec[:half]
    out[-half:] = spec[-half:]
    return (np.fft.ifft(out) * n_out / x.size).astype(np.complex64)


def wideband_capture(muxes: dict, center_hz: float, fs: int,
                     n_frames: int, rng):
    """One complex64 capture at ``fs`` centred at ``center_hz`` holding
    each ensemble of ``muxes`` ({Band III block label: Ensemble}) at its
    block's frequency, ``n_frames`` frames each, scaled so the sum has
    the power of one mux.  Returns (capture, {label: payloads as
    :func:`modulate` returns them})."""
    factor = fs // C.SAMPLE_RATE
    wide, payloads = None, {}
    for label, ens in muxes.items():
        x, payloads[label] = modulate(ens, n_frames, rng)
        y = upconvert(x, factor, int(BAND_III[label] - center_hz), fs)
        wide = y if wide is None else wide + y
    return (wide / np.sqrt(len(muxes))).astype(np.complex64), payloads


def flagship_codewords(rng, device, noise: float = 0.35):
    """The flagship block's Viterbi lanes: 64 FIC codewords (768 data
    bits) and 576 EEP 3-A 128 kbit/s codewords (3072 data bits), each
    encoded, punctured, given Gaussian noise and depunctured on
    ``device``.  Returns (messages, soft jobs), one entry per profile."""
    msgs, jobs = [], []
    for prof, count in ((FIC_PROFILE, 64), (eep_profile(3, "A", 128), 576)):
        m = rng.integers(0, 2, size=(count, prof.data_bits), dtype=np.uint8)
        mask = prof.mask().astype(bool)
        tx = np.stack([(1.0 - 2.0 * conv_encode(r))[mask] for r in m])
        tx = (tx + rng.normal(scale=noise, size=tx.shape)).astype(np.float32)
        msgs.append(m)
        jobs.append(depuncture(torch.from_numpy(tx).to(device), prof))
    return msgs, jobs


def first_payload_cif(eti: bytes, payloads: dict) -> int:
    """The CIF index, in ``payloads``, of the first frame of the ETI
    stream ``eti``: where its first sub-channel's bytes occur (random
    payloads make the match unique).  Raises AssertionError if they occur
    nowhere."""
    frame = next(iter(EtiParser().feed(eti)))
    sc = next(iter(payloads))
    data = frame.subchannel_data(sc)
    for n, row in enumerate(payloads[sc]):
        if row.tobytes() == data:
            return n
    raise AssertionError(f"subch {sc} payload of the first ETI frame is "
                         f"none of the modulator's")


def check_eti_payloads(eti: list[bytes], payloads: dict,
                       first_cif: int) -> int:
    """Parse ``eti`` back and hold frame ``k``'s sub-channel data against
    ``payloads[subchid][first_cif + k]``; raises AssertionError on a CRC
    failure or a differing byte.  Returns the number of frames checked."""
    frames = list(EtiParser().feed(b"".join(eti)))
    if len(frames) != len(eti):
        raise AssertionError("ETI frames do not parse back")
    for k, f in enumerate(frames):
        if not (f.header_crc_ok and f.mst_crc_ok):
            raise AssertionError(f"ETI frame {k} CRC")
        for sc, rows in payloads.items():
            if f.subchannel_data(sc) != rows[first_cif + k].tobytes():
                raise AssertionError(f"subch {sc} payload differs at CIF "
                                     f"{first_cif + k}")
    return len(frames)


# ------------------------------------------------------------ lab chain
EVERYTHING_OBJECT_SEED = 42     # the MOT object's bytes: default_rng(42)
EVERYTHING_OBJECT_BYTES = 700
LAB_CIFS = 100                  # the lab chain's mux, as the JAX test's
LAB_BLOCK_FRAMES = 16           # dab2eti's block in the lab chain
# etiinfo's lines, and eti2audio --labels', that the everything-mux's
# metadata must give off air (tests/test_everything_mux.py)
EVERYTHING_INFO = ("PTy Pop Music", "English", "German",
                   "linkage set 0x0AA", "DAB ensemble 0xE7E7 -> 225.648 MHz",
                   "service 0x1111 also in ensemble(s): 0xBEEF",
                   "FEC RS(204,188)", "time 2026-01-01")
EVERYTHING_LABELS = ("dynamic label: 'Blur - Song 2'", "ITEM.ARTIST='Blur'")


def everything_object() -> bytes:
    """The everything-mux's MOT object: 700 random bytes."""
    return np.random.default_rng(EVERYTHING_OBJECT_SEED).integers(
        0, 256, EVERYTHING_OBJECT_BYTES, dtype=np.uint8).tobytes()


def everything_mux(obj_path) -> dict:
    """The ``dabmux`` configuration of the everything-mux
    (``tests/test_everything_mux.py``): MP2 64 kbit/s with DLS and DL
    Plus, DAB+ 72 kbit/s and a 32 kbit/s FEC packet service carrying the
    MOT object at ``obj_path``, with language/PTy, linkage, frequency
    information, OE and time."""
    return {
        "eid": "0xE7E7", "label": "EVERYTHING", "time": True,
        "frequency_info": [
            {"id": "0xE7E7", "frequencies_hz": [225648000]}],
        "linkage": [{"lsn": "0x0AA", "ids": ["0x1111"], "idlq": 0}],
        "services": [
            {"sid": "0x1111", "label": "POPPLUS", "type": "mp2",
             "subch": {"id": 1, "start_cu": 0, "protection": "EEP-3A",
                       "bitrate": 64},
             "source": "prbs", "dls": "Blur - Song 2",
             "dlplus": {"artist": "Blur", "title": "Song 2"},
             "language": 9, "pty": 10,
             "also_in_ensembles": ["0xBEEF"]},
            {"sid": "0x2222", "label": "NEWSAAC", "type": "dab+",
             "subch": {"id": 2, "start_cu": 48, "protection": "EEP-3A",
                       "bitrate": 72}, "source": "prbs"},
            {"sid": "0xE1C00077", "label": "EPGDATA", "type": "packet",
             "subch": {"id": 3, "start_cu": 102, "protection": "EEP-3A",
                       "bitrate": 32},
             "scid": 5, "address": 17, "objects": [str(obj_path)],
             "fec": True, "language": 8},
        ],
    }


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_cli(main, argv: list[str]) -> tuple[str, list[str]]:
    """``main(argv)`` of one of the port's commands, in this process:
    (its standard output, the messages it logged at INFO and above).
    Raises AssertionError if it returns non-zero."""
    root = logging.getLogger()
    grab, level = _Messages(), root.level
    root.addHandler(grab)
    root.setLevel(logging.INFO)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        root.removeHandler(grab)
        root.setLevel(level)
    if rc:
        raise AssertionError(f"{main.__module__} {argv} exited {rc}: "
                             f"{grab.lines[-3:]}")
    return out.getvalue(), grab.lines


def lab_chain(tmp: pathlib.Path, torch_device: str) -> dict:
    """The repo's lab chain on the everything-mux, through the port's
    commands only, in this process and in ``tmp``: ``dabmux --cifs
    LAB_CIFS`` -> ``eti2iq --format u8 --snr 16 --cfo-hz 420`` ->
    ``dab2eti --format u8`` on ``torch_device`` (``LAB_BLOCK_FRAMES``-frame
    blocks) -> ``etiinfo``, ``eti2audio --all`` and ``eti2audio --sid
    0x1111 --labels``.

    Raises AssertionError unless every off-air ETI frame has good header
    and MST CRCs and carries sub-channels 1-3 of the dabmux ETI from the
    receiver's activation CIF on, FIG 0/14 came through, ``epg.bin`` is
    the MOT object byte for byte beside an ``.mp2`` and an ``.aac`` file,
    and the DLS, DL Plus and ``etiinfo`` metadata lines appear.  Returns
    the off-air frame count, ``dab2eti``'s receiver and its device steps,
    its seconds (host clock, file to file) and the air time of the
    capture in seconds."""
    from dabtools_tpu_torch.cli import (
        dab2eti,
        dabmux,
        eti2audio,
        eti2iq,
        etiinfo,
    )
    obj = tmp / "epg.bin"
    obj.write_bytes(everything_object())
    cfg = tmp / "mux.json"
    cfg.write_text(json.dumps(everything_mux(obj)))
    eti, iq, offair = tmp / "mux.eti", tmp / "mux.u8", tmp / "offair.eti"
    run_cli(dabmux.main, [str(cfg), "--cifs", str(LAB_CIFS), "-o",
                          str(eti)])
    run_cli(eti2iq.main, ["--format", "u8", "--snr", "16", "--cfo-hz",
                          "420", str(eti), "-o", str(iq)])

    # the receiver the command builds, kept to read its activation CIF
    # and device steps
    receivers = []
    real = dab2eti.DabReceiver

    def recorded(*args, **kwargs):
        receivers.append(real(*args, **kwargs))
        return receivers[-1]

    dab2eti.DabReceiver = recorded
    try:
        t0 = time.perf_counter()
        run_cli(dab2eti.main, [
            "--torch-device", torch_device, "--format", "u8",
            "--frames-per-block", str(LAB_BLOCK_FRAMES), str(iq), "-o",
            str(offair)])
        seconds = time.perf_counter() - t0
    finally:
        dab2eti.DabReceiver = real
    rx, = receivers
    if rx.ensemble is None or rx.ensemble.eid != 0xE7E7:
        raise AssertionError("dab2eti: no or a wrong ensemble")
    if rx.ensemble.fec_scheme(3) != 1:
        raise AssertionError("FIG 0/14 (packet FEC) did not come through")
    src = list(EtiParser().feed(eti.read_bytes()))
    got = list(EtiParser().feed(offair.read_bytes()))
    a = rx._activation_cif
    if not got or a + len(got) > len(src):
        raise AssertionError(f"{len(got)} off-air ETI frames from CIF {a} "
                             f"of {len(src)}")
    for k, f in enumerate(got):
        if not (f.header_crc_ok and f.mst_crc_ok):
            raise AssertionError(f"off-air ETI frame {k} CRC")
        for sc in (1, 2, 3):
            if f.subchannel_data(sc) != src[a + k].subchannel_data(sc):
                raise AssertionError(f"subch {sc} differs at off-air frame "
                                     f"{k} (CIF {a + k})")

    info, _ = run_cli(etiinfo.main, [str(offair)])
    missing = [s for s in EVERYTHING_INFO if s not in info]
    if missing:
        raise AssertionError(f"etiinfo lacks {missing}")
    run_cli(eti2audio.main, ["--all", str(tmp / "all"), str(offair)])
    files = {p.name: p for p in (tmp / "all").rglob("*") if p.is_file()}
    if not (any(n.endswith(".mp2") for n in files)
            and any(n.endswith(".aac") for n in files)):
        raise AssertionError(f"eti2audio --all wrote {sorted(files)}")
    if ("epg.bin" not in files
            or files["epg.bin"].read_bytes() != everything_object()):
        raise AssertionError("epg.bin is not the MOT object")
    _, labels = run_cli(eti2audio.main, [
        "--sid", "0x1111", "--labels", str(offair), "-o",
        str(tmp / "pop.mp2")])
    missing = [s for s in EVERYTHING_LABELS
               if not any(s in line for line in labels)]
    if missing:
        raise AssertionError(f"eti2audio --labels lacks {missing}")
    return {"frames": len(got), "receiver": rx,
            "device_steps": rx.device_steps,
            "dab2eti_s": seconds,
            "air_s": iq.stat().st_size / 2 / C.SAMPLE_RATE}

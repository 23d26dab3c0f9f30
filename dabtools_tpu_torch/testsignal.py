"""Known-answer signals for exercising the port: the flagship mux as
impaired u8 IQ (optionally with TII), at another sample rate, or several
such muxes in one wideband Band III capture; the mixed mux (EEP, UEP and
a DAB+ sub-channel of real superframes); and coded Viterbi lanes with
their messages.

Host-side NumPy, built on the port's copies of the transmitter modules
(``mod.modulator``, ``mod.impairments``, ``mod.convcode``, ``fic``,
``tables``, ``eti.parse``); like the rest of the port it imports no
``jax`` and nothing of ``dabtools_tpu``.  Used by ``chip_smoke.py`` and
the on-card tests.
"""

from __future__ import annotations

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
    awgn,
    carrier_offset,
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

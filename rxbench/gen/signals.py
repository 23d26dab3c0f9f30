"""Signal builders: frozen copies of the port's ``testsignal.py``
``flagship_ensemble``, ``modulate``, ``upconvert``, ``fft_resample`` and
``wideband_capture``, verbatim but for their import lines."""

from __future__ import annotations

import numpy as np

from . import constants as C
from .bandiii import BAND_III
from .config import Ensemble, Service, ServiceComponent, Subchannel
from .fig import build_fibs_for_ensemble
from .modulator import Modulator, SubchannelSource


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

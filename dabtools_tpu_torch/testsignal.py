"""Known-answer signals for exercising the port: the flagship mux as
impaired u8 IQ, and coded Viterbi lanes with their messages.

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
from dabtools_tpu_torch.tables.puncturing import FIC_PROFILE, eep_profile


def flagship_ensemble() -> Ensemble:
    """A full Mode I mux: 9 x 128 kbit/s EEP 3-A = 864/864 CUs."""
    subs = tuple(
        Subchannel.eep(i, start_cu=96 * i, level=3, option="A",
                       bitrate_kbps=128)
        for i in range(9))
    svcs = tuple(
        Service(sid=0x100 + i, label=f"SVC {i}", components=(
            ServiceComponent(tmid=0, subchid=i),))
        for i in range(9))
    return Ensemble(eid=0x4FFF, subchannels=subs, services=svcs,
                    label="FLAGSHIP")


def modulate(ens: Ensemble, n_frames: int, rng):
    """Complex64 baseband of ``n_frames`` Mode I frames of ``ens`` with
    random payloads; returns (samples, {subchid: (n_cifs, data_bytes)
    uint8})."""
    order = [s.subchid for s in ens.sorted_subchannels()]
    mod = Modulator([SubchannelSource(s.start_cu, s.profile)
                     for s in ens.sorted_subchannels()])
    n_cifs = n_frames * C.MODE_I.n_cifs
    payloads = {sc: np.unpackbits(rng.integers(
        0, 256, size=(n_cifs, ens.subchannel(sc).data_bytes),
        dtype=np.uint8), axis=-1) for sc in order}
    x = mod.frames(n_frames, lambda f: build_fibs_for_ensemble(ens, f),
                   lambda f, i: payloads[order[i]][f * 4:(f + 1) * 4])
    return x, {sc: np.packbits(p, axis=-1) for sc, p in payloads.items()}


def impaired_u8(x: np.ndarray, rng, snr_db: float, cfo_hz: float,
                delay: int) -> np.ndarray:
    """AWGN at ``snr_db``, a carrier offset of ``cfo_hz``, ``delay``
    samples of timing offset, then RTL-SDR style u8 interleaved IQ."""
    y = timing_offset(carrier_offset(awgn(x, snr_db, rng), cfo_hz), delay)
    return quantize_u8(y)


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

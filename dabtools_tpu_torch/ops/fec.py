"""Device-side FEC plumbing: depuncture, descramble, time-deinterleave.

Port of ``dabtools_tpu/ops/fec.py``.  Every table becomes an index or bit
tensor cached per ``(key, device)``.  The deinterleaver ring is explicit
state that the receiver carries across blocks on its device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.tables.puncturing import (
    PuncturingProfile,
    puncture_mask_for_profile,
)
from dabtools_tpu_torch.tables.time_interleave import DELAYS
from dabtools_tpu_torch.utils.prbs import energy_dispersal_bits


@functools.cache
def depuncture_gather_map(profile: PuncturingProfile) -> np.ndarray:
    """int64 (mother_bits,): index into the tx-bit stream, or ``tx_bits``
    (sentinel -> reads a zero pad) for punctured positions."""
    mask = puncture_mask_for_profile(profile)
    idx = np.full(mask.size, profile.tx_bits, dtype=np.int64)
    idx[mask.astype(bool)] = np.arange(int(mask.sum()), dtype=np.int64)
    return idx


@functools.cache
def _depuncture_index(profile: PuncturingProfile,
                      device: torch.device) -> torch.Tensor:
    return torch.from_numpy(depuncture_gather_map(profile)).to(device)


def depuncture(soft_tx: torch.Tensor,
               profile: PuncturingProfile) -> torch.Tensor:
    """(batch, tx_bits) soft bits -> (batch, mother_bits) with 0 erasures."""
    padded = torch.cat([soft_tx, soft_tx.new_zeros(*soft_tx.shape[:-1], 1)],
                       dim=-1)
    return padded.index_select(-1, _depuncture_index(profile,
                                                     soft_tx.device))


@functools.cache
def _prbs(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(energy_dispersal_bits(n).copy()).to(device)


def descramble(bits: torch.Tensor) -> torch.Tensor:
    """XOR decoded hard bits (..., n) uint8 with the energy-dispersal PRBS."""
    return torch.bitwise_xor(bits, _prbs(bits.shape[-1], bits.device))


# ------------------------------------------------------------ deinterleave
@functools.cache
def _lag_rows(n_cifs: int, n_bits: int, device: torch.device) -> torch.Tensor:
    """(n_cifs, n_bits) int64: row of the stream H (15 history rows, then
    the new CIFs) that output CIF j, bit i reads: ``15 + j + d(i) - 15``
    with d(i) = DELAYS[i mod 16]."""
    off = DELAYS[np.arange(n_bits) % 16].astype(np.int64) - 15
    rows = 15 + np.arange(n_cifs, dtype=np.int64)[:, None] + off[None, :]
    return torch.from_numpy(rows).to(device)


def time_deinterleave(ring: torch.Tensor, cif_count: torch.Tensor,
                      coded: torch.Tensor):
    """De-interleave a run of received coded CIF contributions, of one
    stream or of each of B streams.

    ``ring``: (..., 16, n_bits) float32, the last 16 received CIFs, slot
    ``k`` holding the received CIF with global index ``== k (mod 16)``.
    ``cif_count``: integer tensor, global index of the first CIF in
    ``coded``: 0-dim (shared by the streams) or (B,) (one per stream).
    ``coded``: (..., n_cifs, n_bits) newly received coded CIFs.  The
    leading shape ``...`` is () or (B,), the same for ``ring`` and
    ``coded``.

    Returns ``(new_ring, out)``; ``out[..., j, :]`` is logical frame
    ``cif_count + j - 15`` (garbage for global index < 15, the 384 ms
    startup transient).  ``out[..., j, i]`` is the received stream at
    global CIF ``cif_count + j + d(i) - 15``: one direct per-lane lag
    gather from the stream H = [15 history rows from the ring | coded].
    """
    *lead, n_cifs, n_bits = coded.shape
    dev = coded.device
    c = cif_count.to(torch.int64)[..., None]                 # (..., 1)
    hist_rows = torch.remainder(c - 15 + torch.arange(15, device=dev), 16)
    hist = ring.gather(-2, hist_rows[..., None].expand(*lead, 15, n_bits))
    H = torch.cat([hist, coded], dim=-2)
    out = H.gather(-2, _lag_rows(n_cifs, n_bits, dev).expand(
        *lead, n_cifs, n_bits))
    # New ring: slot s holds the most recent global index == s (mod 16).
    glast = c + n_cifs - 1
    g_s = glast - torch.remainder(glast - torch.arange(16, device=dev), 16)
    new_ring = H.gather(-2, (g_s - (c - 15))[..., None].expand(
        *lead, 16, n_bits))
    return new_ring, out


def init_deinterleave_ring(n_bits: int, device) -> torch.Tensor:
    return torch.zeros((C.TIME_INTERLEAVE_DEPTH, n_bits),
                       dtype=torch.float32, device=device)

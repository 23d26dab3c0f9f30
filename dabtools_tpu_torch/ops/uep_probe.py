"""Signal-driven identification of a missing UEP Table 33 row.

Port of ``dabtools_tpu/ops/uep_probe.py`` on the ported Viterbi: every
constraint-satisfying candidate row (``tables.puncturing.
enumerate_uep_candidates``) depunctures the sub-channel's deinterleaved
soft rows, all candidates x rows decode in ONE batched Viterbi call, and
the row whose path metric wins on every row by a margin is accepted.  See
the JAX module for the calibration of ``margin`` and ``floor``.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from dabtools_tpu_torch.ops.fec import depuncture_gather_map
from dabtools_tpu_torch.ops.viterbi import viterbi_decode
from dabtools_tpu_torch.tables.puncturing import PuncturingProfile

log = logging.getLogger("dabtools_tpu_torch.uep_probe")


def _metrics_batched(aligned: torch.Tensor,
                     profiles: tuple[PuncturingProfile, ...]
                     ) -> torch.Tensor:
    """(n_rows, tx_bits) soft rows -> (n_cand, n_rows) normalized path
    metrics, one batched Viterbi call over all candidates x rows.
    Metrics are normalized by sum|soft| per row."""
    maps = torch.from_numpy(np.stack(
        [depuncture_gather_map(p) for p in profiles])).to(aligned.device)
    padded = torch.cat([aligned, aligned.new_zeros(aligned.shape[0], 1)],
                       dim=-1)
    dep = padded[:, maps]                               # (R, C, mother)
    stacked = dep.transpose(0, 1).reshape(
        len(profiles) * aligned.shape[0], -1)
    _, metric = viterbi_decode(stacked)
    ceil = aligned.abs().sum(-1)                        # (n_rows,)
    return metric.reshape(len(profiles), -1) / ceil[None, :]


def candidate_metrics(aligned_soft, profiles: Sequence[PuncturingProfile],
                      device) -> np.ndarray:
    """Normalized per-candidate, per-row path metrics (host ndarray),
    computed on ``device``."""
    aligned = torch.as_tensor(np.asarray(aligned_soft, dtype=np.float32),
                              device=device)
    if aligned.ndim == 1:
        aligned = aligned[None]
    return _metrics_batched(aligned, tuple(profiles)).cpu().numpy()


def identify_uep_profile(aligned_soft,
                         profiles: Sequence[PuncturingProfile],
                         device, *, margin: float = 0.002,
                         floor: float = 0.80) -> tuple[int | None, dict]:
    """Pick the candidate the signal was punctured with, or None.

    ``aligned_soft``: (n_rows, tx_bits) fully-primed deinterleaved soft
    rows of the sub-channel.  Accepts index i iff candidate i wins on
    EVERY row, its mean normalized metric clears ``floor``, and it beats
    the runner-up's mean by ``margin``.  Returns ``(index_or_None,
    diagnostics)``.
    """
    if len(profiles) < 2:
        # With one candidate the per-row-win and margin tests cannot bind;
        # refuse rather than rubber-stamp.
        return None, {"best": None, "n_candidates": len(profiles),
                      "reason": "need >= 2 candidate profiles for the "
                                "per-row-win/margin tests to bind"}
    m = candidate_metrics(aligned_soft, profiles, device)   # (n_cand, rows)
    mean = m.mean(axis=1)
    order = np.argsort(mean)[::-1]
    best, second = int(order[0]), int(order[1])
    per_row_win = bool((m[best] >= m.max(axis=0) - 1e-6).all())
    gap = float(mean[best] - mean[second])
    diag = {
        "best": best, "best_metric": float(mean[best]),
        "runner_up": second, "runner_up_metric": float(mean[second]),
        "gap": gap, "per_row_win": per_row_win,
        "n_rows": int(m.shape[1]), "n_candidates": int(m.shape[0]),
    }
    ok = per_row_win and mean[best] >= floor and gap >= margin
    if ok:
        log.info("UEP row identified from signal: %s (metric %.3f, "
                 "runner-up %.3f, gap %.3f over %d rows)",
                 profiles[best].name, mean[best], mean[second], gap,
                 m.shape[1])
    return (best if ok else None), diag

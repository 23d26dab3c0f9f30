"""Batched soft-decision Viterbi for the DAB K=7 rate-1/4 code, radix-4.

Port of ``dabtools_tpu/ops/viterbi.py`` and of the lane-batch glue of
``dabtools_tpu/ops/viterbi_pallas4.py``.  Two trellis steps are fused per
iteration: after inputs (u1, u2) state s reaches t = u2<<5 | u1<<4 | s>>2,
so target t has the 4 predecessors ``4*(t&15) + p``.

Dispatch is by the tensor's device:

* a CUDA tensor goes to the hand-written kernels of ``viterbi_cuda``
  (K1 ``acs4``, K2 ``traceback4``) or the call raises;
* a CPU tensor goes to the plain PyTorch versions here, ``acs4_plain``
  and ``traceback4_plain``, which compute exactly what K1 and K2 compute:
  the same branch-metric summation order, the same strict ``>`` select
  (ties take the lower predecessor), the same packed decision words.

Conventions (shared with ``mod.convcode``): soft > 0 means coded bit 0;
erasures (punctured positions) are exactly 0.  Codewords have an even
trellis length T = data_bits + 6, which radix-4 requires; odd T would
need the radix-2 kernels, which are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dabtools_tpu import constants as C
from dabtools_tpu.mod.convcode import output_table

NEG_INF = -1e30

_ODD_T = ("odd trellis lengths need the radix-2 Viterbi kernels (K3/K4), "
          "which are not ported yet: see ROADMAP.md, Queue 2")

# Double steps the plain ACS handles per chunk (bounds its branch-metric
# and decision scratch at (8, 256, B) float32 and (B, 8, 64) int64).
_STEP_CHUNK = 8


@functools.cache
def transition_matrix() -> np.ndarray:
    """W: (128, 4) float32; row ``4*c + 2*b + u`` is the +/-1 pattern of the
    coded bits on the transition (state=2c+b) --input u--> (u*32 + c)."""
    table = output_table()  # out[reg] -> 4 bits, reg = (u << 6) | state
    w = np.empty((128, 4), dtype=np.float32)
    for c in range(32):
        for b in range(2):
            for u in range(2):
                reg = (u << 6) | (2 * c + b)
                w[4 * c + 2 * b + u] = 1.0 - 2.0 * table[reg]
    return w


@functools.cache
def acs_radix4_matrices():
    """Radix-4 ACS operators.  ``PU4`` (256, 64) row ``p*64+t`` picks
    predecessor p of target t; ``WS4`` (256, 8) holds the +/-1 pattern of
    the 8 coded bits along that 2-step path (first step's 4 bits, then the
    second's)."""
    table = output_table()
    pu4 = np.zeros((256, 64), dtype=np.float32)
    ws4 = np.empty((256, 8), dtype=np.float32)
    for t in range(64):
        u2, u1 = t >> 5, (t >> 4) & 1
        for p in range(4):
            pred = 4 * (t & 15) + p
            mid = (u1 << 5) | (pred >> 1)
            reg1 = (u1 << 6) | pred
            reg2 = (u2 << 6) | mid
            r = p * 64 + t
            pu4[r, pred] = 1.0
            ws4[r, :4] = 1.0 - 2.0 * table[reg1]
            ws4[r, 4:] = 1.0 - 2.0 * table[reg2]
    return pu4, ws4


@functools.cache
def _ws4(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(acs_radix4_matrices()[1]).to(device)


def _signed_sums(s4: torch.Tensor) -> torch.Tensor:
    """(G, 4, B) -> (G, 16, B): row ``8*n0 + 4*n1 + 2*n2 + n3`` is
    ``((+/-s0 +/- s1) +/- s2) +/- s3``, with s_k negated iff n_k, summed left to
    right."""
    acc = torch.stack([s4[:, 0], -s4[:, 0]], dim=1)
    for k in range(1, 4):
        sk = s4[:, k:k + 1]
        acc = torch.stack([acc + sk, acc - sk], dim=2).flatten(1, 2)
    return acc


def branch_metrics(soft8: torch.Tensor, ws4: torch.Tensor) -> torch.Tensor:
    """(G, 8, B) soft bits -> (G, 256, B) fused 2-step branch metrics.

    Row r of ``ws4`` (+/-1 signs) gives ``bm[r] = (w0 s0 + w1 s1 + w2 s2
    + w3 s3) + (w4 s4 + w5 s5 + w6 s6 + w7 s7)``: each step's 4 signed
    terms summed left to right, then the two steps' sums added, the order
    the CUDA kernel uses, so the two agree bit for bit.  Each step has
    only 16 sign patterns, so the 256 rows gather from two (G, 16, B)
    tables of partial sums."""
    neg = (ws4 < 0).to(torch.int64)
    i1 = 8 * neg[:, 0] + 4 * neg[:, 1] + 2 * neg[:, 2] + neg[:, 3]
    i2 = 8 * neg[:, 4] + 4 * neg[:, 5] + 2 * neg[:, 6] + neg[:, 7]
    return (_signed_sums(soft8[:, :4]).index_select(1, i1)
            + _signed_sums(soft8[:, 4:]).index_select(1, i2))


def pack_decisions(d: torch.Tensor) -> torch.Tensor:
    """(..., 64) 2-bit decisions -> (..., 4) int32 words: word ``2w +
    plane`` holds bit ``plane`` of the decision of state ``32w + j`` at
    bit j (the layout of K1's two ballots per warp)."""
    bits = d.to(torch.int64).reshape(*d.shape[:-1], 2, 32)
    shifts = torch.arange(32, device=d.device)
    lo = ((bits & 1) << shifts).sum(-1)
    hi = ((bits >> 1) << shifts).sum(-1)
    words = torch.stack([lo, hi], dim=-1).reshape(*d.shape[:-1], 4)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def acs4_plain(soft8: torch.Tensor, t2: torch.Tensor, ws4: torch.Tensor):
    """Plain PyTorch version of K1 (``viterbi_cuda.acs4``).

    ``soft8``: (B, T2, 8) float32, ``t2``: (B,) int32 lane lengths in
    double steps, ``ws4``: (256, 8) float32.  A step ``g >= t2[lane]``
    freezes the lane's path metrics and records decision 0.  Returns
    ``(dec, metric)``: dec (B, T2, 4) int32 packed decisions (see
    :func:`pack_decisions`), metric (B,) float32 = final ``pm[0]``.

    Works lane-last, (states, lanes), as the TPU kernel does, so every
    per-step op runs over contiguous lanes.
    """
    b, t2_max, _ = soft8.shape
    dev = soft8.device
    soft = soft8.permute(1, 2, 0).contiguous()             # (T2, 8, B)
    pm = torch.full((64, b), NEG_INF, dtype=torch.float32, device=dev)
    pm[0] = 0.0
    live = (torch.arange(t2_max, device=dev)[:, None]
            < t2.to(torch.int64)[None, :])                 # (T2, B)
    dec = torch.empty((b, t2_max, 4), dtype=torch.int32, device=dev)
    for g0 in range(0, t2_max, _STEP_CHUNK):
        bm = branch_metrics(soft[g0:g0 + _STEP_CHUNK], ws4)   # (G, 256, B)
        d_chunk = torch.empty((bm.shape[0], 64, b), dtype=torch.uint8,
                              device=dev)
        for j in range(bm.shape[0]):
            # candidate p of target t = 16*hi + a reads pm[4a + p]: a view
            # of pm as (a, p), transposed and broadcast over hi
            pred = pm.view(16, 4, b).transpose(0, 1)[:, None]
            c = (pred + bm[j].view(4, 4, 16, b)).reshape(4, 64, b)
            c0, c1, c2, c3 = c.unbind(0)
            d01 = c1 > c0
            m01 = torch.where(d01, c1, c0)
            d23 = c3 > c2
            m23 = torch.where(d23, c3, c2)
            hi = m23 > m01
            new = torch.where(hi, m23, m01)
            d = torch.where(hi, 2 + d23.to(torch.uint8), d01.to(torch.uint8))
            lv = live[g0 + j]
            pm = torch.where(lv, new, pm)
            d_chunk[j] = torch.where(lv, d, 0)
        dec[:, g0:g0 + bm.shape[0]] = pack_decisions(
            d_chunk.permute(2, 0, 1))
    return dec, pm[0].clone()


def traceback4_plain(dec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2 (``viterbi_cuda.traceback4``).

    ``dec``: (B, T2, 4) int32 packed decisions.  Walks each lane's state
    from 0 at the last double step; step g emits bits ``2g`` = (t>>4)&1
    and ``2g+1`` = (t>>5)&1, then moves to ``4*(t&15) + d(t)``.  Returns
    (B, 2*T2) uint8.
    """
    b, t2_max, _ = dec.shape
    words = dec.to(torch.int64)
    state = torch.zeros(b, dtype=torch.int64, device=dec.device)
    states = torch.empty((b, t2_max), dtype=torch.int64, device=dec.device)
    for g in range(t2_max - 1, -1, -1):
        states[:, g] = state
        w = state >> 5
        lo = words[:, g].gather(1, (2 * w)[:, None])[:, 0]
        hi = words[:, g].gather(1, (2 * w + 1)[:, None])[:, 0]
        j = state & 31
        d = ((lo >> j) & 1) | (((hi >> j) & 1) << 1)
        state = 4 * (state & 15) + d
    bits = torch.stack([(states >> 4) & 1, (states >> 5) & 1], dim=-1)
    return bits.reshape(b, 2 * t2_max).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _lane_t2(lengths: bytes, device: torch.device) -> torch.Tensor:
    """(lanes,) int32 double-step lengths on ``device`` from int64 trellis
    lengths, cached so a steady stream uploads nothing per block."""
    t2 = np.frombuffer(lengths, dtype=np.int64) // 2
    return torch.from_numpy(t2.astype(np.int32)).to(device)


def _decode4(soft: torch.Tensor, t2: torch.Tensor):
    """(B, 4*T) right-padded soft bits (T even), (B,) int32 lane lengths
    in double steps -> bits (B, T) uint8, metric (B,) float32."""
    b, n4 = soft.shape
    soft8 = soft.reshape(b, n4 // 8, 8)
    if soft.is_cuda:
        from dabtools_tpu_torch.ops import viterbi_cuda
        dec, metric = viterbi_cuda.acs4(soft8, t2, _ws4(soft.device))
        return viterbi_cuda.traceback4(dec), metric
    if soft.device.type != "cpu":
        raise ValueError(f"no Viterbi for device {soft.device}")
    dec, metric = acs4_plain(soft8, t2, _ws4(soft.device))
    return traceback4_plain(dec), metric


def viterbi_decode4(soft: torch.Tensor, lengths=None):
    """Decode a lane batch of mother codewords with per-lane lengths.

    ``soft``: (batch, 4*T) float32, T even.  ``lengths`` (optional):
    (batch,) ints, each lane's trellis length (incl. tail), even, positive
    and <= T; short lanes are zero-padded on the right.  Lane k's
    information bits are ``bits[k, :lengths[k] - 6]``; positions beyond
    are zeros.  Returns ``(bits (batch, T-6) uint8, metric (batch,))``.
    """
    if soft.ndim != 2:
        raise ValueError("expected (batch, 4*T) soft bits")
    t_max = soft.shape[-1] // 4
    if soft.shape[-1] % 4 or t_max % 2:
        raise ValueError("radix-4 decode requires an even codeword length")
    if lengths is None:
        ln = np.full(soft.shape[0], t_max, dtype=np.int64)
    else:
        ln = np.asarray(lengths, dtype=np.int64)
        if ln.shape != (soft.shape[0],):
            raise ValueError("lengths must be (batch,)")
        if (ln % 2).any() or (ln > t_max).any() or (ln <= 0).any():
            raise ValueError("each lane length must be even, positive and "
                             "<= the padded codeword length")
    t2 = _lane_t2(ln.tobytes(), soft.device)
    bits, metric = _decode4(soft.to(torch.float32).contiguous(), t2)
    return bits[:, : t_max - C.TAIL_BITS], metric


def viterbi_decode(soft: torch.Tensor):
    """Decode a batch of mother codewords.

    ``soft``: (batch, 4*(n+6)) or (4*(n+6),) float32, positive => coded
    bit 0, 0 = erasure.  Returns ``(bits, metric)``: bits (batch, n) uint8
    information bits (tail stripped); metric (batch,) float32, the winning
    path's correlation with the received soft bits.
    """
    squeeze = soft.ndim == 1
    if squeeze:
        soft = soft[None]
    if soft.shape[-1] % 4:
        raise ValueError("mother codeword length must be a multiple of 4")
    if (soft.shape[-1] // 4) % 2:
        raise NotImplementedError(_ODD_T)
    bits, metric = viterbi_decode4(soft)
    return (bits[0], metric[0]) if squeeze else (bits, metric)


def ragged_lanes(softs):
    """Sequence of (batch_i, 4*T_i) soft-bit tensors -> one right-padded
    (sum batch_i, 4*max T_i) float32 lane batch and its (lanes,) int64
    NumPy vector of per-lane trellis lengths."""
    if any(s.ndim != 2 or s.shape[-1] % 4 for s in softs):
        raise ValueError("each batch must be (batch_i, 4*T_i) soft bits")
    ts = [s.shape[-1] // 4 for s in softs]
    if any(t % 2 for t in ts):
        raise NotImplementedError(_ODD_T)
    n4_max = max(s.shape[-1] for s in softs)
    soft = torch.cat([torch.nn.functional.pad(s.to(torch.float32),
                                              (0, n4_max - s.shape[-1]))
                      for s in softs], dim=0)
    lengths = np.concatenate([np.full(s.shape[0], t, np.int64)
                              for s, t in zip(softs, ts)])
    return soft, lengths


def viterbi_decode_ragged(softs):
    """Decode several codeword batches of (possibly) different lengths as
    ONE dispatch.

    ``softs``: sequence of (batch_i, 4*T_i) soft-bit tensors on one
    device.  The batches are right-padded to the longest T, concatenated
    along lanes and decoded with a per-lane length vector, so FIC and
    every MSC profile group share one ACS chain.  Returns a list of
    ``(bits_i, metric_i)`` in the same order, each equal to
    ``viterbi_decode(softs[i])``.
    """
    softs = list(softs)
    if not softs:
        return []
    soft, lengths = ragged_lanes(softs)
    bits, metric = viterbi_decode4(soft, lengths)
    out, o = [], 0
    for s in softs:
        t = s.shape[-1] // 4
        b = s.shape[0]
        out.append((bits[o: o + b, : t - C.TAIL_BITS], metric[o: o + b]))
        o += b
    return out

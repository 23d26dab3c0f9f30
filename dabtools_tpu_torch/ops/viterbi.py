"""Batched soft-decision Viterbi for the DAB K=7 rate-1/4 code.

Port of ``dabtools_tpu/ops/viterbi.py`` and of the lane-batch glue of
``dabtools_tpu/ops/viterbi_pallas4.py`` and ``viterbi_pallas.py``.  An
even trellis length T decodes radix-4: two trellis steps are fused per
iteration, and after inputs (u1, u2) state s reaches t = u2<<5 | u1<<4 |
s>>2, so target t has the 4 predecessors ``4*(t&15) + p``.  An odd T
decodes radix-2: target ``t = u*32 + c`` has the predecessors ``2c``
and ``2c+1``.

Dispatch is by the tensor's device:

* a CUDA tensor goes to the hand-written kernels of ``viterbi_cuda``
  (K1 ``acs4``, K2 ``traceback4`` or K2' ``traceback4_onehot64``; K3
  ``acs2``, K4 ``traceback2``) or the call raises;
* a CPU tensor goes to the plain PyTorch versions here (``acs4_plain``,
  ``traceback4_plain``, ``traceback4_onehot64_plain``, ``acs2_plain``,
  ``traceback2_plain``), which
  compute exactly what the kernels compute: the same branch-metric
  summation order, the same strict ``>`` select (ties take the lower
  predecessor), the same packed decision words.

Conventions (shared with ``mod.convcode``): soft > 0 means coded bit 0;
erasures (punctured positions) are exactly 0.  Codewords have a trellis
length T = data_bits + 6.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.mod.convcode import output_table

NEG_INF = -1e30

TRACEBACKS = ("factored", "onehot64")

# Double steps the plain radix-4 ACS handles per chunk (bounds its
# branch-metric and decision scratch at (8, 256, B) float32 and (B, 8, 64)
# int64); the radix-2 one takes twice as many single steps.
_STEP_CHUNK = 8


@functools.cache
def ws4_table() -> np.ndarray:
    """K1's branch-metric signs, (256, 8) float32: row ``p*64 + t`` holds
    the +/-1 pattern of the 8 coded bits on the 2-step path from
    predecessor ``4*(t&15) + p`` to target t (first step's 4 bits, then the
    second's)."""
    table = output_table()
    ws4 = np.empty((256, 8), dtype=np.float32)
    for t in range(64):
        u2, u1 = t >> 5, (t >> 4) & 1
        for p in range(4):
            pred = 4 * (t & 15) + p
            mid = (u1 << 5) | (pred >> 1)
            reg1 = (u1 << 6) | pred
            reg2 = (u2 << 6) | mid
            r = p * 64 + t
            ws4[r, :4] = 1.0 - 2.0 * table[reg1]
            ws4[r, 4:] = 1.0 - 2.0 * table[reg2]
    return ws4


@functools.cache
def ws2_table() -> np.ndarray:
    """K3's branch-metric signs, (128, 4) float32: row ``t`` (``64 + t``)
    holds the +/-1 coded-bit pattern of the transition into target ``t =
    u*32 + c`` from predecessor ``2t mod 64`` (``2t mod 64 + 1``)."""
    table = output_table()
    ws = np.empty((128, 4), dtype=np.float32)
    for r in range(128):
        t = r % 64
        pred = (2 * t) % 64 + (1 if r >= 64 else 0)
        u = t >> 5
        ws[r] = 1.0 - 2.0 * table[(u << 6) | pred]
    return ws


@functools.cache
def _ws4(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(ws4_table()).to(device)


@functools.cache
def _ws2(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(ws2_table()).to(device)


def _signed_sums(s4: torch.Tensor) -> torch.Tensor:
    """(G, 4, B) -> (G, 16, B): row ``8*n0 + 4*n1 + 2*n2 + n3`` is
    ``((+/-s0 +/- s1) +/- s2) +/- s3``, with s_k negated iff n_k, summed left to
    right."""
    acc = torch.stack([s4[:, 0], -s4[:, 0]], dim=1)
    for k in range(1, 4):
        sk = s4[:, k:k + 1]
        acc = torch.stack([acc + sk, acc - sk], dim=2).flatten(1, 2)
    return acc


def _sign_rows(w: torch.Tensor) -> torch.Tensor:
    """(R, 4) +/-1 signs -> (R,) row of :func:`_signed_sums`' table."""
    neg = (w < 0).to(torch.int64)
    return 8 * neg[:, 0] + 4 * neg[:, 1] + 2 * neg[:, 2] + neg[:, 3]


def branch_metrics(soft8: torch.Tensor, ws4: torch.Tensor) -> torch.Tensor:
    """(G, 8, B) soft bits -> (G, 256, B) fused 2-step branch metrics.

    Row r of ``ws4`` (+/-1 signs) gives ``bm[r] = (w0 s0 + w1 s1 + w2 s2
    + w3 s3) + (w4 s4 + w5 s5 + w6 s6 + w7 s7)``: each step's 4 signed
    terms summed left to right, then the two steps' sums added, the order
    the CUDA kernel uses, so the two agree bit for bit.  Each step has
    only 16 sign patterns, so the 256 rows gather from two (G, 16, B)
    tables of partial sums."""
    step1 = _signed_sums(soft8[:, :4]).index_select(1, _sign_rows(ws4[:, :4]))
    step2 = _signed_sums(soft8[:, 4:]).index_select(1, _sign_rows(ws4[:, 4:]))
    return step1 + step2


def _ballot_words(bits: torch.Tensor) -> torch.Tensor:
    """(..., 64) 0/1 -> (..., 2) int32: word w holds the bit of state ``32w
    + j`` at bit j (one warp's ``__ballot_sync``)."""
    b = bits.to(torch.int64).reshape(*bits.shape[:-1], 2, 32)
    words = (b << torch.arange(32, device=bits.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def pack_decisions(d: torch.Tensor) -> torch.Tensor:
    """(..., 64) 2-bit decisions -> (..., 4) int32 words: word ``2w +
    plane`` holds bit ``plane`` of the decision of state ``32w + j`` at
    bit j (the layout of K1's two ballots per warp)."""
    d = d.to(torch.int64)
    return torch.stack([_ballot_words(d & 1), _ballot_words(d >> 1)],
                       dim=-1).reshape(*d.shape[:-1], 4)


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


def traceback4_onehot64_plain(dec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2' (``viterbi_cuda.traceback4_onehot64``):
    :func:`traceback4_plain`'s function, with the kernel's arithmetic.

    Each lane's survivor is a 64-state one-hot, never a state index: ``lo``
    and ``hi`` (int64 holding 32-bit masks) have bit ``t`` and ``t - 32``.
    ``any = lo | hi`` has bit ``p = t & 31``; its square, bit ``2p`` of
    64, has its high word nonzero iff bit 4 of ``t`` is set, and its two
    words OR'd hold bit ``2a`` (``a = t & 15``), whose square has bit
    ``4a``.  A step emits bits 4 and 5 of ``t``, takes the decision as a
    masked AND of the one-hot with each plane's words and moves to ``4a +
    d`` by shifting both words of that square by ``d``.
    """
    b, t2_max, _ = dec.shape
    words = dec.to(torch.int64) & 0xFFFFFFFF
    lo = torch.ones(b, dtype=torch.int64, device=dec.device)
    hi = torch.zeros_like(lo)
    bits = torch.empty((b, t2_max, 2), dtype=torch.uint8, device=dec.device)
    for g in range(t2_max - 1, -1, -1):
        w = words[:, g]
        sq = (lo | hi) ** 2                    # bit 2p < 63: no overflow
        sq_hi = sq >> 32
        bits[:, g, 0] = sq_hi != 0
        bits[:, g, 1] = hi != 0
        d0 = ((lo & w[:, 0]) | (hi & w[:, 2])).clamp(max=1)
        d1 = ((lo & w[:, 1]) | (hi & w[:, 3])).clamp(max=1)
        sq4 = ((sq & 0xFFFFFFFF) | sq_hi) ** 2
        d = d0 + 2 * d1
        lo = (sq4 & 0xFFFFFFFF) << d
        hi = (sq4 >> 32) << d
    return bits.reshape(b, 2 * t2_max)


def acs2_plain(soft4: torch.Tensor, ws2: torch.Tensor):
    """Plain PyTorch version of K3 (``viterbi_cuda.acs2``).

    ``soft4``: (B, T, 4) float32, ``ws2``: (128, 4) float32, the signs of
    :func:`ws2_table`.  Target ``t = u*32 + c`` takes
    candidate ``c0 = pm[2c] + bm[t]`` or ``c1 = pm[2c+1] + bm[64+t]``,
    where ``bm[r] = ((w0 s0 + w1 s1) + w2 s2) + w3 s3`` with ``w =
    ws2[r]``, summed left to right as the kernel does; ``d = c1 > c0``
    (ties take the lower predecessor).  Returns ``(dec, metric)``: dec
    (B, T, 2) int32, word w holding the decision of state ``32w + j`` at
    bit j; metric (B,) float32 = final ``pm[0]``.
    """
    b, t_max, _ = soft4.shape
    dev = soft4.device
    soft = soft4.permute(1, 2, 0).contiguous()             # (T, 4, B)
    rows = _sign_rows(ws2)
    pm = torch.full((64, b), NEG_INF, dtype=torch.float32, device=dev)
    pm[0] = 0.0
    dec = torch.empty((b, t_max, 2), dtype=torch.int32, device=dev)
    for t0 in range(0, t_max, 2 * _STEP_CHUNK):
        bm = _signed_sums(soft[t0:t0 + 2 * _STEP_CHUNK]).index_select(
            1, rows)                                       # (G, 128, B)
        d_chunk = torch.empty((bm.shape[0], 64, b), dtype=torch.bool,
                              device=dev)
        for j in range(bm.shape[0]):
            pair = pm.view(32, 2, b)                       # pm[2c + b]
            c0 = pair[:, 0].repeat(2, 1) + bm[j, :64]
            c1 = pair[:, 1].repeat(2, 1) + bm[j, 64:]
            d = c1 > c0
            pm = torch.where(d, c1, c0)
            d_chunk[j] = d
        dec[:, t0:t0 + bm.shape[0]] = _ballot_words(d_chunk.permute(2, 0, 1))
    return dec, pm[0].clone()


def traceback2_plain(dec: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4 (``viterbi_cuda.traceback2``).

    ``dec``: (B, T, 2) int32 from :func:`acs2_plain`.  Walks each lane's
    state from 0 at the last step; step t emits ``state >> 5``, reads
    ``d = (dec[t][state >> 5] >> (state & 31)) & 1`` and moves to ``2 *
    (state & 31) + d``.  Returns (B, T) uint8.
    """
    b, t_max, _ = dec.shape
    words = dec.to(torch.int64)
    state = torch.zeros(b, dtype=torch.int64, device=dec.device)
    states = torch.empty((b, t_max), dtype=torch.int64, device=dec.device)
    for t in range(t_max - 1, -1, -1):
        states[:, t] = state
        word = words[:, t].gather(1, (state >> 5)[:, None])[:, 0]
        state = 2 * (state & 31) + ((word >> (state & 31)) & 1)
    return (states >> 5).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _lane_t2(lengths: bytes, device: torch.device) -> torch.Tensor:
    """(lanes,) int32 double-step lengths on ``device`` from int64 trellis
    lengths, cached so a steady stream uploads nothing per block."""
    t2 = np.frombuffer(lengths, dtype=np.int64) // 2
    return torch.from_numpy(t2.astype(np.int32)).to(device)


def _check_device(soft: torch.Tensor) -> None:
    if soft.device.type != "cpu":
        raise ValueError(f"no Viterbi for device {soft.device}")


def _decode4(soft: torch.Tensor, t2: torch.Tensor, traceback: str):
    """(B, 4*T) right-padded soft bits (T even), (B,) int32 lane lengths
    in double steps -> bits (B, T) uint8, metric (B,) float32."""
    b, n4 = soft.shape
    soft8 = soft.reshape(b, n4 // 8, 8)
    if soft.is_cuda:
        from dabtools_tpu_torch.ops import viterbi_cuda
        dec, metric = viterbi_cuda.acs4(soft8, t2, _ws4(soft.device))
        if traceback == "onehot64":
            return viterbi_cuda.traceback4_onehot64(dec), metric
        return viterbi_cuda.traceback4(dec), metric
    _check_device(soft)
    dec, metric = acs4_plain(soft8, t2, _ws4(soft.device))
    if traceback == "onehot64":
        return traceback4_onehot64_plain(dec), metric
    return traceback4_plain(dec), metric


def _decode2(soft: torch.Tensor):
    """(B, 4*T) soft bits (T odd) -> bits (B, T) uint8, metric (B,)."""
    b, n4 = soft.shape
    soft4 = soft.reshape(b, n4 // 4, 4)
    if soft.is_cuda:
        from dabtools_tpu_torch.ops import viterbi_cuda
        dec, metric = viterbi_cuda.acs2(soft4, _ws2(soft.device))
        return viterbi_cuda.traceback2(dec), metric
    _check_device(soft)
    dec, metric = acs2_plain(soft4, _ws2(soft.device))
    return traceback2_plain(dec), metric


def viterbi_decode4(soft: torch.Tensor, lengths=None,
                    traceback: str = "factored"):
    """Decode a lane batch of mother codewords with per-lane lengths.

    ``soft``: (batch, 4*T) float32, T even.  ``lengths`` (optional):
    (batch,) ints, each lane's trellis length (incl. tail), even, positive
    and <= T; short lanes are zero-padded on the right.  Lane k's
    information bits are ``bits[k, :lengths[k] - 6]``; positions beyond
    are zeros.  ``traceback`` picks the survivor walk: ``"factored"`` (K2
    or ``traceback4_plain``, an integer state per lane) or ``"onehot64"``
    (K2' or ``traceback4_onehot64_plain``, a 64-state one-hot mask per
    lane); both give the same bits, as ``viterbi_decode_pallas4``'s keyword
    of the same name does.  Returns
    ``(bits (batch, T-6) uint8, metric (batch,))``.
    """
    if soft.ndim != 2:
        raise ValueError("expected (batch, 4*T) soft bits")
    if traceback not in TRACEBACKS:
        raise ValueError(f"traceback must be one of {TRACEBACKS}")
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
    bits, metric = _decode4(soft.to(torch.float32).contiguous(), t2,
                            traceback)
    return bits[:, : t_max - C.TAIL_BITS], metric


def viterbi_decode(soft: torch.Tensor):
    """Decode a batch of mother codewords.

    ``soft``: (batch, 4*(n+6)) or (4*(n+6),) float32, positive => coded
    bit 0, 0 = erasure.  Returns ``(bits, metric)``: bits (batch, n) uint8
    information bits (tail stripped); metric (batch,) float32, the winning
    path's correlation with the received soft bits.  An even trellis
    length decodes radix-4, an odd one radix-2.
    """
    squeeze = soft.ndim == 1
    if squeeze:
        soft = soft[None]
    if soft.shape[-1] % 4:
        raise ValueError("mother codeword length must be a multiple of 4")
    t_max = soft.shape[-1] // 4
    if t_max % 2:
        bits, metric = _decode2(soft.to(torch.float32).contiguous())
        bits = bits[:, : t_max - C.TAIL_BITS]
    else:
        bits, metric = viterbi_decode4(soft)
    return (bits[0], metric[0]) if squeeze else (bits, metric)


def ragged_lanes(softs):
    """Sequence of (batch_i, 4*T_i) soft-bit tensors -> one right-padded
    (sum batch_i, 4*max T_i) float32 lane batch and its (lanes,) int64
    NumPy vector of per-lane trellis lengths."""
    if any(s.ndim != 2 or s.shape[-1] % 4 for s in softs):
        raise ValueError("each batch must be (batch_i, 4*T_i) soft bits")
    ts = [s.shape[-1] // 4 for s in softs]
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
    every MSC profile group share one ACS chain.  A mix that holds an odd
    T decodes batch by batch instead, as the JAX package's does.  Returns
    a list of ``(bits_i, metric_i)`` in the same order, each equal to
    ``viterbi_decode(softs[i])``.
    """
    softs = list(softs)
    if not softs:
        return []
    if any(s.ndim != 2 for s in softs):
        raise ValueError("each batch must be (batch_i, 4*T_i) soft bits")
    if any((s.shape[-1] // 4) % 2 for s in softs):
        return [viterbi_decode(s) for s in softs]
    soft, lengths = ragged_lanes(softs)
    bits, metric = viterbi_decode4(soft, lengths)
    out, o = [], 0
    for s in softs:
        t = s.shape[-1] // 4
        b = s.shape[0]
        out.append((bits[o: o + b, : t - C.TAIL_BITS], metric[o: o + b]))
        o += b
    return out

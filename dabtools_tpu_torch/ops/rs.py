"""Batched shortened-RS decoding as torch ops.

Port of ``dabtools_tpu/ops/rs.py``.  GF(2^8) arithmetic runs as exp/log
table gathers (tables built from the port's ``utils.gf256`` and cached
as tensors per device); everything is fixed-shape and batch-leading, so
thousands of codewords decode as one sequence of device ops:

  syndromes -> Berlekamp-Massey (fixed 2t iterations, masked) -> Chien over
  the n positions -> Forney -> verify.

`make_rs_decoder(n, k)` builds the decoder for any shortened code with
generator roots alpha^0..alpha^{n-k-1} over field poly 0x11D: the DAB+
RS(120,110) (`rs_decode_batch`, TS 102 563) and the packet-mode FEC's
RS(204,188) (EN 300 401 s5.3.5).  It runs on the device of the tensor it
is given and never reads a value back to the host.  Cross-checked against
the NumPy codec (`utils.gf256`) and the JAX decoder in tests.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dabtools_tpu_torch import constants as C
from dabtools_tpu_torch.utils.gf256 import _tables


@functools.cache
def _const_tables(_N: int, _T: int):
    """The JAX decoder's tables, as NumPy integer arrays: log, exp (every
    index a decoder forms stays below 512), syndrome, Chien and Forney
    exponents, the X_p powers and the derivative's exponents."""
    _2T = 2 * _T
    exp, log = _tables()
    exp510 = np.zeros(512, dtype=np.int32)
    exp510[:510] = exp[:510]
    exp510[510:] = exp[:2]
    # syndrome exponents: syn_pow[j, i] = (j * (N-1-i)) mod 255
    i = np.arange(_N)[None, :]
    j = np.arange(_2T)[:, None]
    syn_pow = (j * (_N - 1 - i)) % 255
    # Chien: position p has locator X_p = alpha^{N-1-p}; we evaluate
    # Lambda(X_p^{-1}): chien_pow[p, d] = (d * (255 - (N-1-p))) mod 255
    p = np.arange(_N)[:, None]
    d = np.arange(_T + 1)[None, :]
    chien_pow = (d * (255 - (_N - 1 - p) % 255)) % 255
    # Forney numerator powers: omega evaluated at X_p^{-1}
    d2 = np.arange(_2T)[None, :]
    forney_pow = (d2 * (255 - (_N - 1 - p) % 255)) % 255
    # X_p itself (for the b=0 Forney factor)
    x_pow = (_N - 1 - np.arange(_N)) % 255
    # C'(X_p^-1) = sum_{j odd} C_j X_p^{-(j-1)}: exponents (N, n_odd)
    odd = np.arange(1, _T + 1, 2)
    dpow = ((odd[None, :] - 1) * (255 - (_N - 1 - np.arange(_N)[:, None])
                                  % 255)) % 255
    return (np.asarray(log), exp510, syn_pow, chien_pow, forney_pow, x_pow,
            odd, dpow)


@functools.lru_cache(maxsize=16)
def _device_tables(_N: int, _T: int, device: torch.device) -> tuple:
    """:func:`_const_tables` as int64 tensors on ``device``."""
    return tuple(torch.from_numpy(np.asarray(t, dtype=np.int64)).to(device)
                 for t in _const_tables(_N, _T))


def _gf_mul(a, b, log, exp):
    """Element-wise GF mult of integer tensors via table gathers."""
    prod = exp[log[a] + log[b]]
    return torch.where((a == 0) | (b == 0), 0, prod)


def _gf_inv(a, log, exp):
    return torch.where(a == 0, 0, exp[255 - log[a]])


def _pow_sum(v, pows, log, exp):
    """XOR over the last axis of ``v (B, m) * alpha^pows (n, m)``:
    ``(B, n)``, the polynomial with coefficients ``v`` evaluated at each
    of the n points the exponent rows give (syndromes: the codeword at
    alpha^j; Chien and Forney: Lambda, Omega and Lambda' at each
    X_p^-1)."""
    terms = exp[log[v][:, None, :] + pows[None]]
    terms = torch.where(v[:, None, :] == 0, 0, terms)
    return _xor_reduce(terms, dim=2)


def _xor_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR of ``x`` along ``dim`` by pairwise halving (zero-padded to a
    power of two)."""
    n = x.shape[dim]
    pad = 1
    while pad < n:
        pad *= 2
    if pad != n:
        shape = list(x.shape)
        shape[dim] = pad - n
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = torch.bitwise_xor(x.narrow(dim, 0, h), x.narrow(dim, h, h))
    return x.squeeze(dim)


@functools.cache
def make_rs_decoder(n: int = C.RS_N, k: int = C.RS_K):
    """Batch decoder for the shortened RS(n, k) code.

    Returns ``decode(codewords (batch, n) uint8 tensor) ->
    (data (batch, k) uint8, n_corrected (batch,) int32)`` on the
    codewords' device, with ``n_corrected = -1`` marking uncorrectable
    rows (data passed through).
    """
    _N, _K = n, k
    _T = (n - k) // 2
    _2T = 2 * _T

    def rs_decode_batch(codewords: torch.Tensor):
        if (codewords.dtype != torch.uint8 or codewords.dim() != 2
                or codewords.shape[1] != _N):
            raise ValueError(f"expected (batch, {_N}) uint8 codewords, got "
                             f"{tuple(codewords.shape)} {codewords.dtype}")
        dev = codewords.device
        (log, exp, syn_pow, chien_pow, forney_pow, x_pow, odd,
         dpow) = _device_tables(_N, _T, dev)
        cw = codewords.to(torch.int64)                 # (B, N)
        bsz = cw.shape[0]

        # ---- syndromes (B, 2T)
        synd = _pow_sum(cw, syn_pow, log, exp)
        clean = torch.all(synd == 0, dim=-1)

        # ---- Berlekamp-Massey (fixed 2T iterations)
        c_poly = torch.zeros((bsz, _2T + 1), dtype=torch.int64, device=dev)
        c_poly[:, 0] = 1
        b_poly = c_poly.clone()
        l = torch.zeros((bsz,), dtype=torch.int64, device=dev)
        m = torch.ones((bsz,), dtype=torch.int64, device=dev)
        bb = torch.ones((bsz,), dtype=torch.int64, device=dev)
        idx = torch.arange(_2T + 1, device=dev)

        for i in range(_2T):
            # d = S_i ^ sum_{j=1..l} C_j * S_{i-j}
            s_idx = i - idx                            # (2T+1,)
            s_val = torch.where((s_idx >= 0) & (s_idx < _2T),
                                torch.gather(synd, 1, s_idx.clip(0, _2T - 1)
                                             .expand(bsz, -1)), 0)
            terms = _gf_mul(c_poly, s_val, log, exp)
            terms = torch.where((idx[None, :] >= 1) & (idx[None, :]
                                                       <= l[:, None]),
                                terms, 0)
            d = synd[:, i] ^ _xor_reduce(terms, dim=1)

            coef = _gf_mul(d, _gf_inv(bb, log, exp), log, exp)  # (B,)
            # shifted = x^m * B(x)
            sh_idx = idx[None, :] - m[:, None]
            shifted = torch.where(
                sh_idx >= 0, torch.gather(b_poly, 1, sh_idx.clip(0, _2T)), 0)
            c_new = c_poly ^ _gf_mul(coef[:, None], shifted, log, exp)

            d0 = d == 0
            grow = (~d0) & (2 * l <= i)
            c_poly, b_poly, l, bb, m = (
                torch.where(d0[:, None], c_poly, c_new),
                torch.where(grow[:, None], c_poly, b_poly),
                torch.where(grow, i + 1 - l, l),
                torch.where(grow, d, bb),
                torch.where(d0 | ~grow, m + 1, 1))

        # ---- Chien search: evaluate Lambda at X_p^{-1} for all N positions
        lam = c_poly[:, : _T + 1]                      # deg <= T relevant
        is_root = _pow_sum(lam, chien_pow, log, exp) == 0   # (B, N)
        n_roots = torch.sum(is_root.to(torch.int64), dim=-1)

        # ---- Forney: Omega = S*C mod x^{2T};
        # e_p = X_p * Om(X_p^-1) / C'(X_p^-1)
        conv_idx = torch.arange(_2T, device=dev)
        diff = conv_idx[:, None] - conv_idx[None, :]   # (i, j) -> i - j
        s_mat = torch.where(diff >= 0, torch.gather(   # (B, i, j) = S_{i-j}
            synd[:, None, :].expand(-1, _2T, -1), 2,
            diff.clip(0, _2T - 1).expand(bsz, -1, -1)), 0)
        c_trim = c_poly[:, : _2T]
        omega = _xor_reduce(_gf_mul(c_trim[:, None, :], s_mat, log, exp),
                            dim=2)                     # (B, 2T)
        om_eval = _pow_sum(omega, forney_pow, log, exp)     # (B, N)
        # C'(x): odd coefficients; C'(X^-1) = sum_{j odd} C_j X^{-(j-1)}
        d_eval = _pow_sum(c_poly[:, odd], dpow, log, exp)   # (B, N)

        x_val = exp[x_pow][None, :]                    # (1, N) X_p
        mag = _gf_mul(_gf_mul(x_val, om_eval, log, exp),
                      _gf_inv(d_eval, log, exp), log, exp)
        corrected = cw ^ torch.where(is_root & (d_eval != 0), mag, 0)

        # ---- verify
        synd2 = _pow_sum(corrected, syn_pow, log, exp)
        ok = torch.all(synd2 == 0, dim=-1) & (n_roots == l) & (l <= _T)

        n_corrected = torch.where(clean, 0, torch.where(ok, l, -1))
        out = torch.where(clean[:, None], cw,
                          torch.where(ok[:, None], corrected, cw))
        return out[:, :_K].to(torch.uint8), n_corrected.to(torch.int32)

    return rs_decode_batch


def rs_decode_batch(codewords: torch.Tensor):
    """Decode (batch, 120) uint8 DAB+ codewords (TS 102 563)."""
    return make_rs_decoder()(codewords)

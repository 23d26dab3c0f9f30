"""GF(2^8) arithmetic + RS(120,110) codec (ETSI TS 102 563 / EN 301 234).

Field polynomial 0x11D (x^8+x^4+x^3+x^2+1), generator alpha = 2; the DAB+
outer code is RS(120,110,t=5), shortened from RS(255,245), generator
polynomial g(x) = prod_{i=0}^{9} (x - alpha^i).

NumPy reference codec (host).  The receive path also has a batched jnp
syndrome/decode in ``dabtools_tpu.ops.rs`` built on the same tables; this
module is the ground truth it is tested against.  No counterpart exists in
the reference (dabtools is MP2-only, SURVEY.md s2).
"""

from __future__ import annotations

import functools

import numpy as np

from dabtools_tpu_torch import constants as C

_POLY = C.GF_POLY


@functools.cache
def _tables():
    exp = np.zeros(512, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    return exp, log


def gf_mul(a, b):
    """Element-wise GF(256) multiply (NumPy arrays or ints)."""
    exp, log = _tables()
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = exp[log[a] + log[b]]
    return np.where((a == 0) | (b == 0), 0, out)


def gf_pow(a: int, n: int) -> int:
    exp, log = _tables()
    if a == 0:
        return 0
    return int(exp[(log[a] * n) % 255])


def gf_inv(a):
    exp, log = _tables()
    a = np.asarray(a, dtype=np.int32)
    return exp[255 - log[a]]


def gf_poly_eval(poly: np.ndarray, x: int) -> int:
    """Evaluate polynomial (highest-order coefficient first) at x."""
    y = 0
    for c in poly:
        y = int(gf_mul(y, x)) ^ int(c)
    return y


@functools.cache
def rs_generator(n_roots: int = 2 * C.RS_T) -> np.ndarray:
    """g(x) coefficients, highest first, roots alpha^0..alpha^{n_roots-1}."""
    g = np.array([1], dtype=np.int32)
    for i in range(n_roots):
        root = gf_pow(2, i)
        nxt = np.zeros(g.size + 1, dtype=np.int32)
        nxt[:-1] ^= g
        nxt[1:] ^= gf_mul(g, root)
        g = nxt
    return g


def rs_encode(data: np.ndarray) -> np.ndarray:
    """Systematic RS encode: (..., 110) uint8 -> (..., 120) uint8."""
    data = np.asarray(data, dtype=np.uint8)
    single = data.ndim == 1
    data = np.atleast_2d(data)
    if data.shape[-1] != C.RS_K:
        raise ValueError(f"expected {C.RS_K} data bytes")
    g = rs_generator()[1:]  # monic; keep the low-order 10 coefficients
    out = np.zeros((data.shape[0], C.RS_N), dtype=np.uint8)
    out[:, :C.RS_K] = data
    for row in range(data.shape[0]):
        rem = np.zeros(2 * C.RS_T, dtype=np.int32)
        for byte in data[row]:
            factor = int(byte) ^ int(rem[0])
            rem[:-1] = rem[1:]
            rem[-1] = 0
            if factor:
                rem ^= gf_mul(g, factor)
        out[row, C.RS_K:] = rem
    return out[0] if single else out


def rs_parity(data_rows: np.ndarray, n_parity: int) -> np.ndarray:
    """Systematic RS parity for arbitrary-rate shortened codes.

    ``data_rows``: (c, k) uint8 -> (c, n_parity) uint8 parity, generator
    roots alpha^0..alpha^{n_parity-1} (same convention as the DAB+
    RS(120,110) codec above; used by the EDI PFT layer's RS(k+48, k)).
    """
    data = np.atleast_2d(np.asarray(data_rows, dtype=np.uint8))
    g = rs_generator(n_parity)[1:]
    out = np.zeros((data.shape[0], n_parity), dtype=np.uint8)
    for row in range(data.shape[0]):
        rem = np.zeros(n_parity, dtype=np.int32)
        for byte in data[row]:
            factor = int(byte) ^ int(rem[0])
            rem[:-1] = rem[1:]
            rem[-1] = 0
            if factor:
                rem ^= gf_mul(g, factor)
        out[row] = rem
    return out


def rs_erasure_correct(rows: np.ndarray, erase_pos, n_parity: int):
    """Correct known-position erasures in shortened RS codewords.

    ``rows``: (c, n) uint8 codewords (k = n - n_parity data bytes first),
    with arbitrary bytes at the erased columns.  ``erase_pos``: column
    indices (shared by all rows — the PFT loss pattern).  Returns
    ``(corrected_rows, ok)``; up to ``n_parity`` erasures are correctable.

    Vectorized across rows: the erasure locator algebra is shared, only
    syndromes/magnitudes are per-row (NumPy gf ops).
    """
    cw = np.atleast_2d(np.asarray(rows, dtype=np.uint8)).copy()
    c, n = cw.shape
    erase_pos = sorted(set(int(p) for p in erase_pos))
    if not erase_pos:
        return cw, True
    if len(erase_pos) > n_parity or any(p >= n for p in erase_pos):
        return cw, False
    pad = 255 - n
    cw[:, erase_pos] = 0

    # Syndromes S[:, j] = r(alpha^j): r(x) = sum_i cw[i] x^{n-1-i}.
    powers = np.array([(255 - 1 - (pad + i)) % 255 for i in range(n)],
                      dtype=np.int32)
    exp, _ = _tables()
    s = np.zeros((c, n_parity), dtype=np.int32)
    for j in range(n_parity):
        xj = exp[(powers * j) % 255]          # alpha^{j * power_i}
        s ^= 0  # keep dtype
        s[:, j] = np.bitwise_xor.reduce(gf_mul(cw, xj[None, :]), axis=1)

    # Erasure locators X_k and Lambda(x) = prod (1 - X_k x)  (shared).
    locs = [gf_pow(2, (255 - 1 - (pad + p)) % 255) for p in erase_pos]
    lam = np.zeros(len(locs) + 1, dtype=np.int32)
    lam[0] = 1
    for xk in locs:
        nxt = lam.copy()
        nxt[1:] ^= gf_mul(lam[:-1], xk)
        lam = nxt

    # Omega(x) = S(x) Lambda(x) mod x^{n_parity}, per row.
    omega = np.zeros((c, n_parity), dtype=np.int32)
    for i in range(n_parity):
        acc = np.zeros(c, dtype=np.int32)
        for j in range(min(i, len(locs)) + 1):
            acc ^= gf_mul(np.full(c, lam[j]), s[:, i - j])
        omega[:, i] = acc

    # Forney (first root b=0): e = X * Omega(X^-1) / Lambda'(X^-1).
    for pos, xk in zip(erase_pos, locs):
        x_inv = int(gf_inv(xk))
        num = np.zeros(c, dtype=np.int32)
        for i in range(n_parity):
            num ^= gf_mul(omega[:, i], gf_pow(x_inv, i))
        den = 0
        for j in range(1, len(locs) + 1, 2):
            den ^= int(gf_mul(lam[j], gf_pow(x_inv, j - 1)))
        if den == 0:
            return cw, False
        mag = gf_mul(xk, gf_mul(num, int(gf_inv(den))))
        cw[:, pos] ^= mag.astype(np.uint8)

    # Verify all syndromes vanish.
    for j in range(n_parity):
        xj = exp[(powers * j) % 255]
        if np.bitwise_xor.reduce(gf_mul(cw, xj[None, :]), axis=1).any():
            return cw, False
    return cw, True


def rs_decode(codeword: np.ndarray, n_parity: int = 2 * C.RS_T):
    """Decode shortened RS codewords (may be 2D batch).

    Default is the DAB+ RS(120,110); any shortened code with generator
    roots alpha^0..alpha^{n_parity-1} works (n from the codeword length),
    e.g. the MSC packet-mode FEC's RS(204,188) (EN 300 401 s5.3.5).
    Returns ``(data, n_corrected)``; ``n_corrected = -1`` marks an
    uncorrectable codeword (data returned as-is).
    """
    cw = np.asarray(codeword, dtype=np.uint8)
    single = cw.ndim == 1
    cw = np.atleast_2d(cw).copy()
    counts = np.zeros(cw.shape[0], dtype=np.int32)
    for row in range(cw.shape[0]):
        counts[row] = _rs_decode_one(cw[row], n_parity)
    data = cw[:, :cw.shape[1] - n_parity]
    return (data[0], int(counts[0])) if single else (data, counts)


def _rs_decode_one(cw: np.ndarray, n_parity: int = 2 * C.RS_T) -> int:
    exp, log = _tables()
    n, t = cw.shape[-1], n_parity // 2
    pad = 255 - n  # shortened positions (implicit leading zeros)

    # Syndromes S_j = r(alpha^j), j = 0..2t-1
    synd = np.array([gf_poly_eval(cw, gf_pow(2, j))
                     for j in range(2 * t)], dtype=np.int32)
    if not synd.any():
        return 0

    # Berlekamp-Massey
    c_poly = np.zeros(2 * t + 1, dtype=np.int32); c_poly[0] = 1
    b_poly = np.zeros(2 * t + 1, dtype=np.int32); b_poly[0] = 1
    l, m, b = 0, 1, 1
    for i in range(2 * t):
        d = int(synd[i])
        for j in range(1, l + 1):
            d ^= int(gf_mul(c_poly[j], synd[i - j]))
        if d == 0:
            m += 1
        elif 2 * l <= i:
            tmp = c_poly.copy()
            coef = int(gf_mul(d, gf_inv(b)))
            shifted = np.zeros_like(b_poly)
            shifted[m:] = b_poly[:b_poly.size - m]
            c_poly = c_poly ^ gf_mul(shifted, coef)
            b_poly, b, l, m = tmp, d, i + 1 - l, 1
        else:
            coef = int(gf_mul(d, gf_inv(b)))
            shifted = np.zeros_like(b_poly)
            shifted[m:] = b_poly[:b_poly.size - m]
            c_poly = c_poly ^ gf_mul(shifted, coef)
            m += 1
    if l > t:
        return -1

    # Chien search over the n valid positions (shortened code).
    err_pos = []
    for pos in range(n):
        # position index in the full 255-symbol code, highest power first:
        # r(x) = sum cw[i] x^{n-1-i}; root test at x = alpha^{-(pad + ... )}
        loc = 255 - 1 - (pad + pos)      # power of alpha for this position
        x_inv = gf_pow(2, 255 - (loc % 255))
        val = 0
        for j in range(l + 1):
            val ^= int(gf_mul(c_poly[j], gf_pow(x_inv, j)))
        if val == 0:
            err_pos.append((pos, loc))
    if len(err_pos) != l:
        return -1

    # Forney: error magnitudes. Omega = S(x) * C(x) mod x^{2t}
    s_poly = synd  # S(x) = sum S_j x^j
    omega = np.zeros(2 * t, dtype=np.int32)
    for i in range(2 * t):
        acc = 0
        for j in range(min(i, l) + 1):
            acc ^= int(gf_mul(c_poly[j], s_poly[i - j])) if i - j < 2 * t else 0
        omega[i] = acc
    # C'(x): formal derivative (odd-power coefficients)
    for pos, loc in err_pos:
        x = gf_pow(2, loc % 255)          # X_k = alpha^loc
        x_inv = gf_inv(x)
        num = 0
        for i in range(2 * t):
            num ^= int(gf_mul(omega[i], gf_pow(int(x_inv), i)))
        den = 0
        for j in range(1, l + 1, 2):
            den ^= int(gf_mul(c_poly[j], gf_pow(int(x_inv), j - 1)))
        if den == 0:
            return -1
        # Forney with first root b=0: e = X * Omega(X^-1) / Lambda'(X^-1)
        mag = int(gf_mul(x, gf_mul(num, gf_inv(den))))
        cw[pos] ^= mag
    # Verify
    for j in range(2 * t):
        if gf_poly_eval(cw, gf_pow(2, j)) != 0:
            return -1
    return l

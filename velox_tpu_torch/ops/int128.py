"""int128 limb arithmetic for long decimals (DECIMAL(19..38)).

Counterpart of ``velox_tpu/ops/int128.py`` (velox/type/HugeInt.h +
type/DecimalUtil.h): the decimal ``sum``/``avg`` states and their
extraction, long-decimal comparisons, sort keys, plus/minus, and the
multiply of a long decimal by an int64 (``mul128_i64`` on the 64 x 64 ->
128-bit products ``umul64_full`` and ``mul_i64_full``). A value is two
int64 limbs: ``lo`` holds the low 64 bits (an unsigned pattern stored in
int64), ``hi`` the signed high 64 bits. Columns keep lo as the data and
hi as a child column (vector/device.py).

This build of torch has no uint64 shifts or compares, so the unsigned
operations are written on int64: a logical right shift is an arithmetic
shift masked to the remaining bits, an unsigned compare flips the sign
bit of both sides, and additions and left shifts wrap in two's
complement, as uint64 arithmetic does.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_MIN64 = -(1 << 63)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b of int64 bit patterns."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 bit pattern by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def from_i64(x: torch.Tensor):
    """Sign-extend int64 -> (lo, hi) limbs."""
    x = x.to(torch.int64)
    return x, x >> 63


def add128(alo, ahi, blo, bhi):
    lo = alo + blo
    carry = _ult(lo, alo).to(torch.int64)
    return lo, ahi + bhi + carry


def neg128(lo, hi):
    nlo = ~lo + 1
    borrow = (nlo == 0).to(torch.int64)
    return nlo, ~hi + borrow


def sub128(alo, ahi, blo, bhi):
    nlo, nhi = neg128(blo, bhi)
    return add128(alo, ahi, nlo, nhi)


def eq128(alo, ahi, blo, bhi):
    return (alo == blo) & (ahi == bhi)


def lt128(alo, ahi, blo, bhi):
    """Signed a < b."""
    return (ahi < bhi) | ((ahi == bhi) & _ult(alo, blo))


def umul64_full(ua, ub):
    """Unsigned 64 x 64 -> (lo, hi) 128-bit product of two int64 bit
    patterns, from 32-bit partial products (each wraps in int64 as its
    uint64 counterpart does)."""
    a0, a1 = ua & _M32, _shr(ua, 32)
    b0, b1 = ub & _M32, _shr(ub, 32)
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    mid = _shr(p00, 32) + (p01 & _M32) + (p10 & _M32)
    lo = (p00 & _M32) | (mid << 32)
    hi = a1 * b1 + _shr(p01, 32) + _shr(p10, 32) + _shr(mid, 32)
    return lo, hi


def mul_i64_full(a, b):
    """Signed 64 x 64 -> the full 128-bit product as (lo, hi) limbs: the
    unsigned product, then b subtracted from hi where a < 0 and a where
    b < 0."""
    lo, hi = umul64_full(a, b)
    hi = hi - torch.where(a < 0, b, 0) - torch.where(b < 0, a, 0)
    return lo, hi


def mul128_i64(lo, hi, c):
    """Signed (lo, hi) times a per-row signed int64 ``c``: the low 128 bits
    of the product, through the magnitudes and one sign."""
    alo, ahi, aneg = abs128(lo, hi)
    uc = torch.abs(c)  # |INT64_MIN| wraps to 2^63's bit pattern: exact
    plo, pmid = umul64_full(alo, uc)
    phi = pmid + ahi * uc  # the low 64 bits of the high partial
    neg = aneg ^ (c < 0)
    nlo, nhi = neg128(plo, phi)
    return torch.where(neg, nlo, plo), torch.where(neg, nhi, phi)


def mul128_u64(lo, hi, c: int):
    """(lo, hi) * c for a Python int 0 <= c < 2^63 (e.g. 10^k), modulo
    2^128. The 32-bit partial products of the low limb wrap in int64 as
    their uint64 counterparts do; only masked or logically shifted bits of
    them are kept."""
    l0, l1 = lo & _M32, _shr(lo, 32)
    c0, c1 = c & _M32, c >> 32
    p00 = l0 * c0
    p01 = l0 * c1
    p10 = l1 * c0
    mid = _shr(p00, 32) + (p01 & _M32) + (p10 & _M32)
    new_lo = (p00 & _M32) | (mid << 32)
    carry = l1 * c1 + _shr(p01, 32) + _shr(p10, 32) + _shr(mid, 32)
    return new_lo, hi * c + carry


def rescale_up(lo, hi, k: int):
    """Multiply by 10^k (k >= 0): decimal scale alignment."""
    while k > 0:
        step = min(k, 18)
        lo, hi = mul128_u64(lo, hi, 10 ** step)
        k -= step
    return lo, hi


def from_python_int(v: int):
    """Host: Python int -> (lo, hi) two's-complement int64 limbs."""
    lo = v & 0xFFFFFFFFFFFFFFFF
    if lo >= 1 << 63:
        lo -= 1 << 64
    return lo, v >> 64  # Python's >> is arithmetic


def to_numpy_ints(lo_np, hi_np):
    """Host: limb arrays -> an object array of exact Python ints."""
    import numpy as np
    lo_u = np.asarray(lo_np).astype(np.int64).view(np.uint64)
    out = np.empty(len(lo_u), dtype=object)
    for i in range(len(lo_u)):
        out[i] = (int(hi_np[i]) << 64) | int(lo_u[i])
    return out


def abs128(lo, hi):
    """-> (|x| lo, |x| hi, was_negative)."""
    neg = hi < 0
    nlo, nhi = neg128(lo, hi)
    return torch.where(neg, nlo, lo), torch.where(neg, nhi, hi), neg


def combine_parts(p0, p1, p2, p3):
    """Recombine four 32-bit planar partial sums (int64 accumulators,
    p0..p2 non-negative, p3 signed) into (lo, hi): the long-decimal SUM
    extraction."""
    c0 = p0
    l0 = c0 & _M32
    c1 = _shr(c0, 32) + p1
    l1 = c1 & _M32
    c2 = _shr(c1, 32) + p2
    l2 = c2 & _M32
    c3 = _shr(c2, 32) + p3
    l3 = c3 & _M32
    return l0 | (l1 << 32), l2 | (l3 << 32)


def combine_two_parts(s_lo, s_hi):
    """(lo, hi) int128 from two planar parts of summed int64 values:
    s_lo = sum of (v & 0xFFFFFFFF) >= 0, s_hi = sum of (v >> 32)
    (arithmetic, signed); value = s_hi * 2^32 + s_lo exactly."""
    shl_lo = s_hi << 32
    shl_hi = s_hi >> 32  # arithmetic: the sign fills the top limb
    return add128(shl_lo, shl_hi, s_lo, torch.zeros_like(s_lo))


def split_parts(lo, hi):
    """(lo, hi) -> four planar 32-bit parts as int64 (p3 keeps sign)."""
    return lo & _M32, _shr(lo, 32), hi & _M32, hi >> 32


def divmod128_u64(lo, hi, d):
    """Unsigned (hi:lo) / d -> (qlo, qhi, rem): restoring long division,
    MSB-first over the 128 dividend bits (128 elementwise steps).
    Requires 0 < d < 2^63 (SQL counts)."""
    ud = d.to(torch.int64)
    rem = torch.zeros_like(lo)
    qlo = torch.zeros_like(lo)
    qhi = torch.zeros_like(lo)
    for k in range(127, -1, -1):
        src = hi if k >= 64 else lo
        bit = (src >> (k & 63)) & 1
        rem = (rem << 1) | bit
        ge = ~_ult(rem, ud)
        rem = torch.where(ge, rem - ud, rem)
        qhi = (qhi << 1) | _shr(qlo, 63)
        qlo = (qlo << 1) | ge.to(torch.int64)
    return qlo, qhi, rem


def div128_round_half_up(lo, hi, d):
    """Signed (hi:lo) / d with half-up rounding (d > 0): the decimal avg
    division. Returns (qlo, qhi)."""
    alo, ahi, _ = abs128(lo, hi)
    half = d.to(torch.int64) >> 1
    alo, ahi = add128(alo, ahi, half, torch.zeros_like(half))
    qlo, qhi, _ = divmod128_u64(alo, ahi, d)
    neg = hi < 0
    nlo, nhi = neg128(qlo, qhi)
    return torch.where(neg, nlo, qlo), torch.where(neg, nhi, qhi)

"""Misc scalar functions: nullif, more math, the bitwise operations.

Counterpart of ``velox_tpu/functions/misc.py``: ``nullif`` (a plain
function, as in the reference), the double-domain ``asin`` ... ``atan2``,
``log(base, x)``, ``pi``, ``e``, the ``bitwise_*`` names, ``truncate``
and ``width_bucket``.

Shifts by 64 or more, or by a negative amount, give 0 (left) or the sign
(arithmetic right), as XLA's shifts do. ``truncate`` of a DECIMAL(19..38)
divides both limbs (the reference divides the low limb alone; ROADMAP C).
"""

from __future__ import annotations

import math

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue, merge_validity
from velox_tpu_torch.functions.registry import register
from velox_tpu_torch.functions.scalar import (
    _floor_div, _long_value, _numeric_data, eq_value,
)
from velox_tpu_torch.functions.signature import sig
from velox_tpu_torch.ops import int128 as I


def _nullif_eval(ctx, out_dtype, args):
    a, b = args
    eq = eq_value(ctx, a, b)
    eq_known = eq.data.to(torch.bool)
    if eq.validity is not None:
        eq_known = eq_known & eq.validity
    validity = a.full_validity(ctx.capacity) & ~eq_known.expand(ctx.capacity)
    return EvalValue(a.full_data(ctx.capacity), validity, a.dtype,
                     a.dictionary, children=a.children)


register("nullif", lambda ts: ts[0] if len(ts) == 2 else None, _nullif_eval)


def _binary_double(name, fn):
    def eval_fn(ctx, out_dtype, args):
        a, b = args
        return EvalValue(fn(_numeric_data(a, T.DOUBLE),
                            _numeric_data(b, T.DOUBLE)),
                         merge_validity(a, b), T.DOUBLE)
    register(name, sig("numeric, numeric -> double"), eval_fn)


def _unary_double(name, fn):
    def eval_fn(ctx, out_dtype, args):
        (a,) = args
        return EvalValue(fn(_numeric_data(a, T.DOUBLE)), a.validity,
                         T.DOUBLE)
    register(name, sig("numeric -> double"), eval_fn)


for _name, _fn in (("asin", torch.asin), ("acos", torch.acos),
                   ("atan", torch.atan), ("sinh", torch.sinh),
                   ("cosh", torch.cosh), ("tanh", torch.tanh),
                   ("degrees", torch.rad2deg), ("radians", torch.deg2rad)):
    _unary_double(_name, _fn)
_binary_double("atan2", torch.atan2)
_binary_double("log", lambda b, x: torch.log(x) / torch.log(b))


def _constant(value: float):
    def eval_fn(ctx, out_dtype, args):
        return EvalValue(torch.tensor(value, dtype=torch.float64,
                                      device=ctx.device), None, T.DOUBLE)
    return eval_fn


register("pi", sig("-> double"), _constant(math.pi))
register("e", sig("-> double"), _constant(math.e))


def _shift_left(a, b):
    out = a << b.clamp(0, 63)
    return torch.where((b < 0) | (b >= 64), torch.zeros_like(out), out)


def _shift_right(a, b):
    out = a >> b.clamp(0, 63)
    return torch.where((b < 0) | (b >= 64), a >> 63, out)


def _bitwise(name, fn):
    def eval_fn(ctx, out_dtype, args):
        a, b = args
        da = a.full_data(ctx.capacity).to(torch.int64)
        db = b.full_data(ctx.capacity).to(torch.int64)
        return EvalValue(fn(da, db), merge_validity(a, b), T.BIGINT)
    register(name, sig("integral, integral -> bigint"), eval_fn)


_bitwise("bitwise_and", torch.bitwise_and)
_bitwise("bitwise_or", torch.bitwise_or)
_bitwise("bitwise_xor", torch.bitwise_xor)
_bitwise("bitwise_shift_left", _shift_left)
_bitwise("bitwise_arithmetic_shift_right", _shift_right)


def _bitwise_not_eval(ctx, out_dtype, args):
    (a,) = args
    return EvalValue(~a.full_data(ctx.capacity).to(torch.int64),
                     a.validity, T.BIGINT)


register("bitwise_not", sig("integral -> bigint"), _bitwise_not_eval)


def _long_truncate(ctx, a: EvalValue, out_dtype) -> EvalValue:
    """|x| divided by 10^scale over both limbs, the sign put back."""
    cap = ctx.capacity
    alo, ahi, neg = I.abs128(a.full_data(cap), a.full_hi(cap))
    d = torch.full((cap,), 10 ** a.dtype.scale, dtype=torch.int64,
                   device=ctx.device)
    qlo, qhi, _ = I.divmod128_u64(alo, ahi, d)
    nlo, nhi = I.neg128(qlo, qhi)
    lo, hi = torch.where(neg, nlo, qlo), torch.where(neg, nhi, qhi)
    if out_dtype.is_long_decimal:
        return _long_value(lo, hi, a.validity, out_dtype)
    return EvalValue(lo, a.validity, out_dtype)


def _truncate_eval(ctx, out_dtype, args):
    (a,) = args
    if a.dtype.is_integral:
        return a
    if a.dtype.is_long_decimal:
        return _long_truncate(ctx, a, out_dtype)
    if a.dtype.kind is T.TypeKind.DECIMAL:
        s = 10 ** a.dtype.scale
        d = a.data
        data = torch.where(d >= 0, _floor_div(d, s), -_floor_div(-d, s))
        return EvalValue(data, a.validity, out_dtype)
    return EvalValue(torch.trunc(a.data), a.validity, T.DOUBLE)


register("truncate",
         lambda ts: (ts[0] if ts[0].is_integral else (
             T.decimal(ts[0].precision, 0)
             if ts[0].kind is T.TypeKind.DECIMAL else T.DOUBLE))
         if len(ts) == 1 and ts[0].is_numeric else None, _truncate_eval)


def _width_bucket_eval(ctx, out_dtype, args):
    x, lo, hi, n = args
    dx = _numeric_data(x, T.DOUBLE)
    dlo = _numeric_data(lo, T.DOUBLE)
    dhi = _numeric_data(hi, T.DOUBLE)
    dn = n.full_data(ctx.capacity).to(torch.int64)
    b = torch.floor((dx - dlo) / (dhi - dlo)
                    * dn.to(torch.float64)).to(torch.int64) + 1
    b = torch.minimum(torch.clamp(b, min=0), dn + 1)
    return EvalValue(b, merge_validity(x, lo, hi, n), T.BIGINT)


register("width_bucket",
         sig("numeric, numeric, numeric, numeric -> bigint"),
         _width_bucket_eval)

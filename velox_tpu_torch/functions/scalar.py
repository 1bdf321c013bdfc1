"""Presto-semantics scalar functions: what the 22 TPC-H queries evaluate.

Counterpart of ``velox_tpu/functions/scalar.py``:

* comparisons (eq, neq, lt, lte, gt, gte) over integers, DATE, TIMESTAMP
  and short DECIMAL, with decimal constants rescaled to the common scale;
  over long decimals (DECIMAL(19..38), int128 limbs); over dictionary
  strings (ids; ordered compares need a sorted dictionary); and over raw
  strings (bytes, functions/raw_strings.py);
* plus, minus and multiply over integers and short decimals, with the
  reference's checked-overflow flags for integer results, and over long
  decimals through their limbs (a long decimal times a short one; both
  long raises, as in the reference); divide and mod (integer division
  truncates toward zero, /0 and %0 are checked errors; decimal division
  computes in DOUBLE), negate, abs, ceil, floor, round and sign (long
  decimals through their limbs);
* the double-domain math block (sqrt ... tan, ceil/floor/round, power,
  sign, greatest/least);
* dictionary-string functions (substr, like, lower, trim, strpos, ...):
  a host pass over the dictionary's values, then one device gather by id.
  lower, upper, length, the trims and reverse map the values through
  pyarrow's ``utf8_*`` kernels, with the reference's plain-Python
  fallback where pyarrow rejects them; raw columns take the forms of
  functions/raw_strings.py;
* date parts (year, quarter, month, day, day_of_week, day_of_year); the
  rest of the date and time functions are in functions/datetime.py.

Type resolution (promotion, result types) is the reference's, copied, so
plans type identically in both engines.
"""

from __future__ import annotations

import bisect
import re
from collections import OrderedDict

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import (
    EvalValue, _align_strings, merge_validity, promote,
)
from velox_tpu_torch.functions.registry import _REGISTRY, register
from velox_tpu_torch.ops import int128 as I
from velox_tpu_torch.vector import strings as S
from velox_tpu_torch.vector.device import Dictionary

# ---------------------------------------------------------------------------
# Type promotion (copied from the reference)
# ---------------------------------------------------------------------------

_INT_ORDER = [T.TypeKind.TINYINT, T.TypeKind.SMALLINT, T.TypeKind.INTEGER,
              T.TypeKind.BIGINT]

_I64_MIN = -(1 << 63)


def promote_numeric(a: T.DataType, b: T.DataType) -> T.DataType:
    if a == b:
        return a
    if a.kind is T.TypeKind.DOUBLE or b.kind is T.TypeKind.DOUBLE:
        return T.DOUBLE
    if a.kind is T.TypeKind.REAL or b.kind is T.TypeKind.REAL:
        # real + int -> real; real + decimal -> double
        other = b if a.kind is T.TypeKind.REAL else a
        return T.DOUBLE if other.kind is T.TypeKind.DECIMAL else T.REAL
    if a.kind is T.TypeKind.DECIMAL or b.kind is T.TypeKind.DECIMAL:
        da = a if a.kind is T.TypeKind.DECIMAL else T.decimal(18, 0)
        db = b if b.kind is T.TypeKind.DECIMAL else T.decimal(18, 0)
        s = max(da.scale, db.scale)
        if da.is_long_decimal or db.is_long_decimal:
            idig = max(da.precision - da.scale, db.precision - db.scale)
            return T.decimal(min(38, idig + s + 1), s)
        # short inputs stay on the int64 path, capped at DECIMAL(18)
        return T.decimal(18, s)
    ia, ib = _INT_ORDER.index(a.kind), _INT_ORDER.index(b.kind)
    return a if ia >= ib else b


def _rescale_decimal(data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    return torch.div(data, 10 ** (from_scale - to_scale),
                     rounding_mode="floor")


def _no_long(*vals):
    """Raise where a long decimal reaches a computation the reference has
    no limb form of either (mod, greatest/least, a non-float target)."""
    for v in vals:
        if v.dtype.is_long_decimal:
            raise NotImplementedError(
                f"{v.dtype} (int128 limbs) in this context is not "
                "supported")


def _numeric_data(v: EvalValue, target: T.DataType):
    """Convert EvalValue data to the computation dtype of `target`."""
    if v.dtype.is_long_decimal and target.is_floating:
        from velox_tpu_torch.functions.casts import long_to_double
        hi = v.children[0].data if v.children else torch.zeros_like(v.data)
        return long_to_double(v.data, hi, v.dtype.scale, target)
    _no_long(v)
    if target.is_long_decimal:
        raise NotImplementedError(
            f"{target} (int128 limbs) in this context is not supported")
    data = v.data
    if v.dtype.kind is T.TypeKind.DECIMAL:
        if target.kind is T.TypeKind.DECIMAL:
            return _rescale_decimal(data, v.dtype.scale, target.scale)
        return data.to(target.torch_dtype()) / (10.0 ** v.dtype.scale)
    if target.kind is T.TypeKind.DECIMAL:
        return data.to(torch.int64) * (10 ** target.scale)
    return data.to(target.torch_dtype())


# ---------------------------------------------------------------------------
# Resolvers (copied from the reference)
# ---------------------------------------------------------------------------

def arith_resolver(name):
    def resolver(arg_types):
        if len(arg_types) != 2 or not all(t.is_numeric for t in arg_types):
            return None
        a, b = arg_types
        if name in ("plus", "minus", "multiply") and a.is_integral \
                and b.is_integral:
            # integer arithmetic computes and returns BIGINT
            return T.BIGINT
        if name == "divide":
            if (a.kind is T.TypeKind.DECIMAL
                    or b.kind is T.TypeKind.DECIMAL):
                return T.DOUBLE  # decimal division -> double
            return promote_numeric(a, b)
        if name == "multiply" and (a.kind is T.TypeKind.DECIMAL
                                   and b.kind is T.TypeKind.DECIMAL):
            if a.is_long_decimal or b.is_long_decimal:
                return T.decimal(min(38, a.precision + b.precision),
                                 a.scale + b.scale)
            return T.decimal(min(18, a.precision + b.precision),
                             a.scale + b.scale)
        return promote_numeric(a, b)
    return resolver


def _cmp_resolver(arg_types):
    if len(arg_types) != 2:
        return None
    a, b = arg_types
    if a.is_numeric and b.is_numeric:
        return T.BOOLEAN
    ok_same = (a.kind == b.kind) or {a.kind, b.kind} <= {
        T.TypeKind.VARCHAR, T.TypeKind.VARBINARY}
    if ok_same and (a.is_string or a.kind in (
            T.TypeKind.DATE, T.TypeKind.TIMESTAMP, T.TypeKind.BOOLEAN)):
        return T.BOOLEAN
    if {a.kind, b.kind} <= {T.TypeKind.DATE, T.TypeKind.TIMESTAMP}:
        return T.BOOLEAN
    return None


# ---------------------------------------------------------------------------
# Arithmetic
# ---------------------------------------------------------------------------

def _both_valid(a, b, ctx):
    v = merge_validity(a, b)
    if v is None:
        return torch.ones((ctx.capacity,), dtype=torch.bool,
                          device=ctx.device)
    return v.expand(ctx.capacity)


def _flag(ctx, err, validity):
    """Flag checked-op failures on non-null rows; those rows go NULL and
    the Task raises on the count (common/errors.py)."""
    ctx.flag_error(err)
    return ~err if validity is None else (validity & ~err)


def _ovf_plus(a, b, r):
    return ((a > 0) & (b > 0) & (r < 0)) | ((a < 0) & (b < 0) & (r >= 0))


def _ovf_minus(a, b, r):
    return ((a >= 0) & (b < 0) & (r < 0)) | ((a < 0) & (b > 0) & (r >= 0))


def _ovf_mul(a, b, r):
    # r // b != a exposes a wrapped product; b == -1 (where the division
    # itself can overflow) overflows exactly when a is INT64_MIN
    special = (b == 0) | (b == -1)
    safe = torch.where(special, torch.ones_like(b), b)
    bad = ~special & (torch.div(r, safe, rounding_mode="floor") != a)
    return bad | ((a == _I64_MIN) & (b == -1))


def _binary_arith(op_name, op, checked):
    def eval_fn(ctx, out_dtype, args):
        a, b = args
        if out_dtype.is_long_decimal:
            f = I.add128 if op_name == "plus" else I.sub128
            lo, hi = f(*_limbs(a, out_dtype.scale, ctx),
                       *_limbs(b, out_dtype.scale, ctx))
            return _long_value(lo, hi, merge_validity(a, b), out_dtype)
        da, db = promote(_numeric_data(a, out_dtype),
                         _numeric_data(b, out_dtype))
        data = op(da, db)
        validity = merge_validity(a, b)
        if out_dtype.is_integral:
            # checked integer arithmetic (Presto semantics)
            err = checked(da, db, data) & _both_valid(a, b, ctx)
            validity = _flag(ctx, err, validity)
        return EvalValue(data, validity, out_dtype)
    register(op_name, arith_resolver(op_name), eval_fn)


def _decimal_operand(v: EvalValue):
    """(int64 data, scale) of a decimal or integer multiply operand."""
    if v.dtype.kind is T.TypeKind.DECIMAL:
        return v.data.to(torch.int64), v.dtype.scale
    return _numeric_data(v, T.decimal(18, 0)), 0


def _mul_long(ctx, out_dtype, a: EvalValue, b: EvalValue) -> EvalValue:
    """A long decimal times a short decimal or an integer: the low 128
    bits of the limbs times the int64 (ops/int128.py ``mul128_i64``), then
    the scale; a product of two long decimals raises, as in the
    reference (it may not fit 128 bits)."""
    if a.dtype.is_long_decimal and b.dtype.is_long_decimal:
        raise NotImplementedError(
            "decimal multiply with both operands over 18 digits "
            "overflows int128")
    big, small = (a, b) if a.dtype.is_long_decimal else (b, a)
    cap = ctx.capacity
    lo, hi = I.mul128_i64(big.full_data(cap), big.full_hi(cap),
                          small.full_data(cap).to(torch.int64))
    lo, hi = I.rescale_up(lo, hi, out_dtype.scale - big.dtype.scale
                          - _scale(small))
    return _long_value(lo, hi, merge_validity(a, b), out_dtype)


def _mul_eval(ctx, out_dtype, args):
    a, b = args
    if out_dtype.is_long_decimal:
        return _mul_long(ctx, out_dtype, a, b)
    if out_dtype.kind is T.TypeKind.DECIMAL:
        # exact decimal multiply: the scales add
        (da, sa), (db, sb) = _decimal_operand(a), _decimal_operand(b)
        data = _rescale_decimal(da * db, sa + sb, out_dtype.scale)
        return EvalValue(data, merge_validity(a, b), out_dtype)
    da, db = promote(_numeric_data(a, out_dtype),
                     _numeric_data(b, out_dtype))
    data = da * db
    validity = merge_validity(a, b)
    if out_dtype.is_integral:
        err = _ovf_mul(da, db, data) & _both_valid(a, b, ctx)
        validity = _flag(ctx, err, validity)
    return EvalValue(data, validity, out_dtype)


_binary_arith("plus", lambda a, b: a + b, _ovf_plus)
_binary_arith("minus", lambda a, b: a - b, _ovf_minus)
register("multiply", arith_resolver("multiply"), _mul_eval)


# ---------------------------------------------------------------------------
# Comparisons
# ---------------------------------------------------------------------------

_CMP_OPS = {
    "eq": torch.eq, "neq": torch.ne, "lt": torch.lt,
    "lte": torch.le, "gt": torch.gt, "gte": torch.ge,
}


def _limbs(v: EvalValue, to_scale: int, ctx):
    """(lo, hi) int128 limbs of a decimal or integer value, rescaled to
    `to_scale`; short values widen first, so the rescale cannot wrap."""
    cap = ctx.capacity
    if v.dtype.is_long_decimal:
        lo, hi = v.full_data(cap), v.full_hi(cap)
    else:
        lo, hi = I.from_i64(v.full_data(cap))
    return I.rescale_up(lo, hi, to_scale - _scale(v))


def _is_long(*vals) -> bool:
    return any(v.dtype.is_long_decimal for v in vals)


def _scale(v: EvalValue) -> int:
    return v.dtype.scale if v.dtype.kind is T.TypeKind.DECIMAL else 0


def compare_value(ctx, a: EvalValue, b: EvalValue, op: str) -> EvalValue:
    """Comparison over numerics, dates, booleans and dictionary strings."""
    if a.dtype.is_string or b.dtype.is_string:
        return _compare_strings(a, b, op)
    if _is_long(a, b):
        s = max(_scale(a), _scale(b))
        alo, ahi = _limbs(a, s, ctx)
        blo, bhi = _limbs(b, s, ctx)
        lt, eq = I.lt128(alo, ahi, blo, bhi), I.eq128(alo, ahi, blo, bhi)
        res = {"eq": eq, "neq": ~eq, "lt": lt, "lte": lt | eq,
               "gt": ~(lt | eq), "gte": ~lt}[op]
        return EvalValue(res, merge_validity(a, b), T.BOOLEAN)
    if a.dtype.is_numeric and b.dtype.is_numeric:
        common = promote_numeric(a.dtype, b.dtype)
        da = _numeric_data(a, common)
        db = _numeric_data(b, common)
    else:
        da, db = a.data, b.data
        if a.dtype.kind != b.dtype.kind:
            # date vs timestamp: lift the date to micros
            if a.dtype.kind is T.TypeKind.DATE:
                da = da.to(torch.int64) * 86400_000_000
            if b.dtype.kind is T.TypeKind.DATE:
                db = db.to(torch.int64) * 86400_000_000
    da, db = promote(da, db)
    return EvalValue(_CMP_OPS[op](da, db), merge_validity(a, b), T.BOOLEAN)


def eq_value(ctx, a: EvalValue, b: EvalValue) -> EvalValue:
    """SQL equality of two values of one element type: numerics across
    widths and scales, dates, booleans, long decimals, dictionary strings
    (ids of another dictionary translate into the first's) and string
    constants. The element-space functions (functions/complex.py) compare
    through it."""
    return compare_value(ctx, a, b, "eq")


def _require_sorted(d) -> None:
    if not d.is_sorted:
        vals = d.values
        if any(vals[i] > vals[i + 1] for i in range(len(vals) - 1)):
            raise ValueError(
                "ordered string comparison requires a sorted dictionary")
        d.is_sorted = True


def _ordered_constant(col: EvalValue, const: EvalValue, op: str):
    """Ordered compare of a column against a string constant the column's
    sorted dictionary lacks: the constant falls between two ids, at the
    insertion point ``pos``, so rows below ``pos`` are less than it and
    the rest greater."""
    pos = bisect.bisect_left(list(col.dictionary.values), const.py_value)
    below = col.data < pos
    return below if op in ("lt", "lte") else ~below


def _compare_strings(a: EvalValue, b: EvalValue, op: str) -> EvalValue:
    """Comparison of dictionary ids: eq/neq across any dictionaries (a
    second dictionary's ids translate into the first's through a host
    table), ordered compares within one sorted dictionary. Connectors and
    the Arrow bridge build sorted dictionaries (vector/device.py). A raw
    side compares bytes (functions/raw_strings.py)."""
    if S.is_raw(a) or S.is_raw(b):
        from velox_tpu_torch.functions.raw_strings import raw_compare
        return raw_compare(a, b, op)
    validity = merge_validity(a, b)
    if op not in ("eq", "neq"):
        # a constant absent from the dictionary has no id to order by
        for col, const, flip in ((a, b, False), (b, a, True)):
            if const.data is None and col.dictionary is not None \
                    and col.dictionary.id_of(const.py_value) < 0:
                _require_sorted(col.dictionary)
                if flip:
                    op = {"lt": "gt", "lte": "gte", "gt": "lt",
                          "gte": "lte"}[op]
                return EvalValue(_ordered_constant(col, const, op),
                                 validity, T.BOOLEAN)
    a, b = _align_strings(a, b)
    if a.data is None or b.data is None:
        raise ValueError("string comparison needs at least one dictionary-"
                         "backed side")
    da, db = a.data, b.data
    if a.dictionary is not b.dictionary:
        if op not in ("eq", "neq"):
            raise NotImplementedError(
                "ordered comparison across distinct dictionaries")
        table = torch.tensor([a.dictionary.id_of(v)
                              for v in b.dictionary.values],
                             dtype=torch.int32, device=db.device)
        db = table[db.long()]
    elif op not in ("eq", "neq"):
        _require_sorted(a.dictionary)
    return EvalValue(_CMP_OPS[op](da, db), validity, T.BOOLEAN)


for _op in _CMP_OPS:
    register(_op, _cmp_resolver,
             lambda ctx, out_dtype, args, _op=_op:
             compare_value(ctx, args[0], args[1], _op))


def fixed(out: T.DataType, *kinds_ok):
    """Resolver: ``out`` when each argument's kind is ``kinds_ok``'s (a
    TypeKind or a predicate)."""
    def resolver(arg_types):
        if kinds_ok and len(arg_types) != len(kinds_ok):
            return None
        for t, ok in zip(arg_types, kinds_ok):
            if callable(ok):
                if not ok(t):
                    return None
            elif t.kind is not ok:
                return None
        return out
    return resolver


def _floor_div(x, y):
    return torch.div(x, y, rounding_mode="floor")


def _half_up_div(d, p: int):
    """d / p rounded half away from zero (integer tensors)."""
    half = p // 2
    return torch.where(d >= 0, _floor_div(d + half, p),
                       -_floor_div(-d + half, p))


def _unary_numeric(ts):
    return ts[0] if len(ts) == 1 and ts[0].is_numeric else None


# ---------------------------------------------------------------------------
# Division, modulus, negation, absolute value
# ---------------------------------------------------------------------------

def _div_eval(ctx, out_dtype, args):
    a, b = args
    da, db = promote(_numeric_data(a, out_dtype), _numeric_data(b, out_dtype))
    if out_dtype.is_integral:
        # SQL integer division truncates toward zero; /0 is a checked
        # error (Presto DIVISION_BY_ZERO)
        db_safe = torch.where(db == 0, torch.ones_like(db), db)
        q = torch.sign(da) * torch.sign(db_safe) \
            * _floor_div(torch.abs(da), torch.abs(db_safe))
        err = (db == 0) & _both_valid(a, b, ctx)
        validity = _flag(ctx, err, merge_validity(a, b))
        return EvalValue(q.to(out_dtype.torch_dtype()), validity, out_dtype)
    return EvalValue(da / db, merge_validity(a, b), out_dtype)


def _mod_eval(ctx, out_dtype, args):
    a, b = args
    da, db = promote(_numeric_data(a, out_dtype), _numeric_data(b, out_dtype))
    # SQL mod: the sign follows the dividend; %0 is a checked error
    db_safe = torch.where(db == 0, torch.ones_like(db), db)
    data = torch.sign(da) * torch.remainder(torch.abs(da),
                                            torch.abs(db_safe))
    err = (db == 0) & _both_valid(a, b, ctx)
    validity = _flag(ctx, err, merge_validity(a, b))
    return EvalValue(data.to(out_dtype.torch_dtype()), validity, out_dtype)


def _long_value(lo, hi, validity, out_dtype) -> EvalValue:
    from velox_tpu_torch.vector.device import DeviceColumn
    return EvalValue(lo, validity, out_dtype,
                     children=(DeviceColumn(hi, None, T.BIGINT),))


def _neg_eval(ctx, out_dtype, args):
    (a,) = args
    if out_dtype.is_long_decimal:
        lo, hi = I.neg128(*_limbs(a, out_dtype.scale, ctx))
        return _long_value(lo, hi, a.validity, out_dtype)
    return EvalValue(-a.data, a.validity, out_dtype)


def _abs_eval(ctx, out_dtype, args):
    (a,) = args
    if out_dtype.is_long_decimal:
        # both limbs (the reference takes abs of the low limb alone;
        # ROADMAP C)
        lo, hi, _ = I.abs128(*_limbs(a, out_dtype.scale, ctx))
        return _long_value(lo, hi, a.validity, out_dtype)
    return EvalValue(torch.abs(a.data), a.validity, out_dtype)


register("divide", arith_resolver("divide"), _div_eval)
register("mod", arith_resolver("mod"), _mod_eval)
register("negate", _unary_numeric, _neg_eval)
register("abs", _unary_numeric, _abs_eval)


# ---------------------------------------------------------------------------
# Math (double domain)
# ---------------------------------------------------------------------------

def _cbrt(x):
    """Real cube root: pow of |x| and one Newton step."""
    y = torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)
    safe = torch.where(y == 0, torch.ones_like(y), y)
    step = (safe * safe * safe - x) / (3.0 * safe * safe)
    return torch.where((y == 0) | ~torch.isfinite(y), y, y - step)


def _unary_math(name, fn):
    def eval_fn(ctx, out_dtype, args):
        (a,) = args
        return EvalValue(fn(_numeric_data(a, T.DOUBLE)), a.validity,
                         out_dtype)
    register(name,
             lambda ts: T.DOUBLE if len(ts) == 1 and ts[0].is_numeric
             else None, eval_fn)


for _name, _fn in (("sqrt", torch.sqrt), ("cbrt", _cbrt), ("ln", torch.log),
                   ("log2", torch.log2), ("log10", torch.log10),
                   ("exp", torch.exp), ("sin", torch.sin),
                   ("cos", torch.cos), ("tan", torch.tan)):
    _unary_math(_name, _fn)


def _long_ceil_floor(ctx, a: EvalValue, out_dtype, ceiling: bool):
    """ceil/floor of a DECIMAL(19..38): |x| divided by 10^scale with its
    remainder (ops/int128.py ``divmod128_u64``), the quotient moved one
    away from zero where the rounding direction and the sign ask for it.
    (The reference divides the low limb alone; ROADMAP C.)"""
    cap = ctx.capacity
    alo, ahi, neg = I.abs128(a.full_data(cap), a.full_hi(cap))
    d = torch.full((cap,), 10 ** a.dtype.scale, dtype=torch.int64,
                   device=ctx.device)
    qlo, qhi, rem = I.divmod128_u64(alo, ahi, d)
    bump = (rem != 0) & (neg if not ceiling else ~neg)
    qlo, qhi = I.add128(qlo, qhi, bump.to(torch.int64),
                        torch.zeros_like(qhi))
    nlo, nhi = I.neg128(qlo, qhi)
    lo, hi = torch.where(neg, nlo, qlo), torch.where(neg, nhi, qhi)
    if out_dtype.is_long_decimal:
        return _long_value(lo, hi, a.validity, out_dtype)
    return EvalValue(lo, a.validity, out_dtype)


def _ceil_floor(name, fn):
    def resolver(ts):
        if len(ts) != 1 or not ts[0].is_numeric:
            return None
        return ts[0] if ts[0].is_integral else (
            T.decimal(ts[0].precision, 0)
            if ts[0].kind is T.TypeKind.DECIMAL else T.DOUBLE)

    def eval_fn(ctx, out_dtype, args):
        (a,) = args
        if a.dtype.is_integral:
            return EvalValue(a.data, a.validity, out_dtype)
        if a.dtype.is_long_decimal:
            return _long_ceil_floor(ctx, a, out_dtype, name == "ceiling")
        if a.dtype.kind is T.TypeKind.DECIMAL:
            s = 10 ** a.dtype.scale
            d = a.data
            if name == "ceiling":
                data = torch.where(d >= 0, _floor_div(d + s - 1, s),
                                   _floor_div(d, s))
            else:
                data = torch.where(d >= 0, _floor_div(d, s),
                                   -_floor_div(-d + s - 1, s))
            return EvalValue(data, a.validity, out_dtype)
        return EvalValue(fn(a.data.to(torch.float64)), a.validity,
                         out_dtype)
    register(name, resolver, eval_fn)


_ceil_floor("ceiling", torch.ceil)
_ceil_floor("floor", torch.floor)
_REGISTRY["ceil"] = _REGISTRY["ceiling"]


def _round_eval(ctx, out_dtype, args):
    a = args[0]
    nd = 0
    if len(args) > 1:
        nd = int(args[1].py_value if args[1].py_value is not None
                 else args[1].data)
    if a.dtype.kind is T.TypeKind.DECIMAL:
        diff = a.dtype.scale - nd
        if diff <= 0:
            return a
        p = 10 ** diff
        if a.dtype.is_long_decimal:
            lo, hi = I.div128_round_half_up(
                a.full_data(ctx.capacity), a.full_hi(ctx.capacity),
                torch.full((ctx.capacity,), p, dtype=torch.int64,
                           device=ctx.device))
            lo, hi = I.rescale_up(lo, hi, diff)
            return _long_value(lo, hi, a.validity, out_dtype)
        return EvalValue(_half_up_div(a.data, p) * p, a.validity, out_dtype)
    if a.dtype.is_integral:
        return EvalValue(a.data, a.validity, out_dtype)
    scale = 10.0 ** nd
    d = a.data.to(torch.float64) * scale
    # half away from zero (Presto), not banker's rounding
    data = torch.where(d >= 0, torch.floor(d + 0.5),
                       torch.ceil(d - 0.5)) / scale
    return EvalValue(data, a.validity, out_dtype)


register("round",
         lambda ts: (ts[0] if ts and ts[0].is_numeric and len(ts) <= 2
                     else None),
         _round_eval)


def _power_eval(ctx, out_dtype, args):
    a, b = args
    return EvalValue(torch.pow(_numeric_data(a, T.DOUBLE),
                               _numeric_data(b, T.DOUBLE)),
                     merge_validity(a, b), T.DOUBLE)


register("power",
         lambda ts: (T.DOUBLE if len(ts) == 2
                     and all(t.is_numeric for t in ts) else None),
         _power_eval)
_REGISTRY["pow"] = _REGISTRY["power"]


def _sign_eval(ctx, out_dtype, args):
    (a,) = args
    if a.dtype.is_long_decimal:
        lo, hi = a.full_data(ctx.capacity), a.full_hi(ctx.capacity)
        sign = torch.where(hi < 0, -1, ((hi != 0) | (lo != 0)).to(
            torch.int64))
        return EvalValue(sign.to(torch.int64), a.validity, out_dtype)
    return EvalValue(torch.sign(a.data).to(out_dtype.torch_dtype()),
                     a.validity, out_dtype)


register("sign",
         lambda ts: (ts[0] if len(ts) == 1 and ts[0].is_floating
                     else T.BIGINT if len(ts) == 1 and ts[0].is_numeric
                     else None),
         _sign_eval)


def _minmax2(name, fn):
    def eval_fn(ctx, out_dtype, args):
        out = args[0]
        for b in args[1:]:
            da, db = promote(_numeric_data(out, out_dtype),
                             _numeric_data(b, out_dtype))
            out = EvalValue(fn(da, db), merge_validity(out, b), out_dtype)
        return out

    def resolver(ts):
        if not ts or not all(t.is_numeric for t in ts):
            return None
        out = ts[0]
        for t in ts[1:]:
            out = promote_numeric(out, t)
        return out
    register(name, resolver, eval_fn)


_minmax2("greatest", torch.maximum)
_minmax2("least", torch.minimum)


# ---------------------------------------------------------------------------
# Dictionary strings: a host pass over the dictionary's values, then one
# device gather of the result table by the column's ids
# ---------------------------------------------------------------------------

def _require_dict(v: EvalValue, fname: str) -> Dictionary:
    if v.dictionary is None:
        # the reference has no raw form of these either
        raise NotImplementedError(
            f"{fname} over a raw (dictionary-less) string column is not "
            "supported")
    return v.dictionary


# (kind, id(dictionary), device) -> (dictionary, value); the entry holds
# its dictionary, so an id is never reused while it is cached
_DICT_CACHE: "OrderedDict" = OrderedDict()
_DICT_CACHE_MAX = 32


def dict_cached(kind, d: Dictionary, device, make):
    """``make()`` (device tables of dictionary ``d``'s values) once per
    (kind, dictionary, device) among the last ``_DICT_CACHE_MAX``."""
    key = (kind, id(d), str(device))
    hit = _DICT_CACHE.get(key)
    if hit is not None and hit[0] is d:
        _DICT_CACHE.move_to_end(key)
        return hit[1]
    out = make()
    _DICT_CACHE[key] = (d, out)
    while len(_DICT_CACHE) > _DICT_CACHE_MAX:
        _DICT_CACHE.popitem(last=False)
    return out


def _gather_table(table: np.ndarray, v: EvalValue) -> torch.Tensor:
    """``table[ids]`` on the column's device; ids are clamped into the
    table, as a JAX gather clamps them (NULL rows may hold any id)."""
    dev = v.data.device
    ids = v.data.long().clamp(0, max(len(table) - 1, 0))
    if not len(table):
        return torch.zeros(ids.shape, dtype=torch.as_tensor(table).dtype,
                           device=dev)
    return torch.as_tensor(table, device=dev)[ids]


def _remap(v: EvalValue, vals, out_dtype=T.VARCHAR) -> EvalValue:
    """The column's rows mapped to ``vals`` (one new value a dictionary
    value). Distinct values may map to one (substr, lower, trim), and
    duplicate values would break id equality and grouping, so the output
    dictionary is the sorted distinct results and the ids are remapped
    through one device gather."""
    uniq = sorted(set(vals))
    new_id = {x: i for i, x in enumerate(uniq)}
    remap = np.fromiter((new_id[x] for x in vals), dtype=np.int32,
                        count=len(vals))
    new_dict = Dictionary(uniq)
    new_dict.is_sorted = True
    return EvalValue(_gather_table(remap, v), v.validity, out_dtype,
                     new_dict)


def _dict_map(v: EvalValue, f, fname: str,
              out_dtype=T.VARCHAR) -> EvalValue:
    """Dictionary-to-dictionary transform by ``f``."""
    d = _require_dict(v, fname)
    return _remap(v, [f(x) for x in d.values], out_dtype)


def _with_nulls(out: EvalValue, v: EvalValue, vals) -> EvalValue:
    """``out`` with the rows whose dictionary value maps to None NULL."""
    nulls = np.array([x is None for x in vals], dtype=bool)
    if not nulls.any():
        return out
    valid = ~_gather_table(nulls, v)
    if v.validity is not None:
        valid = v.validity & valid
    return EvalValue(out.data, valid, out.dtype, out.dictionary)


def _dict_map_values(v: EvalValue, vals) -> EvalValue:
    """``_remap`` to VARCHAR values of which some may be None (NULL)."""
    out = _remap(v, ["" if x is None else x for x in vals])
    return _with_nulls(out, v, vals)


def _dict_map_nullable(v: EvalValue, f, fname: str) -> EvalValue:
    """``_dict_map`` where ``f`` may return None: those rows are NULL."""
    d = _require_dict(v, fname)
    return _dict_map_values(v, [f(x) for x in d.values])


def _dict_lookup_values(v: EvalValue, vals, out_dtype) -> EvalValue:
    """Each dictionary value's entry of ``vals`` (None: NULL), gathered
    by id on the device."""
    table = np.array([0 if x is None else x for x in vals],
                     dtype=out_dtype.np_dtype())
    out = EvalValue(_gather_table(table, v), v.validity, out_dtype)
    return _with_nulls(out, v, vals)


def _dict_lookup(v: EvalValue, f, out_dtype, fname: str) -> EvalValue:
    """``f`` of each dictionary value, gathered by id on the device; a
    None result makes the row NULL."""
    d = _require_dict(v, fname)
    return _dict_lookup_values(v, [f(x) for x in d.values], out_dtype)


def _str_resolver(out):
    def resolver(ts):
        return out if ts and ts[0].is_string else None
    return resolver


def _pa_values(v: EvalValue, pa_fn, py_f, fname: str) -> list:
    """``pa_fn(pyarrow.compute, values)`` over the dictionary's values in
    one pyarrow call, as a Python list, or ``py_f`` of each value where
    pyarrow rejects the input (the reference's fallback)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    d = _require_dict(v, fname)
    try:
        return pa_fn(pc, pa.array(list(d.values), pa.string())).to_pylist()
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        return [py_f(x) for x in d.values]


def _dict_map_pa(v: EvalValue, pa_fn, py_f, fname: str) -> EvalValue:
    """``_dict_map`` through a pyarrow kernel (the reference's mapping:
    utf8proc's per-code-point case tables, Unicode whitespace, RE2)."""
    return _dict_map_values(v, _pa_values(v, pa_fn, py_f, fname))


def _dict_lookup_pa(v: EvalValue, pa_fn, py_f, out_dtype,
                    fname: str) -> EvalValue:
    return _dict_lookup_values(v, _pa_values(v, pa_fn, py_f, fname),
                               out_dtype)


for _name, _pa, _f in (("lower", "utf8_lower", str.lower),
                       ("upper", "utf8_upper", str.upper),
                       ("trim", "utf8_trim_whitespace", str.strip),
                       ("ltrim", "utf8_ltrim_whitespace", str.lstrip),
                       ("rtrim", "utf8_rtrim_whitespace", str.rstrip),
                       ("reverse", "utf8_reverse", lambda s: s[::-1])):
    register(_name, _str_resolver(T.VARCHAR),
             lambda ctx, o, a, _p=_pa, _f=_f, _n=_name:
             _dict_map_pa(a[0], lambda pc, src: getattr(pc, _p)(src), _f,
                          _n))
register("length", _str_resolver(T.BIGINT),
         lambda ctx, o, a: _dict_lookup_pa(
             a[0], lambda pc, src: pc.utf8_length(src), len, T.BIGINT,
             "length"))


def _substr_eval(ctx, out_dtype, args):
    start = int(args[1].py_value)
    length = int(args[2].py_value) if len(args) > 2 else None

    def f(s):
        # 1-based start; a negative start counts from the end
        i = start - 1 if start > 0 else len(s) + start
        if i < 0:
            i = 0
        return s[i:i + length] if length is not None else s[i:]
    return _dict_map(args[0], f, "substr")


register("substr", lambda ts: T.VARCHAR if ts and ts[0].is_string else None,
         _substr_eval)
_REGISTRY["substring"] = _REGISTRY["substr"]


def _like_regex(pattern: str):
    """A LIKE pattern as an anchored regex: % any run, _ one character,
    everything else literal."""
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.S)


def _like_eval(ctx, out_dtype, args):
    pattern = args[1].py_value
    if pattern is None:
        raise NotImplementedError("LIKE pattern must be a constant")
    rx = _like_regex(pattern)
    return _dict_lookup(args[0], lambda s: bool(rx.match(s)), T.BOOLEAN,
                        "like")


register("like", _str_resolver(T.BOOLEAN), _like_eval)


def _string_test(name, f, out=T.BOOLEAN):
    def eval_fn(ctx, out_dtype, args):
        v, arg = args
        s = arg.py_value
        return _dict_lookup(v, lambda x: f(x, s), out, name)
    register(name, _str_resolver(out), eval_fn)


_string_test("starts_with", lambda x, s: x.startswith(s))
_string_test("ends_with", lambda x, s: x.endswith(s))
_string_test("strpos", lambda x, s: x.find(s) + 1, T.BIGINT)


def _concat_eval(ctx, out_dtype, args):
    # a column with constant prefixes/suffixes; column || column needs the
    # product dictionary (not in the reference either)
    col = None
    for a in args:
        if a.py_value is None:
            if col is not None:
                raise NotImplementedError("concat of two string columns")
            col = a
    parts = [a.py_value for a in args]

    def f(s):
        return "".join(p if p is not None else s for p in parts)
    return _dict_map(col, f, "concat")


register("concat",
         lambda ts: T.VARCHAR if ts and all(t.is_string for t in ts)
         else None, _concat_eval)


def _replace_eval(ctx, out_dtype, args):
    old = args[1].py_value
    new = args[2].py_value if len(args) > 2 else ""
    return _dict_map(args[0], lambda s: s.replace(old, new), "replace")


register("replace", _str_resolver(T.VARCHAR), _replace_eval)


# ---------------------------------------------------------------------------
# Date parts (DATE = int32 days since 1970-01-01)
# ---------------------------------------------------------------------------

def _civil_from_days(days):
    """Days since the epoch -> (year, month, day), Howard Hinnant's
    branch-free algorithm over int64."""
    z = days.to(torch.int64) + 719468
    era = _floor_div(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _floor_div(doe - _floor_div(doe, 1460) + _floor_div(doe, 36524)
                     - _floor_div(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _floor_div(yoe, 4) - _floor_div(yoe, 100))
    mp = _floor_div(5 * doy + 2, 153)
    d = doy - _floor_div(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = _floor_div(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _floor_div(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _floor_div(yoe, 4) - _floor_div(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _date_days(v: EvalValue):
    if v.dtype.kind is T.TypeKind.DATE:
        return v.data
    if v.dtype.kind is T.TypeKind.TIMESTAMP:
        return _floor_div(v.data, 86400_000_000).to(torch.int32)
    raise TypeError(f"not a date: {v.dtype}")


_DATELIKE = fixed(T.BIGINT, lambda t: t.kind in (T.TypeKind.DATE,
                                                 T.TypeKind.TIMESTAMP))


def _date_part(name, picker):
    def eval_fn(ctx, out_dtype, args):
        (v,) = args
        y, m, d = _civil_from_days(_date_days(v))
        return EvalValue(picker(y, m, d).to(torch.int64), v.validity,
                         T.BIGINT)
    register(name, _DATELIKE, eval_fn)


_date_part("year", lambda y, m, d: y)
_date_part("month", lambda y, m, d: m)
_date_part("day", lambda y, m, d: d)
_date_part("quarter", lambda y, m, d: _floor_div(m - 1, 3) + 1)


def _dow_eval(ctx, out_dtype, args):
    (v,) = args
    # 1970-01-01 was a Thursday; ISO day of week 1 = Monday .. 7 = Sunday
    days = _date_days(v).to(torch.int64)
    return EvalValue(torch.remainder(days + 3, 7) + 1, v.validity, T.BIGINT)


def _doy_eval(ctx, out_dtype, args):
    (v,) = args
    days = _date_days(v)
    y, m, d = _civil_from_days(days)
    jan1 = _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
    return EvalValue(days.to(torch.int64) - jan1 + 1, v.validity, T.BIGINT)


register("day_of_week", _DATELIKE, _dow_eval)
_REGISTRY["dow"] = _REGISTRY["day_of_week"]
register("day_of_year", _DATELIKE, _doy_eval)
_REGISTRY["doy"] = _REGISTRY["day_of_year"]


# ---------------------------------------------------------------------------
# $hash: the reference's internal 64-bit row hash. The uint64 lanes of the
# reference are int64 here with the same 64 bits: products wrap the same,
# and each right shift is masked to a logical one (torch has no uint64
# shift on this build).
# ---------------------------------------------------------------------------

def _s64(c: int) -> int:
    """The int64 with the bits of the uint64 constant ``c``."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _srl64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 lanes holding uint64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


_HASH_M1 = _s64(0xFF51AFD7ED558CCD)
_HASH_M2 = _s64(0xC4CEB9FE1A85EC53)
_HASH_GOLDEN = _s64(0x9E3779B97F4A7C15)
_HASH_ADD = 0x2545F4914F6CDD1D


def hash64(data: torch.Tensor) -> torch.Tensor:
    """Murmur3's 64-bit finalizer over int64 lanes."""
    x = data.to(torch.int64)
    x = x ^ _srl64(x, 33)
    x = x * _HASH_M1
    x = x ^ _srl64(x, 33)
    x = x * _HASH_M2
    return x ^ _srl64(x, 33)


def combine_hash(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    return h1 * _HASH_GOLDEN + h2 + _HASH_ADD


def hash_value(v: EvalValue, capacity: int) -> torch.Tensor:
    """The 64-bit hash of a value (int64 lanes); NULLs hash to a fixed
    tag. Floats hash their bits (REAL's sign-extended), everything else
    its data widened to int64: dictionary ids for strings, the low limb
    of a long decimal, as in the reference."""
    data = v.full_data(capacity)
    if v.dtype.kind is T.TypeKind.REAL:
        raw = data.to(torch.float32).contiguous().view(torch.int32) \
            .to(torch.int64)
    elif v.dtype.kind is T.TypeKind.DOUBLE:
        raw = data.to(torch.float64).contiguous().view(torch.int64)
    else:
        raw = data.to(torch.int64)
    h = hash64(raw)
    if v.validity is not None:
        h = torch.where(v.full_validity(capacity), h, _HASH_GOLDEN)
    return h


def _hash_eval(ctx, out_dtype, args):
    h = hash_value(args[0], ctx.capacity)
    for a in args[1:]:
        h = combine_hash(h, hash_value(a, ctx.capacity))
    return EvalValue(h, None, T.BIGINT)


register("$hash", lambda ts: T.BIGINT if ts else None, _hash_eval)

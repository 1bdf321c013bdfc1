"""Presto-semantics scalar functions: the subset of the ported slice.

Counterpart of ``velox_tpu/functions/scalar.py``, reduced to what the
filters and projections of TPC-H Q6, Q1, Q3 and Q18 evaluate:

* comparisons (eq, neq, lt, lte, gt, gte) over integers, DATE and short
  DECIMAL, with decimal constants rescaled to the common scale; over long
  decimals (DECIMAL(19..38), int128 limbs); and over dictionary strings
  (ids; ordered compares need a sorted dictionary);
* plus, minus and multiply over integers and short decimals, with the
  reference's checked-overflow flags for integer results.

Type resolution (promotion, result types) is the reference's, copied, so
plans type identically in both engines. Long-decimal arithmetic and raw
(dictionary-less) strings are not ported yet and raise.
"""

from __future__ import annotations

import bisect

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import (
    EvalValue, _align_strings, merge_validity, promote,
)
from velox_tpu_torch.functions.registry import register
from velox_tpu_torch.ops import int128 as I

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
    for v in vals:
        if v.dtype.is_long_decimal:
            raise NotImplementedError(
                f"{v.dtype} (int128 limbs) is not ported to velox_tpu_torch")


def _numeric_data(v: EvalValue, target: T.DataType):
    """Convert EvalValue data to the computation dtype of `target`."""
    _no_long(v)
    if target.is_long_decimal:
        raise NotImplementedError(
            f"{target} (int128 limbs) is not ported to velox_tpu_torch")
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


def _mul_eval(ctx, out_dtype, args):
    a, b = args
    _no_long(a, b)
    if out_dtype.kind is T.TypeKind.DECIMAL:
        # exact decimal multiply: the scales add
        if out_dtype.is_long_decimal:
            raise NotImplementedError(
                f"{out_dtype} (int128 limbs) is not ported to "
                "velox_tpu_torch")
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


def _is_raw(v: EvalValue) -> bool:
    return v.data is not None and v.dictionary is None


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
    the Arrow bridge build sorted dictionaries (vector/device.py)."""
    if _is_raw(a) or _is_raw(b):
        raise NotImplementedError(
            "raw (dictionary-less) string comparison is not ported to "
            "velox_tpu_torch (ROADMAP A.11)")
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

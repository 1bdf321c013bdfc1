"""Vectorized expression evaluation: typed expr tree -> torch tensor ops.

Counterpart of ``velox_tpu/expression/eval.py``. An ``ExprSet`` evaluates
its expressions eagerly over a ``DeviceBatch``: every node is one or a few
torch operations over dense ``(capacity,)`` tensors on the batch's device.

* CSE: identical (hashable) subtrees are evaluated once per ``eval_batch``
  through a value cache, as in the reference.
* Validity is Optional: None means "no nulls" and no null bookkeeping runs.
* Dense masked execution: the batch mask matters to operators, not to
  expressions; masked-out rows compute harmless values.
* SQL three-valued logic: default null propagation (validity AND) in the
  functions, Kleene AND/OR in the special forms here, and the ``if`` (which
  CASE parses to) and ``coalesce`` forms.
* CAST/TRY_CAST nodes evaluate through functions/casts.py.
* Error channel: checked operations (integer overflow) flag rows on the
  ``EvalCtx``; callers reduce the flags to a per-batch count
  (common/errors.py). ``try(...)`` turns flagged rows into NULLs.

Integer promotion follows the reference (JAX with 64-bit types on): two
tensors combine in their promoted dtype, so an int32 column against an
int64 constant computes in int64. Torch would keep the column's int32 when
the int64 side is a 0-dim tensor, so the functions widen explicitly
(``promote``). A Python int keeps the tensor's dtype in both frameworks.
"""

from __future__ import annotations

import datetime
import decimal as pydec
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common.process_trace import spanned
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.ops.int128 import from_python_int
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn, Dictionary
from velox_tpu_torch.vector.strings import reject_raw


@dataclass
class EvalValue:
    """A (possibly scalar-broadcast) column value during evaluation.

    data: tensor of shape () or (capacity,). For strings: int32 dict ids.
    validity: None (no nulls) or a bool tensor broadcastable to data.
    py_value: set for unresolved string and complex constants (data is
    None) and kept beside every constant's device scalar.
    children: the high-limb column of a long decimal; the element columns
    of an ARRAY/MAP (data holds the counts) and the fields of a ROW.
    starts: an ARRAY/MAP's explicit element starts (vector/device.py).
    """

    data: Any
    validity: Optional[Any]
    dtype: T.DataType
    dictionary: Optional[Dictionary] = None
    py_value: Any = None
    children: tuple = ()
    starts: Any = None

    @property
    def is_scalar(self) -> bool:
        return self.data is not None and self.data.dim() == 0

    def full_data(self, capacity: int):
        if self.data is None:
            raise ValueError(
                f"unresolved constant {self.py_value!r}: string constants "
                "must be consumed by a string-aware function")
        if self.data.dim() == 0:
            return self.data.expand(capacity)
        return self.data

    def full_validity(self, capacity: int):
        if self.validity is None:
            return torch.ones((capacity,), dtype=torch.bool,
                              device=self.data.device)
        if self.validity.dim() == 0:
            return self.validity.expand(capacity)
        return self.validity

    def full_hi(self, capacity: int):
        """The high limb of a long decimal, row-aligned (zeros when the
        value carries none)."""
        if not self.children:
            return torch.zeros((capacity,), dtype=torch.int64,
                               device=self.data.device)
        hi = self.children[0].data
        return hi.expand(capacity) if hi.dim() == 0 else hi

    def to_column(self, capacity: int) -> DeviceColumn:
        v = self.validity
        if v is not None and v.dim() == 0:
            v = v.expand(capacity).contiguous()
        children = tuple(
            DeviceColumn(c.data.expand(capacity).contiguous(), None,
                         c.dtype) if c.data.dim() == 0 else c
            for c in self.children)
        return DeviceColumn(self.full_data(capacity).contiguous(), v,
                            self.dtype, self.dictionary, children,
                            self.starts)


def value_from_column(col: DeviceColumn) -> EvalValue:
    return EvalValue(col.data, col.validity, col.dtype, col.dictionary,
                     children=col.children, starts=col.starts)


def merge_validity(*vals: EvalValue):
    """AND of argument validities (default SQL null propagation)."""
    out = None
    for v in vals:
        if v.validity is None:
            continue
        out = v.validity if out is None else (out & v.validity)
    return out


def promote(x: torch.Tensor, y: torch.Tensor):
    """Cast both operands to their promoted dtype, whatever their ranks."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


class EvalCtx:
    """Per-eval context: input columns, capacity, device, error channel.

    ``errors`` is a lazily created bool[capacity] mask of rows where a
    checked operation failed.
    """

    def __init__(self, columns: Dict[str, EvalValue], capacity: int,
                 device: torch.device):
        self.columns = columns
        self.capacity = capacity
        self.device = device
        self.errors = None

    def flag_error(self, mask) -> None:
        self.errors = mask if self.errors is None else (self.errors | mask)


_cse_disabled = False


def set_cse_disabled(flag: bool):
    """kDebugDisableCommonSubExpressions: evaluate every subtree anew
    instead of once per batch (a debugging aid; the Task sets it around
    a run whose config asks for it)."""
    global _cse_disabled
    _cse_disabled = flag


class ExprSet:
    """A set of expressions evaluated together with CSE."""

    def __init__(self, exprs: List[ex.TypedExpr], input_type: T.DataType):
        self.exprs = list(exprs)
        self.input_type = input_type

    @spanned("eval")
    def eval_batch(self, batch: DeviceBatch,
                   err_sink: Optional[list] = None) -> List[EvalValue]:
        """Evaluate all expressions. When ``err_sink`` (a list) is given,
        the per-row error mask (or None) is appended to it."""
        cols = {name: value_from_column(col)
                for name, col in batch.columns.items()}
        ctx = EvalCtx(cols, batch.capacity, batch.device)
        cache: Dict[ex.TypedExpr, EvalValue] = {}
        out = [_eval(e, ctx, cache) for e in self.exprs]
        if err_sink is not None:
            err_sink.append(ctx.errors)
        return out


def compile_exprs(exprs, input_type: T.DataType) -> ExprSet:
    return ExprSet(exprs, input_type)


def evaluate(expr: ex.TypedExpr, batch: DeviceBatch) -> EvalValue:
    """One-off evaluation of a single expression against a batch."""
    return ExprSet([expr], batch.row_type()).eval_batch(batch)[0]


# ---------------------------------------------------------------------------
# Core recursive evaluator.
# ---------------------------------------------------------------------------

_SPECIAL_FORMS = {}


def special_form(name):
    def deco(fn):
        _SPECIAL_FORMS[name] = fn
        return fn
    return deco


def _eval(expr: ex.TypedExpr, ctx: EvalCtx, cache) -> EvalValue:
    if _cse_disabled:
        return _eval_uncached(expr, ctx, cache)
    hit = cache.get(expr)
    if hit is not None:
        return hit
    out = _eval_uncached(expr, ctx, cache)
    cache[expr] = out
    return out


def _eval_uncached(expr, ctx, cache) -> EvalValue:
    if isinstance(expr, ex.FieldAccess):
        try:
            return ctx.columns[expr.name]
        except KeyError:
            raise KeyError(
                f"column {expr.name!r} not in input "
                f"{sorted(ctx.columns)}") from None
    if isinstance(expr, ex.Constant):
        return _eval_constant(expr, ctx)
    if isinstance(expr, ex.Cast):
        from velox_tpu_torch.functions import casts
        return casts.cast(ctx, _eval(expr.child, ctx, cache), expr.dtype,
                          is_try=expr.is_try)
    if isinstance(expr, ex.Call):
        sf = _SPECIAL_FORMS.get(expr.name)
        if sf is not None:
            return sf(expr, ctx, cache)
        args = [_eval(a, ctx, cache) for a in expr.args]
        from velox_tpu_torch.functions.registry import lookup
        fn = lookup(expr.name, [a.dtype for a in expr.args])
        return fn.eval(ctx, expr.dtype, args)
    raise NotImplementedError(
        f"{type(expr).__name__} expressions are not ported to "
        "velox_tpu_torch")


def _eval_constant(expr: ex.Constant, ctx: EvalCtx) -> EvalValue:
    dt = expr.dtype
    v = expr.value
    dev = ctx.device
    if v is None:
        return ex_null(dt, dev)
    if dt.is_string or dt.is_complex:
        # unresolved until a consumer binds it against a dictionary (a
        # string) or reads its Python value (a complex constant)
        return EvalValue(None, None, dt, py_value=v)
    if dt.kind is T.TypeKind.DECIMAL and not isinstance(v, int):
        # float/Decimal literals: store the scaled int
        v = int(pydec.Decimal(str(v)).scaleb(dt.scale)
                .to_integral_value(rounding=pydec.ROUND_HALF_UP))
    if dt.is_long_decimal:
        v = int(v)
        lo, hi = from_python_int(v)
        hi_col = DeviceColumn(
            torch.tensor(hi, dtype=torch.int64, device=dev), None, T.BIGINT)
        return EvalValue(torch.tensor(lo, dtype=torch.int64, device=dev),
                         None, dt, children=(hi_col,), py_value=v)
    if dt.kind is T.TypeKind.DATE and isinstance(v, str):
        v = (datetime.date.fromisoformat(v)
             - datetime.date(1970, 1, 1)).days
    return EvalValue(torch.tensor(v, dtype=dt.torch_dtype(), device=dev),
                     None, dt, py_value=v)


def ex_null(dt: T.DataType, device) -> EvalValue:
    """A NULL scalar of type ``dt``."""
    tdt = dt.torch_dtype() if dt.is_fixed_width else torch.int32
    return EvalValue(torch.zeros((), dtype=tdt, device=device),
                     torch.zeros((), dtype=torch.bool, device=device), dt)


# ---------------------------------------------------------------------------
# Special forms: Kleene AND/OR, NOT, IF, COALESCE, BETWEEN, IN,
# IS [NOT] NULL, TRY. Dense execution has no short-circuiting.
# ---------------------------------------------------------------------------

def _as_bool3(v: EvalValue, ctx):
    """(value, known) pair for 3-valued logic; null -> known=False."""
    data = v.full_data(ctx.capacity).to(torch.bool)
    if v.validity is None:
        return data, None
    return data, v.full_validity(ctx.capacity)


@special_form("and")
def _and(expr, ctx, cache):
    vals = [_eval(a, ctx, cache) for a in expr.args]
    # Kleene: FALSE dominates NULL
    acc_v, acc_k = _as_bool3(vals[0], ctx)
    for v in vals[1:]:
        d, k = _as_bool3(v, ctx)
        res = acc_v & d
        if acc_k is None and k is None:
            acc_v, acc_k = res, None
        else:
            ak = acc_k if acc_k is not None else torch.ones_like(res)
            bk = k if k is not None else torch.ones_like(res)
            known = (ak & bk) | (ak & ~acc_v) | (bk & ~d)
            acc_v, acc_k = res & ak & bk, known
    return EvalValue(acc_v, acc_k, T.BOOLEAN)


@special_form("or")
def _or(expr, ctx, cache):
    vals = [_eval(a, ctx, cache) for a in expr.args]
    # Kleene: TRUE dominates NULL
    acc_v, acc_k = _as_bool3(vals[0], ctx)
    for v in vals[1:]:
        d, k = _as_bool3(v, ctx)
        res = acc_v | d
        if acc_k is None and k is None:
            acc_v, acc_k = res, None
        else:
            ak = acc_k if acc_k is not None else torch.ones_like(res)
            bk = k if k is not None else torch.ones_like(res)
            known = (ak & bk) | (ak & acc_v) | (bk & d)
            acc_v = (acc_v & ak) | (d & bk)
            acc_k = known
    return EvalValue(acc_v, acc_k, T.BOOLEAN)


@special_form("not")
def _not(expr, ctx, cache):
    v = _eval(expr.args[0], ctx, cache)
    return EvalValue(~v.data.to(torch.bool), v.validity, T.BOOLEAN)


def _where_hi(take, a: EvalValue, b: EvalValue, dt: T.DataType, cap: int):
    """The high limb of a long-decimal result chosen row by row (a short
    branch's is its sign)."""
    if not dt.is_long_decimal:
        return ()
    from velox_tpu_torch.vector.device import DeviceColumn

    def hi(v: EvalValue):
        if v.dtype.is_long_decimal:
            return v.full_hi(cap)
        return v.full_data(cap).to(torch.int64) >> 63
    return (DeviceColumn(torch.where(take, hi(a), hi(b)), None, T.BIGINT),)


@special_form("if")
def _if(expr, ctx, cache):
    """if(cond, then[, else]): a NULL condition takes the else branch."""
    cond = _eval(expr.args[0], ctx, cache)
    then = _eval(expr.args[1], ctx, cache)
    els = (_eval(expr.args[2], ctx, cache) if len(expr.args) > 2
           else ex_null(expr.dtype, ctx.device))
    cap = ctx.capacity
    reject_raw((then, els), "if")
    c, ck = _as_bool3(cond, ctx)
    take_then = c if ck is None else (c & ck)
    then, els = _align_strings(then, els)
    td, ed = promote(then.full_data(cap), els.full_data(cap))
    data = torch.where(take_then, td, ed)
    if then.validity is None and els.validity is None:
        validity = None
    else:
        validity = torch.where(take_then, then.full_validity(cap),
                               els.full_validity(cap))
    return EvalValue(data, validity, expr.dtype,
                     then.dictionary or els.dictionary,
                     children=_where_hi(take_then, then, els, expr.dtype,
                                        cap))


@special_form("coalesce")
def _coalesce(expr, ctx, cache):
    """The first non-NULL argument, row by row."""
    vals = [_eval(a, ctx, cache) for a in expr.args]
    reject_raw(vals, "coalesce")
    cap = ctx.capacity
    out = vals[-1]
    for v in reversed(vals[:-1]):
        if v.validity is None:
            out = v
            continue
        vk = v.full_validity(cap)
        v2, out2 = _align_strings(v, out)
        vd, od = promote(v2.full_data(cap), out2.full_data(cap))
        validity = (vk | out2.full_validity(cap)
                    if out2.validity is not None else None)
        out = EvalValue(torch.where(vk, vd, od), validity, expr.dtype,
                        v2.dictionary or out2.dictionary,
                        children=_where_hi(vk, v2, out2, expr.dtype, cap))
    return out


@special_form("try")
def _try(expr, ctx, cache):
    """TRY(expr): rows the child flagged become NULL and the flags are
    swallowed. The child evaluates under a fresh error channel and a
    copied CSE cache, so identical subexpressions outside the TRY keep
    their own flags."""
    saved = ctx.errors
    ctx.errors = None
    v = _eval(expr.args[0], ctx, dict(cache))
    errs = ctx.errors
    ctx.errors = saved
    if errs is None:
        return v
    validity = (~errs if v.validity is None
                else v.full_validity(ctx.capacity) & ~errs)
    return EvalValue(v.full_data(ctx.capacity), validity, v.dtype,
                     v.dictionary, children=v.children)


@special_form("is_null")
def _is_null(expr, ctx, cache):
    v = _eval(expr.args[0], ctx, cache)
    if v.validity is None:
        return EvalValue(torch.zeros((), dtype=torch.bool,
                                     device=ctx.device), None, T.BOOLEAN)
    return EvalValue(~v.full_validity(ctx.capacity), None, T.BOOLEAN)


@special_form("is_not_null")
def _is_not_null(expr, ctx, cache):
    v = _eval(expr.args[0], ctx, cache)
    if v.validity is None:
        return EvalValue(torch.ones((), dtype=torch.bool,
                                    device=ctx.device), None, T.BOOLEAN)
    return EvalValue(v.full_validity(ctx.capacity), None, T.BOOLEAN)


@special_form("in")
def _in(expr, ctx, cache):
    """x IN (c1, c2, ...) with a constant list."""
    from velox_tpu_torch.functions.scalar import compare_value
    x = _eval(expr.args[0], ctx, cache)
    hits = None
    for arg in expr.args[1:]:
        h = compare_value(ctx, x, _eval(arg, ctx, cache), "eq").data
        hits = h if hits is None else (hits | h)
    return EvalValue(hits, x.validity, T.BOOLEAN)


@special_form("between")
def _between(expr, ctx, cache):
    from velox_tpu_torch.functions.scalar import compare_value
    x, lo, hi = (_eval(a, ctx, cache) for a in expr.args)
    ge = compare_value(ctx, x, lo, "gte")
    le = compare_value(ctx, x, hi, "lte")
    return EvalValue(ge.data & le.data, merge_validity(x, lo, hi),
                     T.BOOLEAN)


def _align_strings(a: EvalValue, b: EvalValue):
    """Bind an unresolved string constant on either side to the other
    side's dictionary: its id there, or -1 when the dictionary lacks the
    value (an id no row holds, so it equals nothing)."""
    if a.data is None and b.dictionary is not None:
        a = _bind_string(a, b.dictionary, b.data.device)
    if b.data is None and a.dictionary is not None:
        b = _bind_string(b, a.dictionary, a.data.device)
    return a, b


def _bind_string(const: EvalValue, dictionary: Dictionary,
                 device) -> EvalValue:
    return EvalValue(torch.tensor(dictionary.id_of(const.py_value),
                                  dtype=torch.int32, device=device),
                     None, const.dtype, dictionary, py_value=const.py_value)

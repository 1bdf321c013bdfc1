"""ARRAY, MAP and ROW functions over the counts + element children layout.

Counterpart of ``velox_tpu/functions/complex.py`` (velox/functions/
prestosql ArrayFunctions, MapFunctions, the lambda functions of
expression/LambdaExpr.cpp, ZipWith.cpp, Reduce.cpp, MapZipWith). It
registers the reference's 32 names:

* ``cardinality``, ``element_at`` (ARRAY), ``contains``;
* the lambda functions ``transform``, ``filter``, ``any_match``,
  ``all_match``, ``none_match``, ``reduce``, ``zip_with``,
  ``map_filter``, ``transform_values``, ``transform_keys`` and
  ``map_zip_with``;
* ``array_sort``, ``array_distinct``, ``array_max``, ``array_min``;
* ``map_keys``, ``map_values``, ``map_entries``, ``map_concat``,
  ``get_field`` (ROW);
* ``array_position``, ``array_remove``, ``slice``, ``concat`` over
  arrays, ``flatten``, ``arrays_overlap``, ``array_intersect``,
  ``array_union`` and ``array_except``.

Lambdas evaluate in *element space*: the flattened children are one dense
column, the lambda parameter binds the child column itself, and a
captured row column is lifted to its elements by one row gather
(``_LiftedColumns``). ``reduce`` is the one sequential function: a loop
over element positions up to the longest row (one host read of that
length), each step applying the lambda to every row's i-th element.

Every 4- and 8-byte gather of elements or rows runs kernel B5
(ops/gather.py ``take_rows``), and every per-row sort (array_sort,
array_distinct, the set operations, arrays_overlap, map_concat,
map_zip_with) is one radix sort of (row, value) words (exec/sort.py
``radix_sort_perm``: B4 with B3, or B4, B2 and B5). Compactions of kept
elements are scatters, as in the reference, so nothing reads the device
on the host but reduce's length.

Presto's NULL rules, where the reference departs from them (ROADMAP C):
``contains`` is NULL when the needle is NULL, or when it is not found and
the array holds a NULL; ``any_match``, ``all_match`` and ``none_match``
are NULL when the predicate is NULL for some elements and does not
decide the result on the others.

Kept limits of the reference (NotImplementedError): an element-space
function over an array whose rows were gathered (it has explicit starts,
vector/device.py), ``element_at`` over a MAP, ``reduce`` over strings.
"""

from __future__ import annotations

from typing import Tuple

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.expression.eval import (
    EvalCtx, EvalValue, _eval, merge_validity, special_form,
)
from velox_tpu_torch.functions.registry import register
from velox_tpu_torch.functions.scalar import eq_value
from velox_tpu_torch.functions.signature import sig
from velox_tpu_torch.ops.gather import take_rows
from velox_tpu_torch.ops.wide import compact_kept
from velox_tpu_torch.vector.device import (
    DeviceColumn, Dictionary, element_offsets,
)

# ---------------------------------------------------------------------------
# Element-space helpers
# ---------------------------------------------------------------------------


def _offsets(v) -> torch.Tensor:
    return element_offsets(v.data, v.starts)


def _require_dense(v, fname: str) -> None:
    """An element-space function needs each row to own its element slice
    in row order (the dense layout). A column whose rows were gathered
    shares its children and raises, as in the reference."""
    if v.starts is not None:
        raise NotImplementedError(
            f"{fname} over an ARRAY/MAP whose rows were gathered (by a "
            "join, an OrderBy or TopN, or a concatenation of batches) is "
            "not supported; apply it before that operator")


def _seg(in_row: torch.Tensor, row_c: torch.Tensor, cap: int):
    """Segment ids: the element's row, or the junk segment ``cap``."""
    return torch.where(in_row, row_c, cap)


# junk elements land on this many slots past the rows: all on one slot,
# their atomic adds would serialize (an element space can be mostly junk,
# e.g. a collect result's, whose capacity is the retained rows')
_JUNK_SLOTS = 1024


def _spread(seg: torch.Tensor, cap: int) -> torch.Tensor:
    lane = torch.arange(seg.shape[0], device=seg.device) & (_JUNK_SLOTS - 1)
    return torch.where(seg == cap, cap + lane, seg)


def _seg_sum(vals: torch.Tensor, seg: torch.Tensor, cap: int):
    out = torch.zeros((cap + _JUNK_SLOTS,), dtype=torch.int64,
                      device=seg.device)
    out.index_add_(0, _spread(seg, cap), vals.to(torch.int64))
    return out[:cap]


def _seg_any(flags: torch.Tensor, seg: torch.Tensor, cap: int):
    return _seg_sum(flags, seg, cap) > 0


def _seg_extreme(vals: torch.Tensor, seg: torch.Tensor, cap: int,
                 op: str) -> torch.Tensor:
    out = torch.zeros((cap + _JUNK_SLOTS,), dtype=vals.dtype,
                      device=seg.device)
    return out.scatter_reduce(0, _spread(seg, cap), vals, reduce=op,
                              include_self=False)[:cap]


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bool, device=device)


def _element_row_map(arr: EvalValue, cap: int, fname: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row of each element, whether it lies in a valid row's slice) over
    the child capacity; the row is clamped into [0, cap)."""
    _require_dense(arr, fname)
    child = arr.children[0]
    dev = child.data.device
    lens = arr.data.to(torch.int64)
    starts = _offsets(arr)
    e = torch.arange(child.capacity, dtype=torch.int64, device=dev)
    row = torch.searchsorted(starts, e, right=True) - 1
    row_c = torch.clamp(row, 0, cap - 1)
    first = take_rows(starts, row_c)
    in_row = (e >= first) & (e < first + take_rows(lens, row_c))
    if arr.validity is not None:
        in_row = in_row & arr.validity[row_c]
    return row_c, in_row


def _lift(v: EvalValue, row: torch.Tensor, cap: int) -> EvalValue:
    """A row-space value at rows ``row`` (element space): row-aligned
    children (a long decimal's high limb, a raw string's lengths, ROW
    fields) with it; an ARRAY/MAP keeps its children and gets the lifted
    element starts."""
    if v.data is None or v.is_scalar:
        return v
    validity = v.validity
    if validity is not None and validity.dim() > 0:
        validity = validity[row]
    data = take_rows(v.full_data(cap), row)
    children, starts = v.children, None
    if v.dtype.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP):
        starts = take_rows(_offsets(v), row)
    elif children:
        children = tuple(DeviceColumn(take_rows(c.data, row), None, c.dtype,
                                      c.dictionary) for c in children)
    return EvalValue(data, validity, v.dtype, v.dictionary,
                     children=children, starts=starts)


class _LiftedColumns(dict):
    """Element-space view of row-space columns: a column is lifted on its
    first access."""

    def __init__(self, base: dict, row_map: torch.Tensor, cap: int):
        super().__init__()
        self._base = base
        self._row = row_map
        self._cap = cap

    def __missing__(self, name):
        out = _lift(self._base[name], self._row, self._cap)
        self[name] = out
        return out


def _flag_rows(ctx, errors, in_row, row_c) -> None:
    """Raise the row flag of every row with a flagged element."""
    if errors is not None:
        ctx.flag_error(_seg_any(errors & in_row,
                                _seg(in_row, row_c, ctx.capacity),
                                ctx.capacity))


def _lambda_eval_bound(lam: ex.Lambda, coll: EvalValue, binds, ctx,
                       fname: str):
    """The lambda body over the element space of ``coll``, with each
    parameter bound to an element-space value. Returns (value, row of
    each element, in_row)."""
    ecap = coll.children[0].capacity
    row_c, in_row = _element_row_map(coll, ctx.capacity, fname)
    cols = _LiftedColumns(ctx.columns, row_c, ctx.capacity)
    for name, val in binds:
        cols[name] = val
    ectx = EvalCtx(cols, ecap, ctx.device)
    out = _eval(lam.body, ectx, {})
    _flag_rows(ctx, ectx.errors, in_row, row_c)
    return out, row_c, in_row


def _child_value(col: DeviceColumn, dtype: T.DataType) -> EvalValue:
    return EvalValue(col.data, col.validity, dtype, col.dictionary,
                     children=col.children, starts=col.starts)


def _lambda_eval(lam: ex.Lambda, arr: EvalValue, ctx, fname: str):
    """The 1-parameter form over an ARRAY: the parameter is the child."""
    bind = _child_value(arr.children[0], arr.dtype.children[0])
    return _lambda_eval_bound(lam, arr, [(lam.params[0], bind)], ctx, fname)


def _lambda_eval_map(lam: ex.Lambda, m: EvalValue, ctx, fname: str):
    """The 2-parameter form over a MAP: (key, value) children."""
    binds = [(p, _child_value(c, t)) for p, c, t in
             zip(lam.params, m.children, m.dtype.children)]
    return _lambda_eval_bound(lam, m, binds, ctx, fname)


def _truth(v: EvalValue, n: int) -> torch.Tensor:
    """TRUE (not NULL) flags of a boolean value."""
    t = v.full_data(n).to(torch.bool)
    if v.validity is not None:
        t = t & v.full_validity(n)
    return t


def _compacted_children(children, elem_types, keep, row_all, cap: int):
    """(children compacted by ``keep``, each row's new count)."""
    n = children[0].capacity
    parts = compact_kept([(c.data, c.validity) for c in children], keep)
    kids = tuple(DeviceColumn(d, v, t, c.dictionary)
                 for (d, v), t, c in zip(parts, elem_types, children))
    return kids, _seg_sum(keep, row_all, cap).to(torch.int32)


def _array(lens, validity, child: DeviceColumn, dtype) -> EvalValue:
    return EvalValue(lens, validity, dtype, children=(child,))


# ---------------------------------------------------------------------------
# cardinality, element_at, contains
# ---------------------------------------------------------------------------

def _cardinality_eval(ctx, out_dtype, args):
    (v,) = args
    return EvalValue(v.data.to(torch.int64), v.validity, T.BIGINT)


register("cardinality", sig("complex -> bigint"), _cardinality_eval)


def _element_at_eval(ctx, out_dtype, args):
    arr, idx = args
    cap = ctx.capacity
    child = arr.children[0]
    lens = arr.data.to(torch.int64)
    i = idx.full_data(cap).to(torch.int64)
    # 1-based; a negative index counts from the end (Presto)
    pos = torch.where(i > 0, i - 1, lens + i)
    in_bounds = (pos >= 0) & (pos < lens)
    src = torch.clamp(_offsets(arr) + pos, 0, child.capacity - 1)
    validity = in_bounds
    if arr.validity is not None:
        validity = validity & arr.validity
    if idx.validity is not None:
        validity = validity & idx.full_validity(cap)
    if child.validity is not None:
        validity = validity & child.validity[src]
    return EvalValue(take_rows(child.data, src), validity,
                     arr.dtype.children[0], child.dictionary)


def _element_at_resolver(ts):
    if len(ts) == 2 and ts[0].kind is T.TypeKind.ARRAY \
            and ts[1].is_integral:
        return ts[0].children[0]
    return None


register("element_at", _element_at_resolver, _element_at_eval)


def _elem_hit(ctx, arr: EvalValue, x: EvalValue, row_c, in_row):
    """(TRUE where an element of a valid row equals the needle, the
    needle lifted to element space): per-row needles gather by row."""
    child = arr.children[0]
    ecap = child.capacity
    elems = EvalValue(child.data, child.validity, arr.dtype.children[0],
                      child.dictionary)
    x_e = _lift(x, row_c, ctx.capacity)
    eq = eq_value(EvalCtx({}, ecap, ctx.device), elems, x_e)
    return _truth(eq, ecap) & in_row, x_e


def _contains_eval(ctx, out_dtype, args):
    """Presto's contains: TRUE when found; else NULL when the needle is
    NULL or the array holds a NULL; else FALSE."""
    arr, x = args
    cap = ctx.capacity
    child = arr.children[0]
    row_c, in_row = _element_row_map(arr, cap, "contains")
    hit, _ = _elem_hit(ctx, arr, x, row_c, in_row)
    seg = _seg(in_row, row_c, cap)
    found = _seg_any(hit, seg, cap)
    validity = merge_validity(arr, x)
    if validity is not None:
        validity = validity.expand(cap) if validity.dim() == 0 else validity
    if child.validity is not None:
        has_null = _seg_any(in_row & ~child.validity, seg, cap)
        known = found | ~has_null
        validity = known if validity is None else validity & known
    return EvalValue(found, validity, T.BOOLEAN)


def _contains_resolver(ts):
    if len(ts) == 2 and ts[0].kind is T.TypeKind.ARRAY:
        return T.BOOLEAN
    return None


register("contains", _contains_resolver, _contains_eval)


# ---------------------------------------------------------------------------
# Lambda functions over arrays
# ---------------------------------------------------------------------------

def _no_eval(*a, **k):
    raise AssertionError("a special form evaluates this name")


@special_form("transform")
def _transform(expr, ctx, cache):
    arr = _eval(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, _, _ = _lambda_eval(lam, arr, ctx, "transform")
    ecap = arr.children[0].capacity
    child = EvalValue(out.full_data(ecap), out.validity, lam.dtype,
                      out.dictionary, children=out.children,
                      starts=out.starts).to_column(ecap)
    return _array(arr.data, arr.validity, child, expr.dtype)


@special_form("filter")
def _filter(expr, ctx, cache):
    arr = _eval(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval(lam, arr, ctx, "filter")
    ecap = arr.children[0].capacity
    keep = _truth(out, ecap) & in_row
    kids, lens = _compacted_children(
        arr.children, arr.dtype.children, keep,
        _seg(in_row, row_c, ctx.capacity), ctx.capacity)
    return EvalValue(lens, arr.validity, arr.dtype, children=kids)


def _match(expr, ctx, cache, mode: str) -> EvalValue:
    """Presto's three-valued any/all/none_match: a deciding element (TRUE
    for any and none, FALSE for all) decides; otherwise a NULL predicate
    makes the result NULL; an empty array gives FALSE (any) or TRUE."""
    arr = _eval(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval(lam, arr, ctx, mode + "_match")
    cap, ecap = ctx.capacity, arr.children[0].capacity
    val = out.full_data(ecap).to(torch.bool)
    known = out.full_validity(ecap)
    seg = _seg(in_row, row_c, cap)
    any_true = _seg_any(in_row & known & val, seg, cap)
    any_false = _seg_any(in_row & known & ~val, seg, cap)
    any_null = _seg_any(in_row & ~known, seg, cap)
    if mode == "any":
        res, decided = any_true, any_true
    elif mode == "all":
        res, decided = ~any_false, any_false
    else:
        res, decided = ~any_true, any_true
    validity = decided | ~any_null
    if arr.validity is not None:
        validity = validity & arr.validity
    return EvalValue(res, validity, T.BOOLEAN)


for _mode in ("any", "all", "none"):
    special_form(f"{_mode}_match")(
        lambda expr, ctx, cache, _m=_mode: _match(expr, ctx, cache, _m))
    register(f"{_mode}_match", sig("array(T), any -> boolean"), _no_eval)

register("transform", sig("array(T), U -> array(U)"), _no_eval)
register("filter", sig("array(T), any -> array(T)"), _no_eval)


# ---------------------------------------------------------------------------
# Order and dedup: array_sort, array_distinct, array_max, array_min
# ---------------------------------------------------------------------------

def _row_bits(cap: int) -> int:
    return max(1, int(cap + 1).bit_length())


def _per_row_sorted_perm(arr: EvalValue, ctx, fname: str):
    """The element permutation sorting each row's elements by value
    (stable, nulls last): one radix sort of (row, null, value) words,
    rows outside every valid row last."""
    from velox_tpu_torch.exec.sort import radix_sort_perm, value_words
    child = arr.children[0]
    ecap = child.capacity
    row_c, in_row = _element_row_map(arr, ctx.capacity, fname)
    words = [_seg(in_row, row_c, ctx.capacity)]
    bits = [_row_bits(ctx.capacity)]
    if child.validity is not None:
        words.append((~child.validity).to(torch.int64))
        bits.append(1)
    vw = value_words(EvalValue(child.data, child.validity,
                               arr.dtype.children[0], child.dictionary), ecap)
    words.extend(vw)
    bits.extend([32] * len(vw))
    return radix_sort_perm(words, bits, ecap), row_c, in_row


def _take_child(child: DeviceColumn, perm) -> DeviceColumn:
    validity = None if child.validity is None else child.validity[perm]
    return DeviceColumn(take_rows(child.data, perm), validity, child.dtype,
                        child.dictionary)


@special_form("array_sort")
def _array_sort(expr, ctx, cache):
    arr = _eval(expr.args[0], ctx, cache)
    perm, _, _ = _per_row_sorted_perm(arr, ctx, "array_sort")
    return _array(arr.data, arr.validity, _take_child(arr.children[0], perm),
                  arr.dtype)


@special_form("array_distinct")
def _array_distinct(expr, ctx, cache):
    """Distinct elements of each row in first-occurrence order (Presto):
    duplicates are found in (row, value) order, where the stable sort
    makes the first occurrence the head of its run, and the keep flags go
    back to element order for the compaction."""
    arr = _eval(expr.args[0], ctx, cache)
    child = arr.children[0]
    ecap = child.capacity
    dev = child.data.device
    perm, row_c, in_row = _per_row_sorted_perm(arr, ctx, "array_distinct")
    row_all = _seg(in_row, row_c, ctx.capacity)
    data_s = take_rows(child.data, perm)
    row_s = take_rows(row_all, perm)
    valid_s = (child.validity[perm] if child.validity is not None
               else _ones(ecap, dev))
    first = torch.ones((ecap,), dtype=torch.bool, device=dev)
    first[1:] = ((row_s[1:] != row_s[:-1]) | (data_s[1:] != data_s[:-1])
                 | (valid_s[1:] != valid_s[:-1]))
    keep = torch.zeros((ecap,), dtype=torch.bool, device=dev)
    keep[perm] = first & (row_s < ctx.capacity)
    kids, lens = _compacted_children(arr.children, arr.dtype.children,
                                     keep, row_all, ctx.capacity)
    return EvalValue(lens, arr.validity, arr.dtype, children=kids)


register("array_sort", sig("array(T) -> array(T)"), _no_eval)
register("array_distinct", sig("array(T) -> array(T)"), _no_eval)


def _array_extreme(ctx, arr: EvalValue, op: str) -> EvalValue:
    """array_max/array_min: NULL for an empty array or one holding a
    NULL (Presto)."""
    cap = ctx.capacity
    child = arr.children[0]
    row_c, in_row = _element_row_map(arr, cap, "array_" + op[1:])
    seg = _seg(in_row, row_c, cap)
    has_null = torch.zeros((cap,), dtype=torch.bool, device=ctx.device)
    if child.validity is not None:
        has_null = _seg_any(in_row & ~child.validity, seg, cap)
        seg = _seg(in_row & child.validity, row_c, cap)
    red = _seg_extreme(child.data, seg, cap, op)
    n = _seg_sum(torch.ones_like(seg), seg, cap)
    validity = (n > 0) & ~has_null
    if arr.validity is not None:
        validity = validity & arr.validity
    return EvalValue(red, validity, arr.dtype.children[0], child.dictionary)


register("array_max", sig("array(T) -> T"),
         lambda ctx, o, args: _array_extreme(ctx, args[0], "amax"))
register("array_min", sig("array(T) -> T"),
         lambda ctx, o, args: _array_extreme(ctx, args[0], "amin"))


def _map_child_eval(which: int):
    def eval_fn(ctx, out_dtype, args):
        (m,) = args
        return EvalValue(m.data, m.validity, out_dtype,
                         children=(m.children[which],), starts=m.starts)
    return eval_fn


register("map_keys", sig("map(K, V) -> array(K)"), _map_child_eval(0))
register("map_values", sig("map(K, V) -> array(V)"), _map_child_eval(1))


def _get_field_eval(ctx, out_dtype, args):
    row, fname = args
    i = list(row.dtype.names).index(fname.py_value)
    child = row.children[i]
    validity = merge_validity(row, _child_value(child, child.dtype))
    return EvalValue(child.data, validity, row.dtype.children[i],
                     child.dictionary, children=child.children,
                     starts=child.starts)


def _get_field_resolver(ts):
    if len(ts) == 2 and ts[0].kind is T.TypeKind.ROW:
        return T.UNKNOWN  # the parser sets the field's type
    return None


register("get_field", _get_field_resolver, _get_field_eval)


# ---------------------------------------------------------------------------
# Lambda functions over maps, zip_with, reduce
# ---------------------------------------------------------------------------

@special_form("map_filter")
def _map_filter(expr, ctx, cache):
    m = _eval(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval_map(lam, m, ctx, "map_filter")
    keep = _truth(out, m.children[0].capacity) & in_row
    kids, lens = _compacted_children(
        m.children, m.dtype.children, keep,
        _seg(in_row, row_c, ctx.capacity), ctx.capacity)
    return EvalValue(lens, m.validity, m.dtype, children=kids)


@special_form("transform_values")
def _transform_values(expr, ctx, cache):
    m = _eval(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, _, _ = _lambda_eval_map(lam, m, ctx, "transform_values")
    ecap = m.children[0].capacity
    nv = DeviceColumn(out.full_data(ecap), out.validity, lam.dtype,
                      out.dictionary)
    return EvalValue(m.data, m.validity, expr.dtype,
                     children=(m.children[0], nv))


@special_form("transform_keys")
def _transform_keys(expr, ctx, cache):
    m = _eval(expr.args[0], ctx, cache)
    lam = expr.args[1]
    out, row_c, in_row = _lambda_eval_map(lam, m, ctx, "transform_keys")
    ecap = m.children[0].capacity
    if out.validity is not None:
        # Presto: a transformed key must not be NULL (TransformKeys.cpp)
        _flag_rows(ctx, ~out.full_validity(ecap), in_row, row_c)
    nk = DeviceColumn(out.full_data(ecap), None, lam.dtype, out.dictionary)
    return EvalValue(m.data, m.validity, expr.dtype,
                     children=(nk, m.children[1]))


@special_form("zip_with")
def _zip_with(expr, ctx, cache):
    """zip_with(a, b, (x, y) -> z): a positional zip per row, the shorter
    row padded with NULLs (Presto), into a fresh dense layout whose
    element capacity is the sum of the two."""
    a1 = _eval(expr.args[0], ctx, cache)
    a2 = _eval(expr.args[1], ctx, cache)
    lam = expr.args[2]
    _require_dense(a1, "zip_with")
    _require_dense(a2, "zip_with")
    c1, c2 = a1.children[0], a2.children[0]
    cap = ctx.capacity
    dev = ctx.device
    l1, l2 = a1.data.to(torch.int64), a2.data.to(torch.int64)
    out_lens = torch.maximum(l1, l2)
    ocap = c1.capacity + c2.capacity
    ostarts = torch.cumsum(out_lens, 0) - out_lens
    e = torch.arange(ocap, dtype=torch.int64, device=dev)
    row_c = torch.clamp(torch.searchsorted(ostarts, e, right=True) - 1,
                        0, cap - 1)
    p = e - take_rows(ostarts, row_c)
    in_row = (p >= 0) & (p < take_rows(out_lens, row_c))
    row_valid = merge_validity(a1, a2)
    if row_valid is not None:
        in_row = in_row & row_valid[row_c]

    def side(a, child, ln):
        idx = torch.clamp(take_rows(_offsets(a), row_c) + p, 0,
                          child.capacity - 1)
        have = in_row & (p < take_rows(ln, row_c))
        valid = have if child.validity is None \
            else have & child.validity[idx]
        return EvalValue(take_rows(child.data, idx), valid,
                         a.dtype.children[0], child.dictionary)

    cols = _LiftedColumns(ctx.columns, row_c, cap)
    cols[lam.params[0]] = side(a1, c1, l1)
    cols[lam.params[1]] = side(a2, c2, l2)
    ectx = EvalCtx(cols, ocap, dev)
    out = _eval(lam.body, ectx, {})
    _flag_rows(ctx, ectx.errors, in_row, row_c)
    nc = DeviceColumn(out.full_data(ocap).contiguous(),
                      None if out.validity is None
                      else out.full_validity(ocap), lam.dtype,
                      out.dictionary)
    return EvalValue(out_lens.to(torch.int32), row_valid, expr.dtype,
                     children=(nc,))


@special_form("reduce")
def _reduce(expr, ctx, cache):
    """reduce(array, init, (s, x) -> s', s -> out): a sequential fold per
    row, vectorised across rows: step i applies the combining lambda to
    every row's i-th element (rows past their end carry their state).
    The number of steps is the longest row's length, read once."""
    arr = _eval(expr.args[0], ctx, cache)
    init = _eval(expr.args[1], ctx, cache)
    comb, outf = expr.args[2], expr.args[3]
    child = arr.children[0]
    cap = ctx.capacity
    dev = ctx.device
    if child.dictionary is not None or init.dictionary is not None \
            or init.data is None:
        raise NotImplementedError("reduce over string state")
    lens = arr.data.to(torch.int64)
    starts = _offsets(arr)
    state_t = comb.dtype
    s = init.full_data(cap).to(state_t.torch_dtype())
    sv = init.full_validity(cap)
    err = torch.zeros((cap,), dtype=torch.bool, device=dev)
    elem_t = arr.dtype.children[0]
    steps = int(lens.max().item()) if cap else 0
    for i in range(steps):
        idx = torch.clamp(starts + i, 0, child.capacity - 1)
        active = i < lens
        xv = active if child.validity is None \
            else active & child.validity[idx]
        cols = dict(ctx.columns)
        cols[comb.params[0]] = EvalValue(s, sv, state_t)
        cols[comb.params[1]] = EvalValue(take_rows(child.data, idx), xv,
                                         elem_t)
        ectx = EvalCtx(cols, cap, dev)
        out = _eval(comb.body, ectx, {})
        s = torch.where(active, out.full_data(cap).to(s.dtype), s)
        sv = torch.where(active, out.full_validity(cap), sv)
        if ectx.errors is not None:
            err = err | (ectx.errors & active)
    ctx.flag_error(err)
    cols = dict(ctx.columns)
    cols[outf.params[0]] = EvalValue(s, sv, state_t)
    ectx = EvalCtx(cols, cap, dev)
    res = _eval(outf.body, ectx, {})
    if ectx.errors is not None:
        ctx.flag_error(ectx.errors)
    validity = res.validity
    if arr.validity is not None:
        validity = res.full_validity(cap) & arr.validity
    return EvalValue(res.full_data(cap), validity, expr.dtype,
                     res.dictionary)


register("map_filter", sig("map(K, V), any -> map(K, V)"), _no_eval)
register("transform_values", sig("map(K, V), U -> map(K, U)"), _no_eval)
register("transform_keys", sig("map(K, V), U -> map(U, V)"), _no_eval)
register("zip_with", sig("array(T), array(U), V -> array(V)"), _no_eval)
register("reduce", sig("array(T), A, B, C -> C"), _no_eval)


# ---------------------------------------------------------------------------
# array_position, array_remove, slice, concat, flatten, map_entries,
# arrays_overlap, the set operations, map_concat, map_zip_with
# ---------------------------------------------------------------------------

def _unify_dicts(ca: DeviceColumn, cb: DeviceColumn):
    """(dictionary, ids of a, ids of b): two dictionary-id columns moved
    onto one merged sorted dictionary, so ids compare across them (a host
    pass over the distinct values, then a device gather by id)."""
    if ca.dictionary is None or cb.dictionary is None \
            or ca.dictionary is cb.dictionary:
        return ca.dictionary or cb.dictionary, ca.data, cb.data
    va, vb = ca.dictionary.values.tolist(), cb.dictionary.values.tolist()
    merged = sorted(set(va) | set(vb))
    pos = {v: i for i, v in enumerate(merged)}
    d = Dictionary(merged)
    d.is_sorted = True

    def remap(vals, data):
        table = torch.tensor([pos[v] for v in vals] or [0],
                             dtype=torch.int32, device=data.device)
        return take_rows(table, data.to(torch.int64))
    return d, remap(va, ca.data), remap(vb, cb.data)


def _array_position_eval(ctx, out_dtype, args):
    arr, x = args
    cap = ctx.capacity
    ecap = arr.children[0].capacity
    row_c, in_row = _element_row_map(arr, cap, "array_position")
    hit, _ = _elem_hit(ctx, arr, x, row_c, in_row)
    e = torch.arange(ecap, dtype=torch.int64, device=ctx.device)
    within = e - take_rows(_offsets(arr), row_c) + 1  # 1-based
    first = _seg_extreme(torch.where(hit, within, ecap + 1),
                         _seg(hit, row_c, cap), cap, "amin")
    data = torch.where((first > ecap) | (first == 0), 0, first)
    return EvalValue(data, merge_validity(arr, x), T.BIGINT)


register("array_position", sig("array(T), T -> bigint"),
         _array_position_eval)


def _array_remove_eval(ctx, out_dtype, args):
    arr, x = args
    row_c, in_row = _element_row_map(arr, ctx.capacity, "array_remove")
    hit, _ = _elem_hit(ctx, arr, x, row_c, in_row)
    kids, lens = _compacted_children(
        arr.children, arr.dtype.children, in_row & ~hit,
        _seg(in_row, row_c, ctx.capacity), ctx.capacity)
    return EvalValue(lens, merge_validity(arr, x), arr.dtype, children=kids)


register("array_remove", sig("array(T), T -> array(T)"), _array_remove_eval)


def _slice_eval(ctx, out_dtype, args):
    arr, start, length = args
    cap = ctx.capacity
    ecap = arr.children[0].capacity
    row_c, in_row = _element_row_map(arr, cap, "slice")
    lens = take_rows(arr.data.to(torch.int64), row_c)
    s = take_rows(start.full_data(cap).to(torch.int64), row_c)
    ln = take_rows(length.full_data(cap).to(torch.int64), row_c)
    e = torch.arange(ecap, dtype=torch.int64, device=ctx.device)
    pos = e - take_rows(_offsets(arr), row_c)  # 0-based within the row
    begin = torch.where(s > 0, s - 1, lens + s)
    keep = in_row & (pos >= begin) & (pos < begin + ln) & (s != 0)
    kids, new_lens = _compacted_children(
        arr.children, arr.dtype.children, keep, _seg(in_row, row_c, cap),
        cap)
    return EvalValue(new_lens, merge_validity(arr, start, length),
                     arr.dtype, children=kids)


register("slice", sig("array(T), integral, integral -> array(T)"),
         _slice_eval)


def _validity_or_ones(col: DeviceColumn) -> torch.Tensor:
    return (col.validity if col.validity is not None
            else _ones(col.capacity, col.data.device))


def _array_concat_eval(ctx, out_dtype, args):
    a, b = args
    cap = ctx.capacity
    ca, cb = a.children[0], b.children[0]
    d, da, db = _unify_dicts(ca, cb)
    la, lb = a.data.to(torch.int64), b.data.to(torch.int64)
    lo = la + lb
    starts_out = torch.cumsum(lo, 0) - lo
    out_cap = ca.capacity + cb.capacity
    row_a, in_a = _element_row_map(a, cap, "concat")
    row_b, in_b = _element_row_map(b, cap, "concat")
    pos_a = (torch.arange(ca.capacity, device=ctx.device)
             - take_rows(_offsets(a), row_a))
    pos_b = (torch.arange(cb.capacity, device=ctx.device)
             - take_rows(_offsets(b), row_b))
    tgt_a = torch.where(in_a, take_rows(starts_out, row_a) + pos_a, out_cap)
    tgt_b = torch.where(in_b, take_rows(starts_out + la, row_b) + pos_b,
                        out_cap)
    dt = torch.promote_types(da.dtype, db.dtype)
    data = torch.zeros((out_cap + 1,), dtype=dt, device=ctx.device)
    data[tgt_a] = da.to(dt)
    data[tgt_b] = db.to(dt)
    validity = None
    if ca.validity is not None or cb.validity is not None:
        validity = _ones(out_cap + 1, ctx.device)
        validity[tgt_a] = _validity_or_ones(ca)
        validity[tgt_b] = _validity_or_ones(cb)
        validity = validity[:out_cap]
    child = DeviceColumn(data[:out_cap], validity, a.dtype.children[0], d)
    return EvalValue(lo.to(torch.int32), merge_validity(a, b), a.dtype,
                     children=(child,))


register("concat", sig("array(T), array(T) -> array(T)"), _array_concat_eval)


def _flatten_eval(ctx, out_dtype, args):
    (arr,) = args  # array(array(T))
    cap = ctx.capacity
    inner = arr.children[0]  # an ARRAY column over the outer elements
    row_c, in_row = _element_row_map(arr, cap, "flatten")
    inner_val = _child_value(inner, arr.dtype.children[0])
    oe_of_ie, in_inner = _element_row_map(inner_val, inner.capacity,
                                          "flatten")
    keep = in_inner & in_row[oe_of_ie]
    leaf = inner.children[0]
    kids, lens = _compacted_children(
        (leaf,), (out_dtype.children[0],), keep,
        _seg(keep, take_rows(row_c, oe_of_ie), cap), cap)
    return EvalValue(lens, arr.validity, out_dtype, children=kids)


register("flatten", sig("array(array(T)) -> array(T)"), _flatten_eval)


def _map_entries_eval(ctx, out_dtype, args):
    (m,) = args
    kchild, vchild = m.children
    entries = DeviceColumn(
        torch.zeros((kchild.capacity,), dtype=torch.int32,
                    device=kchild.data.device),
        None, out_dtype.children[0], None, (kchild, vchild))
    return EvalValue(m.data, m.validity, out_dtype, children=(entries,),
                     starts=m.starts)


register("map_entries", sig("map(K, V) -> array(row(K, V))"),
         _map_entries_eval)


def _merged_elements(a: EvalValue, b: EvalValue, ca: DeviceColumn,
                     cb: DeviceColumn, ctx, fname: str, valid_only=False):
    """Both arrays' elements in one element space: (row or the junk row
    per element, from b, valid, the values (one dictionary), the
    element type)."""
    cap = ctx.capacity
    d, da, db = _unify_dicts(ca, cb)
    row_a, in_a = _element_row_map(a, cap, fname)
    row_b, in_b = _element_row_map(b, cap, fname)
    va, vb = _validity_or_ones(ca), _validity_or_ones(cb)
    if valid_only:
        in_a, in_b = in_a & va, in_b & vb
    rows = torch.cat([_seg(in_a, row_a, cap), _seg(in_b, row_b, cap)])
    src_b = torch.cat([torch.zeros((ca.capacity,), dtype=torch.bool,
                                   device=ctx.device),
                       _ones(cb.capacity, ctx.device)])
    et = a.dtype.children[0]
    want = et.torch_dtype()
    vals = EvalValue(torch.cat([da.to(want), db.to(want)]), None, et, d)
    return rows, src_b, torch.cat([va, vb]), vals


def _sorted_by_row_value(rows, vals: EvalValue, n: int, cap: int,
                         null=None):
    """The permutation sorting elements by (row, [null,] value)."""
    from velox_tpu_torch.exec.sort import radix_sort_perm, value_words
    words, bits = [rows], [_row_bits(cap)]
    if null is not None:
        words.append(null.to(torch.int64))
        bits.append(1)
    vw = value_words(vals, n)
    return radix_sort_perm(words + vw, bits + [32] * len(vw), n)


def _runs(perm, rows, vals, valid=None):
    """(rows, values[, valid]) in sorted order and the run heads of equal
    (row, value[, valid])."""
    rows_s = take_rows(rows, perm)
    data_s = take_rows(vals, perm)
    same = (rows_s[1:] == rows_s[:-1]) & (data_s[1:] == data_s[:-1])
    valid_s = None
    if valid is not None:
        valid_s = valid[perm]
        same = same & (valid_s[1:] == valid_s[:-1])
    head = torch.ones_like(rows_s, dtype=torch.bool)
    head[1:] = ~same
    return rows_s, data_s, valid_s, head


def _run_flags(head, src_s):
    """Per sorted element: whether its run holds an element of a and one
    of b."""
    n = head.shape[0]
    run_id = torch.cumsum(head.to(torch.int64), 0) - 1
    has_b = _seg_any(src_s, run_id, n)
    has_a = _seg_any(~src_s, run_id, n)
    return take_rows(has_a.to(torch.int32), run_id) > 0, \
        take_rows(has_b.to(torch.int32), run_id) > 0


def _arrays_overlap_eval(ctx, out_dtype, args):
    """TRUE when a non-NULL element is common; else NULL when either side
    holds a NULL element (Presto); else FALSE."""
    a, b = args
    cap = ctx.capacity
    ca, cb = a.children[0], b.children[0]
    n = ca.capacity + cb.capacity
    rows, src_b, _, vals = _merged_elements(a, b, ca, cb, ctx,
                                            "arrays_overlap",
                                            valid_only=True)
    perm = _sorted_by_row_value(rows, vals, n, cap)
    rows_s, _, _, head = _runs(perm, rows, vals.data)
    has_a, has_b = _run_flags(head, src_b[perm])
    live = rows_s < cap
    overlap = _seg_any(has_a & has_b & live, torch.where(live, rows_s, cap),
                       cap)
    has_null = torch.zeros((cap,), dtype=torch.bool, device=ctx.device)
    for arr, col in ((a, ca), (b, cb)):
        if col.validity is not None:
            row_c, in_row = _element_row_map(arr, cap, "arrays_overlap")
            has_null = has_null | _seg_any(in_row & ~col.validity,
                                           _seg(in_row, row_c, cap), cap)
    validity = overlap | ~has_null
    mv = merge_validity(a, b)
    if mv is not None:
        validity = validity & mv
    return EvalValue(overlap, validity, T.BOOLEAN)


register("arrays_overlap", sig("array(T), array(T) -> boolean"),
         _arrays_overlap_eval)


def _array_setop(ctx, a: EvalValue, b: EvalValue, mode: str, out_dtype):
    """array_intersect/union/except over the merged elements sorted by
    (row, null, value): one stable sort, per-run presence in a and b, and
    the run heads that satisfy the mode, compacted. Output elements are
    value-sorted within each row (Presto leaves the order unspecified);
    NULLs compare equal to each other (Presto's set semantics)."""
    cap = ctx.capacity
    ca, cb = a.children[0], b.children[0]
    n = ca.capacity + cb.capacity
    rows, src_b, valid, vals = _merged_elements(a, b, ca, cb, ctx,
                                                "array_" + mode)
    data = torch.where(valid, vals.data, torch.zeros_like(vals.data))
    vals = EvalValue(data, None, vals.dtype, vals.dictionary)
    perm = _sorted_by_row_value(rows, vals, n, cap, null=~valid)
    rows_s, data_s, valid_s, head = _runs(perm, rows, data, valid)
    has_a, has_b = _run_flags(head, src_b[perm])
    want = {"intersect": has_a & has_b, "union": has_a | has_b,
            "except": has_a & ~has_b}[mode]
    live = rows_s < cap
    keep = head & want & live
    ((out_data, out_valid),) = compact_kept([(data_s, valid_s)], keep)
    child = DeviceColumn(out_data, out_valid, a.dtype.children[0],
                         vals.dictionary)
    lens = _seg_sum(keep, torch.where(live, rows_s, cap), cap)
    return EvalValue(lens.to(torch.int32), merge_validity(a, b), out_dtype,
                     children=(child,))


for _op in ("intersect", "union", "except"):
    register(f"array_{_op}", sig("array(T), array(T) -> array(T)"),
             lambda ctx, o, args, _m=_op: _array_setop(ctx, args[0],
                                                       args[1], _m, o))


def _map_concat_eval(ctx, out_dtype, args):
    """map_concat(m1, m2): the union of the entries, m2's winning a
    duplicate key: in (row, key) order the stable sort puts m1's entry
    first, so each run's last entry is kept."""
    a, b = args
    cap = ctx.capacity
    ka, va = a.children
    kb, vb = b.children
    n = ka.capacity + kb.capacity
    rows, _, _, keys = _merged_elements(a, b, ka, kb, ctx, "map_concat")
    vd, va_data, vb_data = _unify_dicts(va, vb)
    perm = _sorted_by_row_value(rows, keys, n, cap)
    rows_s, keys_s, _, head = _runs(perm, rows, keys.data)
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    live = rows_s < cap
    keep = tail & live
    vdt = torch.promote_types(va_data.dtype, vb_data.dtype)
    vdata = torch.cat([va_data.to(vdt), vb_data.to(vdt)])
    vvalid = None
    if va.validity is not None or vb.validity is not None:
        vvalid = torch.cat([_validity_or_ones(va), _validity_or_ones(vb)])
    (k, _), (v, vv) = compact_kept(
        [(keys_s, None), (take_rows(vdata, perm),
                          None if vvalid is None else vvalid[perm])],
        keep)
    kt, vt = a.dtype.children
    lens = _seg_sum(keep, torch.where(live, rows_s, cap), cap)
    return EvalValue(lens.to(torch.int32), merge_validity(a, b), out_dtype,
                     children=(DeviceColumn(k, None, kt, keys.dictionary),
                               DeviceColumn(v, vv, vt, vd)))


register("map_concat", sig("map(K, V), map(K, V) -> map(K, V)"),
         _map_concat_eval)


@special_form("map_zip_with")
def _map_zip_with(expr, ctx, cache):
    """map_zip_with(m1, m2, (k, v1, v2) -> r): the union of the keys, the
    side without a key seeing a NULL value (Presto). Both entry streams
    in one element space, one sort by (row, key, side), and each key's
    run of at most two entries gives v1 and v2."""
    m1 = _eval(expr.args[0], ctx, cache)
    m2 = _eval(expr.args[1], ctx, cache)
    lam = expr.args[2]
    cap = ctx.capacity
    dev = ctx.device
    _require_dense(m1, "map_zip_with")
    _require_dense(m2, "map_zip_with")
    k1, v1c = m1.children
    k2, v2c = m2.children
    e1, e2 = k1.capacity, k2.capacity
    n = e1 + e2
    rows, src, _, keys = _merged_elements(m1, m2, k1, k2, ctx,
                                          "map_zip_with")
    ink = rows < cap
    from velox_tpu_torch.exec.sort import radix_sort_perm, value_words
    vw = value_words(keys, n)
    perm = radix_sort_perm([rows] + vw + [src.to(torch.int64)],
                           [_row_bits(cap)] + [32] * len(vw) + [1], n)
    rows_s, ks, _, boundary = _runs(perm, rows, keys.data)
    src_s = src[perm]
    ink_s = ink[perm]
    rows_c = torch.clamp(rows_s, 0, cap - 1)
    is_end = torch.ones_like(boundary)
    is_end[:-1] = boundary[1:]

    def value_at(child, idx, have):
        valid = have if child.validity is None \
            else have & child.validity[idx]
        return take_rows(child.data, idx), valid

    v1, v1_ok = value_at(v1c, torch.clamp(perm, 0, e1 - 1), ~src_s & ink_s)
    v2, v2_ok = value_at(v2c, torch.clamp(perm - e1, 0, e2 - 1),
                         src_s & ink_s)
    # a 2-entry run's m2 value is at the next sorted position (m1 first)
    v2_next = torch.cat([v2[1:], v2[:1]])
    ok_next = torch.cat([v2_ok[1:], torch.zeros_like(v2_ok[:1])])
    v2_start = torch.where(is_end, v2, v2_next)
    v2_start_ok = torch.where(is_end, v2_ok, ok_next)
    take = boundary & ink_s
    cols = _LiftedColumns(ctx.columns, rows_c, cap)
    cols[lam.params[0]] = EvalValue(ks, None, keys.dtype, keys.dictionary)
    cols[lam.params[1]] = EvalValue(v1, v1_ok, m1.dtype.children[1],
                                    v1c.dictionary)
    cols[lam.params[2]] = EvalValue(v2_start, v2_start_ok,
                                    m2.dtype.children[1], v2c.dictionary)
    ectx = EvalCtx(cols, n, dev)
    out = _eval(lam.body, ectx, {})
    _flag_rows(ctx, ectx.errors, take, rows_c)
    (k, _), (v, vv) = compact_kept(
        [(ks, None), (out.full_data(n),
                      None if out.validity is None
                      else out.full_validity(n))], take)
    lens = _seg_sum(take, _seg(take, rows_c, cap), cap)
    return EvalValue(lens.to(torch.int32), merge_validity(m1, m2), expr.dtype,
                     children=(DeviceColumn(k, None, keys.dtype,
                                            keys.dictionary),
                               DeviceColumn(v, vv, lam.dtype,
                                            out.dictionary)))


register("map_zip_with", sig("map(K, V), map(K, U), W -> map(K, W)"),
         _no_eval)


"""Spark SQL functions, batches 3 and 4.

Counterpart of ``velox_tpu/functions/spark_batch3.py`` (velox/functions/
sparksql Register.cpp): string utilities (``left``, ``startswith``,
``endswith``, ``bit_length``, ``chr``, ``conv``, ``sha1``, ``sha2``,
``mask``, ``empty2null``), the date and time unit casts and
``year_of_week``, the seeded hashes, ``unscaled_value``, the id functions,
``raise_error``, the aliases onto shared implementations (``rlike``,
``exists``, ``forall``, ``aggregate``, ``sort_array``, ...), and the
functions with ARRAY and MAP results on the counts + element children
layout of functions/complex.py: ``split``, ``regexp_extract_all``,
``str_to_map`` and ``json_object_keys`` explode each distinct dictionary
value once on the host and lay the rows' elements out densely on the
device (one element slot a row per part of the longest value, as in the
reference, so nothing is read back); ``get``, ``array_repeat``,
``map_from_arrays``, ``arrays_zip``, ``array`` and ``map``; the UTC
conversions, ``make_timestamp``, ``get_timestamp``; and ``might_contain``
over bloom_filter_agg's ARRAY(INTEGER) sketch, whose bit-word gathers run
kernel B5 (ops/gather.py).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import json as _json
import re

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common.errors import note_traced_error
from velox_tpu_torch.expression.eval import EvalValue, merge_validity
from velox_tpu_torch.functions.complex import _offsets, _require_dense
from velox_tpu_torch.functions.registry import register
from velox_tpu_torch.functions.scalar import (
    _civil_from_days, _days_from_civil, _dict_lookup, _dict_map,
    _floor_div, _gather_table, _require_dict, promote_numeric,
)
from velox_tpu_torch.functions.signature import sig
from velox_tpu_torch.functions.sparksql import (
    _alias, _alias_special, _const_arg, _spark_hash_eval,
    _spark_xxhash64_eval,
)
from velox_tpu_torch.ops.gather import take_rows
from velox_tpu_torch.vector.device import DeviceColumn, Dictionary

_alias("rlike", "regexp_like")
_alias("exists", "any_match")
_alias_special("exists", "any_match")
_alias("forall", "all_match")
_alias_special("forall", "all_match")
_alias("aggregate", "reduce")
_alias_special("aggregate", "reduce")
_alias("get_json_object", "json_extract")
_alias("instr", "strpos")
_alias("to_unix_timestamp", "unix_timestamp")
# array_sort is a special form: alias the entry (typing) and the form
_alias("sort_array", "array_sort")
_alias_special("sort_array", "array_sort")


# ---------------------------------------------------------------------------
# String utilities (dictionary space)
# ---------------------------------------------------------------------------

register("left", sig("string, integral -> varchar"),
         lambda ctx, o, a: _dict_map(
             a[0], lambda s, n=int(_const_arg(a, 1, "left")): s[:max(0, n)],
             "left"))


def _affix(fname: str, method: str):
    def eval_fn(ctx, out_dtype, args):
        p = str(_const_arg(args, 1, fname))
        return _dict_lookup(args[0], lambda s: getattr(s, method)(p),
                            T.BOOLEAN, fname)
    return eval_fn


register("startswith", sig("string, string -> boolean"),
         _affix("startswith", "startswith"))
register("endswith", sig("string, string -> boolean"),
         _affix("endswith", "endswith"))
register("bit_length", sig("string -> integer"),
         lambda ctx, o, a: _dict_lookup(
             a[0], lambda s: 8 * len(s.encode("utf-8")), T.INTEGER,
             "bit_length"))


def _chr_eval(ctx, out_dtype, args):
    """chr(n): the character n % 256; '' for n < 0 (Spark's Chr)."""
    vals = sorted({chr(i) for i in range(256)} | {""})
    d = Dictionary(vals)
    d.is_sorted = True
    ids = {v: i for i, v in enumerate(vals)}
    table = torch.tensor([ids[chr(i)] for i in range(256)],
                         dtype=torch.int32, device=ctx.device)
    n = args[0].full_data(ctx.capacity).to(torch.int64)
    data = torch.where(n < 0, ids[""], table[torch.remainder(n, 256)])
    return EvalValue(data, args[0].validity, T.VARCHAR, d)


register("chr", lambda ts: T.VARCHAR if ts and ts[0].is_integral else None,
         _chr_eval)

_DIGITS = "0123456789abcdefghijklmnopqrstuvwxyz"


def _conv_eval(ctx, out_dtype, args):
    fb = int(_const_arg(args, 1, "conv"))
    tb = int(_const_arg(args, 2, "conv"))

    def f(s):
        try:
            v = int(s.strip(), fb)
        except ValueError:
            return ""
        if v == 0:
            return "0"
        if v < 0:
            # Spark's NumberConverter: a negative value wraps to unsigned
            # 64 bits before it is re-encoded
            v &= (1 << 64) - 1
        out = []
        while v:
            out.append(_DIGITS[v % tb])
            v //= tb
        return "".join(reversed(out)).upper()
    return _dict_map(args[0], f, "conv")


register("conv", sig("string, integral, integral -> varchar"), _conv_eval)
register("sha1", sig("string -> varchar"),
         lambda ctx, o, a: _dict_map(
             a[0], lambda s: hashlib.sha1(s.encode()).hexdigest(), "sha1"))

_SHA2 = {224: hashlib.sha224, 256: hashlib.sha256, 384: hashlib.sha384,
         512: hashlib.sha512}


def _sha2_eval(ctx, out_dtype, args):
    bits = int(_const_arg(args, 1, "sha2", 256)) or 256
    algo = _SHA2.get(bits)
    if algo is None:
        raise ValueError(f"sha2: unsupported bit length {bits}")
    return _dict_map(args[0], lambda s: algo(s.encode()).hexdigest(), "sha2")


register("sha2", sig("string, integral -> varchar"), _sha2_eval)


def _mask_eval(ctx, out_dtype, args):
    """mask(s[, upper, lower, digit, other]): Spark's MaskFunction.h
    defaults X, x, n and unchanged; a NULL replacement keeps the class."""
    up = _const_arg(args, 1, "mask", "X")
    lo = _const_arg(args, 2, "mask", "x")
    dg = _const_arg(args, 3, "mask", "n")
    ot = _const_arg(args, 4, "mask", "\0")

    def repl(c):
        if c.isupper():
            return c if up is None else str(up)
        if c.islower():
            return c if lo is None else str(lo)
        if c.isdigit():
            return c if dg is None else str(dg)
        return c if (ot is None or ot == "\0") else str(ot)
    return _dict_map(args[0], lambda s: "".join(repl(c) for c in s), "mask")


register("mask",
         lambda ts: T.VARCHAR if ts and ts[0].is_string and len(ts) <= 5
         else None, _mask_eval)


def _empty2null_eval(ctx, out_dtype, args):
    v = args[0]
    nonempty = _dict_lookup(v, lambda s: len(s) > 0, T.BOOLEAN, "empty2null")
    validity = nonempty.data
    if v.validity is not None:
        validity = validity & v.full_validity(ctx.capacity)
    return EvalValue(v.data, validity, v.dtype, v.dictionary)


register("empty2null", sig("string -> varchar"), _empty2null_eval)


# ---------------------------------------------------------------------------
# Date and time unit casts
# ---------------------------------------------------------------------------

def _i64(v: EvalValue, ctx) -> torch.Tensor:
    return v.full_data(ctx.capacity).to(torch.int64)


register("date_from_unix_date", sig("integral -> date"),
         lambda ctx, o, a: EvalValue(a[0].full_data(ctx.capacity).to(
             torch.int32), a[0].validity, T.DATE))


def _ts_scale(mult: int):
    return lambda ctx, o, a: EvalValue(_i64(a[0], ctx) * mult, a[0].validity,
                                       T.TIMESTAMP)


def _unix_scale(div: int):
    # floored (negative instants round toward -inf, Spark's floorDiv)
    return lambda ctx, o, a: EvalValue(_floor_div(_i64(a[0], ctx), div),
                                       a[0].validity, T.BIGINT)


register("timestamp_micros", sig("integral -> timestamp"), _ts_scale(1))
register("timestamp_millis", sig("integral -> timestamp"), _ts_scale(1000))
register("unix_micros", sig("timestamp -> bigint"), _unix_scale(1))
register("unix_millis", sig("timestamp -> bigint"), _unix_scale(1000))
register("unix_seconds", sig("timestamp -> bigint"), _unix_scale(1_000_000))


def _year_of_week_eval(ctx, out_dtype, args):
    """The ISO week-numbering year: the calendar year of the Thursday of
    the date's ISO week (1970-01-01 was a Thursday)."""
    days = _i64(args[0], ctx)
    y, _, _ = _civil_from_days(days - torch.remainder(days + 3, 7) + 3)
    return EvalValue(y.to(torch.int32), args[0].validity, T.INTEGER)


register("year_of_week", sig("date -> integer"), _year_of_week_eval)


# ---------------------------------------------------------------------------
# Seeded hashes, unscaled_value, ids, raise_error
# ---------------------------------------------------------------------------

def _seeded(fname: str, hash_eval):
    def eval_fn(ctx, out_dtype, args):
        seed = int(_const_arg(args, 0, fname))
        return hash_eval(ctx, out_dtype, args[1:], seed=seed)
    return eval_fn


def _seeded_resolver(out):
    return lambda ts: out if len(ts) >= 2 and ts[0].is_integral else None


register("hash_with_seed", _seeded_resolver(T.INTEGER),
         _seeded("hash_with_seed", _spark_hash_eval))
register("xxhash64_with_seed", _seeded_resolver(T.BIGINT),
         _seeded("xxhash64_with_seed", _spark_xxhash64_eval))


def _unscaled_resolver(ts):
    if len(ts) == 1 and ts[0].kind is T.TypeKind.DECIMAL \
            and not ts[0].is_long_decimal:
        return T.BIGINT
    return None


register("unscaled_value", _unscaled_resolver,
         lambda ctx, o, a: EvalValue(_i64(a[0], ctx), a[0].validity,
                                     T.BIGINT))


def _mono_id_eval(ctx, out_dtype, args):
    """An expression cannot see the batch's ordinal, so ids would restart
    every batch; the AssignUniqueId plan node is the supported form."""
    raise NotImplementedError(
        "monotonically_increasing_id: use the AssignUniqueId plan node "
        "(PlanBuilder.assign_unique_id); expression-space ids would "
        "repeat across batches")


def _nullary(out):
    return lambda ts: out if len(ts) == 0 else None


register("monotonically_increasing_id", _nullary(T.BIGINT), _mono_id_eval)
register("spark_partition_id", _nullary(T.INTEGER),
         lambda ctx, o, a: EvalValue(torch.zeros(
             (ctx.capacity,), dtype=torch.int32, device=ctx.device), None,
             T.INTEGER))


def _raise_error_eval(ctx, out_dtype, args):
    """Flags every row on the error channel (EvalCtx.flag_error): the
    Task raises a VeloxUserError naming the message, and TRY(...) turns
    the rows NULL (Spark's RaiseError.h)."""
    if args and args[0].py_value is not None:
        note_traced_error(str(args[0].py_value))
    cap = ctx.capacity
    ctx.flag_error(torch.ones((cap,), dtype=torch.bool, device=ctx.device))
    zeros = torch.zeros((cap,), dtype=torch.bool, device=ctx.device)
    return EvalValue(zeros, zeros, T.UNKNOWN)


register("raise_error", lambda ts: T.UNKNOWN if len(ts) <= 1 else None,
         _raise_error_eval)


# ---------------------------------------------------------------------------
# Lists of each dictionary value: split, regexp_extract_all, str_to_map,
# json_object_keys
# ---------------------------------------------------------------------------

def _explode_core(v: EvalValue, ctx, parts):
    """(counts, the source of each element slot in the flat concatenation
    of ``parts``, slot in use) for the rows of dictionary column ``v``,
    where ``parts`` holds each dictionary value's list. The slots are
    ``capacity x longest list``, the rows' elements dense at their front;
    the row of a slot comes from a search of the counts' prefix sums."""
    dev = v.data.device
    cap = ctx.capacity
    lens_np = np.array([len(p) for p in parts] or [0], np.int32)
    first_np = np.concatenate([[0], np.cumsum(lens_np)[:-1]])
    ids = v.full_data(cap).to(torch.int64).clamp(0, len(lens_np) - 1)
    lens = take_rows(torch.from_numpy(lens_np).to(dev), ids)
    ends = torch.cumsum(lens.to(torch.int64), 0)
    starts = ends - lens
    slots = max(1, cap * max(1, int(lens_np.max())))
    e = torch.arange(slots, dtype=torch.int64, device=dev)
    row = torch.searchsorted(ends, e, right=True).clamp(max=cap - 1)
    pos = e - take_rows(starts, row)
    n_flat = max(1, int(lens_np.sum()))
    first = torch.from_numpy(first_np.astype(np.int64)).to(dev)
    src = (take_rows(first, take_rows(ids, row)) + pos).clamp(0, n_flat - 1)
    in_use = e < ends[-1]
    return lens, src, in_use


def _flat_strings(parts, src, in_use) -> DeviceColumn:
    """The VARCHAR element column of ``src``'s slots in the flat parts:
    ids into the sorted distinct parts."""
    uniq = sorted({p for ps in parts for p in ps})
    pid = {p: i for i, p in enumerate(uniq)}
    d = Dictionary(uniq)
    d.is_sorted = True
    flat = np.array([pid[p] for ps in parts for p in ps] or [0], np.int32)
    data = take_rows(torch.from_numpy(flat).to(src.device), src)
    return DeviceColumn(torch.where(in_use, data, 0), None, T.VARCHAR, d)


def _explode_parts(v: EvalValue, ctx, parts) -> EvalValue:
    """ARRAY(VARCHAR) of each row's dictionary value's list in ``parts``."""
    lens, src, in_use = _explode_core(v, ctx, parts)
    return EvalValue(lens, v.validity, T.array(T.VARCHAR),
                     children=(_flat_strings(parts, src, in_use),))


def _explode(v: EvalValue, ctx, f, fname: str) -> EvalValue:
    """ARRAY(VARCHAR) of ``f`` of each row's dictionary value."""
    return _explode_parts(v, ctx, [f(x) for x in _require_dict(
        v, fname).values])


def _split_eval(ctx, out_dtype, args):
    pat = re.compile(str(_const_arg(args, 1, "split")))
    limit = int(_const_arg(args, 2, "split", -1))
    return _explode(args[0], ctx, lambda s: pat.split(
        s, maxsplit=(limit - 1 if limit > 0 else 0)), "split")


register("split", sig("string, string -> array(varchar)"), _split_eval)
register("split", sig("string, string, integral -> array(varchar)"),
         _split_eval)


def _regexp_extract_all_eval(ctx, out_dtype, args):
    pat = re.compile(str(_const_arg(args, 1, "regexp_extract_all")))
    group = int(_const_arg(args, 2, "regexp_extract_all", 0))
    return _explode(args[0], ctx,
                    lambda s: [m.group(group) or "" for m in pat.finditer(s)],
                    "regexp_extract_all")


register("regexp_extract_all", sig("string, string -> array(varchar)"),
         _regexp_extract_all_eval)
register("regexp_extract_all",
         sig("string, string, integral -> array(varchar)"),
         _regexp_extract_all_eval)


def _str_to_map_eval(ctx, out_dtype, args):
    """str_to_map(s[, entry_delim, kv_delim]): one explode; the keys,
    values and value NULLs are parallel flat tables over its slots."""
    v = args[0]
    d1 = str(_const_arg(args, 1, "str_to_map", ","))
    d2 = str(_const_arg(args, 2, "str_to_map", ":"))
    pairs = []
    for s in _require_dict(v, "str_to_map").values:
        kv = []
        for part in (s.split(d1) if s else []):
            k, _, val = part.partition(d2)
            kv.append((k, val if d2 in part else None))
        pairs.append(kv)
    lens, src, in_use = _explode_core(v, ctx, pairs)
    keys = _flat_strings([[k for k, _ in ps] for ps in pairs], src, in_use)
    vals = _flat_strings([["" if x is None else x for _, x in ps]
                          for ps in pairs], src, in_use)
    flat_null = np.array([x is None for ps in pairs for _, x in ps]
                         or [False], bool)
    isnull = torch.from_numpy(flat_null).to(src.device)[src] & in_use
    vals = DeviceColumn(vals.data, ~isnull, T.VARCHAR, vals.dictionary)
    return EvalValue(lens, v.validity, T.map_(T.VARCHAR, T.VARCHAR),
                     children=(keys, vals))


register("str_to_map",
         lambda ts: T.map_(T.VARCHAR, T.VARCHAR)
         if ts and ts[0].is_string and len(ts) <= 3 else None,
         _str_to_map_eval)


def _object_keys(s: str):
    try:
        val = _json.loads(s)
    except ValueError:
        return None
    return list(val.keys()) if isinstance(val, dict) else None


def _json_object_keys_eval(ctx, out_dtype, args):
    """json_object_keys(json): the top-level keys in order; NULL where
    the document is not an object (Spark's JsonObjectKeys.h)."""
    v = args[0]
    keys = [_object_keys(s) for s in _require_dict(
        v, "json_object_keys").values]
    out = _explode_parts(v, ctx, [k or [] for k in keys])
    is_obj = _gather_table(np.array([k is not None for k in keys] or [False],
                                    bool), v)
    validity = is_obj if v.validity is None else is_obj & v.full_validity(
        ctx.capacity)
    return EvalValue(out.data, validity, out.dtype, children=out.children)


register("json_object_keys", sig("string -> array(varchar)"),
         _json_object_keys_eval)


# ---------------------------------------------------------------------------
# Arrays and maps
# ---------------------------------------------------------------------------

def _get_eval(ctx, out_dtype, args):
    """Spark's get(array, index): 0-based; NULL (not an error) out of
    bounds."""
    arr, idx = args
    child = arr.children[0]
    lens = arr.data.to(torch.int64)
    i = _i64(idx, ctx)
    in_bounds = (i >= 0) & (i < lens)
    src = (_offsets(arr) + i).clamp(0, child.capacity - 1)
    validity = in_bounds
    if arr.validity is not None:
        validity = validity & arr.validity
    if idx.validity is not None:
        validity = validity & idx.full_validity(ctx.capacity)
    if child.validity is not None:
        validity = validity & child.validity[src]
    return EvalValue(take_rows(child.data, src), validity,
                     arr.dtype.children[0], child.dictionary)


register("get",
         lambda ts: ts[0].children[0] if len(ts) == 2
         and ts[0].kind is T.TypeKind.ARRAY and ts[1].is_integral else None,
         _get_eval)


def _array_repeat_eval(ctx, out_dtype, args):
    """array_repeat(elem, n), n a constant."""
    elem = args[0]
    n = max(0, int(_const_arg(args, 1, "array_repeat")))
    cap = ctx.capacity
    data = elem.full_data(cap)
    validity = None
    if n:
        child_data = torch.repeat_interleave(data, n)
        if elem.validity is not None:
            validity = torch.repeat_interleave(elem.full_validity(cap), n)
    else:
        child_data = torch.zeros((1,), dtype=data.dtype, device=data.device)
    child = DeviceColumn(child_data, validity, elem.dtype, elem.dictionary)
    return EvalValue(torch.full((cap,), n, dtype=torch.int32,
                                device=ctx.device), None,
                     T.array(elem.dtype), children=(child,))


register("array_repeat",
         lambda ts: T.array(ts[0]) if len(ts) == 2 and ts[1].is_integral
         else None, _array_repeat_eval)


def _map_from_arrays_eval(ctx, out_dtype, args):
    """map_from_arrays(keys, values): rows whose two lengths differ flag
    the error channel (Spark raises). The two element columns become the
    map's, so both arrays must be dense (not gathered by an operator)."""
    ka, va = args
    for a in (ka, va):
        _require_dense(a, "map_from_arrays")
    lens_k = ka.data.to(torch.int32)
    ok_rows = torch.ones((ctx.capacity,), dtype=torch.bool,
                         device=ctx.device)
    for a in (ka, va):
        if a.validity is not None:
            ok_rows = ok_rows & a.validity
    ctx.flag_error((lens_k != va.data.to(torch.int32)) & ok_rows)
    return EvalValue(lens_k, merge_validity(ka, va),
                     T.map_(ka.dtype.children[0], va.dtype.children[0]),
                     children=(ka.children[0], va.children[0]))


register("map_from_arrays",
         lambda ts: T.map_(ts[0].children[0], ts[1].children[0])
         if len(ts) == 2 and all(t.kind is T.TypeKind.ARRAY for t in ts)
         else None, _map_from_arrays_eval)


def _arrays_zip_eval(ctx, out_dtype, args):
    """arrays_zip(a, b) -> array(row(0, 1)): element j pairs a[j] with
    b[j], the shorter array giving NULLs (Spark's ArraysZip), in a fresh
    dense element space of |a elements| + |b elements| slots."""
    a, b = args
    ca, cb = a.children[0], b.children[0]
    la, lb = a.data.to(torch.int64), b.data.to(torch.int64)
    lo = torch.maximum(la, lb)
    ends = torch.cumsum(lo, 0)
    out_cap = ca.capacity + cb.capacity
    cap = ctx.capacity
    e = torch.arange(out_cap, dtype=torch.int64, device=ctx.device)
    row = torch.searchsorted(ends, e, right=True).clamp(max=cap - 1)
    pos = e - take_rows(ends - lo, row)

    def field(arr, child, lens):
        src = (take_rows(_offsets(arr), row) + pos).clamp(
            0, child.capacity - 1)
        validity = pos < take_rows(lens, row)
        if child.validity is not None:
            validity = validity & child.validity[src]
        return DeviceColumn(take_rows(child.data, src), validity,
                            arr.dtype.children[0], child.dictionary)

    fields = (field(a, ca, la), field(b, cb, lb))
    row_child = DeviceColumn(
        torch.zeros((out_cap,), dtype=torch.int32, device=ctx.device), None,
        out_dtype.children[0], None, fields)
    return EvalValue(lo.to(torch.int32), merge_validity(a, b), out_dtype,
                     children=(row_child,))


register("arrays_zip",
         lambda ts: T.array(T.row(["0", "1"], [ts[0].children[0],
                                               ts[1].children[0]]))
         if len(ts) == 2 and all(t.kind is T.TypeKind.ARRAY for t in ts)
         else None, _arrays_zip_eval)


def _might_contain_eval(ctx, out_dtype, args):
    """might_contain(bloom, x): x's k = 3 double-hashed bit probes against
    bloom_filter_agg's ARRAY(INTEGER) sketch (functions/aggregates.py
    BloomFilterAgg, exec/hashtable.py bloom_hashes). Each probe's word is
    one B5 gather. A NULL or empty bloom, or a NULL x, gives NULL."""
    from velox_tpu_torch.exec.hashtable import bloom_hashes
    from velox_tpu_torch.functions.aggregates import BloomFilterAgg
    arr, x = args
    cap = ctx.capacity
    child = arr.children[0]
    lens = arr.data.to(torch.int64)
    starts = _offsets(arr)
    m = torch.clamp(lens * 32, min=1)  # bits: a power of two
    h1, h2 = bloom_hashes(x, cap)
    hit = torch.ones((cap,), dtype=torch.bool, device=ctx.device)
    words = child.data.to(torch.int32)
    for i in range(BloomFilterAgg.K):
        p = torch.remainder((h1 + i * h2) & 0xFFFFFFFF, m)
        src = (starts + (p >> 5)).clamp(0, child.capacity - 1)
        w = take_rows(words, src).to(torch.int64)
        hit = hit & (((w >> (p & 31)) & 1) != 0)
    validity = lens > 0
    if arr.validity is not None:
        validity = validity & arr.validity
    if x.validity is not None:
        validity = validity & x.full_validity(cap)
    return EvalValue(hit, validity, T.BOOLEAN)


register("might_contain",
         lambda ts: T.BOOLEAN if len(ts) == 2
         and ts[0].kind is T.TypeKind.ARRAY else None, _might_contain_eval)


def _array_ctor_eval(ctx, out_dtype, args):
    """array(e1, ..., eN): N elements a row, interleaved row-major."""
    cap = ctx.capacity
    et = out_dtype.children[0]
    n = len(args)
    if n == 0:
        child = DeviceColumn(torch.zeros((1,), dtype=et.torch_dtype(),
                                         device=ctx.device), None, et)
        return EvalValue(torch.zeros((cap,), dtype=torch.int32,
                                     device=ctx.device), None, out_dtype,
                         children=(child,))
    dicts = [a.dictionary for a in args]
    d0 = next((d for d in dicts if d is not None), None)
    if any(d is not None and d is not d0 for d in dicts):
        raise NotImplementedError(
            "array(): string operands must share one dictionary")
    datas = [a.full_data(cap) for a in args]
    common = datas[0].dtype
    for d in datas[1:]:
        common = torch.promote_types(common, d.dtype)
    data = torch.stack([d.to(common) for d in datas], dim=1).reshape(-1)
    validity = None
    if any(a.validity is not None for a in args):
        validity = torch.stack([a.full_validity(cap) for a in args],
                               dim=1).reshape(-1)
    child = DeviceColumn(data, validity, et, d0)
    return EvalValue(torch.full((cap,), n, dtype=torch.int32,
                                device=ctx.device), None, out_dtype,
                     children=(child,))


def _array_ctor_resolver(ts):
    if not ts:
        return None
    if all(t == ts[0] for t in ts):
        return T.array(ts[0])
    if all(t.is_numeric for t in ts):
        # the least common numeric element type (Spark's TypeCoercion)
        out = ts[0]
        for t in ts[1:]:
            out = promote_numeric(out, t)
        return T.array(out)
    return None


register("array", _array_ctor_resolver, _array_ctor_eval)


def _map_ctor_eval(ctx, out_dtype, args):
    """map(k1, v1, ..., kN, vN). NULL and duplicate keys flag the error
    channel (Spark: 'Cannot use null as map key', the EXCEPTION dedup
    policy); TRY(map(...)) gives NULL rows instead."""
    cap = ctx.capacity
    keys = args[0::2]
    ka = _array_ctor_eval(ctx, T.array(out_dtype.children[0]), keys)
    va = _array_ctor_eval(ctx, T.array(out_dtype.children[1]), args[1::2])
    bad = torch.zeros((cap,), dtype=torch.bool, device=ctx.device)
    for k in keys:
        if k.validity is not None:
            bad = bad | ~k.full_validity(cap)
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            bad = bad | (keys[i].full_data(cap) == keys[j].full_data(cap))
    ctx.flag_error(bad)
    return EvalValue(ka.data, None, out_dtype,
                     children=(ka.children[0], va.children[0]))


register("map",
         lambda ts: T.map_(ts[0], ts[1]) if len(ts) >= 2 and len(ts) % 2 == 0
         else None, _map_ctor_eval)


# ---------------------------------------------------------------------------
# Timestamps
# ---------------------------------------------------------------------------

def _local_to_utc(local_us, tz: str):
    """Local wall-clock micros to UTC: the zone's transitions are indexed
    by UTC instants, so a first offset at local-as-UTC, then the offset at
    the corrected instant (right around each DST change; an ambiguous or
    skipped local time takes the offset after the change)."""
    from velox_tpu_torch.functions.datetime import _tz_offset_seconds
    off1 = _tz_offset_seconds(local_us, tz)
    off2 = _tz_offset_seconds(local_us - off1 * 1_000_000, tz)
    return local_us - off2 * 1_000_000


def _from_utc_eval(ctx, out_dtype, args):
    from velox_tpu_torch.functions.datetime import _tz_offset_seconds
    ts = _i64(args[0], ctx)
    off = _tz_offset_seconds(ts, str(_const_arg(args, 1,
                                                "from_utc_timestamp")))
    return EvalValue(ts + off * 1_000_000, args[0].validity, T.TIMESTAMP)


def _to_utc_eval(ctx, out_dtype, args):
    tz = str(_const_arg(args, 1, "to_utc_timestamp"))
    return EvalValue(_local_to_utc(_i64(args[0], ctx), tz),
                     args[0].validity, T.TIMESTAMP)


register("from_utc_timestamp", sig("timestamp, string -> timestamp"),
         _from_utc_eval)
register("to_utc_timestamp", sig("timestamp, string -> timestamp"),
         _to_utc_eval)


def _make_timestamp_eval(ctx, out_dtype, args):
    """make_timestamp(y, mo, d, h, mi, sec[, tz]): sec may be a DECIMAL
    with fractional micros; invalid fields give NULL (Spark with ANSI
    off)."""
    cap = ctx.capacity
    y, mo, d, h, mi = (_i64(a, ctx) for a in args[:5])
    sec = args[5]
    if sec.dtype.kind is T.TypeKind.DECIMAL:
        micros = _i64(sec, ctx) * (10 ** max(0, 6 - sec.dtype.scale))
    else:
        micros = _i64(sec, ctx) * 1_000_000
    ok = ((mo >= 1) & (mo <= 12) & (d >= 1) & (d <= 31)
          & (h >= 0) & (h < 24) & (mi >= 0) & (mi < 60)
          & (micros >= 0) & (micros < 61_000_000))
    days = _days_from_civil(y, mo, d)
    ts = (days * 86_400 + h * 3_600 + mi * 60) * 1_000_000 + micros
    if len(args) > 6:  # the fields are local time in this zone
        ts = _local_to_utc(ts, str(_const_arg(args, 6, "make_timestamp")))
    validity = ok
    for a in args[:6]:
        if a.validity is not None:
            validity = validity & a.full_validity(cap)
    return EvalValue(ts, validity, T.TIMESTAMP)


register("make_timestamp", lambda ts: T.TIMESTAMP if len(ts) in (6, 7)
         else None, _make_timestamp_eval)

# Java SimpleDateFormat tokens -> strptime
_TOKENS = {"yyyy": "%Y", "yy": "%y", "MM": "%m", "M": "%m", "dd": "%d",
           "d": "%d", "HH": "%H", "H": "%H", "mm": "%M", "m": "%M",
           "ss": "%S", "s": "%S"}
_TOKEN_RE = r"y+|M+|d+|H+|m+|s+"


def _strptime_format(fmt: str) -> str:
    parts = []
    for piece in re.split(f"({_TOKEN_RE})", fmt):
        if not piece:
            continue
        if re.fullmatch(_TOKEN_RE, piece):
            if piece not in _TOKENS:
                raise NotImplementedError(
                    f"get_timestamp: unsupported pattern token {piece!r} "
                    f"in {fmt!r}")
            parts.append(_TOKENS[piece])
        elif re.search(r"[A-Za-z%]", piece):
            raise NotImplementedError(
                f"get_timestamp: unsupported pattern literal {piece!r} in "
                f"{fmt!r}")
        else:
            parts.append(piece)
    return "".join(parts)


def _get_timestamp_eval(ctx, out_dtype, args):
    """get_timestamp(s, fmt): parse with a SimpleDateFormat pattern (the
    subset strptime maps); NULL where it does not parse. One parse a
    distinct value."""
    pyfmt = _strptime_format(str(_const_arg(args, 1, "get_timestamp")))
    epoch = _dt.datetime(1970, 1, 1)

    def f(s):
        try:
            d = _dt.datetime.strptime(s, pyfmt)
        except ValueError:
            return None
        return int((d - epoch).total_seconds() * 1_000_000)
    return _dict_lookup(args[0], f, T.TIMESTAMP, "get_timestamp")


register("get_timestamp", sig("string, string -> timestamp"),
         _get_timestamp_eval)

"""The Spark SQL function package.

Counterpart of ``velox_tpu/functions/sparksql.py`` (velox/functions/
sparksql): Spark's semantics where they differ from Presto's (``pmod``,
``size``, ``datediff``'s argument order, ``add_months``, the two-argument
``date_add``/``date_sub``), the aliases onto shared implementations, the
murmur3 ``hash`` and ``xxhash64`` of Spark's shuffles (Hash.cpp: seed 42,
the seed chained across the arguments, a NULL leaving it unchanged), the
Spark date functions and the dictionary-string functions (one host pass
over the distinct values, then one device gather by id).

The hashes run on int64 lanes: murmur3's uint32 state in the low 32 bits
(masked after each product), xxhash64's uint64 state as its 64 bits, each
right shift masked to a logical one. They dispatch on the logical type,
not the storage: a DECIMAL(12,2) stored as int32 hashes as Spark's 8-byte
unscaled long. A DOUBLE hashes its true bits (``view``), -0.0 as 0.0 and
NaN as 0x7FF8000000000000, as Spark does; the reference rebuilds the bits
arithmetically and flushes subnormals to zero (ROADMAP C). A string hashes
its UTF-8 bytes: the blocks of each dictionary value are laid out once a
dictionary, and rows fold them one block column at a time, so memory stays
a few row-sized lanes whatever the strings' length; where the seed is a
constant (a string first in the chain) each dictionary value is hashed
once and rows gather the result. A raw string column raises (the
reference fails there too).
"""

from __future__ import annotations

import hashlib
import re
import zlib

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import (
    _SPECIAL_FORMS, EvalValue, merge_validity,
)
from velox_tpu_torch.functions.registry import _REGISTRY, register
from velox_tpu_torch.functions.scalar import (
    _civil_from_days, _date_days, _days_from_civil, _dict_lookup, _dict_map,
    _dict_map_nullable, _floor_div, _numeric_data, _s64, _srl64,
    dict_cached, promote_numeric,
)
from velox_tpu_torch.functions.signature import sig
from velox_tpu_torch.ops.gather import take_rows


def _alias(new: str, old: str):
    if old in _REGISTRY:
        _REGISTRY[new] = _REGISTRY[old]


def _alias_special(new: str, old: str):
    if old in _SPECIAL_FORMS:
        _SPECIAL_FORMS[new] = _SPECIAL_FORMS[old]


_alias_special("nvl", "coalesce")
_alias_special("ifnull", "coalesce")
_alias_special("isnull", "is_null")
_alias_special("isnotnull", "is_not_null")
_alias("shiftleft", "bitwise_shift_left")
_alias("shiftright", "bitwise_arithmetic_shift_right")
_alias("pow", "power")
_alias("lcase", "lower")
_alias("ucase", "upper")
_alias("char_length", "length")
_alias("dayofweek", "day_of_week")
_alias("dayofyear", "day_of_year")
_alias("weekofyear", "week")


def _all_numeric(ts) -> bool:
    return all(t.is_numeric for t in ts)


def _pmod_eval(ctx, out_dtype, args):
    """Spark's pmod: ``r = a % b; if (r < 0) (r + b) % b`` with Java's
    truncating %: the floored remainder for b > 0, the truncated one for
    b < 0 (pmod(10, -3) = 1, pmod(-10, -3) = -1); NULL for b = 0."""
    a, b = args
    da = _numeric_data(a, out_dtype)
    db = _numeric_data(b, out_dtype)
    safe = torch.where(db == 0, torch.ones_like(db), db)
    floored = torch.remainder(da, safe)
    trunc = torch.sign(da) * torch.remainder(torch.abs(da), torch.abs(safe))
    r = torch.where(db > 0, floored, trunc).to(floored.dtype)
    validity = merge_validity(a, b)
    nonzero = db != 0
    validity = nonzero if validity is None else validity & nonzero
    return EvalValue(r, validity, out_dtype)


register("pmod",
         lambda ts: (T.BIGINT if all(t.is_integral for t in ts)
                     else T.DOUBLE)
         if len(ts) == 2 and _all_numeric(ts) else None, _pmod_eval)


def _size_eval(ctx, out_dtype, args):
    """Spark's size(): the element count as an INTEGER."""
    (v,) = args
    return EvalValue(v.data.to(torch.int32), v.validity, T.INTEGER)


register("size",
         lambda ts: T.INTEGER if len(ts) == 1 and ts[0].is_complex
         else None, _size_eval)


def _days_of(v: EvalValue, ctx) -> torch.Tensor:
    d = v.full_data(ctx.capacity).to(torch.int64)
    if v.dtype.kind is T.TypeKind.TIMESTAMP:
        d = _floor_div(d, 86_400_000_000)
    return d


_DATELIKE = (T.TypeKind.DATE, T.TypeKind.TIMESTAMP)


def _datediff_eval(ctx, out_dtype, args):
    """Spark's datediff(end, start) in days (note the order)."""
    end, start = args
    return EvalValue(_days_of(end, ctx) - _days_of(start, ctx),
                     merge_validity(end, start), T.BIGINT)


register("datediff",
         lambda ts: T.BIGINT if len(ts) == 2 and all(
             t.kind in _DATELIKE for t in ts) else None,
         _datediff_eval)


def _add_months_eval(ctx, out_dtype, args):
    from velox_tpu_torch.functions.datetime import _shift_months
    d, n = args
    out = _shift_months(_days_of(d, ctx),
                        n.full_data(ctx.capacity).to(torch.int64))
    return EvalValue(out.to(torch.int32), merge_validity(d, n), T.DATE)


register("add_months",
         lambda ts: T.DATE if len(ts) == 2
         and ts[0].kind in _DATELIKE and ts[1].is_integral
         else None, _add_months_eval)


# ---------------------------------------------------------------------------
# Spark's murmur3 hash (Murmur3Hash: hashInt/hashLong/hashUnsafeBytes)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_MM_C1 = 0xCC9E2D51
_MM_C2 = 0x1B873593


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mm_mix_k1(k1):
    k1 = (k1 * _MM_C1) & _M32
    return (_rotl32(k1, 15) * _MM_C2) & _M32


def _mm_mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _mm_fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def _mm_hash_i32(u32, seed):
    return _mm_fmix(_mm_mix_h1(seed, _mm_mix_k1(u32)), 4)


def _mm_hash_i64(i64, seed):
    h1 = _mm_mix_h1(seed, _mm_mix_k1(i64 & _M32))
    h1 = _mm_mix_h1(h1, _mm_mix_k1((i64 >> 32) & _M32))
    return _mm_fmix(h1, 8)


def _double_bits(x: torch.Tensor) -> torch.Tensor:
    """Java's doubleToLongBits after Spark's -0.0 -> 0.0: the true bits,
    every NaN as the canonical 0x7FF8000000000000."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.contiguous().view(torch.int64)
    return torch.where(torch.isnan(x), 0x7FF8000000000000, bits)


def _float_bits(x: torch.Tensor) -> torch.Tensor:
    """floatToIntBits after -0.0 -> 0.0, as uint32 in int64 lanes."""
    x = torch.where(x == 0.0, torch.zeros_like(x), x)
    bits = x.contiguous().view(torch.int32).to(torch.int64) & _M32
    return torch.where(torch.isnan(x), 0x7FC00000, bits)


def _int_bits(v: EvalValue, cap: int) -> torch.Tensor:
    """A 4-byte kind's value as uint32 in int64 lanes."""
    return v.full_data(cap).to(torch.int32).to(torch.int64) & _M32


_INT4 = (T.TypeKind.BOOLEAN, T.TypeKind.TINYINT, T.TypeKind.SMALLINT,
         T.TypeKind.INTEGER, T.TypeKind.DATE)
_INT8 = (T.TypeKind.BIGINT, T.TypeKind.TIMESTAMP, T.TypeKind.DECIMAL)


def _utf8(x) -> bytes:
    return x.encode("utf-8") if isinstance(x, str) else bytes(x)


def _dict_tables(kind: str, v: EvalValue, fname: str, build):
    """``build(list of UTF-8 values)``'s numpy tables on the column's
    device, made once per dictionary (functions/scalar.py
    ``dict_cached``)."""
    if v.dictionary is None:
        raise NotImplementedError(
            f"{fname} over a raw (dictionary-less) string column is not "
            "supported (the reference has no raw form either)")
    d = v.dictionary
    dev = v.data.device
    return dict_cached(kind, d, dev, lambda: {
        k: torch.from_numpy(a).to(dev)
        for k, a in build([_utf8(x) for x in d.values]).items()})


def _mm_build(values) -> dict:
    """Spark's hashUnsafeBytes block sequence of each value: its aligned
    4-byte little-endian words, then each tail byte sign-extended as a
    block of its own; (blocks, values) so a block column is contiguous."""
    rows = []
    for b in values:
        cut = len(b) - len(b) % 4
        words = [int.from_bytes(b[i:i + 4], "little")
                 for i in range(0, cut, 4)]
        words += [(t - 256 if t >= 128 else t) & _M32 for t in b[cut:]]
        rows.append(words)
    n = max(len(rows), 1)
    width = max((len(r) for r in rows), default=0)
    blocks = np.zeros((width, n), np.int64)
    for i, r in enumerate(rows):
        blocks[:len(r), i] = r
    nb = np.zeros(n, np.int64)
    nb[:len(rows)] = [len(r) for r in rows]
    blen = np.zeros(n, np.int64)
    blen[:len(values)] = [len(b) for b in values]
    return {"blocks": blocks, "nb": nb, "len": blen}


def _rows_of(ids):
    """A per-value table's lanes in row space (``ids``), or as they are
    in dictionary space (``ids`` None)."""
    if ids is None:
        return lambda a: a
    return lambda a: take_rows(a, ids)


def _string_ids(v: EvalValue, cap: int, n: int) -> torch.Tensor:
    # NULL rows may hold any id
    return v.full_data(cap).to(torch.int64).clamp(0, max(n - 1, 0))


def _per_value(v: EvalValue, seed, cap: int, t: dict, fold):
    """``fold(rows, seed)`` over the string column: once a dictionary
    value then gathered by id where the seed is a constant, else in row
    space with the rows' seeds."""
    n = t["len"].shape[0]
    ids = _string_ids(v, cap, n)
    if isinstance(seed, int):
        h = fold(_rows_of(None), torch.full((n,), seed, dtype=torch.int64,
                                               device=ids.device))
        return take_rows(h, ids)
    return fold(_rows_of(ids), seed)


def _mm_string(v: EvalValue, seed, cap: int) -> torch.Tensor:
    t = _dict_tables("murmur3", v, "hash", _mm_build)

    def fold(rows, h1):
        nb = rows(t["nb"])
        for b in range(t["blocks"].shape[0]):
            k1 = _mm_mix_k1(rows(t["blocks"][b]))
            h1 = torch.where(b < nb, _mm_mix_h1(h1, k1), h1)
        return _mm_fmix(h1, rows(t["len"]))
    return _per_value(v, seed, cap, t, fold)


def _lanes(seed, cap: int, device) -> torch.Tensor:
    if isinstance(seed, int):
        return torch.full((cap,), seed, dtype=torch.int64, device=device)
    return seed


def _mm_column(v: EvalValue, seed, cap: int) -> torch.Tensor:
    k = v.dtype.kind
    if v.dtype.is_string:
        return _mm_string(v, seed, cap)
    data = v.full_data(cap)
    seed = _lanes(seed, cap, data.device)
    if k in _INT4:
        return _mm_hash_i32(_int_bits(v, cap), seed)
    if k is T.TypeKind.REAL:
        return _mm_hash_i32(_float_bits(data.to(torch.float32)), seed)
    if k is T.TypeKind.DOUBLE:
        return _mm_hash_i64(_double_bits(data.to(torch.float64)), seed)
    if k in _INT8:
        return _mm_hash_i64(data.to(torch.int64), seed)
    raise NotImplementedError(f"spark hash over {v.dtype}")


def _chain(ctx, args, seed: int, column) -> torch.Tensor:
    """Spark's seed chain: each argument's hash seeds the next; a NULL
    passes its seed on unchanged."""
    cap = ctx.capacity
    h = seed
    for v in args:
        out = column(v, h, cap)
        if v.validity is not None:
            out = torch.where(v.full_validity(cap), out, h)
        h = out
    return _lanes(h, cap, ctx.device)


def _spark_hash_eval(ctx, out_dtype, args, seed=42):
    h = _chain(ctx, args, seed & _M32, _mm_column)
    out = torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)
    return EvalValue(out, None, T.INTEGER)


register("hash", lambda ts: T.INTEGER if ts else None, _spark_hash_eval)


# ---------------------------------------------------------------------------
# Spark's xxhash64 (XxHash64: seed 42, chained like hash)
# ---------------------------------------------------------------------------

_XP1 = _s64(0x9E3779B185EBCA87)
_XP2 = _s64(0xC2B2AE3D27D4EB4F)
_XP3 = _s64(0x165667B19E3779F9)
_XP4 = _s64(0x85EBCA77C2B2AE63)
_XP5 = _s64(0x27D4EB2F165667C5)


def _rotl64(x, r: int):
    # x * 2^r wraps like a left shift
    return (x * (1 << r)) | _srl64(x, 64 - r)


def _xx_round(acc, k):
    return _rotl64(acc + k * _XP2, 31) * _XP1


def _xx_fmix(h):
    h = h ^ _srl64(h, 33)
    h = h * _XP2
    h = h ^ _srl64(h, 29)
    h = h * _XP3
    return h ^ _srl64(h, 32)


def _xx_hash_i32(u32, seed):
    h = seed + _XP5 + 4
    h = h ^ (u32 * _XP1)
    return _xx_fmix(_rotl64(h, 23) * _XP2 + _XP3)


def _xx_hash_i64(x, seed):
    h = seed + _XP5 + 8
    h = h ^ _xx_round(0, x)
    return _xx_fmix(_rotl64(h, 27) * _XP1 + _XP4)


def _xx_build(values) -> dict:
    """XXH64's pieces of each value: its 32-byte stripes as four 8-byte
    little-endian words each, up to three tail words, an optional 4-byte
    word and up to three tail bytes; tables of (piece, value)."""
    n = max(len(values), 1)
    stripes = max((len(b) // 32 for b in values), default=0)
    t = {"stripe": np.zeros((4 * stripes, n), np.uint64),
         "tail8": np.zeros((3, n), np.uint64),
         "tail4": np.zeros(n, np.int64), "tailb": np.zeros((3, n), np.int64),
         "ns": np.zeros(n, np.int64), "n8": np.zeros(n, np.int64),
         "has4": np.zeros(n, bool), "nb": np.zeros(n, np.int64),
         "len": np.zeros(n, np.int64)}

    def word(b, i):
        return int.from_bytes(b[i:i + 8], "little")
    for i, b in enumerate(values):
        ns, rem = divmod(len(b), 32)
        t["ns"][i], t["len"][i] = ns, len(b)
        for w in range(4 * ns):
            t["stripe"][w, i] = word(b, 8 * w)
        pos = 32 * ns
        t["n8"][i] = rem // 8
        for j in range(rem // 8):
            t["tail8"][j, i] = word(b, pos)
            pos += 8
        if len(b) - pos >= 4:
            t["has4"][i] = True
            t["tail4"][i] = int.from_bytes(b[pos:pos + 4], "little")
            pos += 4
        t["nb"][i] = len(b) - pos
        for j, byte in enumerate(b[pos:]):
            t["tailb"][j, i] = byte
    t["stripe"] = t["stripe"].view(np.int64)
    t["tail8"] = t["tail8"].view(np.int64)
    return t


def _xx_string(v: EvalValue, seed, cap: int) -> torch.Tensor:
    t = _dict_tables("xxhash64", v, "xxhash64", _xx_build)

    def fold(rows, seed):
        ns = rows(t["ns"])
        acc = [seed + _XP1 + _XP2, seed + _XP2, seed, seed - _XP1]
        for s in range(t["stripe"].shape[0] // 4):
            live = s < ns
            acc = [torch.where(live, _xx_round(a, rows(t["stripe"][4 * s + j])),
                               a) for j, a in enumerate(acc)]
        merged = (_rotl64(acc[0], 1) + _rotl64(acc[1], 7)
                  + _rotl64(acc[2], 12) + _rotl64(acc[3], 18))
        for a in acc:
            merged = (merged ^ _xx_round(0, a)) * _XP1 + _XP4
        h = torch.where(ns > 0, merged, seed + _XP5) + rows(t["len"])
        n8 = rows(t["n8"])
        for j in range(3):
            nh = h ^ _xx_round(0, rows(t["tail8"][j]))
            h = torch.where(j < n8, _rotl64(nh, 27) * _XP1 + _XP4, h)
        nh = h ^ (rows(t["tail4"]) * _XP1)
        h = torch.where(rows(t["has4"]), _rotl64(nh, 23) * _XP2 + _XP3, h)
        nb = rows(t["nb"])
        for j in range(3):
            nh = _rotl64(h ^ (rows(t["tailb"][j]) * _XP5), 11) * _XP1
            h = torch.where(j < nb, nh, h)
        return _xx_fmix(h)
    return _per_value(v, seed, cap, t, fold)


def _xx_column(v: EvalValue, seed, cap: int) -> torch.Tensor:
    k = v.dtype.kind
    if v.dtype.is_string:
        return _xx_string(v, seed, cap)
    data = v.full_data(cap)
    seed = _lanes(seed, cap, data.device)
    if k in _INT4:
        return _xx_hash_i32(_int_bits(v, cap), seed)
    if k is T.TypeKind.REAL:
        return _xx_hash_i32(_float_bits(data.to(torch.float32)), seed)
    if k is T.TypeKind.DOUBLE:
        return _xx_hash_i64(_double_bits(data.to(torch.float64)), seed)
    if k in _INT8:
        return _xx_hash_i64(data.to(torch.int64), seed)
    raise NotImplementedError(f"xxhash64 over {v.dtype}")


def _spark_xxhash64_eval(ctx, out_dtype, args, seed=42):
    h = _chain(ctx, args, _s64(seed & 0xFFFFFFFFFFFFFFFF), _xx_column)
    return EvalValue(h, None, T.BIGINT)


register("xxhash64", lambda ts: T.BIGINT if ts else None,
         _spark_xxhash64_eval)


# ---------------------------------------------------------------------------
# Spark date functions and aliases (sparksql DateTimeFunctions.h)
# ---------------------------------------------------------------------------

_alias("dayofmonth", "day")
_alias("array_contains", "contains")


def _date_int_resolver(ts):
    if (len(ts) == 2 and ts[0].kind is T.TypeKind.DATE
            and ts[1].is_integral):
        return T.DATE
    return None


def _spark_date_shift(sign: int):
    def eval_fn(ctx, out_dtype, args):
        d, n = args
        out = (d.full_data(ctx.capacity).to(torch.int64)
               + sign * n.full_data(ctx.capacity).to(torch.int64))
        return EvalValue(out.to(torch.int32), merge_validity(d, n), T.DATE)
    return eval_fn


# Spark's two-argument forms sit after Presto's three-argument date_add:
# the registry tries a name's entries in order
register("date_add", _date_int_resolver, _spark_date_shift(1))
register("date_sub", _date_int_resolver, _spark_date_shift(-1))


def _unix_date_eval(ctx, out_dtype, args):
    (v,) = args
    return EvalValue(v.full_data(ctx.capacity).to(torch.int32),
                     v.validity, T.INTEGER)


register("unix_date", sig("date -> integer"), _unix_date_eval)


def _weekday_eval(ctx, out_dtype, args):
    """Spark's weekday(): 0 = Monday ... 6 = Sunday."""
    (v,) = args
    days = _date_days(v).to(torch.int64)
    return EvalValue(torch.remainder(days + 3, 7), v.validity, T.INTEGER)


register("weekday",
         lambda ts: T.INTEGER if len(ts) == 1 and ts[0].kind in _DATELIKE
         else None, _weekday_eval)


def _month_end(y, m):
    """The last day (days since the epoch) of month ``m`` of year ``y``."""
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    return _days_from_civil(ny, nm, torch.ones_like(nm)) - 1


def _last_day_eval(ctx, out_dtype, args):
    (v,) = args
    y, m, _ = _civil_from_days(_date_days(v))
    return EvalValue(_month_end(y, m).to(torch.int32), v.validity, T.DATE)


register("last_day", sig("date -> date"), _last_day_eval)


def _make_date_eval(ctx, out_dtype, args):
    y, m, d = (a.full_data(ctx.capacity).to(torch.int64) for a in args)
    return EvalValue(_days_from_civil(y, m, d).to(torch.int32),
                     merge_validity(*args), T.DATE)


register("make_date", sig("integral, integral, integral -> date"),
         _make_date_eval)


register("ascii", sig("string -> integer"),
         lambda ctx, o, a: _dict_lookup(a[0], lambda s: ord(s[0]) if s
                                        else 0, T.INTEGER, "ascii"))
register("crc32", sig("string -> bigint"),
         lambda ctx, o, a: _dict_lookup(a[0], lambda s: zlib.crc32(
             _utf8(s)), T.BIGINT, "crc32"))
register("md5", sig("string -> varchar"),
         lambda ctx, o, a: _dict_map(a[0], lambda s: hashlib.md5(
             _utf8(s)).hexdigest(), "md5"))


def _nary_minmax(pick):
    """Spark's least/greatest: n-ary, skipping NULL arguments (NULL only
    when every argument is), unlike Presto's."""
    def eval_fn(ctx, out_dtype, args):
        cap = ctx.capacity
        acc = None
        any_valid = torch.zeros((cap,), dtype=torch.bool, device=ctx.device)
        for v in args:
            d = _numeric_data(v, out_dtype).expand(cap)
            valid = v.full_validity(cap)
            if acc is None:
                acc = d
            else:
                acc = torch.where(valid & (~any_valid | pick(d, acc)), d,
                                  acc)
            any_valid = any_valid | valid
        return EvalValue(acc, any_valid, out_dtype)
    return eval_fn


def _nary_resolver(ts):
    if len(ts) >= 2 and _all_numeric(ts):
        out = ts[0]
        for t in ts[1:]:
            out = promote_numeric(out, t)
        return out
    return None


register("least_skipnull", _nary_resolver, _nary_minmax(torch.lt))
register("greatest_skipnull", _nary_resolver, _nary_minmax(torch.gt))


# ---------------------------------------------------------------------------
# Spark string functions (sparksql String.h), dictionary space
# ---------------------------------------------------------------------------

def _const_arg(args, i, fname, default=None):
    v = args[i] if len(args) > i else None
    if v is None:
        if default is None:
            raise ValueError(f"{fname}: missing argument {i}")
        return default
    if v.py_value is None:
        raise NotImplementedError(f"{fname}: argument {i} must be a "
                                  "constant")
    return v.py_value


def _initcap(s):
    return re.sub(r"(^|\s)(\S)", lambda m: m.group(1) + m.group(2).upper(),
                  s.lower())


register("initcap", sig("string -> varchar"),
         lambda ctx, o, a: _dict_map(a[0], _initcap, "initcap"))


def _pad_eval(fname: str, left: bool):
    def eval_fn(ctx, out_dtype, args):
        n = int(_const_arg(args, 1, fname))
        pad = str(_const_arg(args, 2, fname, " "))

        def f(s):
            if len(s) >= n:
                return s[:n]
            fill = (pad * n)[:n - len(s)] if pad else ""
            return fill + s if left else s + fill
        return _dict_map(args[0], f, fname)
    return eval_fn


for _name, _left in (("lpad", True), ("rpad", False)):
    register(_name, sig("string, integral, string -> varchar"),
             _pad_eval(_name, _left))
    register(_name, sig("string, integral -> varchar"),
             _pad_eval(_name, _left))


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _levenshtein_eval(ctx, out_dtype, args):
    other = str(_const_arg(args, 1, "levenshtein"))
    return _dict_lookup(args[0], lambda s: _levenshtein(s, other),
                        T.INTEGER, "levenshtein")


register("levenshtein", sig("string, string -> integer"),
         _levenshtein_eval)


def _translate_eval(ctx, out_dtype, args):
    src = str(_const_arg(args, 1, "translate"))
    dst = str(_const_arg(args, 2, "translate"))
    # Spark: characters past the end of dst are deleted
    table = {ord(c): (dst[i] if i < len(dst) else None)
             for i, c in enumerate(src)}
    return _dict_map(args[0], lambda s: s.translate(table), "translate")


register("translate", sig("string, string, string -> varchar"),
         _translate_eval)


def _locate_eval(ctx, out_dtype, args):
    sub = str(_const_arg(args, 0, "locate"))
    start = int(_const_arg(args, 2, "locate", 1))
    return _dict_lookup(
        args[1], lambda s: 0 if start < 1 else s.find(sub, start - 1) + 1,
        T.INTEGER, "locate")


register("locate", sig("string, string, integral -> integer"),
         _locate_eval)
register("locate", sig("string, string -> integer"), _locate_eval)


def _find_in_set_eval(ctx, out_dtype, args):
    lst = str(_const_arg(args, 1, "find_in_set")).split(",")

    def f(s):
        if "," in s or s not in lst:
            return 0
        return lst.index(s) + 1
    return _dict_lookup(args[0], f, T.INTEGER, "find_in_set")


register("find_in_set", sig("string, string -> integer"),
         _find_in_set_eval)


def _substring_index_eval(ctx, out_dtype, args):
    delim = str(_const_arg(args, 1, "substring_index"))
    cnt = int(_const_arg(args, 2, "substring_index"))

    def f(s):
        if cnt == 0 or not delim:
            return ""
        parts = s.split(delim)
        return delim.join(parts[:cnt] if cnt > 0 else parts[cnt:])
    return _dict_map(args[0], f, "substring_index")


register("substring_index", sig("string, string, integral -> varchar"),
         _substring_index_eval)


def _repeat_eval(ctx, out_dtype, args):
    n = int(_const_arg(args, 1, "repeat"))
    return _dict_map(args[0], lambda s: s * max(n, 0), "repeat")


register("repeat", sig("string, integral -> varchar"), _repeat_eval)


def _overlay_eval(ctx, out_dtype, args):
    repl = str(_const_arg(args, 1, "overlay"))
    pos = max(int(_const_arg(args, 2, "overlay")), 1) - 1
    ln = int(_const_arg(args, 3, "overlay", -1))
    use_len = ln if ln >= 0 else len(repl)
    return _dict_map(args[0], lambda s: s[:pos] + repl + s[pos + use_len:],
                     "overlay")


register("overlay",
         sig("string, string, integral, integral -> varchar"),
         _overlay_eval)
register("overlay", sig("string, string, integral -> varchar"),
         _overlay_eval)


_SOUNDEX_CODES = {**{c: "1" for c in "BFPV"},
                  **{c: "2" for c in "CGJKQSXZ"},
                  **{c: "3" for c in "DT"}, "L": "4",
                  **{c: "5" for c in "MN"}, "R": "6"}


def _soundex(s: str) -> str:
    if not s or not s[0].isalpha():
        return s
    u = s.upper()
    out = [u[0]]
    prev = _SOUNDEX_CODES.get(u[0], "")
    for ch in u[1:]:
        code = _SOUNDEX_CODES.get(ch, "")
        if code and code != prev:
            out.append(code)
            if len(out) == 4:
                break
        if ch not in "HW":
            prev = code
    return "".join(out).ljust(4, "0")


register("soundex", sig("string -> varchar"),
         lambda ctx, o, a: _dict_map(a[0], _soundex, "soundex"))
register("hex", sig("string -> varchar"),
         lambda ctx, o, a: _dict_map(a[0], lambda s: _utf8(s).hex().upper(),
                                     "hex"))


def _unhex(s: str):
    try:
        return bytes.fromhex(s).decode("latin-1")
    except ValueError:
        return None


register("unhex", sig("string -> varchar"),
         lambda ctx, o, a: _dict_map_nullable(a[0], _unhex, "unhex"))


# ---------------------------------------------------------------------------
# Bitwise (sparksql Bitwise.h)
# ---------------------------------------------------------------------------

def _bit_count_eval(ctx, out_dtype, args):
    """Popcount of the 64 bits (SWAR, Hacker's Delight 5-2)."""
    (v,) = args
    u = v.full_data(ctx.capacity).to(torch.int64)
    u = u - ((u >> 1) & 0x5555555555555555)
    u = (u & 0x3333333333333333) + ((u >> 2) & 0x3333333333333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F0F0F0F0F
    cnt = _srl64(u * 0x0101010101010101, 56)
    return EvalValue(cnt.to(torch.int32), v.validity, T.INTEGER)


register("bit_count", sig("integral -> integer"), _bit_count_eval)


def _bit_get_eval(ctx, out_dtype, args):
    v, p = args
    x = v.full_data(ctx.capacity).to(torch.int64)
    pos = p.full_data(ctx.capacity).to(torch.int64).clamp(0, 63)
    return EvalValue(((x >> pos) & 1).to(torch.int8), merge_validity(v, p),
                     T.TINYINT)


register("bit_get", sig("integral, integral -> tinyint"), _bit_get_eval)


_FACTORIALS = [1]
for _i in range(1, 21):
    _FACTORIALS.append(_FACTORIALS[-1] * _i)


def _factorial_eval(ctx, out_dtype, args):
    (v,) = args
    x = v.full_data(ctx.capacity).to(torch.int64)
    ok = (x >= 0) & (x <= 20)
    table = torch.tensor(_FACTORIALS, dtype=torch.int64, device=x.device)
    validity = ok if v.validity is None else v.full_validity(
        ctx.capacity) & ok
    return EvalValue(table[x.clamp(0, 20)], validity, T.BIGINT)


register("factorial", sig("integral -> bigint"), _factorial_eval)


# ---------------------------------------------------------------------------
# Spark date functions over days
# ---------------------------------------------------------------------------

_DOWS = {"MO": 0, "TU": 1, "WE": 2, "TH": 3, "FR": 4, "SA": 5, "SU": 6}


def _next_day_eval(ctx, out_dtype, args):
    want = _DOWS.get(str(_const_arg(args, 1, "next_day"))[:2].upper())
    v = args[0]
    days = _date_days(v).to(torch.int64)
    if want is None:
        return EvalValue(torch.zeros_like(days, dtype=torch.int32),
                         torch.zeros((ctx.capacity,), dtype=torch.bool,
                                     device=ctx.device), T.DATE)
    cur = torch.remainder(days + 3, 7)  # 0 = Monday
    delta = torch.remainder(want - cur - 1, 7) + 1
    return EvalValue((days + delta).to(torch.int32), v.validity, T.DATE)


register("next_day", sig("date, string -> date"), _next_day_eval)


def _months_between_eval(ctx, out_dtype, args):
    a, b = args
    da = _date_days(a).to(torch.int64)
    db = _date_days(b).to(torch.int64)
    ya, ma, ka = _civil_from_days(da)
    yb, mb, kb = _civil_from_days(db)
    whole = (ya - yb) * 12 + (ma - mb)
    # Spark: the same day of the month, or both last days, is whole
    both_last = (da == _month_end(ya, ma)) & (db == _month_end(yb, mb))
    frac = torch.where((ka == kb) | both_last,
                       torch.zeros((), dtype=torch.float64,
                                   device=da.device),
                       (ka - kb).to(torch.float64) / 31.0)
    return EvalValue(whole.to(torch.float64) + frac, merge_validity(a, b),
                     T.DOUBLE)


register("months_between", sig("date, date -> double"),
         _months_between_eval)


def _unix_timestamp_eval(ctx, out_dtype, args):
    (v,) = args
    micros = v.full_data(ctx.capacity).to(torch.int64)
    secs = torch.where(micros >= 0, _floor_div(micros, 1_000_000),
                       -_floor_div(-micros, 1_000_000))
    return EvalValue(secs, v.validity, T.BIGINT)


register("unix_timestamp", sig("timestamp -> bigint"),
         _unix_timestamp_eval)

"""Raw-string forms of the string functions and of the comparisons.

Counterpart of ``velox_tpu/functions/raw_strings.py``. The dictionary
forms in functions/scalar.py run a host pass over the distinct values,
which for a high-cardinality column is a pass over the column. This
module wraps each registered string function: when an argument is a raw
column (vector/strings.py), the function runs over the byte matrix on
the column's device; otherwise the dictionary form runs unchanged.

Unlike the reference's raw forms, ``reverse`` reverses code points and
``upper``/``lower``/the trims follow pyarrow's ``utf8_*`` kernels (the
dictionary path's mapping), so a raw column gives the answer its
dictionary encoding gives (ROADMAP C).
"""

from __future__ import annotations

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue, merge_validity
from velox_tpu_torch.functions.registry import _REGISTRY, ScalarFunction
from velox_tpu_torch.functions.scalar import dict_cached
from velox_tpu_torch.vector import strings as S
from velox_tpu_torch.vector.device import Dictionary


def is_raw_value(v) -> bool:
    return isinstance(v, EvalValue) and S.is_raw(v)


def dict_bytes(d: Dictionary, width, device):
    """The dictionary's values as a (k, W) byte matrix and lengths on
    ``device``, packed on the host once per (dictionary, width, device)
    (functions/scalar.py ``dict_cached``)."""
    def make():
        vals = list(d.values)
        b, ln = S.pack_pylist(vals, max(1, len(vals)), width)
        return (torch.from_numpy(b).to(device),
                torch.from_numpy(ln).to(device))
    return dict_cached(("bytes", width), d, device, make)


def as_raw(v: EvalValue, capacity: int, width=None, device=None):
    """(bytes2d, lens, validity) of any string value at ``capacity`` rows:
    a raw column passes through; dictionary ids gather rows of the packed
    dictionary (one device gather); a constant broadcasts."""
    if S.is_raw(v):
        return v.data, S.lens_of(v), v.validity
    if v.data is None:  # an unresolved constant
        b, ln = S.broadcast_literal(v.py_value, capacity,
                                    width or S.MIN_WIDTH, device)
        return b, ln, None
    if v.dictionary is not None:
        db, dln = dict_bytes(v.dictionary, width, v.data.device)
        ids = v.full_data(capacity).long().clamp(0, db.shape[0] - 1)
        return db[ids], dln[ids], v.validity
    raise NotImplementedError("string value without raw bytes, a "
                              "dictionary or a constant")


def _raw_arg(args) -> EvalValue:
    for a in args:
        if is_raw_value(a):
            return a
    raise AssertionError("no raw argument")


def _const_bytes(v: EvalValue, fname: str) -> bytes:
    if v.py_value is None:
        raise NotImplementedError(
            f"{fname} on raw strings requires a constant argument")
    s = v.py_value
    return s.encode() if isinstance(s, str) else bytes(s)


def _map(fn):
    """A raw -> raw form of a one-argument function of vector/strings.py."""
    def eval_fn(ctx, o, args):
        v = args[0]
        b, ln = fn(v.data, S.lens_of(v))
        return S.raw_value(b, ln, v.validity)
    return eval_fn


def _r_length(ctx, o, args):
    v = args[0]
    return EvalValue(S.length_chars(v.data, S.lens_of(v)), v.validity,
                     T.BIGINT)


def _r_substr(ctx, o, args):
    v = args[0]
    cap = v.data.shape[0]
    start = args[1].full_data(cap).to(torch.int32)
    length = (args[2].full_data(cap).to(torch.int32)
              if len(args) > 2 else None)
    b, ln = S.substr(v.data, S.lens_of(v), start, length)
    return S.raw_value(b, ln, merge_validity(*args))


def _r_like(ctx, o, args):
    v, pat = args[0], args[1]
    if pat.py_value is None:
        raise NotImplementedError("LIKE pattern must be a constant")
    esc = args[2].py_value if len(args) > 2 else None
    res = S.like(v.data, S.lens_of(v), pat.py_value, esc)
    return EvalValue(res, v.validity, T.BOOLEAN)


def _test(fn, out=T.BOOLEAN, name=""):
    """A (raw, constant) -> BOOLEAN/BIGINT form."""
    def eval_fn(ctx, o, args):
        v = args[0]
        res = fn(v.data, S.lens_of(v), _const_bytes(args[1], name))
        return EvalValue(res, merge_validity(*args), out)
    return eval_fn


def _r_contains(ctx, o, args):
    v = args[0]
    pos = S.contains_at(v.data, S.lens_of(v),
                        _const_bytes(args[1], "contains"))
    return EvalValue(pos >= 0, merge_validity(*args), T.BOOLEAN)


def _r_concat(ctx, o, args):
    first = _raw_arg(args)
    cap, dev = first.data.shape[0], first.data.device
    b, ln, validity = as_raw(args[0], cap, device=dev)
    for a in args[1:]:
        b2, ln2, val2 = as_raw(a, cap, device=dev)
        b, ln = S.concat(b, ln, b2, ln2)
        if val2 is not None:
            validity = val2 if validity is None else validity & val2
    return S.raw_value(b, ln, validity)


def raw_compare(a: EvalValue, b: EvalValue, op: str) -> EvalValue:
    """A comparison where at least one side is a raw string column; a
    dictionary or constant side converts to bytes (``as_raw``)."""
    raw = a if S.is_raw(a) else b
    cap, dev = raw.data.shape[0], raw.data.device
    ab, al, _ = as_raw(a, cap, device=dev)
    bb, bl, _ = as_raw(b, cap, device=dev)
    if op in ("eq", "neq"):
        res = S.equal(ab, al, bb, bl)
        if op == "neq":
            res = ~res
    elif op in ("lt", "lte"):
        res = S.less(ab, al, bb, bl, or_equal=(op == "lte"))
    else:  # gt / gte as the swapped form
        res = S.less(bb, bl, ab, al, or_equal=(op == "gte"))
    return EvalValue(res, merge_validity(a, b), T.BOOLEAN)


_RAW_EVALS = {
    "lower": _map(S.lower), "upper": _map(S.upper), "length": _r_length,
    "trim": _map(S.trim), "ltrim": _map(S.ltrim), "rtrim": _map(S.rtrim),
    "reverse": _map(S.reverse), "substr": _r_substr,
    "substring": _r_substr, "like": _r_like,
    "starts_with": _test(S.starts_with, name="starts_with"),
    "ends_with": _test(S.ends_with, name="ends_with"),
    "strpos": _test(S.strpos_chars, T.BIGINT, "strpos"),
    "contains": _r_contains, "concat": _r_concat,
}


def _wrap(name: str, raw_eval):
    """Give each registered entry of ``name`` the raw dispatch; a name the
    port does not register stays unregistered, as in the reference."""
    ents = _REGISTRY.get(name)
    if not ents:
        return
    wrapped = []
    for e in ents:
        def eval_fn(ctx, o, args, _orig=e.eval_fn, _raw=raw_eval):
            if any(is_raw_value(a) for a in args):
                return _raw(ctx, o, args)
            return _orig(ctx, o, args)
        wrapped.append(ScalarFunction(e.name, e.resolver, eval_fn))
    _REGISTRY[name] = wrapped


for _n, _f in _RAW_EVALS.items():
    _wrap(_n, _f)

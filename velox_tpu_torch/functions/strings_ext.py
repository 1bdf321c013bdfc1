"""Regex, JSON, URL and more string functions, in dictionary space.

Counterpart of ``velox_tpu/functions/strings_ext.py`` (velox/functions/lib
Re2Functions, prestosql JsonFunctions and URLFunctions.h): every function
computes once per distinct dictionary value on the host and becomes a new
dictionary (string results, remapped by one device gather) or a lookup
table gathered by id (scalar results). A function may give NULL for a
value (no match, invalid JSON or URL); those rows are NULL.

``regexp_like``, ``regexp_replace``, ``strpos``, ``replace``,
``starts_with`` and ``ends_with`` run pyarrow's kernels over the values
(RE2, the reference's engine) and fall back to Python where pyarrow
rejects the pattern, as the reference does. ``strpos``, ``replace``,
``starts_with`` and ``ends_with`` are second overloads: functions/
scalar.py registered the first, which the registry resolves to, as in the
reference.
"""

from __future__ import annotations

import json as _json
import re
from urllib.parse import parse_qs, quote_plus, unquote_plus, urlsplit

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.functions.registry import register
from velox_tpu_torch.functions.scalar import (
    _dict_lookup, _dict_lookup_pa, _dict_map, _dict_map_nullable,
    _dict_map_pa, _str_resolver,
)


def _const_str(arg: EvalValue, fname: str) -> str:
    if arg.py_value is None:
        raise NotImplementedError(f"{fname}: argument must be a constant")
    return arg.py_value


_VARCHAR_OF_STRING = _str_resolver(T.VARCHAR)

# ---------------------------------------------------------------------------
# Regex (Re2Functions)
# ---------------------------------------------------------------------------


def _regexp_like_eval(ctx, out_dtype, args):
    pat = _const_str(args[1], "regexp_like")
    rx = re.compile(pat)
    return _dict_lookup_pa(
        args[0], lambda pc, src: pc.match_substring_regex(src, pat),
        lambda s: rx.search(s) is not None, T.BOOLEAN, "regexp_like")


register("regexp_like", _str_resolver(T.BOOLEAN), _regexp_like_eval)


def _regexp_extract_eval(ctx, out_dtype, args):
    rx = re.compile(_const_str(args[1], "regexp_extract"))
    group = int(args[2].py_value) if len(args) > 2 else 0

    def f(s):
        m = rx.search(s)
        return m.group(group) if m else None
    return _dict_map_nullable(args[0], f, "regexp_extract")


register("regexp_extract", _VARCHAR_OF_STRING, _regexp_extract_eval)


def _regexp_replace_eval(ctx, out_dtype, args):
    pat = _const_str(args[1], "regexp_replace")
    rx = re.compile(pat)
    repl = _const_str(args[2], "regexp_replace") if len(args) > 2 else ""
    # Presto's $1 group references are \1 to Python and RE2
    repl = re.sub(r"\$(\d+)", r"\\\1", repl)
    return _dict_map_pa(args[0], lambda pc, src: pc.replace_substring_regex(
        src, pattern=pat, replacement=repl), lambda s: rx.sub(repl, s),
        "regexp_replace")


register("regexp_replace", _VARCHAR_OF_STRING, _regexp_replace_eval)


# ---------------------------------------------------------------------------
# JSON (JsonFunctions; the JSONPath subset $.a.b[0])
# ---------------------------------------------------------------------------

def _json_walk(doc, path: str):
    if not path.startswith("$"):
        return None
    cur = doc
    for name, idx in re.findall(r"\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]",
                                path[1:]):
        try:
            cur = cur[name] if name else cur[int(idx)]
        except (KeyError, IndexError, TypeError):
            return None
    return cur


def _loads(s: str):
    """The parsed document, or None where ``s`` is not JSON (a JSON null
    is None as well; the callers treat both alike)."""
    try:
        return _json.loads(s)
    except ValueError:
        return None


def _dumps(v) -> str:
    return _json.dumps(v, separators=(",", ":"))


def _at_path(s: str, path: str):
    try:
        return _json_walk(_json.loads(s), path)
    except ValueError:
        return None


def _json_extract_scalar_eval(ctx, out_dtype, args):
    path = _const_str(args[1], "json_extract_scalar")

    def f(s):
        v = _at_path(s, path)
        if v is None or isinstance(v, (dict, list)):
            return None
        if isinstance(v, bool):
            return "true" if v else "false"
        return str(v)
    return _dict_map_nullable(args[0], f, "json_extract_scalar")


register("json_extract_scalar", _VARCHAR_OF_STRING,
         _json_extract_scalar_eval)


def _json_extract_eval(ctx, out_dtype, args):
    path = _const_str(args[1], "json_extract")

    def f(s):
        v = _at_path(s, path)
        return None if v is None else _dumps(v)
    return _dict_map_nullable(args[0], f, "json_extract")


register("json_extract", _VARCHAR_OF_STRING, _json_extract_eval)


def _json_array_length(s: str):
    v = _loads(s)
    return len(v) if isinstance(v, list) else None


register("json_array_length", _str_resolver(T.BIGINT),
         lambda ctx, o, a: _dict_lookup(a[0], _json_array_length, T.BIGINT,
                                        "json_array_length"))


def _is_json_scalar(s: str) -> bool:
    try:
        return not isinstance(_json.loads(s), (dict, list))
    except ValueError:
        return False


register("is_json_scalar", _str_resolver(T.BOOLEAN),
         lambda ctx, o, a: _dict_lookup(a[0], _is_json_scalar, T.BOOLEAN,
                                        "is_json_scalar"))


def _json_array_contains_eval(ctx, out_dtype, args):
    """json_array_contains(json, value): the value a constant scalar;
    NULL where the document is not an array."""
    v = args[1]
    want = v.py_value
    if want is None:
        raise NotImplementedError(
            "json_array_contains: value must be a constant")
    if v.dtype.kind is T.TypeKind.DECIMAL:
        want = float(want) / 10.0 ** v.dtype.scale

    def f(s):
        arr = _loads(s)
        if not isinstance(arr, list):
            return None
        for x in arr:
            if isinstance(want, bool) or isinstance(x, bool):
                if x is want:
                    return True
            elif isinstance(want, (int, float)) \
                    and isinstance(x, (int, float)):
                if float(x) == float(want):
                    return True
            elif x == want:
                return True
        return False
    return _dict_lookup(args[0], f, T.BOOLEAN, "json_array_contains")


register("json_array_contains",
         lambda ts: T.BOOLEAN if len(ts) == 2 and ts[0].is_string
         else None, _json_array_contains_eval)


def _json_array_get_eval(ctx, out_dtype, args):
    """json_array_get(json, index): a negative index counts from the end;
    out of range or not an array is NULL; the element as canonical JSON."""
    if args[1].py_value is None:
        raise NotImplementedError(
            "json_array_get: index must be a constant")
    idx = int(args[1].py_value)

    def f(s):
        arr = _loads(s)
        if not isinstance(arr, list):
            return None
        i = idx if idx >= 0 else len(arr) + idx
        return _dumps(arr[i]) if 0 <= i < len(arr) else None
    return _dict_map_nullable(args[0], f, "json_array_get")


register("json_array_get",
         lambda ts: T.VARCHAR if len(ts) == 2 and ts[0].is_string
         else None, _json_array_get_eval)


def _json_parse_eval(ctx, out_dtype, args):
    """json_parse: validates and canonicalizes (JSON is VARCHAR text
    here); invalid input raises a user error, as in the reference."""
    def f(s):
        try:
            return _dumps(_json.loads(s))
        except ValueError:
            from velox_tpu_torch.common.errors import VeloxUserError
            raise VeloxUserError(
                f"json_parse: invalid JSON: {s[:80]!r}") from None
    return _dict_map(args[0], f, "json_parse")


register("json_parse", _str_resolver(T.VARCHAR), _json_parse_eval)


def _json_format(s: str):
    try:
        return _dumps(_json.loads(s))
    except ValueError:
        return None


register("json_format", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_nullable(a[0], _json_format,
                                              "json_format"))


def _json_size_eval(ctx, out_dtype, args):
    """json_size(json, path): the member count of the object or array at
    the path (a scalar: 0); NULL where the path misses."""
    path = _const_str(args[1], "json_size")

    def f(s):
        v = _at_path(s, path)
        if v is None:
            return None
        return len(v) if isinstance(v, (dict, list)) else 0
    return _dict_lookup(args[0], f, T.BIGINT, "json_size")


register("json_size",
         lambda ts: T.BIGINT if len(ts) == 2 and ts[0].is_string
         else None, _json_size_eval)


# ---------------------------------------------------------------------------
# URL functions (URLFunctions.h)
# ---------------------------------------------------------------------------

def _url_part(which: str):
    def f(s):
        try:
            u = urlsplit(s)
        except ValueError:
            return None
        if which == "host":
            return u.hostname or None
        if which == "protocol":
            return u.scheme or None
        return getattr(u, which)
    return f


for _name, _part in (("url_extract_host", "host"),
                     ("url_extract_protocol", "protocol"),
                     ("url_extract_path", "path"),
                     ("url_extract_query", "query"),
                     ("url_extract_fragment", "fragment")):
    register(_name, _VARCHAR_OF_STRING,
             lambda ctx, o, a, _p=_part, _n=_name:
             _dict_map_nullable(a[0], _url_part(_p), _n))


def _url_port(s: str):
    try:
        return urlsplit(s).port
    except ValueError:
        return None


register("url_extract_port", _str_resolver(T.BIGINT),
         lambda ctx, o, a: _dict_lookup(a[0], _url_port, T.BIGINT,
                                        "url_extract_port"))


def _url_param_eval(ctx, out_dtype, args):
    name = _const_str(args[1], "url_extract_parameter")

    def f(s):
        try:
            q = parse_qs(urlsplit(s).query, keep_blank_values=True)
        except ValueError:
            return None
        vals = q.get(name)
        return vals[0] if vals else None
    return _dict_map_nullable(args[0], f, "url_extract_parameter")


register("url_extract_parameter", _VARCHAR_OF_STRING, _url_param_eval)
register("url_encode", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map(a[0], quote_plus, "url_encode"))
register("url_decode", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map(a[0], unquote_plus, "url_decode"))


# ---------------------------------------------------------------------------
# More Presto string functions (second overloads, see above)
# ---------------------------------------------------------------------------

def _strpos_eval(ctx, out_dtype, args):
    sub = _const_str(args[1], "strpos")
    return _dict_lookup_pa(
        args[0], lambda pc, src: pc.add(pc.find_substring(src, sub), 1),
        lambda s: s.find(sub) + 1, T.BIGINT, "strpos")


register("strpos", _str_resolver(T.BIGINT), _strpos_eval)


def _replace_eval(ctx, out_dtype, args):
    a = _const_str(args[1], "replace")
    b = _const_str(args[2], "replace") if len(args) > 2 else ""
    return _dict_map_pa(args[0], lambda pc, src: pc.replace_substring(
        src, pattern=a, replacement=b), lambda s: s.replace(a, b), "replace")


register("replace", _VARCHAR_OF_STRING, _replace_eval)


def _affix_eval(fname: str, pa_name: str, py_name: str):
    def eval_fn(ctx, out_dtype, args):
        p = _const_str(args[1], fname)
        return _dict_lookup_pa(
            args[0], lambda pc, src: getattr(pc, pa_name)(src, p),
            lambda s: getattr(s, py_name)(p), T.BOOLEAN, fname)
    return eval_fn


register("starts_with", _str_resolver(T.BOOLEAN),
         _affix_eval("starts_with", "starts_with", "startswith"))
register("ends_with", _str_resolver(T.BOOLEAN),
         _affix_eval("ends_with", "ends_with", "endswith"))


def _split_part_eval(ctx, out_dtype, args):
    delim = _const_str(args[1], "split_part")
    index = int(args[2].py_value)

    def f(s):
        parts = s.split(delim)
        return parts[index - 1] if 1 <= index <= len(parts) else None
    return _dict_map_nullable(args[0], f, "split_part")


register("split_part", _VARCHAR_OF_STRING, _split_part_eval)

"""Generic function-signature DSL with type variables.

Role parity: ``velox/expression/FunctionSignature.h`` +
``SignatureBinder.cpp`` — the reference declares signatures like
``array(T), T -> boolean`` and binds concrete types by unifying the
type variables. Here ``sig("array(T), T -> boolean")`` parses once into
a matcher usable as a registry resolver, replacing ad-hoc per-name
resolver lambdas:

    register("array_contains", sig("array(T), T -> boolean"), eval_fn)

Supported atoms: concrete type names (bigint, integer, double, varchar,
boolean, date, timestamp, real, varbinary, unknown, json-as-varchar),
pseudo-kinds ``any`` / ``numeric`` / ``integral`` / ``string`` /
``orderable``, ``decimal(p,s)`` with numeric variables, and constructors
``array(X)`` / ``map(K,V)`` / ``row(...)``. Single capital letters are
type variables; repeated variables must unify to equal types. Trailing
``...`` marks the last parameter variadic.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from velox_tpu_torch import types as T

_CONCRETE = {
    "boolean": T.BOOLEAN, "tinyint": T.TINYINT, "smallint": T.SMALLINT,
    "integer": T.INTEGER, "int": T.INTEGER, "bigint": T.BIGINT,
    "real": T.REAL, "double": T.DOUBLE, "varchar": T.VARCHAR,
    "varbinary": T.VARBINARY, "date": T.DATE, "timestamp": T.TIMESTAMP,
    "unknown": T.UNKNOWN, "json": T.VARCHAR, "hugeint": T.HUGEINT,
}

_PSEUDO = {
    "any": lambda t: True,
    "numeric": lambda t: t.is_numeric,
    "integral": lambda t: t.is_integral,
    "string": lambda t: t.is_string,
    "orderable": lambda t: not t.is_complex,
    "complex": lambda t: t.is_complex,
}


class _Node:
    __slots__ = ("kind", "name", "children")

    def __init__(self, kind, name=None, children=()):
        self.kind = kind      # concrete | pseudo | var | ctor | decimal
        self.name = name
        self.children = list(children)


def _parse_type(s: str, pos: int):
    m = re.match(r"\s*([A-Za-z_][A-Za-z0-9_]*)", s[pos:])
    if not m:
        raise ValueError(f"bad signature near {s[pos:]!r}")
    word = m.group(1)
    pos += m.end()
    low = word.lower()
    if pos < len(s) and s[pos] == "(":
        if low == "decimal":
            m2 = re.match(r"\(\s*([A-Za-z0-9_]+)\s*,\s*([A-Za-z0-9_]+)"
                          r"\s*\)", s[pos:])
            if not m2:
                raise ValueError(f"bad decimal spec in {s!r}")
            node = _Node("decimal", None, [m2.group(1), m2.group(2)])
            return node, pos + m2.end()
        if low in ("array", "map", "row"):
            children = []
            pos += 1  # consume '('
            while True:
                child, pos = _parse_type(s, pos)
                children.append(child)
                m3 = re.match(r"\s*([,)])", s[pos:])
                if not m3:
                    raise ValueError(f"bad signature near {s[pos:]!r}")
                pos += m3.end()
                if m3.group(1) == ")":
                    break
            return _Node("ctor", low, children), pos
        raise ValueError(f"unknown constructor {word!r}")
    if low in _CONCRETE:
        return _Node("concrete", low), pos
    if low in _PSEUDO:
        return _Node("pseudo", low), pos
    if re.fullmatch(r"[A-Z][0-9]?", word):
        return _Node("var", word), pos
    raise ValueError(f"unknown type {word!r} in signature")


def _match(node: _Node, t: T.DataType, binds: Dict) -> bool:
    if node.kind == "concrete":
        want = _CONCRETE[node.name]
        if node.name == "decimal":
            return t.kind is T.TypeKind.DECIMAL
        return t.kind is want.kind
    if node.kind == "pseudo":
        return _PSEUDO[node.name](t)
    if node.kind == "var":
        bound = binds.get(node.name)
        if bound is None:
            binds[node.name] = t
            return True
        return bound == t
    if node.kind == "decimal":
        if t.kind is not T.TypeKind.DECIMAL:
            return False
        for spec, actual in zip(node.children,
                                (t.precision, t.scale)):
            if spec.isdigit():
                if int(spec) != actual:
                    return False
            else:
                bound = binds.get(spec)
                if bound is None:
                    binds[spec] = actual
                elif bound != actual:
                    return False
        return True
    if node.kind == "ctor":
        kinds = {"array": T.TypeKind.ARRAY, "map": T.TypeKind.MAP,
                 "row": T.TypeKind.ROW}
        if t.kind is not kinds[node.name]:
            return False
        if node.name == "row" and len(node.children) != len(t.children):
            return False
        return all(_match(c, ct, binds)
                   for c, ct in zip(node.children, t.children))
    raise AssertionError(node.kind)


def _resolve(node: _Node, binds: Dict) -> Optional[T.DataType]:
    if node.kind == "concrete":
        return _CONCRETE[node.name]
    if node.kind == "pseudo":
        raise ValueError(
            f"pseudo-kind {node.name!r} cannot be a return type")
    if node.kind == "var":
        return binds.get(node.name)
    if node.kind == "decimal":
        def val(spec):
            return int(spec) if spec.isdigit() else binds[spec]
        return T.decimal(min(38, val(node.children[0])),
                         val(node.children[1]))
    if node.kind == "ctor":
        kids = [_resolve(c, binds) for c in node.children]
        if any(k is None for k in kids):
            return None
        if node.name == "array":
            return T.array(kids[0])
        if node.name == "map":
            return T.map_(kids[0], kids[1])
        return T.row([f"f{i}" for i in range(len(kids))], kids)
    raise AssertionError(node.kind)


class Signature:
    """Parsed signature; callable as a registry resolver."""

    def __init__(self, spec: str):
        self.spec = spec
        params_s, _, ret_s = spec.partition("->")
        if not ret_s:
            raise ValueError(f"signature {spec!r} missing '->'")
        self.variadic = params_s.rstrip().endswith("...")
        if self.variadic:
            params_s = params_s.rstrip().rstrip(".")
        self.params: List[_Node] = []
        pos = 0
        s = params_s.strip()
        while pos < len(s):
            node, pos = _parse_type(s, pos)
            self.params.append(node)
            m = re.match(r"\s*,", s[pos:])
            if m:
                pos += m.end()
            else:
                break
        self.ret, _ = _parse_type(ret_s.strip(), 0)

    def __call__(self, arg_types) -> Optional[T.DataType]:
        n = len(self.params)
        if self.variadic:
            if len(arg_types) < n:
                return None
            padded = self.params[:-1] + [self.params[-1]] * (
                len(arg_types) - n + 1)
        else:
            if len(arg_types) != n:
                return None
            padded = self.params
        binds: Dict = {}
        for node, t in zip(padded, arg_types):
            if not _match(node, t, binds):
                return None
        try:
            return _resolve(self.ret, binds)
        except (KeyError, ValueError):
            return None


def sig(spec: str) -> Signature:
    """Parse a signature string into a registry resolver."""
    return Signature(spec)

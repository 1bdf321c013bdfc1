"""Typed logical expression trees.

Role parity: ``velox/core/Expressions.h`` / ``velox/core/ITypedExpr.h``
(FieldAccessTypedExpr, ConstantTypedExpr, CallTypedExpr, CastTypedExpr).
These are the *logical* form handed to the expression compiler
(velox_tpu/expression/eval.py), which traces them into one jitted program per
plan — the analogue of ExprCompiler -> ExprSet (velox/expression/ExprCompiler.cpp)
except that XLA, not a hand-rolled interpreter, does CSE/fusion/constant folding.

All nodes are frozen/hashable so identical subtrees dedupe naturally and can
serve as jit-static metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

from velox_tpu_torch import types as T


@dataclass(frozen=True)
class TypedExpr:
    dtype: T.DataType

    @property
    def children(self) -> Tuple["TypedExpr", ...]:
        return ()


@dataclass(frozen=True)
class FieldAccess(TypedExpr):
    """Reference to an input column by name."""
    name: str = ""

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class Constant(TypedExpr):
    """A literal. value=None is a typed NULL. Hashable: scalars only."""
    value: Any = None

    def __str__(self):
        if self.value is None:
            return f"null::{self.dtype}"
        if isinstance(self.value, str):
            return repr(self.value)
        return str(self.value)


@dataclass(frozen=True)
class Call(TypedExpr):
    """Function call, including special forms (and/or/not/if/switch/
    coalesce/in/between/is_null/try)."""
    name: str = ""
    args: Tuple[TypedExpr, ...] = ()

    @property
    def children(self):
        return self.args

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


@dataclass(frozen=True)
class Lambda(TypedExpr):
    """A lambda passed to a higher-order function (transform/filter/...).
    Parity: velox core LambdaTypedExpr (expression/LambdaExpr.cpp). dtype
    is the BODY's result type; params bind element-space columns during
    evaluation (functions/complex.py)."""
    params: Tuple[str, ...] = ()
    body: TypedExpr = None

    @property
    def children(self):
        return (self.body,)


@dataclass(frozen=True)
class Cast(TypedExpr):
    child: TypedExpr = None
    # try_cast returns null instead of raising on conversion failure.
    is_try: bool = False

    @property
    def children(self):
        return (self.child,)

    def __str__(self):
        return f"cast({self.child} as {self.dtype})"


# Convenience constructors -------------------------------------------------

def field(name: str, dtype: T.DataType) -> FieldAccess:
    return FieldAccess(dtype, name)


def lit(value: Any, dtype: Optional[T.DataType] = None) -> Constant:
    if dtype is None:
        if isinstance(value, bool):
            dtype = T.BOOLEAN
        elif isinstance(value, int):
            dtype = T.BIGINT
        elif isinstance(value, float):
            dtype = T.DOUBLE
        elif isinstance(value, str):
            dtype = T.VARCHAR
        elif value is None:
            dtype = T.UNKNOWN
        else:
            raise TypeError(f"cannot infer literal type for {value!r}")
    return Constant(dtype, value)


def call(name: str, *args: TypedExpr, dtype: Optional[T.DataType] = None) -> Call:
    """Build a Call; resolves the return type via the function registry when
    not supplied."""
    if dtype is None:
        from velox_tpu_torch.functions.registry import resolve_return_type
        dtype = resolve_return_type(name, [a.dtype for a in args])
    return Call(dtype, name, tuple(args))


def referenced_fields(expr: TypedExpr) -> set:
    """Names of every input column referenced under ``expr``."""
    out = set()
    stack = [expr]
    while stack:
        e = stack.pop()
        if isinstance(e, FieldAccess):
            out.add(e.name)
        stack.extend(e.children)
    return out

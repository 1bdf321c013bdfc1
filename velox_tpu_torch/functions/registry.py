"""Scalar function registry.

Counterpart of ``velox_tpu/functions/registry.py``. A function is
registered as (name, type_resolver, eval_fn):
  type_resolver(arg_types) -> DataType or None (None = signature mismatch)
  eval_fn(ctx, out_dtype, args: list[EvalValue]) -> EvalValue

Every scalar function and special form of the reference is registered:
functions/__init__.py imports the modules in the reference's order, so a
name with several overloads resolves to the same one in both packages.
Remote functions (functions/remote.py) are added at run time. An unknown
name raises NotImplementedError naming it, both when a plan is built
(return-type resolution) and when it is evaluated.
"""

from __future__ import annotations

from typing import Dict, List

from velox_tpu_torch import types as T

_REGISTRY: Dict[str, List["ScalarFunction"]] = {}


class ScalarFunction:
    def __init__(self, name: str, resolver, eval_fn):
        self.name = name
        self.resolver = resolver
        self.eval_fn = eval_fn

    def eval(self, ctx, out_dtype, args):
        return self.eval_fn(ctx, out_dtype, args)


def register(name: str, resolver, eval_fn, *, overwrite: bool = False):
    """Add an overload of ``name``; ``overwrite`` drops its earlier ones
    first (and those of every alias sharing its list)."""
    fns = _REGISTRY.setdefault(name, [])
    if overwrite:
        fns.clear()
    fns.append(ScalarFunction(name, resolver, eval_fn))


def scalar(name: str, resolver):
    """Decorator: ``@scalar("plus", numeric_resolver)`` registers the
    function it decorates as an overload of ``name``."""
    def deco(fn):
        register(name, resolver, fn)
        return fn
    return deco


def _not_ported(name: str, arg_types) -> NotImplementedError:
    return NotImplementedError(
        f"function {name}({', '.join(map(str, arg_types))}) is not ported "
        f"to velox_tpu_torch (ported: {sorted(_REGISTRY)})")


def lookup(name: str, arg_types) -> ScalarFunction:
    from velox_tpu_torch.functions import scalar as _impls  # noqa: F401
    for fn in _REGISTRY.get(name, ()):
        if fn.resolver(arg_types) is not None:
            return fn
    raise _not_ported(name, arg_types)


def resolve_return_type(name: str, arg_types) -> T.DataType:
    from velox_tpu_torch.functions import scalar as _impls  # noqa: F401
    for fn in _REGISTRY.get(name, ()):
        rt = fn.resolver(arg_types)
        if rt is not None:
            return rt
    # special forms resolve here too (they bypass the registry at eval)
    if name in ("and", "or", "not", "is_null", "is_not_null", "in",
                "between", "isnull", "isnotnull"):
        return T.BOOLEAN
    if name in ("if", "coalesce", "switch", "try", "nvl", "ifnull"):
        for a in arg_types[1:] if name == "if" else arg_types:
            if a.kind is not T.TypeKind.UNKNOWN:
                return a
        return T.UNKNOWN
    raise _not_ported(name, arg_types)


def function_names() -> List[str]:
    """Every registered scalar function name, aliases included, sorted."""
    from velox_tpu_torch.functions import scalar as _impls  # noqa: F401
    return sorted(_REGISTRY)

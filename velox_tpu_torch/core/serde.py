"""Plan tree <-> JSON serialization.

A copy of ``velox_tpu/core/serde.py`` whose class registry holds the
port's plan, expression and window classes. Role parity: the reference's
PlanNode ISerializable JSON serde (``velox/core/PlanNode.h``
``serialize()``/``create()`` used by Prestissimo to ship plan fragments) —
a host engine can persist or transmit a plan and reconstruct it
bit-identically (frozen-dataclass equality holds across the round trip).

Format: ``{"_k": <class name>, <field>: <value>, ...}`` recursively;
enums by value, DataType by its canonical string, pyarrow payloads
(ValuesNode tables) as base64 Arrow IPC.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
from typing import Any

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P


def _class_registry():
    reg = {}
    for mod in (P, ex):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and dataclasses.is_dataclass(obj):
                reg[name] = obj
    from velox_tpu_torch.exec import window as W
    for name in ("WindowFunctionCall", "WindowFrame"):
        obj = getattr(W, name, None)
        if obj is not None and dataclasses.is_dataclass(obj):
            reg[name] = obj
    return reg


_ENUMS = {}
for _m in (P,):
    for _n in dir(_m):
        _o = getattr(_m, _n)
        if isinstance(_o, type) and issubclass(_o, enum.Enum) \
                and _o is not enum.Enum:
            _ENUMS[_n] = _o


def _enc(v: Any) -> Any:
    import pyarrow as pa
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, enum.Enum):
        return {"_e": type(v).__name__, "v": v.value}
    if isinstance(v, T.DataType):
        return {"_t": str(v)}
    if isinstance(v, pa.Table):
        import io
        buf = io.BytesIO()
        with pa.ipc.new_stream(buf, v.schema) as w:
            w.write_table(v)
        return {"_arrow": base64.b64encode(buf.getvalue()).decode()}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        out = {"_k": type(v).__name__}
        for f in dataclasses.fields(v):
            out[f.name] = _enc(getattr(v, f.name))
        return out
    if isinstance(v, (tuple, list)):
        return [_enc(x) for x in v]
    raise TypeError(f"cannot serialize {type(v).__name__}: {v!r}")


def _dec(v: Any, reg) -> Any:
    import pyarrow as pa
    if isinstance(v, list):
        return tuple(_dec(x, reg) for x in v)
    if isinstance(v, dict):
        if "_e" in v:
            return _ENUMS[v["_e"]](v["v"])
        if "_t" in v:
            return T.parse_type(v["_t"])
        if "_arrow" in v:
            data = base64.b64decode(v["_arrow"])
            return pa.ipc.open_stream(data).read_all()
        cls = reg[v["_k"]]
        kwargs = {k: _dec(x, reg) for k, x in v.items() if k != "_k"}
        return cls(**kwargs)
    return v


def plan_to_json(node: P.PlanNode) -> str:
    """Serialize a plan tree (or expression tree) to a JSON string."""
    return json.dumps(_enc(node))


def plan_from_json(text: str) -> P.PlanNode:
    """Reconstruct a plan tree from plan_to_json output."""
    return _dec(json.loads(text), _class_registry())

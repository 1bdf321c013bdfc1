"""Remote scalar functions: a UDF evaluated by another process.

Counterpart of ``velox_tpu/functions/remote.py`` (velox/functions/remote:
RemoteVectorFunction serializes a batch, ships it to a function server and
deserializes the result column). The reference leaves its compiled program
through a host callback; in eager torch the call is an explicit round
trip: the argument columns and their joint validity are copied to the
host, framed as one Arrow IPC stream, sent through the transport, and the
returned ``result`` and ``valid`` columns are copied to the query's device.
Argument and result types are numeric or boolean; strings and complex
types are rejected at registration, as in the reference.

A transport implements ``send(fn_name, payload: bytes) -> bytes``.
``LoopbackTransport`` is an in-process function server (the reference's
local test server) that runs the whole wire path.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Callable, Dict, List

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.functions.registry import register


def _ipc_bytes(table) -> bytes:
    import pyarrow as pa
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    return sink.getvalue()


class RemoteTransport:
    def send(self, fn_name: str, payload: bytes) -> bytes:
        raise NotImplementedError


class LoopbackTransport(RemoteTransport):
    """In-process function server: reads the request stream, applies a
    served numpy callable, writes the response stream."""

    def __init__(self):
        self._fns: Dict[str, Callable] = {}

    def serve(self, name: str, fn: Callable) -> None:
        """fn(*cols: np.ndarray, valid: np.ndarray) ->
        (np.ndarray, np.ndarray)."""
        self._fns[name] = fn

    def send(self, fn_name: str, payload: bytes) -> bytes:
        import pyarrow as pa
        table = pa.ipc.open_stream(payload).read_all()
        ncols = table.num_columns - 1
        cols = [np.asarray(table.column(i)) for i in range(ncols)]
        out, out_valid = self._fns[fn_name](
            *cols, valid=np.asarray(table.column(ncols)))
        return _ipc_bytes(pa.table({"result": pa.array(np.asarray(out)),
                                    "valid": pa.array(np.asarray(
                                        out_valid))}))


@dataclass
class _RemoteSpec:
    name: str
    arg_types: List[T.DataType]
    result_type: T.DataType
    transport: RemoteTransport


def _call(spec: _RemoteSpec, cols: List[np.ndarray],
          valid: np.ndarray):
    """One round trip: (result, valid) numpy arrays."""
    import pyarrow as pa
    request = pa.table({**{f"a{i}": pa.array(c) for i, c in enumerate(cols)},
                        "valid": pa.array(valid)})
    reply = pa.ipc.open_stream(
        spec.transport.send(spec.name, _ipc_bytes(request))).read_all()
    return (reply.column("result").to_numpy().astype(
                spec.result_type.np_dtype(), copy=True),
            reply.column("valid").to_numpy().astype(np.bool_, copy=True))


def register_remote_function(name: str, arg_types, result_type,
                             transport: RemoteTransport) -> None:
    """Register a scalar function evaluated through ``transport``
    (velox's registerRemoteFunction)."""
    arg_types = list(arg_types)
    for t in arg_types + [result_type]:
        if t.is_string or t.is_complex:
            raise NotImplementedError(
                "remote functions: numeric/bool argument and result "
                "types only")
    spec = _RemoteSpec(name, arg_types, result_type, transport)

    def eval_fn(ctx, out_dtype, args, _spec=spec):
        cap = ctx.capacity
        valid = torch.ones((cap,), dtype=torch.bool, device=ctx.device)
        for v in args:
            if v.validity is not None:
                valid = valid & v.full_validity(cap)
        cols = [v.full_data(cap).cpu().numpy() for v in args]
        data, out_valid = _call(_spec, cols, valid.cpu().numpy())
        return EvalValue(torch.from_numpy(data).to(ctx.device),
                         torch.from_numpy(out_valid).to(ctx.device),
                         _spec.result_type)

    def resolver(ts, _spec=spec):
        return _spec.result_type if len(ts) == len(_spec.arg_types) else None

    register(name, resolver, eval_fn)

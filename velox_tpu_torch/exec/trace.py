"""Query tracing: record operator inputs and the plan for offline replay.

Counterpart of ``velox_tpu/exec/trace.py`` (velox/exec/QueryTraceConfig.h:30,
QueryDataWriter.h:30, QueryTraceScan.h and the replay tool
tool/trace/QueryReplayer.cpp). A traced operator's input batches are
copied to the host and kept as Arrow IPC files, one directory per traced
plan node; the plan as a text summary and a pickle. ``replay_operator``
re-runs one node over its recorded inputs in a fresh Task on the device
the caller names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Optional

from velox_tpu_torch.core import plan as P
from velox_tpu_torch.vector.device import DeviceBatch, to_arrow


class TraceWriter:
    """Records the input batches of one operator (plan node)."""

    def __init__(self, trace_dir: str, node_id: str):
        self.dir = os.path.join(trace_dir, f"node-{node_id}")
        os.makedirs(self.dir, exist_ok=True)
        self._n = 0

    def record(self, batch: DeviceBatch) -> None:
        import pyarrow as pa
        t = to_arrow(batch)
        path = os.path.join(self.dir, f"input-{self._n:05d}.arrow")
        with pa.OSFile(path, "wb") as f:
            with pa.ipc.new_file(f, t.schema) as w:
                w.write_table(t)
        self._n += 1

    def close(self, meta: Optional[dict] = None):
        with open(os.path.join(self.dir, "meta.json"), "w") as f:
            json.dump({"num_batches": self._n, **(meta or {})}, f)


def write_plan(trace_dir: str, plan: P.PlanNode) -> None:
    os.makedirs(trace_dir, exist_ok=True)
    with open(os.path.join(trace_dir, "plan.txt"), "w") as f:
        f.write(P.plan_tree_string(plan))
    with open(os.path.join(trace_dir, "plan.pickle"), "wb") as f:
        pickle.dump(plan, f)


def read_trace_inputs(trace_dir: str, node_id: str):
    """Yield the recorded input tables of a node (pyarrow Tables)."""
    import pyarrow as pa
    d = os.path.join(trace_dir, f"node-{node_id}")
    for n in sorted(n for n in os.listdir(d) if n.endswith(".arrow")):
        with pa.ipc.open_file(os.path.join(d, n)) as r:
            yield r.read_all()


def load_plan(trace_dir: str) -> P.PlanNode:
    with open(os.path.join(trace_dir, "plan.pickle"), "rb") as f:
        return pickle.load(f)


def _find_node(plan: P.PlanNode, node_id: str) -> P.PlanNode:
    if plan.id == node_id:
        return plan
    for s in plan.sources:
        try:
            return _find_node(s, node_id)
        except KeyError:
            continue
    raise KeyError(node_id)


def _replace_chain_bottom(node: P.PlanNode, values: P.PlanNode):
    """Replace the bottom of `node`'s Filter/Project chain with `values`:
    a fused chain records its inputs at the chain's source, so the replay
    keeps the chain's Filter/Project nodes."""
    if isinstance(node, (P.FilterNode, P.ProjectNode)):
        return dataclasses.replace(
            node, source=_replace_chain_bottom(node.source, values))
    return values


def replay_operator(trace_dir: str, node_id: str, device):
    """Re-run one traced operator over its recorded inputs on ``device``:
    the node (with its fused Filter/Project chain) over a ValuesNode of
    the recorded batches, in a fresh Task.
    Parity: tool/trace/QueryReplayer.cpp."""
    from velox_tpu_torch.exec.fuse import collapse_chain
    from velox_tpu_torch.exec.task import QueryCtx, Task

    plan = load_plan(trace_dir)
    node = _find_node(plan, node_id)
    tables = list(read_trace_inputs(trace_dir, node_id))
    if not tables:
        raise RuntimeError(f"no recorded inputs for node {node_id}")
    ctx = QueryCtx(device)
    if not node.sources:
        return Task(node, ctx).run()
    chain_src = collapse_chain(node.sources[0]).source
    values = P.ValuesNode("replay-src", row_type=chain_src.output_type(),
                          tables=tuple(tables))
    replayed = dataclasses.replace(
        node, source=_replace_chain_bottom(node.sources[0], values))
    return Task(replayed, ctx).run()

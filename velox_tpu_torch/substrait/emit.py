"""Velox plan -> Substrait (protojson) emission.

Role parity: ``velox/substrait/VeloxToSubstraitPlan.h`` — the reverse of
the ingestion in ``__init__.py``, so a velox_tpu_torch plan can be handed to
any Substrait consumer (or round-tripped through ``from_substrait`` for
cross-engine validation). Scope mirrors the reference's emitter: read
(+pushed filter), filter, project (+emit mapping), aggregate, sort,
fetch (Limit/TopN as sort+fetch), join, cross. Window emission is out
of scope (the reference's emitter lacks it too).

Output-column NAMES do not survive a round trip (Substrait is
positional; the ingester synthesizes ``expr{i}``/``agg{i}``) — results
round-trip exactly, names by position.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P

_FN_INV = {
    "plus": "add", "minus": "subtract", "multiply": "multiply",
    "divide": "divide", "mod": "modulus",
    "eq": "equal", "neq": "not_equal", "lt": "lt", "lte": "lte",
    "gt": "gt", "gte": "gte", "and": "and", "or": "or", "not": "not",
    "between": "between",
    "sum": "sum", "min": "min", "max": "max", "count": "count",
    "avg": "avg",
}

_SORT_INV = {
    P.SortOrder.ASC_NULLS_FIRST: "SORT_DIRECTION_ASC_NULLS_FIRST",
    P.SortOrder.ASC_NULLS_LAST: "SORT_DIRECTION_ASC_NULLS_LAST",
    P.SortOrder.DESC_NULLS_FIRST: "SORT_DIRECTION_DESC_NULLS_FIRST",
    P.SortOrder.DESC_NULLS_LAST: "SORT_DIRECTION_DESC_NULLS_LAST",
}

_JOIN_INV = {
    P.JoinType.INNER: "JOIN_TYPE_INNER",
    P.JoinType.FULL: "JOIN_TYPE_OUTER",
    P.JoinType.LEFT: "JOIN_TYPE_LEFT",
    P.JoinType.RIGHT: "JOIN_TYPE_RIGHT",
    P.JoinType.LEFT_SEMI_FILTER: "JOIN_TYPE_LEFT_SEMI",
    P.JoinType.ANTI: "JOIN_TYPE_LEFT_ANTI",
}


def _subs_type(t: T.DataType) -> Dict:
    k = t.kind
    if k is T.TypeKind.INTEGER:
        return {"i32": {}}
    if k in (T.TypeKind.BIGINT, T.TypeKind.TINYINT, T.TypeKind.SMALLINT):
        return {"i64": {}}
    if k is T.TypeKind.REAL:
        return {"fp32": {}}
    if k is T.TypeKind.DOUBLE:
        return {"fp64": {}}
    if k is T.TypeKind.BOOLEAN:
        return {"bool": {}}
    if k is T.TypeKind.VARCHAR:
        return {"string": {}}
    if k is T.TypeKind.DATE:
        return {"date": {}}
    if k is T.TypeKind.TIMESTAMP:
        return {"timestamp": {}}
    if k is T.TypeKind.DECIMAL:
        return {"decimal": {"precision": t.precision, "scale": t.scale}}
    raise ValueError(f"cannot emit substrait type for {t}")


class _Emitter:
    def __init__(self):
        self.anchors: Dict[str, int] = {}

    def _anchor(self, name: str) -> int:
        base = _FN_INV.get(name, name)
        if base not in self.anchors:
            self.anchors[base] = len(self.anchors) + 1
        return self.anchors[base]

    # -- expressions ---------------------------------------------------------

    def expr(self, e: ex.TypedExpr, input_type: T.DataType) -> Dict:
        if isinstance(e, ex.FieldAccess):
            idx = list(input_type.names).index(e.name)
            return {"selection": {
                "directReference": {"structField": {"field": idx}}}}
        if isinstance(e, ex.Constant):
            return {"literal": self._literal(e)}
        if isinstance(e, ex.Cast):
            return {"cast": {"type": _subs_type(e.dtype),
                             "input": self.expr(e.child, input_type)}}
        if isinstance(e, ex.Call):
            if e.name == "if" and len(e.args) == 3:
                return {"ifThen": {
                    "ifs": [{"if": self.expr(e.args[0], input_type),
                             "then": self.expr(e.args[1], input_type)}],
                    "else": self.expr(e.args[2], input_type)}}
            return {"scalarFunction": {
                "functionReference": self._anchor(e.name),
                "outputType": _subs_type(e.dtype),
                "arguments": [{"value": self.expr(a, input_type)}
                              for a in e.args]}}
        raise ValueError(f"cannot emit substrait expr for {type(e)}")

    def _literal(self, c: ex.Constant) -> Dict:
        t, v = c.dtype, c.value
        if t.kind is T.TypeKind.BIGINT:
            return {"i64": str(int(v))}
        if t.kind is T.TypeKind.INTEGER:
            return {"i32": int(v)}
        if t.kind is T.TypeKind.DOUBLE:
            return {"fp64": float(v)}
        if t.kind is T.TypeKind.BOOLEAN:
            return {"boolean": bool(v)}
        if t.kind is T.TypeKind.VARCHAR:
            return {"string": str(v)}
        if t.kind is T.TypeKind.DATE:
            if isinstance(v, str):  # ISO date literal -> epoch days
                import datetime as _dt
                v = (_dt.date.fromisoformat(v)
                     - _dt.date(1970, 1, 1)).days
            return {"date": int(v)}
        if t.kind is T.TypeKind.DECIMAL:
            raw = int(v).to_bytes(16, "little", signed=True)
            return {"decimal": {
                "value": base64.b64encode(raw).decode(),
                "precision": t.precision, "scale": t.scale}}
        raise ValueError(f"cannot emit substrait literal of {t}")

    # -- relations -----------------------------------------------------------

    def rel(self, node: P.PlanNode) -> Dict:
        if isinstance(node, P.ValuesNode):
            rt = node.row_type
            rows: List[Dict] = []
            for t in node.tables:
                for r in t.to_pylist():
                    rows.append({"fields": [
                        self._literal(ex.Constant(
                            rt.field_type(n), r[n]))
                        for n in rt.names]})
            return {"read": {
                "baseSchema": {
                    "names": list(rt.names),
                    "struct": {"types": [_subs_type(c)
                                         for c in rt.children]}},
                "virtualTable": {"values": rows}}}
        if isinstance(node, P.TableScanNode):
            spec: Dict[str, Any] = {
                "baseSchema": {
                    "names": list(node.columns),
                    "struct": {"types": [
                        _subs_type(node.row_type.field_type(n))
                        for n in node.columns]}},
                "namedTable": {"names": [node.table]},
            }
            if node.filter is not None:
                spec["filter"] = self.expr(node.filter,
                                           node.output_type())
            return {"read": spec}
        if isinstance(node, P.FilterNode):
            return {"filter": {
                "input": self.rel(node.source),
                "condition": self.expr(node.predicate,
                                       node.source.output_type())}}
        if isinstance(node, P.ProjectNode):
            it = node.source.output_type()
            n_in = len(it.names)
            return {"project": {
                "common": {"emit": {"outputMapping": [
                    n_in + i for i in range(len(node.expressions))]}},
                "input": self.rel(node.source),
                "expressions": [self.expr(e, it)
                                for e in node.expressions]}}
        if isinstance(node, P.AggregationNode):
            it = node.source.output_type()
            measures = []
            for call in node.aggregates:
                measures.append({"measure": {
                    "functionReference": self._anchor(call.name),
                    "outputType": _subs_type(call.result_type),
                    "arguments": [{"value": self.expr(a, it)}
                                  for a in call.inputs]}})
            return {"aggregate": {
                "input": self.rel(node.source),
                "groupings": [{"groupingExpressions": [
                    self.expr(k, it) for k in node.grouping_keys]}],
                "measures": measures}}
        if isinstance(node, (P.OrderByNode, P.TopNNode)):
            it = node.source.output_type()
            sort = {"sort": {
                "input": self.rel(node.source),
                "sorts": [{"expr": self.expr(k, it),
                           "direction": _SORT_INV[o]}
                          for k, o in zip(node.keys, node.orders)]}}
            if isinstance(node, P.TopNNode):
                return {"fetch": {"input": sort, "offset": "0",
                                  "count": str(node.count)}}
            return sort
        if isinstance(node, P.LimitNode):
            return {"fetch": {"input": self.rel(node.source),
                              "offset": str(node.offset),
                              "count": str(node.count)}}
        if isinstance(node, P.HashJoinNode):
            lt = node.left.output_type()
            rt = node.right.output_type()
            combined = T.row(list(lt.names) + list(rt.names),
                             list(lt.children) + list(rt.children))
            cond = None
            for lk, rk in zip(node.left_keys, node.right_keys):
                c = ex.Call(T.BOOLEAN, "eq", (lk, rk))
                cond = c if cond is None else ex.Call(T.BOOLEAN, "and",
                                                      (cond, c))
            if node.filter is not None:
                cond = node.filter if cond is None else \
                    ex.Call(T.BOOLEAN, "and", (cond, node.filter))
            out = {"join": {
                "left": self.rel(node.left),
                "right": self.rel(node.right),
                "type": _JOIN_INV[node.join_type]}}
            if cond is not None:
                out["join"]["expression"] = self.expr(cond, combined)
            # joins narrowed by output_columns emit a projection on top
            if node.output_columns:
                idx = {n: i for i, n in enumerate(combined.names)}
                out["join"]["common"] = {"emit": {"outputMapping": [
                    idx[n] for n in node.output_columns]}}
            return out
        if isinstance(node, P.NestedLoopJoinNode) \
                and node.join_type is P.JoinType.INNER \
                and node.filter is None:
            return {"cross": {"left": self.rel(node.left),
                              "right": self.rel(node.right)}}
        if isinstance(node, P.WindowNode):
            return self._window_rel(node)
        raise ValueError(
            f"cannot emit substrait for {type(node).__name__}")

    def _window_rel(self, node: "P.WindowNode") -> Dict:
        """ConsistentPartitionWindowRel — the exact shape
        velox_tpu_torch.substrait's _rel_consistentPartitionWindow ingests
        (parity: VeloxToSubstraitPlan window handling)."""
        from velox_tpu_torch.exec.window import BoundType, FrameType
        it = node.source.output_type()

        def bound(bt: BoundType, value) -> Dict:
            if bt in (BoundType.UNBOUNDED_PRECEDING,
                      BoundType.UNBOUNDED_FOLLOWING):
                return {"unbounded": {}}
            if bt is BoundType.CURRENT_ROW:
                return {"currentRow": {}}
            if not isinstance(value, int):
                raise ValueError(
                    "substrait window bounds must be constants "
                    f"(got column offset {value!r})")
            key = ("preceding" if bt is BoundType.PRECEDING
                   else "following")
            return {key: {"offset": int(value)}}

        wfs = []
        for call in node.functions:
            wfs.append({
                "functionReference": self._anchor(call.name),
                "arguments": [{"value": self.expr(a, it)}
                              for a in call.inputs],
                "outputType": _subs_type(call.result_type),
                "boundsType": ("BOUNDS_TYPE_ROWS"
                               if call.frame.frame_type is FrameType.ROWS
                               else "BOUNDS_TYPE_RANGE"),
                "lowerBound": bound(call.frame.start_type,
                                    call.frame.start_value),
                "upperBound": bound(call.frame.end_type,
                                    call.frame.end_value),
            })
        return {"consistentPartitionWindow": {
            "input": self.rel(node.source),
            "partitionExpressions": [self.expr(k, it)
                                     for k in node.partition_keys],
            "sorts": [{"expr": self.expr(k, it),
                       "direction": _SORT_INV[o]}
                      for k, o in zip(node.sort_keys, node.sort_orders)],
            "windowFunctions": wfs}}


def to_substrait(plan: P.PlanNode) -> Dict:
    """velox_tpu_torch plan -> Substrait plan dict (protojson form), the exact
    shape ``from_substrait`` ingests."""
    em = _Emitter()
    root = em.rel(plan)
    extensions = [
        {"extensionFunction": {"functionAnchor": a, "name": n}}
        for n, a in sorted(em.anchors.items(), key=lambda kv: kv[1])]
    return {"extensions": extensions,
            "relations": [{"root": {
                "input": root,
                "names": list(plan.output_type().names)}}]}

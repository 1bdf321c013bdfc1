"""Fluent plan construction DSL.

Role parity: ``velox/exec/tests/utils/PlanBuilder.h`` — the de-facto user
API in the reference's tests and benchmarks. Expressions are SQL strings
parsed by velox_tpu.parse (the reference uses DuckDB's parser there).
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.parse.parser import Parser, _tokenize, parse_expression


def _parse_named(text: str, row_type):
    """Parse 'expr [AS name]' -> (name, expr)."""
    p = Parser(_tokenize(text), row_type)
    e = p.parse_expr()
    name = None
    if p.accept("kw", "as") or (p.peek().kind == "name"):
        t = p.next()
        name = t.value
    if p.peek().kind != "eof":
        raise ValueError(f"trailing tokens in projection {text!r}")
    if name is None:
        name = str(e) if isinstance(e, ex.FieldAccess) else None
    return name, e


def _match_paren(s: str, i: int) -> int:
    """Index of the ')' closing the '(' at s[i] (paren-depth scan)."""
    depth = 0
    for j in range(i, len(s)):
        if s[j] == "(":
            depth += 1
        elif s[j] == ")":
            depth -= 1
            if depth == 0:
                return j
    raise ValueError(f"unbalanced parentheses in {s!r}")


def _parse_agg_spec(text: str):
    """Parse 'name(args...) [filter (where cond)] [as out]' ->
    (fname, arg_text, mask_text, out_name). Handles nested parens in
    args (a regex cannot)."""
    s = text.strip()
    m = re.match(r"(\w+)\s*\(", s)
    if not m:
        raise ValueError(f"cannot parse aggregate {text!r}")
    fname = m.group(1).lower()
    j = _match_paren(s, m.end() - 1)
    arg_text = s[m.end():j]
    rest = s[j + 1:].strip()
    mask_text = None
    fm = re.match(r"filter\s*\(", rest, re.I)
    if fm:
        k = _match_paren(rest, fm.end() - 1)
        inner = rest[fm.end():k].strip()
        wm = re.match(r"where\s+", inner, re.I)
        if not wm:
            raise ValueError(f"FILTER clause must be (WHERE ...): {text!r}")
        mask_text = inner[wm.end():].strip()
        rest = rest[k + 1:].strip()
    out_name = None
    if rest:
        am = re.match(r"as\s+(\w+)\s*$", rest, re.I)
        if not am:
            raise ValueError(f"cannot parse aggregate tail {rest!r}")
        out_name = am.group(1)
    return fname, arg_text, mask_text, out_name


class PlanBuilder:
    def __init__(self, id_gen: Optional[P.PlanNodeIdGenerator] = None):
        self._ids = id_gen or P.PlanNodeIdGenerator()
        self._node: Optional[P.PlanNode] = None

    # ---- sources -----------------------------------------------------------

    def values(self, tables,
               string_encoding: str = "dict") -> "PlanBuilder":
        import pyarrow as pa
        first = tables[0]
        if isinstance(first, (pa.Table, pa.RecordBatch)):
            rt = T.row(first.schema.names,
                       [T.from_arrow(f.type) for f in first.schema])
        else:
            rt = first.row_type()
        self._node = P.ValuesNode(self._ids.next(), row_type=rt,
                                  tables=tuple(tables),
                                  string_encoding=string_encoding)
        return self

    def table_scan(self, table: str, columns: Sequence[str] = (),
                   connector_id: str = "tpch",
                   filter: Optional[str] = None) -> "PlanBuilder":
        from velox_tpu_torch.connectors.connector import get_connector
        conn = get_connector(connector_id)
        schema = conn.table_schema(table)
        cols = tuple(columns) if columns else tuple(schema.names)
        rt = T.row(cols, [schema.field_type(c) for c in cols])
        filter_expr = parse_expression(filter, rt) if filter else None
        self._node = P.TableScanNode(
            self._ids.next(), table=table, connector_id=connector_id,
            columns=cols, row_type=rt, filter=filter_expr)
        return self

    # ---- row-level ----------------------------------------------------------

    def filter(self, predicate: str) -> "PlanBuilder":
        e = parse_expression(predicate, self._node.output_type())
        self._node = P.FilterNode(self._ids.next(), source=self._node,
                                  predicate=e)
        return self

    def project_exprs(self, named_exprs) -> "PlanBuilder":
        """Project pre-built (name, TypedExpr) pairs (fuzzer/API use)."""
        names = tuple(n for n, _ in named_exprs)
        exprs = tuple(e for _, e in named_exprs)
        self._node = P.ProjectNode(self._ids.next(), source=self._node,
                                   names=names, expressions=exprs)
        return self

    def project(self, projections: Sequence[str]) -> "PlanBuilder":
        rt = self._node.output_type()
        names, exprs = [], []
        for i, text in enumerate(projections):
            name, e = _parse_named(text, rt)
            names.append(name or f"p{i}")
            exprs.append(e)
        self._node = P.ProjectNode(self._ids.next(), source=self._node,
                                   names=tuple(names),
                                   expressions=tuple(exprs))
        return self

    # ---- aggregation ---------------------------------------------------------

    def _aggregation(self, step, grouping_keys, aggregates):
        rt = self._node.output_type()
        keys = tuple(ex.field(k, rt.field_type(k)) for k in grouping_keys)
        agg_names, agg_calls = [], []
        for i, text in enumerate(aggregates):
            fname, arg_text, mask_text, out_name = _parse_agg_spec(text)
            arg_text = arg_text.strip()
            if arg_text in ("", "*"):
                inputs = ()
            else:
                inputs = tuple(
                    parse_expression(a.strip(), rt)
                    for a in _split_args(arg_text))
            mask = (parse_expression(mask_text, rt)
                    if mask_text is not None else None)
            from velox_tpu_torch.functions.aggregates import resolve_aggregate
            fn = resolve_aggregate(fname, [x.dtype for x in inputs])
            agg_names.append(out_name or f"a{i}")
            agg_calls.append(P.AggregateCall(
                name=fname, inputs=inputs, result_type=fn.result_type,
                mask=mask))
        self._node = P.AggregationNode(
            self._ids.next(), source=self._node, step=step,
            grouping_keys=keys, aggregate_names=tuple(agg_names),
            aggregates=tuple(agg_calls))
        return self

    def local_partition(self, keys=(), kind: str = "gather"
                        ) -> "PlanBuilder":
        """In-process pipeline boundary (parity: PlanBuilder::
        localPartition). Serial tasks run the source subtree on N
        producer driver threads (local_exchange_drivers config)."""
        rt = self._node.output_type()
        kexprs = tuple(ex.field(k, rt.field_type(k)) for k in keys)
        self._node = P.LocalPartitionNode(
            self._ids.next(), source=self._node, kind=kind, keys=kexprs)
        return self

    def single_aggregation(self, grouping_keys, aggregates):
        return self._aggregation(P.AggregationStep.SINGLE,
                                 grouping_keys, aggregates)

    def partial_aggregation(self, grouping_keys, aggregates):
        return self._aggregation(P.AggregationStep.PARTIAL,
                                 grouping_keys, aggregates)

    def final_aggregation(self, grouping_keys=None, aggregates=None):
        if grouping_keys is None:
            # Derive from the preceding partial aggregation (parity with the
            # reference PlanBuilder::finalAggregation() no-arg form),
            # looking through a LocalPartition boundary.
            src = self._node
            probe = src
            while isinstance(probe, P.LocalPartitionNode):
                probe = probe.source
            if isinstance(probe, P.AggregationNode) and probe is not src:
                self._node = P.AggregationNode(
                    self._ids.next(), source=src,
                    step=P.AggregationStep.FINAL,
                    grouping_keys=tuple(
                        ex.field(k.name, src.output_type()
                                 .field_type(k.name))
                        for k in probe.grouping_keys),
                    aggregate_names=probe.aggregate_names,
                    aggregates=probe.aggregates)
                return self
            if not isinstance(src, P.AggregationNode):
                raise ValueError("no-arg final_aggregation requires a "
                                 "partial aggregation as input")
            ot = src.output_type()
            keys = tuple(ex.field(k.name, ot.field_type(k.name))
                         for k in src.grouping_keys)
            self._node = P.AggregationNode(
                self._ids.next(), source=src,
                step=P.AggregationStep.FINAL, grouping_keys=keys,
                aggregate_names=src.aggregate_names,
                aggregates=src.aggregates)
            return self
        return self._aggregation(P.AggregationStep.FINAL,
                                 grouping_keys, aggregates)

    # ---- sorts / limits -------------------------------------------------------

    def _parse_orders(self, keys):
        rt = self._node.output_type()
        fields, orders = [], []
        for k in keys:
            parts = k.split()
            name = parts[0]
            spec = " ".join(parts[1:]).lower()
            order = P.SortOrder.ASC_NULLS_LAST
            if spec.startswith("desc"):
                order = (P.SortOrder.DESC_NULLS_FIRST
                         if "nulls first" in spec
                         else P.SortOrder.DESC_NULLS_LAST)
            elif "nulls first" in spec:
                order = P.SortOrder.ASC_NULLS_FIRST
            fields.append(ex.field(name, rt.field_type(name)))
            orders.append(order)
        return tuple(fields), tuple(orders)

    def order_by(self, keys: Sequence[str]) -> "PlanBuilder":
        fields, orders = self._parse_orders(keys)
        self._node = P.OrderByNode(self._ids.next(), source=self._node,
                                   keys=fields, orders=orders)
        return self

    def local_merge(self, keys: Sequence[str]) -> "PlanBuilder":
        """Ordered gather over a source producing interleaved sorted
        runs (parity: PlanBuilder::localMerge)."""
        fields, orders = self._parse_orders(keys)
        self._node = P.LocalMergeNode(self._ids.next(), source=self._node,
                                      keys=fields, orders=orders)
        return self

    def top_n(self, keys: Sequence[str], count: int) -> "PlanBuilder":
        fields, orders = self._parse_orders(keys)
        self._node = P.TopNNode(self._ids.next(), source=self._node,
                                keys=fields, orders=orders, count=count)
        return self

    def limit(self, count: int, offset: int = 0) -> "PlanBuilder":
        self._node = P.LimitNode(self._ids.next(), source=self._node,
                                 offset=offset, count=count)
        return self

    # ---- window ----------------------------------------------------------------

    def window(self, partition_keys, sort_keys, functions,
               frame=None) -> "PlanBuilder":
        """functions: 'name(args...) as out' strings; frame: WindowFrame
        applied to all frame-based functions (default RANGE UNBOUNDED
        PRECEDING -> CURRENT ROW)."""
        from velox_tpu_torch.exec.window import (
            DEFAULT_FRAME, WindowFunctionCall,
        )
        rt = self._node.output_type()
        pk = tuple(ex.field(k, rt.field_type(k)) for k in partition_keys)
        sk, orders = self._parse_orders(sort_keys)
        names, calls = [], []
        for i, text in enumerate(functions):
            fname, arg_text, _mask, out_name = _parse_agg_spec(text)
            args = tuple(
                parse_expression(a.strip(), rt)
                for a in _split_args(arg_text.strip()) if a.strip())
            result_type = self._window_result_type(fname, args)
            names.append(out_name or f"w{i}")
            calls.append(WindowFunctionCall(
                name=fname, inputs=args, result_type=result_type,
                frame=frame or DEFAULT_FRAME))
        self._node = P.WindowNode(
            self._ids.next(), source=self._node, partition_keys=pk,
            sort_keys=sk, sort_orders=orders, output_names=tuple(names),
            functions=tuple(calls))
        return self

    @staticmethod
    def _window_result_type(fname, args):
        from velox_tpu_torch.functions.aggregates import resolve_aggregate
        if fname in ("row_number", "rank", "dense_rank", "ntile"):
            return T.BIGINT
        if fname in ("percent_rank", "cume_dist"):
            return T.DOUBLE
        if fname in ("lead", "lag", "first_value", "last_value",
                     "nth_value"):
            return args[0].dtype
        return resolve_aggregate(fname, [a.dtype for a in args]).result_type

    def row_number(self, partition_keys, row_number_column="row_number",
                   limit=None) -> "PlanBuilder":
        rt = self._node.output_type()
        pk = tuple(ex.field(k, rt.field_type(k)) for k in partition_keys)
        self._node = P.RowNumberNode(
            self._ids.next(), source=self._node, partition_keys=pk,
            row_number_column=row_number_column, limit=limit)
        return self

    def top_n_row_number(self, partition_keys, sort_keys, limit,
                         row_number_column=None) -> "PlanBuilder":
        rt = self._node.output_type()
        pk = tuple(ex.field(k, rt.field_type(k)) for k in partition_keys)
        sk, orders = self._parse_orders(sort_keys)
        self._node = P.TopNRowNumberNode(
            self._ids.next(), source=self._node, partition_keys=pk,
            sort_keys=sk, sort_orders=orders,
            row_number_column=row_number_column, limit=limit)
        return self

    # ---- joins -----------------------------------------------------------------

    def hash_join(self, left_keys, right_keys, build: "PlanBuilder",
                  output: Sequence[str] = (),
                  join_type: str = "inner",
                  filter: Optional[str] = None) -> "PlanBuilder":
        lt = self._node.output_type()
        rt_ = build._node.output_type()
        lk = tuple(ex.field(k, lt.field_type(k)) for k in left_keys)
        rk = tuple(ex.field(k, rt_.field_type(k)) for k in right_keys)
        jt = P.JoinType(join_type)
        combined = T.row(list(lt.names) + list(rt_.names),
                         list(lt.children) + list(rt_.children))
        fexpr = parse_expression(filter, combined) if filter else None
        self._node = P.HashJoinNode(
            self._ids.next(), left=self._node, right=build._node,
            join_type=jt, left_keys=lk, right_keys=rk, filter=fexpr,
            output_columns=tuple(output))
        return self

    def table_write(self, target_path: str,
                    connector_id: str = "hive",
                    partition_keys: Sequence[str] = (),
                    bucket_count: int = 0,
                    bucket_keys: Sequence[str] = (),
                    file_format: Optional[str] = None) -> "PlanBuilder":
        self._node = P.TableWriteNode(
            self._ids.next(), source=self._node,
            connector_id=connector_id, target_path=target_path,
            partition_keys=tuple(partition_keys),
            bucket_count=bucket_count, bucket_keys=tuple(bucket_keys),
            file_format=file_format)
        return self

    def merge_join(self, left_keys, right_keys, build: "PlanBuilder",
                   output: Sequence[str] = (),
                   join_type: str = "inner") -> "PlanBuilder":
        lt = self._node.output_type()
        rt_ = build._node.output_type()
        lk = tuple(ex.field(k, lt.field_type(k)) for k in left_keys)
        rk = tuple(ex.field(k, rt_.field_type(k)) for k in right_keys)
        self._node = P.MergeJoinNode(
            self._ids.next(), left=self._node, right=build._node,
            join_type=P.JoinType(join_type), left_keys=lk, right_keys=rk,
            output_columns=tuple(output))
        return self

    def nested_loop_join(self, build: "PlanBuilder",
                         output: Sequence[str] = (),
                         filter: Optional[str] = None,
                         join_type: str = "inner") -> "PlanBuilder":
        lt = self._node.output_type()
        rt_ = build._node.output_type()
        combined = T.row(list(lt.names) + list(rt_.names),
                         list(lt.children) + list(rt_.children))
        fexpr = parse_expression(filter, combined) if filter else None
        self._node = P.NestedLoopJoinNode(
            self._ids.next(), left=self._node, right=build._node,
            join_type=P.JoinType(join_type),
            filter=fexpr, output_columns=tuple(output))
        return self

    def unnest(self, column: str, element_name="element",
               value_name="value", ordinality=None) -> "PlanBuilder":
        self._node = P.UnnestNode(
            self._ids.next(), source=self._node, unnest_column=column,
            element_name=element_name, value_name=value_name,
            ordinality_name=ordinality)
        return self

    def mark_distinct(self, marker: str, keys) -> "PlanBuilder":
        rt = self._node.output_type()
        dk = tuple(ex.field(k, rt.field_type(k)) for k in keys)
        self._node = P.MarkDistinctNode(
            self._ids.next(), source=self._node, marker=marker,
            distinct_keys=dk)
        return self

    def assign_unique_id(self, id_column="unique",
                         task_unique_id=0) -> "PlanBuilder":
        self._node = P.AssignUniqueIdNode(
            self._ids.next(), source=self._node, id_column=id_column,
            task_unique_id=task_unique_id)
        return self

    def enforce_single_row(self) -> "PlanBuilder":
        self._node = P.EnforceSingleRowNode(self._ids.next(),
                                            source=self._node)
        return self

    def expand(self, projection_sets) -> "PlanBuilder":
        """projection_sets: list of lists of 'expr [as name]' strings; all
        sets must produce the same names/types."""
        rt = self._node.output_type()
        names, sets = None, []
        for ps in projection_sets:
            ns, es = [], []
            for i, text in enumerate(ps):
                n, e = _parse_named(text, rt)
                ns.append(n or f"c{i}")
                es.append(e)
            if names is None:
                names = ns
            sets.append(tuple(es))
        self._node = P.ExpandNode(
            self._ids.next(), source=self._node, names=tuple(names),
            projection_sets=tuple(sets))
        return self

    # -----------------------------------------------------------------------------

    def plan(self) -> P.PlanNode:
        return self._node

    def new_builder(self) -> "PlanBuilder":
        """A builder sharing this one's id generator (for join builds)."""
        return PlanBuilder(self._ids)

    def tee(self) -> "PlanBuilder":
        """A new builder rooted at this builder's CURRENT node — plan-DAG
        reuse for correlated-subquery rewrites (e.g. TPC-H Q2's min-cost
        join-back). The serial Task re-executes the shared subtree per
        consumer."""
        nb = PlanBuilder(self._ids)
        nb._node = self._node
        return nb


def _split_args(s: str) -> List[str]:
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out

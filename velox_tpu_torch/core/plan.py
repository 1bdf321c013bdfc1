"""Query plan node tree.

Role parity: ``velox/core/PlanNode.h:110-2391`` — the ~30 plan node types a
host engine hands to the executor. This file covers the core relational set;
exchange/partitioning nodes live here too and are lowered by the parallel
layer onto jax.sharding collectives instead of a wire protocol.

Plan nodes are immutable metadata (no device state); operators in
velox_tpu/exec compile them into jitted batch programs.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field as dfield
from typing import List, Optional, Sequence, Tuple

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex


class PlanNodeIdGenerator:
    def __init__(self):
        self._c = itertools.count()

    def next(self) -> str:
        return str(next(self._c))


@dataclass(frozen=True)
class PlanNode:
    id: str

    @property
    def sources(self) -> Tuple["PlanNode", ...]:
        return ()

    def output_type(self) -> T.DataType:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Node", "")


@dataclass(frozen=True)
class ValuesNode(PlanNode):
    """Literal in-memory batches. Parity: core/PlanNode.h:224."""
    row_type: T.DataType = None
    # host-side payload (list of pyarrow tables); not hashed
    tables: tuple = dfield(default=(), hash=False, compare=False)
    # VARCHAR representation: "dict" | "raw" | "auto" (vector/device.py
    # column_from_arrow)
    string_encoding: str = "dict"

    def output_type(self):
        return self.row_type


@dataclass(frozen=True)
class TableScanNode(PlanNode):
    """Connector-backed scan. Parity: core/PlanNode.h:460."""
    table: str = ""
    connector_id: str = "tpch"
    columns: Tuple[str, ...] = ()
    row_type: T.DataType = None
    # optional pushed-down filter evaluated inside the scan superstep
    filter: Optional[ex.TypedExpr] = None

    def output_type(self):
        return self.row_type


@dataclass(frozen=True)
class FilterNode(PlanNode):
    """Parity: core/PlanNode.h:350."""
    source: PlanNode = None
    predicate: ex.TypedExpr = None

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


@dataclass(frozen=True)
class ProjectNode(PlanNode):
    """Parity: core/PlanNode.h:389."""
    source: PlanNode = None
    names: Tuple[str, ...] = ()
    expressions: Tuple[ex.TypedExpr, ...] = ()

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return T.row(self.names, [e.dtype for e in self.expressions])


class AggregationStep(enum.Enum):
    # Parity: core/PlanNode.h:512-525 (partial/intermediate/final/single).
    PARTIAL = "partial"
    INTERMEDIATE = "intermediate"
    FINAL = "final"
    SINGLE = "single"


@dataclass(frozen=True)
class AggregateCall:
    name: str  # e.g. 'sum'
    inputs: Tuple[ex.TypedExpr, ...]
    result_type: T.DataType
    mask: Optional[ex.TypedExpr] = None  # FILTER (WHERE mask)
    distinct: bool = False


@dataclass(frozen=True)
class AggregationNode(PlanNode):
    """Parity: core/PlanNode.h:512."""
    source: PlanNode = None
    step: AggregationStep = AggregationStep.SINGLE
    grouping_keys: Tuple[ex.FieldAccess, ...] = ()
    aggregate_names: Tuple[str, ...] = ()
    aggregates: Tuple[AggregateCall, ...] = ()

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        names = [k.name for k in self.grouping_keys]
        types = [k.dtype for k in self.grouping_keys]
        from velox_tpu_torch.functions.aggregates import resolve_aggregate
        for out_name, agg in zip(self.aggregate_names, self.aggregates):
            names.append(out_name)
            fn = resolve_aggregate(agg.name, [i.dtype for i in agg.inputs])
            if self.step in (AggregationStep.PARTIAL,
                             AggregationStep.INTERMEDIATE):
                types.append(fn.intermediate_type)
            else:
                types.append(fn.result_type)
        return T.row(names, types)


class SortOrder(enum.Enum):
    ASC_NULLS_LAST = "asc_nulls_last"
    ASC_NULLS_FIRST = "asc_nulls_first"
    DESC_NULLS_LAST = "desc_nulls_last"
    DESC_NULLS_FIRST = "desc_nulls_first"

    @property
    def ascending(self):
        return self in (SortOrder.ASC_NULLS_LAST, SortOrder.ASC_NULLS_FIRST)

    @property
    def nulls_first(self):
        return self in (SortOrder.ASC_NULLS_FIRST, SortOrder.DESC_NULLS_FIRST)


@dataclass(frozen=True)
class OrderByNode(PlanNode):
    """Parity: core/PlanNode.h:1798."""
    source: PlanNode = None
    keys: Tuple[ex.FieldAccess, ...] = ()
    orders: Tuple[SortOrder, ...] = ()
    is_partial: bool = False

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


@dataclass(frozen=True)
class TopNNode(PlanNode):
    """Parity: core/PlanNode.h:1871."""
    source: PlanNode = None
    keys: Tuple[ex.FieldAccess, ...] = ()
    orders: Tuple[SortOrder, ...] = ()
    count: int = 0
    is_partial: bool = False

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


@dataclass(frozen=True)
class LimitNode(PlanNode):
    """Parity: core/PlanNode.h:1923."""
    source: PlanNode = None
    offset: int = 0
    count: int = 0
    is_partial: bool = False

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


class JoinType(enum.Enum):
    # Parity: velox/core/PlanNode.h join types (HashJoinNode:1640).
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    FULL = "full"
    LEFT_SEMI_FILTER = "left_semi_filter"
    RIGHT_SEMI_FILTER = "right_semi_filter"
    ANTI = "anti"  # null-aware anti join


@dataclass(frozen=True)
class HashJoinNode(PlanNode):
    """Parity: core/PlanNode.h:1640. Probe side = left source, build side =
    right source (matches the reference's convention)."""
    left: PlanNode = None
    right: PlanNode = None
    join_type: JoinType = JoinType.INNER
    left_keys: Tuple[ex.FieldAccess, ...] = ()
    right_keys: Tuple[ex.FieldAccess, ...] = ()
    filter: Optional[ex.TypedExpr] = None
    output_columns: Tuple[str, ...] = ()
    null_aware: bool = False

    @property
    def sources(self):
        return (self.left, self.right)

    def output_type(self):
        lt, rt = self.left.output_type(), self.right.output_type()
        if self.join_type in (JoinType.LEFT_SEMI_FILTER, JoinType.ANTI):
            avail_names, avail_types = list(lt.names), list(lt.children)
        elif self.join_type is JoinType.RIGHT_SEMI_FILTER:
            avail_names, avail_types = list(rt.names), list(rt.children)
        else:
            avail_names = list(lt.names) + list(rt.names)
            avail_types = list(lt.children) + list(rt.children)
        if not self.output_columns:
            return T.row(avail_names, avail_types)
        idx = {n: t for n, t in zip(avail_names, avail_types)}
        return T.row(self.output_columns,
                     [idx[n] for n in self.output_columns])


@dataclass(frozen=True)
class TableWriteNode(PlanNode):
    """Write input rows through a connector DataSink.
    Parity: core/PlanNode.h:700; partition/bucket spec parity:
    connectors/hive/HiveDataSink.h:206-276 (HiveInsertTableHandle)."""
    source: PlanNode = None
    connector_id: str = "hive"
    target_path: str = ""
    partition_keys: Tuple[str, ...] = ()
    bucket_count: int = 0
    bucket_keys: Tuple[str, ...] = ()
    file_format: Optional[str] = None  # None = from path ext (parquet/orc)

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return T.row(["rows", "bytes", "path"],
                     [T.BIGINT, T.BIGINT, T.VARCHAR])


@dataclass(frozen=True)
class MarkDistinctNode(PlanNode):
    """Parity: core/PlanNode.h:2341."""
    source: PlanNode = None
    marker: str = "marker"
    distinct_keys: Tuple[ex.FieldAccess, ...] = ()

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        st = self.source.output_type()
        return T.row(list(st.names) + [self.marker],
                     list(st.children) + [T.BOOLEAN])


@dataclass(frozen=True)
class AssignUniqueIdNode(PlanNode):
    """Parity: core/PlanNode.h:2089."""
    source: PlanNode = None
    id_column: str = "unique"
    task_unique_id: int = 0

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        st = self.source.output_type()
        return T.row(list(st.names) + [self.id_column],
                     list(st.children) + [T.BIGINT])


@dataclass(frozen=True)
class EnforceSingleRowNode(PlanNode):
    """Parity: core/PlanNode.h:2052."""
    source: PlanNode = None

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


@dataclass(frozen=True)
class ExpandNode(PlanNode):
    """Emit one copy of the input per projection set (grouping sets /
    distinct-agg rewrites). Parity: core/PlanNode.h:872."""
    source: PlanNode = None
    names: Tuple[str, ...] = ()
    projection_sets: Tuple[Tuple[ex.TypedExpr, ...], ...] = ()

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return T.row(self.names,
                     [e.dtype for e in self.projection_sets[0]])


@dataclass(frozen=True)
class UnnestNode(PlanNode):
    """Expand an ARRAY (or MAP) column into one row per element, other
    columns replicated. Parity: core/PlanNode.h:1988."""
    source: PlanNode = None
    unnest_column: str = ""
    element_name: str = "element"
    value_name: str = "value"  # MAP only (element_name holds keys)
    ordinality_name: Optional[str] = None

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        st = self.source.output_type()
        names, types = [], []
        for n, t in zip(st.names, st.children):
            if n == self.unnest_column:
                continue
            names.append(n)
            types.append(t)
        ut = st.field_type(self.unnest_column)
        if ut.kind is T.TypeKind.MAP:
            names += [self.element_name, self.value_name]
            types += [ut.children[0], ut.children[1]]
        else:
            names.append(self.element_name)
            types.append(ut.children[0])
        if self.ordinality_name:
            names.append(self.ordinality_name)
            types.append(T.BIGINT)
        return T.row(names, types)


@dataclass(frozen=True)
class GroupIdNode(PlanNode):
    """Grouping-sets expansion: one copy of the input per grouping set,
    with keys outside the set nulled and a group_id column.
    Parity: core/PlanNode.h:922."""
    source: PlanNode = None
    grouping_sets: Tuple[Tuple[str, ...], ...] = ()
    aggregation_inputs: Tuple[str, ...] = ()
    group_id_name: str = "group_id"

    @property
    def sources(self):
        return (self.source,)

    def all_keys(self):
        seen, out = set(), []
        for gs in self.grouping_sets:
            for k in gs:
                if k not in seen:
                    seen.add(k)
                    out.append(k)
        return out

    def output_type(self):
        st = self.source.output_type()
        names = self.all_keys() + list(self.aggregation_inputs) \
            + [self.group_id_name]
        types = [st.field_type(n) for n in names[:-1]] + [T.BIGINT]
        return T.row(names, types)


@dataclass(frozen=True)
class NestedLoopJoinNode(PlanNode):
    """Cross/inequality join. Parity: core/PlanNode.h:1745 (inner/cross)."""
    left: PlanNode = None
    right: PlanNode = None
    join_type: JoinType = None
    filter: Optional[ex.TypedExpr] = None
    output_columns: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.join_type is None:
            object.__setattr__(self, "join_type", JoinType.INNER)

    @property
    def sources(self):
        return (self.left, self.right)

    def output_type(self):
        lt, rt = self.left.output_type(), self.right.output_type()
        names = list(lt.names) + list(rt.names)
        types = list(lt.children) + list(rt.children)
        if not self.output_columns:
            return T.row(names, types)
        idx = dict(zip(names, types))
        return T.row(self.output_columns,
                     [idx[n] for n in self.output_columns])


@dataclass(frozen=True)
class MergeJoinNode(PlanNode):
    """Sorted-input join. Parity: core/PlanNode.h:1709. Currently executed
    through the hash-join machinery (sortedness is not exploited yet —
    correct, not optimal)."""
    left: PlanNode = None
    right: PlanNode = None
    join_type: JoinType = None
    left_keys: Tuple[ex.FieldAccess, ...] = ()
    right_keys: Tuple[ex.FieldAccess, ...] = ()
    filter: Optional[ex.TypedExpr] = None
    output_columns: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.join_type is None:
            object.__setattr__(self, "join_type", JoinType.INNER)

    @property
    def sources(self):
        return (self.left, self.right)

    def output_type(self):
        return HashJoinNode.output_type(self)


@dataclass(frozen=True)
class WindowNode(PlanNode):
    """Parity: core/PlanNode.h:2145 (partition/sort keys + window function
    calls with ROWS/RANGE frames)."""
    source: PlanNode = None
    partition_keys: Tuple[ex.FieldAccess, ...] = ()
    sort_keys: Tuple[ex.FieldAccess, ...] = ()
    sort_orders: Tuple["SortOrder", ...] = ()
    output_names: Tuple[str, ...] = ()
    functions: tuple = ()  # WindowFunctionCall (exec/window.py)

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        st = self.source.output_type()
        names = list(st.names) + list(self.output_names)
        types = list(st.children) + [f.result_type for f in self.functions]
        return T.row(names, types)


@dataclass(frozen=True)
class RowNumberNode(PlanNode):
    """Parity: core/PlanNode.h:2276 (streaming partitioned row numbers,
    optional per-partition limit)."""
    source: PlanNode = None
    partition_keys: Tuple[ex.FieldAccess, ...] = ()
    row_number_column: Optional[str] = "row_number"
    limit: Optional[int] = None

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        st = self.source.output_type()
        if not self.row_number_column:
            return st
        return T.row(list(st.names) + [self.row_number_column],
                     list(st.children) + [T.BIGINT])


@dataclass(frozen=True)
class TopNRowNumberNode(PlanNode):
    """Parity: core/PlanNode.h:2391 (per-partition top-k by sort keys)."""
    source: PlanNode = None
    partition_keys: Tuple[ex.FieldAccess, ...] = ()
    sort_keys: Tuple[ex.FieldAccess, ...] = ()
    sort_orders: Tuple["SortOrder", ...] = ()
    row_number_column: Optional[str] = None
    limit: int = 1

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        st = self.source.output_type()
        if not self.row_number_column:
            return st
        return T.row(list(st.names) + [self.row_number_column],
                     list(st.children) + [T.BIGINT])


@dataclass(frozen=True)
class LocalPartitionNode(PlanNode):
    """In-process repartition. Parity: core/PlanNode.h:1171. On TPU this is
    a reshard across the chips of one host (mesh sub-axis)."""
    source: PlanNode = None
    kind: str = "gather"  # gather | repartition | round_robin
    keys: Tuple[ex.TypedExpr, ...] = ()

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


@dataclass(frozen=True)
class PartitionedOutputNode(PlanNode):
    """Distributed shuffle producer. Parity: core/PlanNode.h:1251. Lowered
    to a bucketize + all_to_all collective (SURVEY.md §5.8)."""
    source: PlanNode = None
    kind: str = "partitioned"  # partitioned | broadcast | arbitrary
    keys: Tuple[ex.TypedExpr, ...] = ()
    num_partitions: int = 1
    # PartitionFunction SPI spec (parity: core/PlanNode.h:1116):
    # "hash" | "round_robin" | "hive_bucket" | registered custom name
    partition_spec: str = "hash"
    bucket_count: int = 0  # hive_bucket only; 0 -> num_partitions

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


@dataclass(frozen=True)
class ExchangeNode(PlanNode):
    """Distributed shuffle consumer. Parity: core/PlanNode.h:1004."""
    row_type: T.DataType = None

    def output_type(self):
        return self.row_type


@dataclass(frozen=True)
class ArrowStreamNode(PlanNode):
    """Streaming source over a pyarrow RecordBatchReader (or any
    iterator of record batches/tables). Parity: core/PlanNode.h:280 +
    exec/ArrowStream.h:23 — the host-engine streaming ingest SPI."""
    reader: object = None        # RecordBatchReader | iterator factory
    row_type: T.DataType = None

    def output_type(self):
        return self.row_type


@dataclass(frozen=True)
class LocalMergeNode(PlanNode):
    """Ordered gather: re-establishes a total order over a source whose
    sorted runs arrive interleaved (multi-driver pipelines). Parity:
    core/PlanNode.h:1071 (LocalMergeNode + TreeOfLosers) — but the
    reference's merge IS a re-sort of the gathered runs over packed
    keys (exec/sort.py sort_perm_key)."""
    source: PlanNode = None
    keys: Tuple[ex.FieldAccess, ...] = ()
    orders: Tuple[SortOrder, ...] = ()

    @property
    def sources(self):
        return (self.source,)

    def output_type(self):
        return self.source.output_type()


@dataclass(frozen=True)
class MergeExchangeNode(PlanNode):
    """Ordered distributed exchange consumer: pages from remote tasks
    are drained, then the total order is re-established by one device
    sort (see LocalMergeNode for why re-sort beats a streaming merge on
    TPU). Parity: core/PlanNode.h:1037 (MergeExchangeNode)."""
    row_type: T.DataType = None
    keys: Tuple[ex.FieldAccess, ...] = ()
    orders: Tuple[SortOrder, ...] = ()

    def output_type(self):
        return self.row_type


def plan_tree_string(node: PlanNode, indent: int = 0) -> str:
    pad = "  " * indent
    lines = [f"{pad}- {node.name}[{node.id}] -> {node.output_type()}"]
    for s in node.sources:
        lines.append(plan_tree_string(s, indent + 1))
    return "\n".join(lines)

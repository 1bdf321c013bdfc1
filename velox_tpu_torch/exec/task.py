"""Task: executes one plan fragment serially on one torch device.

Counterpart of ``velox_tpu/exec/task.py`` (velox/exec/Task.h serial
``Task::next`` mode, LocalPlanner and the Driver pull loop). Every batch
of the query lives on ``QueryCtx.device``; the host loop only moves batch
handles, and reads a device value once at the end (the error total and
the output rows).

Ported node kinds: Values, ArrowStream, TableScan (with a pushed-down
filter), Filter/Project chains (fused, exec/fuse.py), Aggregation (the
filter-sum kernel for a Q6-shaped global ``sum(a * b)``,
ops/filter_reduce.py, and the generic operator of exec/aggregation.py
for every other plan, with partial-aggregation abandonment), OrderBy,
TopN and Limit (a Limit over an OrderBy runs as a TopN), Unnest, HashJoin
(exec/join.py: the build pipeline runs to completion, then the probe
pipeline streams; the probe side's scans start before the build runs),
NestedLoopJoin (exec/misc_ops.py, built and probed the same way),
EnforceSingleRow, MergeJoin (the presorted build compacts without a
sort, and probes binary-search it; key tuples beyond one packed lane
take the hash join), MarkDistinct, AssignUniqueId, Expand, GroupId
(exec/misc_ops.py), Window, RowNumber and TopNRowNumber (exec/window.py).
An aggregation over an OrderBy on its grouping keys streams
(exec/streaming_agg.py, unless ``STREAMING_AGG_ENABLED`` is false), and
one whose aggregate is ``map_union`` runs as an Unnest of the maps and a
``map_agg`` of their entries. The kinds still to port raise
NotImplementedError naming their ROADMAP item: TableWrite and
LocalPartition/LocalMerge (A.8), Exchange, MergeExchange and
PartitionedOutput (A.10).

*Dynamic filters* (``DYNAMIC_FILTERS``, HashProbe.cpp:393): once an
inner or semi join's build is done, the build keys' ``IN`` list (at most
64 usable rows) or ``[min, max]`` range becomes a Filter over the probe
side, which fuses into the probe scan's chain; not for an array-mode
join over a unique build, whose domain lookup rejects such rows anyway.
*The early finish* (``HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD``): such a
join over a build without a usable row runs no probe pipeline at all.
Its probe scans, started before the build, wait to read their first
split until a build batch holds a row, so an empty build leaves them
unread.

Scans take their splits from the device scan cache
(connectors/cache.py) and, by default on a CUDA device, generate and
upload the next splits on a producer thread (``SCAN_PREFETCH_DEPTH``).

*Memory and spill* (exec/memory.py). An OrderBy's input and a join
build's batches go through an ``OffloadBuffer`` that reserves them in
the query's pool (``QueryCtx.memory_pool``, capped by
``QUERY_HBM_CAP_BYTES``; past the cap the arbitrator evicts the scan
cache, then moves operator state to host RAM). ``SORT_OFFLOAD_BYTES``
and ``JOIN_BUILD_OFFLOAD_BYTES`` (4 GiB each by default) bound the
device bytes of each buffer; ``ORDERBY_SPILL_ENABLED`` and
``JOIN_SPILL_ENABLED`` switch those budgets off (a merge join's build
reads its budget without the switch, as in the reference).
``OFFLOAD_HOST_BUDGET_BYTES`` bounds a buffer's host bytes before its
oldest host batches go to spill files in ``SPILL_DIR`` (a temporary
directory when empty), and ``MAX_SPILL_BYTES`` caps those files' bytes.
``AGG_HOST_OFFLOAD`` moves an aggregation's compacted partial runs to
host RAM.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.connectors.connector import get_connector
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.core.config import QueryConfig
from velox_tpu_torch.core.stats import resolve_column_unique
from velox_tpu_torch.exec.aggregation import AggregationOperator
from velox_tpu_torch.exec.batch_utils import concat_batches
from velox_tpu_torch.exec.fuse import chain_fn, collapse_chain
from velox_tpu_torch.exec.join import (
    HashBuildStage, HashJoinOperator, MergeBuildStage, MergeJoinOperator,
    SortedBuild, array_join_range, build_key_ranges, has_raw_key,
    key_values, usable_rows,
)
from velox_tpu_torch.exec.operator import (
    ArrowStreamOperator, FilterProjectOperator, LimitOperator, Operator,
    SourceOperator, TableScanOperator, ValuesOperator,
)
from velox_tpu_torch.exec.memory import MemoryPool, OffloadBuffer
from velox_tpu_torch.exec.misc_ops import (
    AssignUniqueIdOperator, EnforceSingleRowOperator, ExpandOperator,
    GroupIdOperator, MarkDistinctOperator, NestedLoopJoinOperator,
    UnnestOperator,
)
from velox_tpu_torch.exec.orderby import OrderByOperator, TopNOperator
from velox_tpu_torch.exec.sort import packable_words
from velox_tpu_torch.exec.streaming_agg import (
    StreamingAggregationOperator, streaming_supported,
)
from velox_tpu_torch.exec.window import (
    RowNumberOperator, TopNRowNumberOperator, WindowOperator,
)
from velox_tpu_torch.vector.device import DeviceBatch

# single-source operators: node kind -> operator class
_UNARY = {
    P.EnforceSingleRowNode: EnforceSingleRowOperator,
    P.MarkDistinctNode: MarkDistinctOperator,
    P.AssignUniqueIdNode: AssignUniqueIdOperator,
    P.ExpandNode: ExpandOperator,
    P.GroupIdNode: GroupIdOperator,
    P.WindowNode: WindowOperator,
    P.RowNumberNode: RowNumberOperator,
    P.TopNRowNumberNode: TopNRowNumberOperator,
    P.TopNNode: TopNOperator,
    P.UnnestNode: UnnestOperator,
}

# joins whose unmatched probe rows are dropped: they take dynamic filters
_FILTERED_JOINS = (P.JoinType.INNER, P.JoinType.LEFT_SEMI_FILTER)

# node kinds still to port, and their ROADMAP item
_UNPORTED = {
    P.TableWriteNode: "A.8",
    P.LocalPartitionNode: "A.8",
    P.LocalMergeNode: "A.8",
    P.ExchangeNode: "A.10",
    P.MergeExchangeNode: "A.10",
    P.PartitionedOutputNode: "A.10",
}


def _map_union_plan(node: P.AggregationNode) -> Optional[P.PlanNode]:
    """map_union(m) as Unnest(m -> k, v) + map_agg(k, v), whose first
    entry of a duplicate key wins: Presto's arbitrary value for a key
    that repeats (MapUnionAggregate.cpp). None when the node has no
    map_union."""
    calls = [c for c in node.aggregates if c.name == "map_union"]
    if not calls:
        return None
    if len(node.aggregates) != 1:
        raise NotImplementedError(
            "map_union cannot mix with other aggregates (the unnest "
            "rewrite changes row counts)")
    inp = calls[0].inputs[0]
    if not isinstance(inp, ex.FieldAccess):
        raise NotImplementedError("map_union argument must be a column")
    kname, vname = "__mu_k", "__mu_v"
    unnest = P.UnnestNode(f"{node.id}__mu", source=node.source,
                          unnest_column=inp.name, element_name=kname,
                          value_name=vname)
    kt, vt = inp.dtype.children
    return P.AggregationNode(
        node.id, source=unnest, step=node.step,
        grouping_keys=node.grouping_keys,
        aggregate_names=node.aggregate_names,
        aggregates=(P.AggregateCall(
            "map_agg", (ex.field(kname, kt), ex.field(vname, vt)),
            calls[0].result_type),))


class QueryCtx:
    """Per-query context: the device the query runs on, its config and
    its memory pool. There is no default device: a query on a CUDA card
    names it, so it never lands on the host by omission. Parity:
    velox/core/QueryCtx.h:33."""

    def __init__(self, device, config: Optional[Dict] = None):
        self.device = torch.device(device)
        self.config = dict(config or {})
        self.query_config = QueryConfig(self.config)
        # the query's pool under the process's device root
        cap = self.query_config.get_int(
            QueryConfig.QUERY_HBM_CAP_BYTES, 0)
        self.memory_pool = MemoryPool(f"query-{id(self):x}", cap or None,
                                      parent=MemoryPool.device_root())


class Task:
    """Serial single-fragment execution (Task::next parity)."""

    def __init__(self, plan: P.PlanNode, ctx: QueryCtx):
        self.plan = plan
        self.ctx = ctx
        self.operators: List[Operator] = []  # for stats
        self._error_counts: List[torch.Tensor] = []
        # probe-side scans started before their join's build runs:
        # node id -> a live TableScanOperator (its prefetch running)
        self._prewarmed_scans: Dict[str, TableScanOperator] = {}

    def _spill_kwargs(self, budget_key: str,
                      switch_key: Optional[str]) -> dict:
        """An ``OffloadBuffer``'s arguments: its device budget (4 GiB by
        default; None when the operator class's spill switch is off), the
        query's pool and the disk-tier knobs (parity: the reference's
        ``Task._spill_kwargs`` and its budget reads)."""
        qc = self.ctx.query_config
        on = switch_key is None or qc.get_bool(switch_key, True)
        hb = qc.get_int(QueryConfig.OFFLOAD_HOST_BUDGET_BYTES, 0)
        sd = qc.get_str(QueryConfig.SPILL_DIR)
        ms = qc.get_int(QueryConfig.MAX_SPILL_BYTES, 0)
        return {"budget_bytes": qc.get_int(budget_key, 4 << 30) if on
                else None,
                "pool": self.ctx.memory_pool,
                "host_budget_bytes": hb or None,
                "spill_dir": sd or None,
                "max_spill_bytes": ms or None}

    def _build_buffer(self, switch_key: Optional[str]) -> OffloadBuffer:
        """A join build's buffer under ``JOIN_BUILD_OFFLOAD_BYTES``."""
        return OffloadBuffer(metric_key=M.K_JOIN_BUILD_OFFLOADS,
                             **self._spill_kwargs(
                                 QueryConfig.JOIN_BUILD_OFFLOAD_BYTES,
                                 switch_key))

    # ---- public API --------------------------------------------------------

    def _strip_errors(self, batch: DeviceBatch) -> DeviceBatch:
        """Detach a batch's checked-op error count into the task total
        (one device scalar per batch; read once at query end)."""
        if batch is not None and batch.errors is not None:
            self._error_counts.append(batch.errors)
            batch = DeviceBatch(batch.columns, batch.mask)
        return batch

    def check_errors(self) -> None:
        """Raise VeloxUserError if any checked operation failed.
        Parity: Task::setError (exec/Task.cpp:2574)."""
        if not self._error_counts:
            return
        total = int(sum(self._error_counts).item())
        self._error_counts = []
        if total:
            from velox_tpu_torch.common.errors import (
                VeloxUserError, traced_error_suffix,
            )
            raise VeloxUserError(
                f"{total} row(s) failed a checked operation (division by "
                "zero, integer overflow, or invalid cast); wrap the "
                "expression in TRY(...) to get NULLs instead"
                + traced_error_suffix())

    def batches(self) -> Iterator[DeviceBatch]:
        try:
            for b in self._run_node(self.plan):
                yield self._strip_errors(b)
        finally:
            # finished, closed early or raised: stop every scan's
            # producer, those of prewarmed scans never driven included
            for op in self.operators:
                op.close()
            for op in self._prewarmed_scans.values():
                op.close()
            self._prewarmed_scans.clear()

    def run(self):
        """Execute to completion; return a pyarrow Table."""
        import pyarrow as pa

        from velox_tpu_torch.vector.device import to_arrow
        t0 = time.perf_counter()
        out = list(self.batches())
        self.check_errors()
        tables = [to_arrow(b) for b in out]
        M.record_counter(M.K_TASK_QUERIES)
        M.record_histogram(M.K_QUERY_WALL_MS,
                           (time.perf_counter() - t0) * 1e3)
        for t in tables:
            M.record_counter(M.K_OUTPUT_ROWS, t.num_rows)
            M.record_counter(M.K_OUTPUT_BYTES, t.nbytes)
        if not tables:
            schema = T.to_arrow(self.plan.output_type())
            return pa.table({n: pa.array([], type=f.type)
                             for n, f in zip(schema.names, schema)})
        return pa.concat_tables(tables)

    def stats(self):
        return [op.stats.as_dict() for op in self.operators]

    # ---- pipeline construction ----------------------------------------------

    def _run_node(self, node: P.PlanNode) -> Iterator[DeviceBatch]:
        """Recursively build + drive the pipeline rooted at `node`."""
        if isinstance(node, P.ValuesNode):
            yield from self._drive_source(
                ValuesOperator(node, self.ctx.device))
        elif isinstance(node, P.ArrowStreamNode):
            yield from self._drive_source(
                ArrowStreamOperator(node, self.ctx.device))
        elif isinstance(node, P.TableScanNode) and node.filter is None:
            yield from self._drive_source(self._make_scan(node))
        elif isinstance(node, (P.TableScanNode, P.FilterNode,
                               P.ProjectNode)):
            # the whole Filter/Project chain, including a pushed-down scan
            # filter, runs as one fused step over the bare source
            chain = collapse_chain(node)
            op = FilterProjectOperator(node, chain_fn(chain))
            yield from self._drive(chain.source, op)
        elif isinstance(node, P.AggregationNode) \
                and _map_union_plan(node) is not None:
            yield from self._run_node(_map_union_plan(node))
        elif isinstance(node, P.AggregationNode):
            chain = collapse_chain(node.source)
            if self._streams(node):
                yield from self._drive(node.source,
                                       StreamingAggregationOperator(node))
                return

            qc = self.ctx.query_config

            def mk_agg(pre):
                return AggregationOperator(
                    node, self.ctx.device, pre_fn=pre,
                    host_offload=qc.get_bool(QueryConfig.AGG_HOST_OFFLOAD),
                    compact_threshold=qc.get_int(
                        QueryConfig.AGG_COMPACT_THRESHOLD, 8),
                    abandon_min_rows=qc.get_int(
                        QueryConfig.ABANDON_PARTIAL_AGG_MIN_ROWS, 100_000),
                    abandon_min_pct=float(qc.get(
                        QueryConfig.ABANDON_PARTIAL_AGG_MIN_PCT, 0.8)))
            # the fused one-pass kernel for Q6-shaped global sums
            op = self._try_filter_sum(node, chain, mk_agg)
            if op is None:
                op = mk_agg(None if chain.is_identity else chain_fn(chain))
            yield from self._drive(chain.source, op)
        elif isinstance(node, P.OrderByNode):
            yield from self._drive(node.source, OrderByOperator(
                node, OffloadBuffer(metric_key=M.K_SORT_OFFLOADS,
                                    **self._spill_kwargs(
                                        QueryConfig.SORT_OFFLOAD_BYTES,
                                        QueryConfig.ORDERBY_SPILL_ENABLED))))
        elif type(node) in _UNARY:
            yield from self._drive(node.source, _UNARY[type(node)](node))
        elif isinstance(node, P.HashJoinNode):
            yield from self._run_join(node)
        elif isinstance(node, P.MergeJoinNode):
            yield from self._run_merge_join(node)
        elif isinstance(node, P.NestedLoopJoinNode):
            yield from self._run_nested_loop_join(node)
        elif isinstance(node, P.LimitNode):
            # OrderBy + Limit(offset=0) => TopN: a bounded key-only sort
            # per batch instead of a full sort (parity: the Limit-over-
            # OrderBy plans Presto lowers to TopNNode)
            if (isinstance(node.source, P.OrderByNode)
                    and node.offset == 0 and 0 < node.count <= (1 << 20)):
                ob = node.source
                tn = P.TopNNode(f"{node.id}-topn", source=ob.source,
                                keys=ob.keys, orders=ob.orders,
                                count=node.count)
                yield from self._drive(ob.source, TopNOperator(tn))
            else:
                yield from self._drive(node.source, LimitOperator(node))
        else:
            item = _UNPORTED.get(type(node), "A")
            raise NotImplementedError(
                f"no operator for {type(node).__name__} in velox_tpu_torch "
                f"(ROADMAP {item})")

    def _streams(self, node: P.AggregationNode) -> bool:
        """An aggregation whose source is an OrderBy led by exactly its
        grouping keys streams (velox StreamingAggregation.h:29, chosen
        when the source declares its order)."""
        src = node.source
        if not isinstance(src, P.OrderByNode) or not \
                self.ctx.query_config.get_bool(
                    QueryConfig.STREAMING_AGG_ENABLED, True):
            return False
        knames = {k.name for k in node.grouping_keys}
        prefix = {k.name for k in src.keys[:len(knames)]}
        return (len(src.keys) >= len(knames) and prefix == knames
                and streaming_supported(node))

    def _run_join(self, node: P.HashJoinNode, dynamic: bool = True
                  ) -> Iterator[DeviceBatch]:
        return self._build_then_probe(
            node, HashBuildStage(
                node.right_keys, array_range=array_join_range(node),
                key_ranges=build_key_ranges(node),
                buffer=self._build_buffer(QueryConfig.JOIN_SPILL_ENABLED)),
            HashJoinOperator(node), dynamic)

    def _run_merge_join(self, node: P.MergeJoinNode
                        ) -> Iterator[DeviceBatch]:
        """The presorted build's order is checked once; probes
        binary-search it. Key tuples beyond one packed lane run as a hash
        join (with no dynamic filter: the reference's merge join pushes
        none)."""
        if not packable_words([k.dtype for k in node.right_keys]):
            return self._run_join(P.HashJoinNode(
                node.id, left=node.left, right=node.right,
                join_type=node.join_type, left_keys=node.left_keys,
                right_keys=node.right_keys, filter=node.filter,
                output_columns=node.output_columns), dynamic=False)
        return self._build_then_probe(node, MergeBuildStage(
            node.right_keys, buffer=self._build_buffer(None)),
            MergeJoinOperator(node))

    def _build_then_probe(self, node, build, probe, dynamic: bool = False
                          ) -> Iterator[DeviceBatch]:
        """The build pipeline runs to completion (JoinBridge parity), then
        the probe pipeline streams through the join; the probe side's
        scans start first. With ``dynamic``, the build may push a filter
        onto the probe side or finish the join early: the probe scans
        then wait for a build batch that holds a row."""
        gate = threading.Event() if (
            dynamic and self._pushes_dynamic_filter(node)
            and self.ctx.query_config.get_bool(
                QueryConfig.HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD, True)
        ) else None
        started = self._prewarm_probe_scans(node.left, gate)
        try:
            for batch in self._run_node(node.right):
                batch = self._strip_errors(batch)
                if gate is not None and not gate.is_set() \
                        and bool(batch.mask.any()):
                    gate.set()
                build.add_input(batch)
            table = build.finish()
        finally:
            # a build that raised or was abandoned keeps no pool bytes or
            # spill files (after finish there is nothing left to drop)
            build.close()
        probe.set_built_table(table)
        left = (self._maybe_push_dynamic_filter(node, table) if dynamic
                else node.left)
        if left is None:  # an empty build: no probe pipeline at all
            for scan_id in started:
                scan = self._prewarmed_scans.pop(scan_id, None)
                if scan is not None:
                    scan.close()
            return
        if gate is not None:
            gate.set()
        yield from self._drive(left, probe)

    def _pushes_dynamic_filter(self, node: P.HashJoinNode) -> bool:
        """Dynamic filters are on, the join drops unmatched probe rows
        (inner, left semi), and it is not an array-mode join over a
        unique build, whose domain lookup rejects out-of-range keys at no
        cost."""
        return (self.ctx.query_config.get_bool(QueryConfig.DYNAMIC_FILTERS,
                                               True)
                and node.join_type in _FILTERED_JOINS
                and not (array_join_range(node) is not None and any(
                    resolve_column_unique(node.right, k.name)
                    for k in node.right_keys)))

    def _maybe_push_dynamic_filter(self, node: P.HashJoinNode,
                                   table: SortedBuild
                                   ) -> Optional[P.PlanNode]:
        """The probe side with the build keys' summary as a filter, or
        None when an inner/semi join's build has no usable row (the early
        finish). Parity: the reference's Task._maybe_push_dynamic_filter
        (HashProbe dynamic filters, exec/HashProbe.cpp:393, and
        Driver::pushdownFilters, exec/Driver.cpp:613).

        Only joins ``_pushes_dynamic_filter`` accepts get one; raw-string
        keys have no summary. The summaries (the usable row count, each
        key's min, max and first 64 usable values) are reduced on the
        device and read in one host read."""
        qc = self.ctx.query_config
        left = node.left
        if not self._pushes_dynamic_filter(node) \
                or has_raw_key(table.batch, node.right_keys):
            return left
        batch = table.batch
        cap = batch.capacity
        keys = key_values(batch, node.right_keys)
        ok = usable_rows(batch, keys)
        # keys whose summary can become a predicate: integral, DATE and
        # short DECIMAL (a long decimal's summary would need both limbs)
        summarized = [i for i, lk in enumerate(node.left_keys)
                      if (lk.dtype.is_integral
                          or lk.dtype.kind in (T.TypeKind.DATE,
                                               T.TypeKind.DECIMAL))
                      and not lk.dtype.is_long_decimal]
        parts = [ok.sum(dtype=torch.int64).reshape(1)]
        pos = torch.cumsum(ok.to(torch.int64), 0) - 1
        tgt = torch.where(ok & (pos < 64), pos, 64)
        for i in summarized:
            d = keys[i].full_data(cap).to(torch.int64)
            big = torch.iinfo(torch.int64).max
            first = torch.zeros((65,), dtype=torch.int64, device=d.device)
            first[tgt] = d
            parts += [torch.where(ok, d, big).min().reshape(1),
                      torch.where(ok, d, -big).max().reshape(1),
                      first[:64]]
        host = torch.cat(parts).tolist()
        n_usable = host[0]
        if n_usable == 0:
            if qc.get_bool(QueryConfig.HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD,
                           True):
                return None
            return left
        lt = left.output_type()
        preds = []
        for j, i in enumerate(summarized):
            lk = node.left_keys[i]
            lo, hi = host[1 + 66 * j], host[2 + 66 * j]
            small = host[3 + 66 * j:3 + 66 * j + min(n_usable, 64)]
            f = ex.field(lk.name, lt.field_type(lk.name))
            if n_usable <= 64:
                preds.append(ex.Call(T.BOOLEAN, "in", (f,) + tuple(
                    ex.Constant(lk.dtype, v) for v in sorted(set(small)))))
            else:
                preds.append(ex.Call(T.BOOLEAN, "between", (
                    f, ex.Constant(lk.dtype, lo),
                    ex.Constant(lk.dtype, hi))))
        if not preds:
            return left
        pred = preds[0]
        for p in preds[1:]:
            pred = ex.Call(T.BOOLEAN, "and", (pred, p))
        M.record_counter(M.K_JOIN_DYN_FILTERS)
        return P.FilterNode(f"{node.id}-dynfilter", source=left,
                            predicate=pred)

    def _run_nested_loop_join(self, node: P.NestedLoopJoinNode
                              ) -> Iterator[DeviceBatch]:
        """The whole build side first (one concatenated batch), then the
        probe pipeline streams through the product."""
        self._prewarm_probe_scans(node.left)
        builds = [self._strip_errors(b) for b in self._run_node(node.right)]
        if not builds:
            raise RuntimeError("empty nested-loop build side")
        op = NestedLoopJoinOperator(node)
        op.set_build(concat_batches(builds))
        yield from self._drive(node.left, op)

    def _try_filter_sum(self, node: P.AggregationNode, chain, mk_agg):
        """Kernel pushdown: global sum(a*b) over a range-filtered scan runs
        as one fused pass (ops/filter_reduce.py). Returns the operator,
        or None when the plan or the connector's stats don't match; a
        batch the kernel cannot take falls back to ``mk_agg`` with the
        fused chain."""
        from velox_tpu_torch.ops.filter_reduce import (
            FilterSumOperator, match_filter_sum,
        )
        if not isinstance(chain.source, P.TableScanNode):
            return None
        try:
            conn = get_connector(chain.source.connector_id)
        except KeyError:
            return None
        stats_fn = getattr(conn, "column_stats", None)
        if stats_fn is None:
            return None
        stats = {}
        for c in chain.source.output_type().names:
            s = stats_fn(chain.source.table, c)
            if s is not None:
                stats[c] = s
        spec = match_filter_sum(node, chain, stats)
        if spec is None:
            return None
        M.record_counter(M.K_FILTER_SUM_KERNEL)
        return FilterSumOperator(node, spec, self.ctx.device,
                                 lambda: mk_agg(chain_fn(chain)))

    def _prewarm_probe_scans(self, left: P.PlanNode,
                             gate: Optional[threading.Event] = None
                             ) -> List[str]:
        """Start the probe side's scans (and their producer threads)
        before the build side runs, so that the probe's generation and
        upload overlap the build: the analogue of velox running HashBuild
        and the probe pipeline as concurrent drivers. Their producers wait
        for ``gate``, when given. Returns the scans' node ids."""
        started: List[str] = []

        def walk(n: P.PlanNode) -> None:
            if isinstance(n, P.TableScanNode) \
                    and n.id not in self._prewarmed_scans:
                self._prewarmed_scans[n.id] = self._make_scan(n, gate)
                started.append(n.id)
                M.record_counter(M.K_SCAN_PREWARMED)
            for s in n.sources:
                walk(s)
        walk(left)
        return started

    def _make_scan(self, node: P.TableScanNode,
                   gate: Optional[threading.Event] = None
                   ) -> TableScanOperator:
        warm = self._prewarmed_scans.pop(node.id, None)
        if warm is not None:
            return warm
        conn = get_connector(node.connector_id)
        source = conn.create_data_source(node.table, node.columns, self.ctx)
        splits = conn.default_splits(node.table)
        # a producer thread by default on a CUDA device, where it overlaps
        # host generation and the upload with the device's work; on the
        # CPU the query's work runs on the same cores as the generator
        default = 2 if self.ctx.device.type == "cuda" else 0
        depth = self.ctx.query_config.get_int(
            QueryConfig.SCAN_PREFETCH_DEPTH, default)
        return TableScanOperator(node, source, splits, prefetch=depth,
                                 gate=gate)

    # ---- driver loop (Driver::runInternal parity) ---------------------------

    def _drive(self, source_node: P.PlanNode, op: Operator
               ) -> Iterator[DeviceBatch]:
        self.operators.append(op)
        st = op.stats
        for batch in self._run_node(source_node):
            batch = self._strip_errors(batch)
            M.record_counter(M.K_TASK_BATCHES)
            t0 = time.perf_counter_ns()
            op.add_input(batch)
            st.add_input_wall_ns += time.perf_counter_ns() - t0
            st.input_batches += 1
            st.input_bytes += batch.nbytes
            while True:
                t0 = time.perf_counter_ns()
                out = op.get_output()
                st.get_output_wall_ns += time.perf_counter_ns() - t0
                if out is None:
                    break
                st.output_batches += 1
                st.output_bytes += out.nbytes
                yield out
        t0 = time.perf_counter_ns()
        op.no_more_input()
        st.finish_wall_ns += time.perf_counter_ns() - t0
        while True:
            out = op.get_output()
            if out is None:
                break
            st.output_batches += 1
            st.output_bytes += out.nbytes
            yield out
        # operators that evaluate expressions inside their own steps (the
        # aggregation's fused chain and inputs) hand over their error
        # counts here
        self._error_counts.extend(getattr(op, "error_scalars", ()))

    def _drive_source(self, op: SourceOperator) -> Iterator[DeviceBatch]:
        self.operators.append(op)
        st = op.stats
        while not op.is_finished():
            t0 = time.perf_counter_ns()
            out = op.get_output()
            st.get_output_wall_ns += time.perf_counter_ns() - t0
            if out is None:
                break
            st.output_batches += 1
            st.output_bytes += out.nbytes
            yield out

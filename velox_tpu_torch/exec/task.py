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
(exec/misc_ops.py), Window, RowNumber and TopNRowNumber (exec/window.py),
TableWrite (exec/writer.py, through a connector's DataSink), LocalPartition
and LocalMerge, and the multi-fragment exchange (exec/exchange.py):
PartitionedOutput, Exchange and MergeExchange. An aggregation over an
OrderBy on its grouping keys streams (exec/streaming_agg.py, unless
``STREAMING_AGG_ENABLED`` is false), and one whose aggregate is
``map_union`` runs as an Unnest of the maps and a ``map_agg`` of their
entries.

*Plan fragments* (exec/exchange.py). A PartitionedOutput sinks its rows
into the OutputBuffer of the task named by the ``task.id`` setting and
emits nothing; a Task that fails poisons that buffer. An Exchange pulls
destination ``task.destination``'s pages from the tasks listed under
``exchange.<node id>.tasks`` (or ``exchange.tasks``) through the
registered transport, and uploads them onto the query's device with the
``exchange.batch_capacity``, the ``exchange.<node id>.dictionaries`` and
a queue bound of ``exchange.max_queue_bytes``. A MergeExchange drains its
pages and sorts them once on the device. Distributed execution over a
mesh of shards is parallel/distributed.py's ``DistributedTask``.

*Local exchange* (exec/local_exchange.py). A LocalPartition runs
``LOCAL_EXCHANGE_DRIVERS`` driver threads (1 by default; 0 runs the node
inline), each over its slice of the splits of the scans that feed its
probe pipeline, into one queue bounded by
``MAX_LOCAL_EXCHANGE_BUFFER_BYTES``. A join under the boundary builds
once, from every split of its build side, and its drivers share the
table (Velox's HashJoinBridge; the reference slices the build side too
and loses rows, ROADMAP C). A LocalMerge runs as an OrderBy.
*Grouped execution* (``GroupedTask``): one Task per bucket of the
bucketed scans, each scan pinned to its group's splits through the
``splits.<node id>`` setting, which any scan honours. A scan's filter (or
``prune_filter``) drops the splits that a connector's ``prune_splits``
proves empty.

*Debugging and tracing.* ``TRACE_ENABLED`` with ``TRACE_DIR`` records
the plan and the input batches of the operators of ``TRACE_NODE_IDS``
(all when empty) for exec/trace.py's replay. ``DEBUG_SYNC_OPERATORS``
synchronizes the device after each operator call on a CUDA device, so
operator walls hold their device time. ``DEBUG_DISABLE_CSE`` turns off
the evaluator's common-subexpression cache for the run. The query
(``run``, from the Task's making) and each operator call (``add_input``,
``get_output``, ``finish``, a join's build) run inside a
common/process_trace.py span, whose two clock readings are also the
operator's ``OperatorStats`` walls: host time, which holds the device's
time only under ``DEBUG_SYNC_OPERATORS``. ``print_plan_with_stats``
renders the plan with each operator's batches, bytes and walls.

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
from contextlib import contextmanager
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
from velox_tpu_torch.common import testvalue as TV
from velox_tpu_torch.common import process_trace as PT
from velox_tpu_torch.exec.batch_utils import concat_batches
from velox_tpu_torch.exec.fuse import chain_fn, collapse_chain
from velox_tpu_torch.exec.local_exchange import LocalExchangeQueue
from velox_tpu_torch.exec.join import (
    HashBuildStage, HashJoinOperator, MergeBuildStage, MergeJoinOperator,
    SortedBuild, array_join_range, build_key_ranges, has_raw_key,
    int_storage_type, key_summaries,
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
from velox_tpu_torch.exec.writer import TableWriterOperator
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
# joins that emit build rows after the probe: one prober must see them all
_BUILD_SIDE_JOINS = (P.JoinType.RIGHT, P.JoinType.FULL,
                     P.JoinType.RIGHT_SEMI_FILTER)


def limit_as_top_n(node: P.LimitNode) -> Optional[P.TopNNode]:
    """A Limit (offset 0) over an OrderBy as a TopN: a bounded key-only
    sort per batch instead of a full sort (parity: the Limit-over-OrderBy
    plans Presto lowers to TopNNode), or None."""
    ob = node.source
    if (isinstance(ob, P.OrderByNode) and node.offset == 0
            and 0 < node.count <= (1 << 20)):
        return P.TopNNode(f"{node.id}-topn", source=ob.source,
                          keys=ob.keys, orders=ob.orders, count=node.count)
    return None


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

    def get(self, key, default=None):
        return self.config.get(key, default)


class Task:
    """Serial single-fragment execution (Task::next parity)."""

    def __init__(self, plan: P.PlanNode, ctx: QueryCtx):
        # the query's span opens here and closes when ``run`` returns
        self._opened = PT.clock()
        self.plan = plan
        self.ctx = ctx
        self.operators: List[Operator] = []  # for stats
        self._error_counts: List[torch.Tensor] = []
        # probe-side scans started before their join's build runs:
        # node id -> a live TableScanOperator (its prefetch running)
        self._prewarmed_scans: Dict[str, TableScanOperator] = {}
        # a local exchange's driver thread: its (index, count) split
        # slice, None while it runs a join's build side
        self._driver = threading.local()
        # join builds that the drivers of a local exchange share
        self._shared_builds: Dict[str, "_SharedBuild"] = {}
        self._shared_lock = threading.Lock()
        qc = ctx.query_config
        self._sync_ops = qc.get_bool(QueryConfig.DEBUG_SYNC_OPERATORS)
        self._trace_dir = (qc.get_str(QueryConfig.TRACE_DIR)
                           if qc.get_bool(QueryConfig.TRACE_ENABLED) else "")
        ids = qc.get_str(QueryConfig.TRACE_NODE_IDS)
        self._trace_ids = set(x for x in ids.split(",") if x) or None
        self._trace_writers: Dict[str, object] = {}
        self._trace_lock = threading.Lock()
        if self._trace_dir:
            from velox_tpu_torch.exec.trace import write_plan
            write_plan(self._trace_dir, plan)

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
            for w in self._trace_writers.values():
                w.close()
            self._trace_writers = {}

    def run(self):
        """Execute to completion; return a pyarrow Table. The query's
        span (layer ``task``) runs from the Task's making to the return."""
        with PT.Span(PT.site("query", self.plan.id), start=self._opened):
            return self._run()

    def _run(self):
        import pyarrow as pa

        from velox_tpu_torch.expression import eval as ev
        from velox_tpu_torch.vector.device import to_arrow
        t0 = time.perf_counter()
        cse_off = self.ctx.query_config.get_bool(
            QueryConfig.DEBUG_DISABLE_CSE)
        if cse_off:
            ev.set_cse_disabled(True)
        try:
            out = list(self.batches())
            self.check_errors()
        except BaseException as e:
            self._terminate(e)
            raise
        finally:
            if cse_off:
                ev.set_cse_disabled(False)
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

    def total_hbm_bytes(self) -> int:
        """Lower-bound device-memory traffic model: every operator reads
        its input batches and writes its output batches at least once.
        The byte count of a roofline share for a whole query."""
        return sum(op.stats.input_bytes + op.stats.output_bytes
                   for op in self.operators)

    def print_plan_with_stats(self) -> str:
        """The plan tree with each operator's batches, bytes and walls.
        The walls are host time (the operator's calls, a join's build
        finish): on a CUDA device they hold the device's time only under
        ``DEBUG_SYNC_OPERATORS``. Parity: velox printPlanWithStats
        (TpchBenchmark.cpp:82-103)."""
        by_node: Dict[str, List] = {}
        for op in self.operators:
            by_node.setdefault(op.stats.plan_node_id, []).append(op.stats)

        def fmt(node: P.PlanNode, indent: int) -> List[str]:
            pad = "  " * indent
            lines = [f"{pad}- {node.name}[{node.id}]"]
            for st in by_node.get(node.id, []):
                ms = (st.add_input_wall_ns + st.get_output_wall_ns
                      + st.finish_wall_ns) / 1e6
                extra = (f" (+build {st.build_wall_ns / 1e6:.1f} ms)"
                         if st.build_wall_ns else "")
                lines.append(
                    f"{pad}    {st.operator_type}: in={st.input_batches} "
                    f"out={st.output_batches} batches "
                    f"({st.input_bytes / 1e6:.0f}/"
                    f"{st.output_bytes / 1e6:.0f} MB), {ms:.1f} ms{extra}")
            for s in node.sources:
                lines.extend(fmt(s, indent + 1))
            return lines

        return "\n".join(fmt(self.plan, 0))

    def _sync(self) -> None:
        """``DEBUG_SYNC_OPERATORS``: wait for the device's queued work, so
        that the operator call's wall holds it (nothing on the CPU, whose
        work is done when the call returns)."""
        if self._sync_ops and self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)

    def _maybe_trace(self, op: Operator, batch: DeviceBatch) -> None:
        """Record an operator's input batch for replay (Operator::
        traceInput, exec/Operator.h:437)."""
        if not self._trace_dir:
            return
        nid = op.stats.plan_node_id
        if self._trace_ids is not None and nid not in self._trace_ids:
            return
        with self._trace_lock:
            w = self._trace_writers.get(nid)
            if w is None:
                from velox_tpu_torch.exec.trace import TraceWriter
                w = self._trace_writers[nid] = TraceWriter(self._trace_dir,
                                                           nid)
            w.record(batch)

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
        elif isinstance(node, P.TableWriteNode):
            yield from self._drive(node.source,
                                   TableWriterOperator(node, self.ctx.device))
        elif isinstance(node, P.LocalPartitionNode):
            n = self.ctx.query_config.get_int(
                QueryConfig.LOCAL_EXCHANGE_DRIVERS, 1)
            if n >= 1:
                yield from self._run_local_partition(node, n)
            else:  # inline
                yield from self._run_node(node.source)
        elif isinstance(node, P.LocalMergeNode):
            # the merge of the gathered runs is a sort, as in the reference
            yield from self._run_node(P.OrderByNode(
                node.id, source=node.source, keys=node.keys,
                orders=node.orders))
        elif isinstance(node, P.LimitNode):
            tn = limit_as_top_n(node)
            if tn is not None:
                yield from self._drive(tn.source, TopNOperator(tn))
            else:
                yield from self._drive(node.source, LimitOperator(node))
        elif isinstance(node, P.PartitionedOutputNode):
            from velox_tpu_torch.exec.exchange import (
                PartitionedOutputOperator,
            )
            op = PartitionedOutputOperator(
                node, self.ctx.get("task.id", "task-0"), self.ctx.device)
            # a sink: drive it to completion, emit nothing
            for _ in self._drive(node.source, op):
                pass
        elif isinstance(node, (P.ExchangeNode, P.MergeExchangeNode)):
            yield from self._run_exchange(node)
        else:
            raise NotImplementedError(
                f"no operator for {type(node).__name__} in velox_tpu_torch")

    def _run_exchange(self, node) -> Iterator[DeviceBatch]:
        """The pages of this task's destination from the remote tasks;
        a MergeExchange re-establishes the total order with one device
        sort over the drained pages (see MergeExchangeNode)."""
        from velox_tpu_torch.exec.exchange import ExchangeOperator
        from velox_tpu_torch.exec.orderby import sort_batch
        ctx = self.ctx
        op = ExchangeOperator(
            node, ctx.get(f"exchange.{node.id}.tasks")
            or ctx.get("exchange.tasks") or [],
            ctx.get("task.destination", 0), ctx.device,
            ctx.get("exchange.batch_capacity"),
            ctx.get(f"exchange.{node.id}.dictionaries"),
            ctx.get("exchange.max_queue_bytes"))
        pages = self._drive_source(op)
        if not isinstance(node, P.MergeExchangeNode):
            yield from pages
            return
        got = list(pages)
        if got:
            yield sort_batch(concat_batches(got), list(node.keys),
                             list(node.orders))

    def _terminate(self, e: BaseException) -> None:
        """Task::terminate parity (exec/Task.cpp:1934): a failing
        fragment poisons its output buffer, so its consumer fragments
        abort instead of waiting on a never-finished stream."""
        from velox_tpu_torch.exec.exchange import PartitionedOutputOperator
        for op in self.operators:
            if isinstance(op, PartitionedOutputOperator):
                op.terminate(f"{type(e).__name__}: {e}")

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
        then wait for a build batch that holds a row. Under a local
        exchange the drivers share one build of every split."""
        gate, started = None, []
        drv = self._slice()
        if drv is not None:
            if drv[1] > 1 and node.join_type in _BUILD_SIDE_JOINS:
                build.close()
                raise NotImplementedError(
                    f"a {node.join_type.value} join emits its unmatched "
                    "build rows once; it cannot run under a LocalPartition "
                    "with more than one driver")
            try:
                table, build_ns = self._shared_build(
                    node.id, lambda: self._build(node, build, None))
            finally:
                build.close()  # the stage of a driver that did not build
        else:
            if dynamic and self._pushes_dynamic_filter(node) \
                    and self.ctx.query_config.get_bool(
                        QueryConfig.HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD,
                        True):
                gate = threading.Event()
            started = self._prewarm_probe_scans(node.left, gate)
            table, build_ns = self._build(node, build, gate)
        probe.stats.build_wall_ns = build_ns
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

    def _slice(self):
        """This thread's (index, count) split slice when it is a local
        exchange's driver running its probe pipeline, else None."""
        return getattr(self._driver, "slice", None)

    @contextmanager
    def _every_split(self):
        """A join's build side reads every split, in a driver too."""
        drv = self._slice()
        self._driver.slice = None
        try:
            yield
        finally:
            self._driver.slice = drv

    def _build(self, node, build, gate: Optional[threading.Event]):
        """Run a join's build pipeline over every split and finish its
        table: returns the table and the nanoseconds of its finish."""
        add = PT.site(node.name, node.id, "build_input")
        try:
            with self._every_split():
                for batch in self._run_node(node.right):
                    batch = self._strip_errors(batch)
                    if gate is not None and not gate.is_set() \
                            and bool(batch.mask.any()):
                        gate.set()
                    with PT.Span(add):
                        build.add_input(batch)
            with PT.Span(PT.site(node.name, node.id, "build_finish")) as s:
                table = build.finish()
                self._sync()
            return table, s.end - s.start
        finally:
            # a build that raised or was abandoned keeps no pool bytes or
            # spill files (after finish there is nothing left to drop)
            build.close()

    def _shared_build(self, node_id: str, make):
        """The build of join ``node_id``, made once by the first driver
        that reaches it; the others wait for it and share the table."""
        with self._shared_lock:
            entry = self._shared_builds.setdefault(node_id, _SharedBuild())
        with entry.lock:
            if entry.table is None and entry.error is None:
                try:
                    entry.table = make()
                except BaseException as e:
                    entry.error = e
            if entry.error is not None:
                raise entry.error
            return entry.table

    def _pushes_dynamic_filter(self, node: P.HashJoinNode) -> bool:
        """Dynamic filters are on, the join drops unmatched probe rows
        (inner, left semi), and it is not an array-mode join over a
        unique build, whose domain lookup rejects out-of-range keys at no
        cost. Decided from the plan before the build: a build that takes
        array mode from its own key range still pushes its filter."""
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
        device and read in one host read; a build that read its key's
        range at finish (``SortedBuild.key_range``) needs no other read
        unless it holds 1 to 64 usable rows."""
        qc = self.ctx.query_config
        left = node.left
        if not self._pushes_dynamic_filter(node) \
                or has_raw_key(table.batch, node.right_keys):
            return left
        # keys whose summary can become a predicate
        summarized = [i for i, lk in enumerate(node.left_keys)
                      if int_storage_type(lk.dtype)]
        if table.key_range is not None and not 0 < table.key_range[0] <= 64:
            n_usable, lo, hi = table.key_range
            ranges = [(lo, hi, [])] * len(summarized)
        else:
            n_usable, ranges = key_summaries(table.batch, node.right_keys,
                                             summarized)
        if n_usable == 0:
            if qc.get_bool(QueryConfig.HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD,
                           True):
                return None
            return left
        lt = left.output_type()
        preds = []
        for i, (lo, hi, small) in zip(summarized, ranges):
            lk = node.left_keys[i]
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
        probe pipeline streams through the product. Under a local
        exchange the drivers share one build of every split."""
        def build():
            with self._every_split():
                builds = [self._strip_errors(b)
                          for b in self._run_node(node.right)]
            if not builds:
                raise RuntimeError("empty nested-loop build side")
            with PT.Span(PT.site(node.name, node.id, "build_finish")):
                return concat_batches(builds)

        if self._slice() is not None:
            batch = self._shared_build(node.id, build)
        else:
            self._prewarm_probe_scans(node.left)
            batch = build()
        op = NestedLoopJoinOperator(node)
        op.set_build(batch)
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
        for ``gate``, when given. Returns the scans' node ids. Not below
        a LocalPartition, whose drivers make their own scans."""
        started: List[str] = []

        def walk(n: P.PlanNode) -> None:
            if isinstance(n, P.LocalPartitionNode):
                return
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
        """A scan over the ``splits.<node id>`` setting's splits or the
        connector's default ones, a local exchange's driver taking its
        slice of them, less the splits that the connector's
        ``prune_splits`` proves empty under the scan's filter (or its
        ``prune_filter``)."""
        drv = self._slice()
        if drv is None:
            warm = self._prewarmed_scans.pop(node.id, None)
            if warm is not None:
                return warm
        conn = get_connector(node.connector_id)
        source = conn.create_data_source(node.table, node.columns, self.ctx)
        splits = self.ctx.get(f"splits.{node.id}") \
            or conn.default_splits(node.table, self.ctx)
        if drv is not None:
            i, k = drv
            splits = list(splits)[i::k]
        pf = node.filter if node.filter is not None \
            else getattr(node, "prune_filter", None)
        if pf is not None and hasattr(conn, "prune_splits"):
            splits = conn.prune_splits(node.table, splits, pf)
        # a producer thread by default on a CUDA device, where it overlaps
        # host generation and the upload with the device's work; on the
        # CPU the query's work runs on the same cores as the generator
        default = 2 if self.ctx.device.type == "cuda" else 0
        depth = self.ctx.query_config.get_int(
            QueryConfig.SCAN_PREFETCH_DEPTH, default)
        return TableScanOperator(node, source, splits, prefetch=depth,
                                 gate=gate)

    def _run_local_partition(self, node: P.LocalPartitionNode, n: int
                             ) -> Iterator[DeviceBatch]:
        """``n`` driver threads run the source subtree, each over its
        ``[i::n]`` slice of the probe pipeline's splits, into one
        byte-bounded queue that this generator drains. Its ``finally``
        stops the queue and joins every driver, so that no thread of the
        task launches work once the task is over."""
        q = LocalExchangeQueue(n, max_bytes=self.ctx.query_config.get_int(
            QueryConfig.MAX_LOCAL_EXCHANGE_BUFFER_BYTES, 32 << 20))

        cause, where = PT.current(), PT.site(node.name, node.id, "drive")

        def produce(i):
            try:
                self._driver.slice = (i, n)
                with PT.Span(where, cause=cause):
                    for batch in self._run_node(node.source):
                        TV.adjust("LocalPartition::produce", (i, batch))
                        if not q.put(batch, batch.nbytes):
                            return
                q.producer_done()
            except BaseException as e:  # raised again by the consumer
                q.producer_done(e)
            finally:
                self._driver.slice = None

        threads = [threading.Thread(target=produce, args=(i,), daemon=True,
                                    name=f"velox-lp-{node.id}-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            q.stop()
            for t in threads:
                while t.is_alive():
                    t.join(timeout=0.25)
                    q.stop()  # re-signal in case of a put/stop race

    # ---- driver loop (Driver::runInternal parity) ---------------------------

    # Each operator call runs inside one span, whose start and end are
    # also the call's OperatorStats wall; the sites are built once an
    # operator.

    def _drive(self, source_node: P.PlanNode, op: Operator
               ) -> Iterator[DeviceBatch]:
        self.operators.append(op)
        st = op.stats
        sites = PT.OperatorSites(st.operator_type, st.plan_node_id)
        for batch in self._run_node(source_node):
            batch = self._strip_errors(batch)
            M.record_counter(M.K_TASK_BATCHES)
            TV.adjust("Task::drive::addInput", (op, batch))
            self._maybe_trace(op, batch)
            with PT.Span(sites.add_input) as s:
                op.add_input(batch)
                self._sync()
            st.add_input_wall_ns += s.end - s.start
            st.input_batches += 1
            st.input_bytes += batch.nbytes
            yield from self._outputs(op, sites.get_output, False)
        with PT.Span(sites.finish) as s:
            op.no_more_input()
            self._sync()
        st.finish_wall_ns += s.end - s.start
        yield from self._outputs(op, sites.get_output, False)
        # operators that evaluate expressions inside their own steps (the
        # aggregation's fused chain and inputs) hand over their error
        # counts here
        self._error_counts.extend(getattr(op, "error_scalars", ()))

    def _outputs(self, op: Operator, site: PT.Site, source: bool
                 ) -> Iterator[DeviceBatch]:
        """The operator's output batches, until ``get_output`` returns
        None (a source: or until it is finished)."""
        st = op.stats
        while not (source and op.is_finished()):
            with PT.Span(site) as s:
                out = op.get_output()
                self._sync()
            st.get_output_wall_ns += s.end - s.start
            if out is None:
                return
            st.output_batches += 1
            st.output_bytes += out.nbytes
            yield out

    def _drive_source(self, op: SourceOperator) -> Iterator[DeviceBatch]:
        self.operators.append(op)
        st = op.stats
        yield from self._outputs(op, PT.OperatorSites(
            st.operator_type, st.plan_node_id).get_output, True)


class _SharedBuild:
    """One join's build, shared by the drivers of a local exchange."""

    def __init__(self):
        self.lock = threading.Lock()
        self.table = None
        self.error: Optional[BaseException] = None


class GroupedTask:
    """Grouped execution: the plan runs once per group of leaf splits.

    Role parity: ``velox/exec/Task.h:151-171`` and ``TaskStructs.h:89``
    (ExecutionMode::kGrouped): a bucketed table's splits are grouped by
    bucket and the plan runs group by group, so that a join build or an
    aggregation holds one group's rows at a time. Each group runs as a
    fresh Task on this task's device, its bucketed scans pinned to the
    group's splits through the ``splits.<node id>`` setting. A scan of an
    unbucketed table reads all its splits in every group (velox's mixed
    grouped execution), which suits a broadcast build side. As in the
    reference, the result is right only when the plan's join and group
    keys align with the bucketing.
    """

    def __init__(self, plan: P.PlanNode, ctx: QueryCtx):
        self.plan = plan
        self.ctx = ctx
        self.group_tasks: List[Task] = []
        self._scan_groups = self._collect_groups()

    def _scan_nodes(self) -> List[P.TableScanNode]:
        out = []

        def walk(n):
            if isinstance(n, P.TableScanNode):
                out.append(n)
            for s in n.sources:
                walk(s)
        walk(self.plan)
        return out

    def _collect_groups(self):
        groups: Dict[str, List] = {}
        n_groups = None
        for node in self._scan_nodes():
            conn = get_connector(node.connector_id)
            sg = conn.split_groups(node.table) \
                if hasattr(conn, "split_groups") else None
            if sg:
                if n_groups is None:
                    n_groups = len(sg)
                elif len(sg) != n_groups:
                    raise ValueError(
                        "grouped execution: scans have mismatched "
                        f"group counts ({len(sg)} vs {n_groups})")
                groups[node.id] = sg
        if n_groups is None:
            raise ValueError("grouped execution: no bucketed scan found")
        self.n_groups = n_groups
        return groups

    def run(self):
        import pyarrow as pa
        tables = []
        for g in range(self.n_groups):
            cfg = dict(self.ctx.config)
            for node_id, groups in self._scan_groups.items():
                cfg[f"splits.{node_id}"] = groups[g]
            task = Task(self.plan, QueryCtx(self.ctx.device, cfg))
            self.group_tasks.append(task)
            t = task.run()
            if t.num_rows:
                tables.append(t)
        M.record_counter(M.K_GROUPED_EXECUTIONS)
        if not tables:
            schema = T.to_arrow(self.plan.output_type())
            return pa.table({n: pa.array([], type=f.type)
                             for n, f in zip(schema.names, schema)})
        return pa.concat_tables(tables)

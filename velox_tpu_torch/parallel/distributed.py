"""Distributed plan execution over a mesh of shards.

Counterpart of ``velox_tpu/parallel/distributed.py``. Role parity: the
multi-task topology of the reference engine (N drivers pulling splits,
velox/exec/Task.h:166; LocalPartition/PartitionedOutput exchanges between
pipelines, SURVEY.md §2.9) collapsed onto a mesh, under one controller:

* **split/data parallelism**: scan splits go in waves of n, one split a
  shard (the TPC-H connector cuts each table into n splits for it,
  ``scan.splits_per_table``). A wave is a list of n per-shard batches,
  each on its shard's device (None: no rows); the reference's stacked
  (n, cap) batches and their pytree helpers have no counterpart. Per-shard
  work is the port's own operator code run once a shard (the reference
  vmaps the same operator steps).
* **exchange**: a grouped aggregation's partial states, a partitioned
  join's two sides, a window's and a MarkDistinct's rows repartition by
  their keys (parallel/exchange.py ``repartition``, one host read of the
  (n, n) count matrix each). Global aggregates reduce the shards' states.
* **broadcast join**: the build side is gathered once per distinct device
  and built there; on one card that is one table for every shard.

Shards run in order on each device's current stream, so a moved slice is
ordered before its use; there is no per-shard stream. The reference's
compile cache (``_cjit``) has no counterpart: nothing is compiled.

A Limit over an OrderBy runs as a TopN, as the serial Task runs it (the
reference's mesh sorts every row on one shard). Serial funnels (shard 0
carries the batch, the others are empty), as in the reference: EnforceSingleRow, the nested-loop join, filtered non-inner
joins, global aggregates whose states the scalar reduction cannot combine
(and, here, grouped collect aggregates, whose partial step the reference
cannot run either). A MergeJoin runs as a hash join. Every other node
kind raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import torch

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.connectors.connector import get_connector
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as Pn
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec import join as J
from velox_tpu_torch.exec.aggregation import AggregationOperator
from velox_tpu_torch.exec.batch_utils import concat_batches, slice_batch
from velox_tpu_torch.exec.fuse import chain_fn, collapse_chain
from velox_tpu_torch.exec.operator import ValuesOperator, _hand_over
from velox_tpu_torch.exec.orderby import TopNOperator, _key_ranges, sort_batch
from velox_tpu_torch.exec.task import QueryCtx, limit_as_top_n
from velox_tpu_torch.functions.aggregates import AggregateFunction
from velox_tpu_torch.parallel import exchange as X
from velox_tpu_torch.parallel.mesh import Mesh, make_mesh
from velox_tpu_torch.vector.device import DeviceBatch

Shards = X.Shards


def _resolved(device) -> torch.device:
    """A CUDA device with its index (``cuda`` is the current card)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _concat(batches: List[DeviceBatch]) -> Optional[DeviceBatch]:
    return concat_batches(batches) if batches else None


def _waves(outs: List[List[DeviceBatch]]) -> Iterator[Shards]:
    """Each shard's outputs as waves: a shard's k-th in the k-th."""
    for k in range(max(map(len, outs))):
        yield [o[k] if k < len(o) else None for o in outs]


def _drain(op) -> List[DeviceBatch]:
    out = []
    while True:
        o = op.get_output()
        if o is None:
            return out
        out.append(o)


def _reducible(op: AggregationOperator) -> bool:
    """Every state of the operator's aggregates combines by a scalar
    sum, min or max."""
    return all(type(a).map_raw is not AggregateFunction.map_raw
               and all(st.width == 1 and st.combine in ("sum", "min", "max")
                       for st in a.states)
               for a in op._aggs)


def _empty_like(batch: DeviceBatch, device) -> DeviceBatch:
    """One inactive row shaped as ``batch`` (its dictionaries, raw size
    classes) on ``device``: a shard's build side without rows."""
    one = slice_batch(batch, 0, 1)
    return X.to_device(DeviceBatch(one.columns, torch.zeros_like(one.mask)),
                       device)


class DistributedTask:
    """Executes one plan over every shard of a mesh.

    Parity: velox Task in parallel mode (Task::start, exec/Task.h:172):
    drivers become shards, exchanges become tensor movement between them.
    ``ctx`` defaults to a QueryCtx on the mesh's first device; a ctx on a
    device the mesh does not hold raises.
    """

    def __init__(self, plan: Pn.PlanNode, mesh: Optional[Mesh] = None,
                 ctx=None):
        self.plan = plan
        self.mesh = mesh or make_mesh()
        self.n = self.mesh.size
        self.ctx = ctx or QueryCtx(self.mesh.devices[0])
        devices = [_resolved(d) for d in self.mesh.devices]
        if _resolved(self.ctx.device) not in devices:
            raise ValueError(f"the query's device {self.ctx.device} is not "
                             f"one of the mesh's {self.mesh}")
        self._dev0 = self.mesh.devices[0]
        self._errors: List[torch.Tensor] = []
        # every exchange of the run (parallel/exchange.py ExchangeStats)
        self.exchanges: List[X.ExchangeStats] = []

    # -- public ---------------------------------------------------------------

    def batches(self) -> Iterator[DeviceBatch]:
        """Every shard's output batches; checked-op errors raise once the
        plan is drained."""
        for wave in self._run_node(self.plan):
            for b in wave:
                if b is not None:
                    yield b
        self.check_errors()

    def run(self):
        """Execute to completion; return a pyarrow Table. Each shard's
        batch converts on its own, so ARRAY/MAP outputs keep their
        per-shard element offsets."""
        import pyarrow as pa

        from velox_tpu_torch import types as T
        from velox_tpu_torch.vector.device import to_arrow
        tables = [to_arrow(b) for b in self.batches()]
        if not tables:
            schema = T.to_arrow(self.plan.output_type())
            return pa.table({n: pa.array([], type=f.type)
                             for n, f in zip(schema.names, schema)})
        return pa.concat_tables(tables)

    def _check_errors(self, b: Optional[DeviceBatch]
                      ) -> Optional[DeviceBatch]:
        """Detach the checked-op error count riding a batch into the task
        total (read once, by ``check_errors``)."""
        if b is None or b.errors is None:
            return b
        self._errors.append(b.errors.to(self._dev0))
        return DeviceBatch(b.columns, b.mask)

    def check_errors(self) -> None:
        if not self._errors:
            return
        total = int(sum(self._errors).item())
        self._errors = []
        if total:
            from velox_tpu_torch.common.errors import VeloxUserError
            raise VeloxUserError(
                f"{total} row(s) failed a checked operation (division by "
                "zero, integer overflow, or invalid cast); wrap the "
                "expression in TRY(...) to get NULLs instead")

    # -- plan walk (waves of per-shard batches) ------------------------------

    def _run_node(self, node: Pn.PlanNode) -> Iterator[Shards]:
        for wave in self._dispatch(node):
            yield [self._check_errors(b) for b in wave]

    def _dispatch(self, node: Pn.PlanNode) -> Iterator[Shards]:
        if isinstance(node, (Pn.FilterNode, Pn.ProjectNode)) or (
                isinstance(node, Pn.TableScanNode)
                and node.filter is not None):
            # the whole Filter/Project chain, a pushed-down scan filter
            # included, runs as one fused step a shard
            chain = collapse_chain(node)
            yield from self._map_shards(chain.source, chain_fn(chain))
        elif isinstance(node, Pn.TableScanNode):
            yield from self._run_scan(node)
        elif isinstance(node, Pn.ValuesNode):
            yield from self._run_values(node)
        elif isinstance(node, Pn.AggregationNode):
            yield from self._run_aggregation(node)
        elif isinstance(node, Pn.HashJoinNode):
            yield from self._run_join(node)
        elif isinstance(node, Pn.TopNNode):
            yield from self._run_topn(node)
        elif isinstance(node, (Pn.LocalPartitionNode,
                               Pn.PartitionedOutputNode)):
            yield from self._run_repartition(node)
        elif isinstance(node, Pn.OrderByNode):
            yield from self._run_orderby(node)
        elif isinstance(node, Pn.LimitNode) \
                and limit_as_top_n(node) is not None:
            # a TopN a shard and a final one, as the serial Task runs it,
            # not a gather of every row for one sort
            yield from self._run_topn(limit_as_top_n(node))
        elif isinstance(node, Pn.LimitNode):
            yield from self._run_limit(node)
        elif isinstance(node, Pn.WindowNode):
            yield from self._run_window(node)
        elif isinstance(node, Pn.UnnestNode):
            yield from self._run_unnest(node)
        elif isinstance(node, Pn.MarkDistinctNode):
            yield from self._run_markdistinct(node)
        elif isinstance(node, Pn.NestedLoopJoinNode):
            yield from self._run_nested_loop(node)
        elif isinstance(node, Pn.EnforceSingleRowNode):
            from velox_tpu_torch.exec.misc_ops import EnforceSingleRowOperator
            # scalar-subquery guard: globally <= 1 row by construction
            yield from self._funnel_serial(
                EnforceSingleRowOperator(node), node.source)
        elif isinstance(node, Pn.MergeJoinNode):
            # sortedness is a single-stream property that the exchanges
            # do not keep: a distributed merge join is a hash join
            yield from self._run_join(Pn.HashJoinNode(
                node.id, left=node.left, right=node.right,
                join_type=node.join_type, left_keys=node.left_keys,
                right_keys=node.right_keys, filter=node.filter,
                output_columns=node.output_columns))
        else:
            raise NotImplementedError(
                f"distributed operator for {type(node).__name__}")

    def _to0(self, b: DeviceBatch) -> DeviceBatch:
        return X.to_device(b, self._dev0)

    def _restack_one(self, b: Optional[DeviceBatch]) -> Shards:
        """A serial result as a wave: shard 0 carries it."""
        return [b] + [None] * (self.n - 1)

    def _stats(self, kind: str) -> X.ExchangeStats:
        s = X.ExchangeStats(kind)
        self.exchanges.append(s)
        return s

    def _gather0(self, waves, kind: str) -> Optional[DeviceBatch]:
        """Every shard's rows of every wave, concatenated on shard 0."""
        rows = [b for w in waves for b in w if b is not None]
        if not rows:
            return None
        stats = self._stats(kind)
        stats.rows += sum(b.capacity for b in rows)
        out = concat_batches([self._to0(b) for b in rows])
        stats.bytes += out.nbytes
        return out

    def _funnel_serial(self, op, source_node) -> Iterator[Shards]:
        """Drive a serial operator on shard 0 over every shard's batches,
        re-emitting its outputs as one-shard waves (the single-driver
        final stage; the reference likewise funnels stages whose parallel
        form does not exist)."""
        for wave in self._run_node(source_node):
            for b in wave:
                if b is None:
                    continue
                op.add_input(self._to0(b))
                for o in _drain(op):
                    yield self._restack_one(o)
        op.no_more_input()
        for o in _drain(op):
            yield self._restack_one(o)
        self._errors.extend(getattr(op, "error_scalars", ()))

    def _run_nested_loop(self, node) -> Iterator[Shards]:
        """Both sides funnel to shard 0: nested-loop joins in practice are
        scalar-subquery joins over tiny sides, and the reference funnels
        them the same way."""
        from velox_tpu_torch.exec.misc_ops import NestedLoopJoinOperator
        build = self._gather0(list(self._run_node(node.right)), "gather")
        if build is None:
            raise RuntimeError("empty nested-loop build side")
        op = NestedLoopJoinOperator(node)
        op.set_build(build)
        yield from self._funnel_serial(op, node.left)

    # -- sources ---------------------------------------------------------------

    def _run_scan(self, node: Pn.TableScanNode) -> Iterator[Shards]:
        conn = get_connector(node.connector_id)
        # a full wave of splits per scan (one per shard)
        self.ctx.config.setdefault("scan.splits_per_table", self.n)
        source = conn.create_data_source(node.table, node.columns, self.ctx)
        splits = self.ctx.get(f"splits.{node.id}") \
            or conn.default_splits(node.table, self.ctx)
        for lo in range(0, len(splits), self.n):
            wave: Shards = []
            for i, s in enumerate(splits[lo:lo + self.n]):
                parts = []
                while True:
                    b = source.next(s)
                    if b is None:
                        break
                    parts.append(_hand_over(b))
                M.record_counter(M.K_SCAN_SPLITS)
                wave.append(X.to_device(_concat(parts),
                                        self.mesh.devices[i])
                            if parts else None)
            wave += [None] * (self.n - len(wave))
            if any(b is not None for b in wave):
                yield wave

    def _run_values(self, node: Pn.ValuesNode) -> Iterator[Shards]:
        """The Values tables through the serial operator's ingest (and
        its cache), n to a wave."""
        op = ValuesOperator(node, self._dev0)
        wave: Shards = []
        while not op.is_finished():
            b = op.get_output()
            if b is None:
                break
            wave.append(X.to_device(b, self.mesh.devices[len(wave)]))
            if len(wave) == self.n:
                yield wave
                wave = []
        if wave:
            yield wave + [None] * (self.n - len(wave))

    # -- per-shard map ----------------------------------------------------------

    def _map_shards(self, source: Pn.PlanNode, fn) -> Iterator[Shards]:
        for wave in self._run_node(source):
            yield [fn(b) if b is not None else None for b in wave]

    def _reshard(self, wave: Shards, key_names, kind: str,
                 spread_hot: Optional[List[bool]] = None) -> Shards:
        """Hash repartition of a wave by ``key_names`` (``spread_hot``:
        destinations whose rows go round-robin, skew key-splitting)."""
        dests = [X.destinations(b, key_names, self.n)
                 if b is not None else None for b in wave]
        if spread_hot is not None:
            hot = torch.tensor(spread_hot, device=self._dev0)
            dests = [X._spread_dest(d, b.mask, hot.to(d.device), self.n, i)
                     if d is not None else None
                     for i, (b, d) in enumerate(zip(wave, dests))]
        return X.repartition(wave, dests, self.mesh, self._stats(kind))

    def _histogram(self, wave: Shards, key_names) -> List[int]:
        """Global rows per destination of a wave (one host read)."""
        counts = [X.dest_counts(X.destinations(b, key_names, self.n), self.n)
                  if b is not None else None for b in wave]
        return X.partition_histogram(X.count_matrix(counts, self.n,
                                                    self._dev0))

    def _concat_waves(self, waves: List[Shards]) -> Shards:
        """Each shard's batches of every wave, concatenated."""
        return [_concat([w[i] for w in waves if w[i] is not None])
                for i in range(self.n)]

    # -- aggregation -------------------------------------------------------------

    def _run_aggregation(self, node: Pn.AggregationNode) -> Iterator[Shards]:
        op = AggregationOperator(node, self._dev0)
        if op._collect_mode or not (node.grouping_keys or _reducible(op)):
            # states the scalar reduction cannot combine (vector registers,
            # collect and percentile states): the serial operator, the
            # reference's single-driver final step (for grouped collect
            # aggregates too, whose partial step the reference cannot run)
            yield from self._funnel_serial(op, node.source)
            return
        if not node.grouping_keys:
            yield self._run_global_aggregation(node, op)
            return
        partials: List[List[DeviceBatch]] = [[] for _ in range(self.n)]
        for wave in self._run_node(node.source):
            for i, b in enumerate(wave):
                if b is not None:
                    op.note_dictionaries(b)
                    partials[i].append(self._check_errors(
                        op._partial_step(b)))
        if not any(partials):
            return
        # local merge of each shard's partial runs, then the exchange so
        # that each shard owns a hash range of the keys, then the merge
        merged = [op._compact_step(concat_batches(p)) if p else None
                  for p in partials]
        key_names = [k.name for k in node.grouping_keys]
        resharded = self._reshard(merged, key_names, "aggregation")
        yield [op._merge_step(b) if b is not None else None
               for b in resharded]

    def _run_global_aggregation(self, node, op) -> Shards:
        """Per-shard states reduced by their combine (sum/min/max) across
        shards and waves, on shard 0."""
        raw = node.step in (Pn.AggregationStep.PARTIAL,
                            Pn.AggregationStep.SINGLE)
        total = None
        idents = op._identity_state()
        for wave in self._run_node(node.source):
            for b in wave:
                if b is None:
                    continue
                op.note_dictionaries(b)
                errs: list = []
                _, addends, _ = op._eval_keys_and_addends(b, raw,
                                                          err_sink=errs)
                self._errors.extend(e.to(self._dev0) for e in errs)
                states = [self._reduce(data, combine, ident)
                          for (data, combine), ident in zip(addends, idents)]
                total = states if total is None else [
                    self._combine(t, s, c) for t, s, (_, c) in zip(
                        total, states, addends)]
        if total is None:
            op._accumulate_empty_global()
        else:
            op._global_state = total
        return self._restack_one(op._extract_global())

    def _reduce(self, data: torch.Tensor, combine: str,
                ident: torch.Tensor) -> torch.Tensor:
        """One shard's state, on shard 0, in the state's dtype."""
        if combine == "sum":
            v = data.sum(0, dtype=ident.dtype)
        elif combine == "min":
            v = data.min(0).values.to(ident.dtype)
        else:
            v = data.max(0).values.to(ident.dtype)
        return v.to(self._dev0)

    @staticmethod
    def _combine(t: torch.Tensor, s: torch.Tensor, combine: str):
        if combine == "sum":
            return t + s
        return torch.minimum(t, s) if combine == "min" \
            else torch.maximum(t, s)

    # -- join ---------------------------------------------------------------------

    def _run_join(self, node: Pn.HashJoinNode) -> Iterator[Shards]:
        """Distributed hash join with a broadcast/partitioned choice by the
        build's bytes against JOIN_BROADCAST_THRESHOLD (parity: the host
        engines' broadcast-vs-partitioned strategy over PartitionedOutput,
        velox/exec/PartitionedOutput.h:149): a small build is gathered
        onto every device; a larger one hash-partitions both sides, so a
        shard holds 1/n of the table."""
        if node.filter is not None \
                and node.join_type is not Pn.JoinType.INNER:
            # filtered outer/semi/anti joins track per-probe-row and
            # per-build-row pass flags across emit chunks
            # (exec/join.py _probe_filtered): funnel through the serial
            # operator, as the reference does
            build = J.HashBuildStage(node.right_keys,
                                     key_ranges=J.build_key_ranges(node))
            for wave in self._run_node(node.right):
                for b in wave:
                    if b is not None:
                        build.add_input(self._to0(b))
            probe = J.HashJoinOperator(node)
            probe.set_built_table(build.finish())
            yield from self._funnel_serial(probe, node.left)
            return
        build_waves = list(self._run_node(node.right))
        if not build_waves:
            raise RuntimeError("empty build side")
        stacked = self._concat_waves(build_waves)
        template = next((b for b in stacked if b is not None), None)
        if template is None:  # no shard has a build row
            rt = node.right.output_type()
            template = DeviceBatch(
                {n: J._null_column(t, 1, self._dev0)
                 for n, t in zip(rt.names, rt.children)},
                torch.zeros((1,), dtype=torch.bool, device=self._dev0))
        thr = self.ctx.query_config.get_int(QC.JOIN_BROADCAST_THRESHOLD,
                                            128 << 20)
        if sum(b.nbytes for b in stacked if b is not None) <= thr:
            yield from self._run_broadcast_join(node, stacked, template)
        else:
            yield from self._run_partitioned_join(node, stacked, template)

    def _build(self, node, b: Optional[DeviceBatch], template, device):
        """A shard's build table (of one inactive row when it has none)."""
        if b is None:
            b = _empty_like(template, device)
        return J.build_table(b, tuple(node.right_keys), None,
                             J.build_key_ranges(node))

    def _probe_waves(self, wave: Shards, ops) -> Iterator[Shards]:
        """Each shard's batch through its prober; a shard's k-th output
        goes in the k-th wave."""
        outs = []
        for op, b in zip(ops, wave):
            if b is not None:
                op.add_input(b)
            outs.append(_drain(op) if b is not None else [])
        yield from _waves(outs)

    def _run_partitioned_join(self, node: Pn.HashJoinNode, stacked: Shards,
                              template) -> Iterator[Shards]:
        n = self.n
        jt = node.join_type
        if node.filter is not None and jt is not Pn.JoinType.INNER:
            raise NotImplementedError(
                "distributed join filter on non-inner joins")
        rnames = [k.name for k in node.right_keys]
        lnames = [k.name for k in node.left_keys]
        resharded_b = self._reshard(stacked, rnames, "join_build")
        devs = self.mesh.devices

        def probers(parts: Shards) -> list:
            """One prober a shard over its build; the null-key flag is
            global (a null-aware anti join must see nulls on any shard),
            and so is the unique flag: one host read for both."""
            bts = [self._build(node, b, template, devs[j])
                   for j, b in enumerate(parts)]
            flags = torch.stack([torch.stack([bt.has_null_key,
                                              bt.has_dup_keys]).to(self._dev0)
                                 for bt in bts]).tolist()
            has_null = any(f[0] for f in flags)
            unique = not any(f[1] for f in flags)
            ops = []
            for j, bt in enumerate(bts):
                op = J.HashJoinOperator(node)
                op.set_built_table(bt._replace(has_null_key=torch.tensor(
                    has_null, device=devs[j])), unique=unique)
                ops.append(op)
            return ops

        ops = probers(resharded_b)
        # skew handling (SURVEY §7.2 step 7): every probe wave reads the
        # global histogram; the hot set is the union over waves, and the
        # build re-augments whenever a wave brings a new hot destination.
        # Joins with a right phase are left out (replicated build rows
        # would need a matched merge across shards).
        track = jt in J._NEEDS_RIGHT_PHASE
        skew_factor = self.ctx.query_config.get_int(QC.SKEW_FACTOR, 4)
        hot_acc: Optional[List[bool]] = None
        for wave in self._run_node(node.left):
            if not track:
                hist = self._histogram(wave, lnames)
                mean = max(1, sum(hist) // n)
                wave_hot = [h > skew_factor * mean for h in hist]
                if any(wave_hot) and (hot_acc is None or any(
                        w and not a for w, a in zip(wave_hot, hot_acc))):
                    M.record_counter(M.K_SKEW_SPLITS)
                    hot_acc = (wave_hot if hot_acc is None else
                               [a or w for a, w in zip(hot_acc, wave_hot)])
                    ops = probers(self._augment_build_with_hot(
                        resharded_b, hot_acc))
            sp = self._reshard(wave, lnames, "join_probe",
                               spread_hot=hot_acc)
            yield from self._probe_waves(sp, ops)
        if track:
            # build rows are partitioned (each shard owns its hash range):
            # each shard's right phase is complete on its own
            for op in ops:
                op.no_more_input()
            yield from _waves([_drain(op) for op in ops])

    def _augment_build_with_hot(self, resharded_b: Shards,
                                hot: List[bool]) -> Shards:
        """Key-splitting build side: each shard keeps its partition unless
        that partition is hot, and gets every hot partition's rows (the
        union, once a device). Paired with spread probes, every spread
        probe row finds its build rows on its shard, and no row is counted
        twice."""
        hot_rows = X.gather_hot_rows(resharded_b, hot, self.mesh)
        out: Shards = []
        for j, b in enumerate(resharded_b):
            parts = [] if hot[j] or b is None else [b]
            extra = hot_rows.get(self.mesh.devices[j])
            if extra is not None:
                parts.append(extra)
            out.append(_concat(parts))
        return out

    def _run_broadcast_join(self, node: Pn.HashJoinNode, stacked: Shards,
                            template) -> Iterator[Shards]:
        """Gather the build side once a device and build it there; each
        shard probes its device's table. A right, full or right-semi
        join ORs its matched flags over every shard and wave, then emits
        the right phase once."""
        jt = node.join_type
        if node.filter is not None and jt is not Pn.JoinType.INNER:
            raise NotImplementedError(
                "distributed join filter on non-inner joins")
        gathered = X.broadcast_gather(stacked, self.mesh,
                                      self._stats("broadcast"))
        tables: Dict[torch.device, J.SortedBuild] = {}
        probes: Dict[torch.device, J.HashJoinOperator] = {}
        for d, b in zip(self.mesh.devices, gathered):
            if d not in tables:
                tables[d] = self._build(node, b, template, d)
                probes[d] = J.HashJoinOperator(node)
                probes[d].set_built_table(tables[d])
        ops = [probes[d] for d in self.mesh.devices]
        for wave in self._run_node(node.left):
            yield from self._probe_waves(wave, ops)
        if jt in J._NEEDS_RIGHT_PHASE:
            matched = None
            probe_cols: Dict = {}
            for op in probes.values():
                m = op._matched.to(self._dev0)
                matched = m if matched is None else (matched | m)
                probe_cols.update(op._probe_cols)
            yield self._restack_one(J.emit_right_phase(
                node, tables[self._dev0], matched, probe_cols))

    # -- topN / orderby / limit / window ----------------------------------------

    def _run_topn(self, node: Pn.TopNNode) -> Iterator[Shards]:
        """A TopN a shard over its waves, then the final TopN over every
        shard's candidates on shard 0."""
        ops = [TopNOperator(node) for _ in range(self.n)]
        for wave in self._run_node(node.source):
            for op, b in zip(ops, wave):
                if b is not None:
                    op.add_input(b)
        cands = []
        for op in ops:
            op.no_more_input()
            cands += _drain(op)
        final = self._gather0([cands], "gather")
        if final is None:
            return
        op = TopNOperator(node)
        op.add_input(final)
        op.no_more_input()
        yield self._restack_one(op.get_output())

    def _run_orderby(self, node: Pn.OrderByNode) -> Iterator[Shards]:
        """Final sort on shard 0 after a gather. Parity: Presto/velox final
        ORDER BY stages are single-driver merges of partial streams
        (exec/Merge.h); one radix sort replaces the k-way merge."""
        merged = self._gather0(list(self._run_node(node.source)), "gather")
        if merged is None:
            return
        keys, orders = list(node.keys), list(node.orders)
        yield self._restack_one(sort_batch(merged, keys, orders,
                                           _key_ranges(node, keys)))

    def _run_limit(self, node: Pn.LimitNode) -> Iterator[Shards]:
        """LIMIT/OFFSET: a row's global position is the rows of earlier
        waves, of earlier shards of its wave, and before it in its batch;
        the counts stay on the device (parity: velox/exec/Limit.h over a
        gather exchange)."""
        off, cnt = node.offset, node.count
        seen = torch.zeros((), dtype=torch.int64, device=self._dev0)
        for wave in self._run_node(node.source):
            counts = torch.stack([
                b.mask.sum(dtype=torch.int64).to(self._dev0)
                if b is not None else seen.new_zeros(()) for b in wave])
            before = torch.cumsum(counts, 0) - counts + seen
            out: Shards = []
            for i, b in enumerate(wave):
                if b is None:
                    out.append(None)
                    continue
                prefix = torch.cumsum(b.mask.to(torch.int64), 0) - 1
                pos = before[i].to(b.device) + prefix
                keep = b.mask & (pos >= off) & (pos < off + cnt)
                out.append(DeviceBatch(b.columns, keep))
            seen = seen + counts.sum()
            yield out

    def _run_window(self, node: Pn.WindowNode) -> Iterator[Shards]:
        """Reshard by the partition keys so each shard owns whole
        partitions, then the serial sort-based window build runs a shard
        (exec/window.py). With no partition keys it is one global
        partition: gathered and computed on shard 0."""
        from velox_tpu_torch.exec.window import WindowOperator
        waves = list(self._run_node(node.source))
        if not waves:
            return
        key_names = [k.name for k in node.partition_keys]

        def window(b):
            op = WindowOperator(node)
            op.add_input(b)
            op.no_more_input()
            return op.get_output()
        if key_names:
            resharded = self._reshard(self._concat_waves(waves), key_names,
                                      "window")
            yield [window(b) if b is not None else None for b in resharded]
            return
        yield self._restack_one(window(self._gather0(waves, "gather")))

    def _run_unnest(self, node: Pn.UnnestNode) -> Iterator[Shards]:
        """Row-local: the serial operator a shard, no data movement
        (parity: velox/exec/Unnest.h runs per driver)."""
        from velox_tpu_torch.exec.misc_ops import UnnestOperator
        op = UnnestOperator(node)

        def unnest(b):
            op.add_input(b)
            return op.get_output()
        yield from self._map_shards(node.source, unnest)

    def _run_markdistinct(self, node: Pn.MarkDistinctNode
                          ) -> Iterator[Shards]:
        """Global distinct marking: each wave reshards by the distinct
        keys (hash placement is deterministic, so a key lands on the same
        shard in every wave), and each shard's streaming hash table lives
        across waves (parity: velox/exec/MarkDistinct.h over a hash
        exchange)."""
        from velox_tpu_torch.exec.misc_ops import MarkDistinctOperator
        ops = [MarkDistinctOperator(node) for _ in range(self.n)]
        key_names = [k.name for k in node.distinct_keys]
        for wave in self._run_node(node.source):
            out: Shards = []
            for op, b in zip(ops, self._reshard(wave, key_names,
                                                "mark_distinct")):
                if b is not None:
                    op.add_input(b)
                    b = op.get_output()
                out.append(b)
            yield out

    def _run_repartition(self, node) -> Iterator[Shards]:
        key_names = [k.name if isinstance(k, ex.FieldAccess) else None
                     for k in node.keys]
        if not key_names or any(k is None for k in key_names):
            # gather / round-robin kinds: pass through (already sharded)
            yield from self._run_node(node.source)
            return
        for wave in self._run_node(node.source):
            yield self._reshard(wave, key_names, "repartition")

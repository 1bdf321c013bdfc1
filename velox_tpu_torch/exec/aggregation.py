"""Aggregation operator (group-by and global).

Counterpart of ``velox_tpu/exec/aggregation.py`` (velox/exec/
HashAggregation.h:23 + GroupingSet.cpp; the partial/final steps of
core/PlanNode.h:512-525). There is no probing hash table: per input batch
the *partial* step computes per-row addends and reduces them into dense
per-group state in array mode (small known key domains) or sort mode
(packed keys, radix sort, run reductions; exec/groupby.py). The operator
holds the partial group batches and a *merge* step re-groups their
concatenation and extracts the final values: the in-memory analogue of
the reference's sorted spill-run merge (GroupingSet.cpp:1043).

SINGLE, FINAL and INTERMEDIATE steps with keys buffer per-row state
batches and group once at the end (single-shot), folding the buffer into
one grouped run past ``_SINGLE_MERGE_MAX_ROWS``. A SINGLE step with a
vector state (approx_distinct's 512 registers a group) groups each batch
instead: its per-row states would be 2 KB a row.

*Abandonment* (velox kAbandonPartialAggregationMinRows/Pct): a PARTIAL
step whose groups reach ``abandon_min_pct`` of its input rows, once it
has seen ``abandon_min_rows``, emits its compacted run and passes every
later batch through as per-row states for the FINAL step to group. The
check rides each compaction's one host read.

Collect mode (the reference's collect pathway): when an aggregate has no
segment-combinable state (min_by/max_by over wide types, min/max over a
long decimal, mode, approx_percentile, and the ARRAY/MAP results:
array_agg, set_agg, map_agg, multimap_agg, histogram,
approx_most_frequent, bloom_filter_agg), the operator retains each
batch's keys and aggregate inputs and computes every aggregate at the end
from one radix sort of the rows by (group keys, value). A collection's
elements are the passing sorted rows compacted in place (a scatter), so
each group's elements are contiguous: the result column is dense, with
per-group counts and element children of the retained rows' capacity.
array_agg keeps input order through the keys-only sort, which is stable.
Single-step only, except one approx_percentile, whose PARTIAL step emits
at most K weighted quantile knots a group and whose FINAL step
re-selects by weighted rank (``_pct_compress``, ``_pct_final``).

*Host offload* (``host_offload``, the spill analogue of velox
GroupingSet::spill): each compacted partial run moves to host RAM
(exec/memory.py ``HostBatch``) and the runs come back, ahead of the
pending partials, for the final merge. It turns single-shot mode off.

Not ported: the reference's compiled-program caches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec import groupby as G
from velox_tpu_torch.exec.batch_utils import concat_batches, slice_batch
from velox_tpu_torch.exec.memory import HostBatch
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.expression.eval import (
    EvalCtx, EvalValue, ExprSet, value_from_column,
)
from velox_tpu_torch.functions.aggregates import (
    ApproxDistinctAgg, ApproxMostFrequentAgg, ApproxPercentileAgg, ArrayAgg,
    BloomFilterAgg, CollectAgg, CountAgg, RegisterAddend, masked,
    resolve_aggregate,
)
from velox_tpu_torch.ops.gather import take_rows
from velox_tpu_torch.ops.wide import (
    compact_kept, scatter_unique_set, segment_offsets,
    segmented_reduce_sorted,
)
from velox_tpu_torch.vector import strings as S
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn


def check_raw_args(agg, args) -> None:
    """Raise where a raw (byte-matrix) string reaches an aggregate the
    reference cannot run over one either: only count, approx_distinct
    (over the byte words) and the ordering argument of the sorted
    min_by/max_by take it; min, max, arbitrary, first/last, mode and an
    argument min_by/max_by would return fail there (ROADMAP C)."""
    raw = [S.is_raw(a) for a in args]
    if not any(raw):
        return
    if isinstance(agg, (CountAgg, ApproxDistinctAgg)):
        return
    if isinstance(agg, CollectAgg) and agg.collect_kind in (
            "min_by", "max_by") and len(args) == 2 and not raw[0]:
        return
    raise NotImplementedError(
        f"aggregate {type(agg).__name__} over a raw (dictionary-less) "
        "string argument is not supported")


def _state_col_name(out_name: str, agg, suffix: str) -> str:
    if len(agg.states) == 1:
        return out_name
    return f"{out_name}${suffix}"


def _const_arg(call, i: int, what: str) -> float:
    """A constant argument's value (a DECIMAL literal unscaled)."""
    from velox_tpu_torch.core import expressions as ex
    c = call.inputs[i]
    if not isinstance(c, ex.Constant):
        raise NotImplementedError(
            f"{call.name}: {what} must be a constant")
    v = float(c.value)
    if c.dtype.kind is T.TypeKind.DECIMAL:
        v /= 10.0 ** c.dtype.scale
    return v


class AggregationOperator(Operator):
    """Group-by or global aggregation over one plan node."""

    # single-shot buffers fold into one grouped run past this many rows
    _SINGLE_MERGE_MAX_ROWS = 1 << 24

    def __init__(self, node: P.AggregationNode, device, pre_fn=None,
                 host_offload: bool = False, compact_threshold: int = 8,
                 abandon_min_rows: int = 100_000,
                 abandon_min_pct: float = 0.8):
        super().__init__(node)
        self._device = torch.device(device)
        # the fused upstream Filter/Project chain (exec/fuse.py), applied
        # to each batch before the aggregation reads it
        self._pre_fn = pre_fn
        # compacted partial runs offloaded to host RAM
        self._host_offload = host_offload
        self._host_runs: List[HostBatch] = []
        self._step = node.step
        self._keys = list(node.grouping_keys)
        # static (min, max) bounds per grouping key (core/stats.py):
        # narrows the sort-mode keys to their information content, so
        # fewer radix passes
        from velox_tpu_torch.core.stats import resolve_column_stats
        self._key_ranges = tuple(
            resolve_column_stats(node.source, k.name)
            if node.source is not None else None
            for k in self._keys)
        self._agg_calls = list(node.aggregates)
        self._agg_names = list(node.aggregate_names)
        self._aggs = [resolve_aggregate(a.name, [i.dtype for i in a.inputs])
                      for a in self._agg_calls]
        self._vector = any(st.width > 1 for a in self._aggs
                           for st in a.states)
        # collect mode: retain rows, aggregate once at the end
        self._collect_mode = any(isinstance(a, CollectAgg)
                                 for a in self._aggs)
        self._pct_split = False
        if self._collect_mode:
            self._init_collect()
        self._collect_rows: List[DeviceBatch] = []
        self._partials: List[DeviceBatch] = []
        self._outputs: List[DeviceBatch] = []
        self.error_scalars: List[torch.Tensor] = []  # read by the Task
        # single-shot: one sort over every buffered row beats a sort per
        # batch plus a sort of the concatenated partials
        self._single_shot = (
            bool(self._keys) and not self._collect_mode
            and not host_offload
            and self._step is not P.AggregationStep.PARTIAL
            and not (self._vector
                     and self._step is P.AggregationStep.SINGLE))
        self._buffered_rows = 0
        # string aggregate outputs carry the input dictionary over
        self._agg_dicts: List = [None] * len(self._aggs)
        self._global_state: Optional[List[torch.Tensor]] = None
        # fold accumulated partial runs when this many pile up
        self._compact_threshold = compact_threshold
        # partial-aggregation abandonment: input rows (device scalars,
        # read at compaction time) against the compacted group count
        self._abandon_min_rows = abandon_min_rows
        self._abandon_min_pct = abandon_min_pct
        self._in_rows: List[torch.Tensor] = []
        self._abandoned = False
        # (input rows, groups, batches) when it abandoned, and the batches
        # passed through since: what a run reports
        self.abandoned_at: Optional[Tuple[int, int, int]] = None
        self.passthrough_batches = 0
        self._batches_in = 0

    def _init_collect(self):
        if any(st.width > 1 for a in self._aggs for st in a.states):
            raise NotImplementedError(
                "vector-state aggregates cannot mix with collect "
                "aggregates")
        self._pct_split = self._step is not P.AggregationStep.SINGLE
        if self._pct_split and not (
                len(self._aggs) == 1
                and isinstance(self._aggs[0], ApproxPercentileAgg)):
            raise NotImplementedError(
                "collect aggregates support single-step aggregation only "
                "(but for one approx_percentile, which splits through its "
                "mergeable knot summary)")
        for a, call in zip(self._aggs, self._agg_calls):
            if isinstance(a, BloomFilterAgg) and len(call.inputs) > 1:
                # numBits given (argument 3), or ~8 bits an item (2)
                want = int(_const_arg(call, 2, "the bit count")
                           if len(call.inputs) > 2
                           else 8 * _const_arg(call, 1, "the item count"))
                a.num_bits = max(1 << 10, min(
                    1 << 23, 1 << max(1, want - 1).bit_length()))
            if isinstance(a, ApproxMostFrequentAgg):
                a.buckets = int(_const_arg(call, 0, "buckets"))
            if not isinstance(a, ApproxPercentileAgg):
                continue
            a.percentile = _const_arg(call, 1, "percentage")
            if len(call.inputs) > 2:
                acc = _const_arg(call, 2, "accuracy")
                if not 0.0 < acc < 1.0:
                    from velox_tpu_torch.common.errors import (
                        VeloxUserError,
                    )
                    raise VeloxUserError(
                        "approx_percentile accuracy must be in (0, 1), "
                        f"got {acc}")
                a.accuracy = acc
        # knots a group: a compression's rank error is at most W/K and
        # there are two (the partials, then the final re-select), so the
        # normalized rank error stays within 2/K; with an accuracy, K is
        # chosen so that 2/K <= accuracy
        self._pct_k = 1024
        acc = getattr(self._aggs[0], "accuracy", None)
        if acc:
            self._pct_k = min(1 << 20, max(2, int(np.ceil(2.0 / acc))))

    # ---- per-batch steps -----------------------------------------------------

    def _pre(self, batch: DeviceBatch, errs: list) -> DeviceBatch:
        if self._pre_fn is not None:
            batch = self._pre_fn(batch)
            if batch.errors is not None:
                errs.append(batch.errors)
        return batch

    def _eval_keys_and_addends(self, batch: DeviceBatch, raw: bool,
                               err_sink: Optional[list] = None):
        """Grouping keys and per-row addends (raw or intermediate)."""
        cap = batch.capacity
        cols = {n: value_from_column(c) for n, c in batch.columns.items()}
        ctx = EvalCtx(cols, cap, batch.device)
        keys = [cols[k.name] for k in self._keys]
        active = batch.mask
        addends: List[Tuple[torch.Tensor, str]] = []
        for out_name, agg_call, agg in zip(
                self._agg_names, self._agg_calls, self._aggs):
            if raw:
                sink = [] if err_sink is not None else None
                args = ExprSet(list(agg_call.inputs), None).eval_batch(
                    batch, err_sink=sink)
                if sink and sink[0] is not None:
                    err_sink.append((sink[0] & active).sum(
                        dtype=torch.int32))
                row_active = active
                if agg_call.mask is not None:
                    m = ExprSet([agg_call.mask], None).eval_batch(batch)[0]
                    mm = m.full_data(cap).to(torch.bool)
                    if m.validity is not None:
                        mm = mm & m.full_validity(cap)
                    row_active = row_active & mm
                check_raw_args(agg, args)
                arrays = agg.map_raw(ctx, args, row_active)
                for arr, st in zip(arrays, agg.states):
                    addends.append((arr, st.combine))
            else:
                # intermediate input: state columns combine, inactive or
                # null rows masked to the identity
                for st in agg.states:
                    col = cols[_state_col_name(out_name, agg, st.suffix)]
                    keep = active
                    if col.validity is not None:
                        keep = keep & col.full_validity(cap)
                    addends.append((_masked_state(col.full_data(cap), keep,
                                                  st), st.combine))
        return keys, addends, active

    def _group(self, keys, addends, active, cap):
        """(group keys, group states, group mask, output capacity)."""
        domain = G.array_mode_domain(keys) if keys else None
        if keys and domain is not None and domain <= cap:
            gk, gs, gmask = G.reduce_array_mode(keys, addends, active, cap,
                                                domain)
            return gk, gs, gmask, domain
        gk, gs, gmask = G.reduce_sort_mode(keys, addends, active, cap,
                                           ranges=self._key_ranges)
        return gk, gs, gmask, gmask.shape[0]

    def _with_errors(self, out: DeviceBatch, errs: list) -> DeviceBatch:
        if errs:
            out = DeviceBatch(out.columns, out.mask, errors=sum(errs))
        return out

    def _partial_step(self, batch: DeviceBatch) -> DeviceBatch:
        errs: list = []
        batch = self._pre(batch, errs)
        raw = self._step in (P.AggregationStep.PARTIAL,
                             P.AggregationStep.SINGLE)
        keys, addends, active = self._eval_keys_and_addends(
            batch, raw, err_sink=errs)
        gk, gs, gmask, out_cap = self._group(keys, addends, active,
                                             batch.capacity)
        return self._with_errors(
            self._make_state_batch(gk, gs, gmask, out_cap), errs)

    def _passthrough_step(self, batch: DeviceBatch) -> DeviceBatch:
        """Per-row states without grouping: a single-shot SINGLE step's
        input, and an abandoned PARTIAL step's output."""
        errs: list = []
        batch = self._pre(batch, errs)
        keys, addends, active = self._eval_keys_and_addends(
            batch, True, err_sink=errs)
        return self._with_errors(self._make_state_batch(
            keys, [a for a, _ in addends], active, batch.capacity), errs)

    def _make_state_batch(self, group_keys, group_states, group_mask,
                          out_cap) -> DeviceBatch:
        cols: Dict[str, DeviceColumn] = {}
        for k, v in zip(self._keys, group_keys):
            cols[k.name] = v.to_column(out_cap)
        i = 0
        for out_name, agg in zip(self._agg_names, self._aggs):
            for st in agg.states:
                cols[_state_col_name(out_name, agg, st.suffix)] = \
                    DeviceColumn(group_states[i], None, st.dtype)
                i += 1
        return DeviceBatch(cols, group_mask)

    def _regroup_states(self, merged: DeviceBatch):
        cap = merged.capacity
        cols = {n: value_from_column(c) for n, c in merged.columns.items()}
        keys = [cols[k.name] for k in self._keys]
        active = merged.mask
        addends = []
        for out_name, agg in zip(self._agg_names, self._aggs):
            for st in agg.states:
                data = cols[_state_col_name(out_name, agg,
                                            st.suffix)].full_data(cap)
                addends.append((_masked_state(data, active, st),
                                st.combine))
        return self._group(keys, addends, active, cap)

    def _compact_step(self, merged: DeviceBatch) -> DeviceBatch:
        """Re-group concatenated partials back into one state batch."""
        gk, gs, gmask, out_cap = self._regroup_states(merged)
        return self._make_state_batch(gk, gs, gmask, out_cap)

    def _merge_step(self, merged: DeviceBatch) -> DeviceBatch:
        """Re-group concatenated state batches; extract if final."""
        gk, gs, gmask, out_cap = self._regroup_states(merged)
        if self._step in (P.AggregationStep.PARTIAL,
                          P.AggregationStep.INTERMEDIATE):
            return self._make_state_batch(gk, gs, gmask, out_cap)
        out_cols: Dict[str, DeviceColumn] = {}
        for k, v in zip(self._keys, gk):
            out_cols[k.name] = v.to_column(out_cap)
        i = 0
        for out_name, agg, d in zip(self._agg_names, self._aggs,
                                    self._agg_dicts):
            n_states = len(agg.states)
            res = agg.extract(gs[i:i + n_states], gmask)
            i += n_states
            out_cols[out_name] = self._result_column(res, out_cap, d)
        return DeviceBatch(out_cols, gmask)

    @staticmethod
    def _result_column(res, cap: int, dictionary) -> DeviceColumn:
        col = res.to_column(cap)
        if res.dtype.is_string and col.dictionary is None:
            col = DeviceColumn(col.data, col.validity, col.dtype, dictionary)
        return col

    # ---- collect mode --------------------------------------------------------

    def _collect_inputs(self, i: int):
        """The inputs a collect row keeps for aggregate i: approx_
        percentile's value only (its percentage and accuracy are
        constants)."""
        call = self._agg_calls[i]
        if isinstance(self._aggs[i],
                      (ApproxPercentileAgg, BloomFilterAgg)):
            return [call.inputs[0]]
        if isinstance(self._aggs[i], ApproxMostFrequentAgg):
            return [call.inputs[1]]  # buckets and capacity are constants
        return list(call.inputs)

    def _collect_prep(self, batch: DeviceBatch) -> DeviceBatch:
        """The rows to retain: grouping keys, every aggregate's evaluated
        inputs (``__a{i}_{j}``) and masks (``__m{i}``)."""
        errs: list = []
        batch = self._pre(batch, errs)
        cap = batch.capacity
        out: Dict[str, DeviceColumn] = {
            k.name: batch.columns[k.name] for k in self._keys}
        for i, call in enumerate(self._agg_calls):
            exprs = self._collect_inputs(i)
            if exprs:
                sink: list = []
                vals = ExprSet(exprs, None).eval_batch(batch, err_sink=sink)
                if sink and sink[0] is not None:
                    errs.append((sink[0] & batch.mask).sum(
                        dtype=torch.int32))
                for j, v in enumerate(vals):
                    out[f"__a{i}_{j}"] = v.to_column(cap)
            if call.mask is not None:
                m = ExprSet([call.mask], None).eval_batch(batch)[0]
                out[f"__m{i}"] = m.to_column(cap)
        return self._with_errors(DeviceBatch(out, batch.mask), errs)

    def _collect_finalize(self, merged: DeviceBatch) -> DeviceBatch:
        """Group the retained rows (one radix sort by the keys) and compute
        each aggregate: collect kinds from their own (keys, value) sort,
        the others by segmented reduction over the group runs."""
        cap = merged.capacity
        active = merged.mask
        cols = {n: value_from_column(c) for n, c in merged.columns.items()}
        keys = [cols[k.name] for k in self._keys]
        perm, gid, boundary, act_s, num_groups = G.sorted_group_info(
            keys, active, cap, self._key_ranges)
        out_keys, gmask = G.group_keys_sorted(
            keys, perm, gid, boundary, act_s, num_groups, cap)
        out_cols: Dict[str, DeviceColumn] = {
            k.name: v.to_column(cap) for k, v in zip(self._keys, out_keys)}
        ctx = EvalCtx(cols, cap, merged.device)
        for i, (out_name, agg) in enumerate(zip(self._agg_names,
                                                self._aggs)):
            row_active = active
            mval = cols.get(f"__m{i}")
            if mval is not None:
                mm = mval.full_data(cap).to(torch.bool)
                if mval.validity is not None:
                    mm = mm & mval.full_validity(cap)
                row_active = row_active & mm
            args = []
            while f"__a{i}_{len(args)}" in cols:
                args.append(cols[f"__a{i}_{len(args)}"])
            check_raw_args(agg, args)
            if isinstance(agg, ArrayAgg):
                out_cols[out_name] = _array_agg(
                    agg, args[0], row_active, (gid, boundary, act_s),
                    perm, gmask, cap)
                continue
            if isinstance(agg, CollectAgg):
                collect = {
                    "mode": self._collect_mode_value,
                    "approx_percentile": self._collect_percentile,
                    "approx_most_frequent": self._collect_most_frequent,
                    "bloom": self._collect_bloom,
                    "set_agg": self._collect_runs,
                    "map_agg": self._collect_runs,
                    "multimap_agg": self._collect_runs,
                    "histogram": self._collect_runs,
                }.get(agg.collect_kind, self._collect_min_max_by)
                out_cols[out_name] = collect(agg, args, row_active, keys,
                                             active, gmask, cap)
                continue
            arrays = agg.map_raw(ctx, args, row_active)
            gs = [segmented_reduce_sorted(a[perm], gid, boundary, act_s,
                                          cap, st.combine)
                  for a, st in zip(arrays, agg.states)]
            out_cols[out_name] = self._result_column(
                agg.extract(gs, gmask), cap, self._agg_dicts[i])
        return DeviceBatch(out_cols, self._collect_mask(gmask))

    def _collect_mask(self, gmask: torch.Tensor) -> torch.Tensor:
        """The group mask; a global aggregation has exactly one output
        row (NULL results when no row passed)."""
        if self._keys:
            return gmask
        one = torch.zeros_like(gmask)
        one[0] = True
        return one

    def _collect_min_max_by(self, agg, args, row_active, keys, active,
                            gmask, cap: int) -> DeviceColumn:
        """min_by/max_by: rows sorted by (group, y); the first (min_by) or
        last (max_by) passing row's x in each group. min/max over a long
        decimal pass one argument, both x and y. The group numbering is
        the skeleton's: the same key words and active flag lead the
        sort."""
        x, y = (args[0], args[0]) if len(args) == 1 else args
        perm, gid, boundary, act_s, _, _ = G.sorted_group_info_vals(
            keys, [y], active, cap, self._key_ranges)
        pass_ = row_active[perm] & act_s
        if y.validity is not None:
            pass_ = pass_ & y.full_validity(cap)[perm]
        c = torch.cumsum(pass_.to(torch.int64), 0)
        ce = c - pass_.to(torch.int64)
        # passing-row ordinal within its group
        within = ce - ce[torch.arange(cap, device=perm.device)
                         - segment_offsets(boundary, cap)]
        n_pass = segmented_reduce_sorted(pass_.to(torch.int64), gid,
                                         boundary, act_s, cap, "sum")
        if agg.collect_kind == "min_by":
            sel = pass_ & (within == 0)
        else:
            sel = pass_ & (within == n_pass[gid] - 1)
        tgt = torch.where(sel, gid, cap)
        gvalid = gmask & (n_pass > 0)
        if x.validity is not None:
            xv = torch.ones((cap + 1,), dtype=torch.bool, device=perm.device)
            xv[tgt] = x.full_validity(cap)[perm]
            gvalid = gvalid & xv[:cap]
        return _picked(x, perm, tgt, None, gvalid, agg.result_type)

    def _run_counts(self, keys, v, row_active, active, cap: int):
        """The (group, value) sort of the rows and, per sorted row, the
        passing rows of its (group, value) run: (perm, count)."""
        perm, gid, boundary, act_s, _, vb = G.sorted_group_info_vals(
            keys, [v], active, cap, self._key_ranges)
        pass_ = row_active[perm] & act_s
        if v.validity is not None:
            pass_ = pass_ & v.full_validity(cap)[perm]
        return perm, _run_sizes(pass_, vb, cap)

    def _collect_mode_value(self, agg, args, row_active, keys, active,
                            gmask, cap: int) -> DeviceColumn:
        """mode(x): each row's (group, value) run count, then a second
        sort by (group, -count, value), whose first passing row of each
        group is the most frequent value, the smallest of a tie."""
        (v,) = args
        perm, run_cnt = self._run_counts(keys, v, row_active, active, cap)
        cnt = torch.zeros((cap,), dtype=torch.int64, device=perm.device)
        cnt[perm] = run_cnt
        negc = EvalValue(-cnt, None, T.BIGINT)
        perm2, gid2, b2, act2, _, _ = G.sorted_group_info_vals(
            keys, [negc, v], active, cap, self._key_ranges)
        pass2 = row_active[perm2] & act2
        if v.validity is not None:
            pass2 = pass2 & v.full_validity(cap)[perm2]
        p64 = pass2.to(torch.int64)
        before = torch.cumsum(p64, 0) - p64  # passing rows before a row
        grp_start = torch.arange(cap, device=perm2.device) \
            - segment_offsets(b2, cap)
        take = pass2 & (before == take_rows(before, grp_start))
        tgt = torch.where(take, gid2, cap)
        has = torch.zeros((cap + 1,), dtype=torch.bool, device=tgt.device)
        has[tgt] = True
        return _picked(v, perm2, tgt, None, gmask & has[:cap],
                       agg.result_type)

    def _collect_percentile(self, agg, args, row_active, keys, active,
                            gmask, cap: int) -> DeviceColumn:
        """approx_percentile in one step, exact: the passing values of
        each group compacted in (group, value) order, and the one of rank
        ceil(p * n) taken."""
        (v,) = args
        perm, gid, boundary, act_s, _, _ = G.sorted_group_info_vals(
            keys, [v], active, cap, self._key_ranges)
        keep = row_active[perm] & act_s
        if v.validity is not None:
            keep = keep & v.full_validity(cap)[perm]
        k64 = keep.to(torch.int64)
        tgt = torch.where(keep, torch.cumsum(k64, 0) - 1, cap)
        n = segmented_reduce_sorted(k64, gid, boundary, act_s, cap, "sum")
        starts = torch.cumsum(n, 0) - n
        rank = torch.ceil(agg.percentile * n.to(torch.float64)).to(
            torch.int64) - 1
        rank = torch.minimum(torch.clamp(rank, min=0),
                             torch.clamp(n - 1, min=0))
        idx = torch.clamp(starts + rank, 0, cap - 1)
        return _picked(v, perm, tgt, idx, gmask & (n > 0), agg.result_type)

    def _collect_most_frequent(self, agg, args, row_active, keys, active,
                               gmask, cap: int) -> DeviceColumn:
        """approx_most_frequent, exact: each row's (group, value) run
        count, then a sort by (group, -count, value) whose first
        ``buckets`` runs of each group are the most frequent values."""
        (v,) = args
        perm, run_cnt = self._run_counts(keys, v, row_active, active, cap)
        cnt = torch.zeros((cap,), dtype=torch.int64, device=perm.device)
        cnt[perm] = run_cnt
        negc = EvalValue(-cnt, None, T.BIGINT)
        perm2, gid2, b2, act2, _, vb2 = G.sorted_group_info_vals(
            keys, [negc, v], active, cap, self._key_ranges)
        pass2 = row_active[perm2] & act2
        if v.validity is not None:
            pass2 = pass2 & v.full_validity(cap)[perm2]
        first2 = _run_heads(pass2, vb2, cap)
        f64 = first2.to(torch.int64)
        before = torch.cumsum(f64, 0) - f64  # runs taken before a row
        # the count at each group's first row: a scatter and a gather
        base = scatter_unique_set(cap + 1, torch.where(b2, gid2, cap),
                                  before)[:cap]
        take = first2 & (before - take_rows(base, gid2) < agg.buckets)
        (kd, _), (cd, _) = compact_kept(
            [(take_rows(v.full_data(cap), perm2), None),
             (take_rows(cnt, perm2), None)], take & act2)
        lengths = _run_lengths(take, gid2, b2, act2, gmask)
        kt = agg.result_type.children[0]
        return DeviceColumn(lengths, gmask, agg.result_type, None,
                            (DeviceColumn(kd, None, kt, v.dictionary),
                             DeviceColumn(cd, None, T.BIGINT)))

    def _collect_bloom(self, agg, args, row_active, keys, active, gmask,
                       cap: int) -> DeviceColumn:
        """bloom_filter_agg: the K probes of every passing non-NULL row
        set their bits of an m-bit filter, packed 32 to an INTEGER (bit j
        of word w is bit 32 w + j)."""
        from velox_tpu_torch.exec.hashtable import bloom_hashes
        if self._keys:
            raise NotImplementedError(
                "bloom_filter_agg supports global aggregation only (build "
                "it with a scalar subquery)")
        (v,) = args
        m = agg.num_bits
        keep = row_active
        if v.validity is not None:
            keep = keep & v.full_validity(cap)
        h1, h2 = bloom_hashes(v, cap)
        bits = torch.zeros((m + 1,), dtype=torch.int32, device=h1.device)
        for i in range(agg.K):
            pos = (h1 + i * h2) & (m - 1)
            bits[torch.where(keep, pos, m)] = 1
        weights = torch.ones((32,), dtype=torch.int64, device=h1.device) \
            << torch.arange(32, device=h1.device)
        words = (bits[:m].view(m // 32, 32).to(torch.int64) * weights).sum(1)
        # the words' 32 bits as int32 (bit 31 set -> negative)
        words = ((words ^ (1 << 31)) - (1 << 31)).to(torch.int32)
        lengths = torch.zeros((cap,), dtype=torch.int32, device=h1.device)
        lengths[0] = m // 32
        return DeviceColumn(lengths, gmask, agg.result_type, None,
                            (DeviceColumn(words, None, T.INTEGER),))

    def _collect_runs(self, agg, args, row_active, keys, active, gmask,
                      cap: int) -> DeviceColumn:
        """set_agg, map_agg, multimap_agg and histogram over one sort of
        the rows by (group, value): the first passing row of each
        (group, value) run is the distinct value (set_agg, keeping a NULL
        once), the entry (map_agg) or the key (multimap_agg, whose values
        are the run's passing rows, compacted in the same row order), and
        histogram counts the run. NULL keys drop out of the map kinds."""
        kind = agg.collect_kind
        v = args[0]
        perm, gid, boundary, act_s, _, vb = G.sorted_group_info_vals(
            keys, [v], active, cap, self._key_ranges)
        pass_ = row_active[perm] & act_s
        val_s = None if v.validity is None else v.full_validity(cap)[perm]
        if kind != "set_agg" and val_s is not None:
            pass_ = pass_ & val_s
        first = _run_heads(pass_, vb, cap)
        data_s = take_rows(v.full_data(cap), perm)
        lengths = _run_lengths(first, gid, boundary, act_s, gmask)
        et = agg.result_type.children[0]
        if kind == "set_agg":
            ((d, dv),) = compact_kept([(data_s, val_s)], first & act_s)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (DeviceColumn(d, dv, et, v.dictionary),))
        if kind == "histogram":
            ((d, _), (c, _)) = compact_kept(
                [(data_s, None), (_run_sizes(pass_, vb, cap), None)],
                first & act_s)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (DeviceColumn(d, None, et, v.dictionary),
                                 DeviceColumn(c, None, T.BIGINT)))
        w = args[1]
        wd = take_rows(w.full_data(cap), perm)
        wv = None if w.validity is None else w.full_validity(cap)[perm]
        if kind == "map_agg":
            ((d, _), (vd, vv)) = compact_kept([(data_s, None), (wd, wv)],
                                              first & act_s)
            return DeviceColumn(lengths, gmask, agg.result_type, None,
                                (DeviceColumn(d, None, et, v.dictionary),
                                 DeviceColumn(vd, vv, agg.value_type,
                                              w.dictionary)))
        # multimap_agg: one entry a (group, key) run, whose array holds
        # the run's passing rows' values in their order
        ((d, _), (n, _)) = compact_kept(
            [(data_s, None),
             (_run_sizes(pass_, vb, cap).to(torch.int32), None)],
            first & act_s)
        ((vd, vv),) = compact_kept([(wd, wv)], pass_ & act_s)
        at = agg.result_type.children[1]
        values = DeviceColumn(n, None, at, None,
                              (DeviceColumn(vd, vv, agg.value_type,
                                            w.dictionary),))
        return DeviceColumn(lengths, gmask, agg.result_type, None,
                            (DeviceColumn(d, None, et, v.dictionary),
                             values))

    # ---- approx_percentile split into PARTIAL and FINAL -------------------
    #
    # PARTIAL compresses its rows into at most K knots a group: rows sorted
    # by value within their group, cumulative weight cw, and the first row
    # crossing each of K evenly spaced weight thresholds kept with weight
    # cw - cw(previous knot). A knot's cumulative weight is its exact local
    # rank, so a compression errs by at most W/K ranks; weights add under
    # concatenation, so FINAL merges the knots and re-selects by weighted
    # rank.

    def _pct_sorted(self, merged: DeviceBatch):
        """Rows (or knots) sorted by (group, value), with their weights,
        the within-group cumulative weight and each group's total."""
        cap = merged.capacity
        active = merged.mask
        cols = {n: value_from_column(c) for n, c in merged.columns.items()}
        keys = [cols[k.name] for k in self._keys]
        name = self._agg_names[0]
        if self._step is P.AggregationStep.PARTIAL:
            v, w = cols["__a0_0"], None
        else:
            v, w = cols[f"{name}$v"], cols[f"{name}$w"]
        perm, gid, boundary, act_s, num_groups, _ = \
            G.sorted_group_info_vals(keys, [v], active, cap,
                                     self._key_ranges)
        pass_ = act_s
        if v.validity is not None:
            pass_ = pass_ & v.full_validity(cap)[perm]
        wd = (torch.ones((cap,), dtype=torch.int64, device=perm.device)
              if w is None else take_rows(w.full_data(cap).to(torch.int64),
                                          perm))
        wd = torch.where(pass_, wd, 0)
        run_start = torch.arange(cap, device=perm.device) \
            - segment_offsets(boundary, cap)
        cs = torch.cumsum(wd, 0)
        cw = cs - take_rows(cs - wd, run_start)  # inclusive, in the group
        W = segmented_reduce_sorted(wd, gid, boundary, act_s, cap, "sum")
        return dict(cap=cap, keys=keys, v=v, perm=perm, gid=gid,
                    boundary=boundary, act_s=act_s, num_groups=num_groups,
                    v_s=_gather_value(v, perm, cap), pass_=pass_,
                    wd=wd, cw=cw, W=W, run_start=run_start)

    def _pct_compress(self, merged: DeviceBatch) -> DeviceBatch:
        """PARTIAL: rows -> at most K weighted knots a group."""
        s = self._pct_sorted(merged)
        cap, K = s["cap"], self._pct_k
        cw, wd, pass_ = s["cw"], s["wd"], s["pass_"]
        safe = torch.clamp(take_rows(s["W"], s["gid"]), min=1)
        # keep the first row crossing each ceil(cw * K / W) threshold
        bk = (cw * K + safe - 1) // safe
        bk_prev = ((cw - wd) * K + safe - 1) // safe
        keep = pass_ & (wd > 0) & (bk > bk_prev)
        iota = torch.arange(cap, device=keep.device)
        incl = torch.cummax(torch.where(keep, iota, -1), 0).values
        prev = torch.cat([incl.new_full((1,), -1), incl[:-1]])
        prev = torch.where(prev >= s["run_start"], prev, -1)
        prev_cw = torch.where(prev >= 0,
                              take_rows(cw, torch.clamp(prev, min=0)), 0)
        new_w = torch.where(keep, cw - prev_cw, 0)
        out: Dict[str, DeviceColumn] = {}
        for k, kv in zip(self._keys, s["keys"]):
            out[k.name] = _gather_value(kv, s["perm"], cap)
        name = self._agg_names[0]
        v_s = s["v_s"]
        out[f"{name}$v"] = DeviceColumn(v_s.data, keep,
                                        self._aggs[0].input_type,
                                        v_s.dictionary, v_s.children)
        out[f"{name}$w"] = DeviceColumn(new_w, None, T.BIGINT)
        return DeviceBatch(out, keep)

    def _pct_final(self, merged: DeviceBatch) -> DeviceBatch:
        """FINAL: the weighted rank-select over the merged knots."""
        s = self._pct_sorted(merged)
        cap = s["cap"]
        agg = self._aggs[0]
        W = s["W"]
        r = torch.clamp(torch.ceil(agg.percentile * W.to(torch.float64))
                        .to(torch.int64), min=1)
        r_row = take_rows(r, s["gid"])
        cw, wd, pass_ = s["cw"], s["wd"], s["pass_"]
        crossing = pass_ & (wd > 0) & (cw >= r_row) & ((cw - wd) < r_row)
        tgt = torch.where(crossing, s["gid"], cap)

        def pick(rows: torch.Tensor) -> torch.Tensor:
            return scatter_unique_set(cap + 1, tgt, rows)[:cap]
        v_s = s["v_s"]
        out_keys, gmask = G.group_keys_sorted(
            s["keys"], s["perm"], s["gid"], s["boundary"], s["act_s"],
            s["num_groups"], cap)
        out_cols: Dict[str, DeviceColumn] = {
            k.name: kv.to_column(cap) for k, kv in zip(self._keys,
                                                       out_keys)}
        out_cols[self._agg_names[0]] = DeviceColumn(
            pick(v_s.data), gmask & (W > 0), agg.result_type,
            v_s.dictionary, tuple(DeviceColumn(pick(c.data), None, c.dtype)
                                  for c in v_s.children))
        return DeviceBatch(out_cols, self._collect_mask(gmask))

    # ---- operator contract -------------------------------------------------

    def add_input(self, batch: DeviceBatch):
        # remember dictionaries of string aggregate inputs for extraction
        from velox_tpu_torch.core import expressions as ex
        for j, agg_call in enumerate(self._agg_calls):
            if agg_call.inputs and agg_call.inputs[0].dtype.is_string:
                inp = agg_call.inputs[0]
                if isinstance(inp, ex.FieldAccess):
                    col = batch.columns.get(inp.name)
                    if col is not None:
                        self._agg_dicts[j] = col.dictionary
        if self._collect_mode:
            if self._pct_split \
                    and self._step is not P.AggregationStep.PARTIAL:
                # INTERMEDIATE/FINAL inputs already are knot batches
                self._collect_rows.append(batch)
            else:
                self._collect_rows.append(self._strip_errs(
                    self._collect_prep(batch)))
            return
        if not self._keys:
            self._accumulate_global(batch)
            return
        if self._single_shot:
            if self._step is P.AggregationStep.SINGLE:
                self._partials.append(self._strip_errs(
                    self._passthrough_step(batch)))
            else:  # FINAL/INTERMEDIATE inputs already are state batches
                self._partials.append(batch)
            self._buffered_rows += batch.capacity
            if self._buffered_rows > self._SINGLE_MERGE_MAX_ROWS:
                merged = self._shrink(self._compact_step(
                    concat_batches(self._partials)))
                self._partials = [merged]
                self._buffered_rows = merged.capacity
            return
        if self._abandoned:
            self.passthrough_batches += 1
            self._outputs.append(self._strip_errs(
                self._passthrough_step(batch)))
            return
        self._batches_in += 1
        if self._step is P.AggregationStep.PARTIAL:
            self._in_rows.append(batch.num_active())
        self._partials.append(self._strip_errs(self._partial_step(batch)))
        if len(self._partials) >= self._compact_threshold:
            self._compact_partials()

    def _strip_errs(self, out: DeviceBatch) -> DeviceBatch:
        if out.errors is not None:
            self.error_scalars.append(out.errors)
            out = DeviceBatch(out.columns, out.mask)
        return out

    def _may_abandon(self) -> bool:
        # vector states are never passed through: a row's HLL state is
        # 2 KB
        return (self._step is P.AggregationStep.PARTIAL
                and not self._abandoned and not self._vector
                and bool(self._in_rows))

    def _compact_partials(self):
        """Fold all pending partial runs into one right-sized state
        batch (the analogue of HashTable::decideHashMode's resize). One
        host read gives the group count, the shrink's tails and, for a
        PARTIAL step, the input rows that decide abandonment."""
        merged = self._compact_step(concat_batches(self._partials))
        counts = self._pow2_suffix_actives(merged.mask)
        rows = None
        if self._may_abandon():
            counts = torch.cat([counts, sum(self._in_rows).reshape(1).to(
                counts.dtype)])
        host = counts.tolist()
        if self._may_abandon():
            rows = host.pop()
        num_groups, tails = host[0], host[1:]
        if rows is not None and rows >= self._abandon_min_rows \
                and num_groups >= self._abandon_min_pct * rows:
            # grouping does not reduce the rows: emit the run and pass
            # every later batch through
            self._abandoned = True
            self.abandoned_at = (rows, num_groups, self._batches_in)
            self._outputs.append(merged)
            self._partials = []
            return
        merged = self._shrink(merged, num_groups, tails)
        if self._host_offload:
            M.record_counter(M.K_AGG_HOST_OFFLOADS)
            self._host_runs.append(HostBatch(merged))
            self._partials = []
        else:
            self._partials = [merged]

    @staticmethod
    def _pow2_suffix_actives(mask: torch.Tensor):
        """(active count, active rows at positions >= 2^k for each power
        of two below the capacity), read together in one host sync."""
        cap = mask.shape[0]
        cm = torch.cumsum(mask.to(torch.int64), 0)
        total = cm[-1:]
        bounds = [1 << k for k in range(max(1, cap - 1).bit_length())
                  if (1 << k) < cap]
        if not bounds:
            return total
        idx = torch.tensor([b - 1 for b in bounds], device=mask.device)
        return torch.cat([total, total - cm[idx]])

    def _shrink(self, merged: DeviceBatch, num_groups: Optional[int] = None,
                tails=None) -> DeviceBatch:
        """Cut a compacted run down to a power-of-two capacity near its
        group count when no active row lies past it (one host read, unless
        the caller read the counts already)."""
        cap = merged.capacity
        if num_groups is None:
            counts = self._pow2_suffix_actives(merged.mask).tolist()
            num_groups, tails = counts[0], counts[1:]
        want = max(1024, 1 << max(1, num_groups - 1).bit_length())
        if want < cap:
            # array mode scatters groups over the domain: cut only when
            # the rows past `want` are all inactive
            k = max(0, want.bit_length() - 1)
            tail = tails[k] if k < len(tails) else 0
            if tail == 0:
                merged = slice_batch(merged, 0, want)
        return merged

    def no_more_input(self):
        super().no_more_input()
        if self._collect_mode:
            if self._collect_rows:
                merged = concat_batches(self._collect_rows)
                self._collect_rows = []
                if not self._pct_split:
                    self._outputs.append(self._collect_finalize(merged))
                elif self._step is P.AggregationStep.FINAL:
                    self._outputs.append(self._pct_final(merged))
                else:  # PARTIAL/INTERMEDIATE: the knot summary
                    self._outputs.append(self._pct_compress(merged))
            return
        if not self._keys:
            self._outputs = [self._extract_global()]
            return
        if self._host_runs:
            self._partials = [h.restore() for h in self._host_runs] \
                + self._partials
            self._host_runs = []
        if not self._partials:
            return
        total_cap = sum(b.capacity for b in self._partials)
        if total_cap <= self._SINGLE_MERGE_MAX_ROWS:
            # one sort over everything buffered, then shrink the output
            # capacity to about the group count
            self._outputs.append(self._shrink(self._merge_step(
                concat_batches(self._partials))))
            self._partials = []
            return
        # hierarchical run merge: fold runs k at a time so peak memory is
        # bounded by k runs + one table (velox's multi-level spill merge)
        k = 4
        runs = self._partials
        self._partials = []
        while len(runs) > 1:
            head, runs = runs[:k], runs[k:]
            runs.append(self._shrink(self._compact_step(
                concat_batches(head))))
        self._outputs.append(self._merge_step(runs[0]))

    def get_output(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def is_finished(self):
        return self._no_more_input and not self._outputs

    # ---- global (no grouping keys) ----------------------------------------

    def _accumulate_global(self, batch: DeviceBatch):
        if self._global_state is None:
            self._global_state = self._identity_state()
        errs: list = []
        batch = self._pre(batch, errs)
        raw = self._step in (P.AggregationStep.PARTIAL,
                             P.AggregationStep.SINGLE)
        _, addends, _ = self._eval_keys_and_addends(batch, raw,
                                                    err_sink=errs)
        new_state = []
        for (data, combine), s in zip(addends, self._global_state):
            if isinstance(data, RegisterAddend):
                new_state.append(s.scatter_reduce(0, data.reg, data.val,
                                                  reduce="amax"))
            elif combine == "sum":
                new_state.append(s + data.sum(0, dtype=s.dtype))
            elif combine == "min":
                new_state.append(torch.minimum(s, data.min(0).values))
            else:
                new_state.append(torch.maximum(s, data.max(0).values))
        self._global_state = new_state
        if errs:
            self.error_scalars.append(sum(errs))

    def _identity_state(self) -> List[torch.Tensor]:
        out = []
        for agg in self._aggs:
            for st in agg.states:
                if st.width > 1:  # registers: >= 0, so max starts at 0
                    out.append(torch.zeros((st.width,),
                                           dtype=st.dtype.torch_dtype(),
                                           device=self._device))
                    continue
                out.append(torch.as_tensor(
                    np.asarray(st.identity(), st.dtype.np_dtype()),
                    device=self._device))
        return out

    def _extract_global(self) -> DeviceBatch:
        state = self._global_state
        if state is None:  # no input batch: every state is its identity
            state = self._identity_state()
        one = torch.ones((1,), dtype=torch.bool, device=self._device)
        out_cols: Dict[str, DeviceColumn] = {}
        i = 0
        if self._step in (P.AggregationStep.PARTIAL,
                          P.AggregationStep.INTERMEDIATE):
            for out_name, agg in zip(self._agg_names, self._aggs):
                for st in agg.states:
                    out_cols[_state_col_name(out_name, agg, st.suffix)] = \
                        DeviceColumn(state[i].unsqueeze(0), None, st.dtype)
                    i += 1
            return DeviceBatch(out_cols, one)
        for out_name, agg, d in zip(self._agg_names, self._aggs,
                                    self._agg_dicts):
            n_states = len(agg.states)
            res = agg.extract([s.unsqueeze(0)
                               for s in state[i:i + n_states]], one)
            i += n_states
            out_cols[out_name] = self._result_column(res, 1, d)
        return DeviceBatch(out_cols, one)


def _run_lengths(keep, gid, boundary, act_s, gmask) -> torch.Tensor:
    """Each group's count of kept sorted rows (int32), 0 past the last
    group, so the counts' prefix sum is each group's first element."""
    n = segmented_reduce_sorted((keep & act_s).to(torch.int64), gid,
                                boundary, act_s, gmask.shape[0], "sum")
    return torch.where(gmask, n, 0).to(torch.int32)


def _run_heads(pass_: torch.Tensor, vb: torch.Tensor, cap: int):
    """The first passing sorted row of each (group, value) run."""
    p64 = pass_.to(torch.int64)
    run_id = torch.cumsum(vb.to(torch.int64), 0) - 1
    ce = torch.cumsum(p64, 0) - p64
    start_ce = scatter_unique_set(cap + 1, torch.where(vb, run_id, cap),
                                  ce)[:cap]
    return pass_ & (ce == take_rows(start_ce, run_id))


def _run_sizes(pass_: torch.Tensor, vb: torch.Tensor, cap: int):
    """Per sorted row, the passing rows of its (group, value) run."""
    p64 = pass_.to(torch.int64)
    run_id = torch.cumsum(vb.to(torch.int64), 0) - 1
    c = torch.cumsum(p64, 0)
    start = scatter_unique_set(cap + 1, torch.where(vb, run_id, cap),
                               c - p64)[:cap]
    is_end = torch.ones_like(vb)
    is_end[:-1] = vb[1:]
    end = scatter_unique_set(cap + 1, torch.where(is_end, run_id, cap),
                             c)[:cap]
    return take_rows(end - start, run_id)


def _array_agg(agg, v: EvalValue, row_active, skeleton, perm, gmask,
               cap: int) -> DeviceColumn:
    """array_agg: the passing rows of each group in the keys-only sort's
    order, the input order (the sort is stable), NULLs kept."""
    gid, boundary, act_s = skeleton
    keep = row_active[perm]
    val = None if v.validity is None else v.full_validity(cap)[perm]
    ((d, dv),) = compact_kept([(take_rows(v.full_data(cap), perm), val)],
                              keep & act_s)
    child = DeviceColumn(d, dv, agg.result_type.children[0], v.dictionary)
    return DeviceColumn(_run_lengths(keep, gid, boundary, act_s, gmask),
                        gmask, agg.result_type, None, (child,))


def _masked_state(data: torch.Tensor, keep: torch.Tensor,
                  st) -> torch.Tensor:
    """An intermediate state column with its inactive rows at the
    combine's identity; a vector state's rows at 0 (registers are >=
    0)."""
    if data.dim() > 1:
        return torch.where(keep[:, None], data, 0)
    return masked(data, keep, st.identity())


def _picked(v: EvalValue, perm: torch.Tensor, tgt: torch.Tensor,
            idx: Optional[torch.Tensor], valid: torch.Tensor,
            dtype: T.DataType) -> DeviceColumn:
    """A collect kind's result column: the value's rows in ``perm``
    order scattered to ``tgt`` (one a group, or a compaction), then taken
    at ``idx`` when given; a long decimal's high limb the same way."""
    cap = perm.shape[0]

    def pick(rows: torch.Tensor) -> torch.Tensor:
        out = scatter_unique_set(cap + 1, tgt, take_rows(rows, perm))[:cap]
        return out if idx is None else take_rows(out, idx)
    children = ()
    if v.dtype.is_long_decimal:
        children = (DeviceColumn(pick(v.full_hi(cap)), None, T.BIGINT),)
    return DeviceColumn(pick(v.full_data(cap)), valid, dtype, v.dictionary,
                        children)


def _gather_value(v: EvalValue, perm: torch.Tensor, cap: int
                  ) -> DeviceColumn:
    """A value's rows in ``perm`` order as a column (B5 for its 4- and
    8-byte arrays, a long decimal's high limb with it)."""
    validity = None if v.validity is None else v.full_validity(cap)[perm]
    children = ()
    if v.dtype.is_long_decimal:
        children = (DeviceColumn(take_rows(v.full_hi(cap), perm), None,
                                 T.BIGINT),)
    return DeviceColumn(take_rows(v.full_data(cap), perm), validity,
                        v.dtype, v.dictionary, children)

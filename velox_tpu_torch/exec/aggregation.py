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
one grouped run past ``_SINGLE_MERGE_MAX_ROWS``.

Collect mode (the reference's collect pathway): when an aggregate has no
segment-combinable state (min_by/max_by, and min/max over a long
decimal), the operator retains each batch's keys and aggregate inputs and
computes every aggregate at the end from one radix sort of the rows by
(group keys, value). Single-step only, as in the reference.

Not ported: the other collect aggregates (array_agg, approx_percentile,
...; ROADMAP A.5), host offload of partial runs, partial-aggregation
abandonment, and the reference's compiled-program caches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec import groupby as G
from velox_tpu_torch.exec.batch_utils import concat_batches, slice_batch
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.expression.eval import (
    EvalCtx, ExprSet, value_from_column,
)
from velox_tpu_torch.functions.aggregates import (
    CollectAgg, masked, resolve_aggregate,
)
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn


def _state_col_name(out_name: str, agg, suffix: str) -> str:
    if len(agg.states) == 1:
        return out_name
    return f"{out_name}${suffix}"


class AggregationOperator(Operator):
    """Group-by or global aggregation over one plan node."""

    # fold accumulated partial runs when this many pile up
    _COMPACT_THRESHOLD = 8
    # single-shot buffers fold into one grouped run past this many rows
    _SINGLE_MERGE_MAX_ROWS = 1 << 24

    def __init__(self, node: P.AggregationNode, device, pre_fn=None):
        super().__init__(node)
        self._device = torch.device(device)
        # the fused upstream Filter/Project chain (exec/fuse.py), applied
        # to each batch before the aggregation reads it
        self._pre_fn = pre_fn
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
        # collect mode: retain rows, aggregate once at the end
        self._collect_mode = any(isinstance(a, CollectAgg)
                                 for a in self._aggs)
        if self._collect_mode and self._step is not P.AggregationStep.SINGLE:
            raise NotImplementedError(
                "collect aggregates (min_by/max_by, min/max over "
                "DECIMAL(19..38)) support single-step aggregation only")
        self._collect_rows: List[DeviceBatch] = []
        self._partials: List[DeviceBatch] = []
        self._outputs: List[DeviceBatch] = []
        self.error_scalars: List[torch.Tensor] = []  # read by the Task
        # single-shot: one sort over every buffered row beats a sort per
        # batch plus a sort of the concatenated partials
        self._single_shot = (bool(self._keys) and not self._collect_mode
                             and self._step is not P.AggregationStep.PARTIAL)
        self._buffered_rows = 0
        # string aggregate outputs carry the input dictionary over
        self._agg_dicts: List = [None] * len(self._aggs)
        self._global_state: Optional[List[torch.Tensor]] = None

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
                    addends.append((masked(col.full_data(cap), keep,
                                           st.identity()), st.combine))
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
        return gk, gs, gmask, cap

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
        """Per-row states without grouping (single-shot SINGLE input)."""
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
                addends.append((masked(data, active, st.identity()),
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

    def _collect_prep(self, batch: DeviceBatch) -> DeviceBatch:
        """The rows to retain: grouping keys, every aggregate's evaluated
        inputs (``__a{i}_{j}``) and masks (``__m{i}``)."""
        errs: list = []
        batch = self._pre(batch, errs)
        cap = batch.capacity
        out: Dict[str, DeviceColumn] = {
            k.name: batch.columns[k.name] for k in self._keys}
        for i, call in enumerate(self._agg_calls):
            if call.inputs:
                sink: list = []
                vals = ExprSet(list(call.inputs), None).eval_batch(
                    batch, err_sink=sink)
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
        from velox_tpu_torch.ops.wide import segmented_reduce_sorted
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
            if isinstance(agg, CollectAgg):
                out_cols[out_name] = self._collect_min_max_by(
                    agg, args, row_active, keys, active, gmask, cap)
                continue
            arrays = agg.map_raw(ctx, args, row_active)
            gs = [segmented_reduce_sorted(a[perm], gid, boundary, act_s,
                                          cap, st.combine)
                  for a, st in zip(arrays, agg.states)]
            out_cols[out_name] = self._result_column(
                agg.extract(gs, gmask), cap, self._agg_dicts[i])
        mask_out = gmask
        if not self._keys:
            # a global aggregation has exactly one output row (NULL
            # results when no row passed)
            mask_out = torch.zeros((cap,), dtype=torch.bool,
                                   device=merged.device)
            mask_out[0] = True
        return DeviceBatch(out_cols, mask_out)

    def _collect_min_max_by(self, agg, args, row_active, keys, active,
                            gmask, cap: int) -> DeviceColumn:
        """min_by/max_by: rows sorted by (group, y); the first (min_by) or
        last (max_by) passing row's x in each group. min/max over a long
        decimal pass one argument, both x and y. The group numbering is
        the skeleton's: the same key words and active flag lead the
        sort."""
        from velox_tpu_torch.ops.wide import (
            scatter_unique_set, segment_offsets, segmented_reduce_sorted,
        )
        x, y = (args[0], args[0]) if len(args) == 1 else args
        perm, gid, boundary, act_s, _ = G.sorted_group_info_vals(
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

        def pick(rows: torch.Tensor) -> torch.Tensor:
            return scatter_unique_set(cap + 1, tgt, rows[perm])[:cap]

        gvalid = gmask & (n_pass > 0)
        if x.validity is not None:
            xv = torch.ones((cap + 1,), dtype=torch.bool, device=perm.device)
            xv[tgt] = x.full_validity(cap)[perm]
            gvalid = gvalid & xv[:cap]
        children = ()
        if x.dtype.is_long_decimal:
            # the high limb goes through the same gather and scatter
            children = (DeviceColumn(pick(x.full_hi(cap)), None, T.BIGINT),)
        return DeviceColumn(pick(x.full_data(cap)), gvalid,
                            agg.result_type, x.dictionary, children)

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
        self._partials.append(self._strip_errs(self._partial_step(batch)))
        if len(self._partials) >= self._COMPACT_THRESHOLD:
            self._compact_partials()

    def _strip_errs(self, out: DeviceBatch) -> DeviceBatch:
        if out.errors is not None:
            self.error_scalars.append(out.errors)
            out = DeviceBatch(out.columns, out.mask)
        return out

    def _compact_partials(self):
        """Fold all pending partial runs into one right-sized state
        batch (the analogue of HashTable::decideHashMode's resize)."""
        merged = self._compact_step(concat_batches(self._partials))
        self._partials = [self._shrink(merged)]

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

    def _shrink(self, merged: DeviceBatch) -> DeviceBatch:
        """Cut a compacted run down to a power-of-two capacity near its
        group count when no active row lies past it (one host read)."""
        cap = merged.capacity
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
                self._outputs.append(self._collect_finalize(merged))
            return
        if not self._keys:
            self._outputs = [self._extract_global()]
            return
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
            if combine == "sum":
                new_state.append(s + data.sum(0, dtype=s.dtype))
            elif combine == "min":
                new_state.append(torch.minimum(s, data.min(0).values))
            else:
                new_state.append(torch.maximum(s, data.max(0).values))
        self._global_state = new_state
        if errs:
            self.error_scalars.append(sum(errs))

    def _identity_state(self) -> List[torch.Tensor]:
        return [torch.as_tensor(np.asarray(st.identity(),
                                           st.dtype.np_dtype()),
                                device=self._device)
                for agg in self._aggs for st in agg.states]

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
                        DeviceColumn(state[i].reshape(1), None, st.dtype)
                    i += 1
            return DeviceBatch(out_cols, one)
        for out_name, agg, d in zip(self._agg_names, self._aggs,
                                    self._agg_dicts):
            n_states = len(agg.states)
            res = agg.extract([s.reshape(1) for s in state[i:i + n_states]],
                              one)
            i += n_states
            out_cols[out_name] = self._result_column(res, 1, d)
        return DeviceBatch(out_cols, one)

"""Streaming aggregation: group-by over key-sorted input, no table.

Counterpart of ``velox_tpu/exec/streaming_agg.py``
(velox/exec/StreamingAggregation.h:29): when rows arrive sorted by the
grouping keys, groups are contiguous runs; states accumulate run by run
and a group is final the moment its key changes. Per input batch:

1. active rows compact stably to a dense prefix (the input order is the
   group order, so nothing is sorted);
2. run boundaries come from adjacent key comparison, and each run's
   addends reduce (ops/wide.py ``segmented_reduce_sorted``);
3. the carried last group's state merges into the first run when that
   run continues it;
4. every run but the last is emitted; the last run's key and state carry
   forward as 0-dim device tensors (no host read a batch).

``no_more_input`` flushes the carry as the final group. Only aggregates
whose states are segment-combinable scalars stream; collect aggregates go
through the regular AggregationOperator.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.aggregation import AggregationOperator
from velox_tpu_torch.exec.groupby import group_keys_sorted
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.functions.aggregates import CollectAgg, resolve_aggregate
from velox_tpu_torch.ops.wide import scatter_unique_set, segmented_reduce_sorted
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn
from velox_tpu_torch.vector.strings import reject_raw

_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def streaming_supported(node: P.AggregationNode) -> bool:
    """SINGLE-step grouped aggregation with scalar combinable states (no
    collect aggregates)."""
    if node.step is not P.AggregationStep.SINGLE or not node.grouping_keys:
        return False
    try:
        aggs = [resolve_aggregate(a.name, [i.dtype for i in a.inputs])
                for a in node.aggregates]
    except (KeyError, NotImplementedError):
        return False
    return not any(isinstance(a, CollectAgg)
                   or any(st.width > 1 for st in a.states) for a in aggs)


def _shift(a: torch.Tensor) -> torch.Tensor:
    """The previous row's value (row 0 its own)."""
    return torch.cat([a[:1], a[:-1]])


class StreamingAggregationOperator(Operator):
    """Group-by over input sorted by the grouping keys."""

    # the keys and per-row state addends, as the aggregation computes them
    _eval_keys_and_addends = AggregationOperator._eval_keys_and_addends

    def __init__(self, node: P.AggregationNode):
        super().__init__(node)
        if not streaming_supported(node):
            raise ValueError("aggregation cannot stream")
        self._keys = list(node.grouping_keys)
        self._agg_calls = list(node.aggregates)
        self._agg_names = list(node.aggregate_names)
        self._aggs = [resolve_aggregate(a.name, [i.dtype for i in a.inputs])
                      for a in self._agg_calls]
        self._specs = [st for a in self._aggs for st in a.states]
        self._outputs: List[DeviceBatch] = []
        self.error_scalars: List[torch.Tensor] = []  # read by the Task
        self._carry = None
        self._key_dicts: List = [None] * len(self._keys)
        self._agg_dicts: List = [None] * len(self._aggs)

    def _empty_carry(self, device):
        def zero(dt, value=0):
            return torch.full((), value, dtype=dt, device=device)
        kd = tuple(zero(k.dtype.torch_dtype()) for k in self._keys)
        kv = tuple(zero(torch.bool, True) for _ in self._keys)
        states = tuple(torch.as_tensor(st.identity(), device=device)
                       for st in self._specs)
        return (zero(torch.bool, False), kd, kv, states)

    def _batch_step(self, batch: DeviceBatch, carry):
        cvalid, ckd, ckv, cstates = carry
        errs: list = []
        keys, addends, active = self._eval_keys_and_addends(
            batch, True, err_sink=errs)
        cap = batch.capacity
        dev = batch.device
        iota = torch.arange(cap, dtype=torch.int64, device=dev)
        # 1. stable compaction of active rows to a dense prefix
        pos = torch.cumsum(active.to(torch.int64), 0) - 1
        tgt = torch.where(active, pos, cap)
        n_rows = active.sum(dtype=torch.int64)
        active_d = iota < n_rows
        # 2. run boundaries by adjacent comparison of the dense keys
        dkeys = []
        neq = torch.zeros((cap,), dtype=torch.bool, device=dev)
        for v in keys:
            kd = scatter_unique_set(cap + 1, tgt, v.full_data(cap))[:cap]
            ne = kd != _shift(kd)
            kv = None
            if v.validity is not None:
                kv = torch.ones((cap + 1,), dtype=torch.bool, device=dev)
                kv[tgt] = v.full_validity(cap)
                kv = kv[:cap]
                pv = _shift(kv)
                neq = neq | (kv != pv)
                ne = ne & kv & pv  # null == null: only non-null diffs split
            neq = neq | ne
            dkeys.append(EvalValue(kd, kv, v.dtype, v.dictionary))
        boundary = neq.clone()
        boundary[0] = True
        gid = torch.cumsum(boundary.to(torch.int64), 0) - 1
        num_groups = (boundary & active_d).sum(dtype=torch.int64)
        gstates = []
        for (data, combine), st in zip(addends, self._specs):
            dd = scatter_unique_set(cap + 1, tgt, data)[:cap]
            dd = torch.where(active_d, dd,
                             torch.as_tensor(st.identity(), device=dev)
                             .to(dd.dtype))
            gstates.append(segmented_reduce_sorted(
                dd, gid, boundary, active_d, cap, combine))
        gkeys, _ = group_keys_sorted(dkeys, iota, gid, boundary, active_d,
                                     num_groups, cap)
        # 3. the carry continues group 0 iff the keys are equal (null ==
        #    null)
        same = cvalid & (num_groups > 0)
        for ck, ckvf, gv in zip(ckd, ckv, gkeys):
            g0 = gv.data[0]
            g0v = gv.validity[0] if gv.validity is not None \
                else torch.ones((), dtype=torch.bool, device=dev)
            same = same & ((g0v & ckvf & (g0 == ck)) | (~g0v & ~ckvf))
        for g, cs, st in zip(gstates, cstates, self._specs):
            g[0] = torch.where(same, _COMBINE[st.combine](
                g[0], cs.to(g.dtype)), g[0])
        # 4. emit: row 0 the old carry when it does not continue, rows
        #    1..cap groups 0..num_groups-2 (the last group is held back)
        emit_carry = cvalid & ~same & (num_groups > 0)
        out_active = torch.cat([emit_carry[None], iota < num_groups - 1])
        out_states = [torch.cat([cs.to(g.dtype)[None], g])
                      for cs, g in zip(cstates, gstates)]
        out_keys = []
        for ck, ckvf, gv in zip(ckd, ckv, gkeys):
            data = torch.cat([ck.to(gv.data.dtype)[None], gv.data])
            validity = None
            if gv.validity is not None:
                validity = torch.cat([ckvf[None], gv.validity])
            out_keys.append((data, validity))
        out = self._extract(out_keys, out_states, out_active)
        # the new carry: the held-back last group (or the old carry)
        has = num_groups > 0
        last = torch.clamp(num_groups - 1, 0, cap - 1)
        nckd = tuple(torch.where(has, gv.data[last].to(ck.dtype), ck)
                     for ck, gv in zip(ckd, gkeys))
        nckv = tuple(torch.where(
            has, gv.validity[last] if gv.validity is not None else True,
            ckvf) for ckvf, gv in zip(ckv, gkeys))
        ncst = tuple(torch.where(has, g[last].to(cs.dtype), cs)
                     for cs, g in zip(cstates, gstates))
        err = sum(errs) if errs else None
        return out, (cvalid | has, nckd, nckv, ncst), err

    def _extract(self, out_keys, out_states, out_active) -> DeviceBatch:
        m = out_active.shape[0]
        cols: Dict[str, DeviceColumn] = {}
        for k, (data, validity), d in zip(self._keys, out_keys,
                                          self._key_dicts):
            cols[k.name] = DeviceColumn(data, validity, k.dtype, d)
        i = 0
        for out_name, agg, d in zip(self._agg_names, self._aggs,
                                    self._agg_dicts):
            n = len(agg.states)
            res = agg.extract(out_states[i:i + n], out_active)
            i += n
            cols[out_name] = AggregationOperator._result_column(res, m, d)
        return DeviceBatch(cols, out_active)

    def _flush(self, carry) -> DeviceBatch:
        cvalid, ckd, ckv, cstates = carry
        out_keys = [(ck[None], kv[None]) for ck, kv in zip(ckd, ckv)]
        out_states = [cs[None] for cs in cstates]
        return self._extract(out_keys, out_states, cvalid[None])

    # ---- operator contract ---------------------------------------------------

    def add_input(self, batch: DeviceBatch):
        # input dictionaries, for the string keys and aggregates
        from velox_tpu_torch.core import expressions as ex
        reject_raw([batch.columns.get(k.name) for k in self._keys],
                   "streaming aggregation")
        for i, k in enumerate(self._keys):
            col = batch.columns.get(k.name)
            if col is not None and self._key_dicts[i] is None:
                self._key_dicts[i] = col.dictionary
        for j, call in enumerate(self._agg_calls):
            if call.inputs and call.inputs[0].dtype.is_string \
                    and isinstance(call.inputs[0], ex.FieldAccess):
                col = batch.columns.get(call.inputs[0].name)
                if col is not None:
                    self._agg_dicts[j] = col.dictionary
        if self._carry is None:
            self._carry = self._empty_carry(batch.device)
        out, self._carry, err = self._batch_step(batch, self._carry)
        if err is not None:
            self.error_scalars.append(err)
        self._outputs.append(out)

    def no_more_input(self):
        super().no_more_input()
        if self._carry is not None:
            self._outputs.append(self._flush(self._carry))

    def get_output(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def is_finished(self):
        return self._no_more_input and not self._outputs

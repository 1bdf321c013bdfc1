"""Smaller relational operators.

Counterpart of ``velox_tpu/exec/misc_ops.py`` (all under velox/exec/):

* ``MarkDistinctOperator`` (MarkDistinct.h): a boolean marker on the
  first row of each distinct key tuple in the stream, from the growing
  hash table of exec/hashtable.py.
* ``AssignUniqueIdOperator`` (AssignUniqueId.h): the task id at bit 40
  plus a running row counter kept on the device.
* ``EnforceSingleRowOperator`` (EnforceSingleRow.h): more than one input
  row raises; no row gives one all-NULL row.
* ``ExpandOperator`` (Expand.h) and ``GroupIdOperator`` (GroupId.h): one
  copy of each batch per projection set or grouping set.
* ``NestedLoopJoinOperator`` (NestedLoopJoinProbe.h): every probe row
  against every build row, optionally filtered; inner, left, right and
  full joins, with per-side match tracking across chunks. The product is
  expanded in chunks of the probe batch's capacity; each chunk's probe and
  build columns come through kernel B5, all of a side's arrays through one
  index (exec/batch_utils.py ``take_columns_rows``).

* ``UnnestOperator`` (Unnest.h): one row per ARRAY or MAP element, with
  an optional ordinality, the other columns repeated. Its output capacity
  is the element capacity, so a dense column needs no host read; the
  repeated columns and the elements come through kernel B5.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec import hashtable as H
from velox_tpu_torch.exec.batch_utils import (
    compact, concat_batches, take_columns_rows,
)
from velox_tpu_torch.exec.join import _null_column, null_like
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.expression.eval import ExprSet, value_from_column
from velox_tpu_torch.ops.gather import take_rows
from velox_tpu_torch.vector.device import (
    DeviceBatch, DeviceColumn, default_capacity,
)
from velox_tpu_torch.vector.strings import reject_raw


def _project(node, out: DeviceBatch) -> DeviceBatch:
    if node.output_columns:
        out = DeviceBatch({n: out.columns[n] for n in node.output_columns},
                          out.mask)
    return out


class EnforceSingleRowOperator(Operator):
    """Errors unless the input has at most one row (scalar subqueries);
    an empty input gives one all-NULL row."""

    def __init__(self, node: P.EnforceSingleRowNode):
        super().__init__(node)
        self._batches: List[DeviceBatch] = []
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch: DeviceBatch):
        self._batches.append(batch)

    def no_more_input(self):
        super().no_more_input()
        if not self._batches:
            raise RuntimeError("EnforceSingleRow: no input batches")
        merged = concat_batches(self._batches)
        self._batches = []
        n = int(merged.num_active())
        if n > 1:
            raise RuntimeError(
                f"Expected single row of input, received {n} rows")
        if n == 1:
            self._out = compact(merged)
            return
        cap, dev = merged.capacity, merged.device
        cols = {}
        for name, c in merged.columns.items():
            children = tuple(
                DeviceColumn(torch.zeros_like(ch.data), None, ch.dtype)
                for ch in c.children)
            cols[name] = DeviceColumn(
                torch.zeros_like(c.data),
                torch.zeros((cap,), dtype=torch.bool, device=dev), c.dtype,
                c.dictionary, children)
        mask = torch.zeros((cap,), dtype=torch.bool, device=dev)
        mask[0] = True
        self._out = DeviceBatch(cols, mask)

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None


class NestedLoopJoinOperator(Operator):
    """Cross or inequality join: every probe row against every build row,
    optionally filtered. LEFT/RIGHT/FULL joins track which probe rows and
    build rows found a passing match."""

    def __init__(self, node: P.NestedLoopJoinNode):
        super().__init__(node)
        self._node = node
        jt = node.join_type
        self._track_probe = jt in (P.JoinType.LEFT, P.JoinType.FULL)
        self._track_build = jt in (P.JoinType.RIGHT, P.JoinType.FULL)
        self._build: Optional[DeviceBatch] = None
        self._build_n = 0
        self._build_matched = None   # bool[build capacity], OR of chunks
        self._probe_template: Optional[Dict[str, DeviceColumn]] = None
        self._outputs: List[DeviceBatch] = []

    def set_build(self, build: DeviceBatch):
        """The whole build side, its active rows moved to the front (one
        host read of their count)."""
        self._build = compact(build)
        self._build_n = int(build.num_active())
        if self._track_build:
            self._build_matched = torch.zeros(
                (self._build.capacity,), dtype=torch.bool,
                device=build.device)

    def _emit(self, batch: DeviceBatch, n_probe: int, start: int):
        """Rows [start, start + capacity) of the probe x build product
        (probe-major), and the probe and build rows that passed. The probe
        batch is compacted: its active rows are a prefix."""
        node, build = self._node, self._build
        cap, dev = batch.capacity, batch.device
        nb = max(self._build_n, 1)
        j = start + torch.arange(cap, dtype=torch.int64, device=dev)
        valid = j < nb * n_probe
        prow = torch.clamp(torch.div(j, nb, rounding_mode="floor"),
                           0, cap - 1).to(torch.int32)
        brow = torch.clamp(torch.remainder(j, nb), 0,
                           build.capacity - 1).to(torch.int32)
        cols = take_columns_rows(batch.columns, prow)
        cols.update(take_columns_rows(build.columns, brow))
        out = DeviceBatch(cols, valid)
        if node.filter is not None:
            f = ExprSet([node.filter], None).eval_batch(out)[0]
            passed = f.full_data(cap).to(torch.bool)
            if f.validity is not None:
                passed = passed & f.full_validity(cap)
            out = DeviceBatch(out.columns, out.mask & passed)
        pm = bm = None
        if self._track_probe:
            pm = torch.zeros((cap + 1,), dtype=torch.bool, device=dev)
            pm[torch.where(out.mask, prow.long(), cap)] = True
            pm = pm[:cap]
        if self._track_build:
            bcap = build.capacity
            bm = torch.zeros((bcap + 1,), dtype=torch.bool, device=dev)
            bm[torch.where(out.mask, brow.long(), bcap)] = True
            bm = bm[:bcap]
        return _project(node, out), pm, bm

    def _emit_probe_unmatched(self, batch: DeviceBatch, matched):
        """LEFT/FULL: probe rows with no passing match, build side NULL."""
        cap = batch.capacity
        cols = dict(batch.columns)
        for name, c in self._build.columns.items():
            cols[name] = null_like(c, cap, batch.device)
        return _project(self._node, DeviceBatch(cols, batch.mask & ~matched))

    def _emit_build_unmatched(self):
        """RIGHT/FULL: build rows with no passing match, probe side NULL."""
        build = self._build
        bcap, dev = build.capacity, build.device
        if self._probe_template is not None:
            cols = {name: null_like(c, bcap, dev)
                    for name, c in self._probe_template.items()}
        else:
            # the probe side gave no batch: its schema from the plan, a
            # string column with a one-value dictionary
            from velox_tpu_torch.vector.device import Dictionary
            lt = self._node.left.output_type()
            cols = {name: _null_column(dt, bcap, dev, Dictionary([""])
                                       if dt.is_string else None)
                    for name, dt in zip(lt.names, lt.children)}
        cols.update(build.columns)
        return _project(self._node,
                        DeviceBatch(cols, build.mask & ~self._build_matched))

    def add_input(self, batch: DeviceBatch):
        assert self._build is not None
        batch = compact(batch)
        if self._probe_template is None:
            self._probe_template = dict(batch.columns)
        n_probe = int(batch.num_active())
        total = n_probe * self._build_n
        cap = batch.capacity
        probe_matched = (torch.zeros((cap,), dtype=torch.bool,
                                     device=batch.device)
                         if self._track_probe else None)
        for start in range(0, total, cap):
            out, pm, bm = self._emit(batch, n_probe, start)
            self._outputs.append(out)
            if pm is not None:
                probe_matched = probe_matched | pm
            if bm is not None:
                self._build_matched = self._build_matched | bm
        if self._track_probe:
            self._outputs.append(
                self._emit_probe_unmatched(batch, probe_matched))

    def no_more_input(self):
        super().no_more_input()
        if self._track_build and self._build is not None:
            self._outputs.append(self._emit_build_unmatched())

    def get_output(self):
        if self._outputs:
            return self._outputs.pop(0)
        return None

    def needs_input(self):
        return not self._no_more_input and not self._outputs

    def is_finished(self):
        return self._no_more_input and not self._outputs


class MarkDistinctOperator(Operator):
    """Adds a boolean column marking the first row of each distinct key
    combination in the stream (hash-table backed, streaming). The table
    grows before a batch could fill it past one half."""

    def __init__(self, node: P.MarkDistinctNode):
        super().__init__(node)
        self._node = node
        self._table = H.StreamTable()
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch: DeviceBatch):
        node = self._node
        keys = [value_from_column(batch.columns[k.name])
                for k in node.distinct_keys]
        reject_raw(keys, "MarkDistinct")
        _, is_new = self._table.insert(keys, batch.mask, batch.capacity)
        cols = dict(batch.columns)
        cols[node.marker] = DeviceColumn(is_new, None, T.BOOLEAN)
        self._out = DeviceBatch(cols, batch.mask)

    def get_output(self):
        out, self._out = self._out, None
        return out

    def needs_input(self):
        return not self._no_more_input and self._out is None

    def is_finished(self):
        return self._no_more_input and self._out is None


class AssignUniqueIdOperator(Operator):
    """Adds a unique BIGINT per row: the task id at bit 40 plus a running
    counter of active rows, kept on the device."""

    def __init__(self, node: P.AssignUniqueIdNode):
        super().__init__(node)
        self._node = node
        self._counter: Optional[torch.Tensor] = None
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch: DeviceBatch):
        node = self._node
        m = batch.mask.to(torch.int64)
        if self._counter is None:
            self._counter = torch.zeros((), dtype=torch.int64,
                                        device=batch.device)
        ids = (self._counter + torch.cumsum(m, 0) - 1) \
            | (node.task_unique_id << 40)
        self._counter = self._counter + m.sum()
        cols = dict(batch.columns)
        cols[node.id_column] = DeviceColumn(ids, None, T.BIGINT)
        self._out = DeviceBatch(cols, batch.mask)

    def get_output(self):
        out, self._out = self._out, None
        return out

    def needs_input(self):
        return not self._no_more_input and self._out is None

    def is_finished(self):
        return self._no_more_input and self._out is None


class _CopiesOperator(Operator):
    """Emits ``copies(batch)`` for each input batch, one at a time."""

    def __init__(self, node: P.PlanNode):
        super().__init__(node)
        self._outs: List[DeviceBatch] = []

    def copies(self, batch: DeviceBatch) -> List[DeviceBatch]:
        raise NotImplementedError

    def add_input(self, batch: DeviceBatch):
        self._outs.extend(self.copies(batch))

    def get_output(self):
        if self._outs:
            return self._outs.pop(0)
        return None

    def needs_input(self):
        return not self._no_more_input and not self._outs

    def is_finished(self):
        return self._no_more_input and not self._outs


class ExpandOperator(_CopiesOperator):
    """One copy of the input per projection set (Spark EXPAND: grouping
    sets, distinct-aggregate rewrites)."""

    def __init__(self, node: P.ExpandNode):
        super().__init__(node)
        self._names = node.output_type().names
        self._sets = [ExprSet(list(ps), None) for ps in node.projection_sets]

    def copies(self, batch: DeviceBatch) -> List[DeviceBatch]:
        cap = batch.capacity
        return [DeviceBatch({n: v.to_column(cap) for n, v in zip(
            self._names, es.eval_batch(batch))}, batch.mask)
            for es in self._sets]


class GroupIdOperator(_CopiesOperator):
    """Grouping-sets expansion: per grouping set, the keys outside it
    NULL, the aggregation inputs, and a BIGINT group id."""

    def __init__(self, node: P.GroupIdNode):
        super().__init__(node)
        self._node = node
        self._keys = node.all_keys()

    def copies(self, batch: DeviceBatch) -> List[DeviceBatch]:
        node = self._node
        cap, dev = batch.capacity, batch.device
        outs = []
        for i, gs in enumerate(node.grouping_sets):
            cols: Dict[str, DeviceColumn] = {}
            for k in self._keys:
                col = batch.columns[k]
                if k in gs:
                    cols[k] = col
                    continue
                # a nulled-out key, stored as the column is
                cols[k] = DeviceColumn(
                    torch.zeros_like(col.data),
                    torch.zeros((cap,), dtype=torch.bool, device=dev),
                    col.dtype, col.dictionary,
                    tuple(DeviceColumn(torch.zeros_like(ch.data), None,
                                       ch.dtype) for ch in col.children))
            for a in node.aggregation_inputs:
                cols[a] = batch.columns[a]
            cols[node.group_id_name] = DeviceColumn(
                torch.full((cap,), i, dtype=torch.int64, device=dev), None,
                T.BIGINT)
            outs.append(DeviceBatch(cols, batch.mask))
        return outs


class UnnestOperator(Operator):
    """One row per element of an ARRAY (or entry of a MAP), with a 1-based
    ordinality when the node names one; the other columns repeat for
    each of their row's elements. Element j of the output belongs to the
    row whose running element count first exceeds j. The output capacity
    is the column's element capacity, which bounds a dense column's live
    elements, so nothing is read on the host; a column whose rows were
    gathered (explicit starts) may repeat elements, and reads its total
    once to size the output."""

    def __init__(self, node: P.UnnestNode):
        super().__init__(node)
        self._node = node
        st = node.source.output_type()
        ut = st.field_type(node.unnest_column)
        # the reference's limits (ROADMAP C)
        for n, t in zip(st.names, st.children):
            if n != node.unnest_column and t.is_complex:
                raise NotImplementedError(
                    "repeating complex columns through Unnest")
        if any(c.is_complex for c in ut.children):
            raise NotImplementedError("nested complex unnest")
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch: DeviceBatch):
        node = self._node
        cap = batch.capacity
        col = batch.columns[node.unnest_column]
        ecap = col.children[0].capacity
        valid = batch.mask
        if col.validity is not None:
            valid = valid & col.validity
        lens = torch.where(valid, col.data.to(torch.int64), 0)
        cum = torch.cumsum(lens, 0)
        out_cap = ecap
        if col.starts is not None:
            out_cap = max(ecap, default_capacity(int(cum[-1].item())))
        j = torch.arange(out_cap, dtype=torch.int64, device=batch.device)
        row_c = torch.clamp(torch.searchsorted(cum, j, right=True), 0,
                            cap - 1)
        within = j - (take_rows(cum, row_c) - take_rows(lens, row_c))
        src = torch.clamp(take_rows(col.offsets(), row_c) + within, 0,
                          ecap - 1)
        cols = take_columns_rows(
            {n: c for n, c in batch.columns.items()
             if n != node.unnest_column}, row_c)
        names = ([node.element_name, node.value_name]
                 if col.dtype.kind is T.TypeKind.MAP
                 else [node.element_name])
        cols.update(take_columns_rows(dict(zip(names, col.children)), src))
        if node.ordinality_name:
            cols[node.ordinality_name] = DeviceColumn(within + 1, None,
                                                      T.BIGINT)
        self._out = DeviceBatch(cols, j < cum[-1])

    def get_output(self):
        out, self._out = self._out, None
        return out

    def needs_input(self):
        return not self._no_more_input and self._out is None

    def is_finished(self):
        return self._no_more_input and self._out is None

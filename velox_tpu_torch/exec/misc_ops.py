"""EnforceSingleRow and the nested-loop join.

Counterpart of the two operators of ``velox_tpu/exec/misc_ops.py`` that
TPC-H's scalar subqueries need (Q11, Q22):

* ``EnforceSingleRowOperator`` (velox/exec/EnforceSingleRow.h): more than
  one input row raises; no row gives one all-NULL row.
* ``NestedLoopJoinOperator`` (velox/exec/NestedLoopJoinProbe.h): every
  probe row against every build row, optionally filtered; inner, left,
  right and full joins, with per-side match tracking across chunks. The
  product is expanded in chunks of the probe batch's capacity; each
  chunk's probe and build columns come through kernel B5, all of a side's
  arrays through one index (exec/batch_utils.py ``take_columns_rows``).

Not ported: MarkDistinct, AssignUniqueId, Expand, GroupId and Unnest
(ROADMAP A.5).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.batch_utils import (
    compact, concat_batches, take_columns_rows,
)
from velox_tpu_torch.exec.join import _null_column
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.expression.eval import ExprSet
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn


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
            cols[name] = _null_column(c.dtype, cap, batch.device,
                                      c.dictionary)
        return _project(self._node, DeviceBatch(cols, batch.mask & ~matched))

    def _emit_build_unmatched(self):
        """RIGHT/FULL: build rows with no passing match, probe side NULL."""
        build = self._build
        bcap, dev = build.capacity, build.device
        if self._probe_template is not None:
            probe = {name: (c.dtype, c.dictionary)
                     for name, c in self._probe_template.items()}
        else:
            # the probe side gave no batch: its schema from the plan, a
            # string column with a one-value dictionary
            from velox_tpu_torch.vector.device import Dictionary
            lt = self._node.left.output_type()
            probe = {name: (dt, Dictionary([""]) if dt.is_string else None)
                     for name, dt in zip(lt.names, lt.children)}
        cols = {name: _null_column(dt, bcap, dev, d)
                for name, (dt, d) in probe.items()}
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

"""Operator SPI + the stateless operators of the ported slice.

Counterpart of ``velox_tpu/exec/operator.py``: the needs_input /
add_input / get_output / no_more_input / is_finished contract
(velox/exec/Operator.h), the Values and TableScan sources, and the fused
Filter/Project operator. Each operator's per-batch work is eager torch
code on the batch's device; the driver loop in exec/task.py only moves
batch handles.

Not ported yet: the scan prefetch thread, the Values ingest cache and the
Arrow stream source.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from velox_tpu_torch.core import plan as P
from velox_tpu_torch.vector.device import DeviceBatch, from_arrow


@dataclass
class OperatorStats:
    """Parity: velox/exec/OperatorStats (TaskStats.h)."""
    operator_type: str = ""
    plan_node_id: str = ""
    input_batches: int = 0
    output_batches: int = 0
    # batch footprints (DeviceBatch.nbytes): every operator reads its input
    # bytes and writes its output bytes through device memory at least once
    input_bytes: int = 0
    output_bytes: int = 0
    add_input_wall_ns: int = 0
    get_output_wall_ns: int = 0
    finish_wall_ns: int = 0

    def as_dict(self):
        return dict(self.__dict__)


class Operator:
    """Push/pull operator contract (parity exec/Operator.h:398-434)."""

    def __init__(self, node: P.PlanNode):
        self.node = node
        self.stats = OperatorStats(operator_type=type(self).__name__,
                                   plan_node_id=node.id if node else "")
        self._no_more_input = False

    def needs_input(self) -> bool:
        return not self._no_more_input

    def add_input(self, batch: DeviceBatch) -> None:
        raise NotImplementedError

    def get_output(self) -> Optional[DeviceBatch]:
        raise NotImplementedError

    def no_more_input(self) -> None:
        self._no_more_input = True

    def is_finished(self) -> bool:
        raise NotImplementedError


class SourceOperator(Operator):
    """Source operators take no input."""

    def needs_input(self) -> bool:
        return False

    def add_input(self, batch):
        raise RuntimeError(f"{type(self).__name__} takes no input")


class ValuesOperator(SourceOperator):
    """Parity: velox/exec/Values.h:21. Uploads each pyarrow table (or
    passes through a ready DeviceBatch) to the query's device."""

    def __init__(self, node: P.ValuesNode, device):
        super().__init__(node)
        self._tables = list(node.tables)
        self._i = 0
        self._device = device

    def get_output(self):
        if self._i >= len(self._tables):
            return None
        t = self._tables[self._i]
        self._i += 1
        if isinstance(t, DeviceBatch):
            return t
        return from_arrow(t, device=self._device)

    def is_finished(self):
        return self._i >= len(self._tables)


class TableScanOperator(SourceOperator):
    """Parity: velox/exec/TableScan.cpp:75 — pulls splits in order, hands
    them to a connector DataSource, yields device batches."""

    def __init__(self, node: P.TableScanNode, data_source, splits):
        super().__init__(node)
        self._source = data_source
        self._splits = list(splits)
        self._i = 0

    def get_output(self):
        while self._i < len(self._splits):
            out = self._source.next(self._splits[self._i])
            if out is None:
                from velox_tpu_torch.common import metrics as M
                M.record_counter(M.K_SCAN_SPLITS)
                self._i += 1
                continue
            return out
        return None

    def is_finished(self):
        return self._i >= len(self._splits)


class FilterProjectOperator(Operator):
    """Fused filter + project (parity: velox/exec/FilterProject.h:24) over
    a batch function built by exec/fuse.py ``chain_fn``."""

    def __init__(self, node: P.PlanNode,
                 fn: Callable[[DeviceBatch], DeviceBatch]):
        super().__init__(node)
        self._fn = fn
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch):
        self._out = self._fn(batch)

    def get_output(self):
        out, self._out = self._out, None
        return out

    def needs_input(self):
        return not self._no_more_input and self._out is None

    def is_finished(self):
        return self._no_more_input and self._out is None


class LimitOperator(Operator):
    """Parity: velox/exec/Limit.h:20. The running row count stays on the
    device (no host sync per batch); rows past the limit are masked off."""

    def __init__(self, node: P.LimitNode):
        super().__init__(node)
        self._offset = node.offset
        self._count = node.count
        self._seen: Optional[torch.Tensor] = None  # 0-dim, on the device
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch):
        if self._seen is None:
            self._seen = torch.zeros((), dtype=torch.int64,
                                     device=batch.device)
        prefix = torch.cumsum(batch.mask.to(torch.int64), 0)
        pos = self._seen + prefix - 1  # 0-based global position of a row
        keep = batch.mask & (pos >= self._offset) \
            & (pos < self._offset + self._count)
        self._seen = self._seen + prefix[-1]
        self._out = DeviceBatch(batch.columns, keep)

    def get_output(self):
        out, self._out = self._out, None
        return out

    def needs_input(self):
        return not self._no_more_input and self._out is None

    def is_finished(self):
        return self._no_more_input and self._out is None

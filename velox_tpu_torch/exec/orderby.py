"""Sort operators: OrderBy and TopN.

Counterpart of ``velox_tpu/exec/orderby.py`` (velox/exec/OrderBy.h:35 and
TopN.h:23). PrefixSort's normalized binary keys become order-preserving
words fed to the counting radix sort of exec/sort.py, whose passes run
the kernels of ops/radix.py. TopN keeps a top-k buffer on the device and
merges it with each incoming batch (one key-only sort per batch, then a
gather of the k winning rows): the analogue of the reference's bounded
row-container heap.

OrderBy buffers its input in an ``OffloadBuffer`` (exec/memory.py): past
its device budget, batches go to host RAM and past the host budget to
spill files (velox Spiller kOrderBy); they come back in input order for
the one sort.
"""

from __future__ import annotations

from typing import Optional

import torch

from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.batch_utils import concat_batches, take
from velox_tpu_torch.exec.memory import OffloadBuffer
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.exec.sort import radix_sort_perm, sort_words
from velox_tpu_torch.expression.eval import value_from_column
from velox_tpu_torch.vector.device import DeviceBatch


def sort_batch(batch: DeviceBatch, keys, orders,
               ranges=None) -> DeviceBatch:
    """Stable sort of a batch's rows by keys/orders; inactive rows last.
    ``ranges`` (per key, optional) narrows the sort words via static
    column stats: fewer radix passes."""
    cap = batch.capacity
    key_vals = [value_from_column(batch.columns[k.name]) for k in keys]
    words, bits = sort_words(key_vals, orders, cap, batch.mask,
                             ranges=ranges)
    perm = radix_sort_perm(words, bits, cap)
    return take(batch, perm, batch.mask[perm])


def _key_ranges(node, keys):
    from velox_tpu_torch.core.stats import resolve_column_stats
    return tuple(resolve_column_stats(node.source, k.name) for k in keys)


class OrderByOperator(Operator):
    """Full sort: buffer all input in ``buffer``, sort once at the end.
    The Task hands it an ``OffloadBuffer`` with the query's spill
    settings; without one every batch stays on the device, unaccounted."""

    def __init__(self, node: P.OrderByNode,
                 buffer: Optional[OffloadBuffer] = None):
        super().__init__(node)
        self._keys = list(node.keys)
        self._orders = list(node.orders)
        self._ranges = _key_ranges(node, self._keys)
        self._buffer = buffer if buffer is not None else OffloadBuffer(None)
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch):
        self._buffer.add(batch)

    def no_more_input(self):
        super().no_more_input()
        if len(self._buffer):
            merged = concat_batches(self._buffer.restore_all())
            self._out = sort_batch(merged, self._keys, self._orders,
                                   self._ranges)

    def close(self):
        self._buffer.close()

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None


class TopNOperator(Operator):
    """Bounded sort: a device-resident top-k buffer, merged per batch."""

    def __init__(self, node: P.TopNNode):
        super().__init__(node)
        self._keys = list(node.keys)
        self._orders = list(node.orders)
        self._n = node.count
        self._ranges = _key_ranges(node, self._keys)
        self._topk: Optional[DeviceBatch] = None
        self._out: Optional[DeviceBatch] = None
        # buffer capacity: n rounded up for alignment
        self._buf_cap = max(1024, -(-node.count // 128) * 128)

    def _merge(self, buf: Optional[DeviceBatch],
               batch: DeviceBatch) -> DeviceBatch:
        """Key-only sort of buffer + batch, then a gather of the first
        buf_cap rows: the payload never rides the sort."""
        merged = concat_batches([buf, batch]) if buf is not None else batch
        cap = merged.capacity
        key_vals = [value_from_column(merged.columns[k.name])
                    for k in self._keys]
        words, bits = sort_words(key_vals, self._orders, cap, merged.mask,
                                 ranges=self._ranges)
        perm = radix_sort_perm(words, bits, cap)
        k = min(self._buf_cap, cap)
        top = perm[:k]
        s = take(merged, top, merged.mask[top])
        keep = (torch.arange(k, device=s.device) < self._n) & s.mask
        return DeviceBatch(s.columns, keep)

    def add_input(self, batch):
        self._topk = self._merge(self._topk, batch)

    def no_more_input(self):
        super().no_more_input()
        self._out, self._topk = self._topk, None

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None

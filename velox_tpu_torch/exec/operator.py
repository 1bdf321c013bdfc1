"""Operator SPI + the stateless operators of the ported slice.

Counterpart of ``velox_tpu/exec/operator.py``: the needs_input /
add_input / get_output / no_more_input / is_finished contract
(velox/exec/Operator.h), the Values and TableScan sources, and the fused
Filter/Project operator, and the Arrow stream source. Each operator's
per-batch work is eager torch code on the batch's device; the driver
loop in exec/task.py only moves batch handles. The scan can generate and
upload its next splits on a producer thread while the query works on the
current one. Repeated Values runs over the same host table take its
uploaded batch from the ingest cache (``IngestCache``), which reserves
its bytes in the device root and gives them up to the arbitrator.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

import torch

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.common import testvalue as TV
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.memory import DeviceLru, batch_nbytes
from velox_tpu_torch.vector.device import (
    DeviceBatch, DeviceColumn, from_arrow,
)


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

    def close(self) -> None:
        """Release what the operator holds beyond its batches (threads).
        The Task calls it when the query finishes, stops early or raises.
        Parity: Operator::close (exec/Operator.h)."""


class SourceOperator(Operator):
    """Source operators take no input."""

    def needs_input(self) -> bool:
        return False

    def add_input(self, batch):
        raise RuntimeError(f"{type(self).__name__} takes no input")


class IngestCache(DeviceLru):
    """The Values ingest cache: the uploaded batch of a host table, keyed
    by (id(table), string encoding, device), at most ``MAX_ENTRIES`` in
    LRU order. An entry holds its table, so the id stays its own while it
    is cached. As a ``DeviceLru`` each entry's bytes are reserved in the
    device root, an entry that cannot be reserved is not cached, and the
    arbitrator reclaims from it first. (The reference's cache reserves
    nothing and cannot be reclaimed, velox_tpu/exec/operator.py:113-121.)"""

    MAX_ENTRIES = 8
    _instance: Optional["IngestCache"] = None

    def __init__(self):
        super().__init__(max_entries=self.MAX_ENTRIES)

    @classmethod
    def instance(cls) -> "IngestCache":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def get(self, key, table) -> Optional[DeviceBatch]:
        hit = self._lookup(key)
        if hit is None or hit[0] is not table:
            return None
        M.record_counter(M.K_VALUES_INGEST_HITS)
        return hit[1]

    def put(self, key, table, batch: DeviceBatch) -> None:
        self._insert(key, (table, batch), batch_nbytes(batch))

    def stats(self):
        return {"used": self.used, "entries": len(self._entries)}


class ValuesOperator(SourceOperator):
    """Parity: velox/exec/Values.h:21. Uploads each pyarrow table (or
    passes through a ready DeviceBatch) to the query's device, its VARCHAR
    columns in the node's ``string_encoding`` ("dict", "raw", "auto", or a
    dict of column name to one of them), through the ingest cache."""

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
        enc = self.node.string_encoding
        key = (id(t), tuple(sorted(enc.items())) if isinstance(enc, dict)
               else enc, str(self._device))
        cache = IngestCache.instance()
        batch = cache.get(key, t)
        if batch is None:
            batch = from_arrow(t, string_encoding=enc, device=self._device)
            cache.put(key, t, batch)
        return batch

    def is_finished(self):
        return self._i >= len(self._tables)


class ArrowStreamOperator(SourceOperator):
    """Streaming source: pulls record batches from a pyarrow
    RecordBatchReader (or any iterable of batches, tables or
    DeviceBatches, or a callable returning one) and stages them on the
    query's device. A DeviceBatch on another device raises: it is not
    moved. Parity: velox/exec/ArrowStream.h:23."""

    def __init__(self, node: P.ArrowStreamNode, device):
        super().__init__(node)
        r = node.reader
        self._it = iter(r() if callable(r) else r)
        self._device = torch.device(device)
        self._done = False

    def get_output(self):
        if self._done:
            return None
        try:
            t = next(self._it)
        except StopIteration:
            self._done = True
            return None
        if isinstance(t, DeviceBatch):
            if t.device != self._device:
                raise ValueError(
                    f"ArrowStream batch on {t.device}, the query runs on "
                    f"{self._device}")
            return t
        import pyarrow as pa
        if isinstance(t, pa.RecordBatch):
            t = pa.table(t)
        return from_arrow(t, device=self._device)

    def is_finished(self):
        return self._done


def _column_tensors(col: DeviceColumn) -> Iterator[torch.Tensor]:
    yield col.data
    if col.validity is not None:
        yield col.validity
    for child in col.children:
        yield from _column_tensors(child)


def _hand_over(batch: DeviceBatch) -> DeviceBatch:
    """Mark a scan batch's CUDA tensors as used by the consuming stream.
    They were allocated on the data source's upload stream; without this
    the caching allocator could hand a freed block (an evicted cache
    entry) back to that stream for the next upload while this stream's
    kernels still read it."""
    if batch.device.type == "cuda":
        stream = torch.cuda.current_stream(batch.device)
        batch.mask.record_stream(stream)
        for col in batch.columns.values():
            for t in _column_tensors(col):
                t.record_stream(stream)
    return batch


class TableScanOperator(SourceOperator):
    """Parity: velox/exec/TableScan.cpp:75 — pulls splits in order, hands
    them to a connector DataSource, yields device batches.

    With ``prefetch > 0`` and more than one split, a producer thread runs
    the source ahead (host generation and upload of the next splits) into
    a queue of at most ``prefetch`` batches while the query works on the
    current one: the split preload of velox's I/O executor and a bounded
    exchange queue in one. One producer thread a scan, so a data source
    needs no locking. Its error is raised on the consumer side."""

    _DONE = object()

    def __init__(self, node: P.TableScanNode, data_source, splits,
                 prefetch: int, gate: Optional[threading.Event] = None):
        super().__init__(node)
        # a producer waits for ``gate`` before its first split: a probe
        # scan started before its join's build, which may finish early
        self._gate = gate
        self._source = data_source
        self._splits = list(splits)
        self._i = 0
        self._queue: Optional[queue.Queue] = None
        self._error: Optional[BaseException] = None
        self._exhausted = False
        if prefetch > 0 and len(self._splits) > 1:
            self._queue = queue.Queue(maxsize=prefetch)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._produce, daemon=True,
                name=f"velox-scan-{node.id}")
            self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up once the consumer abandoned the scan
        (a Limit, an error, a probe that finished early): without the
        stop check the producer would block on a full queue forever."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            while self._gate is not None and not self._gate.wait(0.1):
                if self._stop.is_set():
                    return
            for split in self._splits:
                TV.adjust("TableScan::prefetch", split)
                if self._stop.is_set():
                    return
                while True:
                    out = self._source.next(split)
                    if out is None:
                        break
                    if not self._put(out):
                        return
                # counted when fully drained, as the serial path counts
                M.record_counter(M.K_SCAN_SPLITS)
        except BaseException as e:  # raised again by get_output
            self._error = e
        finally:
            self._put(self._DONE)

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Stop the producer and join it, so that no thread of this scan
        issues copies once its task is over."""
        if self._queue is None:
            return
        self._stop.set()
        # a producer blocked in put() sees the stop within its timeout;
        # one inside a split's generation finishes that split first
        while self._thread.is_alive():
            self._drain()
            self._thread.join(timeout=0.25)
        self._drain()

    def get_output(self):
        if self._queue is not None:
            if self._exhausted:
                return None
            item = self._queue.get()
            if item is self._DONE:
                self._exhausted = True
                if self._error is not None:
                    raise self._error
                return None
            return _hand_over(item)
        while self._i < len(self._splits):
            out = self._source.next(self._splits[self._i])
            if out is None:
                M.record_counter(M.K_SCAN_SPLITS)
                self._i += 1
                continue
            return _hand_over(out)
        return None

    def is_finished(self):
        if self._queue is not None:
            return self._exhausted
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

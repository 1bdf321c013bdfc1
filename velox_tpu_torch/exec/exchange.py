"""Multi-fragment exchange: PartitionedOutput -> OutputBuffer -> Exchange.

Counterpart of ``velox_tpu/exec/exchange.py``. Role parity:
``velox/exec/PartitionedOutput.h:149`` (Destination buffering),
``exec/OutputBuffer.h:203`` (partitioned/broadcast/arbitrary kinds),
``exec/OutputBufferManager.h:22`` (process-wide registry keyed by task id),
``exec/Exchange.h:38`` / ``ExchangeClient.h:25`` (a consumer pulls pages
from remote tasks), and the pluggable ``ExchangeSource`` transport factory
(exec/ExchangeSource.h:137), whose in-process implementation mirrors the
reference's test ``LocalExchangeSource`` (exec/tests/utils/
LocalExchangeSource.cpp:25).

This is the host boundary between plan fragments: pages are framed Arrow
IPC (serializers/pages.py). Shuffles between the shards of one mesh stay
tensor movement (parallel/exchange.py). A producer Task and its consumer
Tasks may run on threads: an OutputBuffer takes a lock around every call.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.operator import Operator, SourceOperator
from velox_tpu_torch.serializers import PageSerde
from velox_tpu_torch.vector.device import DeviceBatch


class _SpilledPage:
    """A page overflowed to disk (flow-control memory bound)."""

    __slots__ = ("path", "size")

    def __init__(self, page: bytes):
        import tempfile
        f = tempfile.NamedTemporaryFile(prefix="vtx_page_", delete=False)
        f.write(page)
        f.close()
        self.path = f.name
        self.size = len(page)

    def load(self) -> bytes:
        with open(self.path, "rb") as f:
            return f.read()

    def drop(self):
        import os
        try:
            os.unlink(self.path)
        except OSError:
            pass


class OutputBuffer:
    """Per-task destination-partitioned page queues with flow control.
    Parity: exec/OutputBuffer.h (kinds partitioned/broadcast/arbitrary;
    maxSize producer bound + consumer acknowledgeResults/deleteResults).

    ``get(dest, sequence)`` implicitly acks every page before
    ``sequence``: acked pages are dropped and their bytes credited back
    (the reference's ack/delete protocol). Producers never block (a
    serial driver would deadlock); past ``max_bytes`` of unacked pages,
    new pages overflow to disk and reload on consumption, so memory stays
    bounded under a slow consumer."""

    def __init__(self, num_destinations: int, kind: str = "partitioned",
                 max_bytes: int = 64 << 20):
        self.kind = kind
        self.max_bytes = max_bytes
        self._queues: List[List] = [[] for _ in range(num_destinations)]
        self._acked = [0] * num_destinations  # absolute seq of q[0]
        self.bytes_in_memory = 0
        self._finished = False
        self._error: Optional[str] = None
        self._lock = threading.Lock()
        self._rr = 0

    def set_error(self, message: str):
        """The producer task failed: poison the buffer so every consumer
        fragment aborts instead of waiting on a never-finished stream.
        Parity: Task::setError -> terminate clearing output buffers
        (exec/Task.cpp:2574,1934)."""
        with self._lock:
            self._error = message
            self._finished = True
            for q in self._queues:
                for e in q:
                    if isinstance(e, _SpilledPage):
                        e.drop()
                q.clear()
            self.bytes_in_memory = 0

    def _admit(self, q: List, page: bytes):
        if self.bytes_in_memory + len(page) > self.max_bytes:
            M.record_counter(M.K_EXCHANGE_OVERFLOWS)
            q.append(_SpilledPage(page))
        else:
            self.bytes_in_memory += len(page)
            q.append(page)

    def enqueue(self, destination: int, page: bytes):
        M.record_counter(M.K_EXCHANGE_PAGES)
        M.record_counter(M.K_EXCHANGE_BYTES, len(page))
        with self._lock:
            if self.kind == "broadcast":
                for q in self._queues:
                    self._admit(q, page)
            elif self.kind == "arbitrary":
                self._admit(self._queues[self._rr % len(self._queues)],
                            page)
                self._rr += 1
            else:
                self._admit(self._queues[destination], page)

    def no_more_data(self):
        with self._lock:
            self._finished = True

    def ack(self, destination: int, sequence: int):
        """Drop pages before absolute index ``sequence``; return credit.
        Parity: OutputBuffer::acknowledge (exec/OutputBuffer.h:157)."""
        with self._lock:
            self._ack_locked(destination, sequence)

    def _ack_locked(self, destination: int, sequence: int):
        q = self._queues[destination]
        drop = min(max(sequence - self._acked[destination], 0), len(q))
        for e in q[:drop]:
            if isinstance(e, _SpilledPage):
                e.drop()
            else:
                self.bytes_in_memory -= len(e)
        del q[:drop]
        self._acked[destination] += drop

    def get(self, destination: int, sequence: int,
            max_bytes: Optional[int] = None):
        """Pages from absolute index ``sequence`` on, and the at_end flag.
        Pages before ``sequence`` are implicitly acknowledged and dropped;
        later ones may be read again until then. ``max_bytes`` bounds the
        response (at least one page is returned when there is one): the
        consumer's credit (parity: ExchangeSource::request(maxBytes),
        exec/ExchangeClient.h:104)."""
        with self._lock:
            if self._error is not None:
                from velox_tpu_torch.common.errors import VeloxRuntimeError
                raise VeloxRuntimeError(
                    f"producer task failed: {self._error}")
            self._ack_locked(destination, sequence)
            q = self._queues[destination]
            start = max(sequence - self._acked[destination], 0)
            pages = []
            total = 0
            for e in q[start:]:
                size = e.size if isinstance(e, _SpilledPage) else len(e)
                if pages and max_bytes is not None \
                        and total + size > max_bytes:
                    break
                pages.append(e.load() if isinstance(e, _SpilledPage)
                             else e)
                total += size
            at_end = self._finished and start + len(pages) >= len(q)
            return pages, at_end

    @property
    def finished(self) -> bool:
        return self._finished


class OutputBufferManager:
    """Process-wide task id -> OutputBuffer registry.
    Parity: exec/OutputBufferManager.h:22."""

    _instance: Optional["OutputBufferManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._buffers: Dict[str, OutputBuffer] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "OutputBufferManager":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def create(self, task_id: str, num_destinations: int,
               kind: str = "partitioned") -> OutputBuffer:
        with self._lock:
            buf = OutputBuffer(num_destinations, kind)
            self._buffers[task_id] = buf
            return buf

    def get(self, task_id: str) -> OutputBuffer:
        with self._lock:
            return self._buffers[task_id]

    def remove(self, task_id: str):
        with self._lock:
            self._buffers.pop(task_id, None)


# ---------------------------------------------------------------------------
# ExchangeSource SPI + the in-process transport.
# ---------------------------------------------------------------------------

class ExchangeSource:
    """Pulls pages for one (remote task, destination).
    Parity: exec/ExchangeSource.h:23."""

    def next(self, max_bytes: Optional[int] = None):
        """-> (pages: List[bytes], at_end: bool). ``max_bytes`` is the
        consumer's credit for this request (parity:
        ExchangeSource::request(maxBytes, maxWait))."""
        raise NotImplementedError


class LocalExchangeSource(ExchangeSource):
    """In-process transport reading the producer's OutputBufferManager.
    Parity: exec/tests/utils/LocalExchangeSource.cpp:25."""

    def __init__(self, task_id: str, destination: int):
        self.task_id = task_id
        self.destination = destination
        self._seq = 0

    def next(self, max_bytes: Optional[int] = None):
        buf = OutputBufferManager.instance().get(self.task_id)
        pages, at_end = buf.get(self.destination, self._seq, max_bytes)
        self._seq += len(pages)
        return pages, at_end


_SOURCE_FACTORY: Callable[[str, int], ExchangeSource] = LocalExchangeSource


def register_exchange_source_factory(factory):
    """Swap the transport (parity: ExchangeSource::registerFactory)."""
    global _SOURCE_FACTORY
    _SOURCE_FACTORY = factory


# ---------------------------------------------------------------------------
# Operators.
# ---------------------------------------------------------------------------

class PartitionedOutputOperator(Operator):
    """Partitions rows by the node's partition function and serializes
    per-destination pages into this task's OutputBuffer.
    Parity: exec/PartitionedOutput.cpp:319.

    The bucketize is the device-side analogue of Destination::advance
    (exec/PartitionedOutput.cpp:23-70): one stable radix sort of the
    destination id (B4 and B3; the reference sorts ``dest << 32 | row``,
    whose stable order is the same permutation) and one multi-column
    gather (B5) put each destination's rows together in input order, and
    one host read gives the per-destination counts, so the host cuts the
    pages by slicing."""

    def __init__(self, node: "P.PartitionedOutputNode", task_id: str,
                 device):
        super().__init__(node)
        from velox_tpu_torch.parallel.exchange import (
            resolve_partition_function,
        )
        self._node = node
        self._n = node.num_partitions
        self._buffer = OutputBufferManager.instance().create(
            task_id, self._n, node.kind)
        self._serde = PageSerde(device=device)
        self._key_names = [k.name for k in node.keys]
        spec = getattr(node, "partition_spec", "hash") or "hash"
        self._partition_fn = resolve_partition_function(spec)
        self._bucket_count = getattr(node, "bucket_count", 0) \
            or node.num_partitions
        # rows sent so far: round-robin continuity across batches, and
        # what a run reports
        self.rows_emitted = 0
        self._uses_keys = bool(self._key_names) or spec == "round_robin"

    def add_input(self, batch: DeviceBatch):
        import torch

        from velox_tpu_torch.expression.eval import value_from_column
        from velox_tpu_torch.parallel.exchange import bucketize, take_prefix
        from velox_tpu_torch.vector.device import to_arrow
        if self._node.kind != "partitioned" or not self._uses_keys:
            table = to_arrow(batch)
            self.rows_emitted += table.num_rows
            self._buffer.enqueue(0, self._serde.serialize_table(table))
            return
        n, cap = self._n, batch.capacity
        keys = [value_from_column(batch.columns[k])
                for k in self._key_names]
        dest = self._partition_fn(keys, batch.mask, cap, n,
                                  self.rows_emitted, self._bucket_count)
        dest = torch.where(batch.mask, dest.to(torch.int64), n)
        perm, counts = bucketize(dest, n)
        counts = counts.tolist()  # the one host read of the batch
        active = sum(counts)
        self.rows_emitted += active
        if not active:
            return
        # active rows, destination-contiguous
        table = to_arrow(take_prefix(batch, perm, active))
        off = 0
        for d, c in enumerate(counts):
            if c:
                self._buffer.enqueue(d, self._serde.serialize_table(
                    table.slice(off, c)))
            off += c

    def no_more_input(self):
        super().no_more_input()
        self._buffer.no_more_data()

    def terminate(self, message: str):
        """The fragment failed: poison the output buffer
        (Task::terminate)."""
        self._buffer.set_error(message)

    def get_output(self):
        return None

    def is_finished(self):
        return self._no_more_input


class ExchangeOperator(SourceOperator):
    """Consumes pages from remote tasks' output buffers and uploads each
    onto the query's device, with ``capacity`` and the node's
    dictionaries. Parity: exec/Exchange.h:38 + ExchangeClient."""

    # consumer-side queue bound: the reference's 32MB ExchangeClient
    # queue (exec/ExchangeClient.h:27)
    MAX_QUEUE_BYTES = 32 << 20

    def __init__(self, node: "P.ExchangeNode", remote_task_ids: List[str],
                 destination: int, device, capacity: Optional[int] = None,
                 dictionaries=None, max_queue_bytes: Optional[int] = None):
        super().__init__(node)
        self._sources = [_SOURCE_FACTORY(t, destination)
                         for t in remote_task_ids]
        self._pending: List[bytes] = []
        self._pending_bytes = 0
        self._max_queue_bytes = max_queue_bytes or self.MAX_QUEUE_BYTES
        self._done = [False] * len(self._sources)
        self._serde = PageSerde(device=device)
        self._capacity = capacity
        self._dictionaries = dictionaries or {}

    def _poll(self):
        """Credit-based re-request: each source gets at most the queue's
        headroom; polling stops once the bounded queue is full (parity:
        ExchangeClient::next re-request scheduling, ExchangeClient.h:104)."""
        for i, s in enumerate(self._sources):
            if self._done[i]:
                continue
            credit = self._max_queue_bytes - self._pending_bytes
            if credit <= 0 and self._pending:
                return
            pages, at_end = s.next(max(credit, 1))
            self._pending.extend(pages)
            self._pending_bytes += sum(len(p) for p in pages)
            if at_end:
                self._done[i] = True

    def get_output(self):
        while not self._pending and not all(self._done):
            self._poll()
            if not self._pending and not all(self._done):
                # a producer on another thread has not published its
                # next page yet
                time.sleep(0.001)
        if not self._pending:
            return None
        page = self._pending.pop(0)
        self._pending_bytes -= len(page)
        return self._serde.deserialize(page, capacity=self._capacity,
                                       dictionaries=self._dictionaries)

    def is_finished(self):
        return all(self._done) and not self._pending

"""In-process multi-driver local exchange.

Counterpart of ``velox_tpu/exec/local_exchange.py`` (velox/exec/
LocalPartition.h): a LocalPartitionNode boundary runs N producer
threads, each driving the source subtree over its slice of the probe
pipeline's splits (LocalPlanner.cpp:177 per-pipeline driver counts), all
feeding one byte-bounded queue (LocalExchangeMemoryManager, 32 MB by
default) that the consumer pipeline drains. Every thread issues its work
to the same device stream, so a batch a producer hands over is ordered
before the consumer's use of it.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from velox_tpu_torch.vector.device import DeviceBatch


class LocalExchangeQueue:
    """Byte-bounded multi-producer single-consumer queue.
    Parity: exec/LocalPartition.h:52 + LocalExchangeMemoryManager:25."""

    def __init__(self, n_producers: int, max_bytes: int = 32 << 20):
        self._cond = threading.Condition()
        self._items: deque = deque()
        self._bytes = 0
        self.max_bytes = max_bytes
        self._open_producers = n_producers
        self._stopped = False
        self._error: Optional[BaseException] = None

    def put(self, batch: DeviceBatch, nbytes: int) -> bool:
        """Blocks while the queue is over budget (backpressure); returns
        False when the consumer abandoned the exchange."""
        with self._cond:
            while (self._bytes > 0 and self._bytes + nbytes > self.max_bytes
                   and not self._stopped):
                self._cond.wait(0.05)
            if self._stopped:
                return False
            self._items.append((batch, nbytes))
            self._bytes += nbytes
            self._cond.notify_all()
            return True

    def producer_done(self, error: Optional[BaseException] = None):
        with self._cond:
            if error is not None and self._error is None:
                self._error = error
            self._open_producers -= 1
            self._cond.notify_all()

    def get(self) -> Optional[DeviceBatch]:
        """Next batch, or None when all producers finished. Raises the
        first producer error."""
        with self._cond:
            while not self._items and self._open_producers > 0 \
                    and self._error is None:
                self._cond.wait(0.05)
            if self._error is not None:
                raise self._error
            if not self._items:
                return None
            batch, nbytes = self._items.popleft()
            self._bytes -= nbytes
            self._cond.notify_all()
            return batch

    def stop(self):
        """Consumer abandoned: unblock and discard producers' output."""
        with self._cond:
            self._stopped = True
            self._items.clear()
            self._bytes = 0
            self._cond.notify_all()

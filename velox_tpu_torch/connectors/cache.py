"""Device-resident scan cache.

Counterpart of the device tier of ``velox_tpu/connectors/cache.py``
(role parity: ``velox/common/caching/AsyncDataCache.h:698``). The cached
unit is the uploaded batch of one split, keyed by (connector, scale,
table, columns, split range, capacity, device), under a byte budget with
LRU eviction. A query's second run takes its scans from here and skips
generation and upload.

Cached batches are shared by every later query that scans the same
split, so no operator may write into a scan batch's tensors.

Not ported: the SSD tier (``SsdTier``), ROADMAP A.7.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.exec.memory import (
    MemoryArbitrator, MemoryPool, batch_nbytes,
)
from velox_tpu_torch.vector.device import DeviceBatch

DEFAULT_BUDGET = 8 << 30  # 8 GiB of device memory for cached scans


class DataCache:
    """LRU cache of uploaded scan batches with a byte budget."""

    _instance: Optional["DataCache"] = None

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET):
        self.budget = budget_bytes
        self.used = 0
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[Tuple, Tuple[DeviceBatch, int]]" = \
            OrderedDict()
        self._lock = threading.Lock()
        # cached scans can be regenerated: first in line for arbitration
        # (parity: AsyncDataCache shrinking under memory pressure)
        self._pool = MemoryPool.device_root()
        MemoryArbitrator.instance().register(
            self, MemoryArbitrator.PRI_CACHE)

    def enable_ssd(self, directory: str, budget_bytes: int = 64 << 30):
        raise NotImplementedError(
            "the scan cache's SSD tier is not ported to velox_tpu_torch "
            "(ROADMAP A.7)")

    @classmethod
    def instance(cls) -> "DataCache":
        if cls._instance is None:
            from velox_tpu_torch.common.flags import get_flag
            budget = int(get_flag("scan_cache_bytes")) or DEFAULT_BUDGET
            cache = cls(budget)
            ssd_dir = get_flag("ssd_cache_dir")
            if ssd_dir:
                cache.enable_ssd(ssd_dir)
            cls._instance = cache
        return cls._instance

    def get(self, key) -> Optional[DeviceBatch]:
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                M.record_counter(M.K_SCAN_CACHE_HITS)
                return hit[0]
            self.misses += 1
            M.record_counter(M.K_SCAN_CACHE_MISSES)
        return None

    def put(self, key, batch: DeviceBatch) -> None:
        n = batch_nbytes(batch)
        if n > self.budget:
            return
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._drop_bytes(old[1])
            while self.used + n > self.budget and self._entries:
                _, (_, sz) = self._entries.popitem(last=False)
                M.record_counter(M.K_SCAN_CACHE_EVICTIONS)
                self._drop_bytes(sz)
            if not self._pool.reserve(n):
                # the device root is capped: skip the put rather than oust
                # operator state (the arbitrator cannot help: this cache is
                # its first reclaim target)
                return
            self._entries[key] = (batch, n)
            self.used += n

    def _drop_bytes(self, n: int) -> None:
        self.used -= n
        self._pool.release(n)

    def reclaim(self, needed: int) -> int:
        """Arbitrator hook: evict LRU entries until `needed` bytes are
        freed; returns the bytes freed."""
        with self._lock:
            freed = 0
            while self._entries and freed < needed:
                _, (_, sz) = self._entries.popitem(last=False)
                self._drop_bytes(sz)
                freed += sz
            return freed

    def clear(self) -> None:
        """Drop every entry: the next scan of each split is cold."""
        with self._lock:
            self._pool.release(self.used)
            self._entries.clear()
            self.used = 0

    def entries(self) -> List[Tuple[Tuple, DeviceBatch]]:
        """(key, batch) of every entry, least recently used first."""
        with self._lock:
            return [(k, b) for k, (b, _) in self._entries.items()]

    def stats(self):
        return {"used": self.used, "budget": self.budget,
                "entries": len(self._entries), "hits": self.hits,
                "misses": self.misses}

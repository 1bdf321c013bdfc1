"""Device-resident scan cache with an SSD (disk) tier.

Counterpart of ``velox_tpu/connectors/cache.py`` (role parity:
``velox/common/caching/AsyncDataCache.h:698``). The cached unit is the
uploaded batch of one split, keyed by (connector, scale, table, columns,
split range, capacity, device), under a byte budget with LRU eviction. A
query's second run takes its scans from here and skips generation and
upload.

Cached batches are shared by every later query that scans the same
split, so no operator may write into a scan batch's tensors.

The SSD tier (``SsdTier``, parity ``common/caching/SsdCache.h``): with
``enable_ssd``, entries evicted from the device persist as pickled
``HostBatch``es in a directory with a JSON index checkpoint, a device
miss looks there before the split is generated again, and the index
survives a restart. An eviction can run on a scan's producer thread:
every cache entry is complete when it is put (the data source
synchronizes its upload stream), and the host copy is waited for before
it is pickled.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.exec.memory import DeviceLru, HostBatch, batch_nbytes
from velox_tpu_torch.vector.device import DeviceBatch

DEFAULT_BUDGET = 8 << 30  # 8 GiB of device memory for cached scans


class SsdTier:
    """Disk tier: evicted entries persist as pickled HostBatches under a
    directory, with a JSON index checkpoint (entry id -> bytes, least
    recently used first) and LRU eviction under a byte budget. Parity:
    common/caching/SsdCache.h:27 + SsdFile checkpointing."""

    INDEX = "index.json"

    def __init__(self, directory: str, budget_bytes: int = 64 << 30):
        self.dir = directory
        self.budget = budget_bytes
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._index: "OrderedDict[str, int]" = OrderedDict()
        self.used = 0
        self.hits = 0
        self.misses = 0
        path = os.path.join(directory, self.INDEX)
        if os.path.exists(path):  # checkpoint recovery
            with open(path) as f:
                for eid, size in json.load(f):
                    if os.path.exists(self._path(eid)):
                        self._index[eid] = size
                        self.used += size

    @staticmethod
    def entry_id(key) -> str:
        return hashlib.sha256(repr(key).encode()).hexdigest()[:32]

    def _path(self, eid: str) -> str:
        return os.path.join(self.dir, f"{eid}.bin")

    def _checkpoint_locked(self) -> None:
        tmp = os.path.join(self.dir, self.INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump(list(self._index.items()), f)
        os.replace(tmp, os.path.join(self.dir, self.INDEX))

    def put(self, key, batch: DeviceBatch) -> None:
        eid = self.entry_id(key)
        blob = pickle.dumps(HostBatch(batch))
        with self._lock:
            if eid in self._index:
                return
            while self.used + len(blob) > self.budget and self._index:
                old, size = self._index.popitem(last=False)
                try:
                    os.unlink(self._path(old))
                except FileNotFoundError:
                    pass
                self.used -= size
            with open(self._path(eid), "wb") as f:
                f.write(blob)
            self._index[eid] = len(blob)
            self.used += len(blob)
            self._checkpoint_locked()
        M.record_counter(M.K_SSD_CACHE_WRITES)
        M.record_counter(M.K_SSD_CACHE_WRITE_BYTES, len(blob))

    def get(self, key) -> Optional[DeviceBatch]:
        """The entry back on its device, or None. The files are this
        tier's own: it unpickles only what its ``put`` wrote."""
        eid = self.entry_id(key)
        with self._lock:
            if eid not in self._index:
                self.misses += 1
                M.record_counter(M.K_SSD_CACHE_MISSES)
                return None
            self._index.move_to_end(eid)
            self.hits += 1
            M.record_counter(M.K_SSD_CACHE_HITS)
        try:
            with open(self._path(eid), "rb") as f:
                host = pickle.load(f)
        except (OSError, pickle.UnpicklingError):
            # evicted since the lookup, or unreadable: a miss
            return None
        return host.restore()

    def stats(self):
        return {"used": self.used, "budget": self.budget,
                "entries": len(self._index), "hits": self.hits,
                "misses": self.misses}


class DataCache(DeviceLru):
    """LRU cache of uploaded scan batches with a byte budget, reserved in
    the device root and reclaimed first by the arbitrator."""

    _instance: Optional["DataCache"] = None

    def __init__(self, budget_bytes: int = DEFAULT_BUDGET):
        super().__init__(budget_bytes)
        self.hits = 0
        self.misses = 0
        self._ssd: Optional[SsdTier] = None

    def enable_ssd(self, directory: str,
                   budget_bytes: int = 64 << 30) -> SsdTier:
        """Attach the disk tier (parity: SsdCache behind AsyncDataCache):
        evicted entries go to `directory`, misses look there before the
        split is generated again, and the index survives restarts."""
        self._ssd = SsdTier(directory, budget_bytes)
        return self._ssd

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
        batch = self._lookup(key)
        with self._lock:
            if batch is not None:
                self.hits += 1
                M.record_counter(M.K_SCAN_CACHE_HITS)
                return batch
            self.misses += 1
            M.record_counter(M.K_SCAN_CACHE_MISSES)
        if self._ssd is not None:
            batch = self._ssd.get(key)
            if batch is not None:
                self.put(key, batch)  # promoted back to the device
                return batch
        return None

    def put(self, key, batch: DeviceBatch) -> None:
        for _ in self._insert(key, batch, batch_nbytes(batch)):
            M.record_counter(M.K_SCAN_CACHE_EVICTIONS)

    def _evicted(self, evicted) -> None:
        # demoted to the disk tier outside the cache's lock, so a get on
        # another thread does not wait for the write
        if self._ssd is not None:
            for key, batch, _ in evicted:
                self._ssd.put(key, batch)

    def entries(self) -> List[Tuple[Tuple, DeviceBatch]]:
        """(key, batch) of every entry, least recently used first."""
        with self._lock:
            return [(k, b) for k, (b, _) in self._entries.items()]

    def stats(self):
        return {"used": self.used, "budget": self.budget,
                "entries": len(self._entries), "hits": self.hits,
                "misses": self.misses}

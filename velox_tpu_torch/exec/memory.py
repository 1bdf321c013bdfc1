"""Memory accounting: the pools and the arbitrator the scan cache needs.

Counterpart of the accounting half of ``velox_tpu/exec/memory.py``
(velox/common/memory MemoryPool usage tracking and the MemoryArbitrator's
reclaim). The device root counts the scan cache's bytes
(connectors/cache.py); operators reserve nothing yet. Host offload and
disk spill (``HostBatch``, ``DiskBatch``, ``OffloadBuffer``) are not
ported.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Optional

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.vector.device import DeviceBatch


def batch_nbytes(batch: DeviceBatch) -> int:
    """Device bytes held by a batch: data, validity, DECIMAL(38) high
    limbs and the mask."""
    return batch.nbytes


class MemoryPool:
    """Hierarchical usage tracking with a soft cap.
    Parity: common/memory/MemoryPool.h (tracking); reclaim is triggered
    through MemoryArbitrator below."""

    _device_root: Optional["MemoryPool"] = None

    def __init__(self, name: str, cap_bytes: Optional[int] = None,
                 parent: Optional["MemoryPool"] = None):
        self.name = name
        self.cap_bytes = cap_bytes
        self.parent = parent
        self.used = 0
        self.peak = 0

    @classmethod
    def device_root(cls) -> "MemoryPool":
        """Process-wide root modelling device-memory use. Parity: the
        MemoryManager root pool (common/memory/Memory.h:175). Cap set via
        set_device_cap()."""
        if cls._device_root is None:
            cls._device_root = cls("device-root")
        return cls._device_root

    @classmethod
    def set_device_cap(cls, cap_bytes: Optional[int]):
        cls.device_root().cap_bytes = cap_bytes

    def _over_cap(self, n: int) -> bool:
        p: Optional[MemoryPool] = self
        while p is not None:
            if p.cap_bytes is not None and p.used + n > p.cap_bytes:
                return True
            p = p.parent
        return False

    def reserve(self, n: int) -> bool:
        """Account n bytes; False if this pool's or an ancestor's cap would
        be exceeded."""
        if self._over_cap(n):
            return False
        p: Optional[MemoryPool] = self
        while p is not None:
            p.used += n
            p.peak = max(p.peak, p.used)
            p = p.parent
        return True

    def reserve_or_reclaim(self, n: int) -> bool:
        """reserve(); on cap overflow ask the arbitrator to free memory and
        retry once. Parity: MemoryArbitrator::growCapacity triggering
        reclaim (common/memory/MemoryArbitrator.h:46)."""
        if self.reserve(n):
            return True
        MemoryArbitrator.instance().reclaim(n)
        return self.reserve(n)

    def release(self, n: int) -> None:
        p: Optional[MemoryPool] = self
        while p is not None:
            p.used = max(0, p.used - n)
            p = p.parent

    def stats(self) -> Dict:
        return {"name": self.name, "used": self.used, "peak": self.peak,
                "cap": self.cap_bytes}


class MemoryArbitrator:
    """Process-wide reclaim coordinator. Reclaimers register with a
    priority (lower runs first); when a pool's reserve crosses a cap,
    reclaim(n) walks them until n bytes are freed. Parity:
    common/memory/MemoryArbitrator.h:46 + exec/MemoryReclaimer.h."""

    _instance: Optional["MemoryArbitrator"] = None

    PRI_CACHE = 0      # re-loadable data: evict first
    PRI_OPERATOR = 10  # operator state

    def __init__(self):
        # weak references: a reclaimer that dies without unregistering
        # must not be kept alive by the process-wide arbitrator
        self._reclaimers: List = []  # (priority, weakref to reclaimer)
        self.reclaimed_bytes = 0
        self.reclaim_calls = 0

    @classmethod
    def instance(cls) -> "MemoryArbitrator":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def register(self, reclaimer, priority: int = PRI_OPERATOR) -> None:
        self._reclaimers.append((priority, weakref.ref(reclaimer)))

    def unregister(self, reclaimer) -> None:
        self._reclaimers = [(p, r) for p, r in self._reclaimers
                            if r() is not None and r() is not reclaimer]

    def reclaim(self, needed: int) -> int:
        """Free at least `needed` bytes if possible; returns the bytes
        freed. Each reclaimer's ``reclaim(n)`` returns what it freed and
        releases it from its own pool."""
        self.reclaim_calls += 1
        freed = 0
        for _, ref in sorted(self._reclaimers, key=lambda t: t[0]):
            rec = ref()
            if rec is None:
                continue
            if freed >= needed:
                break
            freed += rec.reclaim(needed - freed)
        self._reclaimers = [(p, r) for p, r in self._reclaimers
                            if r() is not None]
        self.reclaimed_bytes += freed
        M.record_counter(M.K_MEM_RECLAIMS)
        M.record_counter(M.K_MEM_RECLAIMED_BYTES, freed)
        return freed

"""Memory accounting, host offload and disk spill.

Counterpart of ``velox_tpu/exec/memory.py``: velox/common/memory's
MemoryPool usage tracking, the MemoryArbitrator's reclaim, and the spill
framework (velox/exec/Spiller.h) mapped onto a device's memory tiers.
Operator state that crosses its device budget moves to host RAM
(``HostBatch``: every tensor of the batch in pinned memory on a CUDA
card, a clone on the CPU); past the host budget the oldest host batches
go to spill files (``DiskBatch``). ``OffloadBuffer`` holds an OrderBy's
input or a join build's batches across the three tiers, reserves its
device bytes in the query's pool and gives them up when the arbitrator
asks. ``restore_all`` returns every batch in the order it was added,
whichever tier it reached (the reference returns device, then host, then
disk batches, which reorders a sort's ties and a merge join's presorted
build once two tiers hold batches).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import uuid
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.common.errors import VeloxRuntimeError
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn


def batch_nbytes(batch: DeviceBatch) -> int:
    """Device bytes held by a batch: data, validity, the mask and every
    child column's and explicit starts' bytes."""
    return batch.nbytes


def _flatten(batch: DeviceBatch) -> Tuple[tuple, List[torch.Tensor]]:
    """(layout, tensors): every tensor of the batch (data, validity,
    starts and child columns, recursively; the mask; the error count) in
    one list, and the structure that puts them back. Dtypes and
    dictionaries stay in the layout by reference."""
    tensors: List[torch.Tensor] = []

    def slot(t: Optional[torch.Tensor]) -> Optional[int]:
        if t is None:
            return None
        tensors.append(t)
        return len(tensors) - 1

    def column(c: DeviceColumn) -> tuple:
        return (c.dtype, c.dictionary, slot(c.data), slot(c.validity),
                slot(c.starts), tuple(column(ch) for ch in c.children))

    cols = tuple((name, column(c)) for name, c in batch.columns.items())
    return (cols, slot(batch.mask), slot(batch.errors)), tensors


def _unflatten(layout: tuple, tensors: List[torch.Tensor]) -> DeviceBatch:
    def get(i: Optional[int]) -> Optional[torch.Tensor]:
        return None if i is None else tensors[i]

    def column(d: tuple) -> DeviceColumn:
        dtype, dictionary, data, validity, starts, children = d
        return DeviceColumn(tensors[data], get(validity), dtype, dictionary,
                            tuple(column(ch) for ch in children), get(starts))

    cols, mask, errors = layout
    return DeviceBatch({name: column(d) for name, d in cols}, tensors[mask],
                       get(errors))


def _ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


class HostBatch:
    """A device batch offloaded to host RAM: each of its tensors copied
    out (``_flatten``), dictionaries kept by reference. From a CUDA batch
    the copies go into pinned host tensors, asynchronously on the current
    stream; a host buffer that cannot be pinned raises rather than fall
    back to pageable memory. From a CPU batch the tensors are cloned.
    ``restore()`` puts the batch back on the device it came from."""

    def __init__(self, batch: DeviceBatch):
        t0 = time.perf_counter()
        self.layout, tensors = _flatten(batch)
        self.device = batch.device
        self.nbytes = batch_nbytes(batch)
        self._start = self._ready = None
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._start = torch.cuda.Event(enable_timing=True)
            self._ready = torch.cuda.Event(enable_timing=True)
            self._start.record(stream)
            self.tensors = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.tensors.append(h)
            self._ready.record(stream)
        else:
            self.tensors = [t.clone() for t in tensors]
        M.record_histogram(M.K_OFFLOAD_HOST_MS, _ms_since(t0))
        M.record_counter(M.K_OFFLOAD_HOST_BYTES, self.nbytes)

    def wait(self) -> None:
        """Block until the device-to-host copies are complete: numpy may
        read the host tensors only after this."""
        if self._ready is not None:
            self._ready.synchronize()
            M.record_histogram(M.K_OFFLOAD_COPY_MS,
                               self._start.elapsed_time(self._ready))
            self._start = self._ready = None

    def arrays(self) -> List[np.ndarray]:
        """The host tensors as numpy arrays (sharing memory)."""
        self.wait()
        return [t.numpy() for t in self.tensors]

    def restore(self) -> DeviceBatch:
        self.wait()
        return _upload(self.layout, self.tensors, self.device)

    def __getstate__(self):
        # pickled (the SSD tier) as numpy arrays, dictionaries by value
        return {"layout": self.layout, "device": str(self.device),
                "nbytes": self.nbytes, "arrays": self.arrays()}

    def __setstate__(self, state):
        self.layout = state["layout"]
        self.device = torch.device(state["device"])
        self.nbytes = state["nbytes"]
        self.tensors = [torch.from_numpy(a) for a in state["arrays"]]
        self._start = self._ready = None


def _upload(layout: tuple, tensors: List[torch.Tensor],
            device: torch.device) -> DeviceBatch:
    """The batch of host `tensors` on `device`. On a CUDA card the copies
    complete before it returns: the batch may be handed to any stream."""
    if device.type != "cuda":
        return _unflatten(layout, tensors)
    out = [t.to(device, non_blocking=True) for t in tensors]
    torch.cuda.current_stream(device).synchronize()
    return _unflatten(layout, out)


class DiskBatch:
    """A host batch spilled to a file: its arrays in one ``.npz`` under
    ``spill_dir``, its layout (dtypes, dictionaries) kept here. The disk
    tier below host offload (parity: velox Spiller writing spill files,
    exec/Spiller.h:29-92). The file goes on ``restore()`` and on
    ``delete()``. A failed write raises."""

    def __init__(self, host: HostBatch, spill_dir: str):
        os.makedirs(spill_dir, exist_ok=True)
        self.path = os.path.join(spill_dir,
                                 f"spill-{uuid.uuid4().hex}.npz")
        self.layout = host.layout
        self.device = host.device
        self.nbytes = host.nbytes
        arrays = host.arrays()
        self.n_arrays = len(arrays)
        t0 = time.perf_counter()
        try:
            np.savez(self.path, **{f"a{i}": a for i, a in enumerate(arrays)})
        except BaseException:
            self.delete()
            raise
        M.record_histogram(M.K_SPILL_DISK_WRITE_MS, _ms_since(t0))
        M.record_counter(M.K_SPILL_DISK_WRITES)
        M.record_counter(M.K_SPILL_DISK_WRITE_BYTES, self.nbytes)

    def restore(self) -> DeviceBatch:
        t0 = time.perf_counter()
        with np.load(self.path) as z:
            tensors = [torch.from_numpy(z[f"a{i}"])
                       for i in range(self.n_arrays)]
        self.delete()
        M.record_histogram(M.K_SPILL_DISK_READ_MS, _ms_since(t0))
        M.record_counter(M.K_SPILL_DISK_READ_BYTES, self.nbytes)
        return _upload(self.layout, tensors, self.device)

    def delete(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass


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


class DeviceLru:
    """LRU of device-resident values under a byte budget (None: no
    budget) and an optional entry cap, under a lock. Each entry's bytes
    are reserved in the device root; an entry that cannot be reserved is
    not kept. The arbitrator reclaims from it first (``PRI_CACHE``),
    evicting LRU entries. The scan cache and the Values ingest cache are
    two of them; a subclass's ``_evicted`` sees what left, after the lock
    is released."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None):
        self.budget = budget_bytes
        self.max_entries = max_entries
        self.used = 0
        self._entries: "OrderedDict" = OrderedDict()  # key -> (value, n)
        self._lock = threading.Lock()
        self._pool = MemoryPool.device_root()
        MemoryArbitrator.instance().register(
            self, MemoryArbitrator.PRI_CACHE)

    def _lookup(self, key):
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                return None
            self._entries.move_to_end(key)
            return hit[0]

    def _full(self, n: int) -> bool:
        return (self.budget is not None and self.used + n > self.budget) \
            or (self.max_entries is not None
                and len(self._entries) >= self.max_entries)

    def _pop_lru(self) -> Tuple:
        key, (value, n) = self._entries.popitem(last=False)
        self.used -= n
        self._pool.release(n)
        return key, value, n

    def _insert(self, key, value, n: int) -> List[Tuple]:
        """Keep `value` under `key` (unless it is over the budget or the
        device root refuses its bytes); returns the (key, value, bytes)
        evicted for it, after ``_evicted`` has seen them."""
        if self.budget is not None and n > self.budget:
            return []
        evicted = []
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self.used -= old[1]
                self._pool.release(old[1])
            while self._entries and self._full(n):
                evicted.append(self._pop_lru())
            # a capped root refuses: skip the entry rather than oust
            # operator state (the arbitrator cannot help: a cache is its
            # first reclaim target)
            if self._pool.reserve(n):
                self._entries[key] = (value, n)
                self.used += n
        self._evicted(evicted)
        return evicted

    def _evicted(self, evicted: List[Tuple]) -> None:
        """Hook: entries that left by eviction or reclaim."""

    def reclaim(self, needed: int) -> int:
        """Arbitrator hook: evict LRU entries until `needed` bytes are
        freed; returns the bytes freed."""
        evicted = []
        with self._lock:
            freed = 0
            while self._entries and freed < needed:
                evicted.append(self._pop_lru())
                freed += evicted[-1][2]
        self._evicted(evicted)
        return freed

    def clear(self) -> None:
        """Drop every entry and release its bytes."""
        with self._lock:
            while self._entries:
                self._pop_lru()


class OffloadBuffer:
    """Byte-budgeted batch buffer across three tiers: batches stay on the
    device until ``budget_bytes`` (or the pool) is exceeded, then go to
    host RAM (``HostBatch``), and past ``host_budget_bytes`` the oldest
    host batches go to spill files (``DiskBatch``) under ``spill_dir``
    (a temporary directory of its own when None). ``max_spill_bytes``
    caps the disk bytes. With a ``pool``, device batches are reserved in
    it and the arbitrator may force the oldest of them to host RAM.
    Parity: the spill framework for join builds and sort buffers
    (velox/exec/Spiller.h:29-92, kHashJoinBuild / kOrderBy)."""

    def __init__(self, budget_bytes: Optional[int], metric_key=None,
                 pool: Optional[MemoryPool] = None,
                 host_budget_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 max_spill_bytes: Optional[int] = None):
        self.budget = budget_bytes
        self.used = 0
        self.host_budget = host_budget_bytes
        self.host_used = 0
        self.max_spill_bytes = max_spill_bytes
        self.disk_used = 0
        # (sequence number, batch) in each tier: restore_all sorts by it
        self._device: List[Tuple[int, DeviceBatch]] = []
        self._host: List[Tuple[int, HostBatch]] = []
        self._disk: List[Tuple[int, DiskBatch]] = []
        self._seq = 0
        self._metric_key = metric_key
        self._spill_dir = spill_dir
        self._own_dir: Optional[str] = None  # made here, removed here
        self._pool = pool
        if pool is not None:
            MemoryArbitrator.instance().register(
                self, MemoryArbitrator.PRI_OPERATOR)

    def _dir(self) -> str:
        if self._spill_dir is None:
            self._spill_dir = self._own_dir = tempfile.mkdtemp(
                prefix="velox_tpu_torch_spill_")
        return self._spill_dir

    def _to_host(self, seq: int, batch: DeviceBatch) -> None:
        if self._metric_key is not None:
            M.record_counter(self._metric_key)
        h = HostBatch(batch)
        self._host.append((seq, h))
        self.host_used += h.nbytes
        if self.host_budget is None:
            return
        while self._host and self.host_used > self.host_budget:
            oseq, oldest = self._host[0]
            if self.max_spill_bytes is not None and \
                    self.disk_used + oldest.nbytes > self.max_spill_bytes:
                raise VeloxRuntimeError(
                    f"spill limit exceeded: {self.disk_used} + "
                    f"{oldest.nbytes} bytes > max_spill_bytes="
                    f"{self.max_spill_bytes}")
            self._disk.append((oseq, DiskBatch(oldest, self._dir())))
            self._host.pop(0)
            self.host_used -= oldest.nbytes
            self.disk_used += oldest.nbytes

    def add(self, batch: DeviceBatch) -> None:
        seq, self._seq = self._seq, self._seq + 1
        n = batch_nbytes(batch)
        if (self.budget is not None and self.used + n > self.budget) or (
                self._pool is not None
                and not self._pool.reserve_or_reclaim(n)):
            self._to_host(seq, batch)
            return
        self.used += n
        self._device.append((seq, batch))

    def reclaim(self, needed: int) -> int:
        """Arbitrator hook: move the oldest device batches to host RAM
        until `needed` bytes are freed; returns the bytes freed (parity:
        Operator::reclaim, exec/Operator.h:557)."""
        freed = 0
        while self._device and freed < needed:
            seq, batch = self._device.pop(0)
            n = batch_nbytes(batch)
            self._to_host(seq, batch)
            self.used -= n
            if self._pool is not None:
                self._pool.release(n)
            freed += n
        return freed

    def _release(self) -> None:
        if self._pool is not None:
            MemoryArbitrator.instance().unregister(self)
            self._pool.release(self.used)
        self.used = 0
        if self._own_dir is not None:
            os.rmdir(self._own_dir)
            self._own_dir = self._spill_dir = None

    def close(self) -> None:
        """Drop every batch: release the pool's bytes and delete the
        spill files."""
        for _, d in self._disk:
            d.delete()
        self._device, self._host, self._disk = [], [], []
        self.host_used = self.disk_used = 0
        self._release()

    def __len__(self) -> int:
        return len(self._device) + len(self._host) + len(self._disk)

    def restore_all(self) -> List[DeviceBatch]:
        """Every buffered batch back on the device, in the order it was
        added (spill files are deleted as they are read)."""
        out = list(self._device)
        out += [(s, h.restore()) for s, h in self._host]
        self._host = []
        while self._disk:
            s, d = self._disk.pop(0)
            out.append((s, d.restore()))
        self._device = []
        self.host_used = self.disk_used = 0
        self._release()
        out.sort(key=lambda sb: sb[0])
        return [b for _, b in out]

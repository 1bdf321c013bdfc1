"""Distributed exchange: repartition rows between the shards of a mesh.

Counterpart of ``velox_tpu/parallel/exchange.py``. Role parity:
``velox/exec/PartitionedOutput.h:149`` + ``OutputBuffer`` + ``Exchange``
(SURVEY.md §3.5/§5.8). The reference lays each shard's rows out in an
(n, window) send buffer and moves them with one ``lax.all_to_all``. Here a
single controller drives every shard, so the exchange is explicit tensor
movement: each source shard bucketizes its rows by destination (a stable
radix sort of the destination id, kernels B4 and B3, then one
multi-column gather, B5), and destination j receives source i's rows for
it as one contiguous slice, moved with ``.to(mesh.devices[j],
non_blocking=True)`` and concatenated in source order. On one card every
shard is on ``cuda:0`` and the move is a no-op.

The reference sizes each exchange with a power-of-two static window
(``window_for``, ``partition_max_count``) to bound XLA's compiled
programs, and reads the window's count maximum on the host once an
exchange. Eager PyTorch compiles nothing, so the port sizes each exchange
from its exact per-destination counts instead: one host read of the
(n, n) count matrix an exchange, in place of ``_count_window``'s. The
windows, ``window_for`` and ``partition_max_count`` are left out;
``partition_max_count_spread``'s role is taken by the count matrix of the
spread routing.

Every shard's work runs in order on the device's current stream, so a
moved slice is ordered before its use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from velox_tpu_torch.exec.batch_utils import (
    concat_batches, slice_batch, take_columns_rows,
)
from velox_tpu_torch.exec.hashtable import hash_rows
from velox_tpu_torch.exec.sort import radix_sort_perm
from velox_tpu_torch.expression.eval import EvalValue, value_from_column
from velox_tpu_torch.parallel.mesh import Mesh
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn

# one shard's rows of a wave; None: the shard has none
Shards = List[Optional[DeviceBatch]]


def partition_ids(keys: Sequence[EvalValue], capacity: int,
                  n: int) -> torch.Tensor:
    """Destination id per row = hash(keys) % n (int64).
    Parity: exec/HashPartitionFunction.h."""
    return hash_rows(keys, capacity) % n


# ---------------------------------------------------------------------------
# PartitionFunction SPI. Parity: core/PlanNode.h:1116 PartitionFunction +
# exec/HashPartitionFunction.h / RoundRobinPartitionFunction /
# connectors/hive/HivePartitionFunction.h. A spec name resolves to
# fn(keys, mask, capacity, n, start, bucket_count) -> int64 destination
# per row; ``start`` is the count of rows earlier batches emitted
# (round-robin continuity across batches).
# ---------------------------------------------------------------------------

def _hash_partition(keys, mask, capacity, n, start, bucket_count):
    return partition_ids(keys, capacity, n)


def _round_robin_partition(keys, mask, capacity, n, start, bucket_count):
    """Active-row ordinal (continuing across batches) modulo n.
    Parity: exec/RoundRobinPartitionFunction."""
    ordinal = torch.cumsum(mask.to(torch.int64), 0) - 1 + start
    return ordinal % n


def _hive_bucket_partition(keys, mask, capacity, n, start, bucket_count):
    """Bucket-compatible shuffle: the Spark murmur3 (seed 42) that the
    Hive connector's bucketed writes use (connectors/hive.py
    ``_np_murmur3 % bucket_count``), so a destination owns whole bucket
    files. dest = bucket % n. Parity:
    connectors/hive/HivePartitionFunction.h."""
    from velox_tpu_torch.functions.sparksql import _mm_column
    seed = 42
    for v in keys:
        h = _mm_column(v, seed, capacity)
        if v.validity is not None:
            prev = (seed if torch.is_tensor(seed)
                    else torch.full_like(h, seed))
            h = torch.where(v.full_validity(capacity), h, prev)
        seed = h
    if not torch.is_tensor(seed):
        raise ValueError("hive_bucket partitioning needs a key column")
    h32 = torch.where(seed >= (1 << 31), seed - (1 << 32), seed)
    bucket = torch.remainder(h32, bucket_count)  # floored: >= 0
    return bucket % n


_PARTITION_FUNCTIONS = {
    "hash": _hash_partition,
    "round_robin": _round_robin_partition,
    "hive_bucket": _hive_bucket_partition,
}


def register_partition_function(name: str, fn):
    """SPI hook (parity: PartitionFunction::SpecFactory registration)."""
    _PARTITION_FUNCTIONS[name] = fn


def resolve_partition_function(name: str):
    try:
        return _PARTITION_FUNCTIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown partition function {name!r} "
            f"(have {sorted(_PARTITION_FUNCTIONS)})") from None


# ---------------------------------------------------------------------------
# Per-shard bucketize
# ---------------------------------------------------------------------------

def destinations(batch: DeviceBatch, key_names: Sequence[str],
                 n: int) -> torch.Tensor:
    """hash(keys) % n per row, n for an inactive row (dropped)."""
    keys = [value_from_column(batch.columns[k]) for k in key_names]
    dest = partition_ids(keys, batch.capacity, n)
    return torch.where(batch.mask, dest, n)


def bucketize(dest: torch.Tensor, n: int):
    """(perm, counts): the stable permutation grouping rows by
    destination (rows of destination n, the dropped ones, last) and the
    rows headed to each of the n destinations. The permutation is one
    radix sort of the destination id: the scatter branch, B4 then B3 a
    pass (the reference's ``radix_sort_perm`` over ``dest``). A stable
    permutation is unique, so each destination's rows keep their input
    order."""
    bits = max(1, n.bit_length())  # ids 0..n
    perm = radix_sort_perm([dest], [bits], dest.shape[0])
    return perm, dest_counts(dest, n)


def dest_counts(dest: torch.Tensor, n: int) -> torch.Tensor:
    """Rows headed to each of the n destinations (int64[n])."""
    return torch.bincount(dest, minlength=n + 1)[:n]


def take_prefix(batch: DeviceBatch, perm: torch.Tensor,
                rows: int) -> DeviceBatch:
    """The batch's rows at ``perm[:rows]``, all active: one multi-column
    gather (B5)."""
    _refuse_complex(batch)
    idx = perm[:rows]
    cols = take_columns_rows(batch.columns, idx)
    mask = torch.ones((rows,), dtype=torch.bool, device=batch.device)
    return DeviceBatch(cols, mask)


def _refuse_complex(batch: DeviceBatch) -> None:
    """ARRAY/MAP columns need element-space exchange, which these row
    transports do not do (as in the reference)."""
    for name, col in batch.columns.items():
        if col.dtype.is_complex:
            raise NotImplementedError(
                f"column {name!r}: ARRAY/MAP columns are not supported "
                "across the distributed exchange yet")


def to_device(batch: DeviceBatch, device: torch.device) -> DeviceBatch:
    """The batch on ``device`` (itself when it is there already)."""
    if batch.device == device:
        return batch

    def move(a: torch.Tensor) -> torch.Tensor:
        return a.to(device, non_blocking=True)

    def col(c: DeviceColumn) -> DeviceColumn:
        return DeviceColumn(
            move(c.data), None if c.validity is None else move(c.validity),
            c.dtype, c.dictionary, tuple(col(ch) for ch in c.children),
            None if c.starts is None else move(c.starts))

    return DeviceBatch({k: col(c) for k, c in batch.columns.items()},
                       move(batch.mask),
                       None if batch.errors is None else move(batch.errors))


# ---------------------------------------------------------------------------
# Exchanges between shards
# ---------------------------------------------------------------------------

@dataclass
class ExchangeStats:
    """One exchange: rows and bytes that reached a destination shard,
    and the host reads that sized it."""
    kind: str
    rows: int = 0
    bytes: int = 0
    host_reads: int = 0


def count_matrix(counts: Sequence[Optional[torch.Tensor]], n: int,
                 device: torch.device) -> List[List[int]]:
    """counts[i][j]: rows source shard i sends to destination j, in one
    host read (a source without rows sends none)."""
    rows = [c.to(device, non_blocking=True) if c is not None
            else torch.zeros((n,), dtype=torch.int64, device=device)
            for c in counts]
    return torch.stack(rows).tolist()


def repartition(shards: Shards, dests: Sequence[Optional[torch.Tensor]],
                mesh: Mesh, stats: Optional[ExchangeStats] = None
                ) -> Shards:
    """Move every shard's rows to the destination ``dests[i]`` gives
    each (n: dropped). Counterpart of ``repartition_all_to_all``:
    destination j gets source i's rows for it as one contiguous slice, in
    source order, in a batch whose every row is active."""
    n = mesh.size
    perms: List[Optional[torch.Tensor]] = [None] * n
    counts: List[Optional[torch.Tensor]] = [None] * n
    for i, (b, d) in enumerate(zip(shards, dests)):
        if b is not None:
            perms[i], counts[i] = bucketize(d, n)
    mat = count_matrix(counts, n, mesh.devices[0])
    if stats is not None:
        stats.host_reads += 1
    parts: List[List[DeviceBatch]] = [[] for _ in range(n)]
    for i, b in enumerate(shards):
        if b is None or not sum(mat[i]):
            continue
        grouped = take_prefix(b, perms[i], sum(mat[i]))
        off = 0
        for j, c in enumerate(mat[i]):
            if c:
                parts[j].append(to_device(slice_batch(grouped, off, c),
                                          mesh.devices[j]))
            off += c
    out: Shards = [concat_batches(p) if p else None for p in parts]
    if stats is not None:
        stats.rows += sum(map(sum, mat))
        stats.bytes += sum(b.nbytes for b in out if b is not None)
    return out


def partition_histogram(matrix: Sequence[Sequence[int]]) -> List[int]:
    """Global rows per destination from an exchange's count matrix: the
    skew signal (SURVEY §7.2 step 7), a destination holding far more
    than total/n rows marks its hash range hot."""
    return [sum(col) for col in zip(*matrix)]


def _spread_dest(dest: torch.Tensor, active: torch.Tensor,
                 hot: torch.Tensor, n: int, shard: int) -> torch.Tensor:
    """Re-route rows whose destination is hot round-robin over every
    shard (offset by the sender's index, so senders interleave): the
    key-splitting half of skew handling; the matching build rows are
    replicated to every shard (``gather_hot_rows``)."""
    cap = dest.shape[0]
    rr = (torch.arange(cap, dtype=torch.int64, device=dest.device)
          + shard) % n
    is_hot = active & (dest < n) & hot[torch.clamp(dest, 0, n - 1)]
    return torch.where(is_hot, rr, dest)


def gather_hot_rows(partitioned: Shards, hot: Sequence[bool],
                    mesh: Mesh) -> Dict[torch.device, DeviceBatch]:
    """Every build row whose destination is hot, once on each device:
    after a hash repartition those are exactly the rows of the hot
    destination shards, so their union is the reference's all_gather of
    the hot-range rows (the build-side replication half of key
    splitting). Empty when no hot shard holds a row."""
    rows = [b for j, b in enumerate(partitioned) if hot[j] and b is not None]
    if not rows:
        return {}
    union = concat_batches([to_device(b, mesh.devices[0]) for b in rows])
    return {d: to_device(union, d) for d in mesh.distinct_devices()}


def broadcast_gather(shards: Shards, mesh: Mesh,
                     stats: Optional[ExchangeStats] = None) -> Shards:
    """Every shard's rows on every shard: one concatenation, copied once
    per distinct device (not once per shard: on one card the shards share
    it). The broadcast join's build side and the gather exchange. None
    when no shard holds rows."""
    rows = [b for b in shards if b is not None]
    if not rows:
        return [None] * mesh.size
    for b in rows:
        _refuse_complex(b)
    union = concat_batches([to_device(b, mesh.devices[0]) for b in rows])
    copies = {d: to_device(union, d) for d in mesh.distinct_devices()}
    if stats is not None:
        stats.rows += sum(b.capacity for b in rows)
        stats.bytes += union.nbytes * len(copies)
    return [copies[d] for d in mesh.devices]

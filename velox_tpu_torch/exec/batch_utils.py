"""Batch-level utilities: concat, compaction, row gathers and slices.

Counterpart of ``velox_tpu/exec/batch_utils.py``. Compaction (moving
active rows to the front) is done only at operator boundaries that profit
(buffered sorts, aggregation runs), as in the reference. Every function
keeps the batch on its device and never reads a device value on the host.

A DECIMAL(19..38) column's high limb, a raw string's byte lengths
(``children[0]``) and a ROW column's fields are row-aligned and move with
their parent; raw byte matrices of different size classes concatenate
after zero-padding to the widest, and their row gathers run through
kernel B5 as 8-byte lanes (ops/gather.py ``take_rows``). An ARRAY/MAP
column's element children stay where they are: a row transform moves its
counts and its per-row element starts (vector/device.py), so a gathered
row still finds its elements, and a concatenation appends the parts'
children in element space and shifts each part's starts.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.ops.gather import take_many_rows, take_rows
from velox_tpu_torch.vector import strings as S
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn


def _row_aligned_children(col: DeviceColumn) -> bool:
    """Whether the column's children have its rows (ROW fields, a long
    decimal's high limb, a raw string's lengths) rather than elements."""
    return (col.dtype.kind is T.TypeKind.ROW or col.dtype.is_long_decimal
            or S.is_raw(col))


def _element_children(col: DeviceColumn) -> bool:
    return col.dtype.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP)


def concat_batches(batches: List[DeviceBatch]) -> DeviceBatch:
    """Concatenate batches (same schema) into one larger batch."""
    if len(batches) == 1:
        return batches[0]

    def concat_cols(parts: List[DeviceColumn]) -> DeviceColumn:
        first = parts[0]
        if S.is_raw(first):
            w = max(p.data.shape[1] for p in parts)
            data = torch.cat([S.pad_width(p.data, w) for p in parts])
        else:
            data = torch.cat([p.data for p in parts])
        if any(p.validity is not None for p in parts):
            validity = torch.cat([
                p.validity if p.validity is not None
                else torch.ones((p.capacity,), dtype=torch.bool,
                                device=p.data.device)
                for p in parts])
        else:
            validity = None
        children = first.children
        starts = None
        if _row_aligned_children(first) or _element_children(first):
            children = tuple(concat_cols([p.children[i] for p in parts])
                             for i in range(len(first.children)))
        if _element_children(first):
            # each part's rows point past the element capacity before it
            shift, pieces = 0, []
            for p in parts:
                pieces.append(p.offsets() + shift)
                shift += p.children[0].capacity
            starts = torch.cat(pieces)
        return DeviceColumn(data, validity, first.dtype, first.dictionary,
                            children, starts)

    cols = {name: concat_cols([b.columns[name] for b in batches])
            for name in batches[0].columns}
    mask = torch.cat([b.mask for b in batches])
    return DeviceBatch(cols, mask)


def map_column_rows(col: DeviceColumn,
                    f: Callable[[torch.Tensor], torch.Tensor]
                    ) -> DeviceColumn:
    """Apply a row-axis transform to a column and to its row-aligned
    children (ROW fields, the long-decimal high limb, a raw string's
    lengths); an ARRAY/MAP column's element starts go through it too,
    made explicit, and its element children stay shared."""
    data = f(col.data)
    validity = f(col.validity) if col.validity is not None else None
    children = col.children
    starts = None
    if _row_aligned_children(col):
        children = tuple(map_column_rows(c, f) for c in col.children)
    elif _element_children(col):
        starts = f(col.offsets())
    return DeviceColumn(data, validity, col.dtype, col.dictionary, children,
                        starts)


def take_columns_rows(columns: Dict[str, DeviceColumn],
                      idx: torch.Tensor) -> Dict[str, DeviceColumn]:
    """Every column (with its validity and row-aligned children) at rows
    ``idx``: all their 4- and 8-byte arrays through kernel B5's
    multi-column gather, up to eight to a launch that reads ``idx`` once
    (ops/gather.py ``take_many_rows``)."""
    arrays: List[torch.Tensor] = []

    def record(a: torch.Tensor) -> torch.Tensor:
        arrays.append(a)
        return a

    for col in columns.values():
        map_column_rows(col, record)
    taken = iter(take_many_rows(arrays, idx))
    return {name: map_column_rows(col, lambda a: next(taken))
            for name, col in columns.items()}


def compact(batch: DeviceBatch) -> DeviceBatch:
    """Move active rows to the front (stable), preserving order:
    cumsum + scatter."""
    cap = batch.capacity
    dense = torch.cumsum(batch.mask.to(torch.int64), 0) - 1
    target = torch.where(batch.mask, dense, cap)

    def scat(a):
        out = torch.zeros((cap + 1,) + a.shape[1:], dtype=a.dtype,
                          device=a.device)
        out[target] = a
        return out[:cap]

    cols = {name: map_column_rows(col, scat)
            for name, col in batch.columns.items()}
    n = batch.num_active()
    mask = torch.arange(cap, dtype=torch.int32, device=batch.device) < n
    return DeviceBatch(cols, mask)


def _take_any(a: torch.Tensor, indices) -> torch.Tensor:
    """``a[indices]``: a raw byte matrix through B5 (its rows are whole
    8-byte lanes), everything else by plain indexing."""
    return take_rows(a, indices) if a.dim() == 2 else a[indices]


def take(batch: DeviceBatch, indices, valid_rows) -> DeviceBatch:
    """Gather rows by index; `valid_rows` becomes the new mask."""
    cols = {name: map_column_rows(col, lambda a: _take_any(a, indices))
            for name, col in batch.columns.items()}
    return DeviceBatch(cols, valid_rows)


def slice_batch(batch: DeviceBatch, start: int, length: int) -> DeviceBatch:
    """Static slice of a batch's rows (used to re-chunk large batches)."""
    def f(a):
        return a[start:start + length]
    cols = {name: map_column_rows(col, f)
            for name, col in batch.columns.items()}
    return DeviceBatch(cols, batch.mask[start:start + length])


def compact_batch(batch: DeviceBatch, out_cap: int) -> DeviceBatch:
    """Gather active rows into a dense prefix of a batch of capacity
    `out_cap` (active rows beyond it are dropped)."""
    m = batch.mask.to(torch.int64)
    pos = torch.cumsum(m, 0) - m
    tgt = torch.where(batch.mask, torch.clamp(pos, max=out_cap - 1),
                      out_cap)

    def scatter(a):
        out = torch.zeros((out_cap + 1,) + a.shape[1:], dtype=a.dtype,
                          device=a.device)
        out[tgt] = a
        return out[:out_cap]

    cols = {n: map_column_rows(c, scatter)
            for n, c in batch.columns.items()}
    n_active = m.sum()
    mask = torch.arange(out_cap, dtype=torch.int64,
                        device=batch.device) < n_active
    return DeviceBatch(cols, mask)

"""Segmented reductions over sorted runs, the unique-index scatter and
the compaction of kept rows.

Counterpart of ``velox_tpu/ops/wide.py``. The reference splits 64-bit
scatters into 32-bit halves (and f64 into three f32 parts) because
XLA:TPU scatters 64-bit values ~20x slower than 32-bit ones; Hopper
scatters 64-bit values natively, so ``scatter_unique_set`` is one
indexed store. The run reductions keep the reference's formulation,
which sort-mode group-by uses (exec/groupby.py):

* integer sums: global cumsum + end-of-run scatter + adjacent difference
  (exact: integer addition is associative);
* min/max and float sums: a segmented Hillis-Steele doubling scan (a
  shift + select per power of two) + end-of-run scatter. Float sums take
  the scan because a global running total mixes groups (2e300 + 5 ==
  2e300 would absorb a small group that follows a huge one).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch


def scatter_unique_set(out_len: int, idx: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """``zeros(out_len)[idx] = values``. Indices must be unique, except a
    junk slot the caller slices off, whose winner is unspecified."""
    out = torch.zeros((out_len,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    out[idx] = values
    return out


def compact_kept(cols: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                 keep: torch.Tensor
                 ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """The rows where ``keep`` moved to a dense prefix, in order, for
    each (data, validity) pair: a cumulative sum and one scatter, with
    no host read. The rest of each output is zeros (validity True)."""
    n = keep.shape[0]
    k = keep.to(torch.int64)
    tgt = torch.where(keep, torch.cumsum(k, 0) - 1, n)
    out = []
    for data, validity in cols:
        d = scatter_unique_set(n + 1, tgt, data)[:n]
        v = None
        if validity is not None:
            v = torch.ones((n + 1,), dtype=torch.bool, device=keep.device)
            v[tgt] = validity
            v = v[:n]
        out.append((d, v))
    return out


def _identity(dtype: torch.dtype, combine: str):
    if combine == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if combine == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if combine == "min" else info.min


def segmented_reduce_sorted(data: torch.Tensor, gid: torch.Tensor,
                            boundary: torch.Tensor,
                            active_sorted: torch.Tensor, capacity: int,
                            combine: str) -> torch.Tensor:
    """Per-group reduction over rows sorted by group: groups are runs,
    gid is non-decreasing, inactive rows trail (already carrying the
    combine identity). Returns group values as a dense prefix of length
    `capacity`."""
    is_end = torch.cat([boundary[1:],
                        torch.ones((1,), dtype=torch.bool,
                                   device=boundary.device)])
    idx_end = torch.where(is_end & active_sorted, gid, capacity)
    if combine == "sum" and not data.dtype.is_floating_point:
        cs = torch.cumsum(data, 0)
        ends = scatter_unique_set(capacity + 1, idx_end, cs)[:capacity]
        prev = torch.cat([torch.zeros_like(ends[:1]), ends[:-1]])
        return ends - prev
    if combine == "sum":
        op = torch.add
    else:
        op = torch.minimum if combine == "min" else torch.maximum
    return _segmented_scan_reduce(data, idx_end, boundary, capacity, op,
                                  _identity(data.dtype, combine))


def _segmented_scan_reduce(data, idx_end, boundary, capacity: int, op,
                           ident):
    """Segmented doubling scan + end-of-run scatter (the general-combine
    path of segmented_reduce_sorted)."""
    run_off = segment_offsets(boundary, capacity)
    x = _segmented_scan(data, run_off, capacity, op, ident)
    return scatter_unique_set(capacity + 1, idx_end, x)[:capacity]


def segment_offsets(boundary: torch.Tensor, capacity: int) -> torch.Tensor:
    """Per-row offset within its run (0 at run starts)."""
    iota = torch.arange(capacity, dtype=torch.int64, device=boundary.device)
    run_start = torch.cummax(torch.where(boundary, iota, 0), 0).values
    return iota - run_start


def _segmented_scan(data, run_off, capacity: int, op, ident):
    x = data
    k = 1
    while k < capacity:
        shifted = torch.cat([torch.full((k,) + tuple(x.shape[1:]), ident,
                                        dtype=x.dtype, device=x.device),
                             x[:-k]])
        take = run_off >= k
        if x.dim() > 1:
            take = take[:, None]
        x = torch.where(take, op(x, shifted), x)
        k <<= 1
    return x


def segmented_scan_values(data: torch.Tensor, run_off: torch.Tensor,
                          capacity: int, combine: str):
    """Per-row inclusive segmented scan: the value at each run's last row
    is the run's reduction. Returns (values, needs_diff): with needs_diff
    the values are a global running total (integer sums), and the caller
    takes adjacent differences after compacting the run ends."""
    if combine == "sum" and not data.dtype.is_floating_point:
        return torch.cumsum(data, 0), True
    if combine == "sum":
        op = torch.add
    else:
        op = torch.minimum if combine == "min" else torch.maximum
    return _segmented_scan(data, run_off, capacity, op,
                           _identity(data.dtype, combine)), False

"""Fused scan-filter-sum(product): one pass over the scan batch.

Counterpart of ``velox_tpu/ops/filter_reduce.py``. The pattern: a global
``sum(a * b)`` over int32-stored columns under a conjunction of
per-column range predicates — TPC-H Q6 exactly. ``match_filter_sum``
recognizes it in a fused scan chain and ``FilterSumOperator`` runs
``filtered_sum_product`` once per scan batch:

* on a CUDA tensor, the hand-written kernel in ``csrc/filter_sum.cu``
  (exact int64 accumulation, one atomic add per block);
* on a CPU tensor, its plain PyTorch version
  ``filtered_sum_product_reference``.

The matcher is the reference's, unchanged, so both engines pick the
kernel on the same plans. That includes ``MAX_B_ABS``: the reference needs
the bound for its TPU int32 lane sums, and Hopper's int64 accumulation
does not; widening the matcher is a separate change with its own test.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn

# The reference's |b| bound for its 1024-row int32 lane sums:
# 1024 * 65535 * |b| < 2^31.
MAX_B_ABS = (2 ** 31 - 1) // (1024 * 65536)

# the kernel's fixed argument slots (csrc/filter_sum.cu kMaxCols/kMaxRanges)
MAX_COLS = 8
MAX_RANGES = 8


def filtered_sum_product_reference(cols: List[torch.Tensor], ranges,
                                   ai: int, bi: int,
                                   n_active) -> torch.Tensor:
    """Plain PyTorch version of the kernel: sum over rows with
    ``row < n_active`` passing every ``(col_idx, lo, hi)`` range of
    ``cols[ai] * cols[bi]``, exact in int64. Returns a 0-dim int64 tensor."""
    n = cols[0].shape[0]
    keep = torch.arange(n, device=cols[0].device) < n_active
    for (i, lo, hi) in ranges:
        c = cols[i].long()
        keep = keep & (c >= lo) & (c <= hi)
    prod = cols[ai].long() * cols[bi].long()
    return torch.where(keep, prod, 0).sum()


class _FilterSumArgs(ctypes.Structure):
    """Mirror of ``FilterSumArgs`` in csrc/filter_sum.cu."""
    _fields_ = [
        ("cols", ctypes.c_void_p * MAX_COLS),
        ("lo", ctypes.c_int64 * MAX_RANGES),
        ("hi", ctypes.c_int64 * MAX_RANGES),
        ("range_col", ctypes.c_int32 * MAX_RANGES),
        ("n_ranges", ctypes.c_int32),
        ("a_col", ctypes.c_int32),
        ("b_col", ctypes.c_int32),
        ("pad", ctypes.c_int32),
        ("n", ctypes.c_int64),
    ]


def _kernel_lib():
    from velox_tpu_torch.native.build import load_kernel
    fn = load_kernel("filter_sum").vt_filter_sum
    if fn.argtypes is None:
        fn.argtypes = [_FilterSumArgs, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_args(cols: List[torch.Tensor], ranges, ai: int, bi: int):
    if not cols:
        raise ValueError("filtered_sum_product needs at least one column")
    if len(cols) > MAX_COLS or len(ranges) > MAX_RANGES:
        raise ValueError(
            f"filtered_sum_product takes at most {MAX_COLS} columns and "
            f"{MAX_RANGES} ranges, got {len(cols)} and {len(ranges)}")
    n = cols[0].shape[0]
    dev = cols[0].device
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != n \
                or c.device != dev or not c.is_contiguous():
            raise ValueError(
                "filtered_sum_product takes contiguous 1-D int32 columns "
                f"of one length on one device; got {c.dtype} "
                f"{tuple(c.shape)} on {c.device}")
    for idx in [ai, bi] + [r[0] for r in ranges]:
        if not 0 <= idx < len(cols):
            raise ValueError(f"column index {idx} out of range")


def _launch(cols: List[torch.Tensor], ranges, ai: int, bi: int,
            n_active) -> torch.Tensor:
    dev = cols[0].device
    if isinstance(n_active, torch.Tensor):
        if n_active.device != dev or n_active.numel() != 1:
            raise ValueError("n_active must be one value on the columns' "
                             "device")
        n_act = n_active.reshape(()).to(torch.int32).contiguous()
    else:
        n_act = torch.tensor(int(n_active), dtype=torch.int32, device=dev)
    args = _FilterSumArgs()
    for i, c in enumerate(cols):
        args.cols[i] = c.data_ptr()
    for r, (i, lo, hi) in enumerate(ranges):
        args.range_col[r], args.lo[r], args.hi[r] = i, lo, hi
    args.n_ranges, args.a_col, args.b_col = len(ranges), ai, bi
    args.n = cols[0].shape[0]
    out = torch.zeros((), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_lib()(args, n_act.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"filter_sum kernel launch failed: CUDA error "
                           f"{err}")
    filtered_sum_product.launches += 1
    return out


def filtered_sum_product(cols: List[torch.Tensor], ranges, ai: int, bi: int,
                         n_active) -> torch.Tensor:
    """sum over active rows passing all ranges of cols[ai] * cols[bi].

    cols: int32 tensors of one shared length on one device; rows at or
    past ``n_active`` (an int or a one-element tensor on that device) are
    excluded. ranges: (col_idx, lo, hi) inclusive int bounds. Returns a
    0-dim int64 tensor on the columns' device. CUDA tensors run the
    kernel (``launches`` counts its launches); CPU tensors run the plain
    version; any other device raises.
    """
    _check_args(cols, ranges, ai, bi)
    dev = cols[0].device
    if dev.type == "cuda":
        return _launch(cols, ranges, ai, bi, n_active)
    if dev.type == "cpu":
        return filtered_sum_product_reference(cols, ranges, ai, bi,
                                              n_active)
    raise ValueError(f"filtered_sum_product has no kernel for {dev}")


filtered_sum_product.launches = 0


# ---------------------------------------------------------------------------
# Plan matcher (the reference's, unchanged): recognize the Q6 shape in a
# fused scan chain + aggregation.
# ---------------------------------------------------------------------------

class FilterSumSpec:
    def __init__(self, scan_cols: List[str], ranges, a_col: str, b_col: str,
                 out_name: str, out_dtype: T.DataType):
        self.scan_cols = scan_cols      # kernel column order
        self.ranges = ranges            # (idx, lo, hi) into scan_cols
        self.a_col = a_col
        self.b_col = b_col
        self.out_name = out_name
        self.out_dtype = out_dtype


def _const_int(c: ex.TypedExpr, col_dtype: T.DataType) -> Optional[int]:
    """Constant -> storage-int at the COLUMN's scale, or None."""
    if not isinstance(c, ex.Constant) or c.value is None:
        return None
    dt = c.dtype
    if dt.kind is T.TypeKind.DATE:
        v = c.value
        if isinstance(v, str):
            v = int((np.datetime64(v) - np.datetime64("1970-01-01"))
                    .astype(int))
        return int(v)
    if dt.kind is T.TypeKind.DECIMAL:
        if col_dtype.kind is not T.TypeKind.DECIMAL:
            return None
        v = int(c.value)
        ds = col_dtype.scale - dt.scale
        if ds >= 0:
            return v * (10 ** ds)
        # constant finer than storage: only exact rescales are safe
        f = 10 ** (-ds)
        if v % f:
            return None
        return v // f
    if dt.is_integral:
        return int(c.value)
    return None


def _collect_ranges(pred: ex.TypedExpr, bounds: Dict[str, List[int]],
                    scan_names) -> bool:
    """Fold a conjunction of range predicates into per-column [lo, hi]
    (intersection). Returns False if any conjunct is not a range test."""
    if isinstance(pred, ex.Call) and pred.name == "and":
        return all(_collect_ranges(a, bounds, scan_names)
                   for a in pred.args)
    if not isinstance(pred, ex.Call):
        return False
    args = pred.args
    name = pred.name
    if name == "between" and len(args) == 3 \
            and isinstance(args[0], ex.FieldAccess):
        f = args[0]
        lo = _const_int(args[1], f.dtype)
        hi = _const_int(args[2], f.dtype)
        if lo is None or hi is None or f.name not in scan_names:
            return False
        b = bounds.setdefault(f.name, [-(2 ** 31), 2 ** 31 - 1])
        b[0] = max(b[0], lo)
        b[1] = min(b[1], hi)
        return True
    if name in ("lt", "lte", "gt", "gte") and len(args) == 2:
        f, c = args
        flip = False
        if isinstance(c, ex.FieldAccess) and isinstance(f, ex.Constant):
            f, c = c, f
            flip = True
        if not isinstance(f, ex.FieldAccess) or f.name not in scan_names:
            return False
        v = _const_int(c, f.dtype)
        if v is None:
            return False
        op = {("lt", False): "lt", ("lte", False): "lte",
              ("gt", False): "gt", ("gte", False): "gte",
              ("lt", True): "gt", ("lte", True): "gte",
              ("gt", True): "lt", ("gte", True): "lte"}[(name, flip)]
        b = bounds.setdefault(f.name, [-(2 ** 31), 2 ** 31 - 1])
        if op == "lt":
            b[1] = min(b[1], v - 1)
        elif op == "lte":
            b[1] = min(b[1], v)
        elif op == "gt":
            b[0] = max(b[0], v + 1)
        else:
            b[0] = max(b[0], v)
        return True
    return False


def match_filter_sum(node: "P.AggregationNode", chain,
                     stats: Optional[Dict[str, Tuple[int, int]]]
                     ) -> Optional[FilterSumSpec]:
    """Match a global single-step sum(a*b) over a fused range-filtered scan
    chain; returns a kernel spec or None. `stats` maps scan column ->
    (min, max) value bounds (connector-provided) used for limb safety."""
    if node.grouping_keys or node.step is not P.AggregationStep.SINGLE:
        return None
    if len(node.aggregates) != 1 or node.aggregates[0].name != "sum":
        return None
    agg = node.aggregates[0]
    if agg.mask is not None or len(agg.inputs) != 1:
        return None
    if not isinstance(chain.source, P.TableScanNode):
        return None
    scan_names = set(chain.source.output_type().names)
    # resolve the aggregate input through the chain's projections
    mapping = dict(zip(chain.names, chain.exprs))
    e = agg.inputs[0]
    if isinstance(e, ex.FieldAccess) and e.name in mapping:
        e = mapping[e.name]
    if not (isinstance(e, ex.Call) and e.name == "multiply"
            and len(e.args) == 2
            and all(isinstance(a, ex.FieldAccess) for a in e.args)
            and all(a.name in scan_names for a in e.args)):
        return None
    a_f, b_f = e.args
    # b must be |b|-bounded for limb-safe accumulation; allow either order
    if stats is None:
        return None

    def b_ok(f):
        s = stats.get(f.name)
        return s is not None and max(abs(s[0]), abs(s[1])) <= MAX_B_ABS

    if b_ok(b_f):
        pass
    elif b_ok(a_f):
        a_f, b_f = b_f, a_f
    else:
        return None
    bounds: Dict[str, List[int]] = {}
    if chain.predicate is not None:
        if not _collect_ranges(chain.predicate, bounds, scan_names):
            return None
    cols = sorted(set(list(bounds) + [a_f.name, b_f.name]))
    idx = {c: i for i, c in enumerate(cols)}
    ranges = tuple((idx[c], int(b[0]), int(b[1]))
                   for c, b in bounds.items())
    out_dtype = node.output_type().children[0]
    return FilterSumSpec(cols, ranges, a_f.name, b_f.name,
                         node.aggregate_names[0], out_dtype)


class FilterSumOperator(Operator):
    """Runs the fused kernel per scan batch and emits one row with the
    total. A batch whose storage defeats the kernel (nulls, non-int32
    columns) switches the operator to the generic aggregation that
    ``fallback_factory`` builds, as in the reference; that batch and every
    later one go there."""

    def __init__(self, node, spec: FilterSumSpec, device, fallback_factory):
        super().__init__(node)
        self.spec = spec
        self._device = torch.device(device)
        self._idx = {c: i for i, c in enumerate(spec.scan_cols)}
        self._fallback_factory = fallback_factory
        self._fallback = None
        self._total = None
        self._done = False

    @property
    def error_scalars(self):
        return self._fallback.error_scalars if self._fallback else []

    def _batch_ok(self, batch) -> bool:
        for c in self.spec.scan_cols:
            col = batch.columns.get(c)
            if col is None or col.validity is not None \
                    or col.data.dtype != torch.int32:
                return False
        return True

    def add_input(self, batch):
        if self._fallback is None and not self._batch_ok(batch):
            if self._total is not None:
                # the reference would drop the kernel's running total here
                raise NotImplementedError(
                    "filter-sum input whose storage changes after the "
                    "first batch")
            self._fallback = self._fallback_factory()
        if self._fallback is not None:
            self._fallback.add_input(batch)
            return
        cols = [batch.columns[c].data for c in self.spec.scan_cols]
        t = filtered_sum_product(
            cols, self.spec.ranges, self._idx[self.spec.a_col],
            self._idx[self.spec.b_col], batch.num_active())
        self._total = t if self._total is None else self._total + t

    def no_more_input(self):
        super().no_more_input()
        if self._fallback is not None:
            self._fallback.no_more_input()

    def get_output(self):
        if self._fallback is not None:
            return self._fallback.get_output()
        if self._done or not self._no_more_input:
            return None
        self._done = True
        total = (self._total if self._total is not None
                 else torch.zeros((), dtype=torch.int64,
                                  device=self._device))
        data = total.reshape(1)
        children = None
        if self.spec.out_dtype.is_long_decimal:
            # sum(decimal) declares DECIMAL(38, s): attach the int128 high
            # limb, the sign extension of the exact int64 total
            children = (DeviceColumn(data >> 63, None, T.BIGINT),)
        col = DeviceColumn(data, None, self.spec.out_dtype, None, children)
        return DeviceBatch({self.spec.out_name: col},
                           torch.ones((1,), dtype=torch.bool,
                                      device=data.device))

    def needs_input(self):
        return not self._no_more_input

    def is_finished(self):
        if self._fallback is not None:
            return self._fallback.is_finished()
        return self._done

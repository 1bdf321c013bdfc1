"""Fused scan-filter-sum(product): one pass over the scan batch.

Counterpart of ``velox_tpu/ops/filter_reduce.py``. The pattern: a global
``sum(a * b)`` over int32-stored columns under a conjunction of
per-column range predicates — TPC-H Q6 exactly. ``match_filter_sum``
recognizes it in a fused scan chain and ``FilterSumOperator`` runs
``filtered_sum_product`` once per scan batch, adding into one running
total on the device:

* on a CUDA tensor, the hand-written kernel in ``csrc/filter_sum.cu``
  (exact int64 accumulation, one atomic add per block; a template
  instance per ``kernel_layout``);
* on a CPU tensor, its plain PyTorch version
  ``filtered_sum_product_reference``.

The matcher is the reference's, unchanged, so both engines pick the
kernel on the same plans. That includes ``MAX_B_ABS``: the reference needs
the bound for its TPU int32 lane sums, and Hopper's int64 accumulation
does not; widening the matcher is a separate change with its own test.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.native.build import load_kernel, sm_count
from velox_tpu_torch.ops import count_launch
from velox_tpu_torch.ops.int128 import add128
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn

# The reference's |b| bound for its 1024-row int32 lane sums:
# 1024 * 65535 * |b| < 2^31.
MAX_B_ABS = (2 ** 31 - 1) // (1024 * 65536)

# the kernel's argument slots (csrc/filter_sum.cu kMaxCols, which also
# bounds its instance table); MAX_RANGES bounds the (col_idx, lo, hi)
# triples a call may pass, which the wrapper intersects per column before
# the kernel sees them
MAX_COLS = 8
MAX_RANGES = 8
_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1


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


class KernelLayout(NamedTuple):
    """How one call maps onto the kernel: ``order`` lists the distinct
    columns it reads (indices into the call's ``cols``), the ``n_ranges``
    range columns first, each with one int32 ``bounds`` pair, then the
    ``n_product`` product columns outside every range; ``a`` and ``b``
    index ``order``. ``instance`` names the kernel instance: the kernel
    has one for every layout of a call over at most ``MAX_COLS``
    columns."""
    n_ranges: int
    n_product: int
    order: Tuple[int, ...]
    bounds: Tuple[Tuple[int, int], ...]
    a: int
    b: int

    @property
    def instance(self) -> Tuple[int, int]:
        return self.n_ranges, self.n_product


def kernel_layout(ranges, ai: int, bi: int) -> KernelLayout:
    """The kernel layout of a call: ranges on one column intersected into
    one pair, clamped to int32 (a column holds int32 values, so the clamp
    keeps every row's outcome; an empty range becomes (1, 0))."""
    merged: Dict[int, List[int]] = {}
    for i, lo, hi in ranges:
        b = merged.setdefault(i, [_INT32_MIN, _INT32_MAX])
        b[0], b[1] = max(b[0], int(lo)), min(b[1], int(hi))
    range_cols = sorted(merged)
    product = sorted({ai, bi} - set(range_cols))
    order = tuple(range_cols + product)
    bounds = tuple((lo, hi) if lo <= hi else (1, 0)
                   for lo, hi in (merged[c] for c in range_cols))
    return KernelLayout(len(range_cols), len(product), order, bounds,
                        order.index(ai), order.index(bi))


class _FilterSumArgs(ctypes.Structure):
    """Mirror of ``FilterSumArgs`` in csrc/filter_sum.cu."""
    _fields_ = [
        ("cols", ctypes.c_void_p * MAX_COLS),
        ("lo", ctypes.c_int32 * MAX_COLS),
        ("hi", ctypes.c_int32 * MAX_COLS),
        ("n_ranges", ctypes.c_int32),
        ("n_product", ctypes.c_int32),
        ("a", ctypes.c_int32),
        ("b", ctypes.c_int32),
        ("n", ctypes.c_int64),
        ("sms", ctypes.c_int32),
        ("pad", ctypes.c_int32),
    ]


def _kernel_lib():
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


def _check_out(out: Optional[torch.Tensor], dev: torch.device) -> None:
    if out is not None and (out.dtype != torch.int64 or out.dim() != 0
                            or out.device != dev):
        raise ValueError("out must be a 0-dim int64 tensor on the columns' "
                         f"device; got {out.dtype} {tuple(out.shape)} on "
                         f"{out.device}")


@functools.lru_cache(maxsize=256)
def _call_template(ranges, ai: int, bi: int,
                   sms: int) -> Tuple[Tuple[int, ...], _FilterSumArgs]:
    """The layout's column order and the kernel's arguments without the
    column pointers and the row count: built once per (ranges, a, b, SM
    count), so a query's batches pay only for their pointers."""
    layout = kernel_layout(ranges, ai, bi)
    args = _FilterSumArgs()
    for r, (lo, hi) in enumerate(layout.bounds):
        args.lo[r], args.hi[r] = lo, hi
    args.n_ranges, args.n_product = layout.n_ranges, layout.n_product
    args.a, args.b = layout.a, layout.b
    args.sms = sms
    return layout.order, args


def _launch(cols: List[torch.Tensor], ranges, ai: int, bi: int,
            n_active, out: Optional[torch.Tensor]) -> torch.Tensor:
    dev = cols[0].device
    if isinstance(n_active, torch.Tensor):
        if n_active.device != dev or n_active.numel() != 1:
            raise ValueError("n_active must be one value on the columns' "
                             "device")
        n_act = n_active.reshape(()).to(torch.int32).contiguous()
    else:
        n_act = torch.tensor(int(n_active), dtype=torch.int32, device=dev)
    order, template = _call_template(tuple(map(tuple, ranges)), ai, bi,
                                     sm_count(dev))
    args = _FilterSumArgs.from_buffer_copy(template)
    ptrs = args.cols
    for slot, i in enumerate(order):
        ptrs[slot] = cols[i].data_ptr()
    args.n = cols[0].shape[0]
    if out is None:
        out = torch.zeros((), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _kernel_lib()(args, n_act.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"filter_sum kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(filtered_sum_product)
    return out


def filtered_sum_product(cols: List[torch.Tensor], ranges, ai: int, bi: int,
                         n_active, out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """sum over active rows passing all ranges of cols[ai] * cols[bi].

    cols: int32 tensors of one shared length on one device; rows at or
    past ``n_active`` (an int or a one-element tensor on that device) are
    excluded. ranges: (col_idx, lo, hi) inclusive int bounds. Returns a
    0-dim int64 tensor on the columns' device: a new one, or ``out`` (a
    0-dim int64 tensor there) with the sum added to it in place, so a
    caller carries a running total across calls without a launch of its
    own. CUDA tensors run the kernel (``launches`` counts its launches);
    CPU tensors run the plain version; any other device raises.
    """
    _check_args(cols, ranges, ai, bi)
    dev = cols[0].device
    _check_out(out, dev)
    if dev.type == "cuda":
        return _launch(cols, ranges, ai, bi, n_active, out)
    if dev.type == "cpu":
        s = filtered_sum_product_reference(cols, ranges, ai, bi, n_active)
        return s if out is None else out.add_(s)
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
    """Runs the fused kernel per scan batch, adding into one device int64
    total that it zeroes once per query, and emits one row with the total.
    A batch whose storage defeats the kernel (nulls, non-int32 columns)
    switches the operator to the generic aggregation that
    ``fallback_factory`` builds, as in the reference; that batch and every
    later one go there, and the kernel's total of the earlier batches is
    added to the generic aggregation's result."""

    def __init__(self, node, spec: FilterSumSpec, device, fallback_factory):
        super().__init__(node)
        self.spec = spec
        self._device = torch.device(device)
        self._idx = {c: i for i, c in enumerate(spec.scan_cols)}
        self._fallback_factory = fallback_factory
        self._fallback = None
        self._total = None  # the kernel's running total, once it ran
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
            self._fallback = self._fallback_factory()
        if self._fallback is not None:
            self._fallback.add_input(batch)
            return
        if self._total is None:
            self._total = torch.zeros((), dtype=torch.int64,
                                      device=self._device)
        cols = [batch.columns[c].data for c in self.spec.scan_cols]
        filtered_sum_product(
            cols, self.spec.ranges, self._idx[self.spec.a_col],
            self._idx[self.spec.b_col], batch.num_active(), out=self._total)

    def no_more_input(self):
        super().no_more_input()
        if self._fallback is not None:
            self._fallback.no_more_input()

    def _with_kernel_total(self, out: DeviceBatch) -> DeviceBatch:
        """The generic aggregation's one-row result plus the kernel's total
        of the batches before the fallback. The kernel's sum is never NULL,
        so neither is the combined one."""
        name = self.spec.out_name
        col = out.columns[name]
        total = self._total.reshape(1)
        if col.dtype.is_long_decimal:
            lo, hi = add128(col.data, col.children[0].data, total,
                            total >> 63)
            col = DeviceColumn(lo, None, col.dtype, None,
                               (DeviceColumn(hi, None, T.BIGINT),))
        else:
            col = DeviceColumn(col.data + total, None, col.dtype)
        return DeviceBatch(dict(out.columns, **{name: col}), out.mask)

    def get_output(self):
        if self._fallback is not None:
            out = self._fallback.get_output()
            if out is None or self._total is None:
                return out
            return self._with_kernel_total(out)
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

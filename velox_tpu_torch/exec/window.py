"""Window, RowNumber and TopNRowNumber operators.

Counterpart of ``velox_tpu/exec/window.py`` (velox/exec/Window.h:38 with
the SortWindowBuild, WindowFunction.h:34, the frames of
core/PlanNode.h:2139-2165, AggregateWindow.h, RowNumber.h:24 and
TopNRowNumber.h:37).

The buffered input is radix-sorted once by (partition keys, order keys)
(exec/sort.py, whose passes run kernels B4 and B3 or B2), the sorted copy
comes through B5 (exec/batch_utils.py ``take_columns_rows``), and every
function is computed in closed form over the sorted batch:

* partition and peer runs -> run starts and ends by a scatter of each
  run's first index to its run id and a gather back (``_runs``), in
  place of the reference's cummax/cummin scans, which take most of a
  merge-rank join's device time on an H100;
* row_number/rank/dense_rank/ntile/percent_rank/cume_dist -> index
  arithmetic on positions within partitions;
* lead/lag/first/last/nth_value -> bounds-clamped gathers (B5);
* sum/count/avg over frames -> differences of prefix sums;
* min/max over frames -> a sparse table of floor(log2 n) + 1 levels,
  built level by level into one flat array and read by flat index
  ``k * n + i`` (B5); ``k`` is an exact integer bit length, where the
  reference's float32 log2 rounds lengths above 2^24;
* RANGE k bounds -> ``torch.searchsorted`` over an int64 (partition,
  order key) composite.

RowNumber streams: a partition's running count lives in a per-slot array
of the growing hash table (exec/hashtable.py), and the in-batch rank comes
from a radix sort of the rows' slot ids. TopNRowNumber buffers, sorts
once and keeps each partition's first rows.
"""

from __future__ import annotations

import enum
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.core.stats import resolve_column_stats
from velox_tpu_torch.exec import hashtable as H
from velox_tpu_torch.exec.batch_utils import concat_batches, take_columns_rows
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.exec.sort import radix_sort_perm, sort_words
from velox_tpu_torch.expression.eval import EvalValue, value_from_column
from velox_tpu_torch.ops.gather import take_rows
from velox_tpu_torch.ops.int128 import from_i64
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn
from velox_tpu_torch.vector.strings import reject_raw


class BoundType(enum.Enum):
    # Parity: core/PlanNode.h:2147-2158.
    UNBOUNDED_PRECEDING = "unbounded_preceding"
    PRECEDING = "preceding"
    CURRENT_ROW = "current_row"
    FOLLOWING = "following"
    UNBOUNDED_FOLLOWING = "unbounded_following"


class FrameType(enum.Enum):
    ROWS = "rows"
    RANGE = "range"


@dataclass(frozen=True)
class WindowFrame:
    """k-bound values are int constants OR str column names (per-row
    offsets; null or negative offsets raise VeloxUserError)."""
    frame_type: FrameType = FrameType.RANGE
    start_type: BoundType = BoundType.UNBOUNDED_PRECEDING
    start_value: object = 0
    end_type: BoundType = BoundType.CURRENT_ROW
    end_value: object = 0


DEFAULT_FRAME = WindowFrame()


@dataclass(frozen=True)
class WindowFunctionCall:
    name: str                      # row_number, rank, sum, lead, ...
    inputs: Tuple = ()             # FieldAccess args
    result_type: T.DataType = T.BIGINT
    frame: WindowFrame = DEFAULT_FRAME
    ignore_nulls: bool = False


_RANKING = {"row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
            "ntile"}
_OFFSET = {"lead", "lag"}
_VALUE = {"first_value", "last_value", "nth_value"}
_AGG = {"sum", "count", "avg", "min", "max"}

_I64_MAX = torch.iinfo(torch.int64).max
_I64_MIN = torch.iinfo(torch.int64).min

# bits of the window's error flags, read once at get_output
_FLAG_RANGE_OVERFLOW = 1
_FLAG_BAD_OFFSET = 2


def _runs(flag: torch.Tensor):
    """(start, end) index of each row's run, where ``flag`` marks run
    starts (row 0 always starts one): each run's first index is scattered
    to its run id (``cumsum(flag) - 1``) and gathered back; a run ends
    one row before the next run starts, the last run at the last row."""
    n = flag.shape[0]
    dev = flag.device
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    flag = flag | (iota == 0)
    rid = torch.cumsum(flag.to(torch.int64), 0) - 1
    starts = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    starts[torch.where(flag, rid, n)] = iota
    start = take_rows(starts, rid)
    ends = torch.where(iota == rid[-1], n - 1, starts[1:] - 1)
    return start, take_rows(ends, rid)


def _changes(s: DeviceBatch, keys) -> torch.Tensor:
    """True where a row's key tuple differs from the previous row's (row
    0 compares with itself). Every row-aligned array of a key counts:
    data, validity and a long decimal's high limb."""
    out = torch.zeros((s.capacity,), dtype=torch.bool, device=s.device)
    for k in keys:
        col = s.columns[k.name]
        arrays = [col.data] + [ch.data for ch in col.children]
        if col.validity is not None:
            arrays.append(col.validity)
        for a in arrays:
            out = out | (a != torch.cat([a[:1], a[:-1]]))
    return out


def _sorted_by(batch: DeviceBatch, node, pkeys, okeys, orders
               ) -> DeviceBatch:
    """The batch stably sorted by (partition keys, order keys), inactive
    rows last, every column through B5. Plan-level stats narrow the sort
    words (an order-preserving narrowing: the same permutation)."""
    keys = list(pkeys) + list(okeys)
    orders = [P.SortOrder.ASC_NULLS_LAST] * len(pkeys) + list(orders)
    if not keys:
        return batch
    cap = batch.capacity
    vals = [value_from_column(batch.columns[k.name]) for k in keys]
    ranges = tuple(resolve_column_stats(node.source, k.name) for k in keys)
    words, bits = sort_words(vals, orders, cap, batch.mask, ranges=ranges)
    perm = radix_sort_perm(words, bits, cap)
    return DeviceBatch(take_columns_rows(batch.columns, perm),
                       batch.mask[perm])


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of int64 x >= 1, exactly: its bit length - 1."""
    k = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = (x >> s) > 0
        x = torch.where(big, x >> s, x)
        k = k + big.to(torch.int64) * s
    return k


class _SparseTable:
    """Range min/max over arbitrary per-row bounds in two gathers: level
    k holds op over [i, i + 2^k), all levels in one flat array."""

    def __init__(self, data: torch.Tensor, op):
        n = data.shape[0]
        self.levels = n.bit_length()  # floor(log2 n) + 1
        flat = torch.empty((self.levels * n,), dtype=data.dtype,
                           device=data.device)
        flat[:n] = data
        size = 1
        for k in range(1, self.levels):
            prev = flat[(k - 1) * n:k * n]
            cur = flat[k * n:(k + 1) * n]
            op(prev[:n - size], prev[size:], out=cur[:n - size])
            cur[n - size:] = prev[n - size:]
            size *= 2
        self.flat, self.op, self.n = flat, op, n

    def query(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """op over [lo, hi] inclusive; requires lo <= hi."""
        n = self.n
        k = torch.clamp(_floor_log2(torch.clamp(hi - lo + 1, min=1)),
                        0, self.levels - 1)
        left = take_rows(self.flat, k * n + torch.clamp(lo, 0, n - 1))
        right_pos = hi - (torch.ones_like(k) << k) + 1
        right = take_rows(self.flat,
                          k * n + torch.clamp(right_pos, 0, n - 1))
        return self.op(left, right)


def _prefix_at(prefix: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """prefix[i], 0 where i < 0 (an inclusive prefix before row 0)."""
    got = take_rows(prefix, torch.clamp(i, 0, prefix.shape[0] - 1))
    return torch.where(i >= 0, got, torch.zeros_like(got))


def _range_sum(prefix: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Inclusive-range sum from an inclusive prefix array."""
    return _prefix_at(prefix, hi) - _prefix_at(prefix, lo - 1)


def _gather_value(v: EvalValue, src: torch.Tensor, cap: int):
    """(data, validity or None, children) of ``v`` at rows ``src``."""
    col = take_columns_rows({"v": v.to_column(cap)}, src)["v"]
    return col.data, col.validity, col.children


def _long(data: torch.Tensor, rt: T.DataType):
    """A long decimal result's high limb: the int64 sign extension."""
    if not rt.is_long_decimal:
        return ()
    return (DeviceColumn(from_i64(data)[1], None, T.BIGINT),)


class WindowOperator(Operator):
    """Sort-based window build (parity: exec/SortWindowBuild.h)."""

    def __init__(self, node: P.WindowNode):
        super().__init__(node)
        self._node = node
        self._batches: List[DeviceBatch] = []
        self._out: Optional[DeviceBatch] = None
        self._flags: List[torch.Tensor] = []

    def add_input(self, batch: DeviceBatch):
        self._batches.append(batch)

    def no_more_input(self):
        super().no_more_input()
        if self._batches:
            merged = concat_batches(self._batches)
            self._batches = []
            node = self._node
            reject_raw([merged.columns[k.name] for k in
                        tuple(node.partition_keys) + tuple(node.sort_keys)],
                       "Window")
            self._out = self._compute(merged)

    def get_output(self):
        out, self._out = self._out, None
        if out is not None and self._flags:
            # one host read, where the output is about to be read anyway
            f = int(functools.reduce(torch.bitwise_or, self._flags))
            self._flags = []
            if f & _FLAG_BAD_OFFSET:
                from velox_tpu_torch.common.errors import VeloxUserError
                raise VeloxUserError(
                    "window frame offset is null or negative")
            if f & _FLAG_RANGE_OVERFLOW:
                from velox_tpu_torch.common.errors import VeloxRuntimeError
                raise VeloxRuntimeError(
                    "RANGE k-PRECEDING/FOLLOWING: partition count x "
                    "ORDER BY key span overflows the int64 composite; "
                    "narrow the key range or reduce partitions")
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None

    # ---- the sorted batch ----------------------------------------------------

    def _compute(self, batch: DeviceBatch) -> DeviceBatch:
        node = self._node
        s = _sorted_by(batch, node, node.partition_keys, node.sort_keys,
                       node.sort_orders)
        cap = s.capacity
        mask = s.mask
        iota = torch.arange(cap, dtype=torch.int64, device=s.device)
        last = torch.clamp(mask.sum(dtype=torch.int64) - 1, min=0)
        new_part = (_changes(s, node.partition_keys) | (iota == 0)) & mask
        new_peer = (new_part | _changes(s, node.sort_keys)) & mask
        pid = torch.cumsum(new_part.to(torch.int64), 0) - 1
        pstart, pend = _runs(new_part)
        pend = torch.minimum(pend, last)
        peer_start, peer_end = _runs(new_peer)
        peer_end = torch.minimum(peer_end, last)
        rows = _Rows(s, cap, mask, iota, pstart, pend, peer_start, peer_end,
                     new_peer, pid)
        out_cols: Dict[str, DeviceColumn] = dict(s.columns)
        for out_name, call in zip(node.output_names, node.functions):
            out_cols[out_name] = self._one_function(call, rows)
        return DeviceBatch(out_cols, mask)

    # ---- individual functions ------------------------------------------------

    def _one_function(self, call: WindowFunctionCall, r: "_Rows"
                      ) -> DeviceColumn:
        name = call.name
        cap, iota = r.cap, r.iota
        pos = iota - r.pstart           # 0-based position in the partition
        psize = r.pend - r.pstart + 1
        if name == "row_number":
            return DeviceColumn(pos + 1, None, T.BIGINT)
        if name == "rank":
            return DeviceColumn(r.peer_start - r.pstart + 1, None, T.BIGINT)
        if name == "dense_rank":
            c = torch.cumsum(r.new_peer.to(torch.int64), 0)
            return DeviceColumn(c - _prefix_at(c, r.pstart - 1), None,
                                T.BIGINT)
        if name == "percent_rank":
            rk = (r.peer_start - r.pstart).to(torch.float64)
            denom = torch.clamp(psize - 1, min=1).to(torch.float64)
            out = torch.where(psize == 1, 0.0, rk / denom)
            return DeviceColumn(out, None, T.DOUBLE)
        if name == "cume_dist":
            out = (r.peer_end - r.pstart + 1).to(torch.float64) \
                / psize.to(torch.float64)
            return DeviceColumn(out, None, T.DOUBLE)
        if name == "ntile":
            n = max(self._const_arg(call, 0), 1)
            small = psize // n          # base bucket size
            rem = psize % n
            cut = rem * (small + 1)     # the first `rem` buckets are larger
            bucket = torch.where(
                pos < cut, pos // torch.clamp(small + 1, min=1),
                rem + (pos - cut) // torch.clamp(small, min=1))
            return DeviceColumn(bucket + 1, None, T.BIGINT)
        if name in _OFFSET:
            v = value_from_column(r.s.columns[call.inputs[0].name])
            off = self._const_arg(call, 1, default=1)
            src = iota + (off if name == "lead" else -off)
            in_part = (src >= r.pstart) & (src <= r.pend) & r.mask
            data, validity, children = _gather_value(
                v, torch.clamp(src, 0, cap - 1), cap)
            validity = in_part if validity is None else in_part & validity
            if len(call.inputs) > 2:
                dflt = value_from_column(r.s.columns[call.inputs[2].name])
                data = torch.where(in_part, data, dflt.full_data(cap))
                validity = torch.where(in_part, validity,
                                       dflt.full_validity(cap))
                if children:
                    children = (DeviceColumn(torch.where(
                        in_part, children[0].data, dflt.full_hi(cap)),
                        None, T.BIGINT),)
            return DeviceColumn(data, validity, v.dtype, v.dictionary,
                                children)

        # frame-based functions
        lo, hi = self._frame_bounds(call.frame, r)
        empty = lo > hi
        lo_c = torch.clamp(lo, 0, cap - 1)
        hi_c = torch.clamp(hi, 0, cap - 1)
        if name in _VALUE:
            v = value_from_column(r.s.columns[call.inputs[0].name])
            if name == "first_value":
                src = lo_c
            elif name == "last_value":
                src = hi_c
            else:  # nth_value(x, n): 1-based within the frame
                src = lo_c + (self._const_arg(call, 1) - 1)
                empty = empty | (src > hi_c)
                src = torch.clamp(src, 0, cap - 1)
            data, validity, children = _gather_value(v, src, cap)
            valid = ~empty & r.mask
            validity = valid if validity is None else valid & validity
            return DeviceColumn(data, validity, v.dtype, v.dictionary,
                                children)
        if name in _AGG:
            return self._frame_aggregate(call, r, lo_c, hi_c, empty)
        raise NotImplementedError(f"window function {name}")

    @staticmethod
    def _const_arg(call, i, default=None) -> int:
        from velox_tpu_torch.core import expressions as ex
        if len(call.inputs) <= i:
            if default is None:
                raise ValueError(f"{call.name} missing argument {i}")
            return default
        arg = call.inputs[i]
        if isinstance(arg, ex.Constant):
            return int(arg.value)
        raise NotImplementedError(
            f"{call.name}: non-constant argument {i} not supported")

    def _range_k_comp(self, r: "_Rows"):
        """(comp, span): a per-row monotone composite pid * span' +
        biased(order key), so one searchsorted over the sorted batch finds
        a RANGE k bound (keys ascend within partitions; DESC negates)."""
        node = self._node
        if len(node.sort_keys) != 1:
            # as velox: checkKRangeFrameBounds, exec/Window.cpp:94-105
            raise NotImplementedError(
                "RANGE k frames require exactly one ORDER BY key")
        v = value_from_column(r.s.columns[node.sort_keys[0].name])
        if not (v.dtype.is_integral or v.dtype.kind in (
                T.TypeKind.DATE, T.TypeKind.DECIMAL)):
            raise NotImplementedError(
                "RANGE k frames need an integral/date/decimal key")
        key = v.full_data(r.cap).to(torch.int64)
        if not node.sort_orders[0].ascending:
            key = -key
        kmin = torch.where(r.mask, key, _I64_MAX).min()
        kmax = torch.where(r.mask, key, _I64_MIN).max()
        span = kmax - kmin + 1
        # pid_max * (span + 2^33) must stay inside int64, or the bounds
        # would wrap silently: a flag, raised at get_output
        pid_max = torch.where(r.mask, r.pid, 0).max()
        safe = pid_max <= (1 << 62) // (span + 2 * (1 << 32))
        self._flags.append(torch.where(safe, 0, _FLAG_RANGE_OVERFLOW))
        comp = r.pid * (span + 2 * (1 << 32)) + (key - kmin) + (1 << 32)
        # padding rows sort last: +inf keeps the array monotone
        comp = torch.where(r.mask, comp, _I64_MAX)
        return comp, 2 * (1 << 32) + span

    def _frame_k(self, value, r: "_Rows"):
        """A frame offset: a python int (constant) or a per-row int64
        tensor (a column of the sorted batch). Null or negative per-row
        offsets set a flag, raised at get_output."""
        if not isinstance(value, str):
            return int(value)
        v = value_from_column(r.s.columns[value])
        k = v.full_data(r.cap).to(torch.int64)
        bad = k < 0
        if v.validity is not None:
            vv = v.full_validity(r.cap)
            bad = bad | ~vv
            k = torch.where(vv, k, 0)
        self._flags.append(torch.where((bad & r.mask).any(),
                                       _FLAG_BAD_OFFSET, 0))
        return torch.clamp(k, min=0)

    def _frame_bounds(self, frame: WindowFrame, r: "_Rows"):
        """Per-row inclusive frame [lo, hi] as sorted-batch indices."""
        if frame.frame_type is FrameType.ROWS:
            def bound(btype, value, is_start):
                if btype is BoundType.UNBOUNDED_PRECEDING:
                    return r.pstart
                if btype is BoundType.UNBOUNDED_FOLLOWING:
                    return r.pend
                if btype is BoundType.CURRENT_ROW:
                    return r.iota
                k = self._frame_k(value, r)
                return r.iota - k if btype is BoundType.PRECEDING \
                    else r.iota + k
        else:  # RANGE: peers collapse; k bounds need the order key
            def bound(btype, value, is_start):
                if btype is BoundType.UNBOUNDED_PRECEDING:
                    return r.pstart
                if btype is BoundType.UNBOUNDED_FOLLOWING:
                    return r.pend
                if btype is BoundType.CURRENT_ROW:
                    return r.peer_start if is_start else r.peer_end
                # k PRECEDING / FOLLOWING on the order key's value: one
                # searchsorted over the (partition, key) composite. DESC
                # needs nothing more: the composite negates the key. An
                # offset beyond the partition's span lands outside it
                # either way, so it is clamped to the span, which keeps
                # the composite from overflowing.
                comp, pspan = self._range_k_comp(r)
                k = self._frame_k(value, r)
                delta = -k if btype is BoundType.PRECEDING else k
                delta = torch.minimum(torch.maximum(
                    torch.as_tensor(delta, device=r.s.device), -pspan),
                    pspan)
                target = (comp + delta).expand(r.cap).contiguous()
                if is_start:
                    return torch.searchsorted(comp, target)
                return torch.searchsorted(comp, target, right=True) - 1
        lo = bound(frame.start_type, frame.start_value, True)
        hi = bound(frame.end_type, frame.end_value, False)
        return torch.maximum(lo, r.pstart), torch.minimum(hi, r.pend)

    def _frame_aggregate(self, call, r: "_Rows", lo, hi, empty
                         ) -> DeviceColumn:
        from velox_tpu_torch.functions.aggregates import (
            MinMaxAgg, masked, resolve_aggregate,
        )
        name, cap = call.name, r.cap
        if name == "count" and not call.inputs:
            return DeviceColumn(torch.where(empty, 0, hi - lo + 1), None,
                                T.BIGINT)
        v = value_from_column(r.s.columns[call.inputs[0].name])
        data = v.full_data(cap)
        valid = r.mask if v.validity is None \
            else r.mask & v.full_validity(cap)
        cnt = _range_sum(torch.cumsum(valid.to(torch.int64), 0), lo, hi)
        if name == "count":
            return DeviceColumn(torch.where(empty, 0, cnt), None, T.BIGINT)
        has = ~empty & (cnt > 0) & r.mask
        if name in ("sum", "avg"):
            agg = resolve_aggregate(name, [v.dtype])
            rt = agg.result_type
            # decimal frames accumulate in int64 (frame sums are range
            # differences of one batch's prefix sum); a DECIMAL(38, s)
            # result gets the sign extension as its high limb
            acc = (torch.int64 if v.dtype.kind is T.TypeKind.DECIMAL
                   else agg.states[0].dtype.torch_dtype())
            contrib = torch.where(valid, data, 0).to(acc)
            ssum = _range_sum(torch.cumsum(contrib, 0), lo, hi)
            if name == "sum":
                return DeviceColumn(ssum, has, rt, v.dictionary,
                                    _long(ssum, rt))
            if rt.kind is T.TypeKind.DECIMAL:
                c = torch.clamp(cnt, min=1)
                half = c // 2
                q = torch.where(ssum >= 0, (ssum + half) // c,
                                -((-ssum + half) // c))
                return DeviceColumn(q, has, rt, None, _long(q, rt))
            return DeviceColumn(ssum / torch.clamp(cnt, min=1), has,
                                T.DOUBLE)
        # min / max through the sparse table
        st = MinMaxAgg(name, v.dtype).states[0]
        data = masked(data.to(st.dtype.torch_dtype()), valid,
                      st.identity())
        op = torch.minimum if name == "min" else torch.maximum
        res = _SparseTable(data, op).query(lo, hi)
        return DeviceColumn(res, has, v.dtype, v.dictionary)


@dataclass
class _Rows:
    """The sorted batch and its per-row partition and peer indices."""
    s: DeviceBatch
    cap: int
    mask: torch.Tensor
    iota: torch.Tensor
    pstart: torch.Tensor
    pend: torch.Tensor
    peer_start: torch.Tensor
    peer_end: torch.Tensor
    new_peer: torch.Tensor
    pid: torch.Tensor


class RowNumberOperator(Operator):
    """Streaming row_number per partition-key group (hash-based, no
    sort of the input): a per-slot running count carried across batches
    in the growing hash table."""

    def __init__(self, node: P.RowNumberNode):
        super().__init__(node)
        self._node = node
        self._out: Optional[DeviceBatch] = None
        self._table = H.StreamTable(n_states=1)  # running counts
        # no partition keys: one running count of the rows seen, on the
        # device
        self._seen: Optional[torch.Tensor] = None

    def _numbers_without_keys(self, batch: DeviceBatch) -> torch.Tensor:
        if self._seen is None:
            self._seen = torch.zeros((), dtype=torch.int64,
                                     device=batch.device)
        prefix = torch.cumsum(batch.mask.to(torch.int64), 0)
        rn = self._seen + prefix
        self._seen = self._seen + prefix[-1]
        return rn

    def add_input(self, batch: DeviceBatch):
        node = self._node
        cap = batch.capacity
        if not node.partition_keys:
            self._emit(batch, self._numbers_without_keys(batch))
            return
        keys = [value_from_column(batch.columns[k.name])
                for k in node.partition_keys]
        reject_raw(keys, "RowNumber")
        slots, _ = self._table.insert(keys, batch.mask, cap)
        (counts,) = self._table.states
        S = counts.shape[0]
        seg = torch.where(batch.mask, slots, S)
        # each row's rank within its group in this batch: a stable radix
        # sort by slot, then the position within the run of equal slots
        order = radix_sort_perm([seg], [max(1, S.bit_length())], cap)
        s_sorted = take_rows(seg, order)
        newg = torch.cat([torch.ones((1,), dtype=torch.bool,
                                     device=seg.device),
                          s_sorted[1:] != s_sorted[:-1]])
        gstart, gend = _runs(newg)
        rank = torch.empty((cap,), dtype=torch.int64, device=seg.device)
        rank[order] = torch.arange(cap, device=seg.device) - gstart
        rn = take_rows(counts, torch.clamp(slots, 0, S - 1)) + rank + 1
        # each group's rows in this batch, added at its run's first row
        # (one write a slot: no atomics on a popular key's slot)
        first = (newg & (s_sorted < S)).nonzero().squeeze(1)
        hit = take_rows(s_sorted, first)
        counts[hit] += take_rows(gend - gstart + 1, first)
        self._emit(batch, rn)

    def _emit(self, batch: DeviceBatch, rn: torch.Tensor):
        node = self._node
        mask = batch.mask
        if node.limit is not None:
            mask = mask & (rn <= node.limit)
        cols = dict(batch.columns)
        if node.row_number_column:
            cols[node.row_number_column] = DeviceColumn(rn, None, T.BIGINT)
        self._out = DeviceBatch(cols, mask)

    def get_output(self):
        out, self._out = self._out, None
        return out

    def needs_input(self):
        return not self._no_more_input and self._out is None

    def is_finished(self):
        return self._no_more_input and self._out is None


class TopNRowNumberOperator(Operator):
    """Buffered per-partition top-k: one sort by (partition keys, sort
    keys), then each partition's first ``limit`` rows."""

    def __init__(self, node: P.TopNRowNumberNode):
        super().__init__(node)
        self._node = node
        self._batches: List[DeviceBatch] = []
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch: DeviceBatch):
        self._batches.append(batch)

    def no_more_input(self):
        super().no_more_input()
        if not self._batches:
            return
        node = self._node
        merged = concat_batches(self._batches)
        # the reference sorts by a raw sort key but not a raw partition
        reject_raw([merged.columns[k.name] for k in node.partition_keys],
                   "TopNRowNumber partition")
        s = _sorted_by(merged, node, node.partition_keys, node.sort_keys,
                       node.sort_orders)
        self._batches = []
        iota = torch.arange(s.capacity, dtype=torch.int64, device=s.device)
        pstart, _ = _runs(_changes(s, node.partition_keys) & s.mask)
        rn = iota - pstart + 1
        cols = dict(s.columns)
        if node.row_number_column:
            cols[node.row_number_column] = DeviceColumn(rn, None, T.BIGINT)
        self._out = DeviceBatch(cols, s.mask & (rn <= node.limit))

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None

"""Aggregate functions: columnar state vectors with segment-combine ops.

Counterpart of ``velox_tpu/functions/aggregates.py`` (velox/exec/
Aggregate.h:43 + the Presto aggregate library). An aggregate is a list of
*states*, each with a combine op (sum/min/max); the execution layer
computes per-row addends once per batch and reduces them into dense
per-group state (exec/groupby.py). Velox's companion split maps onto:

  map_raw()    -> per-row addends from raw inputs    (addRawInput)
  states       -> the intermediate layout            (accumulator)
  combine ops  -> merging intermediates              (addIntermediateResults)
  extract()    -> final result from state columns    (extractValues)

Every aggregate name of the reference with a scalar result is ported:
sum, count, avg, min, max, count_if, bool_and/every/bool_or,
arbitrary/any_value, the six variance and stddev names, skewness,
kurtosis, min_by/max_by (the 32-bit pair packing, and the collect
pathway for wider arguments), first/first_value/last/last_value,
approx_distinct (HyperLogLog registers: a vector state of 512 int32 a
group), and the collect kinds (rows retained, sorted by (group, value);
exec/aggregation.py): mode, approx_percentile and the eight with an
ARRAY or MAP result, array_agg, set_agg, map_agg, multimap_agg,
map_union, histogram, approx_most_frequent and bloom_filter_agg.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue


@dataclass(frozen=True)
class StateSpec:
    suffix: str           # physical column suffix, e.g. "sum", "count"
    dtype: T.DataType     # device dtype of the state column
    combine: str          # 'sum' | 'min' | 'max'
    width: int = 1        # >1: a per-group state vector (HLL registers)

    def identity(self):
        """Identity element for masked-out rows (a numpy scalar of the
        state's dtype)."""
        np_dt = self.dtype.np_dtype()
        if self.combine == "sum":
            return np.zeros((), np_dt)
        if self.combine == "min":
            return (np.array(np.inf, np_dt) if self.dtype.is_floating
                    else np.iinfo(np_dt).max)
        if self.combine == "max":
            return (np.array(-np.inf, np_dt) if self.dtype.is_floating
                    else np.iinfo(np_dt).min)
        raise ValueError(self.combine)


class AggregateFunction:
    """One resolved aggregate (name + input types)."""

    name: str
    states: Tuple[StateSpec, ...]
    result_type: T.DataType

    @property
    def intermediate_type(self) -> T.DataType:
        if len(self.states) == 1:
            return self.states[0].dtype
        return T.row([s.suffix for s in self.states],
                     [s.dtype for s in self.states])

    def map_raw(self, ctx, args: List[EvalValue], active) -> List:
        """Per-row addend tensors (one per state) from raw inputs; rows
        where `active` is False (or the input is null) contribute the
        identity."""
        raise NotImplementedError

    def extract(self, state_arrays: List, group_valid) -> EvalValue:
        """Final result from dense per-group state columns."""
        raise NotImplementedError


def masked(data: torch.Tensor, keep: torch.Tensor, identity) -> torch.Tensor:
    """where(keep, data, identity), in data's dtype."""
    return torch.where(keep, data, np.asarray(identity).item())


def _valid_and_active(v: EvalValue, active, capacity):
    keep = active
    if v.validity is not None:
        keep = keep & v.full_validity(capacity)
    return keep


def _two_parts(data: torch.Tensor, keep: torch.Tensor) -> List:
    """Short-decimal planar parts: v & M32 (>= 0) and the signed v >> 32,
    plus the row count."""
    lo = data.to(torch.int64)
    return [masked(lo & 0xFFFFFFFF, keep, 0), masked(lo >> 32, keep, 0),
            keep.to(torch.int64)]


def _four_parts(v: EvalValue, data: torch.Tensor, keep: torch.Tensor):
    """Long-decimal planar 32-bit parts of (lo, hi), plus the row count."""
    from velox_tpu_torch.ops.int128 import split_parts
    lo = data.to(torch.int64)
    if v.dtype.is_long_decimal and v.children:
        hi = v.children[0].data
        if hi.dim() == 0:
            hi = hi.expand(lo.shape)
    else:
        hi = lo >> 63  # short decimal: sign extension
    parts = split_parts(lo, hi)
    return [masked(p, keep, 0) for p in parts] + [keep.to(torch.int64)]


def _long_value(lo, hi, valid, result_type) -> EvalValue:
    from velox_tpu_torch.vector.device import DeviceColumn
    hi_col = DeviceColumn(hi, None, T.BIGINT)
    return EvalValue(lo, valid, result_type, children=(hi_col,))


class SumAgg(AggregateFunction):
    def __init__(self, input_type: T.DataType):
        self.name = "sum"
        # every decimal sum returns DECIMAL(38, s) over int128 states
        # (Presto: sum(decimal) -> decimal(38, s))
        self._long = input_type.kind is T.TypeKind.DECIMAL
        self._two_part = self._long and not input_type.is_long_decimal
        self.input_type = input_type
        if self._two_part:
            # short-decimal input: two planar parts recombined to int128
            # at extraction (ops/int128.py combine_two_parts)
            self.result_type = T.decimal(38, input_type.scale)
            self.states = (StateSpec("slo", T.BIGINT, "sum"),
                           StateSpec("shi", T.BIGINT, "sum"),
                           StateSpec("count", T.BIGINT, "sum"))
            return
        if self._long:
            # long decimal: four planar 32-bit limb parts
            self.result_type = T.decimal(38, input_type.scale)
            self.states = tuple(
                StateSpec(f"p{i}", T.BIGINT, "sum") for i in range(4)
            ) + (StateSpec("count", T.BIGINT, "sum"),)
            return
        st = T.BIGINT if input_type.is_integral else T.DOUBLE
        self.result_type = st
        self.states = (StateSpec("sum", st, "sum"),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        data = v.full_data(ctx.capacity)
        if self._two_part:
            return _two_parts(data, keep)
        if self._long:
            return _four_parts(v, data, keep)
        # widen to the state dtype
        data = data.to(self.result_type.torch_dtype())
        return [masked(data, keep, 0), keep.to(torch.int64)]

    def extract(self, state_arrays, group_valid):
        if self._two_part:
            from velox_tpu_torch.ops.int128 import combine_two_parts
            s_lo, s_hi, c = state_arrays
            lo, hi = combine_two_parts(s_lo, s_hi)
            return _long_value(lo, hi, group_valid & (c > 0),
                               self.result_type)
        if self._long:
            from velox_tpu_torch.ops.int128 import combine_parts
            p0, p1, p2, p3, c = state_arrays
            lo, hi = combine_parts(p0, p1, p2, p3)
            return _long_value(lo, hi, group_valid & (c > 0),
                               self.result_type)
        s, c = state_arrays
        return EvalValue(s, group_valid & (c > 0), self.result_type)


class CountAgg(AggregateFunction):
    def __init__(self, input_type: Optional[T.DataType]):
        self.name = "count"
        self.input_type = input_type  # None => count(*)
        self.result_type = T.BIGINT
        self.states = (StateSpec("count", T.BIGINT, "sum"),)

    def map_raw(self, ctx, args, active):
        if not args:
            keep = active
        else:
            keep = _valid_and_active(args[0], active, ctx.capacity)
        return [keep.to(torch.int64)]

    def extract(self, state_arrays, group_valid):
        (c,) = state_arrays
        # count over an empty/all-null group is 0, never null
        return EvalValue(torch.where(group_valid, c, 0), None, T.BIGINT)


class AvgAgg(AggregateFunction):
    def __init__(self, input_type: T.DataType):
        self.name = "avg"
        self.input_type = input_type
        self._long = input_type.is_long_decimal
        self._two_part = (input_type.kind is T.TypeKind.DECIMAL
                          and not input_type.is_long_decimal)
        if self._two_part:
            # short-decimal avg: the sum runs at int128 (two planar
            # parts) and is divided half-up by the count at extraction
            self.result_type = input_type
            self.states = (StateSpec("slo", T.BIGINT, "sum"),
                           StateSpec("shi", T.BIGINT, "sum"),
                           StateSpec("count", T.BIGINT, "sum"))
            return
        if self._long:
            self.result_type = input_type
            self.states = tuple(
                StateSpec(f"p{i}", T.BIGINT, "sum") for i in range(4)
            ) + (StateSpec("count", T.BIGINT, "sum"),)
            return
        self.result_type = T.DOUBLE
        self.states = (StateSpec("sum", T.DOUBLE, "sum"),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        data = v.full_data(ctx.capacity)
        if self._two_part:
            return _two_parts(data, keep)
        if self._long:
            return _four_parts(v, data, keep)
        data = data.to(torch.float64)
        return [masked(data, keep, 0), keep.to(torch.int64)]

    def extract(self, state_arrays, group_valid):
        from velox_tpu_torch.ops.int128 import (
            combine_parts, combine_two_parts, div128_round_half_up,
        )
        if self._two_part or self._long:
            if self._two_part:
                s_lo, s_hi, c = state_arrays
                lo, hi = combine_two_parts(s_lo, s_hi)
            else:
                p0, p1, p2, p3, c = state_arrays
                lo, hi = combine_parts(p0, p1, p2, p3)
            qlo, qhi = div128_round_half_up(lo, hi, torch.clamp(c, min=1))
            valid = group_valid & (c > 0)
            if self._two_part:  # the quotient fits the input type
                return EvalValue(qlo, valid, self.result_type)
            return _long_value(qlo, qhi, valid, self.result_type)
        s, c = state_arrays
        valid = group_valid & (c > 0)
        return EvalValue(s / torch.clamp(c, min=1), valid, T.DOUBLE)


class MinMaxAgg(AggregateFunction):
    def __init__(self, name: str, input_type: T.DataType):
        self.name = name
        self.input_type = input_type
        self.result_type = input_type
        self.states = (StateSpec(name, input_type, name),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        # the state's dtype: a column stored narrower than its type
        # widens, so the identity stays representable
        st = self.states[0]
        data = v.full_data(ctx.capacity).to(st.dtype.torch_dtype())
        return [masked(data, keep, st.identity()), keep.to(torch.int64)]

    def extract(self, state_arrays, group_valid):
        m, c = state_arrays
        return EvalValue(m, group_valid & (c > 0), self.result_type)


class CountIfAgg(AggregateFunction):
    """Parity: prestosql CountIfAggregate.cpp."""

    def __init__(self):
        self.name = "count_if"
        self.result_type = T.BIGINT
        self.states = (StateSpec("count", T.BIGINT, "sum"),)

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        keep = keep & v.full_data(ctx.capacity).to(torch.bool)
        return [keep.to(torch.int64)]

    def extract(self, state_arrays, group_valid):
        (c,) = state_arrays
        return EvalValue(torch.where(group_valid, c, 0), None, T.BIGINT)


class BoolAgg(AggregateFunction):
    """bool_and (every) / bool_or. Parity: prestosql BoolAnd/OrAggregate."""

    def __init__(self, name: str):
        self.name = name
        self.result_type = T.BOOLEAN
        combine = "min" if name == "bool_and" else "max"
        self.states = (StateSpec("b", T.INTEGER, combine),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        b = v.full_data(ctx.capacity).to(torch.int32)
        return [masked(b, keep, self.states[0].identity()),
                keep.to(torch.int64)]

    def extract(self, state_arrays, group_valid):
        b, c = state_arrays
        return EvalValue(b.to(torch.bool), group_valid & (c > 0), T.BOOLEAN)


def _as_double(v: EvalValue, capacity: int) -> torch.Tensor:
    """The value as float64 (a decimal divided by 10^scale), as the
    reference's moment aggregates read it."""
    data = v.full_data(capacity)
    if v.dtype.kind is T.TypeKind.DECIMAL:
        return data.to(torch.float64) / (10.0 ** v.dtype.scale)
    return data.to(torch.float64)


class VarianceAgg(AggregateFunction):
    """variance/var_samp/var_pop/stddev/stddev_samp/stddev_pop over the
    segment-combinable power sums (n, sum x, sum x^2). Parity: prestosql
    VarianceAggregates.cpp."""

    def __init__(self, name: str, input_type: T.DataType):
        self.name = name
        self.input_type = input_type
        self.result_type = T.DOUBLE
        self.states = (StateSpec("n", T.BIGINT, "sum"),
                       StateSpec("sum", T.DOUBLE, "sum"),
                       StateSpec("sumsq", T.DOUBLE, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        x = torch.where(keep, _as_double(v, ctx.capacity), 0.0)
        return [keep.to(torch.int64), x, x * x]

    def extract(self, state_arrays, group_valid):
        n, s, ss = state_arrays
        pop = self.name.endswith("_pop")
        nf = n.to(torch.float64)
        m2 = ss - s * s / torch.clamp(nf, min=1.0)
        denom = nf if pop else nf - 1.0
        out = torch.clamp(m2 / torch.clamp(denom, min=1.0), min=0.0)
        if self.name.startswith("stddev"):
            out = torch.sqrt(out)
        min_n = 1 if pop else 2
        return EvalValue(out, group_valid & (n >= min_n), T.DOUBLE)


class CentralMomentsAgg(AggregateFunction):
    """skewness / kurtosis over the power sums (n, x, x^2, x^3, x^4), with
    the reference's formulas (prestosql CentralMomentsAggregates.cpp):
    m2 = s2 - s1^2/n, m3 = s3 - 3 s2 s1/n + 2 s1^3/n^2,
    m4 = s4 - 4 s3 s1/n + 6 s2 s1^2/n^2 - 3 s1^4/n^3. Groups with too few
    rows or no variance are NULL."""

    def __init__(self, name: str, input_type: T.DataType):
        self.name = name
        self.input_type = input_type
        self.result_type = T.DOUBLE
        self.states = (StateSpec("n", T.BIGINT, "sum"),
                       StateSpec("s1", T.DOUBLE, "sum"),
                       StateSpec("s2", T.DOUBLE, "sum"),
                       StateSpec("s3", T.DOUBLE, "sum"),
                       StateSpec("s4", T.DOUBLE, "sum"))

    def map_raw(self, ctx, args, active):
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        x = torch.where(keep, _as_double(v, ctx.capacity), 0.0)
        x2 = x * x
        return [keep.to(torch.int64), x, x2, x2 * x, x2 * x2]

    def extract(self, state_arrays, group_valid):
        n, s1, s2, s3, s4 = state_arrays
        nf = torch.clamp(n.to(torch.float64), min=1.0)
        m2 = torch.clamp(s2 - s1 * s1 / nf, min=0.0)
        if self.name == "skewness":
            m3 = s3 - 3.0 * s2 * s1 / nf + 2.0 * s1 ** 3 / (nf * nf)
            out = torch.sqrt(nf) * m3 / torch.clamp(m2, min=1e-300) ** 1.5
            ok = (n >= 3) & (m2 > 0.0)
        else:  # kurtosis: the sample excess kurtosis
            m4 = (s4 - 4.0 * s3 * s1 / nf + 6.0 * s2 * s1 * s1 / (nf * nf)
                  - 3.0 * s1 ** 4 / nf ** 3)
            c = nf
            denom = torch.clamp((c - 2.0) * (c - 3.0), min=1.0)
            out = ((c - 1.0) * c * (c + 1.0)) / denom \
                * m4 / torch.clamp(m2 * m2, min=1e-300) \
                - 3.0 * (c - 1.0) * (c - 1.0) / denom
            ok = (n >= 4) & (m2 > 0.0)
        return EvalValue(out, group_valid & ok, T.DOUBLE)


# argument kinds whose order-preserving word is 32 bits: min_by/max_by
# over two of them pack (y, x) into one segment-combinable int64
_PACKABLE_32 = (T.TypeKind.BOOLEAN, T.TypeKind.TINYINT, T.TypeKind.SMALLINT,
                T.TypeKind.INTEGER, T.TypeKind.DATE, T.TypeKind.VARCHAR,
                T.TypeKind.VARBINARY, T.TypeKind.REAL)

_SIGN32 = 1 << 31
_M32 = 0xFFFFFFFF


def _pack32(v: EvalValue, capacity: int, keep_id: bool = False
            ) -> torch.Tensor:
    """The order-preserving 32-bit word of a packable value, as an int64
    in [0, 2^32). With ``keep_id`` a dictionary string packs its id,
    which ``_unpack32`` gives back, and not the rank of its value."""
    from velox_tpu_torch.exec.sort import value_words
    if keep_id and v.dtype.is_string:
        return v.full_data(capacity).to(torch.int64) + _SIGN32
    (w,) = value_words(v, capacity)
    return w


def _unpack32(u: torch.Tensor, dtype: T.DataType) -> torch.Tensor:
    """Invert ``_pack32``: the int64 word in [0, 2^32) back to the value,
    bit for bit (REAL through its int32 bits, not a value cast)."""
    if dtype.kind is T.TypeKind.REAL:
        bits = torch.where((u & _SIGN32) != 0, u ^ _SIGN32, u ^ _M32)
        signed = bits - ((bits >> 31) << 32)  # the int32 of those bits
        return signed.to(torch.int32).view(torch.float32)
    if dtype.kind is T.TypeKind.BOOLEAN:
        return u.to(torch.bool)
    out = u - _SIGN32
    return out.to(torch.int32 if dtype.is_string else dtype.torch_dtype())


class MinMaxByAgg(AggregateFunction):
    """min_by(x, y) / max_by(x, y) for 32-bit-packable x and y: the pair
    (y, x) packs into one int64, so the min/max combine is an exact
    argmin/argmax (ties in y take the smaller x; a string x, the smaller
    id). With ``position_ordered`` (first/last) y is the row's position
    within its batch. Parity: prestosql MinMaxByAggregates.cpp."""

    def __init__(self, name: str, x_type: T.DataType, y_type: T.DataType,
                 position_ordered: bool = False):
        self.name = name
        self.x_type, self.y_type = x_type, y_type
        self.input_type = x_type
        self.result_type = x_type
        self.position_ordered = position_ordered
        combine = "min" if name == "min_by" else "max"
        self.states = (StateSpec("pair", T.BIGINT, combine),
                       StateSpec("count", T.BIGINT, "sum"))

    def map_raw(self, ctx, args, active):
        cap = ctx.capacity
        if self.position_ordered:
            (x,) = args
            y = EvalValue(torch.arange(cap, dtype=torch.int32,
                                       device=active.device), None,
                          T.INTEGER)
        else:
            x, y = args
        keep = _valid_and_active(y, active, cap)
        if x.validity is not None:
            keep = keep & x.full_validity(cap)
        xp = _pack32(x, cap, keep_id=True)
        yp = _pack32(y, cap)
        if self.name == "max_by":
            xp = _M32 - xp  # ties in y: the smaller x wins under max
        # y biased into [-2^31, 2^31): (y << 32) | x spans int64 in order
        pair = ((yp - _SIGN32) << 32) | xp
        return [masked(pair, keep, self.states[0].identity()),
                keep.to(torch.int64)]

    def extract(self, state_arrays, group_valid):
        pair, c = state_arrays
        xp = pair & _M32
        if self.name == "max_by":
            xp = _M32 - xp
        return EvalValue(_unpack32(xp, self.x_type), group_valid & (c > 0),
                         self.x_type)


# HyperLogLog registers of approx_distinct: the reference's default of
# 512 (a standard error of about 1.04 / sqrt(512) = 4.6%)
HLL_REGISTERS = 512


class RegisterAddend(NamedTuple):
    """A row's contribution to a vector state: its register and the value
    to max into it (0 for inactive rows: registers are >= 0, so 0 is the
    identity of their max). The group steps reduce it straight into a
    (groups x width) buffer at ``group * width + reg``: the reference's
    one-hot (rows x width) addend is never formed."""
    reg: torch.Tensor   # int64[rows] in [0, width)
    val: torch.Tensor   # int32[rows]
    width: int


def bit_length(w: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values below 2^32 (0 for
    0), by a binary search over shifts: the reference's
    ``floor(log2(float32(w))) + 1`` rounds near powers of two."""
    n = torch.zeros_like(w)
    x = w
    for s in (16, 8, 4, 2, 1):
        t = (x >> s) > 0
        n = n + torch.where(t, s, 0)
        x = torch.where(t, x >> s, x)
    return n + (x > 0).to(w.dtype)


class ApproxDistinctAgg(AggregateFunction):
    """approx_distinct over HyperLogLog registers: a vector state of
    ``HLL_REGISTERS`` int32 a group, combined by max. Each row hashes its
    value (exec/hashtable.py ``hash_rows``, the reference's 32-bit hash),
    takes its register from the low p bits and rho = the leading zeros
    of the rest + 1. Parity: prestosql approx_distinct (HLL)."""

    def __init__(self, input_type: T.DataType):
        self.name = "approx_distinct"
        self.input_type = input_type
        self.result_type = T.BIGINT
        self.m = HLL_REGISTERS
        self.p = self.m.bit_length() - 1
        self.states = (StateSpec("hll", T.INTEGER, "max", width=self.m),)

    def map_raw(self, ctx, args, active):
        from velox_tpu_torch.exec.hashtable import hash_rows
        (v,) = args
        keep = _valid_and_active(v, active, ctx.capacity)
        h = hash_rows([v], ctx.capacity)  # int64 in [0, 2^32)
        reg = h & (self.m - 1)
        w = h >> self.p
        rho = (32 - self.p) - bit_length(w) + 1
        return [RegisterAddend(reg, torch.where(keep, rho, 0).to(
            torch.int32), self.m)]

    def extract(self, state_arrays, group_valid):
        (regs,) = state_arrays  # (groups, m) int32
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        rf = regs.to(torch.float64)
        est = alpha * m * m / torch.exp2(-rf).sum(1)
        zeros = (regs == 0).to(torch.float64).sum(1)
        # linear counting for small cardinalities
        lin = m * torch.log(m / torch.clamp(zeros, min=1.0))
        out = torch.where((est <= 2.5 * m) & (zeros > 0), lin, est)
        return EvalValue(torch.round(out).to(torch.int64), group_valid,
                         T.BIGINT)


class CollectAgg(AggregateFunction):
    """An aggregate without a segment-combinable state: the operator
    retains its rows and computes it at the end, from one sort of the rows
    by (group, value). Single-step only, but for one approx_percentile."""
    states: Tuple[StateSpec, ...] = ()
    collect_kind: str = ""


class CollectMinMaxByAgg(CollectAgg):
    """min_by(x, y)/max_by(x, y) over types beyond the 32-bit pair
    packing: rows sorted by (group, y), the first or last passing row's x.
    min/max over a long decimal come here with x == y."""

    def __init__(self, name: str, x_type: T.DataType, y_type: T.DataType):
        self.name = name
        self.collect_kind = name if name.endswith("_by") else name + "_by"
        self.input_type = x_type
        self.y_type = y_type
        self.result_type = x_type


class ModeAgg(CollectAgg):
    """mode(x): the most frequent non-null value of each group, the
    smallest of those tied. Parity: Presto/Spark mode."""
    collect_kind = "mode"

    def __init__(self, input_type: T.DataType):
        self.name = "mode"
        self.input_type = input_type
        self.result_type = input_type


class ApproxPercentileAgg(CollectAgg):
    """approx_percentile(x, p[, accuracy]): exact in a single step (rank
    ceil(p * n) of the value-sorted group); split into PARTIAL and FINAL
    through a mergeable summary of at most K weighted knots a group
    (exec/aggregation.py ``_pct_compress``; the role of the reference's
    KLL sketch, functions/lib/KllSketch.h). The operator sets
    ``percentile`` and ``accuracy`` from the constant arguments."""
    collect_kind = "approx_percentile"

    def __init__(self, input_type: T.DataType):
        self.name = "approx_percentile"
        self.input_type = input_type
        self.result_type = input_type
        self.percentile = 0.5
        self.accuracy: Optional[float] = None

    @property
    def intermediate_type(self) -> T.DataType:
        # the knots: "<name>$v" (value) and "<name>$w" (weight) columns
        return T.row(["v", "w"], [self.input_type, T.BIGINT])


class ArrayAgg(CollectAgg):
    """array_agg(x): a group's values, NULLs kept, in input order."""
    collect_kind = "array_agg"

    def __init__(self, input_type: T.DataType):
        self.name = "array_agg"
        self.input_type = input_type
        self.result_type = T.array(input_type)


class SetAgg(CollectAgg):
    """set_agg(x): a group's distinct values, sorted, NULL once at the
    end."""
    collect_kind = "set_agg"

    def __init__(self, input_type: T.DataType):
        self.name = "set_agg"
        self.input_type = input_type
        self.result_type = T.array(input_type)


class MapAgg(CollectAgg):
    """map_agg(k, v): one entry per distinct non-NULL key (the first of
    its rows in input order), keys sorted."""
    collect_kind = "map_agg"

    def __init__(self, key_type: T.DataType, value_type: T.DataType):
        self.name = "map_agg"
        self.input_type = key_type
        self.value_type = value_type
        self.result_type = T.map_(key_type, value_type)


class MultimapAgg(CollectAgg):
    """multimap_agg(k, v) -> map(k, array(v)): every value of each
    non-NULL key, NULL values kept."""
    collect_kind = "multimap_agg"

    def __init__(self, key_type: T.DataType, value_type: T.DataType):
        self.name = "multimap_agg"
        self.input_type = key_type
        self.value_type = value_type
        self.result_type = T.map_(key_type, T.array(value_type))


class MapUnionAgg(CollectAgg):
    """map_union(m): the Task runs it as an Unnest of the maps and a
    map_agg of their entries (exec/task.py ``_map_union_plan``)."""
    collect_kind = "map_union"

    def __init__(self, map_type: T.DataType):
        self.name = "map_union"
        self.input_type = map_type
        self.result_type = map_type


class BloomFilterAgg(CollectAgg):
    """bloom_filter_agg(x[, estimated items[, bits]]): a bloom sketch of
    the non-NULL inputs, K = 3 probes double-hashed from
    exec/hashtable.py ``bloom_hashes``, packed 32 bits to an INTEGER:
    ARRAY(INTEGER), the reference's layout. Global aggregation only."""
    collect_kind = "bloom"
    K = 3

    def __init__(self, input_type: T.DataType):
        self.name = "bloom_filter_agg"
        self.input_type = input_type
        self.result_type = T.array(T.INTEGER)
        self.num_bits = 1 << 20  # the operator sets it from the arguments


class HistogramAgg(CollectAgg):
    """histogram(x): each distinct non-NULL value's count."""
    collect_kind = "histogram"

    def __init__(self, input_type: T.DataType):
        self.name = "histogram"
        self.input_type = input_type
        self.result_type = T.map_(input_type, T.BIGINT)


class ApproxMostFrequentAgg(CollectAgg):
    """approx_most_frequent(buckets, x, capacity): the ``buckets`` most
    frequent non-NULL values of each group with their counts, exact (the
    smaller value first among equal counts)."""
    collect_kind = "approx_most_frequent"

    def __init__(self, input_type: T.DataType):
        self.name = "approx_most_frequent"
        self.input_type = input_type
        self.result_type = T.map_(input_type, T.BIGINT)
        self.buckets = 3  # the operator sets it from the constant argument



_VARIANCE = {"variance": "var_samp", "var_samp": "var_samp",
             "var_pop": "var_pop", "stddev": "stddev_samp",
             "stddev_samp": "stddev_samp", "stddev_pop": "stddev_pop"}


def resolve_aggregate(name: str, input_types) -> AggregateFunction:
    name = name.lower()
    if name == "sum":
        return SumAgg(input_types[0])
    if name == "count":
        return CountAgg(input_types[0] if input_types else None)
    if name == "avg":
        return AvgAgg(input_types[0])
    if name in ("min", "max"):
        if input_types[0].is_long_decimal:
            return CollectMinMaxByAgg(name, input_types[0], input_types[0])
        return MinMaxAgg(name, input_types[0])
    if name in ("arbitrary", "any_value"):
        # any value of the group is conforming; the reference's is min
        return resolve_aggregate("min", input_types[:1])
    if name == "count_if":
        return CountIfAgg()
    if name in ("bool_and", "every"):
        return BoolAgg("bool_and")
    if name == "bool_or":
        return BoolAgg("bool_or")
    if name in _VARIANCE:
        return VarianceAgg(_VARIANCE[name], input_types[0])
    if name in ("skewness", "kurtosis"):
        return CentralMomentsAgg(name, input_types[0])
    if name in ("first", "first_value", "last", "last_value") \
            and len(input_types) == 1:
        # Spark's first/last without an order: min_by/max_by over the
        # row's position in its batch, nulls skipped; wider types take
        # min/max (any value conforms; min/max keeps it deterministic)
        first = name.startswith("first")
        x = input_types[0]
        if x.kind not in _PACKABLE_32:
            return resolve_aggregate("min" if first else "max", [x])
        return MinMaxByAgg("min_by" if first else "max_by", x, T.INTEGER,
                           position_ordered=True)
    if name in ("min_by", "max_by"):
        if (input_types[0].kind in _PACKABLE_32
                and input_types[1].kind in _PACKABLE_32):
            return MinMaxByAgg(name, input_types[0], input_types[1])
        return CollectMinMaxByAgg(name, input_types[0], input_types[1])
    if name == "approx_distinct":
        # approx_distinct(x, e): the reference never reads e, so every
        # call has 512 registers, here too
        return ApproxDistinctAgg(input_types[0])
    if name == "mode":
        return ModeAgg(input_types[0])
    if name == "approx_percentile":
        return ApproxPercentileAgg(input_types[0])
    if name in ("array_agg", "set_agg"):
        return (ArrayAgg if name == "array_agg" else SetAgg)(input_types[0])
    if name in ("map_agg", "multimap_agg"):
        return (MapAgg if name == "map_agg" else MultimapAgg)(
            input_types[0], input_types[1])
    if name == "map_union":
        return MapUnionAgg(input_types[0])
    if name == "histogram":
        return HistogramAgg(input_types[0])
    if name == "approx_most_frequent":
        return ApproxMostFrequentAgg(input_types[1])
    if name == "bloom_filter_agg":
        return BloomFilterAgg(input_types[0])
    raise NotImplementedError(
        f"aggregate function {name!r} is not ported to velox_tpu_torch")


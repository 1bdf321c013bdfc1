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

Ported: sum, count, avg, min, max, and min_by/max_by where the reference
takes its collect pathway (rows retained, sorted by (group, y), the first
or last passing row's x; exec/aggregation.py), which min/max over
DECIMAL(19..38) take too. Any other aggregate raises NotImplementedError
naming itself.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue


@dataclass(frozen=True)
class StateSpec:
    suffix: str           # physical column suffix, e.g. "sum", "count"
    dtype: T.DataType     # device dtype of the state column
    combine: str          # 'sum' | 'min' | 'max'
    width: int = 1        # the reference's vector states; always 1 here

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


class CollectAgg(AggregateFunction):
    """An aggregate without a segment-combinable state: the operator
    retains its rows and computes it at the end, from one sort of the rows
    by (group, value). Single-step only."""
    states: Tuple[StateSpec, ...] = ()
    collect_kind: str = ""


class CollectMinMaxByAgg(CollectAgg):
    """min_by(x, y)/max_by(x, y) over types beyond the reference's 32-bit
    pair packing: rows sorted by (group, y), the first or last passing
    row's x. min/max over a long decimal come here with x == y."""

    def __init__(self, name: str, x_type: T.DataType, y_type: T.DataType):
        self.name = name
        self.collect_kind = name if name.endswith("_by") else name + "_by"
        self.input_type = x_type
        self.y_type = y_type
        self.result_type = x_type


# argument kinds the reference packs into one segment-combinable 64-bit
# min_by/max_by state (MinMaxByAgg, not ported)
_PACKABLE_32 = (T.TypeKind.BOOLEAN, T.TypeKind.TINYINT, T.TypeKind.SMALLINT,
                T.TypeKind.INTEGER, T.TypeKind.DATE, T.TypeKind.VARCHAR,
                T.TypeKind.VARBINARY, T.TypeKind.REAL)

# the reference's other collect aggregates (ROADMAP A.5)
_COLLECT_NOT_PORTED = (
    "array_agg", "set_agg", "map_agg", "multimap_agg", "map_union",
    "mode", "histogram", "approx_percentile", "approx_most_frequent",
    "bloom_filter_agg")


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
    if name in ("min_by", "max_by"):
        if (input_types[0].kind in _PACKABLE_32
                and input_types[1].kind in _PACKABLE_32):
            raise NotImplementedError(
                f"{name} over 32-bit packable arguments (the reference's "
                "MinMaxByAgg) is not ported to velox_tpu_torch (ROADMAP "
                "A.5)")
        return CollectMinMaxByAgg(name, input_types[0], input_types[1])
    if name in _COLLECT_NOT_PORTED:
        raise NotImplementedError(
            f"collect aggregate {name!r} is not ported to velox_tpu_torch "
            "(ROADMAP A.5)")
    raise NotImplementedError(
        f"aggregate function {name!r} is not ported to velox_tpu_torch")

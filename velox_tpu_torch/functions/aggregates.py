"""Aggregate function signatures.

Counterpart of ``velox_tpu/functions/aggregates.py``, reduced to what plan
construction needs: the result and intermediate types of each aggregate,
which ``core/plan.py`` and ``testing/plan_builder.py`` read. The types are
the reference's, so a plan built here has the same output schema as the
same plan built with ``velox_tpu``. The accumulators themselves are not
ported yet (global ``sum(a*b)`` runs through ``ops/filter_reduce.py``);
the generic aggregation arrives with the Q1 slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from velox_tpu_torch import types as T


@dataclass(frozen=True)
class StateSpec:
    suffix: str           # physical column suffix, e.g. "sum", "count"
    dtype: T.DataType     # device dtype of the state column
    combine: str          # 'sum' | 'min' | 'max'


class AggregateFunction:
    """One resolved aggregate signature (name + input types)."""

    name: str
    states: Tuple[StateSpec, ...]
    result_type: T.DataType

    @property
    def intermediate_type(self) -> T.DataType:
        if len(self.states) == 1:
            return self.states[0].dtype
        return T.row([s.suffix for s in self.states],
                     [s.dtype for s in self.states])


class SumAgg(AggregateFunction):
    def __init__(self, input_type: T.DataType):
        self.name = "sum"
        self.input_type = input_type
        if input_type.kind is T.TypeKind.DECIMAL:
            # every decimal sum returns DECIMAL(38, s) over int128 states
            self.result_type = T.decimal(38, input_type.scale)
            if input_type.is_long_decimal:
                self.states = tuple(
                    StateSpec(f"p{i}", T.BIGINT, "sum") for i in range(4)
                ) + (StateSpec("count", T.BIGINT, "sum"),)
            else:
                self.states = (StateSpec("slo", T.BIGINT, "sum"),
                               StateSpec("shi", T.BIGINT, "sum"),
                               StateSpec("count", T.BIGINT, "sum"))
            return
        st = T.BIGINT if input_type.is_integral else T.DOUBLE
        self.result_type = st
        self.states = (StateSpec("sum", st, "sum"),
                       StateSpec("count", T.BIGINT, "sum"))


class CountAgg(AggregateFunction):
    def __init__(self, input_type: Optional[T.DataType]):
        self.name = "count"
        self.input_type = input_type  # None => count(*)
        self.result_type = T.BIGINT
        self.states = (StateSpec("count", T.BIGINT, "sum"),)


class AvgAgg(AggregateFunction):
    def __init__(self, input_type: T.DataType):
        self.name = "avg"
        self.input_type = input_type
        if input_type.is_long_decimal:
            self.result_type = input_type
            self.states = tuple(
                StateSpec(f"p{i}", T.BIGINT, "sum") for i in range(4)
            ) + (StateSpec("count", T.BIGINT, "sum"),)
        elif input_type.kind is T.TypeKind.DECIMAL:
            self.result_type = input_type
            self.states = (StateSpec("slo", T.BIGINT, "sum"),
                           StateSpec("shi", T.BIGINT, "sum"),
                           StateSpec("count", T.BIGINT, "sum"))
        else:
            self.result_type = T.DOUBLE
            self.states = (StateSpec("sum", T.DOUBLE, "sum"),
                           StateSpec("count", T.BIGINT, "sum"))


class MinMaxAgg(AggregateFunction):
    def __init__(self, name: str, input_type: T.DataType):
        if input_type.is_long_decimal:
            raise NotImplementedError(
                f"{name} over DECIMAL(>18) is not ported yet")
        self.name = name
        self.input_type = input_type
        self.result_type = input_type
        self.states = (StateSpec(name, input_type, name),
                       StateSpec("count", T.BIGINT, "sum"))


def resolve_aggregate(name: str, input_types) -> AggregateFunction:
    name = name.lower()
    if name == "sum":
        return SumAgg(input_types[0])
    if name == "count":
        return CountAgg(input_types[0] if input_types else None)
    if name == "avg":
        return AvgAgg(input_types[0])
    if name in ("min", "max"):
        return MinMaxAgg(name, input_types[0])
    raise NotImplementedError(
        f"aggregate function {name!r} is not ported to velox_tpu_torch")

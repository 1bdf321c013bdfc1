"""Streaming aggregation of the torch port against the JAX reference (the
port's counterparts of tests/test_streaming_agg.py).

The Task streams an aggregation whose source is an OrderBy on its
grouping keys. Each plan runs through both engines; the rows must be the
same (integers exactly, doubles within 1e-9 relative), and the port must
have streamed exactly where the reference does.
"""

import math

import numpy as np
import pyarrow as pa
import torch

from velox_tpu.exec.streaming_agg import (
    StreamingAggregationOperator as JStreaming,
)
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.core.config import QueryConfig
from velox_tpu_torch.exec.streaming_agg import StreamingAggregationOperator
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

CPU = QueryCtx("cpu")


def _streamed(task, cls) -> bool:
    return any(isinstance(op, cls) for op in task.operators)


def _rows(table: pa.Table):
    rows = list(zip(*(table.column(c).to_pylist()
                      for c in table.column_names)))
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None
                                             else 0) for v in r))


def _both(build, ctx=CPU):
    """Run ``build(PlanBuilder class)``'s plan through both engines; check
    equal rows; return (port's table, whether each streamed)."""
    jtask = JTask(build(JPlanBuilder))
    want = jtask.run()
    task = Task(build(PlanBuilder), ctx)
    got = task.run()
    assert got.schema == want.schema
    for g, w in zip(_rows(got), _rows(want)):
        for a, b in zip(g, w):
            if isinstance(b, float) and a is not None:
                assert math.isclose(a, b, rel_tol=1e-9)
            else:
                assert a == b
    assert got.num_rows == want.num_rows
    return got, _streamed(task, StreamingAggregationOperator), \
        _streamed(jtask, JStreaming)


def test_streaming_agg_matches_the_reference_multibatch():
    rng = np.random.RandomState(5)
    t = pa.table({"g": pa.array(rng.randint(0, 20, 1000), pa.int64()),
                  "x": pa.array(rng.randint(-50, 50, 1000), pa.int64())})
    _, ours, ref = _both(lambda B: (
        B().values([t.slice(i * 250, 250) for i in range(4)])
        .order_by(["g"])
        .single_aggregation(["g"], ["sum(x) as s", "count(x) as c",
                                    "min(x) as mn", "max(x) as mx",
                                    "avg(x) as a"]).plan()))
    assert ours and ref


def test_streaming_group_spanning_batches():
    """One group across every batch boundary: the carry accumulates
    through all batches and flushes once at the end."""
    tables = [pa.table({"g": pa.array(g, pa.int64()),
                        "x": pa.array(x, pa.int64())})
              for g, x in (([1, 1, 1], [1, 2, 3]), ([1, 1], [4, 5]),
                           ([1, 2], [6, 100]))]
    got, ours, _ = _both(lambda B: (
        B().values(tables).order_by(["g"])
        .single_aggregation(["g"], ["sum(x) as s", "count(*) as c"])
        .plan()))
    assert ours
    assert _rows(got) == [(1, 21, 6), (2, 100, 1)]


def test_streaming_null_keys_and_mask():
    t = pa.table({"g": pa.array([None, None, 1, 1, 2], pa.int64()),
                  "x": pa.array([10, 20, 1, 2, 3], pa.int64())})
    got, ours, _ = _both(lambda B: (
        B().values([t]).order_by(["g"])
        .single_aggregation(["g"], ["sum(x) as s",
                                    "sum(x) filter (where x > 1) as sf"])
        .plan()))
    assert ours
    assert _rows(got) == [(1, 3, 2), (2, 3, 3), (None, 30, 30)]


def test_streaming_desc_and_multikey():
    rng = np.random.RandomState(9)
    t = pa.table({"a": pa.array(rng.randint(0, 5, 300), pa.int64()),
                  "b": pa.array(rng.randint(0, 4, 300), pa.int64()),
                  "x": pa.array(rng.randint(0, 100, 300), pa.int64())})
    _, ours, ref = _both(lambda B: (
        B().values([t.slice(0, 120), t.slice(120)]).order_by(["a desc", "b"])
        .single_aggregation(["a", "b"], ["sum(x) as s"]).plan()))
    assert ours and ref


def test_streaming_not_chosen_when_unsorted_or_disabled():
    t = pa.table({"g": pa.array([2, 1, 2], pa.int64()),
                  "x": pa.array([1, 2, 3], pa.int64())})
    got, ours, ref = _both(lambda B: (
        B().values([t]).single_aggregation(["g"], ["sum(x) as s"]).plan()))
    assert not ours and not ref
    assert _rows(got) == [(1, 2), (2, 4)]
    off = QueryCtx("cpu", {QueryConfig.STREAMING_AGG_ENABLED: False})
    _, ours, _ = _both(lambda B: (
        B().values([t]).order_by(["g"])
        .single_aggregation(["g"], ["sum(x) as s"]).plan()), off)
    assert not ours

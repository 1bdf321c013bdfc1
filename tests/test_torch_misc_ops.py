"""EnforceSingleRow and the nested-loop join of the torch port against the
JAX reference (the port's counterparts of tests/test_misc_ops.py's
EnforceSingleRow and NestedLoopJoin tests).

Each plan is built by each package's own PlanBuilder over the same
pyarrow tables and run by each package's Task; the two Arrow results must
hold the same rows (sorted, since a join's row order is not specified),
with the same schema and the same NULLs.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.exec import misc_ops
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

CPU = QueryCtx("cpu")


def _rows(table: pa.Table):
    cols = table.column_names
    rows = list(zip(*(table.column(c).to_pylist() for c in cols)))
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None
                                             else 0) for v in r))


def _both(build):
    """Run ``build(PlanBuilder class)``'s plan through both engines and
    return the port's table, after checking it equals the reference's."""
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.schema == want.schema
    assert _rows(got) == _rows(want)
    return got


def _table(**cols):
    return pa.table({k: pa.array(v, pa.int64()) for k, v in cols.items()})


def test_enforce_single_row_passes_one_row():
    t = _table(v=[42])
    got = _both(lambda B: B().values([t]).enforce_single_row().plan())
    assert got.column("v").to_pylist() == [42]


def test_enforce_single_row_raises_on_two_rows():
    t = _table(v=[1, 2])
    with pytest.raises(RuntimeError, match="single row"):
        Task(PlanBuilder().values([t]).enforce_single_row().plan(),
             CPU).run()


@pytest.mark.parametrize("filtered", [False, True])
def test_enforce_single_row_of_no_rows_is_one_null_row(filtered):
    """An empty input (no row, or every row filtered away) gives one
    all-NULL row."""
    t = _table(v=[] if not filtered else [1, 2, 3])

    def build(B):
        b = B().values([t])
        if filtered:
            b = b.filter("v > 10")
        return b.enforce_single_row().plan()
    got = _both(build)
    assert got.num_rows == 1 and got.column("v").null_count == 1


def test_enforce_single_row_keeps_a_long_decimal_and_a_string():
    t = pa.table({"s": pa.array(["x", "y", "z"]),
                  "v": pa.array([10, 20, 30], pa.int64())})

    def build(B):
        return (B().values([t]).filter("v = 20")
                .single_aggregation(["s"], ["sum(cast(v as decimal(12,2)))"
                                            " as total"])
                .enforce_single_row().plan())
    got = Task(build(PlanBuilder), CPU).run()
    assert got.column("s").to_pylist() == ["y"]
    assert [int(x.scaleb(2)) for x in got.column("total").to_pylist()] \
        == [2000]


def test_nested_loop_cross_join():
    left, right = _table(a=list(range(30))), _table(b=list(range(7)))

    def build(B):
        b = B()
        bb = b.new_builder().values([right])
        return b.values([left]).nested_loop_join(bb).plan()
    got = _both(build)
    assert got.num_rows == 210


def test_nested_loop_inequality_join():
    left, right = _table(a=list(range(40))), _table(b=list(range(40)))

    def build(B):
        b = B()
        bb = b.new_builder().values([right])
        return b.values([left]).nested_loop_join(bb, filter="a < b").plan()
    got = _both(build)
    assert got.num_rows == 40 * 39 // 2


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full"])
def test_nested_loop_outer_joins(jt):
    """Unmatched rows keep their side with NULLs on the other; the probe
    side comes in three batches, so the build's matches gather across
    them."""
    lefts = [_table(a=list(range(i, 25, 3))) for i in range(3)]
    right = _table(b=[x + 10 for x in range(25)])

    def build(B):
        b = B()
        bb = b.new_builder().values([right])
        return (b.values(lefts)
                .nested_loop_join(bb, filter="a > b", join_type=jt).plan())
    got = _both(build)
    assert got.num_rows > 0


def test_nested_loop_left_join_empty_build():
    left, right = _table(a=list(range(9))), _table(b=[])

    def build(B):
        b = B()
        bb = b.new_builder().values([right])
        return (b.values([left])
                .nested_loop_join(bb, filter="a < b", join_type="left")
                .plan())
    got = _both(build)
    assert got.num_rows == 9 and got.column("b").null_count == 9


def test_nested_loop_join_over_a_one_row_build(monkeypatch):
    """The TPC-H Q11/Q22 shape: a probe of many rows against a one-row
    aggregate; every build row index is 0. The gathers go through
    take_columns_rows (kernel B5 on the card), one call a side a chunk."""
    rng = np.random.default_rng(3)
    left = pa.table({"k": pa.array(rng.integers(0, 1000, 5000), pa.int64()),
                     "s": pa.array([f"s{x % 7}" for x in range(5000)])})
    calls = []
    take = misc_ops.take_columns_rows

    def counted(columns, idx):
        calls.append(idx)
        return take(columns, idx)
    monkeypatch.setattr(misc_ops, "take_columns_rows", counted)

    def build(B):
        b = B()
        total = (b.new_builder().values([left])
                 .single_aggregation([], ["avg(k) as mean"]))
        return (b.values([left])
                .nested_loop_join(total, filter="cast(k as double) > mean")
                .project(["k", "s"]).plan())
    got = _both(build)
    assert 0 < got.num_rows < 5000
    assert len(calls) == 2
    assert int(calls[1].max()) == 0


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full"])
def test_nested_loop_join_over_several_chunks(jt):
    """A product larger than the probe batch's capacity (1024): 100 x 60
    rows a batch, six chunks each, with the matched rows of both sides
    tracked across chunks and batches."""
    lefts = [_table(a=list(range(i * 100, i * 100 + 100)))
             for i in range(3)]
    right = _table(b=[3 * x for x in range(60)])

    def build(B):
        b = B()
        bb = b.new_builder().values([right])
        return (b.values(lefts)
                .nested_loop_join(bb, filter="a % 97 = b % 89",
                                  join_type=jt).plan())
    got = _both(build)
    assert got.num_rows > 0

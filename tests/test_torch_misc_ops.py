"""The smaller operators of the torch port against the JAX reference (the
port's counterparts of tests/test_misc_ops.py): MarkDistinct,
AssignUniqueId, EnforceSingleRow, Expand, GroupId, the nested-loop join
and the merge join.

Each plan is built by each package's own PlanBuilder over the same
pyarrow tables and run by each package's Task; the two Arrow results must
hold the same rows (sorted, since a join's row order is not specified),
with the same schema and the same NULLs.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import velox_tpu.core.expressions as JE
import velox_tpu.core.plan as JP
from velox_tpu.common.errors import VeloxRuntimeError as JVeloxRuntimeError
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.common.errors import VeloxRuntimeError
from velox_tpu_torch.core import expressions as E
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec import misc_ops
from velox_tpu_torch.exec.join import MergeJoinOperator
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


def test_mark_distinct():
    rng = np.random.RandomState(0)
    tables = [_table(k=rng.randint(0, 20, 100), v=np.arange(100))
              for _ in range(2)]
    got = _both(lambda B: B().values(tables)
                .mark_distinct("is_first", ["k"]).plan())
    assert got.num_rows == 200
    assert sum(got.column("is_first").to_pylist()) == len(
        set(got.column("k").to_pylist()))


def test_assign_unique_id():
    tables = [_table(v=np.arange(50)) for _ in range(3)]

    def build(B):
        return (B().values(tables).filter("v % 3 <> 1")
                .assign_unique_id("uid", task_unique_id=5).plan())
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.equals(want)
    uid = np.asarray(got.column("uid"))
    assert ((uid >> 40) == 5).all()
    assert (uid & ((1 << 40) - 1)).tolist() == list(range(len(uid)))


def test_expand():
    t = _table(a=np.arange(10), b=np.arange(10, 20))
    got = _both(lambda B: B().values([t])
                .expand([["a as x", "0 as tag"], ["b as x", "1 as tag"]])
                .plan())
    assert got.num_rows == 20


@pytest.mark.parametrize("sets", [(("a",), ("b",), ()),
                                  (("a", "b"), ("a",), ())])
def test_group_id(sets):
    """GROUPING SETS (and a ROLLUP) expansion plus aggregation: the keys
    outside a set are NULL, group_id numbers the sets."""
    t = pa.table({"a": pa.array([1, 1, 2, 2, 3], pa.int64()),
                  "b": pa.array(["x", "y", "x", "y", "x"]),
                  "v": pa.array([1, 2, 3, 4, 5], pa.int64())})

    def build(B):
        Pk, Ek = (JP, JE) if B is JPlanBuilder else (P, E)
        src = B().values([t]).plan()
        gid = Pk.GroupIdNode("gid", source=src, grouping_sets=sets,
                             aggregation_inputs=("v",))
        ot = gid.output_type()
        return Pk.AggregationNode(
            "agg", source=gid, step=Pk.AggregationStep.SINGLE,
            grouping_keys=tuple(Ek.field(n, ot.field_type(n))
                                for n in ("a", "b", "group_id")),
            aggregate_names=("s", "c"),
            aggregates=(Pk.AggregateCall(
                "sum", (Ek.field("v", ot.field_type("v")),), None),
                Pk.AggregateCall("count", (), None)))
    got = _both(build)
    assert sorted(set(got.column("group_id").to_pylist())) == [0, 1, 2]


def _merge_build(left, right, **kw):
    def build(B):
        b = B()
        bb = b.new_builder().values(right if isinstance(right, list)
                                    else [right])
        return b.values([left]).merge_join(["k"], ["rk"], bb, **kw).plan()
    return build


def test_merge_join():
    rng = np.random.RandomState(8)
    left = _table(k=np.sort(rng.randint(0, 50, 200)), lv=np.arange(200))
    right = _table(rk=np.sort(rng.permutation(60)[:30]), rv=np.arange(30))
    build = _merge_build(left, right, output=["k", "lv", "rv"])
    _both(build)
    task = Task(build(PlanBuilder), CPU)
    task.run()
    assert any(isinstance(op, MergeJoinOperator) for op in task.operators)


@pytest.mark.parametrize("jt", ["inner", "left", "right", "full",
                                "left_semi_filter"])
def test_merge_join_duplicates_and_join_types(jt):
    left = _table(k=[1, 1, 2, 5, 7, 7, 9], lv=np.arange(7))
    right = _table(rk=[1, 2, 2, 7, 8], rv=[10, 20, 21, 70, 80])
    out = ["k", "lv"] if jt == "left_semi_filter" else ["k", "lv", "rv"]
    _both(_merge_build(left, right, output=out, join_type=jt))


def test_merge_join_unsorted_build_raises():
    build = _merge_build(_table(k=[1, 2]), _table(rk=[5, 3, 4]),
                         output=["k", "rk"])
    with pytest.raises(JVeloxRuntimeError):
        JTask(build(JPlanBuilder)).run()
    with pytest.raises(VeloxRuntimeError, match="not sorted"):
        Task(build(PlanBuilder), CPU).run()


def test_merge_join_multibatch_sorted_stream():
    """Two sorted build batches whose concatenation stays sorted."""
    right = [_table(rk=[1, 3, 5], rv=[1, 3, 5]), _table(rk=[6, 8], rv=[6, 8])]
    left = _table(k=[3, 5, 6, 7], lv=[30, 50, 60, 70])
    got = _both(_merge_build(left, right, output=["k", "lv", "rv"]))
    assert sorted(got.column("k").to_pylist()) == [3, 5, 6]


def test_merge_join_on_wide_keys_runs_as_a_hash_join():
    """Key tuples beyond one packed lane (a DOUBLE takes three words)
    take the hash join, as in the reference."""
    left = pa.table({"k": pa.array([0.5, 1.5, 1.5, 3.0]),
                     "lv": pa.array([1, 2, 3, 4], pa.int64())})
    right = pa.table({"rk": pa.array([0.5, 1.5, 2.5]),
                      "rv": pa.array([10, 20, 30], pa.int64())})
    build = _merge_build(left, right, output=["k", "lv", "rv"])
    got = _both(build)
    assert got.num_rows == 3
    task = Task(build(PlanBuilder), CPU)
    task.run()
    assert not any(isinstance(op, MergeJoinOperator)
                   for op in task.operators)


def test_merge_join_anti():
    """An anti merge join gives the reference hash join's rows. (The
    reference's own merge join raises on ANTI: its node has no
    null_aware, ROADMAP C.)"""
    left = _table(k=[1, 1, 2, 5, 7, 7, 9], lv=np.arange(7))
    right = _table(rk=[1, 2, 2, 7, 8], rv=[10, 20, 21, 70, 80])
    got = Task(_merge_build(left, right, output=["k", "lv"],
                            join_type="anti")(PlanBuilder), CPU).run()
    jb = JPlanBuilder()
    jbb = jb.new_builder().values([right])
    want = JTask(jb.values([left]).hash_join(
        ["k"], ["rk"], jbb, output=["k", "lv"], join_type="anti")
        .plan()).run()
    assert _rows(got) == _rows(want) == [(5, 3), (9, 6)]


def test_arrow_stream_source():
    """ArrowStreamNode: record batches pulled from a RecordBatchReader and
    staged on the query's device, in order."""
    from velox_tpu import types as JT
    from velox_tpu_torch import types as T
    t = pa.table({"x": pa.array(range(100), pa.int64())})

    def reader():
        return pa.RecordBatchReader.from_batches(
            t.schema, t.to_batches(max_chunksize=30))
    want = JTask(JP.ArrowStreamNode("as0", reader=reader(),
                                    row_type=JT.row(["x"],
                                                    [JT.BIGINT]))).run()
    node = P.ArrowStreamNode("as0", reader=reader(),
                             row_type=T.row(["x"], [T.BIGINT]))
    got = Task(node, CPU).run()
    assert got.equals(want)
    assert got.column("x").to_pylist() == list(range(100))
    # a callable reader and an aggregation over the stream
    node = P.ArrowStreamNode("as1", reader=reader,
                             row_type=T.row(["x"], [T.BIGINT]))
    plan = P.AggregationNode(
        "agg", source=node, step=P.AggregationStep.SINGLE,
        grouping_keys=(), aggregate_names=("s",),
        aggregates=(P.AggregateCall("sum", (E.field("x", T.BIGINT),),
                                    T.BIGINT),))
    assert Task(plan, CPU).run().column("s").to_pylist() == [4950]


def test_arrow_stream_batch_on_another_device_raises():
    from velox_tpu_torch import types as T
    from velox_tpu_torch.exec.operator import ArrowStreamOperator
    from velox_tpu_torch.vector.device import from_arrow
    b = from_arrow(pa.table({"x": pa.array([1, 2], pa.int64())}),
                   device="cpu")
    node = P.ArrowStreamNode("as0", reader=[b],
                             row_type=T.row(["x"], [T.BIGINT]))
    assert ArrowStreamOperator(node, "cpu").get_output() is b
    with pytest.raises(ValueError, match="query runs on meta"):
        ArrowStreamOperator(node, "meta").get_output()


@pytest.mark.parametrize("limit", [None, 1, 3])
def test_row_number_without_keys(limit):
    """ROW_NUMBER() OVER () over several batches: the rows numbered 1..n
    in stream order (its limit form keeps the first `limit`)."""
    rng = np.random.default_rng(5)
    tables = [_table(v=rng.integers(0, 100, n).tolist())
              for n in (120, 1, 0, 179)]
    got = _both(lambda B: B().values(tables).row_number(
        [], limit=limit).plan())
    n = 300 if limit is None else limit
    assert sorted(got.column("row_number").to_pylist()) == list(
        range(1, n + 1))

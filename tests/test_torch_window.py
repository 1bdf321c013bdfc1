"""Window, RowNumber and TopNRowNumber of the torch port against the JAX
reference (the port's counterparts of tests/test_window.py, and more).

Each plan is built by each package's own PlanBuilder (with each package's
own frame types) over the same numpy-seeded tables and run by each
package's Task. A window's output order is defined (the sorted batch), as
is RowNumber's (the input's), so the two Arrow results must hold the same
rows in the same order: integers and decimals exactly, doubles within
1e-9 relative.
"""

import decimal
import math

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import velox_tpu.exec.window as JW
from velox_tpu.common.errors import VeloxUserError as JVeloxUserError
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.common.errors import VeloxRuntimeError, VeloxUserError
from velox_tpu_torch.exec import window as W
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

CPU = QueryCtx("cpu")
REL_TOL = 1e-9


def _same_rows(got: pa.Table, want: pa.Table) -> None:
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        for i, (a, b) in enumerate(zip(g, w)):
            if isinstance(b, float) and a is not None:
                assert math.isclose(a, b, rel_tol=REL_TOL), (name, i, a, b)
            else:
                assert a == b, (name, i, a, b)


def _both(build):
    """Run ``build(PlanBuilder class, window module)``'s plan through both
    engines; return the port's table after checking it equals the
    reference's row for row."""
    want = JTask(build(JPlanBuilder, JW)).run()
    got = Task(build(PlanBuilder, W), CPU).run()
    _same_rows(got, want)
    return got


def make_df(n=400, parts=7, seed=11):
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "p": rng.randint(0, parts, n).astype("int64"),
        "o": rng.randint(0, 50, n).astype("int64"),
        "v": rng.randint(-100, 100, n).astype("int64"),
    })


def _window(df, functions, frame=None, sort_keys=("o", "v")):
    """build(B, M) of a window over ``df`` partitioned by p; ``frame`` is
    a function of the window module."""
    t = pa.table(df)

    def build(B, M):
        return (B().values([t])
                .window(["p"], list(sort_keys), functions,
                        frame=frame(M) if frame else None)
                .plan())
    return build


def test_row_number_rank_dense_rank():
    got = _both(_window(make_df(), ["row_number() as rn", "rank() as rk",
                                    "dense_rank() as dr"]))
    assert got.num_rows == 400


def test_percent_rank_cume_dist():
    _both(_window(make_df(300, 5), ["percent_rank() as pr",
                                    "cume_dist() as cd"]))


def test_ntile():
    _both(_window(make_df(100, 3), ["ntile(4) as nt", "ntile(7) as n7"]))


def test_lead_lag():
    _both(_window(make_df(200, 4), ["lead(v) as ld", "lag(v, 2) as lg",
                                    "lead(o, 3) as ld3"]))


def test_running_sum_default_frame():
    """The default frame, RANGE UNBOUNDED PRECEDING -> CURRENT ROW,
    includes peers (ties on (o, v))."""
    _both(_window(make_df(300, 5), ["sum(v) as s", "count() as c",
                                    "min(v) as mn", "max(v) as mx",
                                    "avg(v) as a"]))


def test_rows_frame_sliding():
    def frame(M):
        return M.WindowFrame(M.FrameType.ROWS, M.BoundType.PRECEDING, 2,
                             M.BoundType.FOLLOWING, 1)
    _both(_window(make_df(250, 4), [
        "sum(v) as s", "min(v) as mn", "max(v) as mx",
        "first_value(v) as fv", "last_value(v) as lv",
        "nth_value(v, 2) as nv"], frame))


def test_row_number_operator_streaming():
    """RowNumber over several batches: a running count per partition."""
    rng = np.random.RandomState(5)
    tables = [pa.table(pd.DataFrame({
        "p": rng.randint(0, 6, 100).astype("int64"),
        "v": rng.randint(0, 100, 100).astype("int64")}))
        for _ in range(3)]
    got = _both(lambda B, M: B().values(tables).row_number(["p"], "rn")
                .plan())
    assert got.num_rows == 300


def test_row_number_limit():
    df = pd.DataFrame({"p": np.repeat(np.arange(5, dtype="int64"), 20),
                       "v": np.arange(100, dtype="int64")})
    t = pa.table(df)
    got = _both(lambda B, M: B().values([t, t])
                .row_number(["p"], "rn", limit=3).plan())
    assert got.num_rows == 15


def test_top_n_row_number():
    t = pa.table(make_df(300, 6))
    got = _both(lambda B, M: B().values([t])
                .top_n_row_number(["p"], ["v DESC"], 5, "rn").plan())
    assert got.num_rows == 30


def test_rows_frame_column_valued_bounds():
    df = make_df(200, 4, seed=21)
    rng = np.random.RandomState(22)
    df["kb"] = rng.randint(0, 4, len(df)).astype("int64")
    df["kf"] = rng.randint(0, 3, len(df)).astype("int64")

    def frame(M):
        return M.WindowFrame(M.FrameType.ROWS, M.BoundType.PRECEDING, "kb",
                             M.BoundType.FOLLOWING, "kf")
    _both(_window(df, ["sum(v) as s", "count(v) as c", "min(v) as mn"],
                  frame))


@pytest.mark.parametrize("order", ["o", "o DESC"])
def test_range_frame_column_valued_bounds(order):
    """RANGE k bounds: [o - kb, o + kf] value windows, ascending and
    descending."""
    df = make_df(200, 4, seed=31)
    rng = np.random.RandomState(32)
    df["kb"] = rng.randint(0, 6, len(df)).astype("int64")
    df["kf"] = rng.randint(0, 6, len(df)).astype("int64")

    def frame(M):
        return M.WindowFrame(M.FrameType.RANGE, M.BoundType.PRECEDING, "kb",
                             M.BoundType.FOLLOWING, "kf")
    _both(_window(df, ["sum(v) as s", "max(v) as mx"], frame,
                  sort_keys=(order,)))


def test_range_frame_constant_bounds():
    def frame(M):
        return M.WindowFrame(M.FrameType.RANGE, M.BoundType.PRECEDING, 3,
                             M.BoundType.CURRENT_ROW, 0)
    _both(_window(make_df(200, 4, seed=33), ["sum(v) as s", "count() as c",
                                             "min(v) as mn"], frame,
                  sort_keys=("o",)))


def test_frame_offset_null_or_negative_raises():
    df = make_df(50, 2, seed=41)
    df["kb"] = np.int64(1)
    df.loc[3, "kb"] = -2

    def frame(M):
        return M.WindowFrame(M.FrameType.ROWS, M.BoundType.PRECEDING, "kb",
                             M.BoundType.CURRENT_ROW, 0)
    build = _window(df, ["sum(v) as s"], frame)
    with pytest.raises(JVeloxUserError):
        JTask(build(JPlanBuilder, JW)).run()
    with pytest.raises(VeloxUserError, match="negative"):
        Task(build(PlanBuilder, W), CPU).run()


def test_range_frame_composite_overflow_raises():
    """Partitions times an ORDER BY key span past int64: the composite
    would wrap, so the window raises (one flag, read at get_output)."""
    t = pa.table({"p": pa.array(np.arange(8) % 4, pa.int64()),
                  "o": pa.array([-(1 << 61), 1 << 61] * 4, pa.int64()),
                  "v": pa.array(np.arange(8), pa.int64())})

    def build(B, M):
        frame = M.WindowFrame(M.FrameType.RANGE, M.BoundType.PRECEDING, 1,
                              M.BoundType.CURRENT_ROW, 0)
        return (B().values([t]).window(["p"], ["o"], ["sum(v) as s"],
                                       frame=frame).plan())
    with pytest.raises(Exception, match="overflows"):
        JTask(build(JPlanBuilder, JW)).run()
    with pytest.raises(VeloxRuntimeError, match="overflows"):
        Task(build(PlanBuilder, W), CPU).run()


def _decimal_table(n=300, seed=51):
    rng = np.random.RandomState(seed)
    cents = rng.randint(-10 ** 6, 10 ** 6, n)
    nullable = [None if rng.rand() < 0.6 else int(x)
                for x in rng.randint(-10 ** 4, 10 ** 4, n)]
    return pa.table({
        "p": pa.array(rng.randint(0, 5, n), pa.int64()),
        "o": pa.array(rng.randint(0, 40, n), pa.int64()),
        "d": pa.array([decimal.Decimal(int(c)) / 100 for c in cents],
                      pa.decimal128(12, 2)),
        "nv": pa.array(nullable, pa.int64())})


@pytest.mark.parametrize("frame_type", ["rows", "range"])
def test_min_max_frames_over_a_decimal_and_a_nullable_column(frame_type):
    """The sparse table over a DECIMAL column and over a column with
    NULLs (a frame of NULLs only is NULL), beside count and first_value
    of the nullable column and lag of the decimal."""
    t = _decimal_table()

    def build(B, M):
        if frame_type == "rows":
            frame = M.WindowFrame(M.FrameType.ROWS, M.BoundType.PRECEDING,
                                  3, M.BoundType.CURRENT_ROW, 0)
        else:
            frame = M.WindowFrame(M.FrameType.RANGE, M.BoundType.PRECEDING,
                                  5, M.BoundType.FOLLOWING, 2)
        return (B().values([t]).window(
            ["p"], ["o"],
            ["min(d) as mn", "max(d) as mx", "min(nv) as nmn",
             "max(nv) as nmx", "count(nv) as nc", "first_value(nv) as fv",
             "lag(d) as ld"], frame=frame).plan())
    got = _both(build)
    if frame_type == "rows":
        assert got.column("nmn").null_count > 0


def test_decimal_frame_sum_is_a_long_decimal():
    """sum/avg over a DECIMAL(12, 2) frame: a DECIMAL(38, 2) sum whose
    high limb is the sign extension (negative sums included) and a
    half-up DECIMAL(12, 2) average."""
    t = _decimal_table(seed=52)

    def build(B, M):
        frame = M.WindowFrame(M.FrameType.ROWS, M.BoundType.PRECEDING, 4,
                              M.BoundType.FOLLOWING, 1)
        return (B().values([t]).window(["p"], ["o"],
                                       ["sum(d) as s", "avg(d) as a"],
                                       frame=frame).plan())
    got = _both(build)
    assert got.schema.field("s").type == pa.decimal128(38, 2)
    assert min(got.column("s").to_pylist()) < 0


def test_run_starts_and_ends_match_a_cummax_form():
    """The scatter-and-gather run bounds of ``_runs`` equal the
    reference's cummax (starts) and reversed cummin (ends) scans."""
    rng = np.random.RandomState(61)
    for n, p in ((1, 0.5), (7, 0.0), (300, 0.05), (300, 0.5), (300, 1.0)):
        flag = torch.from_numpy(rng.rand(n) < p)
        start, end = W._runs(flag)
        iota = torch.arange(n)
        f = flag | (iota == 0)
        want_start = torch.cummax(torch.where(f, iota, 0), 0).values
        nxt = torch.cat([f[1:], torch.ones(1, dtype=torch.bool)])
        want_end = torch.flip(torch.cummin(torch.flip(
            torch.where(nxt, iota, n), [0]), 0).values, [0])
        assert torch.equal(start, want_start)
        assert torch.equal(end, want_end)


def test_sparse_table_level_is_an_exact_bit_length():
    """floor(log2(length)) in integers: exact past 2^24, where float32
    rounds 2^k - 1 up to 2^k."""
    xs = [1, 2, 3, 7, 8, (1 << 24) - 1, 1 << 24, (1 << 24) + 1,
          (1 << 25) - 1, (1 << 40) + 5, (1 << 62) - 1]
    got = W._floor_log2(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [x.bit_length() - 1 for x in xs]
    assert int(np.log2(np.float32((1 << 25) - 1))) == 25  # the float form


def test_sparse_table_query_matches_numpy():
    rng = np.random.RandomState(71)
    data = rng.randint(-1000, 1000, 257)
    lo = rng.randint(0, 257, 500)
    hi = np.minimum(lo + rng.randint(0, 80, 500), 256)
    table = W._SparseTable(torch.from_numpy(data), torch.minimum)
    got = table.query(torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    want = [data[a:b + 1].min() for a, b in zip(lo, hi)]
    assert got.tolist() == want


def test_top_n_row_number_keeps_a_null_partition_apart():
    """NULL partition keys form their own partition. (The reference
    compares only the keys' data, so its NULL partition, whose data is 0,
    merges with the partition of key 0: ROADMAP C.)"""
    t = pa.table({"p": pa.array([0, 0, None, None, 0], pa.int64()),
                  "v": pa.array([5, 4, 3, 2, 1], pa.int64())})
    got = Task(PlanBuilder().values([t])
               .top_n_row_number(["p"], ["v"], 1, "rn").plan(), CPU).run()
    assert got.to_pylist() == [{"p": 0, "v": 1, "rn": 1},
                               {"p": None, "v": 2, "rn": 1}]

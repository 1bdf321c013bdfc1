"""The generic aggregation of the torch port against the JAX reference.

Covers ops/wide.py and ops/int128.py (elementwise, exact), the
aggregation operator fed the reference's own batches (carried over with
``testing.batches.batch_from_reference``), and whole plans at SF 0.01:
TPC-H Q1 (array mode, DECIMAL(38) sums and half-up avgs), a sort-mode
group-by (Q18's inner aggregate), a global aggregation, and Q6 through
the generic path. Arrow tables must be equal in value and type.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.connectors.tpch import register_tpch as jax_register_tpch
from velox_tpu.exec.aggregation import AggregationOperator as JAggOp
from velox_tpu.exec.task import Task as JTask
from velox_tpu.ops import int128 as JI
from velox_tpu.ops import wide as JW
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu.vector.device import to_arrow as jax_to_arrow
from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch import types as T
from velox_tpu_torch.exec import groupby as G
from velox_tpu_torch.exec.aggregation import AggregationOperator
from velox_tpu_torch.exec.fuse import chain_fn, collapse_chain
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.ops import int128 as I
from velox_tpu_torch.ops import radix as R
from velox_tpu_torch.ops import wide as W
from velox_tpu_torch.ops.filter_reduce import (
    FilterSumOperator, match_filter_sum,
)
from velox_tpu_torch.testing.batches import batch_from_reference
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.vector.device import (
    DeviceBatch, DeviceColumn, Dictionary, to_arrow,
)

torch.set_num_threads(1)

CPU = QueryCtx(device="cpu")
Q6_COLS = ["l_shipdate", "l_extendedprice", "l_quantity", "l_discount"]
Q6_FILTER = ("l_shipdate >= date '1994-01-01' and "
             "l_shipdate < date '1995-01-01' and "
             "l_discount between 0.05 and 0.07 and "
             "l_quantity < 24.0")


@pytest.fixture(autouse=True)
def _tpch():
    jax_register_tpch(0.01)
    register_tpch(0.01)


def _equal_tables(got: pa.Table, want: pa.Table):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    assert got.equals(want), (got.slice(0, 5).to_pylist(),
                              want.slice(0, 5).to_pylist())


# ---------------------------------------------------------------------------
# ops/int128.py and ops/wide.py, elementwise
# ---------------------------------------------------------------------------

def _limbs(seed: int, n: int = 512):
    """int128 values across the whole range as (lo, hi) int64 limbs, with
    the edges (0, -1, +-2^63, +-2^64, extremes) included."""
    rng = np.random.default_rng(seed)
    vals = [0, -1, 1, 2 ** 63, -2 ** 63, 2 ** 64 - 1, -2 ** 64,
            2 ** 127 - 1, -2 ** 127 + 5]
    vals += [int(x) * int(y) for x, y in zip(
        rng.integers(-2 ** 62, 2 ** 62, n), rng.integers(-2 ** 62, 2 ** 62,
                                                         n))]
    lo = np.array([((v % 2 ** 64) + 2 ** 63) % 2 ** 64 - 2 ** 63
                   for v in vals], np.int64)
    hi = np.array([v >> 64 for v in vals], np.int64)
    return lo, hi


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn", ["add128", "neg128", "abs128",
                                "split_parts", "combine_parts",
                                "combine_two_parts"])
def test_int128_matches_jax(fn):
    alo, ahi = _limbs(1)
    blo, bhi = _limbs(2)
    if fn == "add128":
        args = (alo, ahi, blo, bhi)
    elif fn in ("neg128", "abs128", "split_parts"):
        args = (alo, ahi)
    elif fn == "combine_parts":
        rng = np.random.default_rng(3)
        args = tuple(rng.integers(0, 2 ** 62, len(alo)) for _ in range(3)) \
            + (rng.integers(-2 ** 62, 2 ** 62, len(alo)),)
    else:
        rng = np.random.default_rng(4)
        args = (rng.integers(0, 2 ** 62, len(alo)),
                rng.integers(-2 ** 62, 2 ** 62, len(alo)))
    got = getattr(I, fn)(*_t(*args))
    want = getattr(JI, fn)(*_j(*args))
    _eq(got, want)


def test_div128_round_half_up_matches_jax():
    lo, hi = _limbs(5, 256)
    rng = np.random.default_rng(6)
    d = rng.integers(1, 2 ** 40, len(lo))
    d[:4] = [1, 2, 3, 2 ** 62]
    _eq(I.div128_round_half_up(*_t(lo, hi, d)),
        JI.div128_round_half_up(*_j(lo, hi, d)))
    # the exact quotient, rounded half away from zero
    got_lo, got_hi = I.div128_round_half_up(*_t(lo, hi, d))
    for i in range(0, len(lo), 37):
        v = (int(hi[i]) << 64) | (int(lo[i]) % 2 ** 64)
        q = (abs(v) + int(d[i]) // 2) // int(d[i])
        q = -q if v < 0 else q
        assert (int(got_hi[i]) << 64) | (int(got_lo[i]) % 2 ** 64) == q


def _runs(seed: int, n: int = 3000):
    """Sorted-run structure: boundaries, gids, a trailing inactive tail."""
    rng = np.random.default_rng(seed)
    boundary = rng.random(n) < 0.1
    boundary[0] = True
    gid = np.cumsum(boundary) - 1
    active = np.arange(n) < n - 200
    return boundary, gid, active


@pytest.mark.parametrize("combine", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_segmented_reduce_sorted_matches_jax(combine, dtype):
    boundary, gid, active = _runs(7)
    rng = np.random.default_rng(8)
    data = rng.integers(-10 ** 6, 10 ** 6, len(gid)).astype(dtype)
    n = len(gid)
    want = np.asarray(JW.segmented_reduce_sorted(
        *_j(data, gid, boundary, active), n, combine))
    got = W.segmented_reduce_sorted(*_t(data, gid, boundary, active), n,
                                    combine).numpy()
    groups = int((boundary & active).sum())
    np.testing.assert_array_equal(got[:groups], want[:groups])


@pytest.mark.parametrize("combine", ["sum", "min"])
def test_segment_scans_match_jax(combine):
    boundary, gid, active = _runs(9, 1000)
    n = len(gid)
    data = np.random.default_rng(10).normal(size=n) * 1e3
    off = W.segment_offsets(torch.from_numpy(boundary), n)
    np.testing.assert_array_equal(
        off.numpy(), np.asarray(JW.segment_offsets(jnp.asarray(boundary),
                                                   n)))
    got, gd = W.segmented_scan_values(torch.from_numpy(data), off, n,
                                      combine)
    want, wd = JW.segmented_scan_values(jnp.asarray(data),
                                        jnp.asarray(off.numpy()), n,
                                        combine)
    assert gd == wd
    # the same float64 additions in the same order: equal bit for bit
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    idx = np.where(active, gid, n)
    np.testing.assert_array_equal(
        W.scatter_unique_set(n + 1, *_t(idx, data))[:n].numpy(),
        np.asarray(JW.scatter_unique_set(n + 1, *_j(idx, data)))[:n])


@pytest.mark.parametrize("capacity", [4096, G._MASKED_MIN_ROWS])
def test_reduce_array_mode_matches_numpy(capacity):
    """Both reductions of array mode (one scatter per addend below
    _MASKED_MIN_ROWS, masked dense reduces from there) give every group's
    exact sum, min and max; a nullable dictionary key and a BOOLEAN key
    make 4 x 2 groups."""
    rng = np.random.default_rng(11)
    flag = rng.integers(0, 3, capacity).astype(np.int32)
    flag_null = rng.random(capacity) < 0.05
    status = rng.random(capacity) < 0.5
    active = rng.random(capacity) < 0.9
    big = rng.integers(-2 ** 60, 2 ** 60, capacity)
    small = rng.integers(-2 ** 30, 2 ** 30, capacity).astype(np.int32)
    keys = [EvalValue(torch.from_numpy(flag), torch.from_numpy(~flag_null),
                      T.VARCHAR, Dictionary(["A", "N", "R"])),
            EvalValue(torch.from_numpy(status), None, T.BOOLEAN)]
    domain = G.array_mode_domain(keys)
    assert domain == 8
    addends = [(torch.from_numpy(big // 8), "sum"),
               (torch.from_numpy(big), "min"),
               (torch.from_numpy(small), "max")]
    gk, gs, occupied = G.reduce_array_mode(
        keys, addends, torch.from_numpy(active), capacity, domain)
    ids = np.where(flag_null, 3, flag) * 2 + status
    for g in range(domain):
        sel = active & (ids == g)
        assert bool(occupied[g]) == bool(sel.any())
        if not sel.any():
            continue
        assert int(gs[0][g]) == int((big[sel] // 8).sum())
        assert int(gs[1][g]) == int(big[sel].min())
        assert int(gs[2][g]) == int(small[sel].max())
        assert bool(gk[0].validity[g]) == (g // 2 != 3)
        assert int(gk[1].data[g]) == g % 2


# ---------------------------------------------------------------------------
# The operator fed the reference's batches
# ---------------------------------------------------------------------------

def test_partial_step_on_the_reference_batches():
    """Q1's PARTIAL aggregation over the reference's own head batches,
    carried into the port: equal state tables (array mode, the int128
    planar parts of every decimal sum and avg)."""
    jpartial = jax_tpch_plan(1).source.source
    tpartial = tpch_plan(1).source.source
    jop, top = JAggOp(jpartial), AggregationOperator(tpartial, "cpu")
    dicts = {}
    for jb in JTask(jpartial.source).batches():
        jop.add_input(jb)
        top.add_input(batch_from_reference(jb, dictionaries=dicts))
    jop.no_more_input()
    top.no_more_input()
    want = pa.concat_tables([jax_to_arrow(b) for b in iter(jop.get_output,
                                                              None)])
    got = pa.concat_tables([to_arrow(b) for b in iter(top.get_output,
                                                      None)])
    assert got.num_rows == want.num_rows == 4
    _equal_tables(got, want)


# ---------------------------------------------------------------------------
# Whole plans at SF 0.01
# ---------------------------------------------------------------------------

def _plan(builder, kind):
    if kind == "sort_mode_q18_inner":
        return (builder().table_scan("lineitem", ["l_orderkey", "l_quantity"])
                .single_aggregation(["l_orderkey"],
                                    ["sum(l_quantity) as quantity"])
                .plan())
    if kind == "sort_mode_two_keys":
        return (builder().table_scan(
            "lineitem", ["l_suppkey", "l_shipdate", "l_quantity", "l_tax"],
            filter="l_quantity < 10.0")
            .partial_aggregation(["l_suppkey", "l_shipdate"],
                                 ["count() as n", "max(l_tax) as t",
                                  "avg(l_quantity) as q"])
            .final_aggregation().plan())
    if kind == "global":
        return (builder().table_scan(
            "lineitem", ["l_quantity", "l_extendedprice", "l_discount",
                         "l_linenumber"])
            .single_aggregation([], [
                "sum(l_quantity) as a", "avg(l_extendedprice) as b",
                "count() as c", "min(l_linenumber) as d",
                "max(l_linenumber) as e", "sum(l_linenumber) as f"])
            .plan())
    if kind == "q6_generic":
        # the `or` defeats the filter-sum matcher in both engines
        return (builder().table_scan("lineitem", Q6_COLS,
                                     filter=f"({Q6_FILTER}) or "
                                            "l_quantity < 0.0")
                .project(["l_extendedprice * l_discount as revenue"])
                .single_aggregation([], ["sum(revenue) as revenue"])
                .plan())
    raise ValueError(kind)


def test_q1_equals_reference():
    want = JTask(jax_tpch_plan(1)).run()
    pos = R.radix_pos.launches
    got = Task(tpch_plan(1), CPU).run()
    _equal_tables(got, want)
    assert got.num_rows == 4
    assert R.radix_pos.launches == pos  # plain versions on the CPU


@pytest.mark.parametrize("kind", ["sort_mode_q18_inner",
                                  "sort_mode_two_keys", "global",
                                  "q6_generic"])
def test_plans_equal_reference(kind):
    want = JTask(_plan(JPlanBuilder, kind)).run()
    got = Task(_plan(PlanBuilder, kind), CPU).run()
    assert got.num_rows > 0
    _equal_tables(got, want)


def test_rejected_batch_runs_the_generic_aggregation():
    """A batch the filter-sum kernel cannot take (an int64 column) makes
    the operator fall back to the generic aggregation, as the reference
    does, and Q6's value stays exact."""
    want = JTask(jax_tpch_plan(6)).run()
    plan = tpch_plan(6)
    chain = collapse_chain(plan.source)
    conn = register_tpch(0.01)
    stats = {c: conn.column_stats("lineitem", c) for c in Q6_COLS}
    spec = match_filter_sum(plan, chain, stats)
    assert spec is not None
    op = FilterSumOperator(plan, spec, "cpu", lambda: AggregationOperator(
        plan, "cpu", pre_fn=chain_fn(chain)))
    src = conn.create_data_source("lineitem", Q6_COLS, CPU)
    for split in conn.default_splits("lineitem"):
        b = src.next(split)
        while b is not None:
            cols = dict(b.columns)
            q = cols["l_quantity"]
            cols["l_quantity"] = DeviceColumn(q.data.long(), q.validity,
                                              q.dtype)
            assert not op._batch_ok(DeviceBatch(cols, b.mask))
            op.add_input(DeviceBatch(cols, b.mask))
            b = src.next(split)
    op.no_more_input()
    assert op._fallback is not None
    out = op.get_output()
    _equal_tables(to_arrow(out), want)


def test_storage_change_after_the_kernel_ran_raises():
    """A batch the kernel cannot take, after the kernel has summed
    earlier rows, no longer raises: the generic aggregation takes it and
    the kernel's running total is added to its result, so Q6 stays exact.
    The kernel sums the first half of the rows (a prefix mask); the rest
    arrive with an int64 column."""
    want = JTask(jax_tpch_plan(6)).run()
    plan = tpch_plan(6)
    chain = collapse_chain(plan.source)
    conn = register_tpch(0.01)
    spec = match_filter_sum(plan, chain, {
        c: conn.column_stats("lineitem", c) for c in Q6_COLS})
    op = FilterSumOperator(plan, spec, "cpu", lambda: AggregationOperator(
        plan, "cpu", pre_fn=chain_fn(chain)))
    src = conn.create_data_source("lineitem", Q6_COLS, CPU)
    splits = conn.default_splits("lineitem")
    batches = [src.next(s) for s in splits]
    first, rest = batches[0], batches[1:]
    half = torch.arange(first.capacity) < int(first.num_active()) // 2
    op.add_input(DeviceBatch(first.columns, first.mask & half))
    assert op._fallback is None and op._total is not None
    for b, mask in [(first, first.mask & ~half)] + [(b, b.mask)
                                                    for b in rest]:
        cols = dict(b.columns)
        q = cols["l_quantity"]
        cols["l_quantity"] = DeviceColumn(q.data.long(), q.validity, q.dtype)
        op.add_input(DeviceBatch(cols, mask))
    op.no_more_input()
    assert op._fallback is not None
    _equal_tables(to_arrow(op.get_output()), want)


def _long_decimal_key_plan(kind: str):
    """Group lineitem by l_orderkey into a DECIMAL(38, 2) sum, then group
    by that sum: the second group-by's key is a long decimal."""
    b = PlanBuilder().table_scan("lineitem", ["l_orderkey",
                                              "l_extendedprice"])
    if kind == "partial_final":
        return (b.partial_aggregation(["l_orderkey"],
                                      ["sum(l_extendedprice) as s"])
                .final_aggregation()
                .partial_aggregation(["s"], ["count() as n"])
                .final_aggregation().plan())
    b = (b.single_aggregation(["l_orderkey"], ["sum(l_extendedprice) as s"])
         .single_aggregation(["s"], ["count() as n"]))
    if kind == "topn":
        b = b.top_n(["s desc"], 20)
    return b.plan()


@pytest.mark.parametrize("kind", ["single", "partial_final", "topn"])
def test_long_decimal_group_keys_keep_their_high_limb(kind):
    """A DECIMAL(38) group key carries its high limb out of the sort-mode
    group-by (the reference drops it and cannot convert the result, so
    the oracle is pyarrow's group_by over the generator's columns)."""
    conn = register_tpch(0.01)
    li = conn.gen.gen_lineitem(0, conn.gen.num_rows("orders"),
                               ["l_orderkey", "l_extendedprice"])
    sums = (pa.table({"k": li["l_orderkey"].astype(np.int64),
                      "p": li["l_extendedprice"].astype(np.int64)})
            .group_by("k").aggregate([("p", "sum")]))
    counts = sums.group_by("p_sum").aggregate([("p_sum", "count")])
    want = sorted(zip(counts["p_sum"].to_pylist(),
                      counts["p_sum_count"].to_pylist()))
    got = Task(_long_decimal_key_plan(kind), CPU).run()
    assert got.schema.field("s").type == pa.decimal128(38, 2)
    rows = [(int(r["s"].scaleb(2)), r["n"]) for r in got.to_pylist()]
    if kind == "topn":
        assert rows == sorted(want, reverse=True)[:20]
    else:
        assert sorted(rows) == want


@pytest.mark.parametrize("agg", ["approx_distinct(l_quantity)",
                                 "stddev(l_quantity)"])
def test_unported_aggregates_raise(agg):
    """Two aggregates that raised before they were ported: they now run,
    and give the reference's value over SF 0.01's lineitem."""
    jax_register_tpch(0.01)
    register_tpch(0.01)
    got, want = (
        run(B().table_scan("lineitem", ["l_quantity"])
            .single_aggregation([], [f"{agg} as x"]).plan())
        .column("x")[0].as_py()
        for B, run in ((PlanBuilder, lambda p: Task(p, CPU).run()),
                       (JPlanBuilder, lambda p: JTask(p).run())))
    assert got == pytest.approx(want, rel=1e-9)


def test_global_min_max_of_a_narrowed_decimal_are_exact():
    """l_quantity is DECIMAL(12,2) stored as int32: the min/max state
    widens to the type's int64, so padding rows masked to the identity
    never win. (The reference masks with an int64 identity kept in the
    column's int32 and returns -0.01 for this min; ROADMAP.md C.)"""
    conn = register_tpch(0.01)
    q = conn.gen.gen_lineitem(0, conn.gen.num_rows("orders"),
                              ["l_quantity"])["l_quantity"]
    got = Task(PlanBuilder().table_scan("lineitem", ["l_quantity"])
               .single_aggregation([], ["min(l_quantity) as mn",
                                        "max(l_quantity) as mx"]).plan(),
               CPU).run().to_pylist()[0]
    assert int(got["mn"].scaleb(2)) == int(q.min()) == 100
    assert int(got["mx"].scaleb(2)) == int(q.max()) == 5000


def _long_decimal_table(seed: int, n: int = 3000) -> pa.Table:
    """DECIMAL(38,2) values with nonzero high limbs, negatives, pairs whose
    low limbs are equal (v and v + 2^64 cents), and NULLs, in 13 groups;
    group 12 is all NULL."""
    import decimal
    rng = np.random.default_rng(seed)
    big = [int(x) * 10 ** 20 + int(y) for x, y in zip(
        rng.integers(-10 ** 15, 10 ** 15, n), rng.integers(0, 10 ** 12, n))]
    vals = [b if i % 3 else int(rng.integers(-10 ** 6, 10 ** 6))
            for i, b in enumerate(big)]
    for i in range(0, n, 7):  # equal low limbs, one 2^64 apart
        vals[i] = vals[i - 1] + (1 << 64) if i else -1
    keys = rng.integers(0, 12, n)
    valid = rng.random(n) > 0.1
    keys[:40] = 12
    valid[:40] = False
    return pa.table({
        "k": pa.array(keys, pa.int64()),
        "v": pa.array([decimal.Decimal(x).scaleb(-2) if ok else None
                       for x, ok in zip(vals, valid)],
                      pa.decimal128(38, 2)),
        "w": pa.array(rng.normal(size=n), pa.float64()),
    })


def _cents(col):
    return [None if x is None else int(x.scaleb(2)) for x in col]


@pytest.mark.parametrize("grouped", [True, False])
def test_min_max_of_long_decimals_equal_python(grouped):
    """min/max over DECIMAL(38) (the collect pathway: rows sorted by
    (group, value) through the radix sort), grouped and global, against
    Python ints and against the reference."""
    t = _long_decimal_table(0)
    keys = ["k"] if grouped else []

    def build(B):
        return (B().values([t, t.slice(100, 900)])
                .single_aggregation(keys, ["min(v) as lo", "max(v) as hi",
                                           "count(v) as n"]).plan())
    got = Task(build(PlanBuilder), CPU).run()
    want = JTask(build(JPlanBuilder)).run()
    assert got.schema.field("lo").type == pa.decimal128(38, 2)
    rows = sorted(zip(*(got.column(c).to_pylist() for c in got.column_names)),
                  key=lambda r: r[0] if grouped else 0)
    wrows = sorted(zip(*(want.column(c).to_pylist()
                         for c in want.column_names)),
                   key=lambda r: r[0] if grouped else 0)
    assert rows == wrows
    full = pa.concat_tables([t, t.slice(100, 900)])
    ks = full.column("k").to_pylist()
    vs = _cents(full.column("v").to_pylist())
    groups = {}
    for key, v in zip(ks, vs):
        groups.setdefault(key if grouped else 0, []).append(v)
    for key, members in groups.items():
        present = [v for v in members if v is not None]
        row = [r for r in rows if not grouped or r[0] == key]
        assert len(row) == 1
        lo, hi = _cents(row[0][-3:-1])
        if present:
            assert (lo, hi) == (min(present), max(present)), key
        else:
            assert lo is None and hi is None
    assert any(v is not None and v < 0 for v in vs)


def test_global_min_max_of_long_decimals_over_no_passing_row_is_null():
    t = _long_decimal_table(1, 500)
    plan = (PlanBuilder().values([t]).filter("k > 100")
            .single_aggregation([], ["max(v) as hi"]).plan())
    got = Task(plan, CPU).run()
    assert got.num_rows == 1 and got.column("hi").null_count == 1


@pytest.mark.parametrize("fn", ["min_by", "max_by"])
def test_min_by_max_by_equal_reference(fn):
    t = _long_decimal_table(2, 2000)

    def build(B):
        return (B().values([t])
                .single_aggregation(["k"], [f"{fn}(v, w) as x",
                                            f"{fn}(w, v) as y",
                                            "sum(w) as s"]).plan())
    got = Task(build(PlanBuilder), CPU).run()
    want = JTask(build(JPlanBuilder)).run()
    assert got.schema == want.schema
    key = got.column_names.index("k")
    assert sorted(zip(*(got.column(c).to_pylist()
                        for c in got.column_names)),
                  key=lambda r: r[key]) == \
        sorted(zip(*(want.column(c).to_pylist() for c in want.column_names)),
               key=lambda r: r[key])


def test_long_decimal_min_is_single_step_only():
    t = _long_decimal_table(3, 100)
    plan = (PlanBuilder().values([t])
            .partial_aggregation(["k"], ["min(v) as lo"])
            .final_aggregation().plan())
    with pytest.raises(NotImplementedError, match="single-step"):
        Task(plan, CPU).run()


@pytest.mark.parametrize("agg", ["array_agg(k)", "approx_percentile(w, 0.5)"])
def test_other_collect_aggregates_raise_naming_the_roadmap(agg):
    """The collect aggregates once in this list now run: array_agg (its
    ARRAY result came with the complex types) equals the reference, and
    approx_percentile is exact in a single step."""
    t = _long_decimal_table(4, 10)

    def plan(B):
        return B().values([t]).single_aggregation([], [f"{agg} as x"]).plan()
    got = Task(plan(PlanBuilder), CPU).run().column("x").to_pylist()
    if agg.startswith("array_agg"):
        assert got == JTask(plan(JPlanBuilder)).run().column("x").to_pylist()
        assert got == [t.column("k").to_pylist()]
        return
    w = np.sort(np.asarray(t.column("w")))
    assert got == [w[4]]


def test_sorted_group_info_vals_matches_reference():
    """The (group, value) sort of the collect pathway: the same stable
    permutation, group ids and group boundaries as the reference's, over an
    int64 key with NULLs and a DECIMAL(38) value with NULLs and equal low
    limbs."""
    from velox_tpu import types as JT
    from velox_tpu.exec import groupby as JG
    from velox_tpu.expression.eval import EvalValue as JEvalValue
    from velox_tpu.vector.device import DeviceColumn as JDeviceColumn
    rng = np.random.default_rng(11)
    cap = 3000
    keys = rng.integers(-5, 5, cap)
    kvalid = rng.random(cap) > 0.1
    vals = [int(x) * (1 << 64) + int(y) for x, y in zip(
        rng.integers(-3, 3, cap), rng.integers(0, 4, cap))]
    lo = np.array([((v & (2 ** 64 - 1)) ^ 2 ** 63) - 2 ** 63 for v in vals],
                  np.int64)
    hi = np.array([v >> 64 for v in vals], np.int64)
    vvalid = rng.random(cap) > 0.1
    active = rng.random(cap) > 0.05
    dt38 = T.decimal(38, 2)
    tkey = EvalValue(torch.from_numpy(keys), torch.from_numpy(kvalid),
                     T.BIGINT)
    tval = EvalValue(torch.from_numpy(lo), torch.from_numpy(vvalid), dt38,
                     children=(DeviceColumn(torch.from_numpy(hi), None,
                                            T.BIGINT),))
    jkey = JEvalValue(jnp.asarray(keys), jnp.asarray(kvalid), JT.BIGINT)
    jval = JEvalValue(jnp.asarray(lo), jnp.asarray(vvalid),
                      JT.decimal(38, 2),
                      children=(JDeviceColumn(jnp.asarray(hi), None,
                                              JT.BIGINT, None),))
    got = G.sorted_group_info_vals([tkey], [tval], torch.from_numpy(active),
                                   cap)
    want = JG.sorted_group_info_vals([jkey], [jval], jnp.asarray(active),
                                     cap)
    assert len(got) == 6
    for g, w, what in zip(got, want, ("perm", "gid", "boundary", "active",
                                      "groups", "value runs")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=what)
    assert 1 < int(got[4]) < cap


def test_long_decimal_max_sorts_through_the_radix_kernels(monkeypatch):
    """The DECIMAL(38) max's (group, value) sort exceeds 64 bits with the
    row id, so it runs the classic loop: B4 and B2's rank-and-scatter form
    a pass (B4 and B2 on the card)."""
    from velox_tpu_torch.exec import sort as S
    calls = {"hist": 0, "rank_scatter": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(S, "radix_hist", counted("hist", S.radix_hist))
    monkeypatch.setattr(S, "radix_rank_scatter",
                        counted("rank_scatter", S.radix_rank_scatter))
    t = _long_decimal_table(5, 700)
    got = Task(PlanBuilder().values([t])
               .single_aggregation([], ["max(v) as hi"]).plan(), CPU).run()
    present = [v for v in _cents(t.column("v").to_pylist()) if v is not None]
    assert _cents(got.column("hi").to_pylist()) == [max(present)]
    # the active and validity words and four 32-bit value words: 18
    # classic passes, plus the skeleton's one-bit sort (the scatter branch)
    assert calls["rank_scatter"] == 18
    assert calls["hist"] == calls["rank_scatter"] + 1

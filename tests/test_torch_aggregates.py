"""The aggregates of the torch port against the JAX reference: the
counterparts of tests/test_functions.py's aggregate tests,
tests/test_collect_aggs.py's scalar kinds and
tests/test_approx_percentile_merge.py (its distributed test waits for the
exchange, ROADMAP A.10), plus the HLL hash and bit length, the moments'
NULL and constant groups, first/last and the eight names with ARRAY or
MAP results.

Each plan is built by each package's own PlanBuilder over the same
pyarrow tables and run by each package's Task. Integers and decimals
must be equal; doubles within 1e-9 relative, unless stated.
"""

import math

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import velox_tpu.exec.hashtable as JH
import velox_tpu.types as JT
from velox_tpu.exec.task import QueryCtx as JQueryCtx
from velox_tpu.exec.task import Task as JTask
from velox_tpu.expression.eval import EvalValue as JEvalValue
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.vector.device import Dictionary as JDictionary
from velox_tpu_torch import types as T
from velox_tpu_torch.common.errors import VeloxUserError
from velox_tpu_torch.core.config import QueryConfig
from velox_tpu_torch.exec import hashtable as H
from velox_tpu_torch.exec.aggregation import AggregationOperator
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.functions import aggregates as A
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.vector.device import Dictionary

torch.set_num_threads(1)

CPU = QueryCtx("cpu")
RTOL = 1e-9


def _sorted_rows(table: pa.Table):
    cols = table.column_names
    rows = list(zip(*(table.column(c).to_pylist() for c in cols)))
    return sorted(rows, key=lambda r: tuple(
        (v is None, v if v is not None else 0) for v in r))


def _same(got: pa.Table, want: pa.Table, rtol: float = RTOL):
    assert got.schema == want.schema
    g, w = _sorted_rows(got), _sorted_rows(want)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for a, b in zip(rg, rw):
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=rtol, abs=0,
                                          nan_ok=True), (rg, rw)
            else:
                assert a == b, (rg, rw)


def _both(build, rtol: float = RTOL, config=None):
    """``build(PlanBuilder class)``'s plan through both engines; returns
    the port's table after holding it to the reference's."""
    want = JTask(build(JPlanBuilder),
                 JQueryCtx(dict(config)) if config else None).run()
    got = Task(build(PlanBuilder), QueryCtx("cpu", config)).run()
    _same(got, want, rtol)
    return got


def agg_df(n=200, seed=0):
    rng = np.random.RandomState(seed)
    return pd.DataFrame({
        "g": rng.randint(0, 8, n).astype("int64"),
        "x": rng.randn(n) * 10,
        "i": rng.randint(-100, 100, n).astype("int64"),
        "b": rng.rand(n) > 0.5,
    })


def _single(t, keys, aggs):
    tables = t if isinstance(t, list) else [t]
    return lambda B: (B().values(tables).single_aggregation(keys, aggs)
                      .plan())


# ---- counterparts of tests/test_functions.py ------------------------------

def test_variance_stddev():
    df = agg_df()
    got = _both(_single(pa.table(df), ["g"], [
        "var_samp(x) as vs", "var_pop(x) as vp", "stddev(x) as sd",
        "stddev_pop(x) as sp", "variance(x) as v",
        "stddev_samp(x) as ss"])).to_pandas().sort_values("g")
    e = df.groupby("g").x.agg(["var", lambda s: s.var(ddof=0), "std",
                               lambda s: s.std(ddof=0)])
    np.testing.assert_allclose(got.vs, e.iloc[:, 0], rtol=1e-6)
    np.testing.assert_allclose(got.vp, e.iloc[:, 1], rtol=1e-6)
    np.testing.assert_allclose(got.sd, e.iloc[:, 2], rtol=1e-6)
    np.testing.assert_allclose(got.sp, e.iloc[:, 3], rtol=1e-6)


def test_count_if_bool():
    df = agg_df()
    got = _both(_single(pa.table(df), ["g"], [
        "count_if(b) as ci", "bool_and(b) as ba", "bool_or(b) as bo",
        "every(b) as ev"])).to_pandas().sort_values("g")
    e = df.groupby("g").b.agg(["sum", "all", "any"])
    np.testing.assert_array_equal(got.ci, e["sum"])
    np.testing.assert_array_equal(got.ba, e["all"])
    np.testing.assert_array_equal(got.bo, e["any"])
    np.testing.assert_array_equal(got.ev, e["all"])


@pytest.mark.parametrize("xt", ["int32", "float32", "date", "string",
                                "bool", "int16"])
def test_min_max_by(xt):
    """The packed 32-bit pair: every packable kind of x round-trips bit
    for bit (REAL through its int32 bits)."""
    rng = np.random.RandomState(4)
    n = 300
    xs = rng.randint(-1000, 1000, n)
    x = {"int32": pa.array(xs.astype("int32")),
         "float32": pa.array((xs / 7.0).astype("float32")),
         "date": pa.array(xs.astype("int32") + 9000, pa.date32()),
         "string": pa.array([f"v{v}" for v in xs]),
         "bool": pa.array(xs > 0),
         "int16": pa.array(xs.astype("int16"))}[xt]
    t = pa.table({"g": pa.array(rng.randint(0, 6, n), pa.int64()), "x": x,
                  "y": pa.array(rng.permutation(n).astype("int32"))})
    got = _both(_single(t, ["g"], ["min_by(x, y) as mb",
                                   "max_by(x, y) as xb"]))
    df = t.to_pandas()
    for g, mb, xb in zip(*(got.column(c).to_pylist()
                           for c in ("g", "mb", "xb"))):
        s = df[df.g == g]
        assert mb == s.x.iloc[s.y.values.argmin()]
        assert xb == s.x.iloc[s.y.values.argmax()]


def test_min_max_by_ties_and_nulls():
    t = pa.table({
        "g": pa.array([1, 1, 1, 2, 2, 3], pa.int64()),
        "x": pa.array([7, 3, None, 5, 9, 4], pa.int32()),
        "y": pa.array([2, 2, 1, None, 8, None], pa.int32())})
    _both(_single(t, ["g"], ["min_by(x, y) as mb", "max_by(x, y) as xb"]))
    _both(_single(t, [], ["min_by(x, y) as mb", "max_by(x, y) as xb"]))


def test_arbitrary():
    df = agg_df(100)
    got = _both(_single(pa.table(df), ["g"], [
        "arbitrary(i) as a", "any_value(i) as av", "count() as c"]))
    for g, a in zip(got.column("g").to_pylist(),
                    got.column("a").to_pylist()):
        assert a in set(df[df.g == g].i)


def test_approx_distinct():
    rng = np.random.RandomState(11)
    n = 4000
    df = pd.DataFrame({
        "g": rng.randint(0, 4, n).astype("int64"),
        "x": rng.randint(0, 700, n).astype("int64"),
    })
    got = _both(_single(pa.table(df), ["g"], [
        "approx_distinct(x) as ad", "count() as c"])).to_pandas() \
        .sort_values("g")
    exp = df.groupby("g").x.nunique()
    rel = np.abs(got.ad.to_numpy() - exp.to_numpy()) / exp.to_numpy()
    assert (rel < 0.20).all(), (got.ad.tolist(), exp.tolist())


def test_approx_distinct_global_and_small():
    df = pd.DataFrame({"x": np.arange(37, dtype="int64")})
    got = _both(_single(pa.table(df), [], ["approx_distinct(x) as ad"]))
    assert abs(got.column("ad")[0].as_py() - 37) <= 3


@pytest.mark.parametrize("mode", ["array", "sort", "split", "global_split"])
def test_approx_distinct_vector_states(mode):
    """The (groups x 512) register state through array mode (a
    dictionary key), sort mode (an integer key), the partial/final split
    and a global split, over several batches, equal to the reference."""
    rng = np.random.RandomState(5)
    tables = []
    for _ in range(3):
        n = 1500
        tables.append(pa.table({
            "k": pa.array(rng.randint(0, 9, n), pa.int64()),
            "s": pa.array([f"c{v}" for v in rng.randint(0, 3, n)]),
            "x": pa.array(rng.randint(0, 5000, n), pa.int64()),
        }))
    keys = {"array": ["s"], "sort": ["k"], "split": ["k"],
            "global_split": []}[mode]

    def build(B):
        b = B().values(tables)
        if mode.endswith("split"):
            return (b.partial_aggregation(keys, ["approx_distinct(x) as d"])
                    .final_aggregation().plan())
        return b.single_aggregation(keys, ["approx_distinct(x) as d",
                                           "sum(x) as t"]).plan()
    _both(build)


def test_partial_aggregation_abandonment():
    """High-cardinality PARTIAL: correct by default, and with low
    thresholds it abandons grouping and passes rows through."""
    rng = np.random.RandomState(2)
    dfs = [pd.DataFrame({
        "k": np.arange(i * 3000, (i + 1) * 3000, dtype="int64"),
        "v": rng.randint(0, 10, 3000).astype("int64")})
        for i in range(4)]

    def build(B):
        return (B().values([pa.table(d) for d in dfs])
                .partial_aggregation(["k"], ["sum(v) as s"])
                .final_aggregation()
                .single_aggregation([], ["sum(s) as total", "count() as n"])
                .plan())
    allv = pd.concat(dfs)
    got = _both(build)
    assert got.column("total")[0].as_py() == allv.v.sum()
    assert got.column("n")[0].as_py() == 12000
    config = {QueryConfig.ABANDON_PARTIAL_AGG_MIN_ROWS: 1000,
              QueryConfig.AGG_COMPACT_THRESHOLD: 2}
    got = _both(build, config=config)
    assert got.column("n")[0].as_py() == 12000
    task = Task(build(PlanBuilder), QueryCtx("cpu", config))
    task.run()
    partials = [op for op in task.operators
                if isinstance(op, AggregationOperator)
                and op.abandoned_at is not None]
    assert len(partials) == 1
    rows, groups, batches = partials[0].abandoned_at
    assert (rows, groups, batches) == (6000, 6000, 2)
    assert partials[0].passthrough_batches == 2


def test_abandonment_keeps_grouping_when_it_reduces():
    rng = np.random.RandomState(3)
    dfs = [pd.DataFrame({"k": rng.randint(0, 5, 3000).astype("int64"),
                         "v": rng.randint(0, 10, 3000).astype("int64")})
           for _ in range(4)]

    def build(B):
        return (B().values([pa.table(d) for d in dfs])
                .partial_aggregation(["k"], ["sum(v) as s", "count() as c"])
                .final_aggregation().plan())
    config = {QueryConfig.ABANDON_PARTIAL_AGG_MIN_ROWS: 1000,
              QueryConfig.AGG_COMPACT_THRESHOLD: 2}
    _both(build, config=config)
    task = Task(build(PlanBuilder), QueryCtx("cpu", config))
    task.run()
    assert all(getattr(op, "abandoned_at", None) is None
               for op in task.operators)


# ---- counterparts of tests/test_collect_aggs.py ---------------------------

def test_approx_percentile_exact_vs_numpy():
    rng = np.random.RandomState(11)
    g = rng.randint(0, 5, 500)
    x = rng.randint(-1000, 1000, 500).astype(np.int64)
    t = pa.table({"g": pa.array(g, pa.int64()),
                  "x": pa.array(x, pa.int64())})
    for p in (0.25, 0.5, 0.9):
        got = _both(_single(t, ["g"], [f"approx_percentile(x, {p}) as q"]))
        for gv, q in zip(got.column("g").to_pylist(),
                         got.column("q").to_pylist()):
            vals = np.sort(x[g == gv])
            assert q == vals[max(0, math.ceil(p * len(vals)) - 1)]


def test_collect_global_and_empty():
    t = pa.table({
        "g": pa.array([1, 2, 1, 1, 2, 3, 1], pa.int64()),
        "x": pa.array([5, 1, 5, None, 2, 9, 3], pa.int64()),
    })
    got = _both(_single(t, [], ["approx_percentile(x, 0.5) as p50",
                                "mode(x) as m", "count(x) as c"]))
    assert got.to_pylist() == [{"p50": 3, "m": 5, "c": 6}]
    got = _both(_single(t, [], [
        "approx_percentile(x, 0.5) filter (where x > 100) as p",
        "mode(x) filter (where x > 100) as m"]))
    assert got.to_pylist() == [{"p": None, "m": None}]


def test_mode():
    t = pa.table({"g": pa.array([1, 1, 1, 2, 2, 2, 2], pa.int64()),
                  "x": pa.array([5, 5, 9, 7, None, 3, 3], pa.int64())})
    got = _both(_single(t, ["g"], ["mode(x) as m"]))
    assert sorted(got.to_pylist(), key=lambda r: r["g"]) == [
        {"g": 1, "m": 5}, {"g": 2, "m": 3}]


def test_mode_ties_take_the_smallest_value():
    rng = np.random.RandomState(8)
    t = pa.table({"g": pa.array(rng.randint(0, 20, 2000), pa.int64()),
                  "x": pa.array(rng.randint(0, 12, 2000), pa.int64())})
    got = _both(_single(t, ["g"], ["mode(x) as m"]))
    df = t.to_pandas()
    for gv, m in zip(got.column("g").to_pylist(),
                     got.column("m").to_pylist()):
        counts = df[df.g == gv].x.value_counts()
        assert m == min(counts[counts == counts.max()].index)


def test_min_by_double_key_with_nulls():
    df = pd.DataFrame({
        "g": [0, 0, 0, 1, 1, 2],
        "x": [10.5, 20.5, 30.5, 1.5, 2.5, 9.0],
        "y": [3.0, None, 1.0, 5.0, 4.0, None],
    })
    got = _both(_single(pa.table(df), ["g"], ["min_by(x, y) as mn"]))
    rows = sorted(got.to_pylist(), key=lambda r: r["g"])
    assert [r["mn"] for r in rows] == [30.5, 2.5, None]


# ---- counterparts of tests/test_approx_percentile_merge.py ----------------

def _split(tables, keys, agg):
    return lambda B: (B().values(tables).partial_aggregation(keys, [agg])
                      .final_aggregation().plan())


def test_partial_final_exact_when_under_k():
    rng = np.random.RandomState(3)
    dfs = [pd.DataFrame({
        "g": rng.randint(0, 8, 500).astype("int64"),
        "x": rng.randint(0, 10_000, 500).astype("int64")})
        for _ in range(3)]
    got = _both(_split([pa.table(d) for d in dfs], ["g"],
                       "approx_percentile(x, 0.5) as q")).to_pandas() \
        .sort_values("g").reset_index(drop=True)
    allv = pd.concat(dfs)

    def exact(s):
        v = np.sort(s.to_numpy())
        return v[int(np.ceil(0.5 * len(v))) - 1]

    exp = allv.groupby("g").x.apply(exact).reset_index()
    np.testing.assert_array_equal(got.g, exp.g)
    np.testing.assert_array_equal(got.q, exp.x)


def test_partial_final_error_bound_large_group():
    n = 100_000
    rng = np.random.RandomState(11)
    x = rng.permutation(n).astype("int64")  # values are ranks - 1
    dfs = [pd.DataFrame({"x": x[i::4]}) for i in range(4)]
    got = _both(_split([pa.table(d) for d in dfs], [],
                       "approx_percentile(x, 0.9) as q"))
    exact = int(np.ceil(0.9 * n)) - 1
    assert abs(got.column("q")[0].as_py() - exact) <= (n // 1024) + 1


def test_accuracy_argument_contract_fuzz():
    rng = np.random.RandomState(42)
    for trial in range(8):
        n = int(rng.randint(2_000, 40_000))
        p = float(rng.choice([0.01, 0.25, 0.5, 0.9, 0.99]))
        acc = float(rng.choice([0.2, 0.05, 0.01]))
        n_frag = int(rng.randint(1, 6))
        x = rng.permutation(n).astype("int64")
        dfs = [pd.DataFrame({"x": x[i::n_frag]}) for i in range(n_frag)]
        got = _both(_split([pa.table(d) for d in dfs], [],
                           f"approx_percentile(x, {p}, {acc}) as q"))
        err = abs(got.column("q")[0].as_py() + 1 - int(np.ceil(p * n))) / n
        assert err <= acc + 1.0 / n, (trial, n, p, acc, n_frag, err)


def test_accuracy_argument_grouped():
    rng = np.random.RandomState(7)
    df = pd.DataFrame({
        "g": rng.randint(0, 4, 20_000).astype("int64"),
        "x": rng.randint(0, 10**6, 20_000).astype("int64")})
    got = _both(_split([pa.table(df)], ["g"],
                       "approx_percentile(x, 0.5, 0.04) as q")).to_pandas()
    for g, grp in df.groupby("g"):
        v = np.sort(grp.x.to_numpy())
        q = int(got[got.g == g].q.iloc[0])
        rank = int(np.searchsorted(v, q, side="right"))
        assert abs(rank - int(np.ceil(0.5 * len(v)))) / len(v) \
            <= 0.04 + 1e-9


def test_accuracy_argument_validation():
    t = pa.table(pd.DataFrame({"x": np.arange(10, dtype="int64")}))
    plan = _split([t], [], "approx_percentile(x, 0.5, 1.5) as q")(
        PlanBuilder)
    with pytest.raises(VeloxUserError):
        Task(plan, CPU).run()


# ---- the hash, the bit length, moments, first/last, ARRAY/MAP results ------

def _key_values(kind, rng, n):
    """(port EvalValue, reference EvalValue) of one key kind with NULLs."""
    import jax.numpy as jnp
    valid = rng.random(n) > 0.2
    jdict = tdict = None
    if kind == "bigint":
        data, tt, jt = rng.integers(-2**62, 2**62, n), T.BIGINT, JT.BIGINT
    elif kind == "integer":
        data = rng.integers(-2**31, 2**31, n).astype(np.int32)
        tt, jt = T.INTEGER, JT.INTEGER
    elif kind == "date":
        data = rng.integers(0, 20000, n).astype(np.int32)
        tt, jt = T.DATE, JT.DATE
    elif kind == "double":
        data = rng.normal(size=n) * 1e6
        data[:3] = [0.0, -0.0, np.inf]
        tt, jt = T.DOUBLE, JT.DOUBLE
    elif kind == "real":
        data = (rng.normal(size=n) * 1e3).astype(np.float32)
        tt, jt = T.REAL, JT.REAL
    elif kind == "boolean":
        data, tt, jt = rng.random(n) > 0.5, T.BOOLEAN, JT.BOOLEAN
    elif kind == "decimal":
        data = rng.integers(-10**17, 10**17, n)
        tt, jt = T.decimal(18, 2), JT.decimal(18, 2)
    else:  # a dictionary string
        values = sorted(f"s{i}" for i in range(50))
        data = rng.integers(0, 50, n).astype(np.int32)
        tt, jt = T.VARCHAR, JT.VARCHAR
        tdict, jdict = Dictionary(values), JDictionary(values)
    tv = EvalValue(torch.from_numpy(np.asarray(data)),
                   torch.from_numpy(valid), tt, tdict)
    jv = JEvalValue(jnp.asarray(data), jnp.asarray(valid), jt, jdict)
    return tv, jv


def test_hash_rows_equals_reference_bit_for_bit():
    """Every HLL register depends on it: each key kind alone, with NULLs,
    and all of them together."""
    kinds = ["bigint", "integer", "date", "double", "real", "boolean",
             "decimal", "varchar"]
    rng = np.random.default_rng(17)
    n = 777
    pairs = [_key_values(k, rng, n) for k in kinds]
    for tv, jv in pairs + [(None, None)]:
        tk = [tv] if tv is not None else [p[0] for p in pairs]
        jk = [jv] if jv is not None else [p[1] for p in pairs]
        got = H.hash_rows(tk, n).numpy()
        want = np.asarray(JH.hash_rows(jk, n)).astype(np.int64)
        np.testing.assert_array_equal(got, want)


# the values below 2^23 where floor(log2(float32(w))) + 1 is not w's bit
# length (the reference's ApproxDistinctAgg.map_raw)
_FLOAT32_FAULTS = [8192, 32768, 2_097_151, 4_194_303] + list(
    range(8_388_601, 8_388_608))


def test_hll_bit_length_is_exact():
    w = np.array(_FLOAT32_FAULTS + [0, 1, 2, 3, 4, 8191, 8193, 2**23 - 1,
                                    2**32 - 1], np.int64)
    got = A.bit_length(torch.from_numpy(w)).tolist()
    assert got == [int(v).bit_length() for v in w]
    # the reference's float32 form, run by JAX, is wrong at every one of
    # the faults
    import jax.numpy as jnp
    f32 = np.asarray(jnp.floor(jnp.log2(jnp.maximum(
        jnp.asarray(w[:11]), 1).astype(jnp.float32))).astype(jnp.int32) + 1)
    assert all(int(a) != int(v).bit_length() for a, v in zip(f32, w[:11]))


def test_moments_with_null_and_constant_groups():
    """skewness/kurtosis: a group of NULLs, a constant group (no
    variance: NULL), groups below 3 and 4 rows, and a decimal input."""
    t = pa.table({
        "g": pa.array([1, 1, 1, 2, 2, 2, 2, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5],
                      pa.int64()),
        "x": pa.array([None, None, None, 4.0, 4.0, 4.0, 4.0, 1.0, 2.0,
                       1.0, 2.0, 7.0, 1.5, -2.0, 8.25, 3.0, 0.5],
                      pa.float64()),
        "d": pa.array([None, None, None, 400, 400, 400, 400, 100, 200,
                       100, 200, 700, 150, -200, 825, 300, 50],
                      pa.int64()),
    })

    def build(B):
        return (B().values([t]).project(
            ["g", "x", "cast(d as decimal(12, 2)) as d"])
            .single_aggregation(["g"], [
                "skewness(x) as sk", "kurtosis(x) as ku",
                "skewness(d) as skd", "kurtosis(d) as kud",
                "var_samp(x) as v"]).plan())
    got = _both(build)
    rows = {r["g"]: r for r in got.to_pylist()}
    assert rows[1]["sk"] is None and rows[1]["ku"] is None
    assert rows[2]["sk"] is None and rows[2]["ku"] is None  # constant
    assert rows[3]["sk"] is None  # 2 rows
    assert rows[4]["sk"] is not None and rows[4]["ku"] is None  # 3 rows
    x = np.array([1.5, -2.0, 8.25, 3.0, 0.5])
    n, m = len(x), x.mean()
    m2, m3 = ((x - m) ** 2).sum(), ((x - m) ** 3).sum()
    assert rows[5]["sk"] == pytest.approx(math.sqrt(n) * m3 / m2 ** 1.5,
                                          rel=1e-9)


def test_first_last_one_batch_equal_reference():
    rng = np.random.RandomState(9)
    n = 300
    t = pa.table({
        "g": pa.array(rng.randint(0, 7, n), pa.int64()),
        "i": pa.array(np.where(rng.rand(n) > 0.2,
                               rng.randint(-50, 50, n), None), pa.int32()),
        "b": pa.array(rng.randint(0, 10**12, n), pa.int64()),
    })
    _both(_single(t, ["g"], [
        "first(i) as f", "first_value(i) as fv", "last(i) as l",
        "last_value(i) as lv", "first(b) as fb", "last(b) as lb"]))


def test_first_last_over_batches_is_a_group_value():
    rng = np.random.RandomState(10)
    tables = [pa.table({"g": pa.array(rng.randint(0, 5, 100), pa.int64()),
                        "i": pa.array(rng.randint(0, 1000, 100),
                                      pa.int32())}) for _ in range(3)]
    got = _both(_single(tables, ["g"], ["first(i) as f", "last(i) as l"]))
    df = pd.concat([t.to_pandas() for t in tables])
    for g, f, last in zip(*(got.column(c).to_pylist()
                            for c in ("g", "f", "l"))):
        vals = set(df[df.g == g].i)
        assert f in vals and last in vals


_COMPLEX_CALLS = {
    "array_agg": "array_agg(x)", "set_agg": "set_agg(x)",
    "map_agg": "map_agg(k, x)", "multimap_agg": "multimap_agg(k, x)",
    "map_union": "map_union(m)", "histogram": "histogram(x)",
    "approx_most_frequent": "approx_most_frequent(2, x, 10)",
    "bloom_filter_agg": "bloom_filter_agg(x)"}


@pytest.mark.parametrize("name", sorted(_COMPLEX_CALLS))
def test_array_and_map_results_wait_for_complex_types(name):
    """The eight names with an ARRAY or MAP result, once waiting for the
    complex types (ROADMAP A.6), run and equal the reference: grouped
    but for bloom_filter_agg, which is global only, over NULL values,
    keys and maps (tests/test_torch_complex.py holds more cases)."""
    rng = np.random.default_rng(7)
    n = 120
    t = pa.table({
        "g": pa.array(rng.integers(0, 5, n), pa.int64()),
        "x": pa.array([None if rng.random() < 0.1 else int(v)
                       for v in rng.integers(0, 9, n)], pa.int64()),
        "k": pa.array([None if rng.random() < 0.1 else "kqz"[i]
                       for i in rng.integers(0, 3, n)]),
        "m": pa.array([None if rng.random() < 0.1 else
                       {"kqz"[int(i)]: int(i) for i in rng.integers(0, 3, 2)}
                       for _ in range(n)], pa.map_(pa.string(), pa.int64())),
    })
    keys = [] if name == "bloom_filter_agg" else ["g"]
    got = _both(_single(t, keys, [f"{_COMPLEX_CALLS[name]} as r"]))
    assert isinstance(A.resolve_aggregate(
        name, [t.schema.field("m").type if name == "map_union" else T.BIGINT,
               T.BIGINT]), A.CollectAgg)
    assert got.num_rows == (1 if not keys else 5)


@pytest.mark.parametrize("split", [False, True])
def test_percentile_and_mode_of_a_long_decimal_keep_the_high_limb(split):
    """DECIMAL(38) values beyond one limb: the port's results carry both
    limbs (the reference's raise IndexError there, ROADMAP C), held to a
    Python oracle."""
    import decimal
    rng = np.random.default_rng(3)
    n = 600
    g = rng.integers(0, 4, n)
    vals = [int(a) * 10 ** 20 + int(b) for a, b in zip(
        rng.integers(-50, 50, n), rng.integers(0, 3, n))]
    t = pa.table({"g": pa.array(g, pa.int64()),
                  "v": pa.array([decimal.Decimal(x).scaleb(-2)
                                 for x in vals], pa.decimal128(38, 2))})
    if split:
        plan = _split([t.slice(0, 300), t.slice(300)], ["g"],
                      "approx_percentile(v, 0.3) as p")(PlanBuilder)
    else:
        plan = _single(t, ["g"], ["approx_percentile(v, 0.3) as p",
                                  "mode(v) as m"])(PlanBuilder)
    got = {r["g"]: r for r in Task(plan, CPU).run().to_pylist()}
    for k in range(4):
        vs = sorted(v for v, gg in zip(vals, g) if gg == k)
        want = vs[math.ceil(0.3 * len(vs)) - 1]
        assert int(got[k]["p"].scaleb(2)) == want
        if not split:
            counts = {}
            for v in vs:
                counts[v] = counts.get(v, 0) + 1
            top = max(counts.values())
            assert int(got[k]["m"].scaleb(2)) == min(
                v for v, c in counts.items() if c == top)

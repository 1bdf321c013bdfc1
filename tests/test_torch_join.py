"""The torch port's hash join (exec/join.py) against the JAX reference.

The same numpy-seeded tables go through both packages and the Arrow
results must be equal, rows in the same order: both engines emit probe
rows in probe order, expansion candidates in sorted build order and the
right phase in build order. Covered: every join type x {unique, duplicate}
build keys x {no nulls, nulls}, in array mode over the build's own key
range (Values tables have no stats), through the merge-rank (the domain
cap lowered) and in array mode with a given key range (the operators
driven directly); the array-mode boundaries; filtered joins; packable
multi-key, two-BIGINT wide keys; multi-chunk expansion; null-aware anti
joins; the array-mode tables; TPC-H Q3 and Q18 at SF 0.01. The probe's
gathers run B5's plain version here, so no kernel launch is counted.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.connectors.tpch import register_tpch as jax_register_tpch
from velox_tpu.exec import join as JJ
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu.vector import device as JD
from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch.exec import join as J
from velox_tpu_torch.exec.sort import packable_words
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.ops import gather as G
from velox_tpu_torch.ops.gather import flat_gather
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.tpch.queries import q18
from velox_tpu_torch.vector import device as D

torch.set_num_threads(1)

CPU = QueryCtx("cpu")
JOIN_TYPES = ["inner", "left", "right", "full", "left_semi_filter",
              "right_semi_filter", "anti"]
# the columns each join type can output
OUTPUT = {"left_semi_filter": ["pk", "pv"], "anti": ["pk", "pv"],
          "right_semi_filter": ["bk", "bv"]}
ALL_COLS = ["pk", "pv", "bk", "bv"]


def make_tables(dup: bool, nulls: bool, seed: int = 7):
    """(probe, build) Arrow tables keyed pk / bk in [0, 150)."""
    rng = np.random.default_rng(seed)
    n_probe, n_build = 500, 200
    pk = rng.integers(0, 100, n_probe)
    bk = (rng.integers(0, 60, n_build) if dup
          else rng.permutation(150)[:n_build // 2])
    pv = rng.integers(0, 1000, n_probe)
    bv = rng.integers(0, 1000, len(bk))
    pmask = rng.random(n_probe) < 0.1 if nulls else None
    bmask = rng.random(len(bk)) < 0.1 if nulls else None
    probe = pa.table({"pk": pa.array(pk, pa.int64(), mask=pmask),
                      "pv": pa.array(pv, pa.int64())})
    build = pa.table({"bk": pa.array(bk, pa.int64(), mask=bmask),
                      "bv": pa.array(bv, pa.int64())})
    return probe, build


def _plan(builder, probe, build, jt, keys=(["pk"], ["bk"]), output=None,
          filt=None, null_aware=False):
    b = builder()
    bb = b.new_builder().values([build])
    p = (b.values([probe]).hash_join(keys[0], keys[1], bb,
                                     output=output or OUTPUT.get(jt,
                                                                 ALL_COLS),
                                     join_type=jt, filter=filt).plan())
    return dataclasses.replace(p, null_aware=True) if null_aware else p


def _assert_same(jplan, tplan):
    want = JTask(jplan).run()
    launches = flat_gather.launches
    got = Task(tplan, CPU).run()
    assert flat_gather.launches == launches
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    assert got.equals(want)
    return got


ROUTES = {"observed_range": (1, 1, 0), "merge_rank": (0, 0, 1)}


def _route_counters():
    """(array-mode, observed-range, merge-rank) builds counted so far."""
    c = M.reporter().snapshot()["counters"]
    return np.array([c.get(k, 0) for k in (
        M.K_JOIN_ARRAY_MODE_BUILDS, M.K_JOIN_OBSERVED_RANGE_BUILDS,
        M.K_JOIN_MERGE_RANK_BUILDS)])


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_types_merge_rank_equal_reference(jt, dup, nulls, route,
                                               monkeypatch):
    """Values carry no stats: the build takes array mode from its own
    keys' range, or the merge-rank where the domain cap is below that
    range; the reference's build takes the merge-rank either way."""
    probe, build = make_tables(dup, nulls)
    if route == "merge_rank":
        monkeypatch.setattr(J, "ARRAY_JOIN_MAX_DOMAIN", 8)
    before = _route_counters()
    got = _assert_same(_plan(JPlanBuilder, probe, build, jt),
                       _plan(PlanBuilder, probe, build, jt))
    assert got.num_rows > 0
    assert tuple(_route_counters() - before) == ROUTES[route]


def _keyed_tables(probe_keys, build_keys, key_type):
    """(probe, build) Arrow tables keyed pk / bk (``None`` a NULL key)."""
    def table(k, v, keys):
        return pa.table({k: pa.array(keys, key_type),
                         v: pa.array(np.arange(len(keys)), pa.int64())})
    return table("pk", "pv", probe_keys), table("bk", "bv", build_keys)


def _boundary_tables(case):
    """(probe, build, key columns, string encoding) of one boundary
    case; the domain caps are 16 and 2^21 but where BOUNDARY_CAPS says."""
    import datetime
    import decimal
    rng = np.random.default_rng(17)
    ints = [int(x) for x in rng.integers(-3, 20, 60)]
    if case in ("cap", "cap_plus_one"):
        hi = 15 if case == "cap" else 16
        build = [0, hi] + [int(x) for x in rng.integers(0, hi, 10)]
        return (*_keyed_tables(ints, build, pa.int64()), None, "dict")
    if case in ("small_domain", "small_domain_plus_one"):
        # ten rows at least 2^21 - 1 apart at the ends: within velox's
        # kArray size, and one value past it
        hi = (1 << 21) - (1 if case == "small_domain" else 0)
        build = [0, hi] + [int(x) for x in rng.integers(0, hi, 8)]
        return (*_keyed_tables(ints, build, pa.int64()), None, "dict")
    if case in ("rows_dense", "rows_sparse"):
        # ten rows over 80 values (8 a row), or over 10^7: a small build
        # far apart keeps the merge-rank
        hi = 79 if case == "rows_dense" else 10 ** 7
        build = [-30, hi - 30] + [int(x) for x in rng.integers(-30, 10, 8)]
        return (*_keyed_tables(ints, build, pa.int64()), None, "dict")
    if case == "negative":
        build = [int(x) for x in rng.permutation(np.arange(-9, 6))[:10]]
        return (*_keyed_tables(ints, build, pa.int64()), None, "dict")
    if case == "empty":
        return (*_keyed_tables(ints, [], pa.int64()), None, "dict")
    if case == "all_null":
        return (*_keyed_tables(ints, [None] * 8, pa.int64()), None, "dict")
    if case == "date":
        day = datetime.date(1998, 8, 1)
        return (*_keyed_tables(
            [day + datetime.timedelta(days=k) for k in ints],
            [day + datetime.timedelta(days=k) for k in (0, 2, 2, 7, 12)],
            pa.date32()), None, "dict")
    if case in ("short_decimal", "long_decimal"):
        # DECIMAL(38) keys non-negative: the reference's merge-rank drops
        # their high limb (test_long_decimal_keys_compare_both_limbs)
        shift = 0 if case == "short_decimal" else 3
        t = pa.decimal128(12 if case == "short_decimal" else 38, 2)
        return (*_keyed_tables(
            [decimal.Decimal(k + shift) / 100 for k in ints],
            [decimal.Decimal(k + shift) / 100 for k in (-3, 1, 1, 8, 12)],
            t), None, "dict")
    if case == "two_column":
        probe, build = _multi_key_tables(pa.int32())
        return probe, build, (["k1", "k2"], ["b1", "b2"]), "dict"
    assert case == "raw_string"
    words = [f"sku-{k:+03d}" for k in ints]
    return (*_keyed_tables(words, words[::5], pa.string()), None, "raw")


# (array-mode, observed-range, merge-rank) builds of each case
BOUNDARIES = {
    "cap": (1, 1, 0), "cap_plus_one": (0, 0, 1), "negative": (1, 1, 0),
    "empty": (0, 0, 1), "all_null": (0, 0, 1), "date": (1, 1, 0),
    "short_decimal": (1, 1, 0), "long_decimal": (0, 0, 1),
    "two_column": (0, 0, 1), "raw_string": (0, 0, 1),
    "small_domain": (1, 1, 0), "small_domain_plus_one": (0, 0, 1),
    "rows_dense": (1, 1, 0), "rows_sparse": (0, 0, 1),
}
# (ARRAY_JOIN_MAX_DOMAIN, ARRAY_JOIN_SMALL_DOMAIN) of the cases that do
# not take (16, as set)
BOUNDARY_CAPS = {
    "small_domain": (J.ARRAY_JOIN_MAX_DOMAIN, J.ARRAY_JOIN_SMALL_DOMAIN),
    "small_domain_plus_one": (J.ARRAY_JOIN_MAX_DOMAIN,
                              J.ARRAY_JOIN_SMALL_DOMAIN),
    "rows_dense": (J.ARRAY_JOIN_MAX_DOMAIN, 16),
    "rows_sparse": (J.ARRAY_JOIN_MAX_DOMAIN, 16),
}


@pytest.mark.parametrize("case", list(BOUNDARIES))
def test_array_mode_boundaries_equal_reference(case, monkeypatch):
    """Which builds take array mode from their own key range: a domain of
    exactly the cap does and one more value does not; a ten-row build
    does over 2^21 values (velox's kArray size) or 8 a row, and keeps
    the merge-rank one value past 2^21 or over 10^7 values; negative
    keys, DATE and short-DECIMAL keys do; an empty or all-NULL build, a
    DECIMAL(38), two-column or raw-string key keeps the merge-rank. A
    left join, so the empty builds still probe."""
    max_domain, small_domain = BOUNDARY_CAPS.get(
        case, (16, J.ARRAY_JOIN_SMALL_DOMAIN))
    monkeypatch.setattr(J, "ARRAY_JOIN_MAX_DOMAIN", max_domain)
    monkeypatch.setattr(J, "ARRAY_JOIN_SMALL_DOMAIN", small_domain)
    probe, build, keys, enc = _boundary_tables(case)
    keys = keys or (["pk"], ["bk"])
    out = probe.column_names + build.column_names

    def plan(builder):
        b = builder()
        bb = b.new_builder().values([build], string_encoding=enc)
        return (b.values([probe], string_encoding=enc)
                .hash_join(keys[0], keys[1], bb, output=out,
                           join_type="left").plan())
    before = _route_counters()
    got = _assert_same(plan(JPlanBuilder), plan(PlanBuilder))
    assert got.num_rows >= probe.num_rows
    assert tuple(_route_counters() - before) == BOUNDARIES[case]


@pytest.mark.parametrize("key_range,capacity,want", [
    ((0, 5, 9), 1024, None),                        # no usable row
    ((3, -4, 11), 1024, (-4, 11)),
    ((3, 0, (1 << 21) - 1), 1024, (0, (1 << 21) - 1)),
    ((3, 0, 1 << 21), 1024, None),                  # past 2^21 and 8 a row
    ((9, 0, 8 * 300_000 - 1), 300_000, (0, 8 * 300_000 - 1)),
    ((9, 0, 8 * 300_000), 300_000, None),
    ((10 ** 7, 1, 1 << 26), 1 << 24, (1, 1 << 26)),
    ((10 ** 7, 0, 1 << 26), 1 << 24, None),         # past the cap
])
def test_observed_domain_bounds(key_range, capacity, want):
    """An observed domain takes array mode within ARRAY_JOIN_MAX_DOMAIN
    and within ARRAY_JOIN_SMALL_DOMAIN or 8 entries a build row."""
    assert J.observed_domain(key_range, capacity) == want


def _run_operator(mod, dev_mod, plan, probe, build, array_range, **kw):
    """Drive one engine's HashBuildStage and HashJoinOperator directly,
    with the build key's array range handed in (Values have no stats)."""
    build_batch = dev_mod.from_arrow(build, **kw)
    stage = mod.HashBuildStage(plan.right_keys, array_range=array_range)
    stage.add_input(build_batch)
    op = mod.HashJoinOperator(plan)
    op.set_built_table(stage.finish())
    outs = []
    for lo in range(0, probe.num_rows, 200):  # three probe batches
        op.add_input(dev_mod.from_arrow(probe.slice(lo, 200), **kw))
        while (o := op.get_output()) is not None:
            outs.append(o)
    op.no_more_input()
    while (o := op.get_output()) is not None:
        outs.append(o)
    return pa.concat_tables([dev_mod.to_arrow(o) for o in outs])


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_join_types_array_mode_equal_reference(jt, dup, nulls):
    probe, build = make_tables(dup, nulls, seed=11)
    rng = (0, 149)
    want = _run_operator(JJ, JD, _plan(JPlanBuilder, probe, build, jt),
                         probe, build, rng)
    got = _run_operator(J, D, _plan(PlanBuilder, probe, build, jt),
                        probe, build, rng, device="cpu")
    assert got.num_rows == want.num_rows > 0
    assert got.equals(want)


@pytest.mark.parametrize("path", ["array_mode", "count_path"])
def test_build_and_probe_columns_share_one_gather(path, monkeypatch):
    """The matched rows' columns go through B5's multi-column form, all
    the 4- and 8-byte arrays of one side in one call: an inner join's
    build columns (bk with its validity, bv) in array mode, and on the
    count path (duplicate keys) the probe columns as well."""
    calls = []
    real = G.gather_rows

    def spy(columns, idx):
        calls.append(len(columns))
        return real(columns, idx)

    monkeypatch.setattr(G, "gather_rows", spy)
    probe, build = make_tables(path == "count_path", True, seed=11)
    if path == "array_mode":
        want = _run_operator(JJ, JD, _plan(JPlanBuilder, probe, build,
                                           "inner"), probe, build, (0, 149))
        got = _run_operator(J, D, _plan(PlanBuilder, probe, build, "inner"),
                            probe, build, (0, 149), device="cpu")
        assert calls == [2] * 3  # one call per probe batch
    else:
        got = _assert_same(_plan(JPlanBuilder, probe, build, "inner"),
                           _plan(PlanBuilder, probe, build, "inner"))
        want = got
        assert calls and set(calls) == {2}
    assert got.num_rows > 0 and got.equals(want)


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_filtered_joins_equal_reference(jt):
    probe, build = make_tables(True, False)
    filt = "pv + bv < 1000"
    out = ALL_COLS if jt != "right_semi_filter" else ["bk", "bv"]
    if jt in ("left_semi_filter", "anti"):
        out = ["pk", "pv"]
    _assert_same(_plan(JPlanBuilder, probe, build, jt, output=out,
                       filt=filt),
                 _plan(PlanBuilder, probe, build, jt, output=out, filt=filt))


@pytest.mark.parametrize("build_nulls", [False, True])
def test_null_aware_anti_equal_reference(build_nulls):
    probe, build = make_tables(True, True)
    if not build_nulls:
        build = build.filter(pa.compute.is_valid(build["bk"]))
    _assert_same(_plan(JPlanBuilder, probe, build, "anti", null_aware=True),
                 _plan(PlanBuilder, probe, build, "anti", null_aware=True))


def _multi_key_tables(key_type, seed=3):
    rng = np.random.default_rng(seed)
    probe = pa.table({"k1": pa.array(rng.integers(0, 10, 300), key_type),
                      "k2": pa.array(rng.integers(0, 10, 300), key_type),
                      "pv": pa.array(np.arange(300), pa.int64())})
    build = pa.table({"b1": pa.array(np.repeat(np.arange(10), 10)
                                     [rng.permutation(100)], key_type),
                      "b2": pa.array(np.tile(np.arange(12), 10)[:100],
                                     key_type),
                      "bv": pa.array(np.arange(100), pa.int64())})
    return probe, build


@pytest.mark.parametrize("key_type,jt", [
    (pa.int32(), "inner"),      # two 1-word keys: one packed lane
    (pa.int64(), "inner"),      # two BIGINTs: four words, the wide build
    (pa.int64(), "left"),
    (pa.int64(), "anti"),
])
def test_multi_key_joins_equal_reference(key_type, jt):
    probe, build = _multi_key_tables(key_type)
    out = OUTPUT.get(jt, ["k1", "k2", "pv", "bv"])
    if jt == "anti":
        out = ["k1", "k2", "pv"]
    keys = (["k1", "k2"], ["b1", "b2"])
    _assert_same(_plan(JPlanBuilder, probe, build, jt, keys=keys, output=out),
                 _plan(PlanBuilder, probe, build, jt, keys=keys, output=out))
    wide = key_type == pa.int64()
    assert packable_words([T.BIGINT if wide else T.INTEGER] * 2) \
        == (not wide)


def test_expansion_over_many_chunks_equal_reference():
    probe = pa.table({"pk": pa.array(np.zeros(1000, np.int64)),
                      "pv": pa.array(np.arange(1000, dtype=np.int64))})
    build = pa.table({"bk": pa.array(np.zeros(50, np.int64)),
                      "bv": pa.array(np.arange(50, dtype=np.int64))})
    got = _assert_same(
        _plan(JPlanBuilder, probe, build, "inner", output=["pv", "bv"]),
        _plan(PlanBuilder, probe, build, "inner", output=["pv", "bv"]))
    assert got.num_rows == 50_000


@pytest.mark.parametrize("mask", [[True, True, True, False],
                                  [True, False, True, True],
                                  [False, True, True, True]])
def test_array_tables_equal_reference(mask):
    """The direct-address tables, with the masked duplicate of the max key
    that once hid that key's run end (its count went negative)."""
    t = pa.table({"k": pa.array([1, 2, 3, 3], pa.int64())})

    class KF:
        name, dtype = "k", T.BIGINT

    jb = JD.from_arrow(t, capacity=4)
    jb = jb.with_mask(jnp.asarray(mask))
    tb = D.from_arrow(t, capacity=4, device="cpu")
    tb = D.DeviceBatch(tb.columns, torch.tensor(mask))
    want = JJ.build_sorted_table(jb, (KF(),), array_range=(1, 3))
    got = J.build_sorted_table(tb, (KF(),), array_range=(1, 3))
    for name in ("arr_start", "arr_count", "arr_row1", "perm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert getattr(got, "arr_start").dtype == torch.int32
    np.testing.assert_array_equal(
        got.sorted_key.numpy(),
        np.asarray(want.sorted_key).astype(np.uint64).view(np.int64))
    assert bool(got.has_dup_keys) == bool(want.has_dup_keys)
    if mask == [True, True, True, False]:
        assert list(got.arr_count.numpy()) == [1, 1, 1]


@pytest.fixture
def _tpch():
    jax_register_tpch(0.01)
    register_tpch(0.01)


def _q18(builder, threshold):
    b = builder()
    big = (b.table_scan("lineitem", ["l_orderkey", "l_quantity"])
           .single_aggregation(["l_orderkey"],
                               ["sum(l_quantity) as quantity"])
           .filter(f"quantity > {threshold}"))
    customers = b.new_builder().table_scan("customer",
                                           ["c_custkey", "c_name"])
    return (b.new_builder()
            .table_scan("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                                   "o_totalprice"])
            .hash_join(["o_orderkey"], ["l_orderkey"], big,
                       output=["o_orderkey", "o_custkey", "o_orderdate",
                               "o_totalprice", "quantity"])
            .hash_join(["o_custkey"], ["c_custkey"], customers,
                       output=["c_name", "c_custkey", "o_orderkey",
                               "o_orderdate", "o_totalprice", "quantity"])
            .top_n(["o_totalprice DESC", "o_orderdate"], 100).plan())


@pytest.mark.parametrize("query", ["q3", "q18_240", "q18_300"])
def test_tpch_join_queries_equal_reference(query, _tpch):
    if query == "q3":
        jplan, tplan = jax_tpch_plan(3), tpch_plan(3)
    else:
        th = float(query.split("_")[1])
        jplan, tplan = _q18(JPlanBuilder, th), _q18(PlanBuilder, th)
        # the port's own Q18 with this threshold is the same plan
        assert str(tplan.output_type()) == str(q18(threshold=th)
                                               .output_type())
    got = _assert_same(jplan, tplan)
    assert got.num_rows == (0 if query == "q18_300"
                            else (10 if query == "q3" else got.num_rows))
    if query == "q18_240":
        assert got.num_rows > 0
        assert got.column("c_name")[0].as_py().startswith("Customer#")


def test_tpch_duplicate_key_array_join_equal_reference(_tpch):
    """orders probing lineitem: a duplicate-key build in array mode
    (l_orderkey has connector stats), the count path with expansion."""
    def build(builder):
        b = builder()
        li = b.new_builder().table_scan(
            "lineitem", ["l_orderkey", "l_linenumber"],
            filter="l_linenumber <= 2")
        return (b.table_scan("orders", ["o_orderkey", "o_orderdate"],
                             filter="o_orderdate < date '1993-01-01'")
                .hash_join(["o_orderkey"], ["l_orderkey"], li,
                           output=["o_orderkey", "o_orderdate",
                                   "l_linenumber"]).plan())
    tplan = build(PlanBuilder)
    assert J.array_join_range(tplan) is not None
    got = _assert_same(build(JPlanBuilder), tplan)
    assert got.num_rows > 0


def test_unported_join_keys_raise():
    """A raw (byte-matrix) string key now builds the sorted table, with
    the reference's permutation; key tuples past seven words too."""
    vals = ["sku-9", None, "sku-1", "a", "sku-1", "", "é", "sku-10"]
    t = pa.table({"k": pa.array(range(len(vals)), pa.int64()),
                  "s": pa.array(vals)})
    b = D.from_arrow(t, string_encoding={"s": "raw"}, device="cpu")
    jb = JD.from_arrow(t, string_encoding={"s": "raw"})

    class KF:
        name, dtype = "s", T.VARCHAR

    bt = J.build_table(b, (KF(),))
    jbt = JJ.build_table(jb, (KF(),))
    np.testing.assert_array_equal(bt.perm.numpy(), np.asarray(jbt.perm))
    assert bool(bt.has_dup_keys) and bool(bt.has_null_key)
    assert bool(jbt.has_dup_keys) and bool(jbt.has_null_key)

    class Wide:
        name, dtype = "k", T.decimal(38, 2)

    # eight value words: no cap any more, the sorted build takes them
    bt = J.build_table(b, (Wide(),) * 2)
    assert bt.perm.shape[0] == b.capacity


def _decimal_key_tables(values_probe, values_build):
    import decimal
    t = pa.decimal128(38, 2)
    probe = pa.table({"pk": pa.array([decimal.Decimal(v)
                                      for v in values_probe], t),
                      "pv": pa.array(range(len(values_probe)), pa.int64())})
    build = pa.table({"bk": pa.array([decimal.Decimal(v)
                                      for v in values_build], t),
                      "bv": pa.array(range(len(values_build)), pa.int64())})
    return probe, build


@pytest.mark.parametrize("jt", ["inner", "left", "anti"])
def test_long_decimal_keys_equal_reference(jt):
    """DECIMAL(38) keys (four words: the wide build and the merge-rank),
    non-negative and within one limb: the high limb is 0 everywhere, so
    the reference, whose merge-rank drops it, agrees (ROADMAP C)."""
    rng = np.random.default_rng(5)
    vals = [f"{x / 100:.2f}" for x in rng.integers(0, 500, 300)]
    probe, build = _decimal_key_tables(vals[:200], vals[150:])
    _assert_same(_plan(JPlanBuilder, probe, build, jt),
                 _plan(PlanBuilder, probe, build, jt))


def test_long_decimal_keys_compare_both_limbs():
    """-0.01 and 2^64 - 1 cents share their low limb: they must not match,
    and negative keys match exactly their equals. (The reference's
    merge-rank drops the high limb: it matches the first pair and pairs
    negative keys with wrong build rows; ROADMAP C.)"""
    probe, build = _decimal_key_tables(["-0.01", "1.00"],
                                       ["184467440737095516.15", "1.00"])
    got = Task(_plan(PlanBuilder, probe, build, "inner",
                     output=["pk", "pv", "bv"]), CPU).run()
    assert got.to_pydict() == {"pk": [build["bk"][1].as_py()], "pv": [1],
                               "bv": [1]}
    rng = np.random.default_rng(5)
    vals = [f"{x / 100:.2f}" for x in rng.integers(-500, 500, 300)]
    probe, build = _decimal_key_tables(vals[:200], vals[150:])
    got = Task(_plan(PlanBuilder, probe, build, "inner"), CPU).run()
    pairs = sorted((p.as_py(), b.as_py()) for p, b in
                   zip(got["pk"], got["bk"]))
    want = sorted((p, b) for p in probe["pk"].to_pylist()
                  for b in build["bk"].to_pylist() if p == b)
    assert pairs == want and len(want) > 0


@pytest.mark.parametrize("jt,want", [
    ("right", {"ps": ["y", None], "pk": [2, None], "bv": [10, 20]}),
    ("full", {"ps": ["x", "y", "z", None], "pk": [1, 2, 3, None],
              "bv": [None, 10, None, 20]}),
])
def test_right_phase_keeps_string_probe_columns(jt, want):
    """Unmatched build rows get NULL probe columns; a string probe column
    keeps the dictionary the probe batches carried, so the output converts
    to Arrow (the reference's right phase gives it none and cannot;
    ROADMAP C)."""
    probe = pa.table({"pk": pa.array([1, 2, 3], pa.int64()),
                      "ps": pa.array(["x", "y", "z"])})
    build = pa.table({"bk": pa.array([2, 5], pa.int64()),
                      "bv": pa.array([10, 20], pa.int64())})
    got = Task(_plan(PlanBuilder, probe, build, jt,
                     output=["ps", "pk", "bv"]), CPU).run()
    assert got.to_pydict() == want


def _rows_as_set(table: pa.Table):
    cols = table.column_names
    rows = list(zip(*(table.column(c).to_pylist() for c in cols)))
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None
                                             else 0) for v in r))


def _wide_tables(n_keys: int, with_nulls: bool, seed=13):
    """probe/build tables keyed on n_keys BIGINT columns (the reference's
    tests/test_join.py ``_wide_tables``); eight keys take values in
    [0, 2), so that some tuples match."""
    rng = np.random.RandomState(seed)
    hi = 8 if n_keys <= 5 else 2
    pk = {f"pk{i}": rng.randint(0, hi, 400) for i in range(n_keys)}
    pv = rng.randint(0, 1000, 400)
    bk = {f"bk{i}": rng.randint(0, hi, 120) for i in range(n_keys)}
    bv = rng.randint(0, 1000, 120)
    pmask = rng.rand(400) < 0.1 if with_nulls else None
    bmask = rng.rand(120) < 0.1 if with_nulls else None
    probe = {k: pa.array(v, pa.int64(), mask=pmask if k == "pk0" else None)
             for k, v in pk.items()}
    build = {k: pa.array(v, pa.int64(), mask=bmask if k == "bk0" else None)
             for k, v in bk.items()}
    probe["pv"] = pa.array(pv, pa.int64())
    build["bv"] = pa.array(bv, pa.int64())
    return pa.table(probe), pa.table(build)


@pytest.mark.parametrize("n_keys,jt", [
    (2, "inner"), (2, "left"), (2, "left_semi_filter"), (2, "anti"),
    (3, "inner"), (3, "right"), (4, "inner"), (5, "inner"),
    (8, "inner"), (8, "left"), (8, "left_semi_filter"),
])
def test_wide_key_join_types(n_keys, jt):
    """Key tuples of 4-16 value words: the sorted build and the
    merge-rank, where the reference takes its scatter-probe table past
    seven words. The same rows, as a set."""
    probe, build = _wide_tables(n_keys, with_nulls=(jt != "right"))
    pk = [f"pk{i}" for i in range(n_keys)]
    bk = [f"bk{i}" for i in range(n_keys)]
    out = pk + ["pv"] + (["bv"] if jt in ("inner", "left", "right") else [])
    plans = [_plan(B, probe, build, jt, keys=(pk, bk), output=out)
             for B in (JPlanBuilder, PlanBuilder)]
    want = JTask(plans[0]).run()
    got = Task(plans[1], CPU).run()
    assert got.schema == want.schema
    assert _rows_as_set(got) == _rows_as_set(want)
    assert got.num_rows > 0


def _dyn_counter(metrics_module) -> float:
    return metrics_module.reporter().snapshot()["counters"].get(
        metrics_module.K_JOIN_DYN_FILTERS, 0)


@pytest.mark.parametrize("case", ["range", "in_list", "semi", "left",
                                  "two_keys"])
def test_dynamic_filter_pushdown(case):
    """The build keys' range (or IN list of at most 64 values) becomes a
    Filter over the probe side: the same rows, the same filters counted
    as the reference's, and the filter node where the reference has
    one."""
    from velox_tpu.common import metrics as JM
    from velox_tpu.exec.task import QueryCtx as JQueryCtx

    from velox_tpu_torch.common import metrics as M
    from velox_tpu_torch.core.config import QueryConfig
    n_build = 30 if case == "in_list" else 50
    probe = pa.table({"pk": pa.array(np.arange(1000), pa.int64()),
                      "pk2": pa.array(np.arange(1000) % 7, pa.int64()),
                      "pv": pa.array(np.arange(1000), pa.int64())})
    build = pa.table({"bk": pa.array(np.arange(400, 400 + n_build),
                                     pa.int64()),
                      "bk2": pa.array(np.arange(n_build) % 7, pa.int64()),
                      "bv": pa.array(np.arange(n_build), pa.int64())})
    jt = {"semi": "left_semi_filter", "left": "left"}.get(case, "inner")
    keys = ((["pk", "pk2"], ["bk", "bk2"]) if case == "two_keys"
            else (["pk"], ["bk"]))
    plans = [_plan(B, probe, build, jt, keys=keys) for B in
             (JPlanBuilder, PlanBuilder)]
    j0, t0 = _dyn_counter(JM), _dyn_counter(M)
    jtask = JTask(plans[0])
    want = jtask.run()
    task = Task(plans[1], CPU)
    got = task.run()
    assert _rows_as_set(got) == _rows_as_set(want)
    assert _dyn_counter(M) - t0 == _dyn_counter(JM) - j0
    pushed = [o.stats.plan_node_id for o in task.operators
              if o.stats.plan_node_id.endswith("-dynfilter")]
    jpushed = [o.stats.plan_node_id for o in jtask.operators
               if o.stats.plan_node_id.endswith("-dynfilter")]
    assert pushed == jpushed
    assert bool(pushed) == (case != "left")
    # off by config: the same rows, no filter
    off = {QueryConfig.DYNAMIC_FILTERS: False}
    t2 = Task(plans[1], QueryCtx("cpu", off))
    assert _rows_as_set(t2.run()) == _rows_as_set(want)
    assert not any(o.stats.plan_node_id.endswith("-dynfilter")
                   for o in t2.operators)
    assert JTask(plans[0], JQueryCtx(off)).run().num_rows == got.num_rows


@pytest.mark.parametrize("query", [3, 5, 10, 18])
def test_dynamic_filters_of_tpch_plans_equal_reference(query, _tpch):
    """On TPC-H plans (connector stats: array-mode joins over unique
    builds push none) the port pushes the reference's filters, and the
    rows are the reference's."""
    from velox_tpu.common import metrics as JM

    from velox_tpu_torch.common import metrics as M
    j0, t0 = _dyn_counter(JM), _dyn_counter(M)
    want = JTask(jax_tpch_plan(query)).run()
    got = Task(tpch_plan(query), CPU).run()
    assert _dyn_counter(M) - t0 == _dyn_counter(JM) - j0
    assert got.num_rows == want.num_rows


def test_finish_early_on_empty_build():
    """An inner join over an empty build runs no probe pipeline; with the
    switch off it runs one, with the same empty answer."""
    from velox_tpu_torch.core.config import QueryConfig
    probe = pa.table({"pk": pa.array(np.arange(100), pa.int64()),
                      "pv": pa.array(np.arange(100), pa.int64())})
    build = pa.table({"bk": pa.array([], pa.int64()),
                      "bv": pa.array([], pa.int64())})
    plans = [_plan(B, probe, build, "inner", output=["pk", "bv"])
             for B in (JPlanBuilder, PlanBuilder)]
    t = Task(plans[1], CPU)
    out = t.run()
    assert out.num_rows == 0 and out.schema == JTask(plans[0]).run().schema
    assert "HashJoinOperator" not in [op.stats.operator_type
                                      for op in t.operators]
    t2 = Task(plans[1], QueryCtx(
        "cpu", {QueryConfig.HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD: False}))
    assert t2.run().num_rows == 0
    assert "HashJoinOperator" in [op.stats.operator_type
                                  for op in t2.operators]


@pytest.mark.parametrize("empty", [True, False])
def test_probe_scan_reads_no_split_on_an_empty_build(empty, monkeypatch):
    """lineitem in 4,096-row splits with a prefetching producer thread,
    joined to a filtered partsupp: when no partsupp row passes, no
    lineitem split is read; otherwise every one is."""
    from velox_tpu_torch.connectors import tpch as tt
    from velox_tpu_torch.connectors.cache import DataCache
    from velox_tpu_torch.connectors.connector import register_connector
    from velox_tpu_torch.core.config import QueryConfig
    DataCache.instance().clear()
    register_connector(tt.TpchConnector("tpch", 0.01, 4096))
    read = []
    real_next = tt.TpchDataSource.next

    def counted(self, split):
        read.append(self._table)
        return real_next(self, split)
    monkeypatch.setattr(tt.TpchDataSource, "next", counted)
    try:
        limit = 0 if empty else 100
        b = PlanBuilder()
        ps = (b.new_builder().table_scan("partsupp",
                                         ["ps_partkey", "ps_availqty"])
              .filter(f"ps_availqty < {limit}"))
        plan = (b.table_scan("lineitem", ["l_partkey", "l_quantity"])
                .hash_join(["l_partkey"], ["ps_partkey"], ps,
                           output=["l_partkey", "l_quantity"])
                .single_aggregation([], ["count() as n"]).plan())
        task = Task(plan, QueryCtx(
            "cpu", {QueryConfig.SCAN_PREFETCH_DEPTH: 2}))
        n = task.run().column("n")[0].as_py()
    finally:
        tt.register_tpch(0.01)
        DataCache.instance().clear()
    if empty:
        assert n == 0 and "lineitem" not in read
    else:
        assert n > 0 and read.count("lineitem") > 10

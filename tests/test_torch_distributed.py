"""The port's DistributedTask against the JAX reference's, on the CPU.

Counterparts of every test of tests/test_distributed.py: each plan runs
through the reference's DistributedTask on its 8-device virtual CPU mesh
and through the port's on ``make_mesh(8, "cpu")`` (eight shards on the
host), over the same seeded inputs, and the results must be the same
rows (integers, decimals and strings exactly, doubles within
tests/tpch_sql.py ``TOLERANCES``), besides the pandas expectations the
reference's tests hold. Also: the 22 TPC-H queries on the port's mesh at
SF 0.01 against the SQLite oracle (as
tests/test_tpch_queries.py::test_tpch_query_mesh holds the reference's),
Q1, Q3, Q6 and Q18 against the reference's mesh, the mesh's placement,
the TPC-H split count under ``scan.splits_per_table``, an empty global
aggregation, a null-aware anti join and a filtered left join on the
mesh, and a checked error raising there.
"""

import dataclasses

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from tpch_sql import ORACLE_SQL, TOLERANCES
from velox_tpu.common import metrics as JM
from velox_tpu.connectors.connector import (
    register_connector as jregister_connector,
)
from velox_tpu.connectors.tpch import TpchConnector as JTpchConnector
from velox_tpu.connectors.tpch import register_tpch as jregister_tpch
from velox_tpu.core.config import QueryConfig as JQC
from velox_tpu.exec.task import QueryCtx as JQueryCtx
from velox_tpu.parallel import DistributedTask as JDistributedTask
from velox_tpu.parallel import make_mesh as jmake_mesh
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.common.errors import VeloxUserError
from velox_tpu_torch.connectors.connector import register_connector
from velox_tpu_torch.connectors.tpch import TpchConnector, register_tpch
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.parallel import DistributedTask, make_mesh
from velox_tpu_torch.parallel.exchange import destinations
from velox_tpu_torch.testing.golden import load_generated
from velox_tpu_torch.testing.oracle import assert_frames_match
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.vector.device import from_arrow

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def conn():
    """Both engines' "tpch-dist" connector (SF 0.002)."""
    jregister_connector(JTpchConnector("tpch-dist", scale_factor=0.002,
                                       rows_per_split=1024))
    c = TpchConnector("tpch-dist", scale_factor=0.002, rows_per_split=1024)
    register_connector(c)
    return c


def _both(build, jcfg=None, cfg=None):
    """(reference rows, port rows) of ``build(builder)`` on each engine's
    8-shard mesh."""
    want = JDistributedTask(
        build(JPlanBuilder), jmake_mesh(8),
        ctx=JQueryCtx(jcfg) if jcfg else None).run()
    mesh = make_mesh(8, "cpu")
    got = DistributedTask(build(PlanBuilder), mesh,
                          ctx=QueryCtx("cpu", cfg) if cfg else None).run()
    return want, got


def _same_rows(got: pa.Table, want: pa.Table, rel_tol: float = 1e-9):
    """The same multiset of rows (the tables' order is the shards')."""
    assert got.column_names == want.column_names
    assert_frames_match(got, want, sort=True, rel_tol=rel_tol)


def _joined(jt, out_cols, probe_tables, build, **kw):
    def plan(B):
        b = B()
        bb = b.new_builder().values([pa.table(build)])
        return (b.values(probe_tables)
                .hash_join(["pk"], ["bk"], bb, output=out_cols,
                           join_type=jt).plan())
    return _both(plan, **kw)


def _skew_counter():
    return (JM.reporter().snapshot()["counters"].get(JM.K_SKEW_SPLITS, 0),
            M.reporter().snapshot()["counters"].get(M.K_SKEW_SPLITS, 0))


def test_distributed_q1_style(conn):
    want, got = _both(lambda B: (
        B().table_scan("lineitem",
                       ["l_returnflag", "l_linestatus", "l_quantity"],
                       connector_id="tpch-dist")
        .single_aggregation(["l_returnflag", "l_linestatus"],
                            ["sum(l_quantity) as sq", "count() as c"])
        .plan()))
    _same_rows(got, want)
    serial = Task(PlanBuilder().table_scan(
        "lineitem", ["l_returnflag", "l_linestatus", "l_quantity"],
        connector_id="tpch-dist").single_aggregation(
        ["l_returnflag", "l_linestatus"],
        ["sum(l_quantity) as sq", "count() as c"]).plan(),
        QueryCtx("cpu")).run()
    _same_rows(got, serial)


def test_distributed_dup_key_join():
    rng = np.random.RandomState(9)
    probe_tables = [pa.table(pd.DataFrame({
        "pk": rng.randint(0, 30, 400).astype("int64"),
        "pv": np.arange(i * 400, (i + 1) * 400, dtype="int64")}))
        for i in range(10)]
    build = pd.DataFrame({"bk": rng.randint(0, 25, 80).astype("int64"),
                          "bv": np.arange(80, dtype="int64")})
    want, got = _joined("inner", ["pk", "pv", "bv"], probe_tables, build)
    _same_rows(got, want)
    exp = pd.concat([t.to_pandas() for t in probe_tables]).merge(
        build, left_on="pk", right_on="bk")
    assert got.num_rows == len(exp)
    assert got.to_pandas().bv.sum() == exp.bv.sum()


@pytest.mark.parametrize("jtype", ["right", "full", "right_semi_filter"])
def test_distributed_right_joins(jtype):
    """Broadcast right-side joins: a build row is unmatched only when no
    shard matched it, and the right phase emits it once."""
    rng = np.random.RandomState(13)
    probe_tables = [pa.table(pd.DataFrame({
        "pk": rng.randint(0, 40, 300).astype("int64"),
        "pv": np.arange(i * 300, (i + 1) * 300, dtype="int64")}))
        for i in range(6)]
    build = pd.DataFrame({"bk": np.arange(20, 60, dtype="int64"),
                          "bv": np.arange(40, dtype="int64")})
    out_cols = {"right": ["pv", "bk", "bv"],
                "full": ["pk", "pv", "bk", "bv"],
                "right_semi_filter": ["bk", "bv"]}[jtype]
    want, got = _joined(jtype, out_cols, probe_tables, build)
    _same_rows(got, want)
    all_probe = pd.concat([t.to_pandas() for t in probe_tables])
    if jtype == "right_semi_filter":
        assert sorted(got.column("bk").to_pylist()) == \
            sorted(set(all_probe.pk) & set(build.bk))
    else:
        exp = all_probe.merge(build, left_on="pk", right_on="bk",
                              how="right" if jtype == "right" else "outer")
        assert got.num_rows == len(exp)


@pytest.mark.parametrize("jt", ["inner", "left", "right", "anti"])
def test_distributed_partitioned_join(jt):
    """Partitioned join: the build side hash-sharded (no replication),
    the probe side resharded by key."""
    rng = np.random.RandomState(21)
    probe_tables = [pa.table(pd.DataFrame({
        "pk": rng.randint(0, 40, 300).astype("int64"),
        "pv": np.arange(i * 300, (i + 1) * 300, dtype="int64")}))
        for i in range(6)]
    build = pd.DataFrame({"bk": rng.randint(0, 30, 90).astype("int64"),
                          "bv": np.arange(90, dtype="int64")})
    out_cols = {"inner": ["pk", "pv", "bv"], "left": ["pk", "pv", "bv"],
                "right": ["pk", "pv", "bv"], "anti": ["pk", "pv"]}[jt]
    want, got = _joined(jt, out_cols, probe_tables, build,
                        jcfg={JQC.JOIN_BROADCAST_THRESHOLD: 0},
                        cfg={QC.JOIN_BROADCAST_THRESHOLD: 0})
    _same_rows(got, want)
    all_probe = pd.concat([t.to_pandas() for t in probe_tables])
    if jt == "anti":
        exp = all_probe[~all_probe.pk.isin(build.bk)]
    else:
        exp = all_probe.merge(build, left_on="pk", right_on="bk", how=jt)
    assert got.num_rows == len(exp)
    assert np.nansum(got.to_pandas().pv.to_numpy("float64")) == \
        np.nansum(exp.pv.to_numpy("float64"))


def test_partitioned_join_build_exceeds_single_shard():
    """A build side too big to replicate still joins when partitioned:
    each shard holds its hash range."""
    rng = np.random.RandomState(5)
    n_build = 4000
    build = pd.DataFrame({
        "bk": np.arange(n_build, dtype="int64"),
        "bv": rng.randint(0, 100, n_build).astype("int64")})
    probe_tables = [pa.table(pd.DataFrame({
        "pk": rng.randint(0, n_build, 500).astype("int64"),
        "pv": np.arange(i * 500, (i + 1) * 500, dtype="int64")}))
        for i in range(4)]
    want, got = _joined("inner", ["pk", "pv", "bv"], probe_tables, build,
                        jcfg={JQC.JOIN_BROADCAST_THRESHOLD: 0},
                        cfg={QC.JOIN_BROADCAST_THRESHOLD: 0})
    _same_rows(got, want)
    exp = pd.concat([t.to_pandas() for t in probe_tables]).merge(
        build, left_on="pk", right_on="bk")
    assert got.num_rows == len(exp)
    assert got.to_pandas().bv.sum() == exp.bv.sum()


def _skew_join(probe_tables, skew_factor):
    build = pd.DataFrame({"bk": np.arange(64, dtype="int64"),
                          "bv": np.arange(64, dtype="int64") * 10})
    before = _skew_counter()
    want, got = _joined(
        "inner", ["pk", "pv", "bv"], probe_tables, build,
        jcfg={JQC.JOIN_BROADCAST_THRESHOLD: 0, JQC.SKEW_FACTOR: skew_factor},
        cfg={QC.JOIN_BROADCAST_THRESHOLD: 0, QC.SKEW_FACTOR: skew_factor})
    after = _skew_counter()
    _same_rows(got, want)
    exp = pd.concat([t.to_pandas() for t in probe_tables]).merge(
        build, left_on="pk", right_on="bk")
    g = got.to_pandas().sort_values(["pk", "pv"]).reset_index(drop=True)
    e = exp.sort_values(["pk", "pv"]).reset_index(drop=True)
    assert len(g) == len(e)
    np.testing.assert_array_equal(g.pv.to_numpy(), e.pv.to_numpy())
    np.testing.assert_array_equal(g.bv.to_numpy(), e.bv.to_numpy())
    return after[0] - before[0], after[1] - before[1]


def test_skew_detected_in_later_wave():
    """Skew arriving after the first probe wave is caught: the histogram
    is read again every wave."""
    rng = np.random.RandomState(13)
    probe_tables = []
    for i in range(16):  # 16 tables over 8 shards: 2 waves
        pk = rng.randint(0, 64, 100).astype("int64")
        if i >= 8:  # the hot key comes in the second wave only
            pk[:80] = 3
        probe_tables.append(pa.table(pd.DataFrame({
            "pk": pk,
            "pv": np.arange(i * 100, (i + 1) * 100, dtype="int64")})))
    ref_splits, port_splits = _skew_join(probe_tables, 3)
    assert port_splits == ref_splits >= 1


def test_partitioned_join_skew_key_splitting():
    """One key in half the probe rows: its rows spread round-robin and
    its build rows replicate, and every row still finds its match."""
    rng = np.random.RandomState(31)
    pk = rng.randint(0, 64, 800).astype("int64")
    pk[:400] = 7
    probe_tables = [pa.table(pd.DataFrame({
        "pk": pk[i * 200:(i + 1) * 200],
        "pv": np.arange(i * 200, (i + 1) * 200, dtype="int64")}))
        for i in range(4)]
    ref_splits, port_splits = _skew_join(probe_tables, 2)
    assert port_splits == ref_splits >= 1


def test_skew_hot_set_refreshes_on_new_hot_keys():
    """Wave 1's hot key differs from wave 2's: the hot set grows to the
    union and the build re-augments (two splits counted)."""
    rng = np.random.RandomState(5)
    key_a, key_b = 3, 17
    b = from_arrow(pa.table({"pk": np.array([key_a, key_b], "int64")}),
                   device="cpu")
    dests = destinations(b, ["pk"], 8).tolist()
    assert dests[0] != dests[1], "pick keys on distinct destinations"
    probe_tables = []
    for i in range(16):
        pk = rng.randint(0, 64, 100).astype("int64")
        pk[:80] = key_a if i < 8 else key_b
        probe_tables.append(pa.table(pd.DataFrame({
            "pk": pk,
            "pv": np.arange(i * 100, (i + 1) * 100, dtype="int64")})))
    ref_splits, port_splits = _skew_join(probe_tables, 3)
    assert port_splits == ref_splits >= 2


def test_distributed_orderby(conn):
    want, got = _both(lambda B: (
        B().table_scan("lineitem", ["l_orderkey", "l_quantity"],
                       connector_id="tpch-dist")
        .order_by(["l_quantity desc", "l_orderkey"]).plan()))
    # a total order except among equal keys: the key columns in order
    assert got.column("l_orderkey").to_pylist() == \
        want.column("l_orderkey").to_pylist()
    assert got.column("l_quantity").to_pylist() == \
        want.column("l_quantity").to_pylist()


def test_distributed_limit(conn):
    """LIMIT 100 OFFSET 7: rows by global position (waves, then shards,
    then rows), the reference's rows exactly."""
    want, got = _both(lambda B: (
        B().table_scan("lineitem", ["l_orderkey", "l_linenumber"],
                       connector_id="tpch-dist")
        .limit(100, offset=7).plan()))
    assert got.num_rows == 100
    assert got.to_pylist() == want.to_pylist()


def test_distributed_window(conn):
    want, got = _both(lambda B: (
        B().table_scan("lineitem",
                       ["l_orderkey", "l_linenumber", "l_quantity"],
                       connector_id="tpch-dist")
        .window(["l_orderkey"], ["l_linenumber"],
                ["row_number() as rn", "sum(l_quantity) as rs"]).plan()))
    _same_rows(got, want)


def test_distributed_global_window(conn):
    want, got = _both(lambda B: (
        B().table_scan("lineitem", ["l_orderkey", "l_linenumber"],
                       connector_id="tpch-dist")
        .window([], ["l_orderkey", "l_linenumber"],
                ["row_number() as rn"]).plan()))
    assert got.to_pylist() == want.to_pylist()


def test_distributed_unnest():
    """Row-local Unnest a shard."""
    rng = np.random.RandomState(21)
    tables = []
    for i in range(6):
        arrs = [list(rng.randint(0, 100, rng.randint(0, 5)))
                for _ in range(50)]
        tables.append(pa.table({
            "id": pa.array(np.arange(i * 50, (i + 1) * 50), pa.int64()),
            "a": pa.array(arrs, type=pa.list_(pa.int64()))}))
    want, got = _both(lambda B: B().values(tables)
                      .unnest("a", element_name="e").plan())
    _same_rows(got, want)


def test_distributed_mark_distinct():
    """Global distinct marking across shards and waves (a reshard by the
    key): one marked row per distinct key."""
    rng = np.random.RandomState(23)
    tables = [pa.table({"k": pa.array(
        rng.randint(0, 40, 120).astype("int64"))}) for _ in range(10)]
    want, got = _both(lambda B: B().values(tables)
                      .mark_distinct("m", ["k"]).plan())
    _same_rows(got, want)
    allk = pd.concat([t.to_pandas() for t in tables]).k
    marked = got.to_pandas()
    assert sorted(marked[marked.m].k) == sorted(allk.unique())


def test_distributed_window_range_k_frame():
    """RANGE k PRECEDING/FOLLOWING windows on the mesh."""
    from velox_tpu.exec.window import BoundType as JB
    from velox_tpu.exec.window import FrameType as JF
    from velox_tpu.exec.window import WindowFrame as JW
    from velox_tpu_torch.exec.window import BoundType, FrameType, WindowFrame
    rng = np.random.RandomState(29)
    tables = [pa.table(pd.DataFrame({
        "p": rng.randint(0, 5, 80).astype("int64"),
        "o": rng.randint(0, 40, 80).astype("int64"),
        "v": rng.randint(-50, 50, 80).astype("int64")}))
        for _ in range(6)]

    def plan(B):
        ref = B is JPlanBuilder
        frame = (JW(JF.RANGE, JB.PRECEDING, 3, JB.FOLLOWING, 2) if ref else
                 WindowFrame(FrameType.RANGE, BoundType.PRECEDING, 3,
                             BoundType.FOLLOWING, 2))
        return (B().values(tables)
                .window(["p"], ["o"], ["sum(v) as s"], frame=frame).plan())
    want, got = _both(plan)
    _same_rows(got, want)


# ---------------------------------------------------------------------------
# TPC-H on the mesh
# ---------------------------------------------------------------------------

SF = 0.01


@pytest.fixture(scope="module")
def tpch01():
    jregister_tpch(SF)
    return register_tpch(SF)


@pytest.fixture(scope="module")
def oracle(tpch01):
    return load_generated(tpch01)


@pytest.mark.parametrize("q", sorted(ORACLE_SQL))
def test_tpch_query_mesh(q, tpch01, oracle):
    """The 22 queries on the port's 8-shard mesh against SQLite over the
    same generated data."""
    rel_tol, min_rows = TOLERANCES.get(q, (1e-9, 1))
    got = DistributedTask(tpch_plan(q), make_mesh(8, "cpu")).run()
    exp = oracle.query(ORACLE_SQL[q])
    assert exp.num_rows >= min_rows, f"Q{q} oracle returned too few rows"
    assert_frames_match(got, exp, sort=True, rel_tol=rel_tol)


@pytest.mark.parametrize("q", [1, 3, 6, 18])
def test_tpch_mesh_equals_reference_mesh(q, tpch01):
    """Q1, Q3, Q6 and Q18 (threshold 240) on both engines' meshes: the
    same rows and types."""
    params = {18: {"threshold": 240.0}}.get(q, {})
    want = JDistributedTask(jax_tpch_plan(q, **params), jmake_mesh(8)).run()
    got = DistributedTask(tpch_plan(q, **params), make_mesh(8, "cpu")).run()
    assert got.schema == want.schema
    assert want.num_rows > 0
    _same_rows(got, want, TOLERANCES.get(q, (1e-9, 1))[0])


def test_tpch_split_bounds_equal_reference(tpch01):
    """``scan.splits_per_table`` cuts each table into the reference's
    splits, and a scan of them reads the whole table."""
    from velox_tpu.connectors.connector import get_connector as jget
    jc = jget("tpch")
    for want_n in (3, 8):
        ctx, jctx = (QueryCtx("cpu", {"scan.splits_per_table": want_n}),
                     JQueryCtx({"scan.splits_per_table": want_n}))
        for table in ("lineitem", "orders", "customer", "nation"):
            got = [(s.lo, s.hi) for s in tpch01.default_splits(table, ctx)]
            want = [(s.lo, s.hi) for s in jc.default_splits(table, jctx)]
            assert got == want, (table, want_n)
            assert got[0][0] == 0 \
                and got[-1][1] == tpch01.num_index_rows(table)
        assert len(tpch01.default_splits("orders", ctx)) == want_n
    # without the setting: the connector's own split size, as before
    assert [(s.lo, s.hi) for s in tpch01.default_splits("orders")] == \
        [(s.lo, s.hi) for s in jc.default_splits("orders", JQueryCtx())]


# ---------------------------------------------------------------------------
# The mesh and the edges of the plan walk
# ---------------------------------------------------------------------------

def test_make_mesh_places_shards():
    mesh = make_mesh(8, "cpu")
    assert mesh.size == 8
    assert mesh.devices == [torch.device("cpu")] * 8
    assert mesh.distinct_devices() == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(8)
        with pytest.raises(RuntimeError, match="CUDA"):
            DistributedTask(tpch_plan(6))


def test_query_device_must_be_the_mesh_s():
    mesh = make_mesh(2, "cpu")
    task = DistributedTask(tpch_plan(6), mesh)
    assert task.ctx.device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh"):
        DistributedTask(tpch_plan(6), mesh, ctx=QueryCtx("meta"))


def test_empty_global_aggregation_gives_one_row():
    """A global aggregation over no rows still gives its one row."""
    t = pa.table({"a": np.arange(20, dtype="int64")})
    want, got = _both(lambda B: B().values([t]).filter("a < 0")
                      .single_aggregation([], ["count() as c",
                                               "sum(a) as s",
                                               "max(a) as m"]).plan())
    assert got.to_pylist() == want.to_pylist() == \
        [{"c": 0, "s": None, "m": None}]


def test_null_aware_anti_join_partitioned():
    """A NULL build key on any shard empties every shard's null-aware
    anti join output; without it, the plain anti join's rows."""
    rng = np.random.RandomState(41)
    probe = [pa.table({"pk": pa.array(rng.randint(0, 50, 200), pa.int64()),
                       "pv": pa.array(np.arange(i * 200, (i + 1) * 200),
                                      pa.int64())}) for i in range(4)]
    for with_null in (False, True):
        keys = list(range(0, 50, 3)) + ([None] if with_null else [])
        build = pa.table({"bk": pa.array(keys, pa.int64())})

        def plan(B):
            b = B()
            bb = b.new_builder().values([build])
            return dataclasses.replace(
                b.values(probe).hash_join(["pk"], ["bk"], bb,
                                          output=["pk", "pv"],
                                          join_type="anti").plan(),
                null_aware=True)
        want, got = _both(plan, jcfg={JQC.JOIN_BROADCAST_THRESHOLD: 0},
                          cfg={QC.JOIN_BROADCAST_THRESHOLD: 0})
        _same_rows(got, want)
        assert (got.num_rows == 0) == with_null


def test_filtered_left_join_funnels():
    """A filtered non-inner join runs through the serial operator on
    shard 0, with the reference's rows."""
    rng = np.random.RandomState(43)
    probe = [pa.table({"pk": pa.array(rng.randint(0, 30, 150), pa.int64()),
                       "pv": pa.array(rng.randint(0, 9, 150), pa.int64())})
             for _ in range(3)]
    build = pa.table({"bk": pa.array(np.arange(0, 30), pa.int64()),
                      "bv": pa.array(rng.randint(0, 9, 30), pa.int64())})

    def plan(B):
        b = B()
        bb = b.new_builder().values([build])
        return (b.values(probe)
                .hash_join(["pk"], ["bk"], bb, output=["pk", "pv", "bv"],
                           join_type="left", filter="pv < bv").plan())
    want, got = _both(plan)
    _same_rows(got, want)


def test_checked_error_raises_on_the_mesh():
    t = pa.table({"a": np.arange(40, dtype="int64")})
    with pytest.raises(VeloxUserError, match="row"):
        DistributedTask(PlanBuilder().values([t, t]).project(["a % 0 as b"])
                        .plan(), make_mesh(8, "cpu")).run()


def test_local_partition_reshards_by_key(conn):
    """A LocalPartition by key on the mesh is a reshard: the grouping
    after it equals the reference's."""
    want, got = _both(lambda B: (
        B().table_scan("lineitem", ["l_suppkey", "l_quantity"],
                       connector_id="tpch-dist")
        .local_partition(["l_suppkey"], kind="repartition")
        .single_aggregation(["l_suppkey"], ["sum(l_quantity) as q"])
        .plan()))
    _same_rows(got, want)


def test_limit_over_orderby_runs_as_topn(conn):
    """ORDER BY ... LIMIT on the mesh runs as a TopN a shard and a final
    one, and gives the rows, in order, of the reference's mesh (which
    sorts every row on one shard): ties keep the shards' order in
    both."""
    want, got = _both(lambda B: (
        B().table_scan("lineitem", ["l_shipdate", "l_orderkey",
                                    "l_linenumber", "l_quantity"],
                       connector_id="tpch-dist")
        .order_by(["l_shipdate", "l_orderkey"]).limit(50).plan()))
    assert got.num_rows == 50
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("jt", ["inner", "left"])
def test_join_over_a_build_without_rows(jt):
    """A build side whose aggregation leaves no group on any shard: the
    inner join gives nothing, the left join every probe row with a NULL
    build side, as on the reference's mesh."""
    probe = [pa.table({"pk": pa.array(np.arange(i * 10, (i + 1) * 10),
                                      pa.int64())}) for i in range(3)]
    build = pa.table({"bk": pa.array(np.arange(20), pa.int64()),
                      "bv": pa.array(np.arange(20), pa.int64())})

    def plan(B):
        b = B()
        bb = (b.new_builder().values([build]).filter("bv < 0")
              .single_aggregation(["bk"], ["sum(bv) as s"]))
        return (b.values(probe)
                .hash_join(["pk"], ["bk"], bb, output=["pk", "s"],
                           join_type=jt).plan())
    want, got = _both(plan)
    _same_rows(got, want)
    assert got.num_rows == (0 if jt == "inner" else 30)

"""Spill through whole queries: the port with each spill setting against
the JAX reference.

- Counterparts of the offload and spill tests of tests/test_memory_serde.py
  (``test_aggregation_host_offload``, ``test_join_build_and_sort_offload``)
  and tests/test_query_config.py (``test_spill_switches_disable_offload``,
  ``test_max_spill_bytes_enforced``).
- The order fault of the reference (ROADMAP C): its
  ``OffloadBuffer.restore_all`` returns device, then host, then disk
  batches. A merge join whose presorted build reaches the host and the
  disk tiers raises there, and an ORDER BY with ties returns other tied
  rows. The port with spill equals the reference without it, row for
  row, and the tests show the reference's answer with spill.
- TPC-H Q1, Q3 and Q18 at SF 0.01 over 4,096-row splits under each
  setting of ``chip_smoke.py``'s spill phase, budgets computed from each
  run's first split: equal to the reference's rows without spill, with
  the query pool back at 0 and the spill directory empty after each run.
"""

import glob

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from velox_tpu.common.errors import VeloxRuntimeError as JVeloxRuntimeError
from velox_tpu.connectors.connector import (
    register_connector as jax_register_connector,
)
from velox_tpu.connectors.tpch import TpchConnector as JTpchConnector
from velox_tpu.connectors.tpch import register_tpch as jax_register_tpch
from velox_tpu.exec.memory import OffloadBuffer as JOffloadBuffer
from velox_tpu.exec.task import QueryCtx as JQueryCtx
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu.vector import device as JD
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.common.errors import VeloxRuntimeError
from velox_tpu_torch.connectors import tpch as tt
from velox_tpu_torch.connectors.cache import DataCache
from velox_tpu_torch.connectors.connector import (
    get_connector, register_connector,
)
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec.memory import MemoryArbitrator, OffloadBuffer
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.vector import device as D

torch.set_num_threads(1)

SF = 0.01
SPLIT_ROWS = 4096
PARAMS = {18: {"threshold": 240.0}}


def _counter(key):
    return M.reporter().snapshot()["counters"].get(key, 0)


# ---- counterparts of tests/test_memory_serde.py ---------------------------

def test_aggregation_host_offload():
    rng = np.random.RandomState(2)
    tables = [pa.table({"g": rng.randint(0, 50, 500).astype("int64"),
                        "v": rng.randint(0, 100, 500).astype("int64")})
              for _ in range(6)]

    def plan(mod):
        return (mod().values(tables)
                .single_aggregation(["g"], ["sum(v) as s", "count() as c"])
                .order_by(["g"]).plan())
    cfg = {QC.AGG_HOST_OFFLOAD: True, QC.AGG_COMPACT_THRESHOLD: 2}
    want = JTask(plan(JPlanBuilder), JQueryCtx(cfg)).run()
    runs = _counter(M.K_AGG_HOST_OFFLOADS)
    got = Task(plan(PlanBuilder), QueryCtx("cpu", cfg)).run()
    assert _counter(M.K_AGG_HOST_OFFLOADS) - runs == 3
    assert got.equals(want)
    assert got.equals(Task(plan(PlanBuilder), QueryCtx("cpu")).run())
    exp = pd.concat([t.to_pandas() for t in tables]).groupby("g").v.agg(
        ["sum", "size"])
    np.testing.assert_array_equal(got.column("s").to_numpy(), exp["sum"])


def test_join_build_and_sort_offload():
    rng = np.random.RandomState(3)
    probe = pa.table({"pk": rng.randint(0, 50, 400).astype("int64"),
                      "pv": np.arange(400, dtype="int64")})
    build = pa.table({"bk": np.arange(50, dtype="int64"),
                      "bv": np.arange(50, dtype="int64") * 3})

    def plan(mod):
        b = mod()
        bb = b.new_builder().values([build.slice(0, 25), build.slice(25)])
        return (b.values([probe])
                .hash_join(["pk"], ["bk"], bb, output=["pk", "pv", "bv"])
                .order_by(["pk", "pv"]).plan())
    cfg = {QC.JOIN_BUILD_OFFLOAD_BYTES: 1, QC.SORT_OFFLOAD_BYTES: 1}
    want = JTask(plan(JPlanBuilder), JQueryCtx(cfg)).run()
    joins, sorts = _counter(M.K_JOIN_BUILD_OFFLOADS), \
        _counter(M.K_SORT_OFFLOADS)
    ctx = QueryCtx("cpu", cfg)
    got = Task(plan(PlanBuilder), ctx).run()
    assert _counter(M.K_JOIN_BUILD_OFFLOADS) - joins == 2
    assert _counter(M.K_SORT_OFFLOADS) - sorts == 1
    assert got.equals(want) and got.num_rows == 400
    assert ctx.memory_pool.used == 0 and ctx.memory_pool.peak == 0


# ---- counterparts of tests/test_query_config.py ---------------------------

def test_spill_switches_disable_offload():
    t = pa.table({"x": np.arange(5000, dtype="int64")})

    def plan(mod):
        return mod().values([t]).order_by(["x DESC"]).plan()
    want = JTask(plan(JPlanBuilder)).run()
    before = _counter(M.K_SORT_OFFLOADS)
    off = {QC.SORT_OFFLOAD_BYTES: 0, QC.ORDERBY_SPILL_ENABLED: False}
    got = Task(plan(PlanBuilder), QueryCtx("cpu", off)).run()
    assert got.equals(want)
    assert _counter(M.K_SORT_OFFLOADS) == before
    got = Task(plan(PlanBuilder),
               QueryCtx("cpu", {QC.SORT_OFFLOAD_BYTES: 0})).run()
    assert got.equals(want)
    assert _counter(M.K_SORT_OFFLOADS) == before + 1


def test_join_spill_switch_leaves_the_merge_build_budget():
    """JOIN_SPILL_ENABLED false keeps a hash build on the device; a merge
    join's build reads its budget without the switch, as in the
    reference."""
    build = pa.table({"rk": np.arange(10, dtype="int64")})
    probe = pa.table({"lk": np.arange(0, 20, 2, dtype="int64")})
    cfg = {QC.JOIN_BUILD_OFFLOAD_BYTES: 0, QC.JOIN_SPILL_ENABLED: False}
    for join in ("hash_join", "merge_join"):
        def plan(mod):
            b = mod()
            bb = b.new_builder().values([build])
            return getattr(b.values([probe]), join)(
                ["lk"], ["rk"], bb, output=["lk"]).plan()
        want = JTask(plan(JPlanBuilder), JQueryCtx(cfg)).run()
        before = _counter(M.K_JOIN_BUILD_OFFLOADS)
        got = Task(plan(PlanBuilder), QueryCtx("cpu", cfg)).run()
        assert got.equals(want) and got.num_rows == 5
        assert _counter(M.K_JOIN_BUILD_OFFLOADS) - before \
            == (join == "merge_join")


@pytest.mark.parametrize("mod", ("reference", "port"))
def test_max_spill_bytes_enforced(mod, tmp_path):
    t = pa.table({"x": np.arange(4096, dtype="int64")})
    if mod == "reference":
        b, buf_cls, err = JD.from_arrow(t), JOffloadBuffer, \
            JVeloxRuntimeError
    else:
        b, buf_cls, err = D.from_arrow(t, device="cpu"), OffloadBuffer, \
            VeloxRuntimeError
    nbytes = 4096 * 8 + 4096
    buf = buf_cls(0, host_budget_bytes=2 * nbytes, spill_dir=str(tmp_path),
                  max_spill_bytes=10)
    buf.add(b)
    assert buf._host and not buf._disk
    with pytest.raises(err, match="spill limit exceeded"):
        for _ in range(4):
            buf.add(b)


def test_max_spill_bytes_through_a_query(tmp_path):
    tables = [pa.table({"x": np.arange(1000, dtype="int64") + i})
              for i in range(3)]
    ctx = QueryCtx("cpu", {QC.SORT_OFFLOAD_BYTES: 0,
                           QC.OFFLOAD_HOST_BUDGET_BYTES: 1,
                           QC.MAX_SPILL_BYTES: 20_000,
                           QC.SPILL_DIR: str(tmp_path)})
    with pytest.raises(VeloxRuntimeError, match="max_spill_bytes=20000"):
        Task(PlanBuilder().values(tables).order_by(["x"]).plan(),
             ctx).run()
    assert not glob.glob(str(tmp_path / "spill-*"))
    assert ctx.memory_pool.used == 0


# ---- the order fault of the reference -------------------------------------

def _merge_plan(mod, probe, builds):
    b = mod()
    bb = b.new_builder().values(builds)
    return (b.values([probe])
            .merge_join(["lk"], ["rk"], bb, output=["lk", "pv", "rv"])
            .plan())


def test_merge_join_through_three_tiers_keeps_the_build_sorted(tmp_path):
    """The presorted build is three 20-row batches (rk 0..59 in key
    order); device budget 0 and a host budget of 1.5 batches leave two
    on disk and one on the host. The port equals the reference without
    spill; the reference with spill restores host before disk and
    raises."""
    rng = np.random.RandomState(11)
    builds = [pa.table({"rk": np.arange(20 * i, 20 * i + 20, dtype="int64"),
                        "rv": rng.randint(0, 1000, 20).astype("int64")})
              for i in range(3)]
    probe = pa.table({"lk": rng.permutation(80).astype("int64"),
                      "pv": np.arange(80, dtype="int64")})
    one = D.from_arrow(builds[0], device="cpu").nbytes
    jone = JD.from_arrow(builds[0]).nbytes
    assert (one, jone) == (17_408, 17_408)

    def cfg(nbytes, where):
        return {QC.JOIN_BUILD_OFFLOAD_BYTES: 0,
                QC.OFFLOAD_HOST_BUDGET_BYTES: nbytes * 3 // 2,
                QC.SPILL_DIR: str(tmp_path / where)}
    want = JTask(_merge_plan(JPlanBuilder, probe, builds)).run()
    writes = _counter(M.K_SPILL_DISK_WRITES)
    ctx = QueryCtx("cpu", cfg(one, "port"))
    got = Task(_merge_plan(PlanBuilder, probe, builds), ctx).run()
    assert _counter(M.K_SPILL_DISK_WRITES) - writes == 2
    assert got.to_pylist() == want.to_pylist() and got.num_rows == 60
    assert not glob.glob(str(tmp_path / "port" / "*"))
    assert ctx.memory_pool.used == 0
    with pytest.raises(JVeloxRuntimeError, match="not sorted"):
        JTask(_merge_plan(JPlanBuilder, probe, builds),
              JQueryCtx(cfg(jone, "ref"))).run()
    # everything on disk, in order: the reference runs too
    assert JTask(_merge_plan(JPlanBuilder, probe, builds), JQueryCtx(
        {QC.JOIN_BUILD_OFFLOAD_BYTES: 0, QC.OFFLOAD_HOST_BUDGET_BYTES: 1,
         QC.SPILL_DIR: str(tmp_path / "ref")})).run().equals(want)


def test_order_by_ties_keep_their_input_order_through_spill(tmp_path):
    """ORDER BY x over three batches with ties: the stable sort keeps the
    input order of tied rows. With spill, the port's rows equal the
    reference's without spill row for row; the reference's with spill
    put the last batch's tied rows first."""
    rng = np.random.RandomState(5)
    tables = [pa.table({"x": rng.randint(0, 10, 40).astype("int64"),
                        "id": np.arange(40 * i, 40 * i + 40, dtype="int64")})
              for i in range(3)]
    one = D.from_arrow(tables[0], device="cpu").nbytes

    def plan(mod):
        return mod().values(tables).order_by(["x"]).plan()

    def cfg(nbytes, where):
        return {QC.SORT_OFFLOAD_BYTES: 0,
                QC.OFFLOAD_HOST_BUDGET_BYTES: nbytes * 3 // 2,
                QC.SPILL_DIR: str(tmp_path / where)}
    want = JTask(plan(JPlanBuilder)).run()
    got = Task(plan(PlanBuilder), QueryCtx("cpu", cfg(one, "port"))).run()
    assert got.to_pylist() == want.to_pylist()
    jspill = JTask(plan(JPlanBuilder), JQueryCtx(
        cfg(JD.from_arrow(tables[0]).nbytes, "ref"))).run()
    assert jspill.column("x").equals(want.column("x"))
    assert jspill.column("id").to_pylist() != want.column("id").to_pylist()
    assert jspill.column("id")[0].as_py() >= 80  # the host batch first


# ---- TPC-H under each spill setting of the chip phase ---------------------

@pytest.fixture
def small_splits():
    """Both engines' "tpch" connector at SF 0.01 with 4,096-row splits:
    lineitem in 15 batches, orders in 4."""
    DataCache.instance().clear()
    jax_register_connector(JTpchConnector("tpch", SF, SPLIT_ROWS))
    register_connector(tt.TpchConnector("tpch", SF, SPLIT_ROWS))
    yield
    jax_register_tpch(SF)
    tt.register_tpch(SF)
    DataCache.instance().clear()


_WANT = {}  # query -> the reference's rows without spill


def _want(q):
    if q not in _WANT:
        _WANT[q] = JTask(jax_tpch_plan(q, **PARAMS.get(q, {}))).run()
    return _WANT[q]


def _first_split_nbytes(plan, table) -> int:
    """Bytes of the first split of the plan's first scan of `table`
    (None without one)."""
    def scans(n):
        if isinstance(n, P.TableScanNode) and n.table == table:
            yield n
        for s in n.sources:
            yield from scans(s)
    node = next(scans(plan), None)
    if node is None:
        return None
    conn = get_connector(node.connector_id)
    src = conn.create_data_source(table, node.columns, QueryCtx("cpu"))
    return src.next(conn.default_splits(table)[0]).nbytes


def _settings(path, plan, spill_dir):
    li = _first_split_nbytes(plan, "lineitem")
    if path == "spill_sort":
        return {QC.SORT_OFFLOAD_BYTES: 3 * li,
                QC.OFFLOAD_HOST_BUDGET_BYTES: 7 * li // 2,
                QC.SPILL_DIR: spill_dir}
    if path == "spill_join":
        build = _first_split_nbytes(plan, "orders") or li
        return {QC.JOIN_BUILD_OFFLOAD_BYTES: 0,
                QC.OFFLOAD_HOST_BUDGET_BYTES: 3 * build // 2,
                QC.SPILL_DIR: spill_dir}
    if path == "spill_agg":
        return {QC.AGG_HOST_OFFLOAD: True, QC.AGG_COMPACT_THRESHOLD: 2}
    return {QC.QUERY_HBM_CAP_BYTES: 3 * li}  # spill_arbitration


COUNTERS = (M.K_SORT_OFFLOADS, M.K_JOIN_BUILD_OFFLOADS,
            M.K_AGG_HOST_OFFLOADS, M.K_SPILL_DISK_WRITES)


@pytest.mark.parametrize("path", ("spill_sort", "spill_join", "spill_agg",
                                  "spill_arbitration", "spill_ssd"))
@pytest.mark.parametrize("q", (1, 3, 18))
def test_tpch_under_spill_equals_the_reference(q, path, small_splits,
                                               tmp_path):
    want = _want(q)
    plan = tpch_plan(q, **PARAMS.get(q, {}))
    spill_dir = str(tmp_path / "spill")
    if path == "spill_ssd":
        # a cache over half a run's scan bytes with the SSD tier: a cold
        # run demotes, a rerun promotes, and so does a cache restarted
        # over the same directory
        Task(plan, QueryCtx("cpu")).run()
        half = DataCache.instance().used // 2
        DataCache.instance().clear()
        real = DataCache._instance
        hits = _counter(M.K_SSD_CACHE_HITS)
        try:
            for run in ("cold", "rerun", "restart"):
                if run != "rerun":
                    if DataCache._instance is not real:
                        DataCache._instance.clear()
                    DataCache._instance = DataCache(half)
                    DataCache._instance.enable_ssd(spill_dir)
                got = Task(plan, QueryCtx("cpu")).run()
                assert got.equals(want), run
            DataCache._instance.clear()
        finally:
            DataCache._instance = real
        assert _counter(M.K_SSD_CACHE_HITS) > hits
        return
    cfg = _settings(path, plan, spill_dir)
    DataCache.instance().clear()
    calls = MemoryArbitrator.instance().reclaim_calls
    before = [_counter(k) for k in COUNTERS]
    ctx = QueryCtx("cpu", cfg)
    got = Task(plan, ctx).run()
    assert got.equals(want)
    moved = dict(zip(COUNTERS, (_counter(k) - b
                                for k, b in zip(COUNTERS, before))))
    assert ctx.memory_pool.used == 0
    assert not glob.glob(spill_dir + "/*")
    if path == "spill_join" and q != 1:
        assert moved[M.K_JOIN_BUILD_OFFLOADS] > 0
        assert moved[M.K_SPILL_DISK_WRITES] > 0
    if path == "spill_agg":
        assert moved[M.K_AGG_HOST_OFFLOADS] > 0
    if path == "spill_arbitration" and q != 1:
        assert MemoryArbitrator.instance().reclaim_calls > calls

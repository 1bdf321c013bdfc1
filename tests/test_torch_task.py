"""The torch port's Task end to end against the JAX reference, on the CPU.

TPC-H Q6 (through the filter-sum operator) and the scan+filter+project
heads of Q6 and Q1 must give Arrow tables equal in value and type. Also:
the filter-sum counter fires, unported nodes raise, and importing the
whole port never imports jax. (Q1, the sorts and the generic aggregation,
and Q3, Q18 and the join have their own files: test_torch_aggregation.py,
test_torch_sort.py, test_torch_join.py.)
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.common import metrics as JM
from velox_tpu.common.errors import VeloxUserError as JVeloxUserError
from velox_tpu.connectors.tpch import register_tpch as jax_register_tpch
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.common import metrics as TM
from velox_tpu_torch.common.errors import VeloxUserError
from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.ops.filter_reduce import filtered_sum_product
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = QueryCtx(device="cpu")
Q6_COLS = ["l_shipdate", "l_extendedprice", "l_quantity", "l_discount"]
Q6_FILTER = ("l_shipdate >= date '1994-01-01' and "
             "l_shipdate < date '1995-01-01' and "
             "l_discount between 0.05 and 0.07 and "
             "l_quantity < 24.0")
Q1_COLS = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
           "l_discount", "l_tax", "l_shipdate"]
Q1_PROJECT = [
    "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
    "l_extendedprice * (1.0 - l_discount) as l_sum_disc_price",
    "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax) as l_sum_charge",
    "l_discount"]


@pytest.fixture(autouse=True)
def _tpch():
    jax_register_tpch(0.01)
    register_tpch(0.01)


def _counter(m, key):
    return m.reporter().snapshot()["counters"].get(key, 0)


def test_q6_equals_reference():
    want = JTask(jax_tpch_plan(6)).run()
    fired = _counter(TM, TM.K_FILTER_SUM_KERNEL)
    got = Task(tpch_plan(6), CPU).run()
    assert got.schema == want.schema
    assert got.equals(want)
    assert got.num_rows == 1
    assert _counter(TM, TM.K_FILTER_SUM_KERNEL) == fired + 1


def test_q6_on_cpu_runs_the_plain_version():
    launches = filtered_sum_product.launches
    Task(tpch_plan(6), CPU).run()
    assert filtered_sum_product.launches == launches


def test_q6_both_engines_pick_the_kernel():
    jf = _counter(JM, JM.K_FILTER_SUM_KERNEL)
    tf = _counter(TM, TM.K_FILTER_SUM_KERNEL)
    JTask(jax_tpch_plan(6)).run()
    Task(tpch_plan(6), CPU).run()
    assert _counter(JM, JM.K_FILTER_SUM_KERNEL) == jf + 1
    assert _counter(TM, TM.K_FILTER_SUM_KERNEL) == tf + 1


@pytest.mark.parametrize("head", ["q6", "q1", "q6_scan_only"])
def test_filter_project_heads_equal_reference(head):
    def build(builder):
        if head == "q6":
            return (builder().table_scan("lineitem", Q6_COLS,
                                         filter=Q6_FILTER)
                    .project(["l_extendedprice * l_discount as revenue"])
                    .plan())
        if head == "q1":
            return (builder().table_scan(
                "lineitem", Q1_COLS,
                filter="l_shipdate <= date '1998-09-02'")
                .project(Q1_PROJECT).plan())
        return builder().table_scan("lineitem", Q6_COLS,
                                    filter=Q6_FILTER).plan()
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.num_rows == want.num_rows > 0
    assert got.schema == want.schema
    assert got.equals(want)


def test_values_filter_project_equal_reference():
    table = pa.table({"a": pa.array([1, 2, None, 4, 5], pa.int64()),
                      "s": pa.array(["x", "y", "x", None, "z"])})

    def build(builder):
        return (builder().values([table]).filter("a > 1 or a is null")
                .project(["a * 3 as b", "s", "a is null as n"]).plan())
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.schema == want.schema
    assert got.equals(want)


def test_checked_overflow_raises_in_both():
    table = pa.table({"a": pa.array([2 ** 62, 1], pa.int64())})

    def build(builder):
        return builder().values([table]).project(["a * 4 as b"]).plan()
    with pytest.raises(JVeloxUserError):
        JTask(build(JPlanBuilder)).run()
    with pytest.raises(VeloxUserError, match="1 row"):
        Task(build(PlanBuilder), CPU).run()


def _needs_unported(query: int):
    """A plan shaped like TPC-H `query` that needs something the port
    lacks: for 1, Q1's grouping with an aggregate it does not have; for 3,
    Q3's lineitem-orders join with lineitem arriving through an Exchange
    (ROADMAP A.10); for 18, Q18's orders sent to a PartitionedOutput
    (A.10). (Q3's and Q18's own plans run: tests/test_torch_join.py.)"""
    b = PlanBuilder()
    if query == 3:
        orders = b.new_builder().table_scan("orders", ["o_orderkey"])
        join = (b.table_scan("lineitem", ["l_orderkey"])
                .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                           output=["l_orderkey"]).plan())
        return dataclasses.replace(join, left=P.ExchangeNode(
            "exchange-lineitem", row_type=join.left.output_type()))
    if query == 18:
        scan = b.table_scan("orders", ["o_orderkey", "o_custkey"]).plan()
        return P.PartitionedOutputNode(
            "output-orders", source=scan, num_partitions=2,
            keys=(ex.field("o_orderkey", scan.output_type().field_type(
                "o_orderkey")),))
    return (b.table_scan("lineitem", ["l_returnflag", "l_linestatus",
                                      "l_quantity"])
            .partial_aggregation(["l_returnflag", "l_linestatus"],
                                 ["array_agg(l_quantity) as s"])
            .final_aggregation().plan())


@pytest.mark.parametrize("query", [1, 3, 18])
def test_unported_plan_raises(query):
    with pytest.raises(NotImplementedError):
        Task(_needs_unported(query), CPU).run()


def test_unported_node_kinds_raise():
    """Each kind still to port names itself and its ROADMAP item."""
    with pytest.raises(NotImplementedError, match=r"ExchangeNode.*A\.10"):
        Task(_needs_unported(3), CPU).run()
    with pytest.raises(NotImplementedError,
                       match=r"PartitionedOutputNode.*A\.10"):
        Task(_needs_unported(18), CPU).run()


def test_local_partition_join_runs():
    """Q3's lineitem-orders join behind a local exchange, once among the
    kinds to port, runs and equals the reference."""
    def build(builder):
        b = builder()
        orders = b.new_builder().table_scan("orders", ["o_orderkey"])
        return (b.table_scan("lineitem", ["l_orderkey"])
                .local_partition(["l_orderkey"], kind="hash")
                .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                           output=["l_orderkey"])
                .single_aggregation([], ["count() as n",
                                         "sum(l_orderkey) as s"]).plan())
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.to_pylist() == want.to_pylist()
    assert got.column("n")[0].as_py() == 60213


def test_table_write_runs(tmp_path):
    """Q18's orders written out by a TableWrite, once among the kinds to
    port, writes the reference's rows."""
    from velox_tpu.connectors.hive import register_hive as jregister_hive
    from velox_tpu_torch.connectors.hive import register_hive
    jregister_hive("hive")
    register_hive("hive")
    paths = {}

    def build(builder, tag):
        paths[tag] = str(tmp_path / tag / "q18_orders.parquet")
        return (builder().table_scan("orders", ["o_orderkey", "o_custkey"])
                .table_write(paths[tag]).plan())
    want = JTask(build(JPlanBuilder, "ref")).run()
    got = Task(build(PlanBuilder, "port"), CPU).run()
    assert got.column("rows").to_pylist() == \
        want.column("rows").to_pylist() == [15000]
    assert got.column("path").to_pylist() == [paths["port"]]
    import pyarrow.parquet as pq
    back, ref = pq.read_table(paths["port"]), pq.read_table(paths["ref"])
    assert back.to_pylist() == ref.cast(back.schema).to_pylist()
    assert back.schema.field("o_orderkey").type == pa.int64()


def test_unnest_runs():
    """Unnest, once among the kinds to port, runs: the items of each
    order's l_partkey array, with their ordinality, in scan order."""
    conn = register_tpch(0.01)
    plan = (PlanBuilder().table_scan("lineitem", ["l_orderkey", "l_partkey"])
            .single_aggregation(["l_orderkey"], ["array_agg(l_partkey) as p"])
            .unnest("p", element_name="e", ordinality="o")
            .single_aggregation([], ["count() as n", "sum(e) as s",
                                     "max(o) as m"]).plan())
    got = Task(plan, CPU).run().to_pylist()
    li = conn.gen.gen_lineitem(0, conn.gen.num_rows("orders"),
                               ["l_partkey"])["l_partkey"]
    assert got == [{"n": len(li), "s": int(li.astype(np.int64).sum()),
                    "m": 7}]


def test_query_device_must_be_named():
    with pytest.raises(TypeError):
        QueryCtx()
    with pytest.raises(TypeError):
        Task(tpch_plan(6))
    conn = register_tpch(0.01)
    with pytest.raises(AttributeError):
        conn.create_data_source("lineitem", ["l_orderkey"], None)
    src = conn.create_data_source("lineitem", ["l_orderkey"], CPU)
    batch = src.next(conn.default_splits("lineitem")[0])
    assert batch.mask.device == batch.columns["l_orderkey"].data.device \
        == torch.device("cpu")


def test_port_never_imports_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import velox_tpu_torch
        for m in pkgutil.walk_packages(velox_tpu_torch.__path__,
                                       "velox_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "velox_tpu",
                                            "pandas"))
        assert not bad, bad
        for m in ("velox_tpu_torch.exec.join", "velox_tpu_torch.ops.gather"):
            assert m in sys.modules, m
        print("ok", len([k for k in sys.modules
                         if k.startswith("velox_tpu_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")

"""The torch port's Task end to end against the JAX reference, on the CPU.

TPC-H Q6 (through the filter-sum operator) and the scan+filter+project
heads of Q6 and Q1 must give Arrow tables equal in value and type. Also:
the filter-sum counter fires, a plan the port cannot run raises, the
plans that need Exchange and PartitionedOutput run as producer and
consumer Tasks, and importing the whole port never imports jax, the
reference, pandas or torch.distributed. (Q1, the sorts and the generic
aggregation, and Q3, Q18 and the join have their own files:
test_torch_aggregation.py, test_torch_sort.py, test_torch_join.py.)
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

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
    """Q1's grouping with an aggregate the port does not have."""
    return (PlanBuilder().table_scan(
        "lineitem", ["l_returnflag", "l_linestatus", "l_quantity"])
        .partial_aggregation(["l_returnflag", "l_linestatus"],
                             ["array_agg(l_quantity) as s"])
        .final_aggregation().plan())


@pytest.mark.parametrize("query", [1])
def test_unported_plan_raises(query):
    with pytest.raises(NotImplementedError):
        Task(_needs_unported(query), CPU).run()


def _fragments(query: int, E):
    """The plans that once needed an unported node kind, as (producer
    plan, consumer plan) of engine ``E`` (a namespace of its PlanBuilder,
    plan and expression modules): for 3, Q3's lineitem-orders join with
    lineitem arriving through an Exchange from a producer's scan; for 18,
    Q18's orders sent to a PartitionedOutput of 2 partitions and read
    back by an Exchange. (Q3's and Q18's own plans run:
    tests/test_torch_join.py.)"""
    b = E.PB()
    if query == 3:
        scan = b.table_scan("lineitem", ["l_orderkey"]).plan()
        orders = b.new_builder().table_scan("orders", ["o_orderkey"])
        join = (b.hash_join(["l_orderkey"], ["o_orderkey"], orders,
                            output=["l_orderkey"])
                .single_aggregation([], ["count() as n",
                                         "sum(l_orderkey) as s"]).plan())
        exch = E.P.ExchangeNode("exchange-lineitem",
                                row_type=scan.output_type())
        consumer = dataclasses.replace(join, source=dataclasses.replace(
            join.source, left=exch))
        producer = E.P.PartitionedOutputNode(
            "output-lineitem", source=scan, num_partitions=1,
            keys=(E.ex.field("l_orderkey", scan.output_type().field_type(
                "l_orderkey")),))
        return producer, consumer
    scan = b.table_scan("orders", ["o_orderkey", "o_custkey"]).plan()
    producer = E.P.PartitionedOutputNode(
        "output-orders", source=scan, num_partitions=2,
        keys=(E.ex.field("o_orderkey", scan.output_type().field_type(
            "o_orderkey")),))
    return producer, E.P.ExchangeNode("exchange-orders",
                                      row_type=scan.output_type())


@pytest.mark.parametrize("query", [3, 18])
def test_exchange_plans_equal_reference(query):
    """The plans of Q3 and Q18 that needed Exchange and PartitionedOutput
    run: a producer Task feeds consumer Tasks over the in-process
    transport, in each engine, and every destination's rows are the
    reference's."""
    from velox_tpu.core import expressions as Jex
    from velox_tpu.core import plan as JP
    from velox_tpu.exec.exchange import OutputBufferManager as JOBM
    from velox_tpu.exec.task import QueryCtx as JQueryCtx
    from velox_tpu_torch.exec.exchange import OutputBufferManager
    ref = SimpleNamespace(PB=JPlanBuilder, P=JP, ex=Jex, obm=JOBM,
                          run=lambda p, c: JTask(p, JQueryCtx(c)).run())
    port = SimpleNamespace(PB=PlanBuilder, P=P, ex=ex,
                           obm=OutputBufferManager,
                           run=lambda p, c: Task(p, QueryCtx("cpu", c)).run())
    out = {}
    for tag, E in (("ref", ref), ("port", port)):
        producer, consumer = _fragments(query, E)
        tid = f"q{query}-producer-{tag}"
        assert E.run(producer, {"task.id": tid}).num_rows == 0
        exchange_id = "exchange-lineitem" if query == 3 else consumer.id
        out[tag] = [E.run(consumer, {
            f"exchange.{exchange_id}.tasks": [tid],
            "task.destination": d}).to_pylist()
            for d in range(producer.num_partitions)]
        E.obm.instance().remove(tid)
    assert out["port"] == out["ref"]
    if query == 3:
        assert out["port"][0][0]["n"] == 60213
    else:
        assert sum(map(len, out["port"])) == 15000
        assert all(out["port"])


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
        for m in ("velox_tpu_torch.exec.join", "velox_tpu_torch.ops.gather",
                  "velox_tpu_torch.parallel",
                  "velox_tpu_torch.parallel.distributed",
                  "velox_tpu_torch.exec.exchange",
                  "velox_tpu_torch.exec.exchange_net"):
            assert m in sys.modules, m
        # torch imports torch.distributed itself: read the imports of
        # every port module instead
        import ast
        for name, mod in list(sys.modules.items()):
            if not name.startswith("velox_tpu_torch"):
                continue
            tree = ast.parse(open(mod.__file__).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else
                         [node.module or ""]
                         if isinstance(node, ast.ImportFrom) else [])
                assert not any(n.startswith("torch.distributed")
                               for n in names), name
        print("ok", len([k for k in sys.modules
                         if k.startswith("velox_tpu_torch")]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")

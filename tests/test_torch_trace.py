"""The port's tracing, replay, thread-state spans, debug switches and
fault-injecting connector against the JAX reference, on the CPU.

Counterparts of tests/test_trace.py, tests/test_process_trace.py and of
test_faulty_connector and test_debug_sync_operators_attributes_walls in
tests/test_observability.py.
"""

import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.connectors.connector import (
    register_connector as jregister_connector,
)
from velox_tpu.connectors.faulty import FaultyConnector as JFaultyConnector
from velox_tpu.connectors.faulty import error_hook as jerror_hook
from velox_tpu.connectors.tpch import TpchConnector as JTpchConnector
from velox_tpu.core.config import QueryConfig as JQC
from velox_tpu.exec.task import QueryCtx as JQueryCtx
from velox_tpu.exec.task import Task as JTask
from velox_tpu.exec.trace import replay_operator as jreplay_operator
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.common.process_trace import (
    TraceContext, recent, status_lines,
)
from velox_tpu_torch.connectors.connector import register_connector
from velox_tpu_torch.connectors.faulty import FaultyConnector, error_hook
from velox_tpu_torch.connectors.tpch import TpchConnector
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.exec.trace import (
    load_plan, read_trace_inputs, replay_operator,
)
from velox_tpu_torch.expression import eval as ev
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan

torch.set_num_threads(1)


def _frame(n=300, seed=1):
    rng = np.random.RandomState(seed)
    return pa.table({"g": rng.randint(0, 5, n).astype("int64"),
                     "v": rng.randint(0, 100, n).astype("int64")})


def _agg_plan(B, t):
    return (B().values([t.slice(0, 150), t.slice(150)])
            .filter("v > 10")
            .single_aggregation(["g"], ["sum(v) as s", "count() as c"])
            .plan())


def _rows(t):
    return t.sort_by("g").to_pylist()


# ---------------------------------------------------------------------------
# tests/test_trace.py
# ---------------------------------------------------------------------------

def test_trace_and_replay(tmp_path):
    t = _frame()
    plan = _agg_plan(PlanBuilder, t)
    task = Task(plan, QueryCtx("cpu", {
        QC.TRACE_ENABLED: True, QC.TRACE_DIR: str(tmp_path / "trace")}))
    original = task.run()
    jplan = _agg_plan(JPlanBuilder, t)
    JTask(jplan, JQueryCtx({JQC.TRACE_ENABLED: True,
                            JQC.TRACE_DIR: str(tmp_path / "jtrace")})).run()

    # the plan and the aggregation's inputs were recorded
    assert (tmp_path / "trace" / "plan.txt").read_text() == \
        (tmp_path / "jtrace" / "plan.txt").read_text()
    assert load_plan(str(tmp_path / "trace")) == plan
    got_in = list(read_trace_inputs(str(tmp_path / "trace"), plan.id))
    want_in = list(read_trace_inputs(str(tmp_path / "jtrace"), jplan.id))
    assert [x.num_rows for x in got_in] == [x.num_rows for x in want_in]
    assert [x.to_pylist() for x in got_in] == [
        x.cast(y.schema).to_pylist() for x, y in zip(want_in, got_in)]

    # replay only the aggregation over its recorded inputs
    replayed = replay_operator(str(tmp_path / "trace"), plan.id, "cpu")
    jreplayed = jreplay_operator(str(tmp_path / "jtrace"), jplan.id)
    assert _rows(replayed) == _rows(original)
    assert _rows(replayed) == _rows(jreplayed)

    out = task.print_plan_with_stats()
    assert "Aggregation" in out and "ms" in out


def test_trace_node_ids_select_the_traced_operators(tmp_path):
    t = _frame()
    plan = _agg_plan(PlanBuilder, t)
    Task(plan, QueryCtx("cpu", {
        QC.TRACE_ENABLED: True, QC.TRACE_DIR: str(tmp_path),
        QC.TRACE_NODE_IDS: plan.id})).run()
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("node-")) == [f"node-{plan.id}"]
    # off unless enabled: no directory, no files
    Task(plan, QueryCtx("cpu", {QC.TRACE_DIR: str(tmp_path / "off")})).run()
    assert not (tmp_path / "off").exists()


# ---------------------------------------------------------------------------
# tests/test_process_trace.py
# ---------------------------------------------------------------------------

def test_status_line_and_history():
    gate = threading.Event()
    done = threading.Event()

    def work():
        with TraceContext("HashJoin[3] add_input"):
            gate.set()
            done.wait(5)

    t = threading.Thread(target=work, name="driver-1")
    t.start()
    gate.wait(5)
    lines = status_lines()
    assert any("HashJoin[3] add_input" in ln and "driver-1" in ln
               for ln in lines), lines
    done.set()
    t.join()
    assert not any("HashJoin[3]" in ln for ln in status_lines())
    assert any("HashJoin[3] add_input" in h for h in recent(t.ident))


def test_task_driver_emits_spans():
    """Operator phases appear in the thread's history after a query."""
    df = pa.table({"x": np.arange(100, dtype="int64")})
    Task(PlanBuilder().values([df])
         .single_aggregation([], ["sum(x) as s"]).plan(),
         QueryCtx("cpu")).run()
    hist = recent()
    assert any("finish" in h for h in hist), hist
    assert any("add_input" in h for h in hist), hist


# ---------------------------------------------------------------------------
# tests/test_observability.py
# ---------------------------------------------------------------------------

def test_faulty_connector():
    jinner = JTpchConnector("tpch-f-inner", scale_factor=0.001,
                            rows_per_split=2048)
    inner = TpchConnector("tpch-f-inner", 0.001, 2048)
    jfaulty = JFaultyConnector(jinner, "tpch-faulty")
    faulty = FaultyConnector(inner, "tpch-faulty")
    jregister_connector(jfaulty)
    register_connector(faulty)

    def build(B):
        return B().table_scan("nation", ["n_nationkey", "n_name"],
                              connector_id="tpch-faulty").plan()
    ctx = QueryCtx("cpu")
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), ctx).run()
    assert got.num_rows == 25 and got.equals(want)

    jfaulty.set_fault_hook(jerror_hook(IOError("disk on fire")))
    faulty.set_fault_hook(error_hook(IOError("disk on fire")))
    with pytest.raises(IOError, match="disk on fire"):
        JTask(build(JPlanBuilder)).run()
    with pytest.raises(IOError, match="disk on fire"):
        Task(build(PlanBuilder), ctx).run()
    faulty.clear_fault_hook()
    jfaulty.clear_fault_hook()
    assert Task(build(PlanBuilder), ctx).run().equals(want)


def test_debug_sync_operators_attributes_walls():
    """With ``debug_sync_operators`` the operator walls cover most of the
    query's wall and the join's build is timed. (On the CPU the switch
    synchronizes nothing: the work is done when each call returns.)"""
    import time
    register_connector(TpchConnector("tpch-sync", 0.01, 1 << 14))
    plan = tpch_plan(3, connector_id="tpch-sync")
    ctx = {"debug_sync_operators": True}
    Task(plan, QueryCtx("cpu", ctx)).run()  # warm
    t0 = time.perf_counter()
    task = Task(plan, QueryCtx("cpu", ctx))
    task.run()
    wall = time.perf_counter() - t0
    attributed = sum(
        op.stats.add_input_wall_ns + op.stats.get_output_wall_ns
        + op.stats.finish_wall_ns + op.stats.build_wall_ns
        for op in task.operators) / 1e9
    assert attributed > 0.15 * wall
    assert "+build" in task.print_plan_with_stats()


def test_debug_disable_cse_is_reset_after_the_run():
    seen = []
    real = ev._eval_uncached

    def spy(expr, ctx, cache):
        seen.append(ev._cse_disabled)
        return real(expr, ctx, cache)
    t = pa.table({"x": np.arange(10, dtype="int64")})
    plan = (PlanBuilder().values([t])
            .project(["(x + 1) * (x + 1) as y"]).plan())
    ev._eval_uncached = spy
    try:
        got = Task(plan, QueryCtx("cpu", {QC.DEBUG_DISABLE_CSE: True})).run()
    finally:
        ev._eval_uncached = real
    assert seen and all(seen)
    assert not ev._cse_disabled
    assert got.column("y").to_pylist() == [(i + 1) ** 2 for i in range(10)]

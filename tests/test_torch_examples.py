"""The port's examples (``velox_tpu_torch/examples/``) run on the CPU.

Each example runs as a user runs it, in a subprocess with ``--device
cpu`` and a timeout of its own. Its printed result table must equal, as
printed, the same plan run in-process through the reference at the same
data. Without the flag an example asks for CUDA, and where there is none
it raises instead of falling back to the CPU.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from velox_tpu.connectors.connector import register_connector
from velox_tpu.connectors.hive import register_hive
from velox_tpu.connectors.tpch import TpchConnector, register_tpch
from velox_tpu.exec.task import Task
from velox_tpu.parallel import DistributedTask, make_mesh
from velox_tpu.testing.plan_builder import PlanBuilder
from velox_tpu.tpch import tpch_plan

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "velox_tpu_torch" / "examples"
TIMEOUT_S = 120


def _example(name):
    """The example's module, loaded without running its main."""
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, *args):
    return subprocess.run(
        [sys.executable, str(EXAMPLES / f"{name}.py"), *args], cwd=REPO,
        capture_output=True, text=True, timeout=TIMEOUT_S)


def _tpch_query():
    register_tpch(0.01)
    return Task(tpch_plan(6)).run()


def _custom_plan():
    return Task(PlanBuilder()
                .values([_example("02_custom_plan").ORDERS])
                .filter("total > 8.0")
                .single_aggregation(["cust"], ["sum(total) as spend",
                                               "count(*) as n"])
                .order_by(["spend desc"])
                .plan()).run()


def _parquet_scan(tmp_path):
    ex = _example("03_parquet_scan")
    root = str(tmp_path / "sales")
    conn = register_hive()
    Task(PlanBuilder().values([ex.sales()])
         .table_write(root, partition_keys=["region"]).plan()).run()
    conn.register_table("sales", root)
    return Task(PlanBuilder()
                .table_scan("sales", ["region", "amount"],
                            connector_id="hive", filter=ex.FILTER)
                .single_aggregation(["region"], ["sum(amount) as s",
                                                 "count(*) as n"])
                .plan()).run()


def _distributed_mesh():
    register_connector(TpchConnector("tpch-d", scale_factor=0.01,
                                     rows_per_split=16384))
    plan = (PlanBuilder()
            .table_scan("lineitem", ["l_returnflag", "l_quantity"],
                        connector_id="tpch-d")
            .single_aggregation(["l_returnflag"], ["sum(l_quantity) as q",
                                                   "count(*) as n"])
            .order_by(["l_returnflag"])
            .plan())
    return DistributedTask(plan, make_mesh(8)).run()


REFERENCE = {
    "01_tpch_query": lambda tmp_path: _tpch_query(),
    "02_custom_plan": lambda tmp_path: _custom_plan(),
    "03_parquet_scan": _parquet_scan,
    "04_distributed_mesh": lambda tmp_path: _distributed_mesh(),
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_example_on_cpu_prints_the_reference_result(name, tmp_path):
    out = _run(name, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    want = REFERENCE[name](tmp_path)
    assert want.num_rows > 0
    printed = str(want)
    assert "----" in printed and printed in out.stdout, \
        (out.stdout[:2000], printed)


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_example_asks_for_cuda_by_default(name):
    out = _run(name)
    if torch.cuda.is_available():
        assert out.returncode == 0, out.stderr[-2000:]
    else:
        assert out.returncode != 0
        assert "CUDA is not available; pass --device cpu" in out.stderr

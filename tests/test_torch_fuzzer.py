"""The port's differential plan fuzzer (velox_tpu_torch/testing/
plan_fuzzer.py, a copy of the reference's aimed at the port's Task): the
20 seeds of tests/test_fuzzer.py against SQLite, and each seed's plan
through both engines, equal row for row (as sets)."""

import pyarrow as pa
import pytest
import torch

from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing import plan_fuzzer
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

SEEDS = range(20)


def test_plan_fuzzer_vs_sqlite():
    results = plan_fuzzer.run_many(SEEDS, "cpu")
    assert len(results) == 20


def _rows(t: pa.Table):
    rows = list(zip(*(t.column(c).to_pylist() for c in t.column_names)))
    return sorted(rows, key=lambda r: tuple(
        (v is None, v if v is not None else 0) for v in r))


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzzer_plans_equal_reference(seed):
    jplan, _, _, jdesc = plan_fuzzer.make_case(seed, builder=JPlanBuilder)
    plan, _, _, desc = plan_fuzzer.make_case(seed, builder=PlanBuilder)
    assert desc == jdesc
    want = JTask(jplan).run()
    got = Task(plan, QueryCtx("cpu")).run()
    assert got.schema == want.schema
    g, w = _rows(got), _rows(want)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        assert rg == pytest.approx(rw, rel=1e-9)

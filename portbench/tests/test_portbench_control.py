"""The check that decides ``correct`` fails what it must fail, on the CPU
at SF 0.01.

* The control: the plain reference computed in float32 (the precision
  below the configuration's exact DECIMAL sums and float64 DOUBLEs), put
  in the program's place, fails the limits on every seed tried.
* The faults: a run whose timed path is broken underneath, driven from
  set-up to the check with the look for a card skipped, reports
  ``correct`` false: an answer altered where it is produced, its rows
  put out of their ORDER BY's order, and half of every scanned batch
  left out (the aggregates taken over the rest). The
  other faults of the contract do not exist in these cells: no step
  carries state from one query to the next, and one card exchanges
  nothing.
"""

import time

import pyarrow as pa
import pytest
from portbench_support import root  # noqa: F401

from portbench import harness
from portbench.reference import compare, oracles


CELLS = ["tpch_sf10_parquet.bench4", "tpch_sf10.bench5"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_float32_control_fails(root, cell, seed):
    _, cell, cfg, mix = harness.load_cell(cell, root)
    run = harness.Run(cell, cfg, mix, seed, "cpu")
    from portbench import traffic
    stream = traffic.stream(mix, seed, cfg["scale_factor"])
    exact, low = run.reference(), run.reference(oracles.FLOAT32)
    bad, widest = 0, 0.0
    for q, params in stream:
        b, w = compare.gaps(oracles.ANSWERS[q](low, **params),
                            oracles.ANSWERS[q](exact, **params),
                            harness.ORDER_BY[q])
        bad, widest = bad + b, max(widest, w or 0.0)
    lim = cfg["correct_limits"]
    # the cells' answers hold no DOUBLE: the rows separate the control
    assert bad > lim["mismatched_rows"] and widest == 0.0


def _altered(table):
    """The table with its first number changed."""
    for i, field in enumerate(table.schema):
        t = field.type
        if table.num_rows and (pa.types.is_integer(t)
                               or pa.types.is_decimal(t)
                               or pa.types.is_floating(t)):
            vals = table.column(i).to_pylist()
            if vals[0] is None:
                continue
            vals[0] = vals[0] * 1.001 + 1 if pa.types.is_floating(t) \
                else vals[0] + 1
            return table.set_column(i, field, pa.array(vals, type=t))
    return table


def test_an_altered_answer_is_not_correct(root, monkeypatch):
    from velox_tpu_torch.exec import task
    real = task.Task.run
    monkeypatch.setattr(task.Task, "run",
                        lambda self: _altered(real(self)))
    out = harness.run_cell("tpch_sf10.bench5", 21, 0.2, False, "cpu",
                           time.time(), root=root)
    assert out["correct"] is False
    assert out["check"]["mismatched_rows"]["value"] > 0


def test_half_of_each_batch_left_out_is_not_correct(root, monkeypatch):
    from velox_tpu_torch.connectors import tpch
    real = tpch.TpchDataSource.next

    def half(self, split):
        batch = real(self, split)
        if batch is None:
            return None
        mask = batch.mask.clone()
        mask[1::2] = False
        return batch.with_mask(mask)

    monkeypatch.setattr(tpch.TpchDataSource, "next", half)
    out = harness.run_cell("tpch_sf10.bench5", 22, 0.2, False, "cpu",
                           time.time(), root=root)
    assert out["correct"] is False
    assert out["check"]["mismatched_rows"]["value"] > 0


def test_rows_out_of_order_are_not_correct(root, monkeypatch):
    """The program's rows in reverse: every answer of more than one row
    whose ORDER BY sets its order reads as rows out of place."""
    from velox_tpu_torch.exec import task
    real = task.Task.run

    def reversed_rows(self):
        table = real(self)
        return table.take(list(range(table.num_rows - 1, -1, -1)))

    monkeypatch.setattr(task.Task, "run", reversed_rows)
    out = harness.run_cell("tpch_sf10.bench5", 23, 0.2, False, "cpu",
                           time.time(), root=root)
    assert out["correct"] is False
    assert out["check"]["mismatched_rows"]["value"] > 0

"""All 22 TPC-H queries through the port, against the JAX reference, at
SF 0.01.

Each query runs through the port twice with a scan prefetch depth of 2:
cold (the scan cache cleared, every split generated and uploaded by a
producer thread) and warm (every split from the cache), and once more in
both engines over 4,096-row splits. Every run must equal the reference's
result: integers, decimals, dates and strings exactly, doubles within the
reference oracle's relative tolerance (tests/tpch_sql.py ``TOLERANCES``).
Q18 uses threshold 240, the spec's 300 selects no order at this scale.

The reference orders a dictionary string by its dictionary id (ROADMAP C,
"faults of the reference that the port does not copy"), and the TPC-H
connector's ``n_name`` is in key order, so Q9's ``ORDER BY nation,
o_year DESC`` comes out of order there. For Q9 the port is held to the
reference's rows put into that order by value (``IN_VALUE_ORDER``), and
``tests/test_torch_tpch_sqlite.py`` holds every query's order to SQLite.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from tpch_sql import TOLERANCES
from velox_tpu.connectors.tpch import register_tpch as jax_register_tpch
from velox_tpu.exec.task import Task as JTask
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu_torch.connectors.cache import DataCache
from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.core.expressions import Constant
from velox_tpu_torch.core.plan import FilterNode
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.tpch import tpch_plan

torch.set_num_threads(1)

SF = 0.01
QUERIES = tuple(range(1, 23))
PARAMS = {18: {"threshold": 240.0}}
# queries whose ORDER BY sorts the connector's unsorted n_name dictionary
IN_VALUE_ORDER = {9: [("nation", "ascending"), ("o_year", "descending")]}


@pytest.fixture(autouse=True)
def _tpch():
    jax_register_tpch(SF)
    register_tpch(SF)


def _reference(q: int, **params) -> pa.Table:
    """The reference's answer, in ORDER BY order by value where the
    reference orders by dictionary id (a stable sort of its rows)."""
    want = JTask(jax_tpch_plan(q, **params)).run()
    if q in IN_VALUE_ORDER:
        want = want.sort_by(IN_VALUE_ORDER[q])
    return want


def _assert_matches(got: pa.Table, want: pa.Table, rel_tol: float):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):
            gv = np.asarray(g.to_pylist(), dtype=np.float64)
            wv = np.asarray(w.to_pylist(), dtype=np.float64)
            np.testing.assert_allclose(gv, wv, rtol=rel_tol, err_msg=name)
        else:
            assert g.equals(w), (name, g.to_pylist()[:5], w.to_pylist()[:5])


@pytest.mark.parametrize("q", QUERIES)
def test_query_cold_and_warm_equal_reference(q):
    params = PARAMS.get(q, {})
    want = _reference(q, **params)
    assert want.num_rows > 0
    rel_tol = TOLERANCES.get(q, (1e-9, 1))[0]
    cache = DataCache.instance()
    cache.clear()
    ctx = QueryCtx("cpu", {QC.SCAN_PREFETCH_DEPTH: 2})
    lookups = []
    for _ in ("cold", "warm"):
        misses, hits = cache.misses, cache.hits
        got = Task(tpch_plan(q, **params), ctx).run()
        _assert_matches(got, want, rel_tol)
        lookups.append((cache.misses - misses, cache.hits - hits))
    (cold_misses, cold_hits), (warm_misses, warm_hits) = lookups
    # a cold run hits only where two of its scans read the same columns
    # (Q21's lineitem); the warm one takes every split from the cache
    assert cold_misses > 0 and warm_misses == 0
    assert warm_hits == cold_misses + cold_hits


@pytest.fixture
def _small_splits():
    """Both engines' "tpch" connector at SF 0.01 with 4,096-row splits:
    lineitem in 15 batches, orders in 4."""
    from velox_tpu.connectors.connector import (
        register_connector as jax_register_connector,
    )
    from velox_tpu.connectors.tpch import TpchConnector as JTpchConnector
    from velox_tpu_torch.connectors import tpch as tt
    from velox_tpu_torch.connectors.connector import register_connector
    DataCache.instance().clear()
    jax_register_connector(JTpchConnector("tpch", SF, 4096))
    register_connector(tt.TpchConnector("tpch", SF, 4096))
    yield
    jax_register_tpch(SF)
    register_tpch(SF)
    DataCache.instance().clear()


@pytest.mark.parametrize("q", QUERIES)
def test_query_in_small_splits_equal_reference(q, _small_splits):
    """A query over 4,096-row splits: many batches a scan, so the
    aggregations compact and the joins probe batch after batch."""
    params = PARAMS.get(q, {})
    want = _reference(q, **params)
    got = Task(tpch_plan(q, **params), QueryCtx("cpu")).run()
    _assert_matches(got, want, TOLERANCES.get(q, (1e-9, 1))[0])


def _constants(expr):
    if isinstance(expr, Constant):
        yield expr.value
    for c in expr.children:
        yield from _constants(c)


@pytest.mark.parametrize("fraction", [0.0001, 0.0001 / 10, 0.0001 / 3000,
                                      1e-14])
def test_q11_threshold_is_the_fraction_itself(fraction):
    """Q11's plan compares against the same float the caller passed: the
    spec's 0.0001 / SF, at SF 3000 too, is not cut to a number of
    decimals."""
    node = tpch_plan(11, fraction=fraction)
    while not isinstance(node, FilterNode):
        (node,) = node.sources
    assert fraction in list(_constants(node.predicate))

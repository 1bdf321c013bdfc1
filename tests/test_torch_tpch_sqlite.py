"""All 22 TPC-H queries through the port's serial Task at SF 0.01,
against SQLite over the same generated rows.

Counterpart of tests/test_tpch_queries.py::test_tpch_query, which holds
the reference's serial Task to SQLite. The SQL is the port's copy
(``velox_tpu_torch.testing.tpch_sql``, with Q1, Q3, Q6 and Q18 added);
money compares exactly as scaled integers, doubles within the reference
oracle's TOLERANCES. Q18 uses threshold 240, as the port's other SF 0.01
tests do: the spec's 300 selects no order at this scale.

Each query is also held to SQLite's rows in its ORDER BY order
(``tpch_sql.ORDER_BY``): rows may trade places only within a run of
equal keys. The TPC-H connector's ``n_name`` dictionary is in key order,
not name order (CHINA is id 18), so Q9's ``ORDER BY nation`` and Q7's
nation pairs check that a dictionary string sorts by its value.
"""

import pytest
import torch

from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing import golden as G
from velox_tpu_torch.testing.tpch_sql import ORDER_BY, TOLERANCES, oracle_sql
from velox_tpu_torch.tpch import tpch_plan

torch.set_num_threads(1)

SF = 0.01
PARAMS = {18: {"threshold": 240.0}}


_ANSWERS = {}


@pytest.fixture(scope="module")
def oracle():
    return G.load_generated(register_tpch(SF))


def _answers(q, oracle, **params):
    """(the port's table, SQLite's) for ``q``, each run once a module."""
    key = (q, tuple(sorted(params.items())))
    if key not in _ANSWERS:
        _ANSWERS[key] = (Task(tpch_plan(q, **params), QueryCtx("cpu")).run(),
                         oracle.query(oracle_sql(q, **params)))
    return _ANSWERS[key]


@pytest.mark.parametrize("q", range(1, 23))
def test_query_equals_sqlite(q, oracle):
    rel_tol = TOLERANCES.get(q, (1e-9, 1))[0]
    got, exp = _answers(q, oracle, **PARAMS.get(q, {}))
    # every query is held to a row that holds a value, not to an empty
    # result or a row of NULLs on both sides
    assert G.assert_matches_sqlite(got, exp, rel_tol) >= 1, \
        f"Q{q}: no real row to compare"


@pytest.mark.parametrize("q", range(1, 23))
def test_query_rows_in_order_by_order(q, oracle):
    rel_tol = TOLERANCES.get(q, (1e-9, 1))[0]
    got, exp = _answers(q, oracle, **PARAMS.get(q, {}))
    assert G.assert_matches_sqlite(got, exp, rel_tol,
                                   order=ORDER_BY[q]) >= 1


@pytest.mark.parametrize("nation1,nation2", [("CHINA", "INDIA"),
                                             ("INDIA", "CHINA")])
def test_q7_nation_pair_against_its_ids_in_order(nation1, nation2, oracle):
    """CHINA (id 18) and INDIA (id 8): the pair's ids run against their
    names, so ``ORDER BY supp_nation, cust_nation`` holds only by value."""
    from velox_tpu_torch.connectors.tpch import NATIONS
    assert NATIONS.index("CHINA") > NATIONS.index("INDIA")
    got, exp = _answers(7, oracle, nation1=nation1, nation2=nation2)
    assert G.assert_matches_sqlite(got, exp, order=ORDER_BY[7]) >= 2
    nations = got.column("supp_nation").to_pylist()
    assert nations == sorted(nations) and set(nations) == {"CHINA", "INDIA"}


def test_ordered_comparison_sees_a_misplaced_row():
    """The ordered form fails where two runs trade rows and where the
    oracle is out of its own order; the multiset form passes both."""
    import pyarrow as pa
    exp = pa.table({"k": ["a", "b", "b", "c"], "v": [1, 2, 3, 4]})
    swapped = pa.table({"k": ["a", "b", "b", "c"], "v": [1, 3, 2, 4]})
    moved = pa.table({"k": ["b", "a", "b", "c"], "v": [2, 1, 3, 4]})
    order = [(0, False)]
    assert G.assert_matches_sqlite(swapped, exp, order=order) == 4
    assert G.assert_matches_sqlite(moved, exp) == 4
    with pytest.raises(AssertionError):
        G.assert_matches_sqlite(moved, exp, order=order)
    with pytest.raises(AssertionError, match="out of its order"):
        G.assert_matches_sqlite(exp, moved, order=order)

"""Real dbgen output through the port, against SQLite.

Counterpart of tests/test_dbgen_golden.py. The data in
tests/data/dbgen_sf001 was produced by Velox's vendored TPC dbgen (the
README there), not by either engine's generator, so a fault the two
generators share shows here. ``velox_tpu_torch.testing.golden`` reads the
``.tbl.gz`` files with pyarrow.csv, writes them as Parquet for the port's
Hive connector and loads the same rows into SQLite. All 22 queries run
through the port's serial Task on the CPU with the reference's
GOLDEN_PARAMS; money compares exactly as scaled integers, doubles within
the reference oracle's TOLERANCES, and every query compares at least one
real row.
"""

import decimal
from pathlib import Path

import pandas as pd
import pytest
import torch

import test_dbgen_golden as ref_golden
import tpch_sql as ref_sql
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing import golden as G
from velox_tpu_torch.testing import tpch_sql
from velox_tpu_torch.tpch import tpch_plan

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data" / "dbgen_sf001"
CONNECTOR = "hive-dbgen"
ROWS = {"lineitem": 60175, "orders": 15000, "customer": 1500,
        "part": 2000, "partsupp": 8000, "supplier": 10000, "nation": 25,
        "region": 5}


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    _, oracle, rows = G.load_golden(
        str(DATA), str(tmp_path_factory.mktemp("golden_parquet")),
        CONNECTOR)
    assert rows == ROWS
    return oracle


def _run(q):
    params = G.GOLDEN_PARAMS.get(q, {})
    return Task(tpch_plan(q, connector_id=CONNECTOR, **params),
                QueryCtx("cpu")).run()


@pytest.mark.parametrize("q", range(1, 23))
def test_query_on_real_dbgen_equals_sqlite(q, golden):
    exp = golden.query(tpch_sql.oracle_sql(q, **G.GOLDEN_PARAMS.get(q, {})))
    real_rows = G.assert_matches_sqlite(
        _run(q), exp, tpch_sql.TOLERANCES.get(q, (1e-9, 1))[0])
    # an empty or all-NULL oracle result would make the comparison vacuous
    assert real_rows >= 1, f"Q{q} compares no real row on this snapshot"


def test_one_cent_off_is_a_difference(golden):
    got = _run(6)
    exp = golden.query(tpch_sql.oracle_sql(6))
    G.assert_matches_sqlite(got, exp)
    cents = got.column("revenue").to_pylist()[0] + decimal.Decimal("0.0001")
    off = got.set_column(0, "revenue", [[cents]]).cast(got.schema)
    with pytest.raises(AssertionError):
        G.assert_matches_sqlite(off, exp)


@pytest.mark.parametrize("table", sorted(ROWS))
def test_loader_reads_the_rows_the_reference_reads(table):
    """pyarrow.csv gives the table the reference's pandas reader gives
    (tests/test_dbgen_golden.py, its dates parsed as in its fixture)."""
    cols = G.COLUMNS[table]
    fields = ["r_regionkey", "r_name", "_join", "r_comment"] \
        if table == "region" else cols
    df = ref_golden._read_tbl(table, fields)[cols]
    for c in cols:
        if c in ref_golden._DATES:
            df[c] = pd.to_datetime(df[c])
    want = ref_golden._to_parquet_table(df, cols)
    got = G.parquet_table(G.read_tbl(str(DATA), table))
    assert got.schema == want.schema
    assert got.equals(want)


def test_oracle_sql_is_the_references_where_both_have_it():
    assert tpch_sql.TOLERANCES == ref_sql.TOLERANCES
    for q, sql in ref_sql.ORACLE_SQL.items():
        assert tpch_sql.oracle_sql(q) == sql, q
    for q, params in ref_golden.GOLDEN_PARAMS.items():
        assert G.GOLDEN_PARAMS[q] == params
        assert tpch_sql.oracle_sql(q, **params) == \
            ref_sql.oracle_sql(q, **params), q
    assert sorted(tpch_sql.ORACLE_SQL) == list(range(1, 23))

"""External correctness oracle backed by SQLite (Python stdlib).

Role parity: the reference's DuckDB oracle (``velox/exec/tests/utils/
QueryAssertions.h:216-258`` — createDuckDbTable + assertQuery). DuckDB is
not available in this environment, so the independent engine is SQLite:
the *same physical data* the engine scans is loaded into an in-memory
SQLite database and real SQL runs against it. This kills the round-1
self-referential validation (pandas oracles written by the same author
over the engine's own data): SQLite is a complete third-party SQL engine
with its own parser, planner, and executor.

Exactness policy: money columns are DECIMAL scaled ints in the engine;
the oracle receives the SAME scaled ints and the SQL is written against
them (e.g. ``l_discount BETWEEN 5 AND 7``), so sums compare bit-exact in
int64. Averages and floating results compare with a relative tolerance.
Dates are epoch-day ints on both sides.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import pandas as pd


class SqliteOracle:
    """Loads pandas frames into in-memory SQLite and runs SQL."""

    def __init__(self):
        self.con = sqlite3.connect(":memory:")

    def load(self, name: str, df: pd.DataFrame) -> None:
        df = df.copy()
        for c in df.columns:
            if pd.api.types.is_datetime64_any_dtype(df[c]):
                df[c] = (df[c].to_numpy("datetime64[D]")
                         - np.datetime64("1970-01-01")).astype("int64")
        df.to_sql(name, self.con, index=False, if_exists="replace")

    def query(self, sql: str) -> pd.DataFrame:
        cur = self.con.execute(sql)
        names = [d[0] for d in cur.description]
        return pd.DataFrame(cur.fetchall(), columns=names)


def _normalize(df: pd.DataFrame) -> pd.DataFrame:
    """Canonical dtypes for comparison: dates -> epoch days, Decimal ->
    float64, pandas NA -> NaN."""
    import decimal
    out = {}
    for c in df.columns:
        s = df[c]
        if pd.api.types.is_datetime64_any_dtype(s):
            out[c] = ((s.to_numpy("datetime64[D]")
                       - np.datetime64("1970-01-01")).astype("float64"))
            continue
        # extension dtypes (nullable Int64, Arrow/pandas strings) and
        # object columns go value-wise; plain numpy dtypes pass through
        if s.dtype == object or not isinstance(s.dtype, np.dtype):
            vals = list(s.astype(object).where(~s.isna(), None))
            vals = [float(v) if isinstance(v, decimal.Decimal) else v
                    for v in vals]
            if all(v is None or isinstance(v, (int, float, np.floating,
                                               np.integer, bool))
                   for v in vals):
                vals = np.asarray(
                    [np.nan if v is None else float(v) for v in vals])
        else:
            vals = s.to_numpy()
        out[c] = vals
    return pd.DataFrame(out)


def assert_frames_match(got: pd.DataFrame, exp: pd.DataFrame,
                        sort: bool = True, rel_tol: float = 1e-9) -> None:
    """Order-insensitive (optionally) row-set comparison with exact ints/
    strings and relative-tolerance floats."""
    assert len(got) == len(exp), (len(got), len(exp))
    got = _normalize(got)
    exp = _normalize(exp)
    exp.columns = list(got.columns)  # positional match
    if sort and len(got):
        cols = list(got.columns)
        got = got.sort_values(cols, kind="mergesort").reset_index(drop=True)
        exp = exp.sort_values(cols, kind="mergesort").reset_index(drop=True)
    for c in got.columns:
        g, e = got[c], exp[c]
        if not (pd.api.types.is_numeric_dtype(g)
                and pd.api.types.is_numeric_dtype(e)):
            ga = [None if v is None or (isinstance(v, float) and v != v)
                  else v for v in g.astype(object)]
            ea = [None if v is None or (isinstance(v, float) and v != v)
                  else v for v in e.astype(object)]
            assert ga == ea, f"column {c}"
            continue
        g = g.to_numpy("float64")
        e = e.to_numpy("float64")
        gn, en = np.isnan(g), np.isnan(e)
        np.testing.assert_array_equal(gn, en, err_msg=f"column {c} nulls")
        np.testing.assert_allclose(g[~gn], e[~en], rtol=rel_tol,
                                   err_msg=f"column {c}")


def assert_query(task_output, oracle: SqliteOracle, sql: str,
                 ordered: bool = False, rel_tol: float = 1e-9) -> None:
    """assertQuery parity (QueryAssertions.h:216): engine plan output
    (pyarrow Table) vs oracle SQL over the same data."""
    got = task_output.to_pandas()
    exp = oracle.query(sql)
    assert_frames_match(got, exp, sort=not ordered, rel_tol=rel_tol)

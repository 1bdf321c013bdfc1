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
Dates are epoch-day ints on both sides. (The reference's copy holds
pandas frames; this one pyarrow tables, so that the port needs no
pandas.)
"""

from __future__ import annotations

import datetime
import decimal
import sqlite3

import numpy as np

_EPOCH = datetime.date(1970, 1, 1)


def _sql_value(v):
    """A Python value as SQLite stores it: dates as epoch days."""
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    return v


class SqliteOracle:
    """Loads pyarrow tables into in-memory SQLite and runs SQL."""

    def __init__(self):
        self.con = sqlite3.connect(":memory:")

    def load(self, name: str, table) -> None:
        cols = [[_sql_value(v) for v in table.column(c).to_pylist()]
                for c in table.column_names]
        names = ", ".join(f'"{c}"' for c in table.column_names)
        self.con.execute(f'drop table if exists "{name}"')
        self.con.execute(f'create table "{name}" ({names})')
        marks = ", ".join("?" * len(cols))
        self.con.executemany(f'insert into "{name}" values ({marks})',
                             zip(*cols))

    def query(self, sql: str):
        """The rows of ``sql`` as a pyarrow Table (types inferred)."""
        import pyarrow as pa
        cur = self.con.execute(sql)
        names = [d[0] for d in cur.description]
        rows = cur.fetchall()
        return pa.table({n: pa.array([r[i] for r in rows])
                         for i, n in enumerate(names)})


def _normalize(table) -> list:
    """Each column as a list for comparison: dates as epoch days,
    Decimals as floats, and a column of numbers (or NULLs) as a float64
    array with NaN for NULL."""
    out = []
    for c in table.column_names:
        vals = [_sql_value(v) for v in table.column(c).to_pylist()]
        vals = [float(v) if isinstance(v, decimal.Decimal) else v
                for v in vals]
        if all(v is None or (isinstance(v, (int, float, np.floating,
                                            np.integer))
                             and not isinstance(v, bool)) for v in vals):
            vals = np.asarray([np.nan if v is None else float(v)
                               for v in vals], dtype=np.float64)
        out.append(vals)
    return out


def _sort_key(row):
    return tuple((v is None or (isinstance(v, float) and v != v),
                  0 if v is None or (isinstance(v, float) and v != v)
                  else v) for v in row)


def assert_frames_match(got, exp, sort: bool = True,
                        rel_tol: float = 1e-9) -> None:
    """Order-insensitive (optionally) row-set comparison of two pyarrow
    tables, columns matched by position: exact ints and strings, floats
    within ``rel_tol``, NULLs in the same places."""
    assert got.num_rows == exp.num_rows, (got.num_rows, exp.num_rows)
    g_cols, e_cols = _normalize(got), _normalize(exp)
    assert len(g_cols) == len(e_cols), (got.column_names,
                                        exp.column_names)
    if sort and got.num_rows:
        g_rows = sorted(zip(*(list(c) for c in g_cols)), key=_sort_key)
        e_rows = sorted(zip(*(list(c) for c in e_cols)), key=_sort_key)
        g_cols = [list(c) for c in zip(*g_rows)]
        e_cols = [list(c) for c in zip(*e_rows)]
    for name, g, e in zip(got.column_names, g_cols, e_cols):
        numeric = [isinstance(x, np.ndarray) or all(
            isinstance(v, float) for v in x) for x in (g, e)]
        if not all(numeric):
            fix = [[None if isinstance(v, float) and v != v else v
                    for v in x] for x in (g, e)]
            assert fix[0] == fix[1], f"column {name}"
            continue
        g = np.asarray(g, dtype=np.float64)
        e = np.asarray(e, dtype=np.float64)
        gn, en = np.isnan(g), np.isnan(e)
        np.testing.assert_array_equal(gn, en,
                                      err_msg=f"column {name} nulls")
        np.testing.assert_allclose(g[~gn], e[~en], rtol=rel_tol,
                                   err_msg=f"column {name}")


def assert_query(task_output, oracle: SqliteOracle, sql: str,
                 ordered: bool = False, rel_tol: float = 1e-9) -> None:
    """assertQuery parity (QueryAssertions.h:216): engine plan output
    (pyarrow Table) vs oracle SQL over the same data."""
    assert_frames_match(task_output, oracle.query(sql), sort=not ordered,
                        rel_tol=rel_tol)

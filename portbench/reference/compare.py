"""The comparison that decides ``correct``.

A query's answer (a pyarrow Table from the program) is turned into rows
of plain values: DECIMAL as scaled integers, DATE as days since
1970-01-01, strings, integers, DOUBLE as floats. It is then compared with
the reference's rows in the order that the query's ORDER BY
(``plans/order_by.json``) sets: the reference's rows, which must come out
in that order, fall into runs of equal keys, and the program's rows at
the same places must hold the same run as a multiset, so rows trade
places only among equal keys (a query with no ORDER BY is one run).
Every non-DOUBLE value is compared exactly, each DOUBLE by its relative
gap to the reference's value. ``gaps`` returns the two numbers the
harness holds to their limits: the rows that differ (a missing, extra or
misplaced row counts as one) and the widest relative DOUBLE gap (None
where the answer holds no DOUBLE value, as in Q1, Q3, Q6 and Q18).
"""

from __future__ import annotations

import datetime
import math
from typing import List, Optional, Sequence, Tuple

_EPOCH = datetime.date(1970, 1, 1)


def _plain(v):
    if isinstance(v, datetime.date):
        return (v - _EPOCH).days
    return v


def rows_of(table) -> Tuple[List[str], List[tuple]]:
    """(column names, rows) of a pyarrow Table, values made plain; a
    DECIMAL column's integers are at its declared scale."""
    import pyarrow as pa
    cols = []
    for field, col in zip(table.schema, table.columns):
        vals = col.to_pylist()
        if pa.types.is_decimal(field.type):
            s = field.type.scale
            vals = [None if v is None else int(v.scaleb(s)) for v in vals]
        else:
            vals = [_plain(v) for v in vals]
        cols.append(vals)
    return list(table.column_names), list(zip(*cols)) if cols else []


def _key(row):
    return tuple((v is None, 0 if v is None or isinstance(v, float) else v)
                 for v in row)


def _gap(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else math.inf
    return abs(a - b) / abs(b) if b != 0 else abs(a - b)


def ordered(rows: Sequence[tuple], keys: Sequence[Tuple[int, bool]]
            ) -> bool:
    """Whether ``rows`` come in the order of ``keys``: (column, descending)
    pairs, the first the most significant."""
    for a, b in zip(rows, rows[1:]):
        for i, desc in keys:
            if a[i] != b[i]:
                if (a[i] > b[i]) != desc:
                    return False
                break
    return True


def runs(rows: Sequence[tuple], keys: Sequence[Tuple[int, bool]]
         ) -> List[Tuple[int, int]]:
    """[start, end) of each run of rows whose keys are equal."""
    out, start = [], 0
    for i in range(1, len(rows) + 1):
        if i == len(rows) or any(rows[i][k] != rows[start][k]
                                 for k, _ in keys):
            out.append((start, i))
            start = i
    return out


def gaps(got: Tuple[Sequence[str], Sequence[tuple]],
         want: Tuple[Sequence[str], Sequence[tuple]],
         order: Sequence[Sequence[str]] = ()
         ) -> Tuple[int, Optional[float]]:
    """(rows that differ, widest relative DOUBLE gap or None) of an answer
    against the reference's, in the order of ``order``: [(column, "asc" or
    "desc")]."""
    names, rows = got
    want_names, want_rows = want
    if list(names) != list(want_names):
        return max(len(rows), len(want_rows), 1), None
    keys = [(list(names).index(c), d == "desc") for c, d in order]
    if not ordered(want_rows, keys):
        raise AssertionError(f"the reference's rows are not in the order "
                             f"{list(order)}")
    bad = abs(len(rows) - len(want_rows))
    widest = None
    for lo, hi in runs(want_rows, keys) if keys else [(0, len(want_rows))]:
        for g, w in zip(sorted(rows[lo:hi], key=_key),
                        sorted(want_rows[lo:hi], key=_key)):
            differs = False
            for a, b in zip(g, w):
                if isinstance(b, float) and isinstance(a, float):
                    widest = max(widest or 0.0, _gap(a, b))
                elif a != b:
                    differs = True
            bad += differs
    return bad, widest

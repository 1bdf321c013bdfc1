"""Randomized testing: vector fuzzer + expression/aggregation fuzzers.

Counterpart of ``velox_tpu/testing/fuzzer.py`` (velox/vector/fuzzer/
VectorFuzzer.h:43-88, expression/fuzzer/ExpressionFuzzer.cpp and
exec/fuzzer/AggregationFuzzer.cpp): random columns with random NULLs,
random expression trees and group-by plans run through the port's
``Task`` on the device the caller names, checked against an independent
evaluator in plain Python with SQL NULL semantics (the reference's is in
pandas; this one needs only numpy and pyarrow). The data of a seed is the
reference's: the same draws in the same order.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex


class VectorFuzzer:
    """Random columnar data with random NULLs (host-side pyarrow)."""

    SCALAR_TYPES = (T.BIGINT, T.INTEGER, T.SMALLINT, T.DOUBLE, T.REAL,
                    T.BOOLEAN, T.DATE, T.VARCHAR, T.decimal(12, 2))

    def __init__(self, seed: int = 0, null_ratio: float = 0.1):
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.null_ratio = null_ratio

    def random_type(self) -> T.DataType:
        return self.rng.choice(self.SCALAR_TYPES)

    def random_values(self, dtype: T.DataType, n: int, with_nulls: bool = True
                      ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(values, NULL mask or None) of one random column; a DECIMAL's
        values are its unscaled integers."""
        r = self.np_rng
        if dtype.kind is T.TypeKind.BOOLEAN:
            v = r.rand(n) > 0.5
        elif dtype.is_integral:
            info = np.iinfo(dtype.np_dtype())
            lo, hi = max(info.min, -10**6), min(info.max, 10**6)
            v = r.randint(lo, hi, n).astype(dtype.np_dtype())
        elif dtype.kind is T.TypeKind.DOUBLE:
            v = r.randn(n) * 100
        elif dtype.kind is T.TypeKind.REAL:
            v = (r.randn(n) * 100).astype(np.float32)
        elif dtype.kind is T.TypeKind.DATE:
            v = np.array(r.randint(0, 20000, n), dtype="datetime64[D]")
        elif dtype.kind is T.TypeKind.DECIMAL:
            v = r.randint(-10**7, 10**7, n)  # scaled cents
        elif dtype.is_string:
            words = ["apple", "pear", "fig", "kiwi", "lime", "plum", ""]
            v = r.choice(words, n)
        else:
            raise TypeError(dtype)
        nulls = None
        if with_nulls and self.null_ratio > 0:
            mask = r.rand(n) < self.null_ratio
            if mask.any():
                nulls = mask
        return v, nulls

    def random_table(self, n: int, num_cols: int = 4):
        import decimal as pydec

        import pyarrow as pa
        cols, types = {}, {}
        for i in range(num_cols):
            dt = self.random_type()
            name = f"c{i}"
            v, nulls = self.random_values(dt, n)
            types[name] = dt
            if dt.kind is T.TypeKind.DECIMAL:
                cols[name] = pa.array(
                    [None if nulls is not None and nulls[j]
                     else pydec.Decimal(int(x)).scaleb(-2)
                     for j, x in enumerate(v)], pa.decimal128(12, 2))
            else:
                cols[name] = pa.array(v, T.to_arrow(dt), mask=nulls)
        return pa.table(cols), types


# ---------------------------------------------------------------------------
# Independent reference evaluator (Python values, SQL null semantics).
# ---------------------------------------------------------------------------

class RefEvaluator:
    """Evaluates a TypedExpr over columns of Python values (None = NULL)
    with SQL three-valued logic. DECIMAL columns hold ``Decimal`` values
    and DECIMAL constants their float value, as in the reference."""

    def __init__(self, columns: Dict[str, List], types: Dict[str, T.DataType]):
        self.columns = columns
        self.types = types
        self.n = len(next(iter(columns.values()))) if columns else 0

    def eval(self, e: ex.TypedExpr) -> List:
        if isinstance(e, ex.FieldAccess):
            return self.columns[e.name]
        if isinstance(e, ex.Constant):
            v = e.value
            if v is not None and e.dtype.kind is T.TypeKind.DECIMAL:
                v = v / 10.0 ** e.dtype.scale
            if e.dtype.kind is T.TypeKind.DATE and isinstance(v, str):
                v = np.datetime64(v)
            return [v] * self.n
        if isinstance(e, ex.Call):
            return self._call(e)
        raise NotImplementedError(type(e).__name__)

    def _binary(self, e, fn) -> List:
        a, b = self.eval(e.args[0]), self.eval(e.args[1])
        return [None if x is None or y is None else fn(x, y)
                for x, y in zip(a, b)]

    def _call(self, e: ex.Call) -> List:
        name = e.name
        arith = {"plus": lambda x, y: x + y, "minus": lambda x, y: x - y,
                 "multiply": lambda x, y: x * y}
        cmp = {"eq": lambda x, y: x == y, "neq": lambda x, y: x != y,
               "lt": lambda x, y: x < y, "lte": lambda x, y: x <= y,
               "gt": lambda x, y: x > y, "gte": lambda x, y: x >= y}
        if name in arith:
            return self._binary(e, arith[name])
        if name in cmp:
            return self._binary(e, cmp[name])
        if name in ("and", "or"):
            a, b = self.eval(e.args[0]), self.eval(e.args[1])
            dominant = name == "or"  # the value that decides alone
            out = []
            for x, y in zip(a, b):
                xb = None if x is None else bool(x)
                yb = None if y is None else bool(y)
                if xb is dominant or yb is dominant:
                    out.append(dominant)
                elif xb is None or yb is None:
                    out.append(None)
                else:
                    out.append(not dominant)
            return out
        if name == "not":
            return [None if x is None else (not bool(x))
                    for x in self.eval(e.args[0])]
        if name == "is_null":
            return [x is None for x in self.eval(e.args[0])]
        if name == "coalesce":
            cols = [self.eval(a) for a in e.args]
            return [next((c[i] for c in cols if c[i] is not None), None)
                    for i in range(self.n)]
        if name == "if":
            c = self.eval(e.args[0])
            t = self.eval(e.args[1])
            f = self.eval(e.args[2]) if len(e.args) > 2 else [None] * self.n
            return [t[i] if c[i] is not None and bool(c[i]) else f[i]
                    for i in range(self.n)]
        if name == "between":
            x, lo, hi = (self.eval(a) for a in e.args[:3])
            return [None if a is None or b is None or c is None
                    else b <= a <= c for a, b, c in zip(x, lo, hi)]
        raise NotImplementedError(name)


# ---------------------------------------------------------------------------
# Expression fuzzer
# ---------------------------------------------------------------------------

class ExpressionFuzzer:
    """Generates random boolean/numeric expression trees over a fuzzed
    table, evaluates them through the engine on ``device`` and through
    the reference evaluator, and compares (NULLs exactly; numbers within
    1e-9)."""

    def __init__(self, seed: int = 0, rows: int = 200, *, device):
        self.seed = seed
        self.rows = rows
        self.device = device

    def _gen_expr(self, rng: random.Random, types: Dict[str, T.DataType],
                  want: str, depth: int) -> Optional[ex.TypedExpr]:
        numeric_cols = [n for n, t in types.items()
                        if t.is_numeric and t.kind is not T.TypeKind.REAL]
        bool_cols = [n for n, t in types.items()
                     if t.kind is T.TypeKind.BOOLEAN]
        if want == "bool":
            choices = ["cmp", "and", "or", "not", "is_null", "between"]
            if bool_cols:
                choices.append("col")
            if depth <= 0:
                choices = ["col"] if bool_cols else ["cmp"]
            kind = rng.choice(choices)
            if kind == "col":
                c = rng.choice(bool_cols)
                return ex.field(c, types[c])
            if kind in ("and", "or"):
                a = self._gen_expr(rng, types, "bool", depth - 1)
                b = self._gen_expr(rng, types, "bool", depth - 1)
                if a is None or b is None:
                    return None
                return ex.Call(T.BOOLEAN, kind, (a, b))
            if kind == "not":
                a = self._gen_expr(rng, types, "bool", depth - 1)
                if a is None:
                    return None
                return ex.Call(T.BOOLEAN, "not", (a,))
            if kind == "is_null":
                a = self._gen_expr(rng, types, "num", depth - 1)
                if a is None:
                    return None
                return ex.Call(T.BOOLEAN, "is_null", (a,))
            if kind == "between":
                if not numeric_cols:
                    return None
                c = rng.choice(numeric_cols)
                f = ex.field(c, types[c])
                lo = ex.Constant(T.INTEGER, rng.randint(-100, 0))
                hi = ex.Constant(T.INTEGER, rng.randint(0, 100))
                return ex.Call(T.BOOLEAN, "between", (f, lo, hi))
            # cmp
            a = self._gen_expr(rng, types, "num", depth - 1)
            b = self._gen_expr(rng, types, "num", depth - 1)
            if a is None or b is None:
                return None
            op = rng.choice(["eq", "neq", "lt", "lte", "gt", "gte"])
            return ex.Call(T.BOOLEAN, op, (a, b))
        # numeric
        if depth <= 0 or not numeric_cols:
            if numeric_cols and rng.random() < 0.7:
                c = rng.choice(numeric_cols)
                return ex.field(c, types[c])
            return ex.Constant(T.INTEGER, rng.randint(-50, 50))
        kind = rng.choice(["col", "const", "arith", "if", "coalesce"])
        if kind == "col":
            c = rng.choice(numeric_cols)
            return ex.field(c, types[c])
        if kind == "const":
            return ex.Constant(T.INTEGER, rng.randint(-50, 50))
        if kind == "arith":
            a = self._gen_expr(rng, types, "num", depth - 1)
            b = self._gen_expr(rng, types, "num", depth - 1)
            if a is None or b is None:
                return None
            from velox_tpu_torch.functions.scalar import arith_resolver
            op = rng.choice(["plus", "minus", "multiply"])
            try:
                out_t = arith_resolver(op)([a.dtype, b.dtype])
            except Exception:
                return None
            if out_t is None:
                return None
            if op == "multiply" and (
                    a.dtype.kind is T.TypeKind.DECIMAL
                    or b.dtype.kind is T.TypeKind.DECIMAL):
                return None  # scale bookkeeping diverges from a float ref
            return ex.Call(out_t, op, (a, b))
        if kind == "if":
            c = self._gen_expr(rng, types, "bool", depth - 1)
            a = self._gen_expr(rng, types, "num", 0)
            b = self._gen_expr(rng, types, "num", 0)
            if None in (c, a, b) or a.dtype != b.dtype:
                return None
            return ex.Call(a.dtype, "if", (c, a, b))
        # coalesce
        a = self._gen_expr(rng, types, "num", 0)
        b = self._gen_expr(rng, types, "num", 0)
        if a is None or b is None or a.dtype != b.dtype:
            return None
        return ex.Call(a.dtype, "coalesce", (a, b))

    def run(self, iterations: int = 50) -> int:
        """Run fuzz iterations; returns the number of expressions checked."""
        from velox_tpu_torch.exec.task import QueryCtx, Task
        from velox_tpu_torch.testing.plan_builder import PlanBuilder
        checked = 0
        for it in range(iterations):
            rng = random.Random(self.seed + it)
            vf = VectorFuzzer(self.seed + it, null_ratio=0.15)
            # numeric/bool columns only for the expression fuzzer
            table, types = vf.random_table(self.rows, num_cols=4)
            keep = {n: t for n, t in types.items()
                    if (t.is_numeric or t.kind is T.TypeKind.BOOLEAN)
                    and t.kind is not T.TypeKind.REAL}
            if not keep:
                continue
            table = table.select(list(keep))
            expr = self._gen_expr(rng, keep, rng.choice(["bool", "num"]), 3)
            if expr is None:
                continue
            plan = (PlanBuilder().values([table])
                    .project_exprs([("out", expr)]).plan())
            got = Task(plan, QueryCtx(self.device)).run() \
                .column("out").to_pylist()
            ref = RefEvaluator({n: table.column(n).to_pylist()
                                for n in keep}, keep).eval(expr)
            self._compare(got, ref, expr, it)
            checked += 1
        return checked

    @staticmethod
    def _compare(got: List, ref: List, expr, it):
        g_null = np.array([v is None for v in got], dtype=bool)
        r_null = np.array([v is None for v in ref], dtype=bool)
        if not np.array_equal(g_null, r_null):
            raise AssertionError(
                f"[iter {it}] null mismatch for {expr}: "
                f"{int(g_null.sum())} vs {int(r_null.sum())} nulls")
        gv = np.array([float(v) for v in got if v is not None])
        rv = np.array([float(v) for v in ref if v is not None])
        if len(gv) and not np.allclose(gv, rv, rtol=1e-9, atol=1e-9):
            bad = np.nonzero(~np.isclose(gv, rv))[0][:5]
            raise AssertionError(
                f"[iter {it}] value mismatch for {expr} at {bad}: "
                f"{gv[bad]} vs {rv[bad]}")


class AggregationFuzzer:
    """Random group-by plans on ``device`` checked against a numpy
    group-by. Parity: exec/fuzzer/AggregationFuzzer.cpp."""

    def __init__(self, seed: int = 0, rows: int = 400, *, device):
        self.seed = seed
        self.rows = rows
        self.device = device

    def run(self, iterations: int = 20) -> int:
        import pyarrow as pa

        from velox_tpu_torch.exec.task import QueryCtx, Task
        from velox_tpu_torch.testing.plan_builder import PlanBuilder
        checked = 0
        for it in range(iterations):
            rng = np.random.RandomState(self.seed + it)
            pyr = random.Random(self.seed + it)
            n = self.rows
            g = rng.randint(0, pyr.choice([1, 3, 17, 120]), n).astype("int64")
            x = rng.randint(-1000, 1000, n).astype("int64")
            y = rng.randn(n) * 10
            x_null = np.zeros(n, dtype=bool)
            if pyr.random() < 0.3:
                x_null = rng.rand(n) < 0.2
            aggs = pyr.sample(
                ["sum(x) as s", "count(x) as c", "min(x) as mn",
                 "max(x) as mx", "sum(y) as sy", "count() as call"],
                k=pyr.randint(1, 4))
            table = pa.table({"g": g, "x": pa.array(x, mask=x_null), "y": y})
            plan = (PlanBuilder().values([table])
                    .single_aggregation(["g"], aggs)
                    .order_by(["g"]).plan())
            got = Task(plan, QueryCtx(self.device)).run()
            keys, inv = np.unique(g, return_inverse=True)
            cols = {"x": (x.astype(np.float64), ~x_null),
                    "y": (y, np.ones(n, dtype=bool))}
            for a in aggs:
                name = a.split(" as ")[1]
                fn = a.split("(")[0]
                col = a.split("(")[1].split(")")[0]
                if fn == "count":
                    ok = cols[col][1] if col else np.ones(n, dtype=bool)
                    exp = np.bincount(inv, weights=ok, minlength=len(keys))
                else:
                    vals, ok = cols[col]
                    cnt = np.bincount(inv, weights=ok, minlength=len(keys))
                    exp = np.full(len(keys), np.nan)
                    for k in range(len(keys)):
                        sel = vals[(inv == k) & ok]
                        if len(sel):
                            exp[k] = {"sum": np.sum, "min": np.min,
                                      "max": np.max}[fn](sel)
                    exp[cnt == 0] = np.nan  # SQL: NULL over no value
                gv = got.column(name).to_pylist()
                g_null = np.array([v is None for v in gv], dtype=bool)
                if not np.array_equal(g_null, np.isnan(exp)):
                    raise AssertionError(f"[iter {it}] {a}: null mismatch")
                gvv = np.array([float(v) for v in gv if v is not None])
                if not np.isclose(gvv, exp[~np.isnan(exp)], rtol=1e-9).all():
                    raise AssertionError(f"[iter {it}] {a}: mismatch")
            checked += 1
        return checked

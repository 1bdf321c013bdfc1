"""Randomized plan fuzzer cross-checked against the SQLite oracle.

Role parity: velox/exec/fuzzer (PlanFuzzer / join & aggregation fuzzers):
random plans over random tables, executed both by this engine and by an
engine we didn't write, row-set compared. Plans compose scan(values) ->
filter -> project -> [join] -> [aggregate | distinct] -> [order/limit],
mirroring the SQL the oracle runs.

A copy of ``velox_tpu/testing/plan_fuzzer.py`` aimed at this package's
Task: ``run_one`` and ``run_many`` take the device the plans run on, and
``make_case`` builds a seed's plan with either package's PlanBuilder, so
that one seed's plan can run through both engines. Its tables are pyarrow
tables (the reference's are pandas frames), the same rows.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import pyarrow as pa

from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.oracle import SqliteOracle, assert_frames_match
from velox_tpu_torch.testing.plan_builder import PlanBuilder


def _rand_table(rng: np.random.RandomState, n: int) -> pa.Table:
    a = rng.randint(0, 20, n).astype("int64")
    b = rng.randint(-100, 100, n).astype("int64")
    c = rng.randint(0, 1000, n).astype("int64")
    d = rng.choice(["x", "y", "z", "w"], n)
    # sprinkle nulls into b (nullable int)
    mask = rng.rand(n) < 0.1
    return pa.table({"a": a, "b": pa.array(b, mask=mask), "c": c, "d": d})


_FILTERS = [
    ("a < 10", "a < 10"),
    ("b > 0", "b > 0"),
    ("c % 7 = 0", "c % 7 = 0"),
    ("a < 10 and c > 100", "a < 10 and c > 100"),
    ("d = 'x'", "d = 'x'"),
    (None, None),
]

_PROJECTIONS = [
    (["a", "b", "c", "d"], "a, b, c, d"),
    (["a", "b + c as s", "d"], "a, b + c as s, d"),
    (["a * 2 as a2", "c", "d"], "a * 2 as a2, c, d"),
]

_AGGS = [
    (["a"], ["sum(c) as sc", "count(*) as n"],
     "select a, sum(c) as sc, count(*) as n from {} group by a"),
    (["d"], ["min(b) as mb", "max(c) as mc", "count(b) as cb"],
     "select d, min(b) as mb, max(c) as mc, count(b) as cb "
     "from {} group by d"),
    (["a", "d"], ["sum(b) as sb"],
     "select a, d, sum(b) as sb from {} group by a, d"),
    ([], ["sum(c) as sc", "count(*) as n", "avg(c) as ac"],
     "select sum(c) as sc, count(*) as n, avg(c * 1.0) as ac from {}"),
    (None, None, None),
]


def make_case(seed: int, n_rows: int = 500, builder=PlanBuilder):
    """One random plan (built with ``builder``) and its SQL over the
    loaded oracle: (plan, sql, oracle, description)."""
    rng = np.random.RandomState(seed)
    table = _rand_table(rng, n_rows)
    oracle = SqliteOracle()
    oracle.load("t", table)

    filt, filt_sql = _FILTERS[rng.randint(len(_FILTERS))]
    proj, proj_sql = _PROJECTIONS[rng.randint(len(_PROJECTIONS))]
    gkeys, gaggs, agg_sql = _AGGS[rng.randint(len(_AGGS))]

    pb = builder().values([table])
    inner_sql = "t"
    desc = []
    if rng.rand() < 0.4:
        # join a small dimension table on column a
        dim = pa.table({
            "ak": np.arange(0, 20, 2, dtype="int64"),
            "w": rng.randint(0, 50, 10).astype("int64")})
        oracle.load("dim", dim)
        bb = pb.new_builder().values([dim])
        pb = pb.hash_join(["a"], ["ak"], bb,
                          output=["a", "b", "c", "d", "w"])
        inner_sql = ("(select t.a, t.b, t.c, t.d, dim.w from t "
                     "join dim on t.a = dim.ak)")
        desc.append("join[a=ak]")
        # downstream stages see the joined relation as "t"
        inner_sql = inner_sql
        oracle.con.execute(
            f"create view tj as select * from {inner_sql}")
        inner_sql = "tj"
    if filt is not None:
        pb = pb.filter(filt)
        inner_sql = f"(select * from {inner_sql} where {filt_sql})"
        desc.append(f"filter[{filt}]")
    pb = pb.project(proj)
    inner_sql = f"(select {proj_sql} from {inner_sql})"
    desc.append(f"project[{proj_sql}]")
    out_names = [p.split(" as ")[-1].strip() for p in proj]

    if gaggs is not None:
        keys_avail = [k for k in (gkeys or []) if k in out_names]
        aggs_ok = all(
            any(col in out_names for col in (spec.split("(")[1]
                                             .split(")")[0],))
            or "(*" in spec or "()" in spec
            for spec in gaggs)
        if (gkeys is None or len(keys_avail) == len(gkeys)) and aggs_ok:
            pb = pb.single_aggregation(gkeys, gaggs)
            sql = agg_sql.format(inner_sql)
            desc.append(f"agg[{','.join(gkeys)}]")
        else:
            sql = f"select * from {inner_sql}"
    else:
        sql = f"select * from {inner_sql}"

    return pb.plan(), sql, oracle, " -> ".join(desc)


def run_one(seed: int, device, n_rows: int = 500) -> Tuple[str, int]:
    """Build one random plan + equivalent SQL; execute both; compare.
    Returns (description, result row count)."""
    plan, sql, oracle, desc = make_case(seed, n_rows)
    got = Task(plan, QueryCtx(device)).run()
    assert_frames_match(got, oracle.query(sql), sort=True)
    return desc, got.num_rows


def run_many(seeds, device) -> List[str]:
    out = []
    for s in seeds:
        desc, n = run_one(s, device)
        out.append(f"seed {s}: {desc} ({n} rows)")
    return out

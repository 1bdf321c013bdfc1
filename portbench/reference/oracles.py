"""Plain numpy answers to the benchmark's queries.

Each function takes a ``Tables`` (the benchmark's own generator, cached
column by column) and the query's substitution parameters, and returns
``(column names, rows)``: DECIMAL values as scaled integers, DATE as days
since 1970-01-01, strings as ``str``, DOUBLE as ``float``. The arithmetic
is a frozen copy of the numpy oracles that held the program's SF10 runs,
fed from ``tpchgen`` instead of the program's connector.

Each answer's rows come in the order of the query's ORDER BY
(``plans/order_by.json``, TPC-H's): a query with a LIMIT orders its rows
itself before the cut, and ``ANSWERS`` sorts every answer stably by
those keys, as SQL's ORDER BY does.

Every sum goes through ``Tables.arith``: ``EXACT`` (int64 sums, exact as
Python ints, and float64 doubles) answers the reference; ``FLOAT32``
(float32 accumulation and doubles) is the lower-precision control that
the comparison must fail.
"""

from __future__ import annotations

import datetime
import json
import threading
from pathlib import Path
from typing import Callable, Dict, Sequence

import numpy as np

from portbench.reference.tpchgen import TpchGen


def day(iso: str) -> int:
    return (datetime.date.fromisoformat(iso)
            - datetime.date(1970, 1, 1)).days


D94, D95 = day("1994-01-01"), day("1995-01-01")


class Exact:
    """Sums as exact integers, doubles in float64."""

    @staticmethod
    def sum(a: np.ndarray) -> int:
        a = np.asarray(a, dtype=np.int64)
        return sum(int(a[i:i + (1 << 20)].sum())
                   for i in range(0, len(a), 1 << 20))

    @classmethod
    def group_sum(cls, gid: np.ndarray, v: np.ndarray, groups: int,
                  what: str = "") -> np.ndarray:
        # float64 bincount sums are exact while every partial sum stays
        # below 2^53
        if cls.sum(np.abs(v)) >= 2 ** 53:
            raise ArithmeticError(f"{what} sums exceed float64's integers")
        return np.bincount(gid, weights=v, minlength=groups).astype(np.int64)

    @staticmethod
    def dbl(x) -> float:
        return float(np.float64(x))


class Float32:
    """The control: the same sums accumulated in float32, doubles in
    float32, rounded back to the result's type."""

    @staticmethod
    def sum(a: np.ndarray) -> int:
        return int(np.rint(np.sum(np.asarray(a, dtype=np.float32),
                                  dtype=np.float32)))

    @staticmethod
    def group_sum(gid, v, groups, what=""):
        out = np.zeros(groups, np.float32)
        np.add.at(out, np.asarray(gid, dtype=np.int64),
                  np.asarray(v, dtype=np.float32))
        return np.rint(out).astype(np.int64)

    @staticmethod
    def dbl(x) -> float:
        return float(np.float32(x))


EXACT, FLOAT32 = Exact(), Float32()


class Tables:
    """Whole columns of the generator's tables as int64 arrays, each
    generated once; ``li`` is lineitem's."""

    def __init__(self, gen: TpchGen, arith=EXACT):
        self.gen, self.arith = gen, arith
        self._cols: Dict = {}
        self._lock = threading.Lock()  # answers may be worked out at once

    def cols(self, table: str, names: Sequence[str]) -> Dict[str, np.ndarray]:
        with self._lock:
            missing = [c for c in names if (table, c) not in self._cols]
            if missing:
                for c, v in self.gen.table(table, missing).items():
                    self._cols[(table, c)] = v.astype(np.int64)
            return {c: self._cols[(table, c)] for c in names}

    def li(self, *names: str) -> Dict[str, np.ndarray]:
        return self.cols("lineitem", names)

    def dict(self, table: str, col: str):
        return self.gen.dictionaries(table)[col]

    def names(self, table: str, col: str, ids) -> list:
        return [str(v) for v in self.dict(table, col).take(ids)]

    def word_ids(self, table: str, col: str, pred) -> list:
        return [i for i, v in enumerate(self.dict(table, col).values)
                if pred(v)]

    def region_nations(self, region: str) -> np.ndarray:
        na = self.cols("nation", ["n_nationkey", "n_regionkey"])
        rg = self.cols("region", ["r_regionkey", "r_name"])
        key = rg["r_regionkey"][rg["r_name"]
                                == self.dict("region", "r_name").id_of(region)]
        return na["n_nationkey"][np.isin(na["n_regionkey"], key)]

    def nation_key(self, name: str) -> int:
        na = self.cols("nation", ["n_nationkey", "n_name"])
        return int(na["n_nationkey"][
            na["n_name"] == self.dict("nation", "n_name").id_of(name)][0])


def _lookup(keys: np.ndarray, values: np.ndarray) -> np.ndarray:
    """A direct-address table: key -> its value (-1 where absent)."""
    out = np.full(int(keys.max()) + 1, -1, np.int64)
    out[keys] = values
    return out


def _row_of(keys: np.ndarray) -> np.ndarray:
    return _lookup(keys, np.arange(len(keys)))


def _year(days: np.ndarray) -> np.ndarray:
    return days.astype("datetime64[D]").astype("datetime64[Y]") \
        .astype(np.int64) + 1970


def _pair_keys(part, supp, n_supp: int):
    return part * (n_supp + 1) + supp


def _half_up(s: int, c: int) -> int:
    q = (abs(s) + c // 2) // c
    return -q if s < 0 else q


def _half_up_avg(s: np.ndarray, c: np.ndarray) -> np.ndarray:
    return (2 * s + c) // (2 * c)


def q1(t: Tables, delta: int = 90):
    A = t.arith
    li = t.li("l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_tax")
    cut = day("1998-12-01") - delta
    m = li["l_shipdate"] <= cut
    q, p = li["l_quantity"], li["l_extendedprice"]
    d, tx = li["l_discount"], li["l_tax"]
    rows = []
    for fi, flag in enumerate(("A", "N", "R")):
        for si, status in enumerate(("F", "O")):
            sel = m & (li["l_returnflag"] == fi) & (li["l_linestatus"] == si)
            c = int(sel.sum())
            if not c:
                continue
            disc_price = p[sel] * (100 - d[sel])
            sq, sp, sd = A.sum(q[sel]), A.sum(p[sel]), A.sum(d[sel])
            rows.append((flag, status, sq, sp, A.sum(disc_price),
                         A.sum(disc_price * (100 + tx[sel])),
                         _half_up(sq, c), _half_up(sp, c), _half_up(sd, c),
                         c))
    return ["l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
            "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
            "avg_disc", "count_order"], rows


def q2(t: Tables):
    pt = t.cols("part", ["p_partkey", "p_mfgr", "p_size", "p_type"])
    brass = t.word_ids("part", "p_type", lambda v: v.endswith("BRASS"))
    pm = (pt["p_size"] == 15) & np.isin(pt["p_type"], brass)
    p_row = _lookup(pt["p_partkey"], np.where(pm, np.arange(len(pm)), -1))
    cols = ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone",
            "s_acctbal", "s_comment"]
    su = t.cols("supplier", cols)
    s_row = _row_of(su["s_suppkey"])
    europe = np.isin(su["s_nationkey"], t.region_nations("EUROPE"))
    ps = t.cols("partsupp", ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    pk = ps["ps_partkey"]
    sel = (p_row[pk] >= 0) & europe[s_row[ps["ps_suppkey"]]]
    pk, sk, cost = pk[sel], ps["ps_suppkey"][sel], ps["ps_supplycost"][sel]
    low = np.full(len(p_row), np.iinfo(np.int64).max)
    np.minimum.at(low, pk, cost)
    keep = cost == low[pk]
    pk, r = pk[keep], s_row[sk[keep]]
    na = t.cols("nation", ["n_nationkey", "n_name"])
    n_name = np.array(t.names("nation", "n_name", na["n_name"][
        _row_of(na["n_nationkey"])[su["s_nationkey"][r]]]))
    s_name = np.array(t.names("supplier", "s_name", su["s_name"][r]))
    bal = su["s_acctbal"][r]
    top = np.lexsort((pk, s_name, n_name, -bal))[:100]
    r, pk = r[top], pk[top]
    strs = {c: t.names("supplier", c, su[c][r])
            for c in ("s_address", "s_phone", "s_comment")}
    mfgr = t.names("part", "p_mfgr", pt["p_mfgr"][p_row[pk]])
    return ["s_acctbal", "s_name", "n_name", "ps_partkey", "p_mfgr",
            "s_address", "s_phone", "s_comment"], [
        (int(bal[top][i]), str(s_name[top][i]), str(n_name[top][i]),
         int(pk[i]), mfgr[i], strs["s_address"][i], strs["s_phone"][i],
         strs["s_comment"][i]) for i in range(len(top))]


def q3(t: Tables, segment: str = "BUILDING", date: str = "1995-03-15"):
    A = t.arith
    li = t.li("l_orderkey", "l_shipdate", "l_extendedprice", "l_discount")
    cu = t.cols("customer", ["c_custkey", "c_mktsegment"])
    od = t.cols("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                           "o_shippriority"])
    cut = day(date)
    seg = t.dict("customer", "c_mktsegment").id_of(segment)
    chosen = np.zeros(int(cu["c_custkey"].max()) + 1, bool)
    chosen[cu["c_custkey"][cu["c_mktsegment"] == seg]] = True
    om = (od["o_orderdate"] < cut) & chosen[od["o_custkey"]]
    row_of = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    row_of[od["o_orderkey"][om]] = np.nonzero(om)[0]
    r = row_of[li["l_orderkey"]]
    lm = (li["l_shipdate"] > cut) & (r >= 0)
    rev = li["l_extendedprice"][lm] * (100 - li["l_discount"][lm])
    n_od = len(od["o_orderkey"])
    sums = A.group_sum(r[lm], rev, n_od, "Q3")
    cand = np.nonzero(np.bincount(r[lm], minlength=n_od))[0]
    top = cand[np.lexsort((od["o_orderkey"][cand], od["o_orderdate"][cand],
                           -sums[cand]))[:10]]
    return ["l_orderkey", "revenue", "o_orderdate", "o_shippriority"], [
        (int(od["o_orderkey"][i]), int(sums[i]), int(od["o_orderdate"][i]),
         int(od["o_shippriority"][i])) for i in top]


def q4(t: Tables):
    li = t.li("l_orderkey", "l_commitdate", "l_receiptdate")
    od = t.cols("orders", ["o_orderkey", "o_orderdate", "o_orderpriority"])
    late = np.zeros(int(od["o_orderkey"].max()) + 1, bool)
    late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] = True
    od_d = od["o_orderdate"]
    m = (od_d >= day("1993-07-01")) & (od_d < day("1993-10-01")) \
        & late[od["o_orderkey"]]
    counts = np.bincount(od["o_orderpriority"][m])
    prios = t.dict("orders", "o_orderpriority")
    return ["o_orderpriority", "order_count"], [
        (str(prios.values[i]), int(c)) for i, c in enumerate(counts) if c]


def q5(t: Tables, region: str = "ASIA"):
    A = t.arith
    li = t.li("l_orderkey", "l_suppkey", "l_extendedprice", "l_discount")
    od = t.cols("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    cu = t.cols("customer", ["c_custkey", "c_nationkey"])
    su = t.cols("supplier", ["s_suppkey", "s_nationkey"])
    na = t.cols("nation", ["n_nationkey", "n_name"])
    nations = t.region_nations(region)
    c_nat = _lookup(cu["c_custkey"], cu["c_nationkey"])
    m = (od["o_orderdate"] >= D94) & (od["o_orderdate"] < D95)
    o_nat = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    o_nat[od["o_orderkey"][m]] = c_nat[od["o_custkey"][m]]
    s_nat = _lookup(su["s_suppkey"], su["s_nationkey"])
    on, sn = o_nat[li["l_orderkey"]], s_nat[li["l_suppkey"]]
    sel = (on >= 0) & (on == sn) & np.isin(sn, nations)
    rev = li["l_extendedprice"][sel] * (100 - li["l_discount"][sel])
    nat = sn[sel]
    rows = []
    for n in nations:
        if (nat == n).any():
            name = t.names("nation", "n_name",
                           na["n_name"][_row_of(na["n_nationkey"])[[n]]])
            rows.append((name[0], A.sum(rev[nat == n])))
    return ["n_name", "revenue"], rows


def q6(t: Tables, year: int = 1994, discount: float = 0.06,
       quantity: int = 24):
    li = t.li("l_shipdate", "l_discount", "l_quantity", "l_extendedprice")
    cents = int(round(discount * 100))
    m = ((li["l_shipdate"] >= day(f"{year}-01-01"))
         & (li["l_shipdate"] < day(f"{year + 1}-01-01"))
         & (li["l_discount"] >= cents - 1) & (li["l_discount"] <= cents + 1)
         & (li["l_quantity"] < quantity * 100))
    rev = li["l_extendedprice"][m] * li["l_discount"][m]
    return ["revenue"], [(t.arith.sum(rev) if m.any() else None,)]


def q7(t: Tables, nation1: str = "FRANCE", nation2: str = "GERMANY"):
    li = t.li("l_orderkey", "l_suppkey", "l_shipdate", "l_extendedprice",
              "l_discount")
    n1, n2 = t.nation_key(nation1), t.nation_key(nation2)
    su = t.cols("supplier", ["s_suppkey", "s_nationkey"])
    cu = t.cols("customer", ["c_custkey", "c_nationkey"])
    od = t.cols("orders", ["o_orderkey", "o_custkey"])
    sd = li["l_shipdate"]
    m = (sd >= day("1995-01-01")) & (sd <= day("1996-12-31"))
    sn = _lookup(su["s_suppkey"], su["s_nationkey"])[li["l_suppkey"][m]]
    c_nat = _lookup(cu["c_custkey"], cu["c_nationkey"])
    cn = c_nat[_lookup(od["o_orderkey"], od["o_custkey"])[
        li["l_orderkey"][m]]]
    pair = ((sn == n1) & (cn == n2)) | ((sn == n2) & (cn == n1))
    rev = li["l_extendedprice"][m][pair] * (100 - li["l_discount"][m][pair])
    gid = (sn[pair] == n2) * 2 + (_year(sd[m][pair]) - 1995)
    sums = t.arith.group_sum(gid, rev, 4, "Q7")
    counts = np.bincount(gid, minlength=4)
    names = (nation1, nation2)
    return ["supp_nation", "cust_nation", "l_year", "revenue"], [
        (names[g // 2], names[1 - g // 2], 1995 + g % 2, int(sums[g]))
        for g in range(4) if counts[g]]


def q8(t: Tables, region: str = "AMERICA",
       p_type: str = "ECONOMY ANODIZED STEEL", nation: str = "BRAZIL"):
    A = t.arith
    li = t.li("l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice",
              "l_discount")
    pt = t.cols("part", ["p_partkey", "p_type"])
    want = t.dict("part", "p_type").id_of(p_type)
    typed = np.zeros(int(pt["p_partkey"].max()) + 1, bool)
    typed[pt["p_partkey"][pt["p_type"] == want]] = True
    lm = typed[li["l_partkey"]]
    od = t.cols("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    cu = t.cols("customer", ["c_custkey", "c_nationkey"])
    in_region = np.isin(cu["c_nationkey"], t.region_nations(region))
    c_ok = np.zeros(int(cu["c_custkey"].max()) + 1, bool)
    c_ok[cu["c_custkey"][in_region]] = True
    om = ((od["o_orderdate"] >= day("1995-01-01"))
          & (od["o_orderdate"] <= day("1996-12-31"))
          & c_ok[od["o_custkey"]])
    o_year = _lookup(od["o_orderkey"],
                     np.where(om, _year(od["o_orderdate"]), -1))
    y = o_year[li["l_orderkey"][lm]]
    keep = y > 0
    su = t.cols("supplier", ["s_suppkey", "s_nationkey"])
    sn = _lookup(su["s_suppkey"], su["s_nationkey"])[li["l_suppkey"][lm]]
    vol = li["l_extendedprice"][lm] * (100 - li["l_discount"][lm])
    y, vol, home = y[keep], vol[keep], sn[keep] == t.nation_key(nation)
    gid = y - 1995
    total = A.group_sum(gid, vol, 2, "Q8")
    own = A.group_sum(gid[home], vol[home], 2, "Q8")
    counts = np.bincount(gid, minlength=2)
    return ["o_year", "mkt_share"], [
        (1995 + g, A.dbl(A.dbl(int(own[g]) / 1e4)
                         / A.dbl(int(total[g]) / 1e4)))
        for g in range(2) if counts[g]]


def q9(t: Tables):
    li = t.li("l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
              "l_extendedprice", "l_discount")
    pt = t.cols("part", ["p_partkey", "p_name"])
    green = np.isin(pt["p_name"], t.word_ids("part", "p_name",
                                             lambda v: "green" in v))
    green_part = np.zeros(int(pt["p_partkey"].max()) + 1, bool)
    green_part[pt["p_partkey"][green]] = True
    lm = green_part[li["l_partkey"]]
    n_supp = t.gen.num_rows("supplier")
    ps = t.cols("partsupp", ["ps_partkey", "ps_suppkey", "ps_supplycost"])
    ps_keys = _pair_keys(ps["ps_partkey"], ps["ps_suppkey"], n_supp)
    order = np.argsort(ps_keys, kind="stable")
    keys = _pair_keys(li["l_partkey"][lm], li["l_suppkey"][lm], n_supp)
    at = np.minimum(np.searchsorted(ps_keys[order], keys), len(order) - 1)
    found = ps_keys[order][at] == keys
    cost = ps["ps_supplycost"][order][at][found]
    idx = np.nonzero(lm)[0][found]
    od = t.cols("orders", ["o_orderkey", "o_orderdate"])
    year = _lookup(od["o_orderkey"], _year(od["o_orderdate"]))[
        li["l_orderkey"][idx]]
    su = t.cols("supplier", ["s_suppkey", "s_nationkey"])
    sn = _lookup(su["s_suppkey"], su["s_nationkey"])[li["l_suppkey"][idx]]
    amount = (li["l_extendedprice"][idx] * (100 - li["l_discount"][idx])
              - cost * li["l_quantity"][idx])
    years = 1999 - 1992
    gid = sn * years + (year - 1992)
    sums = t.arith.group_sum(gid, amount, 25 * years, "Q9")
    counts = np.bincount(gid, minlength=25 * years)
    na = t.cols("nation", ["n_nationkey", "n_name"])
    name_of = dict(zip(na["n_nationkey"].tolist(),
                       t.names("nation", "n_name", na["n_name"])))
    return ["nation", "o_year", "sum_profit"], [
        (name_of[g // years], 1992 + g % years, int(sums[g]))
        for g in np.nonzero(counts)[0].tolist()]


def q10(t: Tables):
    li = t.li("l_orderkey", "l_returnflag", "l_extendedprice", "l_discount")
    od = t.cols("orders", ["o_orderkey", "o_custkey", "o_orderdate"])
    m = (od["o_orderdate"] >= day("1993-10-01")) & (od["o_orderdate"] < D94)
    o_cust = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    o_cust[od["o_orderkey"][m]] = od["o_custkey"][m]
    r_id = t.dict("lineitem", "l_returnflag").id_of("R")
    c = o_cust[li["l_orderkey"]]
    sel = (li["l_returnflag"] == r_id) & (c >= 0)
    rev = li["l_extendedprice"][sel] * (100 - li["l_discount"][sel])
    n = int(c.max()) + 1
    sums = t.arith.group_sum(c[sel], rev, n, "Q10")
    cand = np.nonzero(np.bincount(c[sel], minlength=n))[0]
    top = cand[np.lexsort((cand, -sums[cand]))[:20]]
    cols = ["c_custkey", "c_name", "c_acctbal", "c_phone", "c_nationkey",
            "c_address", "c_comment"]
    cu = t.cols("customer", cols)
    r = _row_of(cu["c_custkey"])[top]
    strs = {k: t.names("customer", k, cu[k][r])
            for k in ("c_name", "c_phone", "c_address", "c_comment")}
    na = t.cols("nation", ["n_nationkey", "n_name"])
    nation = t.names("nation", "n_name", na["n_name"][
        _row_of(na["n_nationkey"])[cu["c_nationkey"][r]]])
    return ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
            "c_address", "c_comment", "revenue"], [
        (int(top[i]), strs["c_name"][i], int(cu["c_acctbal"][r[i]]),
         strs["c_phone"][i], nation[i], strs["c_address"][i],
         strs["c_comment"][i], int(sums[top[i]]))
        for i in range(len(top))]


def q11(t: Tables, fraction: float = 0.0001):
    A = t.arith
    ps = t.cols("partsupp", ["ps_partkey", "ps_suppkey", "ps_availqty",
                             "ps_supplycost"])
    su = t.cols("supplier", ["s_suppkey", "s_nationkey"])
    german = su["s_suppkey"][su["s_nationkey"] == t.nation_key("GERMANY")]
    m = np.isin(ps["ps_suppkey"], german)
    parts = ps["ps_partkey"][m]
    pv = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
    n = int(parts.max()) + 1
    value = A.group_sum(parts, pv, n, "Q11")
    total = A.sum(pv)
    cand = np.nonzero(np.bincount(parts, minlength=n))[0]
    keep = cand[value[cand] / 100.0 > (total / 100.0) * fraction]
    top = keep[np.argsort(-value[keep], kind="stable")[:1000]]
    return ["ps_partkey", "value"], [(int(k), int(value[k])) for k in top]


def q12(t: Tables):
    li = t.li("l_orderkey", "l_shipmode", "l_commitdate", "l_receiptdate",
              "l_shipdate")
    od = t.cols("orders", ["o_orderkey", "o_orderpriority"])
    modes = t.dict("lineitem", "l_shipmode")
    prios = t.dict("orders", "o_orderpriority")
    sm, cd, rd = li["l_shipmode"], li["l_commitdate"], li["l_receiptdate"]
    m = (cd < rd) & (li["l_shipdate"] < cd) & (rd >= D94) & (rd < D95)
    prio_of = _lookup(od["o_orderkey"], od["o_orderpriority"])
    high_ids = [prios.id_of("1-URGENT"), prios.id_of("2-HIGH")]
    rows = []
    for name in ("MAIL", "SHIP"):
        sel = m & (sm == modes.id_of(name))
        high = np.isin(prio_of[li["l_orderkey"][sel]], high_ids)
        rows.append((name, int(high.sum()), int((~high).sum())))
    return ["l_shipmode", "high_line_count", "low_line_count"], rows


def q13(t: Tables):
    od = t.cols("orders", ["o_custkey", "o_comment"])
    cu = t.cols("customer", ["c_custkey"])
    comments = t.dict("orders", "o_comment").values

    def special(v: str) -> bool:
        i = v.find("special")
        return i >= 0 and v.find("requests", i + len("special")) >= 0

    bad = np.array([special(v) for v in comments], bool)
    keep = ~bad[od["o_comment"]]
    per = np.bincount(od["o_custkey"][keep],
                      minlength=int(cu["c_custkey"].max()) + 1)
    dist = np.bincount(per[cu["c_custkey"]])
    return ["c_count", "custdist"], [(int(k), int(dist[k]))
                                     for k in np.nonzero(dist)[0]]


def q14(t: Tables):
    A = t.arith
    li = t.li("l_partkey", "l_shipdate", "l_extendedprice", "l_discount")
    pt = t.cols("part", ["p_partkey", "p_type"])
    promo_ids = t.word_ids("part", "p_type", lambda v: v.startswith("PROMO"))
    type_of = _lookup(pt["p_partkey"], pt["p_type"])
    sd = li["l_shipdate"]
    m = (sd >= day("1995-09-01")) & (sd < day("1995-10-01"))
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    promo = np.isin(type_of[li["l_partkey"][m]], promo_ids)
    p, tot = A.sum(rev[promo]), A.sum(rev)
    return ["promo_pct"], [(A.dbl(A.dbl(A.dbl(p / 1e4) * 100.0)
                                  / A.dbl(tot / 1e4)),)]


def q15(t: Tables):
    li = t.li("l_suppkey", "l_shipdate", "l_extendedprice", "l_discount")
    sd = li["l_shipdate"]
    m = (sd >= day("1996-01-01")) & (sd < day("1996-04-01"))
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    sk = li["l_suppkey"][m]
    total = t.arith.group_sum(sk, rev, int(sk.max()) + 1, "Q15")
    top = np.nonzero(total == total.max())[0]
    cols = ["s_suppkey", "s_name", "s_address", "s_phone"]
    su = t.cols("supplier", cols)
    r = _row_of(su["s_suppkey"])[top]
    strs = {c: t.names("supplier", c, su[c][r]) for c in cols[1:]}
    return cols + ["total_revenue"], [
        (int(su["s_suppkey"][x]), strs["s_name"][i], strs["s_address"][i],
         strs["s_phone"][i], int(total[k]))
        for i, (x, k) in enumerate(zip(r, top))]


def q16(t: Tables):
    pt = t.cols("part", ["p_partkey", "p_brand", "p_type", "p_size"])
    pd_ = t.gen.dictionaries("part")
    pm = ((pt["p_brand"] != pd_["p_brand"].id_of("Brand#45"))
          & ~np.isin(pt["p_type"], t.word_ids(
              "part", "p_type", lambda v: v.startswith("MEDIUM POLISHED")))
          & np.isin(pt["p_size"], (49, 14, 23, 45, 19, 3, 36, 9)))
    p_row = _lookup(pt["p_partkey"], np.where(pm, np.arange(len(pm)), -1))
    su = t.cols("supplier", ["s_suppkey", "s_comment"])

    def complaint(v: str) -> bool:
        i = v.find("Customer")
        return i >= 0 and v.find("Complaints", i + len("Customer")) >= 0

    bad = su["s_suppkey"][np.isin(su["s_comment"], t.word_ids(
        "supplier", "s_comment", complaint))]
    ps = t.cols("partsupp", ["ps_partkey", "ps_suppkey"])
    r, sk = p_row[ps["ps_partkey"]], ps["ps_suppkey"]
    sel = (r >= 0) & ~np.isin(sk, bad)
    r, sk = r[sel], sk[sel]
    n_types, n_sizes = len(pd_["p_type"]), 51
    gid = (pt["p_brand"][r] * n_types + pt["p_type"][r]) * n_sizes \
        + pt["p_size"][r]
    n_supp = t.gen.num_rows("supplier") + 1
    pairs = np.unique(gid * n_supp + sk)
    groups, cnt = np.unique(pairs // n_supp, return_counts=True)
    brand = np.array(pd_["p_brand"].take(groups // n_sizes // n_types))
    ptype = np.array(pd_["p_type"].take(groups // n_sizes % n_types))
    size = groups % n_sizes
    top = np.lexsort((size, ptype, brand, -cnt))[:1000]
    return ["p_brand", "p_type", "p_size", "supplier_cnt"], [
        (str(brand[i]), str(ptype[i]), int(size[i]), int(cnt[i]))
        for i in top.tolist()]


def q17(t: Tables, brand: str = "Brand#23", container: str = "MED BOX"):
    A = t.arith
    li = t.li("l_partkey", "l_quantity", "l_extendedprice")
    pk, qty = li["l_partkey"], li["l_quantity"]
    n = int(pk.max()) + 1
    s = A.group_sum(pk, qty, n, "Q17")
    c = np.bincount(pk, minlength=n)
    aq = _half_up_avg(s, np.maximum(c, 1))
    pt = t.cols("part", ["p_partkey", "p_brand", "p_container"])
    wanted = pt["p_partkey"][
        (pt["p_brand"] == t.dict("part", "p_brand").id_of(brand))
        & (pt["p_container"]
           == t.dict("part", "p_container").id_of(container))]
    m = np.isin(pk, wanted)
    m[m] = (qty[m].astype(np.float64) / 100.0
            < 0.2 * (aq[pk[m]].astype(np.float64) / 100.0))
    if not m.any():
        return ["avg_yearly"], [(None,)]
    total = A.sum(li["l_extendedprice"][m])
    return ["avg_yearly"], [(A.dbl(A.dbl(total / 100.0) / 7.0),)]


def q18(t: Tables, threshold: float = 300.0):
    li = t.li("l_orderkey", "l_quantity")
    od = t.cols("orders", ["o_orderkey", "o_custkey", "o_orderdate",
                           "o_totalprice"])
    okey = od["o_orderkey"]
    qty = t.arith.group_sum(li["l_orderkey"], li["l_quantity"],
                            int(okey.max()) + 1, "Q18")
    cand = np.nonzero(qty[okey] > round(threshold * 100))[0]
    top = cand[np.lexsort((okey[cand], od["o_orderdate"][cand],
                           -od["o_totalprice"][cand]))[:100]]
    return ["c_name", "c_custkey", "o_orderkey", "o_orderdate",
            "o_totalprice", "quantity"], [
        (f"Customer#{int(od['o_custkey'][i]):09d}", int(od["o_custkey"][i]),
         int(okey[i]), int(od["o_orderdate"][i]),
         int(od["o_totalprice"][i]), int(qty[okey[i]])) for i in top]


def q19(t: Tables, b1: str = "Brand#12", b2: str = "Brand#23",
        b3: str = "Brand#34", q1: int = 1, q2: int = 10, q3: int = 20):
    li = t.li("l_partkey", "l_quantity", "l_extendedprice", "l_discount",
              "l_shipmode", "l_shipinstruct")
    ld = t.gen.dictionaries("lineitem")
    m = (np.isin(li["l_shipmode"], [ld["l_shipmode"].id_of("AIR"),
                                     ld["l_shipmode"].id_of("REG AIR")])
         & (li["l_shipinstruct"]
            == ld["l_shipinstruct"].id_of("DELIVER IN PERSON")))
    pt = t.cols("part", ["p_partkey", "p_brand", "p_container", "p_size"])
    pd_ = t.gen.dictionaries("part")
    r = _row_of(pt["p_partkey"])[li["l_partkey"][m]]
    brand, cont = pt["p_brand"][r], pt["p_container"][r]
    size, qty = pt["p_size"][r], li["l_quantity"][m]
    hit = np.zeros(len(r), bool)
    for b, kind, q, top in ((b1, "SM", q1, 5), (b2, "MED", q2, 10),
                            (b3, "LG", q3, 15)):
        boxes = {"SM": ("CASE", "BOX", "PACK", "PKG"),
                 "MED": ("BAG", "BOX", "PKG", "PACK"),
                 "LG": ("CASE", "BOX", "PACK", "PKG")}[kind]
        ids = [pd_["p_container"].id_of(f"{kind} {x}") for x in boxes]
        hit |= ((brand == pd_["p_brand"].id_of(b)) & np.isin(cont, ids)
                & (qty >= q * 100) & (qty <= (q + 10) * 100)
                & (size >= 1) & (size <= top))
    rev = li["l_extendedprice"][m][hit] * (100 - li["l_discount"][m][hit])
    return ["revenue"], [(t.arith.sum(rev) if len(rev) else None,)]


def q20(t: Tables, color: str = "forest", nation: str = "CANADA"):
    li = t.li("l_partkey", "l_suppkey", "l_quantity", "l_shipdate")
    pt = t.cols("part", ["p_partkey", "p_name"])
    named = np.isin(pt["p_name"], t.word_ids(
        "part", "p_name", lambda v: v.startswith(color)))
    part_ok = np.zeros(int(pt["p_partkey"].max()) + 1, bool)
    part_ok[pt["p_partkey"][named]] = True
    sd = li["l_shipdate"]
    lm = (sd >= D94) & (sd < D95) & part_ok[li["l_partkey"]]
    n_supp = t.gen.num_rows("supplier")
    keys, inv = np.unique(_pair_keys(li["l_partkey"][lm],
                                     li["l_suppkey"][lm], n_supp),
                          return_inverse=True)
    sq = t.arith.group_sum(inv, li["l_quantity"][lm], len(keys), "Q20")
    ps = t.cols("partsupp", ["ps_partkey", "ps_suppkey", "ps_availqty"])
    pm = part_ok[ps["ps_partkey"]]
    pkeys = _pair_keys(ps["ps_partkey"][pm], ps["ps_suppkey"][pm], n_supp)
    at = np.minimum(np.searchsorted(keys, pkeys), len(keys) - 1)
    found = keys[at] == pkeys
    avail = ps["ps_availqty"][pm][found].astype(np.float64)
    ok = avail > 0.5 * (sq[at[found]].astype(np.float64) / 100.0)
    eligible = np.unique(ps["ps_suppkey"][pm][found][ok])
    su = t.cols("supplier", ["s_suppkey", "s_name", "s_address",
                             "s_nationkey"])
    sm = (su["s_nationkey"] == t.nation_key(nation)) \
        & np.isin(su["s_suppkey"], eligible)
    names = np.array(t.names("supplier", "s_name", su["s_name"][sm]))
    addr = t.names("supplier", "s_address", su["s_address"][sm])
    order = np.argsort(names, kind="stable")
    return ["s_name", "s_address"], [(str(names[i]), addr[i])
                                     for i in order.tolist()]


def q21(t: Tables):
    li = t.li("l_orderkey", "l_suppkey", "l_commitdate", "l_receiptdate")
    ok, sk = li["l_orderkey"], li["l_suppkey"]
    if (np.diff(ok) < 0).any():
        raise AssertionError("lineitem is not in order key order")
    late = li["l_receiptdate"] > li["l_commitdate"]
    su = t.cols("supplier", ["s_suppkey", "s_name", "s_nationkey"])
    s_row = _row_of(su["s_suppkey"])
    od = t.cols("orders", ["o_orderkey", "o_orderstatus"])
    f_id = t.dict("orders", "o_orderstatus").id_of("F")
    is_f = np.zeros(int(od["o_orderkey"].max()) + 1, bool)
    is_f[od["o_orderkey"][od["o_orderstatus"] == f_id]] = True
    saudi = t.nation_key("SAUDI ARABIA")
    cand = np.nonzero(late & (su["s_nationkey"][s_row[sk]] == saudi)
                      & is_f[ok])[0]
    other = np.zeros(len(cand), bool)
    other_late = np.zeros(len(cand), bool)
    n = len(ok)
    for d in range(-6, 7):
        j = cand + d
        ins = (j >= 0) & (j < n)
        j = np.clip(j, 0, n - 1)
        same_order_other = ins & (ok[j] == ok[cand]) & (sk[j] != sk[cand])
        other |= same_order_other
        other_late |= same_order_other & late[j]
    keep = cand[other & ~other_late]
    counts = np.bincount(sk[keep])
    supp = np.nonzero(counts)[0]
    names = t.names("supplier", "s_name", su["s_name"][s_row[supp]])
    rows = sorted(((nm, int(counts[k])) for nm, k in zip(names, supp)),
                  key=lambda r: (-r[1], r[0]))[:100]
    return ["s_name", "numwait"], rows


def q22(t: Tables):
    A = t.arith
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cu = t.cols("customer", ["c_custkey", "c_phone", "c_acctbal"])
    phones = t.dict("customer", "c_phone").take(cu["c_phone"])
    code = np.array([p[:2] for p in phones], dtype=object)
    sel = np.isin(code, codes)
    bal = cu["c_acctbal"]
    pos = bal[sel & (bal > 0)]
    ab = _half_up_avg(A.sum(pos), len(pos))
    sel &= bal.astype(np.float64) / 100.0 > np.float64(ab) / 100.0
    od = t.cols("orders", ["o_custkey"])
    has = np.bincount(od["o_custkey"],
                      minlength=int(cu["c_custkey"].max()) + 1) > 0
    sel &= ~has[cu["c_custkey"]]
    return ["cntrycode", "numcust", "totacctbal"], [
        (k, int((sel & (code == k)).sum()), A.sum(bal[sel & (code == k)]))
        for k in sorted(codes) if (sel & (code == k)).any()]


def topn(t: Tables):
    li = t.li("l_shipdate", "l_orderkey")
    # one int64 key orders (shipdate, orderkey): both are non-negative
    # and orderkeys stay below 2^40
    key = (li["l_shipdate"] << 40) | li["l_orderkey"]
    n = min(1000, len(key))
    first = np.sort(key[np.argpartition(key, n - 1)[:n]])
    return ["l_shipdate", "l_orderkey"], [
        (int(k >> 40), int(k & ((1 << 40) - 1))) for k in first]


ORDER_BY = json.loads((Path(__file__).resolve().parent.parent / "plans"
                       / "order_by.json").read_text())


def order_by(query: str, answer: Callable) -> Callable:
    """``answer`` with its rows sorted by the query's ORDER BY keys."""
    def ordered(t: Tables, **params):
        names, rows = answer(t, **params)
        for col, direction in reversed(ORDER_BY[query]):
            i = names.index(col)
            rows = sorted(rows, key=lambda r: r[i],
                          reverse=direction == "desc")
        return names, rows
    return ordered


ANSWERS = {q: order_by(q, globals()[q])
           for q in [f"q{n}" for n in range(1, 23)] + ["topn"]}

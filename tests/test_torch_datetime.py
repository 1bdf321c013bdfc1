"""TIMESTAMP and the date and time functions of the torch port against the
JAX reference: counterparts of tests/test_functions.py's date tests and of
tests/test_timezone.py, plus pre-1970, leap-day and DST-edge timestamps,
TIMESTAMP sort and group keys, every unit of date_add/date_diff/
date_trunc, and the zone reader without the ``tzdata`` package.

Each plan is built by each package's own PlanBuilder over the same
numpy-seeded pyarrow tables and run by each package's Task; results must
be equal (doubles within the reference oracle's relative tolerance), and
where an independent oracle exists (pandas, numpy datetime64, zoneinfo),
equal to it too.
"""

import datetime as dt
import sys
from zoneinfo import ZoneInfo

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from tpch_sql import TOLERANCES
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.functions import datetime as TDT
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

CPU = QueryCtx("cpu")
REL_TOL = TOLERANCES.get(0, (1e-9, 1))[0]
US_DAY = 86_400_000_000


def _both(table, projections, ordered=True):
    """The projections over ``table`` in both engines; equal results."""
    want = JTask(JPlanBuilder().values([table]).project(projections)
                 .plan()).run()
    got = Task(PlanBuilder().values([table]).project(projections).plan(),
               CPU).run()
    assert got.schema == want.schema
    for name in got.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if pa.types.is_floating(got.schema.field(name).type):
            np.testing.assert_allclose(
                np.array(g, dtype=float), np.array(w, dtype=float),
                rtol=REL_TOL)
        else:
            assert g == w, name
    return got.to_pandas()


def dates_df(n=200, seed=3):
    rng = np.random.RandomState(seed)
    days = rng.randint(0, 20000, n)
    return pd.DataFrame({
        "d": np.array(days, dtype="datetime64[D]"),
        "n": rng.randint(-50, 50, n).astype("int64"),
    })


def _edge_micros():
    """Pre-1970, leap days, month ends, a DST edge and random instants."""
    fixed = [
        dt.datetime(1969, 12, 31, 23, 59, 59, 999999),
        dt.datetime(1900, 2, 28, 12), dt.datetime(1904, 2, 29, 0, 0, 1),
        dt.datetime(1960, 2, 29, 23, 0), dt.datetime(2000, 2, 29, 6, 30),
        dt.datetime(2024, 2, 29, 23, 59, 59), dt.datetime(2023, 1, 31, 10),
        dt.datetime(2024, 3, 10, 9, 59, 59), dt.datetime(2024, 3, 10, 10),
        dt.datetime(2024, 11, 3, 5, 59, 59), dt.datetime(2024, 11, 3, 6),
        dt.datetime(1970, 1, 1), dt.datetime(1969, 1, 1, 0, 0, 0, 1),
        dt.datetime(1583, 3, 1), dt.datetime(2100, 12, 31, 23, 59),
    ]
    epoch = dt.datetime(1970, 1, 1)
    out = [int((x - epoch) / dt.timedelta(microseconds=1)) for x in fixed]
    rng = np.random.default_rng(7)
    out += list(rng.integers(-80 * 365 * US_DAY, 80 * 365 * US_DAY, 150))
    return np.array(out, dtype=np.int64)


def _ts_table(seed=0):
    micros = _edge_micros()
    rng = np.random.default_rng(seed)
    n = len(micros)
    valid = rng.random(n) > 0.1
    return pa.table({
        "ts": pa.array(micros, pa.timestamp("us"), mask=~valid),
        "ts2": pa.array(np.roll(micros, 5), pa.timestamp("us")),
        "d": pa.array((micros // US_DAY).astype(np.int32), pa.date32()),
        "n": pa.array(rng.integers(-40, 40, n), pa.int64()),
        "k": pa.array(rng.integers(0, 4, n), pa.int64()),
    })


# ---------------------------------------------------------------------------
# counterparts of tests/test_functions.py
# ---------------------------------------------------------------------------

def test_date_parts():
    df = dates_df()
    got = _both(pa.table(df), ["year(d) as y", "month(d) as m",
                               "day(d) as dd", "quarter(d) as q",
                               "week(d) as w"])
    ts = pd.DatetimeIndex(df.d)
    np.testing.assert_array_equal(got.y, ts.year)
    np.testing.assert_array_equal(got.m, ts.month)
    np.testing.assert_array_equal(got.dd, ts.day)
    np.testing.assert_array_equal(got.q, ts.quarter)
    np.testing.assert_array_equal(got.w, ts.isocalendar().week.to_numpy())


def test_date_add_diff():
    df = dates_df()
    got = _both(pa.table(df), [
        "date_add('day', n, d) as ad",
        "date_add('month', 2, d) as am",
        "date_add('year', 1, d) as ay",
        "date_diff('day', d, date '2000-01-01') as dd",
    ])
    base = pd.DatetimeIndex(df.d)
    np.testing.assert_array_equal(
        pd.DatetimeIndex(got.ad), base + pd.to_timedelta(df.n, "D"))
    np.testing.assert_array_equal(
        pd.DatetimeIndex(got.am), base + pd.DateOffset(months=2))
    np.testing.assert_array_equal(
        pd.DatetimeIndex(got.ay), base + pd.DateOffset(years=1))
    exp_dd = (np.datetime64("2000-01-01") - df.d.to_numpy()) \
        .astype("timedelta64[D]").astype(int)
    np.testing.assert_array_equal(got.dd, exp_dd)


def test_date_trunc():
    df = dates_df()
    got = _both(pa.table(df), ["date_trunc('month', d) as tm",
                               "date_trunc('year', d) as ty",
                               "date_trunc('week', d) as tw"])
    ts = pd.DatetimeIndex(df.d)
    np.testing.assert_array_equal(
        pd.DatetimeIndex(got.tm), ts.to_period("M").to_timestamp())
    np.testing.assert_array_equal(
        pd.DatetimeIndex(got.ty), ts.to_period("Y").to_timestamp())
    np.testing.assert_array_equal(
        pd.DatetimeIndex(got.tw), ts.to_period("W-SUN").start_time)


def test_date_diff_complete_units():
    df = pd.DataFrame({
        "a": np.array(["2020-01-31", "2020-02-01", "2020-03-01",
                       "2020-01-09", "2020-01-01"], dtype="datetime64[D]"),
        "b": np.array(["2020-02-01", "2020-01-31", "2021-02-28",
                       "2020-01-01", "2020-01-09"], dtype="datetime64[D]"),
    })
    got = _both(pa.table(df), ["date_diff('month', a, b) as m",
                               "date_diff('year', a, b) as y",
                               "date_diff('quarter', a, b) as q",
                               "date_diff('week', a, b) as w"])
    np.testing.assert_array_equal(got.m, [0, 0, 11, 0, 0])
    np.testing.assert_array_equal(got.y, [0, 0, 0, 0, 0])
    np.testing.assert_array_equal(got.q, [0, 0, 3, 0, 0])
    np.testing.assert_array_equal(got.w, [0, 0, 52, -1, 1])


# ---------------------------------------------------------------------------
# counterparts of tests/test_timezone.py
# ---------------------------------------------------------------------------

INSTANTS = [
    dt.datetime(2024, 1, 15, 12, 0, tzinfo=dt.timezone.utc),
    dt.datetime(2024, 7, 15, 12, 0, tzinfo=dt.timezone.utc),
    dt.datetime(2024, 3, 10, 9, 59, 59, tzinfo=dt.timezone.utc),
    dt.datetime(2024, 3, 10, 10, 0, 1, tzinfo=dt.timezone.utc),
    dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc),
    dt.datetime(2030, 6, 1, tzinfo=dt.timezone.utc),
    dt.datetime(1950, 6, 1, tzinfo=dt.timezone.utc),
]
ZONES = ["America/Los_Angeles", "Asia/Kolkata", "UTC", "Europe/Berlin",
         "Australia/Sydney", "Pacific/Marquesas", "America/New_York"]


def _tz_table():
    micros = [int(i.timestamp() * 1_000_000) for i in INSTANTS]
    return pa.table({"ts": pa.array(micros, pa.timestamp("us"))})


@pytest.mark.parametrize("zone", ZONES)
def test_tz_functions_vs_zoneinfo(zone):
    t = _tz_table()
    out = _both(t, [f"at_timezone(ts, '{zone}') as lt",
                    f"timezone_hour(ts, '{zone}') as th",
                    f"timezone_minute(ts, '{zone}') as tm"])
    for inst, lt, th, tm in zip(INSTANTS, out["lt"], out["th"], out["tm"]):
        loc = inst.astimezone(ZoneInfo(zone))
        off = int(loc.utcoffset().total_seconds())
        want = inst.replace(tzinfo=None) + dt.timedelta(seconds=off)
        assert lt.to_pydatetime() == want, (zone, inst)
        sign = -1 if off < 0 else 1
        assert th == sign * (abs(off) // 3600), (zone, inst, th)
        assert tm == sign * ((abs(off) % 3600) // 60), (zone, inst, tm)


def test_tz_unknown_zone_raises():
    t = pa.table({"ts": pa.array([0], pa.timestamp("us"))})
    plan = (PlanBuilder().values([t])
            .project(["at_timezone(ts, 'Not/AZone') as x"]).plan())
    with pytest.raises(ValueError, match="Not/AZone"):
        Task(plan, CPU).run()


def test_zone_reader_needs_no_tzdata_package(monkeypatch):
    """The zone table comes from /usr/share/zoneinfo without importing
    ``tzdata``; the reference imports it first, so without the package
    every zone function raises there (ROADMAP C)."""
    from velox_tpu.functions import datetime as JDT
    monkeypatch.setitem(sys.modules, "tzdata", None)  # import fails
    TDT._tz_table.cache_clear()
    JDT._tz_table.cache_clear()
    try:
        trans, offs = TDT._tz_table("America/New_York")
        assert len(trans) > 100 and offs[0] < 0
        with pytest.raises(ImportError):
            JDT._tz_table("America/New_York")
        with pytest.raises(ValueError, match="Not/AZone"):
            TDT._tz_table("Not/AZone")
    finally:
        TDT._tz_table.cache_clear()
        JDT._tz_table.cache_clear()


def test_zone_reader_falls_back_to_the_tzdata_package(monkeypatch,
                                                      tmp_path):
    """A zone missing from the zoneinfo directory is read from tzdata."""
    pytest.importorskip("tzdata")
    monkeypatch.setattr(TDT, "ZONEINFO", str(tmp_path))
    TDT._tz_table.cache_clear()
    try:
        trans, offs = TDT._tz_table("Asia/Kolkata")
        assert 19800 in set(offs.tolist())
    finally:
        TDT._tz_table.cache_clear()


# ---------------------------------------------------------------------------
# TIMESTAMP edges: every unit against the reference and numpy
# ---------------------------------------------------------------------------

_UNITS_TS = ["millisecond", "second", "minute", "hour", "day", "week",
             "month", "quarter", "year"]


@pytest.mark.parametrize("unit", _UNITS_TS)
def test_timestamp_date_add_diff_trunc_every_unit(unit):
    t = _ts_table()
    proj = [f"date_add('{unit}', n, ts) as a",
            f"date_diff('{unit}', ts, ts2) as df"]
    if unit not in ("millisecond", "week"):
        proj.append(f"date_trunc('{unit}', ts) as tr")
    if unit in ("day", "week", "month", "quarter", "year"):
        proj += [f"date_add('{unit}', n, d) as ad",
                 f"date_diff('{unit}', d, cast(ts2 as date)) as dd"]
    got = _both(t, proj)
    if unit in ("millisecond", "second", "minute", "hour", "day"):
        us = {"millisecond": 1000, "second": 10 ** 6, "minute": 6 * 10 ** 7,
              "hour": 36 * 10 ** 8, "day": US_DAY}[unit]
        a = t.column("ts").cast(pa.int64()).to_numpy(zero_copy_only=False)
        b = t.column("ts2").cast(pa.int64()).to_numpy()
        valid = t.column("ts").is_valid().to_numpy(zero_copy_only=False)
        d = (b - np.where(valid, a, 0))
        want = np.sign(d) * (np.abs(d) // us)
        np.testing.assert_array_equal(got.df.to_numpy()[valid], want[valid])


def test_time_parts_unixtime_and_week_of_timestamps():
    t = _ts_table(1)
    got = _both(t, ["hour(ts) as h", "minute(ts) as mi", "second(ts) as s",
                    "millisecond(ts) as ms", "week(ts) as w",
                    "week_of_year(d) as wd", "to_unixtime(ts) as u",
                    "from_unixtime(n * 1000.5) as fu", "year(ts) as y",
                    "day_of_week(ts) as dw"])
    ts = pd.to_datetime(t.column("ts").to_pandas())
    ok = ts.notna().to_numpy()
    np.testing.assert_array_equal(got.h[ok], ts.dt.hour[ok])
    np.testing.assert_array_equal(got.mi[ok], ts.dt.minute[ok])
    np.testing.assert_array_equal(got.s[ok], ts.dt.second[ok])
    np.testing.assert_array_equal(got.ms[ok], ts.dt.microsecond[ok] // 1000)
    np.testing.assert_array_equal(got.w[ok],
                                  ts.dt.isocalendar().week[ok].to_numpy())


def test_timestamp_sort_and_group_keys():
    t = _ts_table(2)

    def run(B, build):
        return build(B().values([t]))

    for build in (lambda b: b.order_by(["ts DESC NULLS LAST", "n"]).plan(),
                  lambda b: b.top_n(["ts", "n"], 17).plan()):
        want = JTask(run(JPlanBuilder, build)).run()
        got = Task(run(PlanBuilder, build), CPU).run()
        assert got.to_pylist() == want.to_pylist()
    agg = lambda b: b.project(  # noqa: E731
        ["date_trunc('month', ts) as m", "ts", "n"]).single_aggregation(
        ["m"], ["count(*) as c", "min(ts) as lo", "max(ts) as hi",
                "sum(n) as s"]).order_by(["m"]).plan()
    want = JTask(run(JPlanBuilder, agg)).run()
    got = Task(run(PlanBuilder, agg), CPU).run()
    assert got.to_pylist() == want.to_pylist()
    months = pd.to_datetime(t.column("ts").to_pandas()).dt.to_period("M")
    assert got.num_rows == months.nunique(dropna=False)

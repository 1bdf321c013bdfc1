"""The Spark SQL functions, the misc math and bitwise functions, $hash and
the remote functions of the torch port against the JAX reference.

* Scalar cases: each expression is parsed by each package over the row
  type of tests/test_torch_functions.py and evaluated over the same
  numpy-seeded batch (nulls, zero divisors, long decimals, a dictionary
  of strings with regex metacharacters, every day of 1992-1998): the
  data, validity, error rows and dictionary must be equal, doubles within
  ``TOLERANCES``.
* Counterparts of tests/test_spark_hash.py, tests/test_spark_batch2.py,
  tests/test_remote_functions.py and the A.9 cases of
  tests/test_functions.py: each plan runs through both packages' Task
  over the same pyarrow tables, the results must be equal, and the
  reference test's own assertions (Spark's hash vectors among them) hold
  on the port's result.
* Registry parity: the same names, overload counts, aliases and special
  forms, and the same return type for every name over a fixed set of
  argument types.
* Faults the port does not copy: the reference hashes a subnormal DOUBLE
  as 0.0; over a raw string column both packages fail.
"""

import dataclasses
import datetime as dt
import hashlib
import itertools
import zlib

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from test_torch_functions import (
    CAP, _assert_matches, _batches, _raw_s, _row_types,
)
from tpch_sql import TOLERANCES
from velox_tpu import types as JT
from velox_tpu.exec.task import Task as JTask
from velox_tpu.expression.eval import ExprSet as JExprSet
from velox_tpu.parse.parser import parse_expression as jparse
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch import types as TT
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.expression.eval import ExprSet as TExprSet
from velox_tpu_torch.parse.parser import parse_expression as tparse
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

CPU = QueryCtx("cpu")
REL_TOL = TOLERANCES.get(0, (1e-9, 1))[0]


def _same_tables(got: pa.Table, want: pa.Table, what, plan=None) -> None:
    if plan is None:
        assert got.schema == want.schema, what
    else:
        # the port's columns come out in the plan's declared types (the
        # reference's in their storage types: weekday's INTEGER as int64)
        assert got.schema.names == want.schema.names, what
        assert got.schema.types == [
            TT.to_arrow(t) for t in plan.output_type().children], what
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):
            gn = np.array(g.to_pylist(), dtype=float)
            wn = np.array(w.to_pylist(), dtype=float)
            assert (np.isnan(gn) == np.isnan(wn)).all(), (what, name)
            ok = ~np.isnan(wn)
            np.testing.assert_allclose(gn[ok], wn[ok], rtol=REL_TOL,
                                       err_msg=f"{what} {name}")
            assert g.null_count == w.null_count, (what, name)
        else:
            assert g.to_pylist() == w.to_pylist(), (what, name)


def _both(build) -> pa.Table:
    """``build(PlanBuilder class)``'s plan through both engines, row for
    row equal; the port's result."""
    want = JTask(build(JPlanBuilder)).run()
    plan = build(PlanBuilder)
    got = Task(plan, CPU).run()
    _same_tables(got, want, "plan", plan)
    return got


def _proj(t, exprs) -> pa.Table:
    return _both(lambda B: B().values([t]).project(exprs).plan())


def _h(t, expr):
    return _proj(t, [f"{expr} as h"]).column("h").to_pylist()


# ---------------------------------------------------------------------------
# Scalar cases over the seeded batch of tests/test_torch_functions.py
# ---------------------------------------------------------------------------

MISC = [
    "nullif(i, 3)", "nullif(s, 'apple')", "nullif(d, e)", "nullif(p, 0)",
    "asin(d / 100)", "acos(e / 10)", "atan(d)", "sinh(e)", "cosh(e)",
    "tanh(d)", "degrees(d)", "radians(d)", "atan2(d, e)",
    "log(2.0, abs(d) + 1)", "pi() * d", "e() + d", "bitwise_and(k, j)",
    "bitwise_or(i, k)", "bitwise_xor(k, j)", "bitwise_shift_left(i, 3)",
    "bitwise_arithmetic_shift_right(k, 7)", "bitwise_not(k)",
    "shiftleft(k, i)", "shiftright(k, i)", "truncate(d)", "truncate(p)",
    "truncate(i)", "width_bucket(d, -50, 50, 10)",
    "width_bucket(e, 5, -5, i)",
]
HASHES = [
    "hash(k)", "hash(i)", "hash(d)", "hash(e)", "hash(p)",
    "hash(l_quantity)", "hash(b)", "hash(dt)", "hash(s)", "hash(n)",
    "hash(q)", "hash(cast(d as real))", "hash(cast(dt as timestamp))",
    "hash(k, i, s, d)", "hash(s, k)", "hash(s, n, s)", "hash(j, s, i)",
    "xxhash64(k)", "xxhash64(i)", "xxhash64(d)", "xxhash64(p)",
    "xxhash64(l_quantity)", "xxhash64(b)", "xxhash64(dt)", "xxhash64(s)",
    "xxhash64(n)", "xxhash64(cast(d as real))", "xxhash64(k, i, s, d)",
    "xxhash64(s, k)", "xxhash64(j, s, i)", "hash_with_seed(7, k, s)",
    "hash_with_seed(-3, s, i)", "xxhash64_with_seed(-3, s, i)",
    "xxhash64_with_seed(12345678901, d, s)",
    "pmod(hash(k), 200)", "pmod(xxhash64(s, j), 7)",
]
SPARK_SCALAR = [
    "pmod(k, 7)", "pmod(k, -7)", "pmod(d, 2.5)", "pmod(i, 3)",
    "datediff(dt, date '1995-01-01')", "datediff(date '1995-01-01', dt)",
    "add_months(dt, i)", "add_months(dt, 1)", "date_add(dt, i)",
    "date_sub(dt, 7)", "unix_date(dt)", "weekday(dt)", "last_day(dt)",
    "make_date(year(dt), 2, 28)", "next_day(dt, 'Mon')",
    "next_day(dt, 'sunday')", "next_day(dt, 'xx')",
    "months_between(dt, date '1995-03-15')",
    "months_between(last_day(dt), date '1996-02-29')", "year_of_week(dt)",
    "dayofmonth(dt)", "dayofweek(dt)", "dayofyear(dt)", "weekofyear(dt)",
    "date_from_unix_date(i)", "timestamp_millis(k)",
    "timestamp_micros(k)", "unix_seconds(cast(dt as timestamp))",
    "unix_millis(cast(dt as timestamp))",
    "unix_micros(cast(dt as timestamp))",
    "unix_timestamp(cast(dt as timestamp))",
    "to_unix_timestamp(cast(dt as timestamp))", "bit_count(k)",
    "bit_count(i)", "bit_get(k, 3)", "bit_get(k, i)", "factorial(i)",
    "least_skipnull(i, j, k)", "greatest_skipnull(d, e)",
    "least_skipnull(d, p)", "spark_partition_id()", "unscaled_value(p)",
    "unscaled_value(l_quantity)", "nvl(j, k)", "ifnull(i, 0)",
    "isnull(d)", "isnotnull(s)", "nvl(s, 'apple')",
]
SPARK_STRINGS = [
    "ascii(s)", "crc32(s)", "md5(s)", "initcap(s)", "lpad(s, 6, '*')",
    "lpad(s, 4)", "rpad(s, 4)", "rpad(s, 7, 'ab')",
    "levenshtein(s, 'apple')", "translate(s, 'ab', 'x')", "locate('a', s)",
    "locate('a', s, 3)", "find_in_set(s, 'apple,a.b,50%')",
    "substring_index(s, 'a', 1)", "substring_index(s, 'a', -1)",
    "substring_index(s, '', 2)", "repeat(s, 2)", "overlay(s, 'XY', 2)",
    "overlay(s, 'XY', 2, 0)", "soundex(s)", "hex(s)", "unhex(n)",
    "unhex(hex(s))", "lcase(s)", "ucase(s)", "char_length(s)", "left(s, 3)",
    "startswith(s, 'a')", "endswith(s, 'b')", "bit_length(s)", "chr(i)",
    "chr(k)", "conv(n, 10, 16)", "conv(n, 16, 2)", "conv(n, 36, 2)",
    "sha1(s)",
    "sha2(s, 256)", "sha2(s, 512)", "sha2(s, 0)", "mask(s)",
    "mask(s, 'U', 'l', 'd', '*')", "empty2null(s)", "instr(s, 'a')",
]


@pytest.mark.parametrize("text", MISC)
def test_misc_function_matches_reference(text):
    _assert_matches(text)


@pytest.mark.parametrize("text", HASHES)
@pytest.mark.parametrize("seed", [0, 1])
def test_hash_matches_reference(text, seed):
    _assert_matches(text, seed)


@pytest.mark.parametrize("args", ["k", "k, i, d, s", "e, p, dt, b", "q",
                                  "cast(d as real), j"])
def test_internal_row_hash_matches_reference(args):
    """$hash (no parser syntax: the call is renamed after parsing)."""
    from test_torch_expression import _assert_same_column
    jrt, trt = _row_types()
    je = dataclasses.replace(jparse(f"hash({args})", jrt), name="$hash",
                             dtype=JT.BIGINT)
    te = dataclasses.replace(tparse(f"hash({args})", trt), name="$hash",
                             dtype=TT.BIGINT)
    jbatch, tbatch, _, _ = _batches(0)
    jv = JExprSet([je], jrt).eval_batch(jbatch)[0]
    tv = TExprSet([te], trt).eval_batch(tbatch)[0]
    _assert_same_column(tv.to_column(CAP), jv.to_column(CAP), args)


def _assert_valid_rows_match(text):
    """Equal validity, and equal data on the valid rows: the NULL rows'
    data of a checked operation is whatever each framework computes for a
    zero divisor."""
    from test_torch_expression import _np
    jrt, trt = _row_types()
    jbatch, tbatch, _, _ = _batches(0)
    jv = JExprSet([jparse(text, jrt)], jrt).eval_batch(jbatch)[0]
    tv = TExprSet([tparse(text, trt)], trt).eval_batch(tbatch)[0]
    jcol, tcol = jv.to_column(CAP), tv.to_column(CAP)
    assert str(tcol.dtype) == str(jcol.dtype)
    valid = _np(jcol.validity)
    np.testing.assert_array_equal(tcol.validity.numpy(), valid)
    np.testing.assert_allclose(tcol.data.numpy()[valid],
                               _np(jcol.data)[valid], rtol=REL_TOL)


@pytest.mark.parametrize("text", SPARK_SCALAR)
def test_spark_scalar_matches_reference(text):
    if text.startswith("pmod"):
        _assert_valid_rows_match(text)
    else:
        _assert_matches(text)


@pytest.mark.parametrize("text", SPARK_STRINGS)
def test_spark_string_function_matches_reference(text):
    _assert_matches(text)


# ---------------------------------------------------------------------------
# tests/test_spark_hash.py
# ---------------------------------------------------------------------------

I64_EDGES = pa.array([1, 0, -1, None, 2**63 - 1, -2**63], pa.int64())
STRINGS = ["Spark", "", "abcdefghijklmnopqrstuvwxyz", None, "12345678"]


def test_murmur3_int64():
    assert _h(pa.table({"x": I64_EDGES}), "hash(x)") == [
        -1712319331, -1670924195, -939490007, 42, -1604625029, -853646085]


def test_murmur3_int32_bool():
    t = pa.table({"x": pa.array([1, 0, -1, None], pa.int32())})
    assert _h(t, "hash(x)") == [-559580957, 933211791, -1604776387, 42]
    t = pa.table({"x": pa.array([True, False, None], pa.bool_())})
    assert _h(t, "hash(x)") == [-559580957, 933211791, 42]


def test_murmur3_string():
    t = pa.table({"x": pa.array(STRINGS, pa.string())})
    assert _h(t, "hash(x)") == [
        228093765, 142593372, -1990933474, 42, 2036199019]


FLOATS = [-0.0, 0.0, 1.0, float("nan"), float("inf"), float("-inf")]


def test_murmur3_floats():
    t = pa.table({"x": pa.array(FLOATS + [None], pa.float64())})
    assert _h(t, "hash(x)") == [
        -1670924195, -1670924195, -460888942, -1281358385, 833680482,
        461104036, 42]
    t = pa.table({"x": pa.array([np.float32(f) for f in FLOATS],
                                pa.float32())})
    assert _h(t, "hash(x)") == [
        933211791, 933211791, -466301895, -349261430, 2026854605,
        427440766]


def _chain_table():
    return pa.table({"a": pa.array([None, "", None, ""], pa.string()),
                     "b": pa.array([None, None, 0, 0], pa.int32())})


def test_murmur3_seed_chain():
    assert _h(_chain_table(), "hash(a, b)") == [
        42, 142593372, 933211791, 1143746540]


def test_xxhash64_ints():
    assert _h(pa.table({"x": I64_EDGES}), "xxhash64(x)") == [
        -7001672635703045582, -5252525462095825812, 3858142552250413010,
        42, -3246596055638297850, -8619748838626508300]
    t = pa.table({"x": pa.array([1, 0, -1, None], pa.int32())})
    assert _h(t, "xxhash64(x)") == [
        -6698625589789238999, 3614696996920510707, 2017008487422258757, 42]


def test_xxhash64_string_all_tail_shapes():
    # empty, 5 B (byte tail), 8 B (one word), 26 B (words + 4 B + tail),
    # 34 B (>= 32: the four-lane stripe path)
    t = pa.table({"x": pa.array(
        ["Spark", "", "abcdefghijklmnopqrstuvwxyz", "12345678",
         "12345678djdejidecjjeijcneknceincne", None], pa.string())})
    assert _h(t, "xxhash64(x)") == [
        -4294468057691064905, -7444071767201028348, -3265757659154784300,
        6863040065134489090, -633855189410948723, 42]


def test_xxhash64_double_and_chain():
    t = pa.table({"x": pa.array(FLOATS + [None], pa.float64())})
    assert _h(t, "xxhash64(x)") == [
        -5252525462095825812, -5252525462095825812, -2162451265447482029,
        -3127944061524951246, 5810986238603807492, 5326262080505358431, 42]
    assert _h(_chain_table(), "xxhash64(a, b)") == [
        42, -7444071767201028348, 3614696996920510707, 5333022629466737987]


@pytest.mark.parametrize("expr", ["hash(x, y)", "xxhash64(x, y)",
                                  "hash(y, x)", "xxhash64(y, x)"])
def test_string_hash_of_every_length_and_seed(expr):
    """Strings of 0-70 bytes (every murmur3 tail and xxhash64 stripe
    shape), multi-byte UTF-8, first in the chain (each dictionary value
    hashed once) and after a column (per-row seeds)."""
    rng = np.random.default_rng(3)
    alpha = list("abcxyz019 ,é漢")
    words = ["".join(rng.choice(alpha, n)) for n in range(71)]
    n = 400
    t = pa.table({
        "x": pa.array([words[i] if i % 13 else None
                       for i in rng.integers(0, 71, n)], pa.string()),
        "y": pa.array(rng.integers(-10**12, 10**12, n), pa.int64())})
    _h(t, expr)


def test_spark_date_functions():
    t = pa.table({"d": pa.array([dt.date(2020, 2, 15), dt.date(2021, 12, 31),
                                 dt.date(1999, 1, 1)], pa.date32()),
                  "n": pa.array([10, -400, 0], pa.int64())})
    got = _proj(t, ["date_add(d, n) as da", "date_sub(d, n) as ds",
                    "unix_date(d) as ud", "weekday(d) as wd",
                    "last_day(d) as ld", "make_date(2020, 2, 29) as md"]
                ).to_pandas()
    assert got.da[0] == dt.date(2020, 2, 25)
    assert got.ds[1] == dt.date(2023, 2, 4)
    assert got.ud[2] == (dt.date(1999, 1, 1) - dt.date(1970, 1, 1)).days
    assert got.wd[0] == 5  # 2020-02-15 was a Saturday
    assert got.ld[0] == dt.date(2020, 2, 29)
    assert got.ld[1] == dt.date(2021, 12, 31)
    assert got.md[0] == dt.date(2020, 2, 29)


def test_spark_string_hashes_and_ascii():
    t = pa.table({"s": ["hello", "", "Spark SQL"]})
    got = _proj(t, ["ascii(s) as a", "crc32(s) as c", "md5(s) as m"])
    assert got.column("a").to_pylist() == [ord("h"), 0, ord("S")]
    assert got.column("c").to_pylist() == [
        zlib.crc32(b"hello"), zlib.crc32(b""), zlib.crc32(b"Spark SQL")]
    assert got.column("m")[0].as_py() == hashlib.md5(b"hello").hexdigest()


def test_least_greatest_skip_nulls():
    t = pa.table({"a": [1.0, None, None], "b": [5.0, 2.0, None],
                  "c": [3.0, None, None]})
    got = _proj(t, ["least_skipnull(a, b, c) as lo",
                    "greatest_skipnull(a, b, c) as hi"])
    assert got.column("lo").to_pylist() == [1.0, 2.0, None]
    assert got.column("hi").to_pylist() == [5.0, 2.0, None]


# ---------------------------------------------------------------------------
# tests/test_spark_batch2.py
# ---------------------------------------------------------------------------

def test_string_batch2():
    t = pa.table({"s": pa.array(["hello world", "FOO bar", "", "a,b,c"])})
    out = _proj(t, [
        "initcap(s) as ic", "lpad(s, 5, '*') as lp", "rpad(s, 5) as rp",
        "levenshtein(s, 'hello') as lv", "translate(s, 'lo', 'x') as tr",
        "locate('o', s) as lc", "substring_index(s, ' ', 1) as si",
        "repeat(s, 2) as rp2", "overlay(s, 'XY', 2) as ov",
        "soundex(s) as sx", "hex(s) as hx"]).to_pandas()
    assert out.ic[0] == "Hello World" and out.ic[1] == "Foo Bar"
    assert out.lp[0] == "hello" and out.lp[2] == "*****"
    assert out.rp[1] == "FOO b" and out.rp[2] == "     "
    assert out.lv[0] == 6 and out.lv[2] == 5
    assert out.tr[0] == "hexx wrxd"
    assert out.lc[0] == 5 and out.lc[2] == 0
    assert out.si[0] == "hello" and out.si[2] == ""
    assert out.rp2[2] == "" and out.rp2[1] == "FOO barFOO bar"
    assert out.ov[0] == "hXYlo world"
    assert out.sx[0] == "H464"
    assert out.hx[2] == ""


def test_find_in_set_unhex():
    t = pa.table({"s": pa.array(["b", "d", "a,b"])})
    out = _proj(t, ["find_in_set(s, 'a,b,c') as f", "unhex(s) as u"])
    assert out.column("f").to_pylist() == [2, 0, 0]
    assert out.column("u").to_pylist() == [None, None, None]


def test_bitwise_factorial():
    t = pa.table({"x": pa.array([0, 1, 255, -1, 20], pa.int64())})
    out = _proj(t, ["bit_count(x) as bc", "bit_get(x, 0) as bg",
                    "factorial(x) as fa"])
    assert out.column("bc").to_pylist() == [0, 1, 8, 64, 2]
    assert out.column("bg").to_pylist() == [0, 1, 1, 1, 0]
    assert out.column("fa").to_pylist() == [
        1, 1, None, None, 2432902008176640000]


def test_dates_batch2():
    days = [(dt.date(2024, 2, 29) - dt.date(1970, 1, 1)).days,
            (dt.date(2024, 3, 15) - dt.date(1970, 1, 1)).days]
    t = pa.table({"d": pa.array(days, pa.int32()).cast(pa.date32()),
                  "e": pa.array(days[::-1], pa.int32()).cast(pa.date32())})
    out = _proj(t, ["next_day(d, 'Mon') as nd",
                    "months_between(d, e) as mb"]).to_pandas()
    assert out.nd[0] == dt.date(2024, 3, 4)
    assert abs(out.mb[0] - (-1 + 14 / 31.0)) < 1e-9
    assert abs(out.mb[1] - (1 - 14 / 31.0)) < 1e-9


def test_unix_timestamp():
    t = pa.table({"ts": pa.array([dt.datetime(2020, 1, 1, 0, 0, 30)],
                                 pa.timestamp("us"))})
    assert _proj(t, ["unix_timestamp(ts) as u"]).column("u").to_pylist() \
        == [1577836830]


# ---------------------------------------------------------------------------
# tests/test_functions.py: the A.9 cases
# ---------------------------------------------------------------------------

def test_nullif_and_math():
    t = pa.table({"a": [1.0, 2.0, 3.0, 2.0], "b": [2.0, 2.0, 2.0, 3.0]})
    got = _proj(t, ["nullif(a, b) as nf", "atan2(a, b) as a2",
                    "log(2.0, a) as lg"]).to_pandas()
    assert got.nf.isna().tolist() == [False, True, False, False]
    np.testing.assert_allclose(got.a2, np.arctan2(t["a"], t["b"]),
                               rtol=1e-12)
    np.testing.assert_allclose(got.lg, np.log2(t["a"]), rtol=1e-12)


def test_bitwise():
    a = np.array([5, -3, 255, 0], "int64")
    b = np.array([3, 1, 15, 7], "int64")
    got = _proj(pa.table({"a": a, "b": b}), [
        "bitwise_and(a, b) as ba", "bitwise_or(a, b) as bo",
        "bitwise_xor(a, b) as bx", "bitwise_shift_left(a, b) as sl"])
    np.testing.assert_array_equal(got.column("ba"), a & b)
    np.testing.assert_array_equal(got.column("bo"), a | b)
    np.testing.assert_array_equal(got.column("bx"), a ^ b)
    np.testing.assert_array_equal(got.column("sl"), a << b)


def test_sparksql_package():
    df = pd.DataFrame({
        "a": np.array([7, -7, 5], "int64"), "b": np.array([3, 3, 0], "int64"),
        "d": np.array(["2020-01-31", "2020-03-15", "2019-12-01"],
                      dtype="datetime64[D]"),
        "e": np.array(["2020-02-10", "2020-03-10", "2020-01-01"],
                      dtype="datetime64[D]")})
    got = _proj(pa.table(df), [
        "pmod(a, b) as pm", "nvl(a, 0) as nv", "datediff(e, d) as dd",
        "add_months(d, 1) as am", "shiftleft(a, 2) as sl"]).to_pandas()
    np.testing.assert_array_equal(got.pm[:2], [1, 2])
    assert pd.isna(got.pm[2])
    np.testing.assert_array_equal(
        got.dd, (df.e.to_numpy() - df.d.to_numpy())
        .astype("timedelta64[D]").astype(int))
    np.testing.assert_array_equal(
        pd.DatetimeIndex(got.am),
        pd.DatetimeIndex(df.d) + pd.DateOffset(months=1))
    np.testing.assert_array_equal(got.sl, df.a.to_numpy() << 2)


def test_spark_size():
    t = pa.table({"arr": pa.array([[1, 2], [], [5, 6, 7], None],
                                  pa.list_(pa.int64()))})
    assert _proj(t, ["size(arr) as n"]).column("n").to_pylist() == [
        2, 0, 3, None]


def test_pmod_negative_divisor():
    """Spark's Pmod with Java's truncating %: pmod(10, -3) = 1,
    pmod(-10, -3) = -1."""
    t = pa.table({"a": pa.array([10, -10, -7, 7], pa.int64()),
                  "b": pa.array([-3, -3, 3, 3], pa.int64())})
    assert _proj(t, ["pmod(a, b) as pm"]).column("pm").to_pylist() == [
        1, -1, 2, 1]


# ---------------------------------------------------------------------------
# Registry parity
# ---------------------------------------------------------------------------

def _registries():
    import velox_tpu.functions  # noqa: F401
    import velox_tpu_torch.functions  # noqa: F401
    from velox_tpu.expression.eval import _SPECIAL_FORMS as JS
    from velox_tpu.functions.registry import _REGISTRY as JR
    from velox_tpu_torch.expression.eval import _SPECIAL_FORMS as TS
    from velox_tpu_torch.functions.registry import _REGISTRY as TR

    def builtin(reg):
        # remote functions registered by tests are not the package's
        return {n: fns for n, fns in reg.items()
                if not any(f.eval_fn.__module__.endswith(".remote")
                           for f in fns)}
    return builtin(JR), builtin(TR), JS, TS


def _alias_groups(reg):
    groups = {}
    for name, fns in reg.items():
        groups.setdefault(id(fns), []).append(name)
    return sorted(sorted(g) for g in groups.values() if len(g) > 1)


def test_registries_hold_the_same_names_overloads_and_aliases():
    jr, tr, js, ts = _registries()
    assert len(jr) == 239
    assert sorted(tr) == sorted(jr)
    assert {n: len(f) for n, f in tr.items()} == \
        {n: len(f) for n, f in jr.items()}
    assert _alias_groups(tr) == _alias_groups(jr)
    assert sorted(ts) == sorted(js)
    for name in ("nvl", "ifnull", "isnull", "isnotnull", "exists",
                 "forall", "aggregate", "sort_array"):
        assert name in ts


_TYPE_NAMES = ["bigint", "integer", "double", "varchar", "date",
               "timestamp", "decimal(12,2)", "boolean", "array(bigint)",
               "map(varchar,bigint)", "decimal(38,2)"]


def _resolve(mod, name, types):
    try:
        return str(mod.resolve_return_type(name, types))
    except (KeyError, NotImplementedError):
        return "unresolved"


# every tuple of up to two of _TYPE_NAMES, of three of its first seven,
# and the longer signatures (width_bucket, make_timestamp, map, ...)
_TUPLES = {
    0: [()], 1: [(t,) for t in _TYPE_NAMES],
    2: list(itertools.product(_TYPE_NAMES, repeat=2)),
    3: list(itertools.product(_TYPE_NAMES[:7], repeat=3)),
    "long": [("double",) * 4, ("bigint",) * 4, ("varchar", "bigint") * 2,
             ("bigint",) * 6, ("integer",) * 5 + ("decimal(12,2)",),
             ("bigint",) * 6 + ("varchar",), ("varchar",) * 4,
             ("varchar",) * 5, ("varchar",) * 6, ("date",) * 4],
}


@pytest.mark.parametrize("arity", sorted(_TUPLES, key=str))
def test_every_name_resolves_to_the_same_return_type(arity):
    from velox_tpu.functions import registry as JReg
    from velox_tpu_torch.functions import registry as TReg
    jr, _, _, _ = _registries()
    tuples = _TUPLES[arity]
    checked = 0
    for name in sorted(jr):
        for combo in tuples:
            want = _resolve(JReg, name, [JT.parse_type(t) for t in combo])
            got = _resolve(TReg, name, [TT.parse_type(t) for t in combo])
            assert got == want, (name, combo)
            checked += want != "unresolved"
    assert checked > 0


# ---------------------------------------------------------------------------
# Faults the port does not copy, kept limits
# ---------------------------------------------------------------------------

SUBNORMALS = [5e-324, 1e-310]


def test_double_hash_uses_the_true_bits_where_the_reference_flushes_subnormals():
    """Spark hashes doubleToLongBits: 5e-324 has the bits 1, so its
    hash(x) is hashLong(1) = -1712319331 and xxhash64 -70016...582. The
    reference rebuilds the bits with frexp and flushes subnormals to 0.0
    (velox_tpu/functions/sparksql.py ``_double_bits``), giving the hashes
    of 0.0."""
    t = pa.table({"x": pa.array(SUBNORMALS, pa.float64()),
                  "one": pa.array([1, 1], pa.int64())})
    plan = lambda B: B().values([t]).project([  # noqa: E731
        "hash(x) as h", "xxhash64(x) as xx", "hash(one) as h1",
        "xxhash64(one) as xx1"]).plan()
    got = Task(plan(PlanBuilder), CPU).run()
    want = JTask(plan(JPlanBuilder)).run()
    assert got.column("h")[0].as_py() == -1712319331
    assert got.column("h")[0] == got.column("h1")[0] \
        == want.column("h1")[0]
    assert got.column("xx")[0].as_py() == -7001672635703045582
    assert got.column("xx")[0] == want.column("xx1")[0]
    bits = np.array(SUBNORMALS).view(np.int64)
    assert len(set(got.column("h").to_pylist())) == 2 and bits[1] != bits[0]
    assert want.column("h").to_pylist() == [-1670924195] * 2
    assert want.column("xx").to_pylist() == [-5252525462095825812] * 2


def test_truncate_of_a_long_decimal_divides_both_limbs():
    """truncate(q) over DECIMAL(38,2) against Python integers (toward
    zero); the reference divides the low limb alone (ROADMAP C), which
    this batch's values past 2^63 show."""
    from test_torch_functions import N_ACTIVE, _long_ints
    jrt, trt = _row_types()
    jbatch, tbatch, _, q = _batches(0)
    col = TExprSet([tparse("truncate(q)", trt)], trt).eval_batch(
        tbatch)[0].to_column(CAP)
    assert str(col.dtype) == "decimal(38,0)"
    live = (np.arange(CAP) < N_ACTIVE) & np.asarray(
        tbatch.columns["q"].validity)
    got = _long_ints(col)
    want = [abs(v) // 100 * (1 if v >= 0 else -1) for v in q]
    assert all(g == w for g, w, ok in zip(got, want, live) if ok)
    jcol = JExprSet([jparse("truncate(q)", jrt)], jrt).eval_batch(
        jbatch)[0].to_column(CAP)
    jlo = np.asarray(jcol.data)
    assert any(int(lo) != (w & (2 ** 64 - 1)) - (
        2 ** 64 if (w & (2 ** 64 - 1)) >= 2 ** 63 else 0)
        for lo, w, ok in zip(jlo, want, live) if ok)


@pytest.mark.parametrize("shift", [-1, 0, 63, 64, 70])
def test_shifts_out_of_range_match_reference(shift):
    _assert_matches(f"bitwise_shift_left(k, {shift})")
    _assert_matches(f"bitwise_arithmetic_shift_right(k, {shift})")


@pytest.mark.parametrize("text", ["hash(s)", "xxhash64(k, s)", "md5(s)",
                                  "levenshtein(s, 'a')", "hex(s)"])
def test_functions_over_a_raw_string_column_fail_in_both(text):
    """Neither package has a raw form of these: the port raises
    NotImplementedError naming the case; the reference fails too (its
    Spark hashes read the missing dictionary: AttributeError)."""
    jrt, trt = _row_types()
    jbatch, tbatch, arrays, _ = _batches(0)
    _raw_s(jbatch, tbatch, arrays)
    with pytest.raises(NotImplementedError, match="raw"):
        TExprSet([tparse(text, trt)], trt).eval_batch(tbatch)
    with pytest.raises((NotImplementedError, AttributeError)):
        JExprSet([jparse(text, jrt)], jrt).eval_batch(jbatch)


def test_monotonically_increasing_id_raises_in_both():
    t = pa.table({"x": pa.array([1, 2, 3], pa.int64())})
    with pytest.raises(NotImplementedError):
        Task(PlanBuilder().values([t]).project(
            ["monotonically_increasing_id() as i"]).plan(), CPU).run()
    with pytest.raises(NotImplementedError):
        JTask(JPlanBuilder().values([t]).project(
            ["monotonically_increasing_id() as i"]).plan()).run()


# ---------------------------------------------------------------------------
# tests/test_remote_functions.py
# ---------------------------------------------------------------------------

def _register_both(name, arg_types, result_type, fn):
    from velox_tpu.functions import remote as JRemote
    from velox_tpu_torch.functions import remote as TRemote
    for mod, types in ((JRemote, JT), (TRemote, TT)):
        transport = mod.LoopbackTransport()
        transport.serve(name, fn)
        mod.register_remote_function(
            name, [getattr(types, a) for a in arg_types],
            getattr(types, result_type), transport)


def test_remote_function_end_to_end():
    _register_both("rhypot_both", ["DOUBLE", "DOUBLE"], "DOUBLE",
                   lambda a, b, valid: (np.sqrt(a * a + b * b), valid))
    t = pa.table({"x": pa.array([3.0, 6.0, None], pa.float64()),
                  "y": pa.array([4.0, 8.0, 1.0], pa.float64())})
    got = _proj(t, ["rhypot_both(x, y) as h", "x"])
    assert got.column("h").to_pylist() == [5.0, 10.0, None]


def test_remote_function_composes_with_local():
    _register_both("rdouble_both", ["BIGINT"], "BIGINT",
                   lambda a, valid: (a * 2, valid))
    t = pa.table({"x": pa.array([1, 2, 3], pa.int64())})
    got = _both(lambda B: B().values([t]).project(
        ["rdouble_both(x) + 1 as r"]).filter("r > 3").plan())
    assert sorted(got.column("r").to_pylist()) == [5, 7]


def test_remote_function_rejects_strings():
    from velox_tpu_torch.functions.remote import (
        LoopbackTransport, register_remote_function,
    )
    with pytest.raises(NotImplementedError):
        register_remote_function("rbad", [TT.VARCHAR], TT.BIGINT,
                                 LoopbackTransport())

"""Regex, JSON, URL and IP functions and the Spark functions with ARRAY
and MAP results (split, str_to_map, the array and map constructors,
might_contain, ...) of the torch port against the JAX reference.

Each plan is built by each package's PlanBuilder over the same pyarrow
tables (strings from a numpy seed where they are not the reference
test's own) and run by each package's Task; the results must be equal,
and the reference test's assertions hold on the port's. Counterparts of
every test of tests/test_spark_batch3.py and tests/test_url_ip.py and of
tests/test_functions.py's test_regex_json_url_functions.
"""

import datetime as dt
import hashlib

import numpy as np
import pyarrow as pa
import pytest
import torch

from test_torch_sparksql import _both, _proj
from velox_tpu.common.errors import VeloxError as JVeloxError
from velox_tpu.common.errors import VeloxUserError as JVeloxUserError
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.common.errors import VeloxError, VeloxUserError
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.ops import gather as G
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

CPU = QueryCtx("cpu")


def _agg(t, keys, aggs):
    return _both(lambda B: B().values([t]).single_aggregation(
        keys, aggs).plan())


def _by_key(table: pa.Table, key: str) -> dict:
    rows = table.to_pylist()
    return {r[key]: r for r in rows}


# ---------------------------------------------------------------------------
# Seeded string columns: every function over each
# ---------------------------------------------------------------------------

URLS = [
    "https://user:pw@example.com:8443/a/b%20c?x=1&y=two#frag",
    "http://velox.io/docs", "ftp://files.example.org:21/pub",
    "not a url at all \x00", "https://example.com?x=%2Fenc", "",
    "http://h:99999/p", "https://[2001:db8::1]:8080/v6?q=a+b", "nota url",
    "https://example.com:8080/p/q?x=1&y=2#frag", "http://h/pp",
]
JDOCS = [
    '{"a": {"b": [1, 2, 3]}, "s": "x"}', '[10, 20, "t", true, null]',
    '"scalar"', "not json", "[]", '{"a": 1}', "[10, 20]", "null",
    '{"a": {"b": [1.5, {"c": false}]}, "k": [true, "20"]}', "20",
    '[1.0, 2, 20.0]', '{"x": [], "y": {}}',
]
IPS = ["10.0.0.200", "192.168.1.5", "8.8.8.8", "2001:db8::8:800:200c:417a",
       "garbage", "10.0.0.0/8", "10.1.0.0/16", "192.168.0.0/24", "bad/99",
       " 172.16.5.4 ", "::1", "fe80::/10", "10.2.3.4", "11.0.0.1"]
WORDS = ["foo123bar", "nope", "a99b", "a,b,c", "x", "", "a,,b",
         "hello world", "FOO bar", "k1:v1,k2:v2", "k:v,,z", "a:1,b:2",
         "x:9", "é漢 2024-02-29", "12:30:05", "abc123", "xyz"]


def _seeded(values, n=240, seed=11, nulls=True):
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, len(values), n)
    return pa.array([None if nulls and rng.random() < 0.08 else values[i]
                     for i in pick], pa.string())


def string_table():
    return pa.table({"u": _seeded(URLS), "j": _seeded(JDOCS, seed=12),
                     "ip": _seeded(IPS, seed=13),
                     "s": _seeded(WORDS, seed=14)})


STRING_CASES = [
    "regexp_like(s, '[0-9]+')", "rlike(s, '^a')",
    "regexp_like(s, '(?=a)a')", "regexp_extract(s, '([0-9]+)', 1)",
    "regexp_extract(s, '[a-z]+')", "regexp_replace(s, '[0-9]+', '#')",
    "regexp_replace(s, '([a-z])([0-9])', '$2$1')",
    "regexp_replace(s, '[aeiou]')",
    "json_extract_scalar(j, '$.a.b[1]')", "json_extract_scalar(j, '$.s')",
    "json_extract_scalar(j, '$.k[0]')", "json_extract(j, '$.a')",
    "get_json_object(j, '$.a.b')", "json_array_length(j)",
    "is_json_scalar(j)", "json_array_contains(j, 20)",
    "json_array_contains(j, 't')", "json_array_contains(j, true)",
    "json_array_contains(j, 2.0)", "json_array_get(j, 1)",
    "json_array_get(j, -1)", "json_format(j)", "json_size(j, '$')",
    "json_size(j, '$.a')", "url_extract_protocol(u)",
    "url_extract_host(u)", "url_extract_port(u)", "url_extract_path(u)",
    "url_extract_query(u)", "url_extract_fragment(u)",
    "url_extract_parameter(u, 'x')", "url_extract_parameter(u, 'q')",
    "url_encode(s)", "url_decode(url_encode(s))", "url_decode(u)",
    "strpos(s, 'a')", "instr(s, 'b')", "replace(s, 'a', 'o')",
    "starts_with(s, 'a')", "ends_with(s, 'b')", "split_part(s, ',', 2)",
    "split_part(s, 'o', 1)", "ip_prefix(ip, 24)", "ip_prefix(ip, 8)",
    "ip_prefix(ip, 64)", "ip_subnet_min(ip)", "ip_subnet_max(ip)",
    "is_private_ip(ip)", "is_subnet_of('10.0.0.0/8', ip)",
    "is_subnet_of(ip, '10.2.3.4')", "is_subnet_of('fe80::/10', ip)",
    "get_timestamp(s, 'HH:mm:ss')", "empty2null(s)",
]


@pytest.mark.parametrize("expr", STRING_CASES)
def test_string_function_matches_reference(expr):
    _proj(string_table(), [f"{expr} as r", "s"])


ARRAY_CASES = [
    "split(s, ',')", "split(s, ',', 2)", "split(s, '[0-9]')",
    "regexp_extract_all(s, '[a-z]+')", "regexp_extract_all(s, '([a-z])(\\d)', 2)",
    "str_to_map(s)", "str_to_map(s, ',', ':')", "str_to_map(s, ';', '=')",
    "json_object_keys(j)", "size(split(s, ','))",
    "element_at(split(s, ','), 1)", "get(split(s, ','), 1)",
    "cardinality(str_to_map(s))", "sort_array(split(s, ','))",
    "element_at(sort_array(split(s, '')), -1)",
    "array_contains(split(s, ','), 'b')", "map_keys(str_to_map(s))",
    "map_values(str_to_map(s))",
    "transform(split(s, ','), x -> length(x))",
    "exists(split(s, ','), x -> x = 'a')",
]


@pytest.mark.parametrize("expr", ARRAY_CASES)
def test_array_result_matches_reference(expr):
    _proj(string_table(), [f"{expr} as r", "s"])


def test_split_results_through_a_join_and_a_sort():
    """split's arrays gathered by a hash join and an OrderBy (explicit
    starts), then read element-wise and out through to_arrow."""
    t = pa.table({"k": pa.array(np.arange(240) % 17, pa.int64()),
                  "s": _seeded(WORDS, seed=21)})
    b = pa.table({"bk": pa.array(np.arange(0, 17, 2), pa.int64())})

    def plan(B):
        p = B().values([t]).project(["k", "split(s, ',') as a",
                                     "str_to_map(s) as m"])
        build = p.new_builder().values([b])
        return (p.hash_join(["k"], ["bk"], build, output=["k", "a", "m"])
                .order_by(["k"]).project(["k", "a", "m",
                                          "cardinality(a) as n"]).plan())
    got = Task(plan(PlanBuilder), CPU).run()
    want = JTask(plan(JPlanBuilder)).run()
    key = lambda r: (r["k"], repr(r["a"]), repr(r["m"]))  # noqa: E731
    assert sorted(got.to_pylist(), key=key) == sorted(want.to_pylist(),
                                                      key=key)


# ---------------------------------------------------------------------------
# tests/test_spark_batch3.py
# ---------------------------------------------------------------------------

def test_string_batch3():
    t = pa.table({"s": pa.array(["Hello World7", "abc", ""])})
    out = _proj(t, [
        "left(s, 3) as lf", "startswith(s, 'He') as sw",
        "endswith(s, 'c') as ew", "bit_length(s) as bl", "sha1(s) as h1",
        "sha2(s, 256) as h2", "mask(s) as mk", "instr(s, 'l') as ins"])
    o = out.to_pydict()
    assert o["lf"] == ["Hel", "abc", ""]
    assert o["sw"] == [True, False, False]
    assert o["ew"] == [False, True, False]
    assert o["bl"] == [96, 24, 0]
    assert o["h1"][1] == hashlib.sha1(b"abc").hexdigest()
    assert o["h2"][1] == hashlib.sha256(b"abc").hexdigest()
    assert o["mk"][0] == "Xxxxx Xxxxxn"
    assert o["ins"] == [3, 0, 0]


def test_chr_conv_empty2null():
    t = pa.table({"n": pa.array([65, 97, -1, 321], pa.int64()),
                  "s": pa.array(["ff", "10", "", "zz"])})
    o = _proj(t, ["chr(n) as c", "conv(s, 16, 10) as cv",
                  "empty2null(s) as e"]).to_pydict()
    assert o["c"] == ["A", "a", "", chr(321 % 256)]
    assert o["cv"][:2] == ["255", "16"]
    assert o["e"][2] is None and o["e"][0] == "ff"


def test_datetime_units():
    d0 = (dt.date(2005, 1, 2) - dt.date(1970, 1, 1)).days  # ISO year 2004
    t = pa.table({
        "u": pa.array([0, 19000], pa.int64()),
        "ts": pa.array([1_700_000_123_456_789, -1], pa.int64())
        .cast(pa.timestamp("us")),
        "d": pa.array([d0, 19000], pa.int32()).cast(pa.date32())})
    o = _proj(t, [
        "date_from_unix_date(u) as dd", "timestamp_millis(u) as tm",
        "timestamp_micros(u) as tu", "unix_seconds(ts) as us",
        "unix_millis(ts) as um", "unix_micros(ts) as uu",
        "year_of_week(d) as yw"]).to_pydict()
    assert o["dd"][1] == dt.date(1970, 1, 1) + dt.timedelta(days=19000)
    assert o["tu"][1] == dt.datetime(1970, 1, 1) + dt.timedelta(
        microseconds=19000)
    assert o["tm"][1] == dt.datetime(1970, 1, 1) + dt.timedelta(
        milliseconds=19000)
    assert o["us"] == [1_700_000_123, -1]  # floored
    assert o["um"][0] == 1_700_000_123_456
    assert o["uu"][0] == 1_700_000_123_456_789
    assert o["yw"][0] == 2004


def test_seeded_hashes_and_ids():
    t = pa.table({"x": pa.array([1, 2, 3], pa.int64())})
    o = _proj(t, ["hash(x) as h", "hash_with_seed(42, x) as hs",
                  "xxhash64(x) as xx", "xxhash64_with_seed(42, x) as xs2",
                  "spark_partition_id() as pid"]).to_pydict()
    assert o["h"] == o["hs"] and o["xx"] == o["xs2"]
    assert o["pid"] == [0, 0, 0]


def test_unscaled_value():
    import decimal
    t = pa.table({"d": pa.array([decimal.Decimal("1.23"),
                                 decimal.Decimal("-0.05")],
                                pa.decimal128(10, 2))})
    assert _proj(t, ["unscaled_value(d) as u"]).column("u").to_pylist() == [
        123, -5]


def test_split_and_extract_all():
    t = pa.table({"s": pa.array(["a,b,c", "x", "", "a,,b"])})
    o = _proj(t, ["split(s, ',') as sp",
                  "regexp_extract_all(s, '[a-z]+') as ex"]).to_pydict()
    assert o["sp"] == [["a", "b", "c"], ["x"], [""], ["a", "", "b"]]
    assert o["ex"][0] == ["a", "b", "c"] and o["ex"][2] == []


def test_rlike_exists_sort_array():
    t = pa.table({"s": pa.array(["abc123", "xyz"]),
                  "a": pa.array([[3, 1, 2], [5, 4, None]],
                                pa.list_(pa.int64()))})
    o = _proj(t, ["rlike(s, '[0-9]+') as r", "sort_array(a) as sa",
                  "exists(a, x -> x > 4) as ex",
                  "aggregate(a, 0, (acc, x) -> acc + x, acc -> acc) as ag"]
              ).to_pydict()
    assert o["r"] == [True, False]
    assert o["sa"][0] == [1, 2, 3]
    assert o["ex"] == [False, True]
    assert o["ag"][0] == 6
    # forall is all_match, three-valued in the port (Presto): [5, 4, NULL]
    # with x > 1 is NULL, where the reference's two-valued form says
    # FALSE (ROADMAP C, functions/complex.py)
    plan = lambda B: B().values([t]).project(  # noqa: E731
        ["forall(a, x -> x > 1) as fa"]).plan()
    assert Task(plan(PlanBuilder), CPU).run().column("fa").to_pylist() == [
        False, None]
    assert JTask(plan(JPlanBuilder)).run().column("fa").to_pylist() == [
        False, False]


def test_raise_error_and_try():
    t = pa.table({"x": pa.array([1, 2], pa.int64())})
    with pytest.raises(VeloxUserError):
        Task(PlanBuilder().values([t]).project(
            ["raise_error('boom') as e"]).plan(), CPU).run()
    with pytest.raises(JVeloxUserError):
        JTask(JPlanBuilder().values([t]).project(
            ["raise_error('boom') as e"]).plan()).run()
    o = _proj(t, ["try(raise_error('boom')) as e"])
    assert o.column("e").to_pylist() == [None, None]


def _maps_of(col):
    return [None if m is None else dict(m) for m in col.to_pylist()]


def test_batch4_arrays_maps():
    t = pa.table({"a": pa.array([[10, 20, 30], [5]], pa.list_(pa.int64())),
                  "i": pa.array([1, 3], pa.int64()),
                  "x": pa.array([7, 8], pa.int64()),
                  "k": pa.array([["a", "b"], ["c"]], pa.list_(pa.string())),
                  "v": pa.array([[1, 2], [3]], pa.list_(pa.int64()))})
    out = _proj(t, ["get(a, i) as g", "array_repeat(x, 3) as ar",
                    "map_from_arrays(k, v) as m"])
    assert out.column("g").to_pylist() == [20, None]
    assert out.column("ar").to_pylist()[0] == [7, 7, 7]
    assert _maps_of(out.column("m")) == [{"a": 1, "b": 2}, {"c": 3}]


def test_batch4_timestamps():
    t = pa.table({"ts": pa.array([1_700_000_000_000_000], pa.int64())
                  .cast(pa.timestamp("us")),
                  "y": pa.array([2024], pa.int64())})
    o = _proj(t, [
        "from_utc_timestamp(ts, 'America/Los_Angeles') as f",
        "to_utc_timestamp(from_utc_timestamp(ts, 'Asia/Tokyo'), "
        "'Asia/Tokyo') as rt",
        "make_timestamp(y, 2, 29, 12, 30, 5) as mk"]).to_pydict()
    assert o["rt"][0] == dt.datetime(2023, 11, 14, 22, 13, 20)
    assert o["f"][0] == o["rt"][0] - dt.timedelta(hours=8)  # PST
    assert o["mk"][0] == dt.datetime(2024, 2, 29, 12, 30, 5)


def test_batch4_str_to_map():
    t = pa.table({"s": pa.array(["a:1,b:2", "x:9", "", "k", None])})
    out = _proj(t, ["str_to_map(s) as m"])
    assert _maps_of(out.column("m")) == [
        {"a": "1", "b": "2"}, {"x": "9"}, {}, {"k": None}, None]


def test_moments_and_first_last():
    t = pa.table({"g": pa.array([1] * 5 + [2] * 5, pa.int64()),
                  "x": pa.array([1.0, 2.0, 4.0, 8.0, 16.0,
                                 3.0, 3.0, 5.0, 9.0, 100.0])})
    out = _by_key(_agg(t, ["g"], ["skewness(x) as sk", "kurtosis(x) as ku",
                                  "first(x) as fi", "last(x) as la"]), "g")
    df = t.to_pandas()
    for g in (1, 2):
        xs = df[df.g == g].x
        n = len(xs)
        assert abs(out[g]["sk"] - xs.skew() * ((n - 2) / np.sqrt(
            n * (n - 1)))) < 1e-9
        assert abs(out[g]["ku"] - xs.kurtosis()) < 1e-9
    assert out[1]["fi"] in list(df[df.g == 1].x)
    assert out[2]["la"] in list(df[df.g == 2].x)


def test_first_last_positional_int32():
    t = pa.table({"g": pa.array([1, 1, 1, 2, 2], pa.int64()),
                  "x": pa.array([7, 3, 9, 4, None], pa.int32())})
    out = _by_key(_agg(t, ["g"], ["first(x) as fi", "last(x) as la"]), "g")
    assert (out[1]["fi"], out[1]["la"]) == (7, 9)
    assert (out[2]["fi"], out[2]["la"]) == (4, 4)


def test_arrays_zip():
    t = pa.table({"a": pa.array([[1, 2, 3], [9]], pa.list_(pa.int64())),
                  "b": pa.array([[10, 20], [7, 8]], pa.list_(pa.int64()))})
    z = _proj(t, ["arrays_zip(a, b) as z"]).column("z").to_pylist()
    assert z[0] == [{"0": 1, "1": 10}, {"0": 2, "1": 20},
                    {"0": 3, "1": None}]
    assert z[1] == [{"0": 9, "1": 7}, {"0": None, "1": 8}]


def test_json_object_keys():
    t = pa.table({"j": pa.array(['{"a": 1, "b": {"c": 2}}', "[1,2]",
                                 "nonsense"])})
    assert _proj(t, ["json_object_keys(j) as k"]).column("k").to_pylist() \
        == [["a", "b"], None, None]


def test_to_utc_timestamp_dst_edge():
    """03:00 local on the US spring-forward day is PDT (UTC-7)."""
    base = np.datetime64("2024-03-10T03:00:00", "us").astype("int64")
    t = pa.table({"ts": pa.array([int(base)], pa.int64())
                  .cast(pa.timestamp("us"))})
    assert _proj(t, ["to_utc_timestamp(ts, 'America/Los_Angeles') as u"]
                 ).column("u").to_pylist() == [dt.datetime(2024, 3, 10, 10)]


def test_conv_negative_unsigned_wrap():
    t = pa.table({"s": pa.array(["-7"])})
    assert _proj(t, ["conv(s, 10, 16) as c"]).column("c").to_pylist() == [
        "FFFFFFFFFFFFFFF9"]


def test_conv_past_64_bits_matches_reference():
    """A positive value past 2^64 is re-encoded whole, as in the
    reference; only negative values wrap to 64 bits."""
    t = pa.table({"s": pa.array(["F" * 18, "-" + "F" * 18, "zz"])})
    assert _proj(t, ["conv(s, 16, 10) as c"]).column("c").to_pylist()[0] \
        == str(int("F" * 18, 16))


def test_raise_error_message_surfaces():
    t = pa.table({"x": pa.array([1], pa.int64())})
    with pytest.raises(VeloxUserError, match="boom-specific"):
        Task(PlanBuilder().values([t]).project(
            ["raise_error('boom-specific') as e"]).plan(), CPU).run()
    with pytest.raises(JVeloxUserError, match="boom-specific"):
        JTask(JPlanBuilder().values([t]).project(
            ["raise_error('boom-specific') as e"]).plan()).run()


def test_moments_constant_group_null():
    t = pa.table({"g": pa.array([1] * 4, pa.int64()),
                  "x": pa.array([5.0] * 4)})
    out = _agg(t, ["g"], ["skewness(x) as sk", "kurtosis(x) as ku"])
    assert out.column("sk").to_pylist() == [None]
    assert out.column("ku").to_pylist() == [None]


def test_array_map_ctors_get_timestamp():
    t = pa.table({"a": pa.array([1, 2], pa.int64()),
                  "b": pa.array([10, None], pa.int64()),
                  "s": pa.array(["2024-02-29 12:30:05", "junk"])})
    out = _proj(t, ["array(a, b, 7) as arr", "map(a, b) as m",
                    "get_timestamp(s, 'yyyy-MM-dd HH:mm:ss') as ts"])
    assert out.column("arr").to_pylist() == [[1, 10, 7], [2, None, 7]]
    assert _maps_of(out.column("m"))[0] == {1: 10}
    assert out.column("ts").to_pylist() == [
        dt.datetime(2024, 2, 29, 12, 30, 5), None]


@pytest.mark.parametrize("expr,want", [
    ("map(a, b, a, 5)", [None, None]), ("map(b, a)", [1, None]),
    ("map_from_arrays(array(a, b), array(a))", [None, None])])
def test_constructor_errors_raise_and_try_nulls_them(expr, want):
    """Duplicate and NULL map keys and unequal lengths flag the error
    channel in both: the query fails, and under TRY the rows are NULL."""
    t = pa.table({"a": pa.array([1, 2], pa.int64()),
                  "b": pa.array([10, None], pa.int64())})
    with pytest.raises(VeloxUserError):
        Task(PlanBuilder().values([t]).project(
            [f"cardinality({expr}) as n"]).plan(), CPU).run()
    with pytest.raises(JVeloxUserError):
        JTask(JPlanBuilder().values([t]).project(
            [f"cardinality({expr}) as n"]).plan()).run()
    got = _proj(t, [f"cardinality(try({expr})) as n"])
    assert got.column("n").to_pylist() == want


# ---------------------------------------------------------------------------
# might_contain over bloom_filter_agg: a runtime filter
# ---------------------------------------------------------------------------

def test_might_contain_is_a_runtime_filter_without_false_negatives():
    """bloom_filter_agg over a filtered build, one row through
    EnforceSingleRow and a nested-loop join, then might_contain: no
    member is dropped, and both engines keep the same rows."""
    rng = np.random.default_rng(5)
    build = pa.table({"bk": pa.array(rng.choice(5000, 300, replace=False),
                                     pa.int64())})
    probe = pa.table({"k": pa.array(rng.integers(0, 5000, 2000), pa.int64()),
                      "v": pa.array(rng.integers(0, 100, 2000), pa.int64())})

    def plan(B):
        b = B().values([probe])
        bloom = b.new_builder().values([build]).single_aggregation(
            [], ["bloom_filter_agg(bk, 300) as bf"]).enforce_single_row()
        return (b.nested_loop_join(bloom, output=["k", "v", "bf"])
                .filter("might_contain(bf, k)").project(["k", "v"]).plan())
    G.flat_gather.launches = 0
    got = _both(plan)
    members = set(build.column("bk").to_pylist())
    kept = got.column("k").to_pylist()
    assert {k for k in probe.column("k").to_pylist() if k in members} \
        <= set(kept)
    assert len(kept) < probe.num_rows


def test_might_contain_nulls():
    bloom = pa.array([[-1] * 4, [], None], pa.list_(pa.int32()))
    t = pa.table({"bf": bloom, "x": pa.array([3, None, 3], pa.int64())})
    assert _proj(t, ["might_contain(bf, x) as m"]).column("m").to_pylist() \
        == [True, None, None]


# ---------------------------------------------------------------------------
# tests/test_url_ip.py
# ---------------------------------------------------------------------------

REF_URLS = URLS[:6]


def test_url_extracts():
    o = _proj(pa.table({"u": REF_URLS}), [
        "url_extract_protocol(u) as proto", "url_extract_host(u) as host",
        "url_extract_port(u) as port", "url_extract_path(u) as path",
        "url_extract_query(u) as qry", "url_extract_fragment(u) as frag"]
    ).to_pydict()
    assert o["proto"][:3] == ["https", "http", "ftp"]
    assert o["host"][:3] == ["example.com", "velox.io", "files.example.org"]
    assert o["port"][:3] == [8443, None, 21]
    assert o["path"][0] == "/a/b%20c"
    assert o["qry"][0] == "x=1&y=two"
    assert o["frag"][0] == "frag"
    assert o["proto"][5] is None and o["host"][5] is None


def test_url_parameter_and_codec():
    o = _proj(pa.table({"u": REF_URLS}), [
        "url_extract_parameter(u, 'y') as y",
        "url_extract_parameter(u, 'x') as x"]).to_pydict()
    assert o["y"][0] == "two" and o["y"][1] is None
    assert o["x"][0] == "1" and o["x"][4] == "/enc"
    plain = ["a b&c", "100%", "plain"]
    enc = _proj(pa.table({"s": plain}), ["url_encode(s) as e"])
    assert enc.column("e").to_pylist() == ["a+b%26c", "100%25", "plain"]
    dec = _proj(pa.table({"s": enc.column("e")}), ["url_decode(s) as d"])
    assert dec.column("d").to_pylist() == plain


def test_ip_functions():
    o = _proj(pa.table({"ip": IPS[:5]}), ["ip_prefix(ip, 24) as p24",
                                          "is_private_ip(ip) as priv"]
              ).to_pydict()
    assert o["p24"][:2] == ["10.0.0.0/24", "192.168.1.0/24"]
    assert o["p24"][4] is None
    assert o["priv"][:3] == [True, True, False]
    o = _proj(pa.table({"n": IPS[5:9]}), [
        "ip_subnet_min(n) as lo", "ip_subnet_max(n) as hi",
        "is_subnet_of('10.0.0.0/8', n) as in8"]).to_pydict()
    assert o["lo"][:3] == ["10.0.0.0", "10.1.0.0", "192.168.0.0"]
    assert o["hi"][0] == "10.255.255.255"
    assert o["lo"][3] is None
    assert o["in8"][:3] == [True, True, False]


def test_is_subnet_of_ip_column():
    t = pa.table({"ip": ["10.2.3.4", "11.0.0.1", "10.255.0.1"]})
    assert _proj(t, ["is_subnet_of('10.0.0.0/8', ip) as s"]).column(
        "s").to_pylist() == [True, False, True]


def test_json_family_completion():
    o = _proj(pa.table({"j": JDOCS[:5]}), [
        "json_array_get(j, 1) as g1", "json_array_get(j, -1) as gm1",
        "json_array_contains(j, 20) as c20", "json_size(j, '$') as sz",
        "json_size(j, '$.a') as sza", "json_format(j) as fmt"]).to_pydict()
    assert o["g1"][0] is None and o["g1"][1] == "20"
    assert o["gm1"][1] == "null"
    assert o["g1"][3] is None and o["g1"][4] is None
    assert o["c20"][0] is None and o["c20"][1] is True
    assert o["c20"][2] is None and o["c20"][3] is None
    assert o["sz"][:3] == [2, 5, 0] and o["sz"][3] is None
    assert o["sza"][0] == 1
    assert o["fmt"][0] == '{"a":{"b":[1,2,3]},"s":"x"}'
    assert o["fmt"][3] is None


def test_json_parse():
    t = pa.table({"j": ['{"a": 1,  "b":[1, 2]}', "[1,2]"]})
    assert _proj(t, ["json_parse(j) as p"]).column("p").to_pylist() == [
        '{"a":1,"b":[1,2]}', "[1,2]"]
    bad = pa.table({"j": ["{oops"]})
    with pytest.raises(VeloxError):
        Task(PlanBuilder().values([bad]).project(["json_parse(j) as p"])
             .plan(), CPU).run()
    with pytest.raises(JVeloxError):
        JTask(JPlanBuilder().values([bad]).project(["json_parse(j) as p"])
              .plan()).run()


# ---------------------------------------------------------------------------
# tests/test_functions.py: test_regex_json_url_functions
# ---------------------------------------------------------------------------

def test_regex_json_url_functions():
    t = pa.table({
        "s": ["foo123bar", "nope", "a99b", "foo123bar"],
        "j": ['{"a": {"b": [1, 2, 3]}}', '{"a": 1}', "not json", "[10, 20]"],
        "u": ["https://example.com:8080/p/q?x=1&y=2#frag", "http://h/pp",
              "nota url", "https://example.com/"]})
    o = _proj(t, [
        "regexp_like(s, '[0-9]+') as rl",
        "regexp_extract(s, '([0-9]+)', 1) as rx",
        "regexp_replace(s, '[0-9]+', '#') as rr",
        "json_extract_scalar(j, '$.a.b[1]') as je",
        "json_array_length(j) as jl", "url_extract_host(u) as uh",
        "url_extract_port(u) as up", "url_extract_parameter(u, 'y') as uy",
        "strpos(s, '123') as sp", "starts_with(s, 'foo') as sw",
        "split_part(s, '1', 1) as spp"]).to_pydict()
    assert o["rl"] == [True, False, True, True]
    assert o["rx"] == ["123", None, "99", "123"]
    assert o["rr"] == ["foo#bar", "nope", "a#b", "foo#bar"]
    assert o["je"] == ["2", None, None, None]
    assert o["jl"] == [None, None, None, 2]
    assert o["uh"] == ["example.com", "h", None, "example.com"]
    assert o["up"] == [8080, None, None, None]
    assert o["uy"] == ["2", None, None, None]
    assert o["sp"] == [4, 0, 0, 4]
    assert o["sw"] == [True, False, False, True]
    assert o["spp"] == ["foo", "nope", "a99b", "foo"]

"""ARRAY, MAP and ROW columns of the torch port against the JAX reference:
the counterparts of tests/test_complex.py and of the ARRAY/MAP-result
cases of tests/test_collect_aggs.py, plus NULLs in every position, arrays
through joins, sorts and several batches, the reference's faults and its
kept limits.

Each plan is built by each package's own PlanBuilder over the same
numpy-seeded pyarrow tables and run by each package's Task; the two Arrow
results must hold the same rows. Where the reference is wrong (ROADMAP C)
the port is held to pyarrow or a Python oracle of Presto's rules instead,
and the test shows the reference's answer differs.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.common.errors import VeloxUserError as JVeloxUserError
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.vector import device as JD
from velox_tpu_torch.common.errors import VeloxUserError
from velox_tpu_torch.exec.hashtable import bloom_hashes
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.expression.eval import value_from_column
from velox_tpu_torch.testing.batches import batch_from_reference
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.vector import device as D

torch.set_num_threads(1)

CPU = QueryCtx("cpu")
I64 = pa.int64()
LIST = pa.list_(I64)
SMAP = pa.map_(pa.string(), I64)


def _rows(table: pa.Table):
    cols = table.column_names
    return sorted(zip(*(table.column(c).to_pylist() for c in cols)),
                  key=repr)


def _both(build, ordered: bool = False) -> pa.Table:
    """Run ``build(PlanBuilder class)``'s plan through both engines and
    return the port's table, after checking it equals the reference's
    (row for row when ``ordered``)."""
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.schema == want.schema
    if ordered:
        assert got.to_pylist() == want.to_pylist()
    else:
        assert _rows(got) == _rows(want)
    return got


def _port(build) -> pa.Table:
    return Task(build(PlanBuilder), CPU).run()


def _ref(build) -> pa.Table:
    return JTask(build(JPlanBuilder)).run()


def _project(t, exprs):
    return lambda B: B().values([t]).project(exprs).plan()


def _agg(tables, keys, aggs):
    return lambda B: B().values(tables).single_aggregation(keys,
                                                           aggs).plan()


def list_table(n=200, seed=6, with_nulls=True):
    """The reference's make_list_table: NULL arrays, empty arrays."""
    rng = np.random.RandomState(seed)
    lists = []
    for _ in range(n):
        if with_nulls and rng.rand() < 0.1:
            lists.append(None)
        else:
            lists.append(rng.randint(0, 100, rng.randint(0, 6)).tolist())
    return pa.table({"id": pa.array(range(n), I64),
                     "arr": pa.array(lists, LIST)})


def null_table(n=300, seed=3):
    """Arrays with NULLs in every position (a NULL array, NULL elements,
    empty arrays), a second array, a needle column with NULLs and a
    string array."""
    rng = np.random.default_rng(seed)

    def arr():
        if rng.random() < 0.1:
            return None
        return [None if rng.random() < 0.15 else int(x)
                for x in rng.integers(0, 12, rng.integers(0, 7))]
    words = ["ant", "bee", "cat", "dog", "eel"]
    return pa.table({
        "a": pa.array([arr() for _ in range(n)], LIST),
        "b": pa.array([arr() for _ in range(n)], LIST),
        "x": pa.array([None if rng.random() < 0.1 else int(v)
                       for v in rng.integers(0, 12, n)], I64),
        "s": pa.array([None if rng.random() < 0.1 else
                       [words[i] for i in rng.integers(0, 5, 3)]
                       for _ in range(n)], pa.list_(pa.string())),
    })


def hof_table():
    return pa.table({
        "arr": pa.array([[1, 2, 3], [], None, [5, 10, 5], [None, 7]], LIST),
        "y": pa.array([10, 20, 30, 40, 50], I64),
    })


def map_table():
    return pa.table({
        "m": pa.array([{"a": 1, "b": 2, "c": 3}, {}, {"d": 10, "e": None}],
                      SMAP),
        "k": pa.array([2, 5, 1], I64),
    })


def row_table():
    return pa.table({
        "r": pa.array([{"a": 1, "b": "x"}, None, {"a": 3, "b": "y"},
                       {"a": None, "b": "z"}],
                      pa.struct([("a", I64), ("b", pa.string())])),
        "i": pa.array([10, 20, 30, 40], I64),
    })


# ---------------------------------------------------------------------------
# The Arrow bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", [
    lambda: list_table(),
    lambda: pa.table({"m": pa.array([{"a": 1, "b": 2}, {}, {"c": 3}],
                                    SMAP)}),
    row_table,
    lambda: pa.table({"n": pa.array([[[1], [2, 3]], [[], None], None],
                                    pa.list_(LIST))}),
    lambda: list_table().slice(7, 50),
], ids=["array", "map", "row", "nested", "sliced"])
def test_round_trip(table):
    t = table()
    back = D.to_arrow(D.from_arrow(t, device="cpu"))
    assert back.to_pylist() == t.to_pylist()
    assert back.to_pylist() == JD.to_arrow(JD.from_arrow(t)).to_pylist()


def test_arrow_stream_takes_complex_columns():
    """ArrowStream batches with ARRAY, MAP and ROW columns, through a
    projection, equal the reference's."""
    import velox_tpu.core.plan as JP
    from velox_tpu import types as JT
    from velox_tpu_torch import types as T
    from velox_tpu_torch.core import plan as P
    t = pa.table({"a": null_table().column("a"),
                  "m": pa.array([{"a": 1}, None, {}] * 100, SMAP),
                  "r": pa.array([{"q": 1}, None, {"q": None}] * 100,
                                pa.struct([("q", I64)]))})

    def reader():
        return pa.RecordBatchReader.from_batches(
            t.schema, t.to_batches(max_chunksize=70))
    names = t.column_names
    want = JTask(JP.ArrowStreamNode("as0", reader=reader(), row_type=JT.row(
        names, [JT.from_arrow(f.type) for f in t.schema]))).run()
    got = Task(P.ArrowStreamNode("as0", reader=reader(), row_type=T.row(
        names, [T.from_arrow(f.type) for f in t.schema])), CPU).run()
    assert got.to_pylist() == want.to_pylist() == t.to_pylist()


def test_batch_from_reference_carries_complex_columns():
    t = pa.table({"a": null_table().column("a"),
                  "m": pa.array([{"a": 1}, None, {}] * 100, SMAP),
                  "r": pa.array([{"q": 1}, None, {"q": None}] * 100,
                                pa.struct([("q", I64)]))})
    b = batch_from_reference(JD.from_arrow(t))
    assert D.to_arrow(b).to_pylist() == t.to_pylist()


# ---------------------------------------------------------------------------
# The functions
# ---------------------------------------------------------------------------

_CASES = {
    "cardinality_element_at_contains": (
        lambda: list_table(with_nulls=False),
        ["id", "cardinality(arr) as n", "element_at(arr, 1) as first",
         "element_at(arr, -1) as last", "contains(arr, 7) as has7"]),
    "transform_with_capture": (
        hof_table, ["transform(arr, x -> x * 2 + y) as r"]),
    "filter": (hof_table, ["filter(arr, x -> x > 2) as r"]),
    "sort_distinct_extremes": (
        hof_table, ["array_sort(arr) as s", "array_distinct(arr) as d",
                    "array_max(arr) as mx", "array_min(arr) as mn"]),
    "map_keys_values": (
        lambda: pa.table({"m": pa.array([{"a": 1, "b": 2}, {}, {"c": 3}],
                                        SMAP)}),
        ["map_keys(m) as k", "map_values(m) as v", "cardinality(m) as n"]),
    "map_filter": (map_table, ["map_filter(m, (k2, v) -> v >= 2) as f"]),
    "map_filter_capture": (map_table,
                           ["map_filter(m, (x, v) -> v >= k) as f"]),
    "transform_values_keys": (
        map_table, ["transform_values(m, (x, v) -> v * 10) as tv",
                    "transform_keys(m, (x, v) -> upper(x)) as tk"]),
    "zip_with": (
        lambda: pa.table({
            "a": pa.array([[1, 2, 3], [4], None, []], LIST),
            "b": pa.array([[10, 20], [40, 50], [1], [2]], LIST)}),
        ["zip_with(a, b, (x, y) -> x + y) as z",
         "zip_with(a, b, (x, y) -> coalesce(x, 0) + coalesce(y, 0)) as zc"]),
    "reduce": (
        lambda: pa.table({"arr": pa.array(
            [[1, 2, 3, 4], [], [10], None, [5, 5]], LIST)}),
        ["reduce(arr, 0, (s, x) -> s + x, s -> s) as total",
         "reduce(arr, 1, (s, x) -> s * x, s -> s * 2) as prod2"]),
    "reduce_capture": (
        lambda: pa.table({"arr": pa.array([[1, 2], [3]], LIST),
                          "base": pa.array([100, 200], I64)}),
        ["reduce(arr, base, (s, x) -> s + x, s -> s) as r"]),
    "position_remove_slice": (
        lambda: pa.table({
            "a": pa.array([[1, 2, 3, 2], [], [5, None, 5], None], LIST),
            "x": pa.array([2, 1, 5, 1], I64)}),
        ["array_position(a, x) as p", "array_remove(a, x) as r",
         "slice(a, 2, 2) as s"]),
    "concat_flatten": (
        lambda: pa.table({
            "a": pa.array([[1, 2], [], [7]], LIST),
            "b": pa.array([[3], [4, 5], []], LIST),
            "n": pa.array([[[1], [2, 3]], [[], [4]], None],
                          pa.list_(LIST))}),
        ["concat(a, b) as c", "flatten(n) as f"]),
    "map_entries_arrays_overlap": (
        lambda: pa.table({
            "m": pa.array([{"a": 1, "b": 2}, {}], SMAP),
            "x": pa.array([[1, 2], [3, None]], LIST),
            "y": pa.array([[2, 9], [8, 7]], LIST)}),
        ["map_entries(m) as e", "arrays_overlap(x, y) as o"]),
    "set_ops": (
        lambda: pa.table({
            "a": pa.array([[1, 2, 2, None], [5], []], LIST),
            "b": pa.array([[2, 3, None], [6], [1]], LIST)}),
        ["array_intersect(a, b) as i", "array_union(a, b) as u",
         "array_except(a, b) as e"]),
    "map_concat": (
        lambda: pa.table({
            "m1": pa.array([{"a": 1, "b": 2}, {}], SMAP),
            "m2": pa.array([{"b": 9, "c": 3}, {"z": 1}], SMAP)}),
        ["map_concat(m1, m2) as m"]),
    "set_ops_strings_other_dictionaries": (
        lambda: pa.table({
            "a": pa.array([["x", "y"], ["p"]], pa.list_(pa.string())),
            "b": pa.array([["y", "z"], ["q"]], pa.list_(pa.string()))}),
        ["array_intersect(a, b) as i", "concat(a, b) as c",
         "arrays_overlap(a, b) as o"]),
    "map_zip_with": (
        lambda: pa.table({
            "m1": pa.array([{"a": 1, "b": 2}, {"x": 5}], SMAP),
            "m2": pa.array([{"b": 10, "c": 20}, {}], SMAP)}),
        ["map_zip_with(m1, m2, (k, v1, v2) -> "
         "coalesce(v1, 0) + coalesce(v2, 0)) as z"]),
    "row_fields": (row_table, ["r.a + i as s", "r.b as b", "r as whole"]),
    "nested_row": (
        lambda: pa.table({"r": pa.array(
            [{"n": {"x": 5}}, {"n": {"x": 7}}],
            pa.struct([("n", pa.struct([("x", I64)]))]))}),
        ["r.n.x as v"]),
    # NULL arrays, NULL elements, empty arrays and NULL needles throughout
    "nulls_everywhere": (
        null_table,
        ["cardinality(a) as n", "element_at(a, 2) as e2",
         "element_at(a, x) as ex", "transform(a, v -> v + x) as t",
         "filter(a, v -> v > x) as f", "array_sort(a) as srt",
         "array_distinct(a) as d", "array_max(a) as mx",
         "array_min(a) as mn", "reduce(a, 0, (s, v) -> s + v, s -> s) as r",
         "slice(a, 2, 3) as sl", "concat(a, b) as c",
         "array_intersect(a, b) as i", "array_union(a, b) as u",
         "array_except(a, b) as ex2", "arrays_overlap(a, b) as o",
         "zip_with(a, b, (p, q) -> p * q) as z",
         "array_position(a, x) as pos", "array_remove(a, x) as rm",
         "array_sort(s) as ss", "array_distinct(s) as sd",
         "array_max(s) as smx"]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_function_matches_reference(case):
    table, exprs = _CASES[case]
    _both(_project(table(), exprs), ordered=True)


def test_lambda_errors_raise_and_try_nulls_them():
    t = pa.table({"arr": pa.array([[4, 0], [2]], LIST)})
    plan = _project(t, ["transform(arr, x -> 10 / x) as r"])
    with pytest.raises(JVeloxUserError):
        _ref(plan)
    with pytest.raises(VeloxUserError):
        _port(plan)
    _both(_project(t, ["try(transform(arr, x -> 10 / x)) as r"]),
          ordered=True)


# ---------------------------------------------------------------------------
# Presto's NULL rules where the reference departs from them
# ---------------------------------------------------------------------------

def _presto_contains(arr, x):
    if arr is None or x is None:
        return None
    if x in [v for v in arr if v is not None]:
        return True
    return None if None in arr else False


def test_contains_follows_presto_nulls_where_the_reference_ignores_them():
    t = pa.table({"a": pa.array([[3, None, 1], [7, 7, None, 1], [9, None],
                                 [], None, [1, 2]], LIST),
                  "x": pa.array([9, 9, 9, None, 9, None], I64)})
    plan = _project(t, ["contains(a, 9) as c9", "contains(a, x) as cx"])
    got = _port(plan)
    a, x = t.column("a").to_pylist(), t.column("x").to_pylist()
    assert got.column("c9").to_pylist() == [
        _presto_contains(v, 9) for v in a] == [None, None, True, False,
                                               None, False]
    assert got.column("cx").to_pylist() == [
        _presto_contains(v, n) for v, n in zip(a, x)]
    ref = _ref(plan)
    assert ref.column("c9").to_pylist()[:2] == [False, False]
    assert ref.column("cx").to_pylist()[3] is False  # a NULL needle
    # and over the NULL-heavy table, against the same oracle
    nt = null_table()
    got = _port(_project(nt, ["contains(a, x) as c"]))
    assert got.column("c").to_pylist() == [
        _presto_contains(v, n) for v, n in
        zip(nt.column("a").to_pylist(), nt.column("x").to_pylist())]


def _presto_match(mode, arr, pred):
    """Presto's any/all/none_match over a Python list."""
    if arr is None:
        return None
    vals = [None if v is None else pred(v) for v in arr]
    if mode == "any":
        return True if True in vals else (None if None in vals else False)
    if mode == "all":
        return False if False in vals else (None if None in vals else True)
    return False if True in vals else (None if None in vals else True)


@pytest.mark.parametrize("mode,expr,pred,wrong", [
    ("any", "x > 4", lambda v: v > 4, False),
    ("all", "x > 0", lambda v: v > 0, False),
    ("none", "x > 6", lambda v: v > 6, True),
])
def test_matches_are_three_valued_where_the_reference_is_two_valued(
        mode, expr, pred, wrong):
    nt = null_table()
    t = pa.table({"a": pa.concat_arrays([
        pa.array([[3, None, 1]], LIST),
        nt.column("a").combine_chunks()])})
    plan = _project(t, [f"{mode}_match(a, x -> {expr}) as m"])
    got = _port(plan).column("m").to_pylist()
    assert got == [_presto_match(mode, v, pred)
                   for v in t.column("a").to_pylist()]
    assert got[0] is None
    assert _ref(plan).column("m").to_pylist()[0] is wrong


def test_match_lambdas_of_the_reference_test():
    """tests/test_complex.py's test_match_lambdas: the port agrees with
    the reference but on the row [NULL, 7], where Presto's answer is
    NULL."""
    t = hof_table()
    plan = _project(t, ["any_match(arr, x -> x > 9) as a",
                        "all_match(arr, x -> x > 0) as b",
                        "none_match(arr, x -> x = 2) as c"])
    got, ref = _port(plan), _ref(plan)
    assert got.column("a").to_pylist() == [False, False, None, True, None]
    assert got.column("b").to_pylist() == [True, True, None, True, None]
    assert got.column("c").to_pylist() == [False, True, None, True, None]
    assert ref.column("a").to_pylist()[4] is False
    assert ref.column("c").to_pylist()[4] is True


def _slot_map():
    """A MAP whose NULL row owns a non-empty slot: legal Arrow."""
    return pa.MapArray.from_arrays([0, 1, 2, 3], ["a", "b", "c"], [1, 2, 3],
                                   mask=pa.array([False, True, False]))


def test_map_with_a_non_empty_null_slot_is_ingested_aligned():
    m = _slot_map()
    want = m.to_pylist()
    assert want == [[("a", 1)], None, [("c", 3)]]
    t = pa.table({"g": pa.array([1, 1, 2], I64), "m": m})
    assert D.to_arrow(D.from_arrow(t, device="cpu")).column(
        "m").to_pylist() == want
    assert JD.to_arrow(JD.from_arrow(t)).column("m").to_pylist()[2] == [
        ("b", 2)]
    keys = _project(t, ["map_keys(m) as k"])
    assert _port(keys).column("k").to_pylist() == [["a"], None, ["c"]]
    assert _ref(keys).column("k").to_pylist()[2] == ["b"]
    unnest = lambda B: (B().values([t])  # noqa: E731
                        .unnest("m", element_name="k", value_name="v")
                        .plan())
    assert _rows(_port(unnest)) == [(1, "a", 1), (2, "c", 3)]
    assert (2, "b", 2) in _rows(_ref(unnest))
    union = _agg([t], [], ["map_union(m) as u"])
    assert sorted(_port(union).column("u").to_pylist()[0]) == [
        ("a", 1), ("c", 3)]
    assert ("b", 2) in _ref(union).column("u").to_pylist()[0]


# ---------------------------------------------------------------------------
# Unnest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["array_ordinality", "map", "aggregate",
                                  "filtered"])
def test_unnest_matches_reference(case):
    if case == "map":
        t = pa.table({"id": pa.array([0, 1, 2], I64),
                      "m": pa.array([{"a": 1, "b": 2}, None, {"c": 3}],
                                    SMAP)})
        _both(lambda B: B().values([t]).unnest(
            "m", element_name="k", value_name="v", ordinality="o").plan())
        return
    t = list_table()

    def build(B):
        b = B().values([t])
        if case == "filtered":
            b = b.filter("id % 3 <> 0")
        b = b.unnest("arr", element_name="e", ordinality="ord")
        if case == "aggregate":
            b = b.single_aggregation([], ["sum(e) as s", "count() as c",
                                          "sum(e * ord) as w"])
        return b.plan()
    got = _both(build)
    if case == "array_ordinality":
        want = [(i, e, k + 1) for i, a in zip(t.column("id").to_pylist(),
                                              t.column("arr").to_pylist())
                for k, e in enumerate(a or [])]
        assert _rows(got) == sorted(want, key=repr)


def test_unnest_of_arrays_gathered_by_a_join():
    """Arrays repeated by a join (explicit starts) unnest row by row."""
    build = pa.table({"k": pa.array([10, 20, 30], I64),
                      "a": pa.array([[1], [2, 2], [3, 3, 3]], LIST)})
    probe = pa.table({"x": pa.array([30, 10, 30, 20, 40, 30], I64)})

    def plan(B):
        b = B()
        right = b.new_builder().values([build])
        return (b.values([probe]).hash_join(["x"], ["k"], right,
                                            output=["x", "a"])
                .unnest("a", element_name="e", ordinality="o").plan())
    assert len(_rows(_both(plan))) == 3 * 3 + 1 + 2


def test_unnest_of_nested_or_beside_complex_columns_raises_in_both():
    t = pa.table({"n": pa.array([[[1]]], pa.list_(LIST)),
                  "a": pa.array([[1]], LIST)})
    for col in ("n", "a"):
        plan = lambda B, c=col: B().values([t]).unnest(c).plan()  # noqa
        with pytest.raises(NotImplementedError):
            _ref(plan)
        with pytest.raises(NotImplementedError):
            _port(plan)


# ---------------------------------------------------------------------------
# Arrays through operators
# ---------------------------------------------------------------------------

def test_array_through_hash_join():
    build = pa.table({"k": pa.array([10, 20, 30], I64),
                      "a": pa.array([[1], [2, 2], [3, 3, 3]], LIST)})
    probe = pa.table({"x": pa.array([30, 10, 30, 20, 40], I64)})

    def plan(B):
        b = B()
        right = b.new_builder().values([build])
        return (b.values([probe]).hash_join(["x"], ["k"], right,
                                            output=["x", "a"])
                .project(["x", "a", "cardinality(a) as n",
                          "element_at(a, 1) as e"]).plan())
    got = _both(plan)
    assert _rows(got)[0] == (10, [1], 1, 1)


def test_arrays_over_several_batches_then_order_by():
    t1 = pa.table({"a": pa.array([[1, 1], [2], None], LIST)})
    t2 = pa.table({"a": pa.array([[3, 3, 3], []], LIST)})
    got = _both(lambda B: B().values([t1, t2]).project(
        ["a", "cardinality(a) as n"]).order_by(["n"]).plan(), ordered=True)
    assert got.column("a").to_pylist() == [[], [2], [1, 1], [3, 3, 3], None]


@pytest.mark.parametrize("op", ["order_by", "top_n"])
def test_arrays_and_rows_through_a_sort(op):
    t = pa.table({"k": pa.array([3, 1, 2, 5, 4], I64),
                  "r": pa.array([{"a": 30}, {"a": 10}, None, {"a": 50},
                                 {"a": None}], pa.struct([("a", I64)])),
                  "m": pa.array([{"x": 3}, {}, None, {"y": 5, "z": 6},
                                 {"w": 4}], SMAP),
                  "arr": pa.array([[3], [1, 1], None, [], [4, None]],
                                  LIST)})

    def plan(B):
        b = B().values([t])
        b = b.order_by(["k"]) if op == "order_by" else b.top_n(["k"], 4)
        return b.project(["k", "r", "m", "arr", "r.a as ra",
                          "cardinality(arr) as n",
                          "element_at(arr, 1) as e",
                          "map_keys(m) as mk"]).plan()
    _both(plan, ordered=True)


def test_element_space_function_after_a_sort_raises_in_both():
    t = pa.table({"k": pa.array([2, 1], I64),
                  "a": pa.array([[1, 2], [3]], LIST)})
    plan = lambda B: (B().values([t]).order_by(["k"])  # noqa: E731
                      .project(["transform(a, x -> x + 1) as t"]).plan())
    with pytest.raises(NotImplementedError):
        _ref(plan)
    with pytest.raises(NotImplementedError, match="OrderBy"):
        _port(plan)


def test_nested_multimap_after_order_by_raises_in_both():
    t = pa.table({"g": pa.array([1, 1, 2], I64),
                  "k": pa.array([1, 2, 1], I64),
                  "v": pa.array([5, 6, 7], I64)})
    plan = lambda B: (B().values([t])  # noqa: E731
                      .single_aggregation(["g"], ["multimap_agg(k, v) as m"])
                      .order_by(["g"]).plan())
    with pytest.raises(NotImplementedError):
        _ref(plan)
    with pytest.raises(NotImplementedError, match="nested"):
        _port(plan)


@pytest.mark.parametrize("op", ["order_by", "group_by", "join"])
def test_a_complex_key_raises(op):
    """An ARRAY sort, grouping or join key raises NotImplementedError in
    the port. The reference groups by one with an IndexError, and orders
    by the element count: [3] before [0] (ROADMAP C)."""
    t = pa.table({"a": pa.array([[3], [1, 2], [0]], LIST),
                  "k": pa.array([1, 2, 3], I64)})

    def plan(B):
        b = B().values([t])
        if op == "order_by":
            return b.order_by(["a"]).plan()
        if op == "group_by":
            return b.single_aggregation(["a"], ["count(*) as n"]).plan()
        right = B().values([t]).project(["a as b", "k as j"])
        return b.hash_join(["a"], ["b"], right, output=["k", "j"]).plan()
    with pytest.raises(NotImplementedError, match="key"):
        _port(plan)
    if op == "order_by":
        assert _ref(plan).column("a").to_pylist() == [[3], [0], [1, 2]]
    elif op == "group_by":
        with pytest.raises(IndexError):
            _ref(plan)


@pytest.mark.parametrize("expr", ["array_position(a, 1)",
                                  "element_at(m, 'a')"])
def test_signatures_the_reference_rejects_raise_in_both(expr):
    t = pa.table({"a": pa.array([[1]], LIST),
                  "m": pa.array([{"a": 1}], SMAP)})
    with pytest.raises(KeyError, match="cannot resolve"):
        _ref(_project(t, [f"{expr} as r"]))
    with pytest.raises(NotImplementedError, match="not ported"):
        _port(_project(t, [f"{expr} as r"]))


# ---------------------------------------------------------------------------
# The aggregates with ARRAY or MAP results
# ---------------------------------------------------------------------------

def base_table():
    return pa.table({
        "g": pa.array([1, 2, 1, 1, 2, 3, 1], I64),
        "x": pa.array([5, 1, 5, None, 2, 9, 3], I64),
        "k": pa.array(["a", "b", "a2", "c", "d", "e", "f"], pa.string()),
    })


def _agg_table(n=400, seed=5):
    """Groups, values with NULLs, string keys with NULLs, NULL values."""
    rng = np.random.default_rng(seed)
    words = ["kiwi", "fig", "lime", "pear", "plum", "date"]
    return pa.table({
        "g": pa.array(rng.integers(0, 9, n), I64),
        "x": pa.array([None if rng.random() < 0.1 else int(v)
                       for v in rng.integers(0, 15, n)], I64),
        "k": pa.array([None if rng.random() < 0.1 else words[i]
                       for i in rng.integers(0, 6, n)], pa.string()),
        "v": pa.array([None if rng.random() < 0.1 else int(v)
                       for v in rng.integers(-50, 50, n)], I64),
    })


_AGG_CASES = {
    "array_agg": (base_table, ["g"], ["array_agg(x) as a"]),
    "set_agg": (base_table, ["g"], ["set_agg(x) as s"]),
    "histogram": (base_table, ["g"], ["histogram(x) as h"]),
    "map_agg": (base_table, ["g"], ["map_agg(k, x) as m"]),
    "map_agg_dedups_keys": (
        lambda: pa.table({"g": pa.array([1, 1, 1], I64),
                          "k": pa.array(["a", "a", "b"]),
                          "v": pa.array([10, 20, 30], I64)}),
        ["g"], ["map_agg(k, v) as m"]),
    "multimap_agg_grouped": (
        lambda: pa.table({
            "g": pa.array([1, 1, 1, 2, 2, 1], I64),
            "k": pa.array(["a", "b", "a", "a", None, "b"]),
            "v": pa.array([10, 20, 30, 40, 50, None], I64)}),
        ["g"], ["multimap_agg(k, v) as m"]),
    "multimap_agg_global": (
        lambda: pa.table({"k": pa.array([1, 2, 1, 2, 3], I64),
                          "v": pa.array([7, 8, 9, 10, 11], I64)}),
        [], ["multimap_agg(k, v) as m"]),
    "global": (base_table, [], ["array_agg(x) as a",
                                "approx_percentile(x, 0.5) as p50",
                                "count(x) as c"]),
    "global_filtered_to_nothing": (
        base_table, [], ["array_agg(x) filter (where x > 100) as a",
                         "histogram(x) filter (where x > 100) as h"]),
    "filter_masks": (base_table, ["g"],
                     ["set_agg(x) filter (where x < 5) as s",
                      "histogram(x) filter (where x >= 5) as h"]),
    "approx_most_frequent_strings": (
        lambda: pa.table({
            "g": pa.array([1] * 18 + [2] * 4, I64),
            "v": pa.array(["a"] * 9 + ["b"] * 5 + ["c"] * 3 + ["d"]
                          + ["z", "z", "z", "y"])}),
        ["g"], ["approx_most_frequent(2, v, 100) as f"]),
    "approx_most_frequent_bigint": (
        lambda: pa.table({"x": pa.array(np.random.RandomState(9).permutation(
            np.repeat(np.arange(20), np.arange(1, 21))), I64)}),
        [], ["approx_most_frequent(3, x, 100) as f"]),
    "nulls_every_kind": (
        _agg_table, ["g"],
        ["array_agg(x) as a", "set_agg(x) as s", "histogram(k) as h",
         "map_agg(k, v) as m", "multimap_agg(k, v) as mm",
         "set_agg(k) as sk", "approx_most_frequent(2, x, 10) as f"]),
    "bloom_bigint": (
        lambda: pa.table({"k": pa.array(range(0, 2000, 2), I64)}),
        [], ["bloom_filter_agg(k) as bf"]),
    "bloom_sized": (
        lambda: pa.table({"k": pa.array(range(300), I64)}),
        [], ["bloom_filter_agg(k, 100) as a",
             "bloom_filter_agg(k, 100, 4096) as b"]),
    "bloom_strings_with_nulls": (
        lambda: pa.table({"k": pa.array(["apple", None, "cherry", "mango"])}),
        [], ["bloom_filter_agg(k, 10) as bf"]),
}


@pytest.mark.parametrize("case", sorted(_AGG_CASES))
def test_collect_aggregate_matches_reference(case):
    table, keys, aggs = _AGG_CASES[case]
    _both(_agg([table()], keys, aggs))


def test_functions_over_grouped_collect_results():
    """Element-space functions over a grouped array_agg's and
    histogram's results, against Python. The reference's counts past the
    last group are negative (its run sums' adjacent differences), which
    unsorts the element starts its searchsorted reads: it gives NULL
    maxima and empty arrays (ROADMAP C)."""
    rng = np.random.default_rng(1)
    g, x = rng.integers(0, 50, 2000), rng.integers(0, 100, 2000)
    t = pa.table({"g": pa.array(g, I64), "x": pa.array(x, I64)})
    plan = lambda B: (B().values([t])  # noqa: E731
                      .single_aggregation(["g"], ["array_agg(x) as p",
                                                  "histogram(x) as h"])
                      .project(["g", "array_max(p) as mx",
                                "cardinality(array_distinct(p)) as d",
                                "any_match(p, v -> v < 3) as am",
                                "cardinality(map_filter(h, (k, c) -> "
                                "c > 1)) as dup"]).plan())
    got = sorted(_port(plan).to_pylist(), key=lambda r: r["g"])
    want = []
    for k in range(50):
        v = x[g == k]
        counts = np.bincount(v)
        want.append({"g": k, "mx": int(v.max()), "d": len(set(v.tolist())),
                     "am": bool((v < 3).any()),
                     "dup": int((counts > 1).sum())})
    assert got == want
    ref = sorted(_ref(plan).to_pylist(), key=lambda r: r["g"])
    assert ref[0]["mx"] is None and ref[0]["d"] == 0


def test_collect_aggregates_over_several_batches():
    t = _agg_table()
    _both(_agg([t.slice(0, 150), t.slice(150, 100), t.slice(250)], ["g"],
               ["array_agg(v) as a", "set_agg(x) as s", "sum(x) as t",
                "map_agg(x, v) as m", "histogram(k) as h"]))


def test_collect_aggregates_of_an_empty_input():
    """No row at all: a global aggregation gives one row of NULLs, a
    grouped one no row."""
    t = base_table().slice(0, 0)
    got = _both(_agg([t], [], ["array_agg(x) as a", "map_agg(k, x) as m",
                               "bloom_filter_agg(x) as b"]))
    assert got.to_pylist() == [{"a": None, "m": None, "b": None}]
    assert _both(_agg([t], ["g"], ["set_agg(x) as s"])).num_rows == 0


def test_map_union_matches_reference():
    t = pa.table({
        "g": pa.array([1, 1, 2, 2, 3], I64),
        "m": pa.array([{"a": 1, "b": 2}, {"b": 9, "c": 3}, {"x": 7}, None,
                       {}], SMAP)})
    got = _both(_agg([t], ["g"], ["map_union(m) as u"]))
    assert dict(sorted(_rows(got))[0][1]) == {"a": 1, "b": 2, "c": 3}


def test_bloom_over_strings_of_other_dictionaries_agree():
    """The sketch hashes values, not dictionary ids: every build value's
    probe bits are set when read from another dictionary."""
    build = pa.table({"k": pa.array(["apple", "cherry", "mango"])})
    sketch = _both(_agg([build], [], ["bloom_filter_agg(k) as bf"])
                   ).column("bf").to_pylist()[0]
    words = np.array(sketch, np.int64) & 0xFFFFFFFF
    m = 32 * len(words)
    probe = D.from_arrow(pa.table({"x": pa.array(["zzz", "mango", "apple",
                                                  "kiwi"])}), device="cpu")
    h1, h2 = bloom_hashes(value_from_column(probe.columns["x"]), 4)
    for row in (1, 2):  # mango, apple
        for i in range(3):
            bit = (int(h1[row]) + i * int(h2[row])) & (m - 1)
            assert (words[bit // 32] >> (bit % 32)) & 1


def test_collect_rejects_a_partial_step():
    plan = (PlanBuilder().values([base_table()])
            .partial_aggregation(["g"], ["array_agg(x) as a"])
            .final_aggregation().plan())
    with pytest.raises(NotImplementedError, match="single-step"):
        Task(plan, CPU).run()


def test_bloom_is_global_only_and_rejects_raw_strings():
    t = pa.table({"g": pa.array([1, 2], I64), "k": pa.array(["a", "b"])})
    with pytest.raises(NotImplementedError, match="global"):
        _port(_agg([t], ["g"], ["bloom_filter_agg(k) as b"]))
    raw = lambda B: (B().values([t], string_encoding="raw")  # noqa: E731
                     .single_aggregation([], ["bloom_filter_agg(k) as b"])
                     .plan())
    with pytest.raises(NotImplementedError):
        _ref(raw)
    with pytest.raises(NotImplementedError):
        _port(raw)

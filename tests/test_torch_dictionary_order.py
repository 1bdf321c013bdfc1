"""Dictionary strings sort by their values (exec/sort.py
``dictionary_keys``, vector/device.py ``Dictionary.ranks``).

A dictionary whose ids do not follow its values, one that also repeats
values, and a sorted one go through ORDER BY (ASC/DESC, NULLS FIRST and
LAST), TopN, a Window's ORDER BY, a LocalMerge and a spilled OrderBy. Each
plan runs twice over the same rows: once over the dictionary column and
once over the same strings as a raw byte-matrix column, which sorts by
its bytes (a Window, which takes no raw string, over the sorted local
dictionary that the Arrow ingest builds). Both sorts are stable, so the
row ids must come out in the same order. The route each key took is read
from the ``velox_tpu.sort.dictionary_*_keys`` counters.
"""

import pickle

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.common import process_trace as PT
from velox_tpu_torch.connectors.tpch import (NATIONS, VirtualDictionary,
                                             register_tpch)
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.functions import scalar
from velox_tpu_torch.exec import sort as S
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.vector import device as V

torch.set_num_threads(1)

CAP = 1024
ROWS = 700
# ids do not follow the values; REPEATED also holds "pear" at ids 0 and 2
DICTS = {
    "unsorted": ["pear", "apple", "fig", "banana", "cherry", "date", "kiwi"],
    "repeated": ["pear", "apple", "pear", "fig", "apple", "banana"],
    "sorted": ["apple", "banana", "cherry", "date", "fig"],
}
ORDERS = ["ASC NULLS LAST", "ASC NULLS FIRST", "DESC NULLS FIRST",
          "DESC NULLS LAST"]


def _counts():
    c = M.reporter().snapshot()["counters"]
    return (c.get(M.K_SORT_DICT_RANKED_KEYS, 0),
            c.get(M.K_SORT_DICT_ID_KEYS, 0))


def _strings(kind: str, seed: int, n: int = ROWS):
    """(ids, validity) of ``n`` seeded rows over the dictionary of
    ``kind``."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, len(DICTS[kind]), n).astype(np.int32)
    return ids, rng.random(n) > 0.15


def _batches(kind: str, seed: int, parts: int = 1, encoding="raw"):
    """The same rows twice, in ``parts`` batches each: a dictionary string
    column ``s`` over DICTS[kind], and the same strings ingested with
    ``encoding`` ("raw", or "dict": a sorted local dictionary); ``r``
    numbers the rows, ``g`` is a small group."""
    ids, valid = _strings(kind, seed)
    d = V.Dictionary(DICTS[kind])
    words = np.asarray(DICTS[kind], dtype=object)[ids]
    dict_parts, raw_parts = [], []
    for lo, hi in zip(np.linspace(0, ROWS, parts + 1, dtype=int)[:-1],
                      np.linspace(0, ROWS, parts + 1, dtype=int)[1:]):
        n = int(hi - lo)
        r = np.arange(lo, hi, dtype=np.int64)
        table = pa.table({
            "s": pa.array(words[lo:hi].tolist(), mask=~valid[lo:hi]),
            "r": r, "g": r % 3})
        raw = V.from_arrow(table, CAP, string_encoding=encoding,
                           device="cpu")
        raw_parts.append(raw)
        pad = np.zeros(CAP, dtype=np.int32)
        # a NULL row's id is 0, as the Arrow ingest leaves it
        pad[:n] = np.where(valid[lo:hi], ids[lo:hi], 0)
        vpad = np.zeros(CAP, dtype=bool)
        vpad[:n] = valid[lo:hi]
        cols = dict(raw.columns)
        cols["s"] = V.DeviceColumn(torch.from_numpy(pad),
                                   torch.from_numpy(vpad), T.VARCHAR, d)
        dict_parts.append(V.DeviceBatch(cols, raw.mask))
    return dict_parts, raw_parts


def _rows(plan_fn, kind, seed, parts=1, config=None, encoding="raw"):
    """The plan's output over the dictionary column and over the same
    strings ingested with ``encoding``, and the (ranked, id) key counts of
    the dictionary run."""
    dict_parts, raw_parts = _batches(kind, seed, parts, encoding)
    out = []
    for batches in (dict_parts, raw_parts):
        before = _counts()
        got = Task(plan_fn(PlanBuilder().values(batches)).plan(),
                   QueryCtx("cpu", config or {})).run()
        after = _counts()
        out.append(got)
        if batches is dict_parts:
            counts = (after[0] - before[0], after[1] - before[1])
    return out[0], out[1], counts


def _assert_same(dict_out, raw_out, counts, kind):
    assert dict_out.column("r").to_pylist() == raw_out.column("r").to_pylist()
    assert dict_out.column("s").to_pylist() == raw_out.column("s").to_pylist()
    ranked, by_id = counts
    if kind == "sorted":
        assert ranked == 0 and by_id >= 1
    else:
        assert ranked >= 1 and by_id == 0


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("kind", list(DICTS))
def test_order_by_sorts_by_value(kind, order):
    d, r, c = _rows(lambda b: b.order_by([f"s {order}", "g DESC"]), kind, 1)
    assert d.num_rows == ROWS
    _assert_same(d, r, c, kind)


@pytest.mark.parametrize("order", ["ASC NULLS LAST", "DESC NULLS FIRST"])
@pytest.mark.parametrize("kind", list(DICTS))
def test_top_n_keeps_the_smallest_values(kind, order):
    d, r, c = _rows(lambda b: b.top_n([f"s {order}", "r"], 37), kind, 2,
                    parts=3)
    assert d.num_rows == 37
    _assert_same(d, r, c, kind)


@pytest.mark.parametrize("kind", list(DICTS))
def test_window_order_by_ranks_by_value(kind):
    d, r, c = _rows(lambda b: b.window(
        ["g"], ["s DESC NULLS LAST"],
        ["row_number() as rn", "rank() as rk"]).order_by(["r"]), kind, 3,
        encoding="dict")
    for col in ("rn", "rk"):
        assert d.column(col).to_pylist() == r.column(col).to_pylist()
    assert d.column("s").to_pylist() == r.column("s").to_pylist()
    assert (c[0] >= 1) == (kind != "sorted")


@pytest.mark.parametrize("kind", list(DICTS))
def test_local_merge_of_sorted_runs(kind):
    d, r, c = _rows(lambda b: b.order_by(["s ASC NULLS FIRST"])
                    .local_merge(["s ASC NULLS FIRST"]), kind, 4, parts=4)
    _assert_same(d, r, c, kind)


@pytest.mark.parametrize("kind", list(DICTS))
def test_spilled_order_by_merges_by_value(kind, tmp_path):
    """Every input batch but the first goes to host RAM and then to
    spill files; the sort after the restore orders by value."""
    cfg = {QC.SORT_OFFLOAD_BYTES: 0, QC.OFFLOAD_HOST_BUDGET_BYTES: 1,
           QC.SPILL_DIR: str(tmp_path)}
    spills = M.reporter().snapshot()["counters"].get(M.K_SPILL_DISK_WRITES,
                                                     0)
    d, r, c = _rows(lambda b: b.order_by(["s DESC NULLS LAST", "r"]), kind,
                    5, parts=4, config=cfg)
    assert M.reporter().snapshot()["counters"][M.K_SPILL_DISK_WRITES] \
        > spills
    _assert_same(d, r, c, kind)


def test_group_by_and_join_keys_match_as_before():
    """Grouping over an unsorted dictionary keeps one group a value, and
    a join over it matches the same rows as over the raw strings."""
    d_parts, r_parts = _batches("unsorted", 6)
    for parts in (d_parts, r_parts):
        got = Task(PlanBuilder().values(parts)
                   .single_aggregation(["s"], ["count(r) as n"])
                   .order_by(["s"]).plan(), QueryCtx("cpu")).run()
        if parts is d_parts:
            want = got
    assert got.to_pylist() == want.to_pylist()
    build = PlanBuilder().values(d_parts).project(["s as bs", "r as br"])
    got = Task(PlanBuilder().values(d_parts)
               .hash_join(["s"], ["bs"], build, ["r", "br"])
               .order_by(["r", "br"]).plan(), QueryCtx("cpu")).run()
    ids, valid = _strings("unsorted", 6)
    want = [(i, j) for i in range(ROWS) if valid[i]
            for j in range(ROWS) if valid[j] and ids[j] == ids[i]]
    assert list(zip(got.column("r").to_pylist(),
                    got.column("br").to_pylist())) == want


def test_ranks_are_dense_and_equal_for_equal_values():
    d = V.Dictionary(DICTS["repeated"])
    assert not d.is_sorted
    # pear, apple, pear, fig, apple, banana
    np.testing.assert_array_equal(d.ranks(), [3, 0, 3, 2, 0, 1])
    assert d.ranks().dtype == np.int32
    assert d.device_ranks("cpu") is d.device_ranks(torch.device("cpu"))
    assert V.Dictionary(DICTS["sorted"]).ranks() is None
    # stated by its maker: never checked
    assert V.Dictionary(["b", "a"], is_sorted=True).is_sorted
    assert V.Dictionary([]).is_sorted and V.Dictionary(["x"]).is_sorted
    with pytest.raises(ValueError):
        V.Dictionary(DICTS["sorted"]).device_ranks("cpu")


def test_rank_table_is_built_inside_its_span():
    PT.start_recording()
    try:
        V.Dictionary(DICTS["unsorted"]).device_ranks("cpu")
        V.Dictionary(DICTS["sorted"]).is_sorted
    finally:
        spans = PT.stop_recording()
    names = [(s.name, s.layer) for s in spans]
    assert names == [("dictionary_rank", "sort")] * 2
    assert PT.LAYERS["dictionary_rank"] == "sort"


def test_pickle_keeps_the_order_and_drops_the_device_copy():
    d = V.Dictionary(DICTS["unsorted"])
    d.device_ranks("cpu")
    back = pickle.loads(pickle.dumps(d))
    assert list(back.values) == DICTS["unsorted"]
    np.testing.assert_array_equal(back.ranks(), d.ranks())
    assert back._device_ranks == {}


def test_sorted_virtual_dictionary_is_never_materialized():
    """The TPC-H connector's numbered names are sorted by construction:
    ORDER BY c_name takes the id route without formatting a value."""
    conn = register_tpch(0.01)
    c_name = conn.gen.dictionaries("customer")["c_name"]
    assert isinstance(c_name, VirtualDictionary) and c_name.is_sorted
    before = _counts()
    got = Task(PlanBuilder().table_scan("customer", ["c_name", "c_custkey"])
               .order_by(["c_name DESC"]).limit(5).plan(),
               QueryCtx("cpu")).run()
    after = _counts()
    assert got.column("c_custkey").to_pylist() == [1500, 1499, 1498, 1497,
                                                   1496]
    assert c_name._values is None
    assert after[0] == before[0] and after[1] > before[1]
    # a phone dictionary states no order: it is ranked over its byte
    # matrix, still without a Python string a value
    c_phone = conn.gen.dictionaries("customer")["c_phone"]
    assert c_phone._values is None and not c_phone.is_sorted
    assert c_phone._values is None
    vals = list(c_phone.values)
    ranks = c_phone.ranks()
    assert [vals[i] for i in np.argsort(ranks, kind="stable")] \
        == sorted(vals)
    back = pickle.loads(pickle.dumps(c_name))
    assert back.is_sorted and back._values is None


def test_nation_names_rank_by_value():
    conn = register_tpch(0.01)
    n_name = conn.gen.dictionaries("nation")["n_name"]
    assert not n_name.is_sorted
    assert [NATIONS[i] for i in np.argsort(n_name.ranks())] \
        == sorted(NATIONS)


@pytest.mark.parametrize("kind", list(DICTS))
def test_require_sorted_and_the_sort_key_agree(kind):
    """An ordered string comparison runs exactly where the sort key takes
    the id route: both read the dictionary's one order memo."""
    d = V.Dictionary(DICTS[kind])
    v = EvalValue(torch.tensor([0, 1, 2], dtype=torch.int32), None,
                  T.VARCHAR, d)
    before = _counts()
    S.value_words(v, 3)
    ranked = _counts()[0] > before[0]
    if ranked:
        with pytest.raises(ValueError, match="sorted dictionary"):
            scalar._require_sorted(d)
    else:
        scalar._require_sorted(d)
    assert ranked == (kind != "sorted")
    # the ordered compare itself, through the registry
    out = scalar.compare_value(None, v, v, "lt") if not ranked else None
    if out is not None:
        assert out.data.tolist() == [False, False, False]


def test_arrow_dictionary_that_repeats_a_value_sorts_by_value():
    """An Arrow dictionary array may repeat a value: its ingested local
    dictionary is sorted but not strictly, so it takes the rank route
    and the two ids of "b" sort as one value."""
    arr = pa.DictionaryArray.from_arrays(
        pa.array([0, 1, 2, 0, 2, 1], pa.int32()), pa.array(["b", "a", "b"]))
    table = pa.table({"s": arr, "r": pa.array(range(6), pa.int64())})
    before = _counts()
    got = Task(PlanBuilder().values([table]).order_by(["s", "r DESC"])
               .plan(), QueryCtx("cpu")).run()
    assert _counts()[0] > before[0]
    assert got.column("s").to_pylist() == ["a", "a", "b", "b", "b", "b"]
    assert got.column("r").to_pylist() == [5, 1, 4, 3, 2, 0]


def test_substr_map_is_built_once_a_dictionary(monkeypatch):
    """substr(c_phone, 1, 2), Q22's country code, over the TPC-H
    connector's phones: the remap of the values is built by one pass a
    dictionary and read by every batch and query after it; other
    arguments make a map of their own; answers are each value's substr."""
    conn = register_tpch(0.01)
    c_phone = conn.gen.dictionaries("customer")["c_phone"]
    passes = []
    build = scalar._remap_table
    monkeypatch.setattr(scalar, "_remap_table",
                        lambda vals: passes.append(len(vals)) or build(vals))

    def counts(start, length):
        plan = (PlanBuilder().table_scan("customer", ["c_phone"])
                .project([f"substr(c_phone, {start}, {length}) as p"])
                .single_aggregation(["p"], ["count() as n"])
                .order_by(["p"]).plan())
        got = Task(plan, QueryCtx("cpu")).run()
        return list(zip(got.column("p").to_pylist(),
                        got.column("n").to_pylist()))

    phones = c_phone.take(np.arange(1, 1501))
    for start, length in ((1, 2), (1, 2), (5, 3), (1, 2)):
        want = {}
        for s in phones:
            key = s[start - 1:start - 1 + length]
            want[key] = want.get(key, 0) + 1
        assert counts(start, length) == sorted(want.items())
    assert passes == [len(c_phone)] * 2
    assert list(c_phone._maps) == [("substr", 1, 2), ("substr", 5, 3)]


def test_dictionary_keeps_at_most_max_maps():
    d = V.Dictionary(DICTS["unsorted"])
    for k in range(V.MAX_MAPS + 1):
        assert d.mapped(k, lambda k=k: k * 10) == k * 10
    assert list(d._maps) == list(range(1, V.MAX_MAPS + 1))
    assert d.mapped(1, lambda: None) == 10
    assert pickle.loads(pickle.dumps(d))._maps == {}

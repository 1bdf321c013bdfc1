"""The port's growing hash table (velox_tpu_torch/exec/hashtable.py) and
the streaming operators on it, MarkDistinct and RowNumber.

insert and lookup are held against a Python dict; the operators against
the JAX reference where it returns, and against numpy where it does not:
the reference sizes a streaming operator's table once, from its first
batch, so a stream with more distinct keys than that table holds never
returns there. The port grows the table, and its insert and lookup raise
RuntimeError after more rounds than the table has slots, so a table that
fills up fails these tests instead of hanging them.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch import types as T
from velox_tpu_torch.connectors import tpch as tt
from velox_tpu_torch.connectors.cache import DataCache
from velox_tpu_torch.connectors.connector import register_connector
from velox_tpu_torch.exec import hashtable as H
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)

CPU = QueryCtx("cpu")


def _keys(rng, n, distinct, null_p=0.0):
    """Two key columns (BIGINT with NULLs, INTEGER) of ``n`` rows over
    about ``distinct`` key tuples."""
    a = rng.randint(0, distinct, n).astype(np.int64) * 7919 - 10 ** 6
    b = (a % 3).astype(np.int32)
    va = rng.rand(n) >= null_p
    return [EvalValue(torch.from_numpy(a), torch.from_numpy(va), T.BIGINT),
            EvalValue(torch.from_numpy(b), None, T.INTEGER)]


def _tuples(keys):
    a, va, b = (keys[0].data.numpy(), keys[0].validity.numpy(),
                keys[1].data.numpy())
    return [(int(x) if v else None, int(y)) for x, v, y in zip(a, va, b)]


def test_insert_and_lookup_match_a_dict():
    """Over several batches into one table: a key keeps one slot, is_new
    marks its first row, inactive rows get no slot; lookup finds exactly
    the inserted keys (NULL keys equal each other)."""
    rng = np.random.RandomState(1)
    n, batches = 512, 3
    first = _keys(rng, n, 150, null_p=0.1)
    table = H.empty_table(first, H.table_size_for(3 * n))
    slot_of = {}
    for i in range(batches):
        keys = first if i == 0 else _keys(rng, n, 150, null_p=0.1)
        active = torch.from_numpy(rng.rand(n) < 0.9)
        table, slots, is_new = H.insert(table, keys, active, n)
        for t, act, s, new in zip(_tuples(keys), active.tolist(),
                                  slots.tolist(), is_new.tolist()):
            if not act:
                assert s == -1 and not new
                continue
            assert new == (t not in slot_of)
            assert slot_of.setdefault(t, s) == s
    assert int(table.occupied().sum()) == len(slot_of)
    probe = _keys(rng, n, 300, null_p=0.1)
    active = torch.ones(n, dtype=torch.bool)
    slots, found = H.lookup(table, probe, active, n)
    for t, s, f in zip(_tuples(probe), slots.tolist(), found.tolist()):
        assert f == (t in slot_of)
        assert s == (slot_of[t] if f else -1)


def test_insert_counts_rounds_and_the_smallest_row_wins():
    """Equal keys contending for one empty slot: the smallest row id
    creates it, whatever the order of the rows."""
    keys = [EvalValue(torch.tensor([5, 9, 5, 5, 9], dtype=torch.int64),
                      None, T.BIGINT)]
    table = H.empty_table(keys, 16)
    before = H.insert.rounds
    _, slots, is_new = H.insert(table, keys, torch.ones(5, dtype=torch.bool),
                                5)
    assert is_new.tolist() == [True, True, False, False, False]
    assert slots[0] == slots[2] == slots[3] and slots[1] == slots[4]
    assert H.insert.rounds > before


def test_a_full_table_raises_instead_of_looping():
    """20 distinct keys into 16 slots: the reference's loop never ends;
    here insert raises once a row has probed every slot."""
    keys = [EvalValue(torch.arange(20, dtype=torch.int64), None, T.BIGINT)]
    table = H.empty_table(keys, H.table_size_for(8))
    with pytest.raises(RuntimeError, match="full"):
        H.insert(table, keys, torch.ones(20, dtype=torch.bool), 20)


def test_reserve_grows_and_carries_state():
    """Batches of new keys beyond the first batch's table: reserve
    rehashes before each batch that could fill it past one half, every
    key keeps its per-slot state, and lookups still find every key."""
    rng = np.random.RandomState(3)
    n = 256
    make = [EvalValue(torch.from_numpy(
        rng.permutation(10 ** 6)[:n].astype(np.int64) + 10 ** 6 * i), None,
        T.BIGINT) for i in range(6)]
    table = H.empty_table([make[0]], H.table_size_for(n))
    state = torch.zeros(table.size + 1, dtype=torch.int64)
    before = H.reserve.rehashes
    live = 0
    sizes = []
    for keys in make:
        table, (state,) = H.reserve(table, [keys], live, n, (state,))
        table, slots, is_new = H.insert(table, [keys],
                                        torch.ones(n, dtype=torch.bool), n)
        live += int(is_new.sum())
        state[slots] = keys.data  # the key itself as the slot's state
        sizes.append(table.size)
    assert live == 6 * n and H.reserve.rehashes - before >= 2
    assert sizes[-1] >= 2 * live and sizes == sorted(sizes)
    everything = EvalValue(torch.cat([k.data for k in make]), None, T.BIGINT)
    slots, found = H.lookup(table, [everything],
                            torch.ones(6 * n, dtype=torch.bool), 6 * n)
    assert bool(found.all())
    assert torch.equal(state[slots], everything.data)


def _both(build):
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), CPU).run()
    assert got.schema == want.schema
    assert got.equals(want)
    return got


@pytest.mark.parametrize("key_cols", [["k"], ["k", "s"], ["d"]])
def test_mark_distinct_marks_the_first_row_of_each_key(key_cols):
    """MarkDistinct over three batches (BIGINT with NULLs, a dictionary
    string, a DOUBLE) equals the reference, and the marker is the first
    row of each key tuple in the stream."""
    rng = np.random.RandomState(4)
    tables = []
    for _ in range(3):
        k = rng.randint(0, 30, 100)
        tables.append(pa.table({
            "k": pa.array([None if x == 0 else int(x) for x in k],
                          pa.int64()),
            "s": pa.array([["x", "y", "z"][x % 3] for x in
                           rng.randint(0, 3, 100)]),
            "d": pa.array(rng.randint(0, 20, 100) / 4.0),
            "v": pa.array(np.arange(100), pa.int64())}))
    got = _both(lambda B: B().values(tables)
                .mark_distinct("first", key_cols).plan())
    keys = list(zip(*(got.column(c).to_pylist() for c in key_cols)))
    seen = set()
    for key, marked in zip(keys, got.column("first").to_pylist()):
        assert marked == (key not in seen)
        seen.add(key)


@pytest.fixture
def small_splits():
    """The "tpch" connector at SF 0.01 with 4,096-row splits: orders comes
    in 4 batches, the first one's table holds 4,096 keys."""
    DataCache.instance().clear()
    conn = tt.TpchConnector("tpch", 0.01, 4096)
    register_connector(conn)
    yield conn
    tt.register_tpch(0.01)
    DataCache.instance().clear()


def _stream_rank(keys: np.ndarray) -> np.ndarray:
    """1-based occurrence number of each row's key in stream order."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    out = np.empty(len(keys), np.int64)
    out[order] = np.arange(len(ks)) - start + 1
    return out


@pytest.mark.parametrize("key", ["o_orderkey", "o_custkey"])
def test_orders_in_small_splits_grow_the_table(small_splits, key):
    """MarkDistinct and RowNumber over orders in 4,096-row splits. With
    o_orderkey, 15,000 distinct keys pass the first batch's table (the
    reference does not return); the port grows it and equals numpy."""
    before = H.reserve.rehashes
    plan = (PlanBuilder().table_scan("orders", ["o_orderkey", "o_custkey"])
            .mark_distinct("first", [key]).row_number([key], "rn").plan())
    got = Task(plan, CPU).run()
    gen = small_splits.gen
    cols = gen.generate("orders", 0, gen.num_rows("orders"),
                        ["o_orderkey", "o_custkey"])
    keys = cols[key].astype(np.int64)
    rank = _stream_rank(keys)
    assert got.num_rows == len(keys) == 15000
    assert np.array_equal(np.asarray(got.column(key)), keys)
    assert np.array_equal(np.asarray(got.column("rn")), rank)
    assert np.array_equal(np.asarray(got.column("first")), rank == 1)
    assert H.reserve.rehashes - before >= 2  # both operators grew

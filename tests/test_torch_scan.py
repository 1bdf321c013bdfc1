"""The port's scan path on the CPU, against the JAX reference.

- ``DataCache`` (connectors/cache.py): the same put/get/evict sequence as
  the reference's gives the same stats and counters; its budget, LRU
  eviction, oversize entries, a capped device root, reclaim through the
  arbitrator, the flags it reads, a key that names the device.
- ``TpchDataSource``: every table's batches equal the reference's and
  the form the port uploaded before the one-pass staging (``np.zeros``,
  ``astype``, a slice copy) bit for bit; a CPU query never pins memory;
  a query leaves every cached batch as it found it.
- ``TableScanOperator``'s producer thread and ``Task``'s probe-scan
  prewarm: depths 0 and 2 agree, a fault injected at
  ``TableScan::prefetch`` reaches the consumer, and no producer thread
  outlives a query that a Limit, a closed iterator or an error stops.

A connector with small splits (``SMALL_SPLITS`` rows) gives every table
but the smallest several splits, so the producer threads have work.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from velox_tpu import types as JT
from velox_tpu.common import metrics as JM
from velox_tpu.connectors import cache as JC
from velox_tpu.connectors import tpch as jt
from velox_tpu.exec import memory as JMem
from velox_tpu.vector.device import DeviceBatch as JBatch
from velox_tpu.vector.device import DeviceColumn as JColumn
from velox_tpu_torch import types as T
from velox_tpu_torch.common import flags as F
from velox_tpu_torch.common import metrics as TM
from velox_tpu_torch.common import testvalue as TV
from velox_tpu_torch.connectors import cache as TC
from velox_tpu_torch.connectors import tpch as tt
from velox_tpu_torch.connectors.connector import register_connector
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec import task as task_mod
from velox_tpu_torch.exec.memory import MemoryArbitrator, MemoryPool
from velox_tpu_torch.exec.operator import TableScanOperator
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.vector.device import DeviceBatch, DeviceColumn

torch.set_num_threads(1)

SF = 0.01
SMALL_SPLITS = 4096


@pytest.fixture(autouse=True)
def _tpch():
    tt.register_tpch(SF)
    TC.DataCache.instance().clear()
    yield
    tt.register_tpch(SF)


@pytest.fixture
def small_splits():
    """The port's "tpch" connector with small splits: lineitem 19, orders
    4, customer 1."""
    conn = tt.TpchConnector("tpch", SF, SMALL_SPLITS)
    register_connector(conn)
    return conn


def _counter(m, key):
    return m.reporter().snapshot()["counters"].get(key, 0)


def _scan_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("velox-scan-") and t.is_alive()]


def _ctx(depth):
    return QueryCtx("cpu", {QC.SCAN_PREFETCH_DEPTH: depth})


def _q18_240():
    from velox_tpu_torch.tpch.queries import q18
    return q18(threshold=240.0)


PLANS = {
    "q1": lambda: tpch_plan(1),
    "q3": lambda: tpch_plan(3),
    "q6": lambda: tpch_plan(6),
    "q18": _q18_240,
    "sort": lambda: (PlanBuilder()
                     .table_scan("lineitem", ["l_shipdate", "l_orderkey",
                                              "l_linenumber"])
                     .order_by(["l_shipdate", "l_orderkey",
                                "l_linenumber"]).plan()),
}


# ---------------------------------------------------------------------------
# DataCache
# ---------------------------------------------------------------------------

ROWS = 1024
BATCH_BYTES = ROWS * 8 + ROWS  # an int64 column and the bool mask


def _pair(i: int, rows: int = ROWS):
    """The same one-column batch in both engines."""
    data = np.arange(rows, dtype=np.int64) + i
    mask = np.ones(rows, bool)
    jb = JBatch({"x": JColumn(jnp.asarray(data), None, JT.BIGINT)},
                jnp.asarray(mask))
    tb = DeviceBatch({"x": DeviceColumn(torch.from_numpy(data), None,
                                        T.BIGINT)}, torch.from_numpy(mask))
    return jb, tb


def _cache_counters(m):
    return [_counter(m, k) for k in (m.K_SCAN_CACHE_HITS,
                                     m.K_SCAN_CACHE_MISSES,
                                     m.K_SCAN_CACHE_EVICTIONS)]


def test_data_cache_matches_the_reference():
    assert TC.DEFAULT_BUDGET == JC.DEFAULT_BUDGET
    budget = 3 * BATCH_BYTES + BATCH_BYTES // 2
    jcache, tcache = JC.DataCache(budget), TC.DataCache(budget)
    assert JMem.batch_nbytes(_pair(0)[0]) == _pair(0)[1].nbytes \
        == BATCH_BYTES
    j0, t0 = _cache_counters(JM), _cache_counters(TM)
    big = _pair(9, rows=4 * ROWS)
    ops = [("put", 0), ("put", 1), ("get", 0), ("put", 2), ("put", 3),
           ("get", 1), ("get", 0), ("put", 4), ("get", 2), ("get", 4),
           ("put", 4), ("put", "big"), ("get", 3), ("reclaim", 1),
           ("get", 3), ("put", 5), ("get", 5), ("clear", None),
           ("get", 5), ("put", 6), ("get", 6)]
    try:
        _replay(ops, big, jcache, tcache)
    finally:
        # the reference cache holds its entries against the process's
        # device memory pool; later tests in the process start from none
        jcache.clear()
        tcache.clear()
    assert [a - b for a, b in zip(_cache_counters(TM), t0)] == \
        [a - b for a, b in zip(_cache_counters(JM), j0)]
    assert tcache.stats()["hits"] > 0 and tcache.stats()["misses"] > 0


def _replay(ops, big, jcache, tcache):
    for op, arg in ops:
        key = ("k", arg)
        if op == "put":
            jb, tb = big if arg == "big" else _pair(arg)
            jcache.put(key, jb)
            tcache.put(key, tb)
        elif op == "get":
            jhit, thit = jcache.get(key), tcache.get(key)
            assert (jhit is None) == (thit is None), (op, arg)
            if thit is not None:
                assert int(thit.columns["x"].data[0]) == arg
        elif op == "reclaim":
            assert jcache.reclaim(arg) == tcache.reclaim(arg)
        else:
            jcache.clear()
            tcache.clear()
        assert tcache.stats() == jcache.stats(), (op, arg)


def test_budget_evicts_the_least_recently_used():
    cache = TC.DataCache(2 * BATCH_BYTES)
    evictions = _counter(TM, TM.K_SCAN_CACHE_EVICTIONS)
    for i in range(2):
        cache.put(("k", i), _pair(i)[1])
    assert cache.get(("k", 0)) is not None  # 1 is now the oldest
    cache.put(("k", 2), _pair(2)[1])
    assert [k for k, _ in cache.entries()] == [("k", 0), ("k", 2)]
    assert cache.used == 2 * BATCH_BYTES
    assert _counter(TM, TM.K_SCAN_CACHE_EVICTIONS) == evictions + 1
    # an entry above the whole budget is not cached and evicts nothing
    cache.put(("big",), _pair(0, rows=4 * ROWS)[1])
    assert cache.get(("big",)) is None
    assert cache.stats()["entries"] == 2
    # a put under a key already present replaces it
    cache.put(("k", 2), _pair(7)[1])
    assert int(cache.get(("k", 2)).columns["x"].data[0]) == 7
    assert cache.used == 2 * BATCH_BYTES


def test_capped_device_root_refuses_the_put():
    root = MemoryPool.device_root()
    cache = TC.DataCache(10 * BATCH_BYTES)
    cache.put(("a",), _pair(0)[1])
    used = root.used
    try:
        MemoryPool.set_device_cap(root.used + BATCH_BYTES - 1)
        cache.put(("b",), _pair(1)[1])
        assert cache.get(("b",)) is None
        assert cache.stats()["entries"] == 1 and root.used == used
    finally:
        MemoryPool.set_device_cap(None)
    cache.put(("b",), _pair(1)[1])
    assert root.used == used + BATCH_BYTES
    cache.clear()
    assert root.used == used - BATCH_BYTES


def test_reclaim_through_the_arbitrator():
    """A capped pool's reserve_or_reclaim evicts the cache (PRI_CACHE)
    and then succeeds."""
    root = MemoryPool.device_root()
    cache = TC.DataCache(10 * BATCH_BYTES)
    for i in range(3):
        cache.put(("k", i), _pair(i)[1])
    pool = MemoryPool("q", parent=root)
    reclaims = MemoryArbitrator.instance().reclaim_calls
    try:
        MemoryPool.set_device_cap(root.used + BATCH_BYTES // 2)
        assert not pool.reserve(BATCH_BYTES)
        assert pool.reserve_or_reclaim(BATCH_BYTES)
        assert MemoryArbitrator.instance().reclaim_calls == reclaims + 1
        # the oldest entry went, as many bytes as the reserve needed
        assert [k for k, _ in cache.entries()] == [("k", 1), ("k", 2)]
        assert pool.stats()["used"] == BATCH_BYTES
    finally:
        MemoryPool.set_device_cap(None)
        pool.release(pool.used)
        cache.clear()


def test_concurrent_producers_keep_the_accounting(monkeypatch):
    """Scan producers share the cache: 12 threads putting and getting
    under a budget of 5 batches, with a short switch interval, lose no
    lookup and keep used == the bytes of the entries <= the budget."""
    import sys
    cache = TC.DataCache(5 * BATCH_BYTES)
    root = MemoryPool.device_root()
    base = root.used
    batches = [_pair(i)[1] for i in range(16)]
    rounds = 200

    def work(seed):
        rng = np.random.default_rng(seed)
        for _ in range(rounds):
            i = int(rng.integers(16))
            if cache.get(("k", i)) is None:
                cache.put(("k", i), batches[i])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(s,))
                   for s in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    stats = cache.stats()
    assert stats["hits"] + stats["misses"] == 12 * rounds
    assert stats["used"] == stats["entries"] * BATCH_BYTES <= cache.budget
    assert root.used - base == stats["used"]
    cache.clear()
    assert root.used == base


def test_instance_reads_the_flags(monkeypatch):
    monkeypatch.setattr(TC.DataCache, "_instance", None)
    try:
        F.set_flag("scan_cache_bytes", 12345)
        assert TC.DataCache.instance().budget == 12345
        monkeypatch.setattr(TC.DataCache, "_instance", None)
        F.set_flag("ssd_cache_dir", "/nonexistent")
        with pytest.raises(NotImplementedError, match="A.7"):
            TC.DataCache.instance()
    finally:
        F.reset_flag("scan_cache_bytes")
        F.reset_flag("ssd_cache_dir")


def test_the_key_names_the_device():
    conn = tt.register_tpch(SF)
    cols = ["n_nationkey", "n_name"]
    split = conn.default_splits("nation")[0]
    cache = TC.DataCache.instance()
    batch = conn.create_data_source("nation", cols,
                                    QueryCtx("cpu")).next(split)
    (key, cached), = cache.entries()
    assert cached is batch
    assert key[:6] == ("tpch", SF, "nation", tuple(cols), split.lo,
                       split.hi)
    assert key[-1] == "cpu"
    # a batch cached for the card is never served to a CPU query
    cache.clear()
    sentinel = DeviceBatch({}, torch.ones(4, dtype=torch.bool))
    cache.put(key[:-1] + ("cuda",), sentinel)
    again = conn.create_data_source("nation", cols,
                                    QueryCtx("cpu")).next(split)
    assert again is not sentinel and again.device.type == "cpu"
    assert torch.equal(again.columns["n_name"].data,
                       batch.columns["n_name"].data)


def _tensors(batch):
    out = [batch.mask]
    for col in batch.columns.values():
        stack = [col]
        while stack:
            c = stack.pop()
            out.append(c.data)
            if c.validity is not None:
                out.append(c.validity)
            stack.extend(c.children)
    return out


@pytest.mark.parametrize("path", sorted(PLANS))
def test_a_query_leaves_the_cached_batches_as_it_found_them(path):
    cache = TC.DataCache.instance()
    first = Task(PLANS[path](), _ctx(2)).run()
    snapshot = {k: (b, [t.clone() for t in _tensors(b)])
                for k, b in cache.entries()}
    assert snapshot
    hits = cache.hits
    again = Task(PLANS[path](), _ctx(2)).run()
    assert again.equals(first)
    assert cache.hits > hits
    assert {k: b for k, b in cache.entries()} == \
        {k: b for k, (b, _) in snapshot.items()}
    for key, (batch, saved) in snapshot.items():
        now = _tensors(batch)
        assert len(now) == len(saved)
        for a, b in zip(now, saved):
            assert a.dtype == b.dtype and torch.equal(a, b), key


# ---------------------------------------------------------------------------
# TpchDataSource
# ---------------------------------------------------------------------------

def _todays_form(table, arrays, columns, cap):
    """The port's host form before the one-pass staging: np.zeros(cap),
    astype, a slice copy."""
    schema = tt.TPCH_SCHEMAS[table]
    out = {}
    for name in columns:
        np_dt = schema.field_type(name).np_dtype()
        if name in tt._NARROW_INT32:
            np_dt = np.dtype(np.int32)
        data = np.zeros((cap,), np_dt)
        arr = arrays[name]
        data[:len(arr)] = arr.astype(np_dt)
        out[name] = data
    return out


@pytest.mark.parametrize("table", sorted(tt.TPCH_SCHEMAS))
def test_source_batches_equal_the_reference_and_todays_form(table):
    cols = list(tt.TPCH_SCHEMAS[table].names)
    jc = jt.TpchConnector("tpch-scan-test", SF, SMALL_SPLITS)
    tc = tt.TpchConnector("tpch-scan-test", SF, SMALL_SPLITS)
    jsrc = jc.create_data_source(table, cols, None)
    tsrc = tc.create_data_source(table, cols, QueryCtx("cpu"))
    splits = tc.default_splits(table)
    assert [(s.lo, s.hi) for s in splits] == \
        [(s.lo, s.hi) for s in jc.default_splits(table)]
    for js, ts in zip(jc.default_splits(table), splits):
        jb = jax.device_get(jsrc.next(js))
        tb = tsrc.next(ts)
        assert tsrc.next(ts) is None
        n = int(np.asarray(jb.mask).sum())
        old = _todays_form(table, tc.gen.generate(table, ts.lo, ts.hi,
                                                  cols), cols, tb.capacity)
        assert tb.capacity == jb.capacity
        assert tb.mask.dtype == torch.bool
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
        np.testing.assert_array_equal(tb.mask.numpy(),
                                      np.arange(tb.capacity) < n)
        for c in cols:
            got = tb.columns[c].data.numpy()
            want = np.asarray(jb.columns[c].data)
            assert got.dtype == want.dtype == old[c].dtype, c
            assert got.tobytes() == want.tobytes() == old[c].tobytes(), c
            assert tb.columns[c].validity is None
            assert str(tb.columns[c].dtype) == str(jb.columns[c].dtype)
        # a second source over the same split gets the cached batch
        assert tc.create_data_source(table, cols, QueryCtx("cpu")) \
            .next(ts) is tb


def test_stage_column_is_todays_form():
    rng = np.random.default_rng(0)
    arr = rng.integers(-2 ** 31, 2 ** 31, 3000).astype(np.int64)
    for dtype, np_dt in ((torch.int32, np.int32), (torch.int64, np.int64)):
        host = tt.stage_column(arr, dtype, 4096, pin=False)
        old = np.zeros(4096, np_dt)
        old[:3000] = arr.astype(np_dt)
        assert host.dtype == dtype and not host.is_pinned()
        assert host.numpy().tobytes() == old.tobytes()


def test_a_cpu_query_never_pins(monkeypatch, small_splits):
    pinned = []
    empty = torch.empty

    def spy_empty(*args, **kwargs):
        if kwargs.get("pin_memory"):
            pinned.append(args)
        return empty(*args, **kwargs)

    def spy_pin(self, *args, **kwargs):
        pinned.append(self.shape)
        raise AssertionError("pin_memory on a CPU query")

    monkeypatch.setattr(torch, "empty", spy_empty)
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy_pin)
    for depth in (0, 2):
        TC.DataCache.instance().clear()
        assert Task(tpch_plan(6), _ctx(depth)).run().num_rows == 1
    assert not pinned
    for _, batch in TC.DataCache.instance().entries():
        assert not any(t.is_pinned() for t in _tensors(batch))


# ---------------------------------------------------------------------------
# Prefetch and prewarm
# ---------------------------------------------------------------------------

def test_prefetch_depth_comes_from_the_config(monkeypatch, small_splits):
    made = []

    class Recorder:
        def __init__(self, node, source, splits, prefetch, gate=None):
            made.append((node.table, str(source._device), prefetch))

    monkeypatch.setattr(task_mod, "TableScanOperator", Recorder)
    node = PlanBuilder().table_scan("lineitem", ["l_orderkey"]).plan()
    for device, config in (("cpu", None), ("cuda", None),
                           ("cpu", {QC.SCAN_PREFETCH_DEPTH: 3}),
                           ("cuda", {QC.SCAN_PREFETCH_DEPTH: 0})):
        Task(node, QueryCtx(device, config))._make_scan(node)
    assert made == [("lineitem", "cpu", 0), ("lineitem", "cuda", 2),
                    ("lineitem", "cpu", 3), ("lineitem", "cuda", 0)]


def test_query_ctx_has_a_pool_under_the_device_root():
    ctx = QueryCtx("cpu", {QC.QUERY_HBM_CAP_BYTES: 1000})
    assert ctx.memory_pool.parent is MemoryPool.device_root()
    assert ctx.memory_pool.cap_bytes == 1000
    assert QueryCtx("cpu").memory_pool.cap_bytes is None
    assert ctx.query_config.get_int(QC.SCAN_PREFETCH_DEPTH, 7) == 7


@pytest.mark.parametrize("path", sorted(PLANS))
def test_prefetch_depths_agree(path, small_splits):
    results = []
    for depth in (0, 2, 1):
        TC.DataCache.instance().clear()
        splits = _counter(TM, TM.K_SCAN_SPLITS)
        results.append((Task(PLANS[path](), _ctx(depth)).run(),
                        _counter(TM, TM.K_SCAN_SPLITS) - splits))
        assert not _scan_threads()
    (want, n), *rest = results
    assert want.num_rows > 0 and n > 0
    for got, m in rest:
        assert got.equals(want) and m == n


@pytest.fixture
def testvalues():
    TV.enable()
    yield
    TV.disable()


def test_prefetch_fault_surfaces_on_the_consumer(small_splits, testvalues):
    class Boom(RuntimeError):
        pass

    for _ in range(3):
        TC.DataCache.instance().clear()
        fired = {"n": 0}

        def cb(split):
            fired["n"] += 1
            if fired["n"] == 2:  # fail on the second split
                raise Boom("prefetch")

        TV.set_callback("TableScan::prefetch", cb)
        plan = (PlanBuilder().table_scan("lineitem", ["l_orderkey"])
                .single_aggregation([], ["count() as c"]).plan())
        t0 = time.time()
        with pytest.raises(Boom, match="prefetch"):
            Task(plan, _ctx(2)).run()
        assert time.time() - t0 < 30
        assert fired["n"] == 2
        assert not _scan_threads()
        TV.clear_callback("TableScan::prefetch")


def test_a_limit_leaves_no_producer_thread(small_splits):
    plan = (PlanBuilder().table_scan("lineitem", ["l_orderkey"])
            .limit(5).plan())
    for _ in range(3):
        TC.DataCache.instance().clear()
        task = Task(plan, _ctx(2))
        out = task.run()
        assert out.num_rows == 5
        # the Limit took the first batch; the scan's producer had more
        scan, = [op for op in task.operators
                 if isinstance(op, TableScanOperator)]
        assert scan._queue is not None and not scan._thread.is_alive()
        assert not _scan_threads()


def _join_plan():
    """lineitem probing orders, streaming one output batch a probe batch."""
    b = PlanBuilder()
    orders = b.new_builder().table_scan("orders",
                                        ["o_orderkey", "o_orderdate"])
    return (b.table_scan("lineitem", ["l_orderkey", "l_quantity"])
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_orderkey", "l_quantity", "o_orderdate"])
            .plan())


def test_prewarmed_probe_scans_close_when_a_query_stops_early(
        small_splits, testvalues):
    prewarmed = _counter(TM, TM.K_SCAN_PREWARMED)
    task = Task(_join_plan(), _ctx(2))
    it = task.batches()
    first = next(it)
    assert first.capacity > 0
    assert _counter(TM, TM.K_SCAN_PREWARMED) == prewarmed + 1
    assert task._prewarmed_scans == {}  # the probe took its scan
    it.close()
    assert not _scan_threads()

    # an error in the build: the prewarmed probe scan was never driven
    def fail_on_orders(split):
        if split.table == "orders":
            raise RuntimeError("build failed")

    TV.set_callback("TableScan::prefetch", fail_on_orders)
    TC.DataCache.instance().clear()
    task = Task(_join_plan(), _ctx(2))
    with pytest.raises(RuntimeError, match="build failed"):
        task.run()
    assert task._prewarmed_scans == {}
    assert not _scan_threads()
    TV.clear_callback("TableScan::prefetch")

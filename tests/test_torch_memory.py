"""Host offload, disk spill, arbitration, the scan cache's SSD tier and
the Values ingest cache of the port, against the JAX reference.

- Counterparts of tests/test_disk_spill.py, tests/test_arbitration.py and
  tests/test_ssd_cache.py: each runs the same numpy-seeded Arrow inputs
  through both packages and compares the rows.
- ``HostBatch`` and ``DiskBatch`` round trips of every column kind the
  port holds (DECIMAL(38), raw and dictionary strings, ARRAY and MAP
  dense and with explicit starts after a join, ROW, validity, the error
  count).
- ``OffloadBuffer.restore_all`` returns the batches in insertion order
  across all three tiers; the reference returns device, host, then disk
  batches (ROADMAP C), which the tests show.
- The ingest cache reserves its bytes in the device root and gives them
  back on reclaim; a capped root keeps the entry out. The reference's
  cache reserves nothing, which the test shows.
"""

import decimal
import glob
import pickle

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.connectors import cache as JC
from velox_tpu.exec import memory as JMem
from velox_tpu.exec.operator import ValuesOperator as JValuesOperator
from velox_tpu.exec.task import QueryCtx as JQueryCtx
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.vector import device as JD
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.common.errors import VeloxRuntimeError
from velox_tpu_torch.connectors.cache import DataCache, SsdTier
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec.memory import (
    DiskBatch, HostBatch, MemoryArbitrator, MemoryPool, OffloadBuffer,
)
from velox_tpu_torch.exec.operator import IngestCache
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.batches import batch_from_reference
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.vector import device as D

torch.set_num_threads(1)

I64 = pa.int64()


@pytest.fixture(autouse=True)
def _caches():
    DataCache.instance().clear()
    IngestCache.instance().clear()
    yield
    DataCache.instance().clear()
    IngestCache.instance().clear()


def _counter(m, key):
    return m.reporter().snapshot()["counters"].get(key, 0)


def _table(seed, n=1000):
    rng = np.random.RandomState(seed)
    return pa.table({"k": rng.randint(0, 50, n).astype("int64"),
                     "v": rng.rand(n),
                     "s": pa.array([f"row-{i}" for i in range(n)])})


def _pair(table, **kw):
    """(reference batch, port batch) of the same Arrow table."""
    jb = JD.from_arrow(table, **kw)
    return jb, batch_from_reference(jb)


# ---- counterparts of tests/test_disk_spill.py ---------------------------

def test_host_batch_preserves_children():
    t = pa.table({
        "d": pa.array([decimal.Decimal("12345678901234567890.12")] * 3,
                      pa.decimal128(38, 2)),
        "s": pa.array(["alpha", "beta", "gamma"])})
    jb, b = _pair(t, capacity=4, string_encoding="raw")
    want = JD.to_arrow(JMem.HostBatch(jb).restore())
    got = D.to_arrow(HostBatch(b).restore())
    assert got.to_pylist() == want.to_pylist() == t.to_pylist()


def test_disk_batch_roundtrip(tmp_path):
    jb, b = _pair(_table(0))
    jdir, pdir = tmp_path / "ref", tmp_path / "port"
    jd = JMem.DiskBatch(JMem.HostBatch(jb), str(jdir))
    d = DiskBatch(HostBatch(b), str(pdir))
    assert glob.glob(str(pdir / "spill-*.npz"))
    assert D.to_arrow(d.restore()).equals(JD.to_arrow(jd.restore()))
    assert not glob.glob(str(pdir / "spill-*"))  # deleted on restore


def test_offload_buffer_three_tiers(tmp_path):
    """Device budget 0, host budget of two batches: the three oldest go
    to disk. The port returns the five batches in insertion order; the
    reference returns host, then disk batches."""
    pairs = [_pair(_table(i)) for i in range(5)]
    firsts = [int(jb.columns["k"].data[0]) for jb, _ in pairs]
    nbytes = HostBatch(pairs[0][1]).nbytes
    buf = OffloadBuffer(0, host_budget_bytes=2 * nbytes + 1,
                        spill_dir=str(tmp_path / "port"))
    jn = JMem.HostBatch(pairs[0][0]).nbytes
    jbuf = JMem.OffloadBuffer(0, host_budget_bytes=2 * jn + 1,
                              spill_dir=str(tmp_path / "ref"))
    for jb, b in pairs:
        buf.add(b)
        jbuf.add(jb)
    assert (len(buf._disk), len(buf._host)) == (3, 2)
    assert (len(jbuf._disk), len(jbuf._host)) == (3, 2)
    assert len(glob.glob(str(tmp_path / "port" / "spill-*.npz"))) == 3
    out = buf.restore_all()
    assert [int(b.columns["k"].data[0]) for b in out] == firsts
    for (jb, _), b in zip(pairs, out):
        assert D.to_arrow(b).equals(JD.to_arrow(jb))
    jout = jbuf.restore_all()
    assert [int(b.columns["k"].data[0]) for b in jout] \
        == firsts[3:] + firsts[:3]
    assert not glob.glob(str(tmp_path / "*" / "spill-*"))


def _join_build_plan(mod, probe, build):
    b = mod()
    bb = b.new_builder().values([pa.table(build[i::4]) for i in range(4)])
    return (b.values([pa.table(probe)])
            .hash_join(["pk"], ["bk"], bb, output=["pk", "pv", "bv"])
            .order_by(["pk", "pv"]).plan())


def test_join_build_larger_than_host_budget(tmp_path):
    """A hash-join build forced through the disk tier (device budget 0,
    host budget 1 byte) answers as the reference does, and leaves no
    spill file."""
    rng = np.random.RandomState(3)
    probe = {"pk": rng.randint(0, 200, 400).astype("int64"),
             "pv": rng.randint(0, 100, 400).astype("int64")}
    build = {"bk": np.arange(200, dtype="int64"),
             "bv": np.arange(200, dtype="int64") * 3}
    build = pa.table(build)
    cfg = {QC.JOIN_BUILD_OFFLOAD_BYTES: 0, QC.OFFLOAD_HOST_BUDGET_BYTES: 1}
    writes = _counter(M, M.K_SPILL_DISK_WRITES)
    want = JTask(_join_build_plan(JPlanBuilder, probe, build), JQueryCtx(
        dict(cfg, **{QC.SPILL_DIR: str(tmp_path / "ref")}))).run()
    ctx = QueryCtx("cpu", dict(cfg, **{QC.SPILL_DIR: str(tmp_path / "p")}))
    got = Task(_join_build_plan(PlanBuilder, probe, build), ctx).run()
    assert got.to_pylist() == want.to_pylist() and got.num_rows > 0
    assert _counter(M, M.K_SPILL_DISK_WRITES) - writes == 4
    assert not glob.glob(str(tmp_path / "p" / "spill-*"))
    assert ctx.memory_pool.used == 0


def test_orderby_through_disk_tier(tmp_path):
    rng = np.random.RandomState(9)
    tables = [pa.table({"x": rng.permutation(500).astype("int64")})
              for _ in range(3)]
    cfg = {QC.SORT_OFFLOAD_BYTES: 0, QC.OFFLOAD_HOST_BUDGET_BYTES: 1}
    want = JTask(JPlanBuilder().values(tables).order_by(["x"]).plan(),
                 JQueryCtx(dict(cfg, **{QC.SPILL_DIR: str(tmp_path)}))
                 ).run()
    got = Task(PlanBuilder().values(tables).order_by(["x"]).plan(),
               QueryCtx("cpu", dict(cfg, **{QC.SPILL_DIR: str(tmp_path)}))
               ).run()
    assert got.equals(want) and got.num_rows == 1500
    assert not glob.glob(str(tmp_path / "spill-*"))


# ---- round trips of every column kind ----------------------------------

LIST = pa.list_(I64)
MAP = pa.map_(pa.string(), I64)
ROW = pa.struct([("x", I64), ("y", pa.string())])


def _kind_batches(kind: str):
    """The port's batches of one column kind, NULLs included."""
    cpu = torch.device("cpu")
    if kind == "decimal38":
        t = pa.table({"d": pa.array(
            [decimal.Decimal("-98765432109876543210.55"), None,
             decimal.Decimal("12345678901234567890.12")],
            pa.decimal128(38, 2))})
    elif kind in ("raw_strings", "dict_strings"):
        t = pa.table({"s": pa.array(["alpha", None, "", "γάμμα"])})
    elif kind == "array":
        t = pa.table({"a": pa.array([[1, 2], None, [], [3]], LIST)})
    elif kind == "map":
        t = pa.table({"m": pa.array([[("x", 1)], None, [],
                                     [("y", 2), ("z", 3)]], MAP)})
    elif kind == "row":
        t = pa.table({"r": pa.array([{"x": 1, "y": "a"}, None,
                                     {"x": 2, "y": None}], ROW)})
    elif kind == "validity":
        t = pa.table({"i": pa.array([1, None, 3], pa.int32()),
                      "f": pa.array([None, 2.5, None])})
    elif kind in ("array_starts", "map_starts"):
        col = {"array_starts": pa.array([[1, 2], None, [3, 4, 5], []], LIST),
               "map_starts": pa.array([[("a", 1)], [("b", 2), ("c", 3)],
                                       None, []], MAP)}[kind]
        build = pa.table({"k": np.array([3, 1, 2, 0], np.int64), "c": col})
        probe = pa.table({"p": np.array([2, 2, 0, 3, 1], np.int64)})
        b = PlanBuilder()
        plan = (b.values([probe])
                .hash_join(["p"], ["k"], b.new_builder().values([build]),
                           output=["p", "c"]).plan())
        out = list(Task(plan, QueryCtx("cpu")).batches())
        assert any(o.columns["c"].starts is not None for o in out)
        return out
    else:  # errors
        b = D.from_arrow(pa.table({"x": np.arange(5, dtype=np.int64)}),
                         device=cpu)
        return [D.DeviceBatch(b.columns, b.mask,
                              torch.tensor(3, dtype=torch.int32))]
    enc = "raw" if kind == "raw_strings" else "dict"
    return [D.from_arrow(t, string_encoding=enc, device=cpu)]


KINDS = ("decimal38", "raw_strings", "dict_strings", "array", "map",
         "array_starts", "map_starts", "row", "validity", "errors")


@pytest.mark.parametrize("tier", ("host", "disk", "pickle"))
@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_of_every_column_kind(kind, tier, tmp_path):
    for b in _kind_batches(kind):
        h = HostBatch(b)
        if tier == "host":
            back = h.restore()
        elif tier == "disk":
            back = DiskBatch(h, str(tmp_path)).restore()
        else:  # the SSD tier's form
            back = pickle.loads(pickle.dumps(h)).restore()
        assert D.to_arrow(back).equals(D.to_arrow(b))
        assert back.nbytes == b.nbytes
        if b.errors is not None:
            assert int(back.errors) == int(b.errors)
        for name, col in b.columns.items():
            if tier != "pickle":  # dictionaries stay by reference
                assert back.columns[name].dictionary is col.dictionary
            assert (back.columns[name].starts is None) \
                == (col.starts is None)
    assert not glob.glob(str(tmp_path / "spill-*"))


# ---- the order of restore_all --------------------------------------------

@pytest.mark.parametrize("budget,host_budget,reclaim", [
    (2, 2.5, 0),    # device 0-1, disk 2-4, host 5-6
    (3, 1.5, 0),    # device 0-2, disk 3-5, host 6
    (None, 2.5, 2),  # all on the device, then the oldest two reclaimed
    (4, 1.0, 3),    # reclaimed device batches land after later host ones
])
def test_restore_all_keeps_insertion_order(budget, host_budget, reclaim,
                                           tmp_path):
    batches = [D.from_arrow(_table(i, 300), device="cpu") for i in range(7)]
    n = batches[0].nbytes
    buf = OffloadBuffer(None if budget is None else budget * n,
                        host_budget_bytes=int(host_budget * n),
                        spill_dir=str(tmp_path))
    for b in batches:
        buf.add(b)
    buf.reclaim(reclaim * n)
    if budget is not None and budget < 7:
        assert buf._device and buf._host and buf._disk
    out = buf.restore_all()
    assert len(out) == 7
    for o, b in zip(out, batches):
        assert D.to_arrow(o).equals(D.to_arrow(b))
    assert not glob.glob(str(tmp_path / "spill-*"))


def test_max_spill_bytes_raises(tmp_path):
    b = D.from_arrow(pa.table({"x": np.arange(4096, dtype="int64")}),
                     device="cpu")
    buf = OffloadBuffer(0, host_budget_bytes=2 * b.nbytes,
                        spill_dir=str(tmp_path), max_spill_bytes=10)
    buf.add(b)
    assert buf._host and not buf._disk
    with pytest.raises(VeloxRuntimeError, match="spill limit exceeded"):
        for _ in range(4):
            buf.add(b)
    buf.close()
    assert not glob.glob(str(tmp_path / "spill-*"))


def test_own_spill_directory_is_removed():
    b = D.from_arrow(_table(1), device="cpu")
    buf = OffloadBuffer(0, host_budget_bytes=1)
    buf.add(b)
    d = buf._spill_dir
    assert glob.glob(d + "/spill-*.npz")
    assert D.to_arrow(buf.restore_all()[0]).equals(D.to_arrow(b))
    assert not glob.glob(d)


# ---- counterparts of tests/test_arbitration.py --------------------------

class _FakeReclaimer:
    def __init__(self, avail):
        self.avail = avail
        self.calls = []

    def reclaim(self, needed):
        self.calls.append(needed)
        freed = min(self.avail, needed)
        self.avail -= freed
        return freed


@pytest.mark.parametrize("mod", (JMem, None))
def test_arbitrator_priority_order(mod):
    arb = (mod.MemoryArbitrator if mod else MemoryArbitrator)()
    cache, op = _FakeReclaimer(1000), _FakeReclaimer(10_000)
    arb.register(op, arb.PRI_OPERATOR)
    arb.register(cache, arb.PRI_CACHE)
    assert arb.reclaim(600) == 600
    assert cache.calls == [600] and op.calls == []
    assert arb.reclaim(2000) == 2000
    assert cache.calls == [600, 2000] and op.calls == [1600]


def test_pool_cap_triggers_cache_eviction():
    cache = DataCache.instance()
    root = MemoryPool.device_root()
    base = root.used
    batch = D.from_arrow(pa.table({"x": np.arange(4096, dtype="int64")}),
                         capacity=4096, device="cpu")
    cache.put(("k1",), batch)
    assert cache.used > 0 and root.used > base
    pool = MemoryPool("q", parent=root)
    try:
        root.cap_bytes = root.used + 1000
        assert not pool.reserve(50_000)
        assert pool.reserve_or_reclaim(cache.used + base + 900)
        assert cache.used == 0
    finally:
        root.cap_bytes = None
        pool.release(pool.used)


def test_offload_buffer_reclaim_moves_batches_to_host():
    tables = [pa.table({"x": np.arange(1024, dtype="int64") + i})
              for i in range(4)]
    pool, jpool = MemoryPool("q"), JMem.MemoryPool("q")
    buf = OffloadBuffer(None, pool=pool)
    jbuf = JMem.OffloadBuffer(None, pool=jpool)
    for t in tables:
        jb, b = _pair(t, capacity=1024)
        buf.add(b)
        jbuf.add(jb)
    assert len(buf._device) == 4 and pool.used == jpool.used > 0
    assert buf.reclaim(1) == jbuf.reclaim(1) > 0
    assert len(buf._host) == len(jbuf._host) == 1
    got = [int(b.columns["x"].data[0]) for b in buf.restore_all()]
    jgot = [int(b.columns["x"].data[0]) for b in jbuf.restore_all()]
    assert got == [0, 1, 2, 3] and sorted(jgot) == got
    assert jgot == [1, 2, 3, 0]  # the reference: device, then host
    assert pool.used == jpool.used == 0


def test_capped_query_completes_without_manual_budgets():
    rng = np.random.RandomState(7)
    tables = [pa.table({
        "k": rng.randint(0, 1 << 30, 20_000).astype("int64"),
        "v": rng.randint(0, 100, 20_000).astype("int64")})
        for _ in range(4)]
    cfg = {QC.QUERY_HBM_CAP_BYTES: 300_000}
    want = JTask(JPlanBuilder().values(tables).order_by(["k"]).plan(),
                 JQueryCtx(cfg)).run()
    ctx = QueryCtx("cpu", cfg)
    before = _counter(M, M.K_SORT_OFFLOADS)
    calls = MemoryArbitrator.instance().reclaim_calls
    got = Task(PlanBuilder().values(tables).order_by(["k"]).plan(),
               ctx).run()
    assert got.equals(want)
    assert _counter(M, M.K_SORT_OFFLOADS) > before
    assert MemoryArbitrator.instance().reclaim_calls > calls
    assert ctx.memory_pool.used == 0 and ctx.memory_pool.peak <= 300_000


# ---- counterparts of tests/test_ssd_cache.py ----------------------------

def _ssd_table(seed, n=2048):
    rng = np.random.RandomState(seed)
    return pa.table({"x": rng.randint(0, 1 << 40, n).astype("int64"),
                     "y": rng.rand(n)})


def test_eviction_demotes_and_get_promotes(tmp_path):
    cache = DataCache(budget_bytes=100_000)  # about 3 batches of 34 KB
    jcache = JC.DataCache(budget_bytes=100_000)
    ssd = cache.enable_ssd(str(tmp_path / "ssd"))
    jssd = jcache.enable_ssd(str(tmp_path / "jssd"))
    tables = {i: _ssd_table(i) for i in range(6)}
    writes = _counter(M, M.K_SSD_CACHE_WRITES)
    for i, t in tables.items():
        jb, b = _pair(t, capacity=2048)
        cache.put(("k", i), b)
        jcache.put(("k", i), jb)
    assert ssd.stats()["entries"] == jssd.stats()["entries"] >= 3
    assert _counter(M, M.K_SSD_CACHE_WRITES) - writes \
        == ssd.stats()["entries"]
    for i in range(6):
        got, want = cache.get(("k", i)), jcache.get(("k", i))
        assert got is not None, i
        assert D.to_arrow(got).equals(JD.to_arrow(want))
        assert D.to_arrow(got).equals(tables[i])
    assert ssd.hits == jssd.hits >= 3
    cache.clear()
    jcache.clear()


def test_checkpoint_survives_restart(tmp_path):
    d = str(tmp_path / "ssd2")
    tier = SsdTier(d, budget_bytes=10 << 20)
    t = _ssd_table(42)
    tier.put(("persist", 1), D.from_arrow(t, capacity=2048, device="cpu"))
    tier2 = SsdTier(d, budget_bytes=10 << 20)  # as after a restart
    assert tier2.stats()["entries"] == 1
    got = tier2.get(("persist", 1))
    assert got is not None and D.to_arrow(got).equals(t)
    assert tier2.get(("persist", 2)) is None
    assert tier2.stats()["hits"] == tier2.stats()["misses"] == 1


def test_ssd_budget_evicts_oldest(tmp_path):
    tier = SsdTier(str(tmp_path / "ssd3"), budget_bytes=120_000)
    jtier = JC.SsdTier(str(tmp_path / "jssd3"), budget_bytes=120_000)
    for i in range(8):
        jb, b = _pair(_ssd_table(i), capacity=2048)
        tier.put(("b", i), b)
        jtier.put(("b", i), jb)
    assert tier.stats()["used"] <= 120_000
    for t in (tier, jtier):
        assert t.get(("b", 7)) is not None
        assert t.get(("b", 0)) is None
    assert tier.stats()["entries"] == jtier.stats()["entries"]


def test_instance_attaches_the_ssd_tier(tmp_path, monkeypatch):
    from velox_tpu_torch.common import flags as F
    monkeypatch.setattr(DataCache, "_instance", None)
    try:
        F.set_flag("ssd_cache_dir", str(tmp_path / "flag"))
        cache = DataCache.instance()
        assert isinstance(cache._ssd, SsdTier)
        assert cache._ssd.dir == str(tmp_path / "flag")
    finally:
        F.reset_flag("ssd_cache_dir")


# ---- the Values ingest cache ----------------------------------------------

def _values_plan(mod, t):
    return mod().values([t]).filter("k < 25").plan()


def test_ingest_cache_hits_and_reserves_in_the_device_root():
    t = _table(5)
    root = MemoryPool.device_root()
    base = root.used
    hits = _counter(M, M.K_VALUES_INGEST_HITS)
    first = Task(_values_plan(PlanBuilder, t), QueryCtx("cpu")).run()
    cache = IngestCache.instance()
    (n_entries, used) = cache.stats()["entries"], cache.stats()["used"]
    assert n_entries == 1 and used == root.used - base > 0
    second = Task(_values_plan(PlanBuilder, t), QueryCtx("cpu")).run()
    assert second.equals(first)
    assert _counter(M, M.K_VALUES_INGEST_HITS) - hits == 1
    assert root.used - base == used
    # the reference caches the same batch but reserves nothing
    jroot = JMem.MemoryPool.device_root()
    jbase = jroot.used
    JTask(_values_plan(JPlanBuilder, t)).run()
    assert any(v[0] is t for v in JValuesOperator._INGEST_CACHE.values())
    assert jroot.used == jbase
    JValuesOperator._INGEST_CACHE.clear()


def test_ingest_cache_releases_its_bytes_on_reclaim():
    root = MemoryPool.device_root()
    base = root.used
    tables = [_table(i) for i in range(3)]
    for t in tables:
        Task(_values_plan(PlanBuilder, t), QueryCtx("cpu")).run()
    cache = IngestCache.instance()
    assert cache.stats()["entries"] == 3
    one = cache.used // 3
    assert cache.reclaim(1) == one  # the least recently used entry
    assert cache.stats()["entries"] == 2 and root.used - base == 2 * one
    hits = _counter(M, M.K_VALUES_INGEST_HITS)
    Task(_values_plan(PlanBuilder, tables[0]), QueryCtx("cpu")).run()
    assert _counter(M, M.K_VALUES_INGEST_HITS) == hits  # it was evicted
    assert cache.reclaim(cache.used) == 3 * one
    assert cache.stats()["entries"] == 0 and root.used == base
    # the arbitrator asks it first, with the scan cache
    arb = MemoryArbitrator.instance()
    assert any(r() is cache and p == arb.PRI_CACHE
               for p, r in arb._reclaimers)


def test_ingest_cache_keeps_at_most_eight_entries():
    root = MemoryPool.device_root()
    base = root.used
    for i in range(10):
        Task(_values_plan(PlanBuilder, _table(i, 100)),
             QueryCtx("cpu")).run()
    cache = IngestCache.instance()
    assert cache.stats()["entries"] == IngestCache.MAX_ENTRIES
    assert root.used - base == cache.used
    cache.clear()
    assert root.used == base and cache.used == 0


def test_capped_root_keeps_the_entry_out():
    t = _table(6)
    root = MemoryPool.device_root()
    nbytes = D.from_arrow(t, device="cpu").nbytes
    used = root.used
    hits = _counter(M, M.K_VALUES_INGEST_HITS)
    try:
        MemoryPool.set_device_cap(root.used + nbytes - 1)
        for _ in range(2):
            got = Task(_values_plan(PlanBuilder, t), QueryCtx("cpu")).run()
            assert got.num_rows > 0
        assert IngestCache.instance().stats()["entries"] == 0
        assert root.used == used
        assert _counter(M, M.K_VALUES_INGEST_HITS) == hits
    finally:
        MemoryPool.set_device_cap(None)


def test_ssd_tier_keeps_a_virtual_dictionary(tmp_path):
    """A customer split's c_name is a virtual dictionary (values formatted
    from ids): the port's SSD tier writes and reads it back; the
    reference's cannot pickle its formatter (ROADMAP C)."""
    from velox_tpu.connectors.tpch import register_tpch as jregister
    from velox_tpu_torch.connectors.tpch import register_tpch
    cols = ["c_custkey", "c_name", "c_phone"]
    conn = register_tpch(0.01)
    split = conn.default_splits("customer")[0]
    b = conn.create_data_source("customer", cols, QueryCtx("cpu")).next(split)
    tier = SsdTier(str(tmp_path / "port"))
    tier.put(("c",), b)
    got = SsdTier(str(tmp_path / "port")).get(("c",))  # after a restart
    assert D.to_arrow(got).equals(D.to_arrow(b))
    jconn = jregister(0.01)
    jb = jconn.create_data_source("customer", cols, JQueryCtx()).next(
        jconn.default_splits("customer")[0])
    assert D.to_arrow(got).equals(JD.to_arrow(jb))
    with pytest.raises((AttributeError, pickle.PicklingError)):
        JC.SsdTier(str(tmp_path / "ref")).put(("c",), jb)

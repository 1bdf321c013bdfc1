"""The port's Hive connector, TableWrite and grouped execution against the
JAX reference, on the CPU.

Counterparts of tests/test_hive.py and tests/test_orc.py: the same files
and plans through both engines, equal rows. TPC-H Q1, Q3, Q6 and Q18 at
SF 0.01 over tables that each engine wrote through its own TableWrite
(lineitem and orders bucketed by their order key, customer partitioned
by c_mktsegment), equal to the reference's rows over its tables and to
the port's rows over the TPC-H connector; GroupedTask over the buckets.
The reference's NULL-partition fault, shown and not copied. The
vectorized ``to_arrow`` against the element-wise form it replaced.
"""

import decimal
import glob
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest
import torch

from velox_tpu.connectors.connector import get_connector as jget_connector
from velox_tpu.connectors.hive import register_hive as jregister_hive
from velox_tpu.connectors.tpch import register_tpch as jregister_tpch
from velox_tpu.exec.task import GroupedTask as JGroupedTask
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import queries as jq
from velox_tpu.tpch import tpch_plan as jtpch_plan
from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.connectors.connector import get_connector
from velox_tpu_torch.connectors.hive import (
    HIVE_DEFAULT_PARTITION, _np_murmur3, register_hive,
)
from velox_tpu_torch.connectors.tpch import register_tpch
from velox_tpu_torch.exec.task import GroupedTask, QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import queries as tq
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.vector import device as D

torch.set_num_threads(1)
CPU = QueryCtx("cpu")


def _both(build, ctx=None):
    """(reference rows, port rows) of one plan built by ``build(builder)``."""
    want = JTask(build(JPlanBuilder)).run()
    got = Task(build(PlanBuilder), ctx or CPU).run()
    return want, got


def _sorted_rows(t, keys):
    return t.sort_by([(k, "ascending") for k in keys]).to_pylist()


def _hive(tag, get, register):
    """The engine's Hive connector ``tag``, registered if it is not."""
    try:
        conn = get(tag)
    except KeyError:
        return register(tag)
    return conn if hasattr(conn, "register_table") else register(tag)


def _register(tag, name, path, **kw):
    """Register ``path`` as ``name`` in a Hive connector of each engine."""
    _hive(tag, jget_connector, jregister_hive).register_table(name, path,
                                                              **kw)
    return _hive(tag, get_connector, register_hive).register_table(
        name, path, **kw)


@pytest.fixture(autouse=True)
def _hive_connectors():
    """A "hive" connector in each engine: TableWrite's default target."""
    _hive("hive", jget_connector, jregister_hive)
    _hive("hive", get_connector, register_hive)


def sample_table(n=5000, seed=5):
    rng = np.random.RandomState(seed)
    return pa.table({
        "k": rng.randint(0, 100, n).astype("int64"),
        "v": rng.randn(n),
        "s": rng.choice(["red", "green", "blue", "cyan"], n),
        "d": pa.array(np.array(rng.randint(8000, 12000, n),
                               dtype="datetime64[D]"), pa.date32()),
    })


# ---------------------------------------------------------------------------
# tests/test_hive.py
# ---------------------------------------------------------------------------

def test_scan_round_trip(tmp_path):
    t = sample_table()
    pq.write_table(t.slice(0, 3000), tmp_path / "part-0.parquet",
                   row_group_size=1000)
    pq.write_table(t.slice(3000), tmp_path / "part-1.parquet",
                   row_group_size=1000)
    table = _register("hive", "t", str(tmp_path))
    assert len(table.splits()) == 5  # 3 + 2 row groups
    want, got = _both(lambda B: B().table_scan(
        "t", ["k", "v", "s"], connector_id="hive").plan())
    assert got.equals(want)
    assert _sorted_rows(got, ["k", "v"]) == _sorted_rows(
        t.select(["k", "v", "s"]), ["k", "v"])


def test_scan_with_filter_and_agg(tmp_path):
    t = sample_table()
    pq.write_table(t, tmp_path / "t.parquet", row_group_size=1024)
    _register("hive", "t2", str(tmp_path / "t.parquet"))
    want, got = _both(lambda B: B().table_scan(
        "t2", ["k", "s"], connector_id="hive", filter="s = 'red'")
        .single_aggregation([], ["count() as n"]).plan())
    assert got.equals(want)
    assert got.column("n")[0].as_py() == pc.sum(
        pc.equal(t.column("s"), "red")).as_py()


def test_table_writer(tmp_path):
    t = sample_table(1000)
    paths = {}

    def build(B):
        paths[B] = str(tmp_path / B.__module__ / "data.parquet")
        return (B().values([t]).filter("k < 50")
                .table_write(paths[B], connector_id="hive").plan())
    jregister_hive("hive")
    register_hive("hive")
    want, got = _both(build)
    n = pc.sum(pc.less(t.column("k"), 50)).as_py()
    assert got.column("rows").to_pylist() == want.column(
        "rows").to_pylist() == [n]
    assert got.column("bytes")[0].as_py() > 0
    back, ref = (pq.read_table(paths[B]) for B in (PlanBuilder,
                                                   JPlanBuilder))
    assert back.num_rows == n and back.equals(ref)


def test_string_dictionary_order(tmp_path):
    """Ordered string comparisons work in dictionary-id space."""
    t = sample_table(2000)
    pq.write_table(t, tmp_path / "t.parquet")
    _register("hive", "t3", str(tmp_path / "t.parquet"))
    want, got = _both(lambda B: B().table_scan(
        "t3", ["s"], connector_id="hive").filter("s > 'cyan'")
        .single_aggregation([], ["count() as n"]).plan())
    assert got.equals(want)
    assert got.column("n")[0].as_py() == pc.sum(
        pc.greater(t.column("s"), "cyan")).as_py()


def _partition_frame(n=200, seed=4):
    rng = np.random.RandomState(seed)
    return pa.table({
        "region": rng.choice(["eu", "us", "ap"], n),
        "year": rng.choice([2023, 2024], n).astype("int64"),
        "v": rng.randint(0, 1000, n).astype("int64"),
    })


def test_partitioned_write_and_read(tmp_path):
    t = _partition_frame()
    roots = {JPlanBuilder: str(tmp_path / "ref"),
             PlanBuilder: str(tmp_path / "port")}
    want, got = _both(lambda B: B().values([t]).table_write(
        roots[B], partition_keys=["region", "year"]).plan())
    assert got.column("rows").to_pylist() == want.column(
        "rows").to_pylist() == [200]
    files = {B: sorted(os.path.relpath(f, r) for f in glob.glob(
        r + "/region=*/year=*/*.parquet")) for B, r in roots.items()}
    assert files[PlanBuilder] == files[JPlanBuilder]
    assert len(files[PlanBuilder]) == 6
    for f in files[PlanBuilder]:
        a = pq.read_table(os.path.join(roots[PlanBuilder], f))
        assert "region" not in a.schema.names
        assert a.equals(pq.read_table(os.path.join(roots[JPlanBuilder], f)))
    jregister_hive("hive-part-test").register_table("sales",
                                                    roots[PlanBuilder])
    register_hive("hive-part-test").register_table("sales",
                                                   roots[PlanBuilder])
    want, got = _both(lambda B: B().table_scan(
        "sales", ["region", "year", "v"],
        connector_id="hive-part-test").plan())
    keys = ["region", "year", "v"]
    assert _sorted_rows(got, keys) == _sorted_rows(want, keys)
    exp = t.set_column(1, "year", pc.cast(t.column("year"), pa.string()))
    assert _sorted_rows(got, keys) == _sorted_rows(exp, keys)


def test_bucketed_write(tmp_path):
    t = pa.table({"k": np.arange(100, dtype="int64"),
                  "v": np.arange(100, dtype="int64")})
    roots = {JPlanBuilder: str(tmp_path / "ref"),
             PlanBuilder: str(tmp_path / "port")}
    _both(lambda B: B().values([t]).table_write(
        roots[B], bucket_count=4, bucket_keys=["k"]).plan())
    files = {B: sorted(glob.glob(r + "/*.parquet"))
             for B, r in roots.items()}
    assert [os.path.basename(f) for f in files[PlanBuilder]] == \
        [os.path.basename(f) for f in files[JPlanBuilder]]
    assert 1 < len(files[PlanBuilder]) <= 4
    for a, b in zip(files[PlanBuilder], files[JPlanBuilder]):
        assert pq.read_table(a).equals(pq.read_table(b))
    assert sum(pq.read_table(f).num_rows for f in files[PlanBuilder]) == 100


def test_murmur3_buckets_equal_reference():
    from velox_tpu.connectors.hive import _np_murmur3 as jmurmur
    rng = np.random.RandomState(9)
    for cols in ([rng.randint(-2**62, 2**62, 1000)],
                 [rng.randint(-2**31, 2**31, 1000).astype(np.int32)],
                 [rng.randint(0, 9, 1000), rng.randint(0, 9, 1000)
                  .astype(np.int32)]):
        assert np.array_equal(_np_murmur3(cols), jmurmur(cols))


def test_row_group_stats_pruning(tmp_path):
    root = tmp_path / "t"
    root.mkdir()
    for i, lo in enumerate((0, 1000, 2000)):
        pq.write_table(pa.table({"x": np.arange(lo, lo + 100,
                                                dtype="int64"),
                                 "v": np.ones(100, dtype="int64")}),
                       str(root / f"f{i}.parquet"))
    _register("hive-prune-test", "t", str(root))
    before = M.reporter().snapshot()["counters"].get(M.K_SPLITS_PRUNED, 0)
    want, got = _both(lambda B: B().table_scan(
        "t", ["x", "v"], connector_id="hive-prune-test",
        filter="x >= 1000 and x < 1050")
        .single_aggregation([], ["count(*) as c", "sum(x) as s"]).plan())
    pruned = M.reporter().snapshot()["counters"].get(
        M.K_SPLITS_PRUNED, 0) - before
    assert got.equals(want)
    assert got.to_pylist() == [{"c": 50, "s": sum(range(1000, 1050))}]
    assert pruned == 2  # files f0 and f2 skipped by stats


def test_partition_pruning_via_stats(tmp_path):
    t = pa.table({"region": ["eu"] * 50 + ["us"] * 50,
                  "v": np.arange(100, dtype="int64")})
    root = str(tmp_path / "p")
    Task(PlanBuilder().values([t]).table_write(
        root, partition_keys=["region"]).plan(), CPU).run()
    _register("hive-prune2-test", "p", root)
    before = M.reporter().snapshot()["counters"].get(M.K_SPLITS_PRUNED, 0)
    want, got = _both(lambda B: B().table_scan(
        "p", ["region", "v"], connector_id="hive-prune2-test",
        filter="region = 'eu'")
        .single_aggregation([], ["count(*) as c"]).plan())
    assert got.equals(want)
    assert got.to_pylist() == [{"c": 50}]
    assert M.reporter().snapshot()["counters"].get(
        M.K_SPLITS_PRUNED, 0) - before == 1


def test_custom_filesystem_scan(tmp_path):
    """An explicit pyarrow filesystem (a SubTreeFileSystem standing in
    for S3/GCS: the path of FileSystem.from_uri resolution)."""
    from pyarrow import fs as pafs
    (tmp_path / "d").mkdir()
    pq.write_table(pa.table({"x": np.arange(50, dtype="int64")}),
                   str(tmp_path / "d" / "f.parquet"))
    sub = pafs.SubTreeFileSystem(str(tmp_path), pafs.LocalFileSystem())
    _register("hive-fs-test", "t", "d", filesystem=sub)
    want, got = _both(lambda B: B().table_scan(
        "t", ["x"], connector_id="hive-fs-test")
        .single_aggregation([], ["sum(x) as s", "count(*) as c"]).plan())
    assert got.equals(want)
    assert got.to_pylist() == [{"s": sum(range(50)), "c": 50}]


def test_unreachable_remote_uri_raises():
    for register in (jregister_hive, register_hive):
        with pytest.raises(ValueError, match="cannot open"):
            register("hive-bad-uri").register_table(
                "t", "badscheme://bucket/path")


def test_grouped_execution(tmp_path):
    """GroupedTask over a bucketed table: one Task per bucket, the same
    rows as one run over the whole table (velox Task.h:151)."""
    rng = np.random.RandomState(7)
    t = pa.table({"k": rng.randint(0, 40, 400).astype("int64"),
                  "v": rng.randint(0, 100, 400).astype("int64")})
    root = str(tmp_path / "bt")
    Task(PlanBuilder().values([t]).table_write(
        root, bucket_count=4, bucket_keys=["k"]).plan(), CPU).run()
    _register("hive-grouped-test", "t", root)

    def build(B):
        return (B().table_scan("t", ["k", "v"],
                               connector_id="hive-grouped-test")
                .single_aggregation(["k"], ["sum(v) as s",
                                            "count(*) as c"]).plan())
    jgt = JGroupedTask(build(JPlanBuilder))
    gt = GroupedTask(build(PlanBuilder), CPU)
    before = M.reporter().snapshot()["counters"].get(
        M.K_GROUPED_EXECUTIONS, 0)
    got, want = gt.run(), jgt.run()
    assert gt.n_groups == jgt.n_groups == 4
    assert len(gt.group_tasks) == 4
    assert all(task.ctx.device == CPU.device for task in gt.group_tasks)
    assert M.reporter().snapshot()["counters"].get(
        M.K_GROUPED_EXECUTIONS, 0) == before + 1
    assert _sorted_rows(got, ["k"]) == _sorted_rows(want, ["k"])
    whole = Task(build(PlanBuilder), CPU).run()
    assert _sorted_rows(got, ["k"]) == _sorted_rows(whole, ["k"])


def test_grouped_execution_join_with_mixed_scan(tmp_path):
    """Bucketed probe side + unbucketed (broadcast) build side."""
    probe = pa.table({"k": np.arange(100, dtype="int64") % 10,
                      "v": np.arange(100, dtype="int64")})
    dim = pa.table({"dk": np.arange(10, dtype="int64"),
                    "name": np.arange(10, dtype="int64") * 1000})
    proot, droot = str(tmp_path / "p"), str(tmp_path / "d")
    Task(PlanBuilder().values([probe]).table_write(
        proot, bucket_count=3, bucket_keys=["k"]).plan(), CPU).run()
    Task(PlanBuilder().values([dim]).table_write(
        droot + "/f.parquet").plan(), CPU).run()
    _register("hive-grouped-join", "probe", proot)
    _register("hive-grouped-join", "dim", droot)

    def build(B):
        b = B()
        bb = b.new_builder().table_scan("dim", ["dk", "name"],
                                        connector_id="hive-grouped-join")
        return (b.table_scan("probe", ["k", "v"],
                             connector_id="hive-grouped-join")
                .hash_join(["k"], ["dk"], bb, output=["k", "v", "name"])
                .plan())
    got = GroupedTask(build(PlanBuilder), CPU).run()
    want = JGroupedTask(build(JPlanBuilder)).run()
    keys = ["k", "v", "name"]
    assert _sorted_rows(got, keys) == _sorted_rows(want, keys)
    assert got.num_rows == 100
    assert sum(got.column("name").to_pylist()) == sum(
        (i % 10) * 1000 for i in range(100))


def test_lazy_per_column_dictionaries(tmp_path):
    """A scan of numeric columns never pays the distinct pass of a string
    column; a scan that needs `seg` builds only `seg`."""
    n = 5000
    t = pa.table({"k": np.arange(n, dtype="int64"),
                  "comment": [f"unique comment number {i}" for i in range(n)],
                  "seg": [f"s{i % 3}" for i in range(n)]})
    path = str(tmp_path / "t.parquet")
    Task(PlanBuilder().values([t]).table_write(path).plan(), CPU).run()
    table = _register("hive-lazydict", "t", path)
    want, got = _both(lambda B: B().table_scan(
        "t", ["k"], connector_id="hive-lazydict")
        .single_aggregation([], ["sum(k) as s"]).plan())
    assert got.equals(want)
    assert got.column("s")[0].as_py() == n * (n - 1) // 2
    assert "comment" not in (table._dictionaries or {})
    want, got = _both(lambda B: B().table_scan(
        "t", ["k", "seg"], connector_id="hive-lazydict")
        .single_aggregation(["seg"], ["count() as c"]).plan())
    assert _sorted_rows(got, ["seg"]) == _sorted_rows(want, ["seg"])
    assert got.num_rows == 3
    assert "seg" in table._dictionaries
    assert "comment" not in table._dictionaries


# ---------------------------------------------------------------------------
# tests/test_orc.py
# ---------------------------------------------------------------------------

def orc_table(n=4000, seed=11):
    rng = np.random.RandomState(seed)
    return pa.table({
        "k": rng.randint(0, 64, n).astype("int64"),
        "v": rng.randn(n),
        "s": rng.choice(["red", "green", "blue"], n),
    })


def test_orc_scan_round_trip(tmp_path):
    t = orc_table()
    orc.write_table(t.slice(0, 2500), str(tmp_path / "a.orc"),
                    stripe_size=16 << 10)
    orc.write_table(t.slice(2500), str(tmp_path / "b.orc"),
                    stripe_size=16 << 10)
    table = _register("hive", "o1", str(tmp_path))
    assert len(table.splits()) > 2  # several stripes across two files
    want, got = _both(lambda B: B().table_scan(
        "o1", ["k", "v", "s"], connector_id="hive").plan())
    assert got.equals(want)
    assert _sorted_rows(got, ["k", "v"]) == _sorted_rows(t, ["k", "v"])


def test_orc_filter_agg(tmp_path):
    t = orc_table(3000)
    orc.write_table(t, str(tmp_path / "t.orc"))
    _register("hive", "o2", str(tmp_path / "t.orc"))
    want, got = _both(lambda B: B().table_scan(
        "o2", ["k", "s"], connector_id="hive", filter="s = 'red'")
        .single_aggregation([], ["count() as n", "sum(k) as sk"]).plan())
    assert got.equals(want)
    red = pc.equal(t.column("s"), "red")
    assert got.to_pylist() == [{
        "n": pc.sum(red).as_py(),
        "sk": pc.sum(pc.filter(t.column("k"), red)).as_py()}]


def test_orc_table_writer(tmp_path):
    t = orc_table(1200)
    paths = {B: str(tmp_path / B.__module__ / "data.orc")
             for B in (JPlanBuilder, PlanBuilder)}
    jregister_hive("hive")
    register_hive("hive")
    want, got = _both(lambda B: B().values([t]).filter("k < 32")
                      .table_write(paths[B], connector_id="hive").plan())
    n = pc.sum(pc.less(t.column("k"), 32)).as_py()
    assert got.column("rows").to_pylist() == want.column(
        "rows").to_pylist() == [n]
    back = orc.ORCFile(paths[PlanBuilder]).read()
    assert back.equals(orc.ORCFile(paths[JPlanBuilder]).read())
    assert back.num_rows == n


def test_mixed_format_table(tmp_path):
    """One table over a Parquet file and an ORC file."""
    t = orc_table(2000)
    pq.write_table(t.slice(0, 1000), tmp_path / "p.parquet")
    orc.write_table(t.slice(1000), str(tmp_path / "q.orc"))
    _register("hive", "m1", str(tmp_path))
    want, got = _both(lambda B: B().table_scan(
        "m1", ["k"], connector_id="hive")
        .single_aggregation([], ["count() as n", "sum(k) as sk"]).plan())
    assert got.equals(want)
    assert got.to_pylist() == [{"n": 2000,
                                "sk": pc.sum(t.column("k")).as_py()}]


def test_orc_split_pruning_conservative(tmp_path):
    """ORC exposes no stripe stats through pyarrow: a pushed-down filter
    keeps every ORC split."""
    from velox_tpu_torch.parse.parser import parse_expression
    orc.write_table(pa.table({"k": np.arange(1000, dtype="int64")}),
                    str(tmp_path / "t.orc"), stripe_size=4 << 10)
    table = _register("hive", "o3", str(tmp_path / "t.orc"))
    conn = register_hive("hive")
    conn._tables["o3"] = table
    kept = conn.prune_splits("o3", table.splits(),
                             parse_expression("k >= 900", table.row_type))
    assert len(kept) == len(table.splits())
    jregister_hive("hive").register_table("o3", str(tmp_path / "t.orc"))
    want, got = _both(lambda B: B().table_scan(
        "o3", ["k"], connector_id="hive", filter="k >= 900")
        .single_aggregation([], ["count() as n"]).plan())
    assert got.equals(want)
    assert got.to_pylist() == [{"n": 100}]


def test_orc_partitioned_write_and_scan(tmp_path):
    t = pa.table({"region": ["eu", "us", "eu", "ap"] * 50,
                  "v": np.arange(200, dtype="int64")})
    root = str(tmp_path / "sales_orc")
    Task(PlanBuilder().values([t]).table_write(
        root, partition_keys=["region"], file_format="orc").plan(),
        CPU).run()
    assert len(glob.glob(root + "/region=*/part-0.orc")) == 3
    _register("hive", "sales_orc", root)
    want, got = _both(lambda B: B().table_scan(
        "sales_orc", ["region", "v"], connector_id="hive",
        filter="region = 'eu'")
        .single_aggregation([], ["sum(v) as sv"]).plan())
    assert got.equals(want)
    assert got.to_pylist() == [{"sv": sum(v for i, v in enumerate(
        range(200)) if i % 2 == 0)}]


def test_fsspec_memory_filesystem_scan():
    """A non-local filesystem: pyarrow's PyFileSystem over fsspec's
    in-memory one (the storage adapters' code path, no credentials)."""
    import fsspec
    from pyarrow.fs import FSSpecHandler, PyFileSystem
    mem = fsspec.filesystem("memory")
    fs = PyFileSystem(FSSpecHandler(mem))
    t = orc_table(1500)
    buf = pa.BufferOutputStream()
    pq.write_table(t.slice(0, 700), buf)
    mem.pipe_file("/bucket/t/a.parquet", buf.getvalue().to_pybytes())
    buf = pa.BufferOutputStream()
    orc.write_table(t.slice(700), buf)
    mem.pipe_file("/bucket/t/b.orc", buf.getvalue().to_pybytes())
    _register("hive", "remote_t", "/bucket/t", filesystem=fs)
    want, got = _both(lambda B: B().table_scan(
        "remote_t", ["k", "v"], connector_id="hive")
        .single_aggregation([], ["count() as n"]).plan())
    assert got.equals(want)
    assert got.to_pylist() == [{"n": 1500}]


# ---------------------------------------------------------------------------
# The reference's NULL-partition fault (ROADMAP C)
# ---------------------------------------------------------------------------

def test_null_partition_values_read_back(tmp_path):
    """A NULL partition value writes under __HIVE_DEFAULT_PARTITION__ and
    reads back NULL; BIGINT keys read back as their integer text. The
    reference writes `k=nan` (read back as 'nan') and `k=1.0`."""
    t = pa.table({"s": pa.array(["a", None, "b", None]),
                  "k": pa.array([1, None, 3, None], pa.int64()),
                  "v": pa.array([10, 20, 30, 40], pa.int64())})
    roots = {JPlanBuilder: str(tmp_path / "ref"),
             PlanBuilder: str(tmp_path / "port")}
    for key in ("s", "k"):
        for B, r in roots.items():
            plan = B().values([t.select([key, "v"])]).table_write(
                os.path.join(r, key), partition_keys=[key]).plan()
            (JTask(plan) if B is JPlanBuilder else Task(plan, CPU)).run()
        dirs = {B: sorted(os.listdir(os.path.join(r, key)))
                for B, r in roots.items()}
        exp = {"s": ["s=a", "s=b"], "k": ["k=1", "k=3"]}[key]
        assert dirs[PlanBuilder] == sorted(
            exp + [f"{key}={HIVE_DEFAULT_PARTITION}"])
        assert dirs[JPlanBuilder] == (["s=a", "s=b", "s=nan"] if key == "s"
                                      else ["k=1.0", "k=3.0", "k=nan"])
        tag = f"hive-null-{key}"
        jregister_hive(tag).register_table(
            "t", os.path.join(roots[JPlanBuilder], key))
        register_hive(tag).register_table(
            "t", os.path.join(roots[PlanBuilder], key))
        want, got = _both(lambda B: B().table_scan(
            "t", [key, "v"], connector_id=tag).plan())
        rows = _sorted_rows(got, ["v"])
        text = [None if x is None else str(x)
                for x in t.column(key).to_pylist()]
        assert rows == [{key: x, "v": v} for x, v in zip(
            text, [10, 20, 30, 40])]
        # the reference's answer: NULL comes back as 'nan', 1 as '1.0'
        ref = [r[key] for r in _sorted_rows(want, ["v"])]
        assert ref == (["a", "nan", "b", "nan"] if key == "s"
                       else ["1.0", "nan", "3.0", "nan"])


def test_partition_groups_keep_input_order(tmp_path):
    """Each partition's file holds its rows in input order (pandas'
    groupby order in the reference), the groups sorted, NULL last."""
    rng = np.random.RandomState(3)
    n = 300
    t = pa.table({"g": pa.array(rng.choice(["x", "y", "z"], n),
                                mask=rng.rand(n) < 0.2),
                  "v": np.arange(n, dtype="int64")})
    root = str(tmp_path / "p")
    op = Task(PlanBuilder().values([t]).table_write(
        root, partition_keys=["g"]).plan(), CPU)
    op.run()
    sink = next(o.sink for o in op.operators if hasattr(o, "sink"))
    assert [os.path.basename(os.path.dirname(f))
            for f in sink.files_written] == [
        "g=x", "g=y", "g=z", f"g={HIVE_DEFAULT_PARTITION}"]
    g = t.column("g").to_pylist()
    for f in sink.files_written:
        val = os.path.basename(os.path.dirname(f)).split("=", 1)[1]
        val = None if val == HIVE_DEFAULT_PARTITION else val
        assert pq.read_table(f).column("v").to_pylist() == [
            i for i in range(n) if g[i] == val]
    assert set(sink.seconds) == {"to_arrow", "bucketing", "write"}


# ---------------------------------------------------------------------------
# TPC-H over Hive at SF 0.01
# ---------------------------------------------------------------------------

LINEITEM = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount",
            "l_tax", "l_returnflag", "l_linestatus", "l_shipdate"]
ORDERS = ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
          "o_totalprice"]
CUSTOMER = ["c_custkey", "c_name", "c_mktsegment"]


def _write_tpch(B, run, root):
    """lineitem and orders bucketed by order key into 4, customer
    partitioned by c_mktsegment, written through ``B``'s TableWrite."""
    outs = []
    for table, cols, kw in (
            ("lineitem", LINEITEM, dict(bucket_count=4,
                                        bucket_keys=["l_orderkey"])),
            ("orders", ORDERS, dict(bucket_count=4,
                                    bucket_keys=["o_orderkey"])),
            ("customer", CUSTOMER, dict(partition_keys=["c_mktsegment"]))):
        outs.append(run(B().table_scan(table, cols).table_write(
            os.path.join(root, table), **kw).plan()))
    return outs


@pytest.fixture(scope="module")
def tpch_hive(tmp_path_factory):
    root = tmp_path_factory.mktemp("tpch_hive")
    jregister_tpch(0.01)
    conn = register_tpch(0.01)
    jregister_hive("hive-tpch")
    register_hive("hive-tpch")
    jout = _write_tpch(JPlanBuilder, lambda p: JTask(p).run(),
                       str(root / "ref"))
    out = _write_tpch(PlanBuilder, lambda p: Task(p, CPU).run(),
                      str(root / "port"))
    jconn, tconn = jregister_hive("hive-tpch"), register_hive("hive-tpch")
    for t in ("lineitem", "orders", "customer"):
        jconn.register_table(t, str(root / "ref" / t))
        tconn.register_table(t, str(root / "port" / t))
    return conn, root, jout, out


def test_tpch_write_summaries_and_schemas(tpch_hive):
    conn, root, jout, out = tpch_hive
    counts = [conn.gen.num_rows(t) for t in ("lineitem", "orders",
                                             "customer")]
    assert [o.column("rows")[0].as_py() for o in out] == counts
    assert [o.column("rows")[0].as_py() for o in jout] == counts
    for t, n_files in (("lineitem", 4), ("orders", 4)):
        files = sorted(glob.glob(str(root / "port" / t / "*.parquet")))
        assert [os.path.basename(f) for f in files] == [
            f"{b:05d}_0_part.parquet" for b in range(n_files)]
        schema = pq.read_schema(files[0])
        want = {"lineitem": LINEITEM, "orders": ORDERS}[t]
        assert schema.names == want
        # every column in its declared type, whatever its storage width
        from velox_tpu_torch.connectors.tpch import TPCH_SCHEMAS
        for f in schema:
            assert f.type == T.to_arrow(TPCH_SCHEMAS[t].field_type(f.name))
        # the same rows in each bucket as the reference's
        ref = pq.read_table(str(root / "ref" / t / os.path.basename(
            files[0])))
        got = pq.read_table(files[0])
        assert got.column(want[0]).to_pylist() == \
            ref.column(want[0]).to_pylist()
    parts = sorted(os.listdir(root / "port" / "customer"))
    assert parts == sorted(os.listdir(root / "ref" / "customer"))
    assert len(parts) == 5
    back = pq.read_table(str(root / "port" / "customer" / parts[0]))
    assert back.schema.names == ["c_custkey", "c_name"]
    assert back.column("c_name")[0].as_py().startswith("Customer#")


def _hive_plan(q, mod, cid):
    if q == 18:
        return mod.q18(cid, threshold=200.0)
    return (jtpch_plan if mod is jq else tpch_plan)(q, connector_id=cid)


@pytest.mark.parametrize("q", [1, 3, 6, 18])
def test_tpch_over_hive(tpch_hive, q):
    """Each query over the port's Hive tables equals the reference's over
    its own, and the port's over the TPC-H connector."""
    want = JTask(_hive_plan(q, jq, "hive-tpch")).run()
    got = Task(_hive_plan(q, tq, "hive-tpch"), CPU).run()
    direct = Task(_hive_plan(q, tq, "tpch"), CPU).run()
    assert got.num_rows > 0
    assert got.equals(direct)
    assert got.to_pylist() == want.cast(got.schema).to_pylist()


def test_tpch_joins_over_hive_take_array_mode(tpch_hive):
    """The Hive connector has no column stats: Q3's and Q18's four hash
    joins take array mode from their builds' own key ranges, none the
    merge-rank, and the answers equal the reference's."""
    keys = (M.K_JOIN_ARRAY_MODE_BUILDS, M.K_JOIN_OBSERVED_RANGE_BUILDS,
            M.K_JOIN_MERGE_RANK_BUILDS)

    def counts():
        c = M.reporter().snapshot()["counters"]
        return [c.get(k, 0) for k in keys]
    before = counts()
    for q in (3, 18):
        want = JTask(_hive_plan(q, jq, "hive-tpch")).run()
        got = Task(_hive_plan(q, tq, "hive-tpch"), CPU).run()
        assert got.num_rows > 0
        assert got.to_pylist() == want.cast(got.schema).to_pylist()
    assert [a - b for a, b in zip(counts(), before)] == [4, 4, 0]


def test_tpch_q3_prunes_customer_partitions(tpch_hive):
    before = M.reporter().snapshot()["counters"].get(M.K_SPLITS_PRUNED, 0)
    Task(_hive_plan(3, tq, "hive-tpch"), CPU).run()
    assert M.reporter().snapshot()["counters"].get(
        M.K_SPLITS_PRUNED, 0) - before == 4


def test_tpch_q6_over_hive_takes_no_filter_sum(tpch_hive):
    before = M.reporter().snapshot()["counters"].get(
        M.K_FILTER_SUM_KERNEL, 0)
    Task(tpch_plan(6, connector_id="hive-tpch"), CPU).run()
    assert M.reporter().snapshot()["counters"].get(
        M.K_FILTER_SUM_KERNEL, 0) == before


def test_grouped_q18_over_buckets(tpch_hive):
    """Q18's inner plan at threshold 200 run per bucket equals the
    ungrouped plan: 854 rows in both engines."""
    def inner(mod, B):
        b = B()
        orders = b.new_builder().table_scan(
            "orders", ["o_orderkey", "o_custkey", "o_totalprice"],
            connector_id="hive-tpch")
        return (b.table_scan("lineitem", ["l_orderkey", "l_quantity"],
                             connector_id="hive-tpch")
                .single_aggregation(["l_orderkey"],
                                    ["sum(l_quantity) as s"])
                .filter("s > 200.0")
                .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                           output=["l_orderkey", "o_custkey",
                                   "o_totalprice", "s"]).plan())
    gt = GroupedTask(inner(tq, PlanBuilder), CPU)
    got = gt.run()
    want = JGroupedTask(inner(jq, JPlanBuilder)).run()
    whole = Task(inner(tq, PlanBuilder), CPU).run()
    keys = ["l_orderkey"]
    assert gt.n_groups == 4
    assert got.num_rows == whole.num_rows == 854
    assert _sorted_rows(got, keys) == _sorted_rows(whole, keys)
    assert _sorted_rows(got, keys) == _sorted_rows(
        want.cast(got.schema), keys)


# ---------------------------------------------------------------------------
# to_arrow: the vectorized form against the element-wise one
# ---------------------------------------------------------------------------

def _elementwise(col, rows):
    """The element-wise to_arrow of a 1-D column that this PR replaced:
    one Python Decimal per value, one Python string per dictionary row."""
    data = col.data.numpy()[rows]
    valid = None if col.validity is None else col.validity.numpy()[rows]
    ok = np.ones(len(data), bool) if valid is None else valid
    dt = col.dtype
    if dt.is_string:
        out = col.dictionary.take(data)
        out = [None if not v else x for x, v in zip(out, ok)]
        return pa.array(out, type=T.to_arrow(dt))
    if dt.kind is T.TypeKind.DECIMAL:
        ints = [int(x) for x in data]
        if dt.is_long_decimal:
            hi = col.children[0].data.numpy()[rows]
            ints = [(int(h) << 64) | (int(x) & ((1 << 64) - 1))
                    for x, h in zip(data, hi)]
        with decimal.localcontext() as c:
            c.prec = 50
            vals = [None if not v else decimal.Decimal(x).scaleb(-dt.scale)
                    for x, v in zip(ints, ok)]
        return pa.array(vals, type=T.to_arrow(dt))
    raise TypeError(dt)


def _column(data, dt, validity=None, children=(), dictionary=None):
    return D.DeviceColumn(torch.as_tensor(data),
                          None if validity is None
                          else torch.as_tensor(validity), dt, dictionary,
                          children)


@pytest.mark.parametrize("scale", list(range(19)))
def test_to_arrow_short_decimals(scale):
    rng = np.random.RandomState(scale)
    n = 300
    dt = T.decimal(18, scale)
    data = rng.randint(-10**17, 10**17, n).astype(np.int64)
    data[:4] = [0, -1, 10**18 - 1, -(10**18 - 1)]
    valid = rng.rand(n) > 0.2
    rows = np.flatnonzero(rng.rand(n) > 0.3)
    for v in (None, valid):
        col = _column(data, dt, v)
        got = D._column_to_arrow(col, rows)
        assert got.type == pa.decimal128(18, scale)
        assert got.equals(_elementwise(col, rows))


def test_to_arrow_int32_narrowed_decimals():
    rng = np.random.RandomState(1)
    data = rng.randint(-2**31, 2**31, 500).astype(np.int32)
    valid = rng.rand(500) > 0.1
    col = _column(data, T.decimal(12, 2), valid)
    rows = np.arange(500)
    assert D._column_to_arrow(col, rows).equals(_elementwise(col, rows))


def test_to_arrow_long_decimals_at_the_limits():
    big = 10**38 - 1
    vals = [big, -big, 0, -1, 1, 2**64, -(2**64) - 5, 2**63, None]
    lo = np.array([(0 if v is None else v) & ((1 << 64) - 1)
                   for v in vals], dtype=np.uint64).view(np.int64)
    hi = np.array([0 if v is None else v >> 64 for v in vals],
                  dtype=np.int64)
    valid = np.array([v is not None for v in vals])
    dt = T.decimal(38, 0)
    col = _column(lo, dt, valid,
                  (D.DeviceColumn(torch.as_tensor(hi), None, T.BIGINT),))
    rows = np.arange(len(vals))
    got = D._column_to_arrow(col, rows)
    assert got.equals(_elementwise(col, rows))
    assert got.to_pylist()[:2] == [decimal.Decimal(big), decimal.Decimal(-big)]
    assert got.to_pylist()[-1] is None


def test_to_arrow_dictionary_strings_with_nulls():
    rng = np.random.RandomState(2)
    d = D.Dictionary(["", "apple", "fig", "kiwi"])
    ids = rng.randint(0, 4, 400).astype(np.int32)
    valid = rng.rand(400) > 0.25
    rows = np.flatnonzero(rng.rand(400) > 0.5)
    for v in (None, valid):
        col = _column(ids, T.VARCHAR, v, dictionary=d)
        got = D._column_to_arrow(col, rows)
        assert got.type == pa.string()
        assert got.equals(_elementwise(col, rows))


def test_to_arrow_virtual_dictionaries_build_no_row_strings():
    conn = register_tpch(0.01)
    dicts = conn.gen.dictionaries("customer")
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 1501, 300).astype(np.int32)
    valid = rng.rand(300) > 0.1
    for name in ("c_name", "c_phone"):
        col = _column(ids, T.VARCHAR, valid, dictionary=dicts[name])
        rows = np.arange(300)
        assert D._column_to_arrow(col, rows).equals(_elementwise(col, rows))


def test_to_arrow_declared_types_and_joined_rows():
    """Columns come out in their declared Arrow types (a BIGINT stored as
    int32 as int64), rows a join gathered included, equal to the
    reference's values."""
    jregister_tpch(0.01)
    register_tpch(0.01)

    def build(B):
        b = B()
        orders = b.new_builder().table_scan(
            "orders", ["o_orderkey", "o_totalprice", "o_orderpriority"])
        return (b.table_scan("lineitem", ["l_orderkey", "l_quantity",
                                          "l_shipmode"])
                .filter("l_quantity < 5.0")
                .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                           output=["l_orderkey", "l_quantity", "l_shipmode",
                                   "o_totalprice", "o_orderpriority"])
                .plan())
    plan = build(PlanBuilder)
    want = JTask(build(JPlanBuilder)).run()
    got = Task(plan, CPU).run()
    assert [f.type for f in got.schema] == [
        T.to_arrow(t) for t in plan.output_type().children]
    assert got.num_rows == want.num_rows > 0
    keys = ["l_orderkey", "l_quantity", "l_shipmode"]
    assert _sorted_rows(got, keys) == _sorted_rows(want.cast(got.schema),
                                                   keys)

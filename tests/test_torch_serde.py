"""The port's serializers, plan JSON serde, Substrait ingestion and
emission, and the expression fuzzer against the JAX reference, on the
CPU.

Counterparts of tests/test_serde_substrait.py (every case) and of the
page, UnsafeRow and CompactRow tests of tests/test_memory_serde.py,
golden bytes included: the same inputs through both packages, equal
bytes, plans and rows.
"""

import decimal
import struct
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu import types as JT
from velox_tpu.connectors.connector import (
    register_connector as jregister_connector,
)
from velox_tpu.connectors.tpch import TpchConnector as JTpchConnector
from velox_tpu.connectors.tpch import register_tpch as jregister_tpch
from velox_tpu.core.serde import plan_to_json as jplan_to_json
from velox_tpu.exec.task import Task as JTask
from velox_tpu.serializers import compactrow as jcompactrow
from velox_tpu.serializers import serialize_page as jserialize_page
from velox_tpu.serializers import unsaferow as junsaferow
from velox_tpu.substrait import from_substrait as jfrom_substrait
from velox_tpu.substrait.emit import to_substrait as jto_substrait
from velox_tpu.testing.fuzzer import VectorFuzzer as JVectorFuzzer
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import tpch_plan as jtpch_plan
from velox_tpu_torch import types as T
from velox_tpu_torch.connectors.connector import register_connector
from velox_tpu_torch.connectors.tpch import TpchConnector, register_tpch
from velox_tpu_torch.core.serde import plan_from_json, plan_to_json
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.serializers import (
    PageSerde, deserialize_page, serialize_page,
)
from velox_tpu_torch.serializers import compactrow, unsaferow
from velox_tpu_torch.serializers.pages import available_codec
from velox_tpu_torch.substrait import from_substrait
from velox_tpu_torch.substrait.emit import to_substrait
from velox_tpu_torch.testing.fuzzer import (
    AggregationFuzzer, ExpressionFuzzer, VectorFuzzer,
)
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.vector.device import from_arrow, to_arrow

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_serde_substrait import (  # noqa: E402
    _dec_lit, _fn, _read, _root, _sel, substrait_q6,
)

torch.set_num_threads(1)
CPU = QueryCtx("cpu")


@pytest.fixture(scope="module")
def conn():
    jregister_tpch(0.01)
    return register_tpch(0.01)


def _equal_rows(got, want):
    assert got.num_rows == want.num_rows
    assert got.to_pylist() == want.cast(got.schema).to_pylist()


# ---------------------------------------------------------------------------
# tests/test_memory_serde.py: pages, UnsafeRow, CompactRow
# ---------------------------------------------------------------------------

def _page_table():
    return pa.table({"a": np.arange(1000, dtype="int64"),
                     "s": np.random.RandomState(0).choice(["x", "y", "z"],
                                                          1000)})


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_page_round_trip(codec):
    t = _page_table()
    buf = serialize_page(t, codec)
    assert buf == jserialize_page(t, codec)
    assert deserialize_page(buf).equals(t)


def test_page_checksum_failure_detected():
    buf = bytearray(serialize_page(_page_table(), "zlib"))
    buf[40] ^= 0xFF
    with pytest.raises(IOError, match="checksum"):
        deserialize_page(bytes(buf))


def test_available_codec_falls_back_to_zlib():
    from velox_tpu.serializers.pages import available_codec as javailable
    assert available_codec("zstd") == javailable("zstd")
    assert available_codec("zstd") in ("zstd", "lz4", "zlib")


def test_page_serde_device_batch():
    t = pa.table({"a": np.arange(100, dtype="int64"),
                  "d": pa.array([None, decimal.Decimal("1.50")] * 50,
                                pa.decimal128(12, 2))})
    serde = PageSerde("zlib", device="cpu")
    b = from_arrow(t, device="cpu")
    back = serde.deserialize(serde.serialize(b))
    assert back.device == torch.device("cpu")
    assert to_arrow(back).equals(to_arrow(b))
    assert np.array_equal(back.columns["a"].data.numpy()[:100],
                          np.arange(100))


def _unsafe_table():
    rng = np.random.RandomState(3)
    a = rng.randint(-1000, 1000, 50).astype("int64")
    return pa.table({
        "a": pa.array(a, mask=rng.rand(50) < 0.2),
        "b": rng.randn(50),
        "s": rng.choice(["hello", "world", "x", ""], 50),
        "f": rng.rand(50) > 0.5,
    })


@pytest.mark.parametrize("mod,jmod", [(unsaferow, junsaferow),
                                      (compactrow, jcompactrow)])
def test_row_formats_round_trip(mod, jmod):
    t = _unsafe_table()
    rt = T.row(t.schema.names, [T.from_arrow(f.type) for f in t.schema])
    jrt = JT.row(t.schema.names, [JT.from_arrow(f.type) for f in t.schema])
    buf = mod.serialize_rows(t)
    assert buf == jmod.serialize_rows(t)
    back = mod.deserialize_rows(buf, rt)
    assert back.equals(jmod.deserialize_rows(buf, jrt))
    assert back.num_rows == 50
    for c in ("a", "b", "s", "f"):
        assert back.column(c).to_pylist() == t.column(c).to_pylist()


def test_compactrow_round_trip_with_null_strings():
    rng = np.random.RandomState(5)
    t = pa.table({
        "a": rng.randint(-100, 100, 40).astype("int32"),
        "b": rng.randn(40),
        "s": pa.array(rng.choice(["aa", "", "zzz"], 40),
                      mask=rng.rand(40) < 0.25),
    })
    rt = T.row(t.schema.names, [T.from_arrow(f.type) for f in t.schema])
    buf = compactrow.serialize_rows(t)
    assert buf == jcompactrow.serialize_rows(t)
    back = compactrow.deserialize_rows(buf, rt)
    for c in t.schema.names:
        assert back.column(c).to_pylist() == t.column(c).to_pylist()
    # the compact layout beats UnsafeRow on size
    assert len(buf) < len(unsaferow.serialize_rows(t))


def test_unsaferow_golden_bytes():
    """Spark/Gluten wire layout (UnsafeRowFast.cpp:354): a string slot
    packs (offset << 32) | size; REAL is a 4-byte float in the slot's low
    word."""
    t = pa.table({
        "a": pa.array([7], pa.int64()),
        "s": pa.array(["hi"], pa.string()),
        "r": pa.array([1.5], pa.float32()),
    })
    buf = unsaferow.serialize_rows(t)
    assert buf == junsaferow.serialize_rows(t)
    row_size = 8 + 3 * 8 + 8  # nulls + 3 slots + padded "hi"
    assert buf[:4] == struct.pack(">i", row_size)
    row = buf[4:]
    assert row[0:8] == b"\0" * 8
    assert row[8:16] == struct.pack("<q", 7)
    off, size = 8 + 3 * 8, 2
    assert row[16:24] == struct.pack("<q", (off << 32) | size)
    assert row[24:28] == struct.pack("<f", 1.5)
    assert row[28:32] == b"\0" * 4
    assert row[32:34] == b"hi"


# ---------------------------------------------------------------------------
# tests/test_serde_substrait.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1, 3, 6, 18])
def test_plan_json_round_trip(conn, q):
    p = tpch_plan(q)
    text = plan_to_json(p)
    assert text == jplan_to_json(jtpch_plan(q))
    assert plan_from_json(text) == p


def test_serialized_plan_executes(conn):
    p2 = plan_from_json(plan_to_json(tpch_plan(6)))
    got = Task(p2, CPU).run()
    assert got.equals(Task(tpch_plan(6), CPU).run())
    _equal_rows(got, JTask(jtpch_plan(6)).run())


def test_substrait_q6_executes(conn):
    got = Task(from_substrait(substrait_q6()), CPU).run()
    _equal_rows(got, Task(tpch_plan(6), CPU).run())
    _equal_rows(got, JTask(jfrom_substrait(substrait_q6())).run())


def test_substrait_inner_join_executes(conn):
    exts = [{"extensionFunction": {"functionAnchor": a, "name": n}}
            for a, n in [(1, "and:bool"), (2, "equal:i64_i64"),
                         (3, "lt:dec_dec"), (4, "sum:dec"),
                         (5, "count:")]]
    cond = _fn(1, _fn(2, _sel(0), _sel(2)),
               _fn(3, _sel(1), {"literal": _dec_lit(100, 4, 1)}))
    join = {"join": {
        "left": _read("lineitem", ["l_orderkey", "l_quantity"]),
        "right": _read("orders", ["o_orderkey", "o_totalprice"]),
        "type": "JOIN_TYPE_INNER",
        "expression": cond,
    }}
    agg = {"aggregate": {"input": join, "groupings": [], "measures": [
        {"measure": {"functionReference": 4,
                     "arguments": [{"value": _sel(3)}],
                     "outputType": {"decimal": {"precision": 18,
                                                "scale": 2}}}},
        {"measure": {"functionReference": 5, "arguments": [],
                     "outputType": {"i64": {}}}},
    ]}}
    sp = {"extensions": exts, **_root(agg, ["s", "n"])}
    got = Task(from_substrait(sp), CPU).run()
    _equal_rows(got, JTask(jfrom_substrait(sp)).run())
    b = PlanBuilder()
    orders = b.new_builder().table_scan(
        "orders", ["o_orderkey", "o_totalprice"])
    ref = Task(b.table_scan("lineitem", ["l_orderkey", "l_quantity"])
               .filter("l_quantity < 10.0")
               .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                          output=["o_totalprice"])
               .single_aggregation([], ["sum(o_totalprice) as s",
                                        "count() as n"]).plan(), CPU).run()
    assert got.column(1).to_pylist() == ref.column("n").to_pylist()
    assert ref.column("n")[0].as_py() > 0
    assert got.column(0).to_pylist() == ref.column("s").to_pylist()


def test_substrait_left_join_and_cross(conn):
    exts = [{"extensionFunction": {"functionAnchor": a, "name": n}}
            for a, n in [(2, "equal:i64_i64"), (5, "count:")]]
    join = {"join": {
        "left": _read("orders", ["o_orderkey", "o_custkey"]),
        "right": _read("customer", ["c_custkey"]),
        "type": "JOIN_TYPE_LEFT",
        "expression": _fn(2, _sel(1), _sel(2)),
    }}
    agg = {"aggregate": {"input": join, "groupings": [], "measures": [
        {"measure": {"functionReference": 5, "arguments": [],
                     "outputType": {"i64": {}}}}]}}
    sp = {"extensions": exts, **_root(agg, ["n"])}
    got = Task(from_substrait(sp), CPU).run()
    _equal_rows(got, JTask(jfrom_substrait(sp)).run())
    assert got.column(0).to_pylist() == [15000]
    cross = {"cross": {"left": _read("region", ["r_regionkey"]),
                       "right": _read("nation", ["n_nationkey"])}}
    agg2 = {"aggregate": {"input": cross, "groupings": [], "measures": [
        {"measure": {"functionReference": 5, "arguments": [],
                     "outputType": {"i64": {}}}}]}}
    sp2 = {"extensions": exts, **_root(agg2, ["n"])}
    got2 = Task(from_substrait(sp2), CPU).run()
    assert got2.column(0).to_pylist() == [5 * 25]
    _equal_rows(got2, JTask(jfrom_substrait(sp2)).run())


def test_substrait_window_row_number(conn):
    exts = [{"extensionFunction":
             {"functionAnchor": 9, "name": "row_number:"}}]
    win = {"consistentPartitionWindow": {
        "input": _read("orders", ["o_orderkey", "o_custkey"]),
        "partitionExpressions": [_sel(1)],
        "sorts": [{"expr": _sel(0),
                   "direction": "SORT_DIRECTION_ASC_NULLS_LAST"}],
        "windowFunctions": [{
            "functionReference": 9,
            "boundsType": "BOUNDS_TYPE_ROWS",
            "lowerBound": {"unbounded": {}},
            "upperBound": {"currentRow": {}},
            "outputType": {"i64": {}},
        }],
    }}
    sp = {"extensions": exts,
          **_root(win, ["o_orderkey", "o_custkey", "rn"])}
    got = Task(from_substrait(sp), CPU).run()
    want = JTask(jfrom_substrait(sp)).run()
    keys = [("o_custkey", "ascending"), ("o_orderkey", "ascending")]
    assert got.sort_by(keys).to_pylist() == \
        want.cast(got.schema).sort_by(keys).to_pylist()
    cust = got.column("o_custkey").to_numpy()
    okey = got.column("o_orderkey").to_numpy()
    rn = got.column("rn").to_numpy()
    order = np.lexsort((okey, cust))
    cs, r = cust[order], rn[order]
    starts = np.r_[0, np.flatnonzero(cs[1:] != cs[:-1]) + 1]
    expect = np.arange(len(cs)) - np.repeat(starts, np.diff(
        np.r_[starts, len(cs)])) + 1
    assert np.array_equal(r, expect)


def test_substrait_emit_roundtrip_results():
    """to_substrait -> from_substrait gives the same rows (names are
    positional in Substrait)."""
    jregister_connector(JTpchConnector("tpch-emit", scale_factor=0.002))
    register_connector(TpchConnector("tpch-emit", 0.002))

    def build(B):
        b = B()
        b.table_scan("lineitem", ["l_quantity", "l_extendedprice",
                                  "l_discount", "l_shipdate"],
                     connector_id="tpch-emit")
        b.filter("l_quantity < 24.0")
        b.single_aggregation([], ["sum(l_extendedprice) as s",
                                  "count() as c"])
        return b.plan()
    plan = build(PlanBuilder)
    sp = to_substrait(plan)
    assert sp == jto_substrait(build(JPlanBuilder))
    a = Task(plan, CPU).run()
    c = Task(from_substrait(sp, connector_id="tpch-emit"), CPU).run()
    assert a.column(0).to_pylist() == c.column(0).to_pylist()
    assert a.column(1).to_pylist() == c.column(1).to_pylist()


def test_substrait_emit_join_sort_fetch():
    rng = np.random.RandomState(5)
    left = pa.table({"pk": rng.randint(0, 20, 100).astype("int64"),
                     "pv": rng.randint(0, 9, 100).astype("int64")})
    right = pa.table({"bk": np.arange(15, dtype="int64"),
                      "bv": np.arange(15, dtype="int64") * 10})

    def build(B):
        b = B()
        bb = b.new_builder().values([right])
        b.values([left])
        b.hash_join(["pk"], ["bk"], bb, output=["pk", "pv", "bv"])
        b.order_by(["pk", "pv desc"])
        b.limit(12)
        return b.plan()
    plan = build(PlanBuilder)
    sp = to_substrait(plan)
    a = Task(plan, CPU).run()
    c = Task(from_substrait(sp), CPU).run()
    jc = JTask(jfrom_substrait(jto_substrait(build(JPlanBuilder)))).run()
    assert a.num_rows == c.num_rows == 12
    assert a.column("pk").to_pylist() == c.column(0).to_pylist()
    assert a.column("bv").to_pylist() == c.column(2).to_pylist()
    _equal_rows(c, jc)


def test_substrait_emit_window_roundtrip():
    t = pa.table({"g": pa.array([1, 1, 2], pa.int64()),
                  "x": pa.array([3.0, 1.0, 5.0])})
    plan = (PlanBuilder().values([t])
            .window(["g"], ["x"],
                    ["row_number() as rn", "sum(x) as s"]).plan())
    sp = to_substrait(plan)
    a = Task(plan, CPU).run().sort_by([("g", "ascending"),
                                       ("x", "ascending")])
    b = Task(from_substrait(sp), CPU).run().sort_by(
        [("g", "ascending"), ("x", "ascending")])
    assert a.column("rn").to_pylist() == b.column(b.num_columns - 2) \
        .to_pylist()
    assert a.column("s").to_pylist() == b.column(b.num_columns - 1) \
        .to_pylist()


# ---------------------------------------------------------------------------
# testing/fuzzer.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_vector_fuzzer_tables_equal_reference(seed):
    got, types = VectorFuzzer(seed, null_ratio=0.15).random_table(200, 6)
    want, jtypes = JVectorFuzzer(seed, null_ratio=0.15).random_table(200, 6)
    assert got.equals(want)
    assert [str(t) for t in types.values()] == [
        str(t) for t in jtypes.values()]


def test_expression_fuzzer():
    assert ExpressionFuzzer(seed=3, rows=150, device="cpu").run(25) > 10


def test_aggregation_fuzzer():
    assert AggregationFuzzer(seed=5, rows=300, device="cpu").run(10) == 10

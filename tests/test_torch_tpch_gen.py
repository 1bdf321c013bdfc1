"""TPC-H generator and connector of the torch port against the JAX one.

Both engines must see bit-identical tables: the port carries its own copy
of the generator, builds the native core from its own copy of dbgen.cpp
into its own build directory, and that copy equals the reference's file.
"""

import jax
import numpy as np
import pytest
import torch

from velox_tpu.connectors import tpch as jt
from velox_tpu_torch.connectors import tpch as tt
from velox_tpu_torch.connectors import tpch_native
from velox_tpu_torch.exec.task import QueryCtx

torch.set_num_threads(1)

SF = 0.01


@pytest.fixture(scope="module")
def gens():
    return jt.TpchTableGen(SF), tt.TpchTableGen(SF)


def _gen_all(gen, table):
    n = (gen.num_rows("orders") if table == "lineitem"
         else gen.num_rows(table))
    return gen.generate(table, 0, n, tt.TPCH_SCHEMAS[table].names)


def test_native_generator_builds_from_the_ports_own_source():
    from velox_tpu_torch.native import build
    repo = build.CSRC.parent.parent
    assert build.DBGEN_SOURCE == repo / "velox_tpu_torch" / "native" / \
        "dbgen.cpp"
    # the copy cannot drift from the reference's file unseen
    assert build.DBGEN_SOURCE.read_bytes() == \
        (repo / "velox_tpu" / "native" / "dbgen.cpp").read_bytes()
    assert build.load_dbgen() is not None
    assert any(build.NATIVE_BUILD_DIR.glob("dbgen-*.so"))
    assert tpch_native.lineitem_rows(0, 100) == \
        int(jt.line_count_at(np.arange(100)).sum())


@pytest.mark.parametrize("column", tt.TPCH_SCHEMAS["lineitem"].names)
def test_lineitem_column_is_identical(gens, column):
    jg, tg = gens
    n = jg.num_rows("orders")
    want = jg.gen_lineitem(0, n, [column])[column]
    got = tg.gen_lineitem(0, n, [column])[column]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table", ["orders", "customer", "part", "supplier",
                                   "partsupp", "nation", "region"])
def test_other_tables_are_identical(gens, table):
    jg, tg = gens
    assert tg.num_rows(table) == jg.num_rows(table)
    want, got = _gen_all(jg, table), _gen_all(tg, table)
    for c in want:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


def test_numpy_and_native_lineitem_agree(gens, monkeypatch):
    _, tg = gens
    cols = list(tt.TPCH_SCHEMAS["lineitem"].names)
    native = tg.gen_lineitem(100, 700, cols)
    monkeypatch.setattr(tpch_native, "gen_lineitem", lambda *a: None)
    numpy_only = tg.gen_lineitem(100, 700, cols)
    for c in cols:
        np.testing.assert_array_equal(native[c], numpy_only[c], err_msg=c)


@pytest.mark.parametrize("table", sorted(tt.TPCH_SCHEMAS))
def test_column_stats_are_identical(table):
    jc = jt.TpchConnector("tpch-gen-test", SF)
    tc = tt.TpchConnector("tpch-gen-test", SF)
    for c in tt.TPCH_SCHEMAS[table].names:
        assert tc.column_stats(table, c) == jc.column_stats(table, c), c


@pytest.mark.parametrize("sf", [0.01, 0.05])
@pytest.mark.parametrize("table", ["lineitem", "orders", "nation"])
def test_default_splits_are_identical(sf, table):
    jc = jt.register_tpch(sf, connector_id="tpch-gen-test")
    tc = tt.register_tpch(sf, connector_id="tpch-gen-test")
    assert tc.rows_per_split == jc.rows_per_split
    js, ts = jc.default_splits(table), tc.default_splits(table)
    assert [(s.table, s.lo, s.hi) for s in ts] == \
        [(s.table, s.lo, s.hi) for s in js]


def test_scan_batch_matches_the_reference():
    """Capacity, the int32 narrowing of money columns, the prefix mask and
    the data of a scan batch are the reference's."""
    cols = ["l_shipdate", "l_extendedprice", "l_quantity", "l_discount",
            "l_orderkey", "l_returnflag"]
    jc = jt.register_tpch(0.05, connector_id="tpch-gen-test")
    tc = tt.register_tpch(0.05, connector_id="tpch-gen-test")
    jsrc = jc.create_data_source("lineitem", cols, None)
    tsrc = tc.create_data_source("lineitem", cols, QueryCtx(device="cpu"))
    for js, ts in zip(jc.default_splits("lineitem"),
                      tc.default_splits("lineitem")):
        jb = jax.device_get(jsrc.next(js))
        tb = tsrc.next(ts)
        assert tsrc.next(ts) is None
        assert tb.capacity == jb.capacity
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
        for c in cols:
            want = np.asarray(jb.columns[c].data)
            got = tb.columns[c].data.numpy()
            assert got.dtype == want.dtype, c
            np.testing.assert_array_equal(got, want, err_msg=c)
            assert str(tb.columns[c].dtype) == str(jb.columns[c].dtype)
        assert tb.columns["l_discount"].data.dtype == torch.int32
        assert tb.columns["l_returnflag"].dictionary.values.tolist() == \
            jb.columns["l_returnflag"].dictionary.values.tolist()


@pytest.mark.parametrize("table,column", [("customer", "c_phone"),
                                          ("supplier", "s_phone"),
                                          ("customer", "c_name"),
                                          ("supplier", "s_name"),
                                          ("orders", "o_clerk")])
def test_virtual_dictionary_values_are_the_reference_values(gens, table,
                                                            column):
    """A virtual dictionary's values, formatted from an id array, are the
    reference's value for value (the host passes of substr/like read them),
    and so are take() and id_of()."""
    jd, td = (g.dictionaries(table)[column] for g in gens)
    assert len(td) == len(jd)
    assert list(td.values) == list(jd.values)
    ids = np.arange(0, len(td), 7)
    assert list(td.take(ids)) == list(jd.take(ids))
    for v in list(jd.values[::97]) + ["nope", jd.values[1] + "x"]:
        assert td.id_of(v) == jd.id_of(v), v

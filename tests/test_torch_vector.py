"""Batches of the torch port against the JAX reference's Arrow bridge.

A reference batch is built with ``velox_tpu.vector.device.from_arrow``,
fetched with ``jax.device_get``, rebuilt in the port with
``testing.batches.batch_from_reference`` (over ``batch_from_numpy``) and
converted back with each package's ``to_arrow``: the two Arrow tables must
be equal in values and types. The row utilities of exec/batch_utils.py
get the same treatment.
"""

import decimal

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from velox_tpu.exec import batch_utils as jbu
from velox_tpu.vector import device as jd
from velox_tpu_torch import types as TT
from velox_tpu_torch.exec import batch_utils as tbu
from velox_tpu_torch.testing.batches import batch_from_reference
from velox_tpu_torch.vector import device as td

torch.set_num_threads(1)

N = 700  # rows; the capacity pads to 1024


def _arrow_columns():
    rng = np.random.default_rng(0)
    nulls = rng.random(N) < 0.2
    big = [decimal.Decimal(int(v)).scaleb(-4) * (10 ** 20)
           for v in rng.integers(-10 ** 9, 10 ** 9, N)]
    return {
        "bigint": pa.array(rng.integers(-2 ** 62, 2 ** 62, N),
                           mask=nulls),
        "integer": pa.array(rng.integers(-2 ** 31, 2 ** 31 - 1, N,
                                         dtype=np.int32)),
        "boolean": pa.array(rng.random(N) < 0.5, mask=nulls),
        "double": pa.array(rng.standard_normal(N)),
        "date": pa.array(rng.integers(8000, 11000, N, dtype=np.int32),
                         type=pa.int32()).cast(pa.date32()),
        "decimal_12_2": pa.array(
            [decimal.Decimal(int(v)).scaleb(-2)
             for v in rng.integers(-10 ** 11, 10 ** 11, N)],
            type=pa.decimal128(12, 2), mask=nulls),
        "decimal_38_4": pa.array(big, type=pa.decimal128(38, 4),
                                 mask=nulls),
        "varchar": pa.array(
            [["A", "N", "R", "MAIL", "TRUCK"][i]
             for i in rng.integers(0, 5, N)], mask=nulls),
    }


def _port_batch(jbatch):
    """The port's batch over the same host arrays as a reference batch."""
    return batch_from_reference(jax.device_get(jbatch))


@pytest.mark.parametrize("name", sorted(_arrow_columns()))
@pytest.mark.parametrize("masked", [False, True])
def test_to_arrow_matches_reference(name, masked):
    table = pa.table({name: _arrow_columns()[name]})
    jbatch = jd.from_arrow(table)
    if masked:  # filters AND into the mask and keep rows in place
        keep = np.arange(jbatch.capacity) % 3 != 0
        jbatch = jbatch.with_mask(jbatch.mask & keep)
    want = jd.to_arrow(jbatch)
    got = td.to_arrow(_port_batch(jbatch))
    assert got.schema == want.schema
    assert got.equals(want)


@pytest.mark.parametrize("name", sorted(_arrow_columns()))
def test_from_arrow_matches_reference(name):
    table = pa.table({name: _arrow_columns()[name]})
    jb = jax.device_get(jd.from_arrow(table))
    tb = td.from_arrow(table, device="cpu")
    assert tb.capacity == jb.capacity == 1024
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    jc, tc = jb.columns[name], tb.columns[name]
    assert str(tc.dtype) == str(jc.dtype)
    np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
    assert (tc.validity is None) == (jc.validity is None)
    if tc.validity is not None:
        np.testing.assert_array_equal(tc.validity.numpy(),
                                      np.asarray(jc.validity))
    for tk, jk in zip(tc.children, jc.children):
        np.testing.assert_array_equal(tk.data.numpy(), np.asarray(jk.data))
    if jc.dictionary is not None:
        assert tc.dictionary.values.tolist() == \
            jc.dictionary.values.tolist()
    assert td.to_arrow(tb).equals(table)


def test_batch_accounting():
    table = pa.table(_arrow_columns())
    tb = td.from_arrow(table, device="cpu")
    jb = jd.from_arrow(table)
    assert tb.nbytes == jb.nbytes
    assert int(tb.num_active()) == int(jb.num_active()) == N
    assert tb.num_active().dtype == torch.int32
    assert str(tb.row_type()) == str(jb.row_type())
    assert td.default_capacity(N) == jd.default_capacity(N)
    assert td.round_up(1025, 1024) == jd.round_up(1025, 1024)


def test_types_map_to_torch_dtypes():
    for t in (TT.BOOLEAN, TT.INTEGER, TT.BIGINT, TT.DOUBLE, TT.DATE,
              TT.decimal(12, 2), TT.VARCHAR):
        assert torch.empty(0, dtype=t.torch_dtype()).numpy().dtype == \
            t.np_dtype()


def _masked_batch():
    """A reference batch of every column kind, with a scattered mask."""
    jb = jd.from_arrow(pa.table(_arrow_columns()))
    keep = np.random.default_rng(1).random(jb.capacity) < 0.6
    return jb.with_mask(jb.mask & jax.numpy.asarray(keep))


@pytest.mark.parametrize("op", ["concat", "compact", "take", "slice",
                                "compact_batch"])
def test_batch_utils_match_reference(op):
    jb = _masked_batch()
    tb = _port_batch(jb)
    idx = np.random.default_rng(2).integers(0, jb.capacity, 900)
    if op == "concat":
        want = jbu.concat_batches([jb, jb])
        got = tbu.concat_batches([tb, tb])
    elif op == "compact":
        want, got = jbu.compact(jb), tbu.compact(tb)
    elif op == "take":
        want = jbu.take(jb, jax.numpy.asarray(idx), jb.mask[idx])
        got = tbu.take(tb, torch.from_numpy(idx), tb.mask[idx])
    elif op == "slice":
        want, got = jbu.slice_batch(jb, 100, 512), tbu.slice_batch(tb, 100,
                                                                  512)
    else:
        want, got = jbu.compact_batch(jb, 512), tbu.compact_batch(tb, 512)
    assert got.capacity == want.capacity
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert td.to_arrow(got).equals(jd.to_arrow(want))


# ---------------------------------------------------------------------------
# The batch helpers (counterparts of tests/test_vector.py's cases that use
# them): names, column, with_mask, with_columns, column_to_numpy and
# Dictionary.arrow, through both packages over the same table.
# ---------------------------------------------------------------------------

def _helper_table():
    return pa.table({
        "a": pa.array([1, 2, None, 4], type=pa.int64()),
        "b": pa.array([1.5, None, 3.5, 4.5], type=pa.float64()),
        "s": pa.array(["x", "y", "x", None], type=pa.string()),
        "d": pa.array([0, 1, 2, 3], type=pa.date32()),
        "flag": pa.array([True, False, True, None]),
    })


def test_names_and_column_match_reference():
    table = _helper_table()
    jb, tb = jd.from_arrow(table), td.from_arrow(table, device="cpu")
    assert tb.names == jb.names == table.column_names
    for name in table.column_names:
        jdata, jvalid = jd.column_to_numpy(jb.column(name))
        tdata, tvalid = td.column_to_numpy(tb.column(name))
        assert tb.column(name) is tb.columns[name]
        assert tdata.dtype == jdata.dtype
        np.testing.assert_array_equal(tdata, jdata)
        assert (tvalid is None) == (jvalid is None)
        if tvalid is not None:
            np.testing.assert_array_equal(tvalid, jvalid)


def test_with_mask_filters_rows_like_reference():
    table = _helper_table()
    jb, tb = jd.from_arrow(table), td.from_arrow(table, device="cpu")
    keep = np.zeros(jb.capacity, dtype=bool)
    keep[[0, 2]] = True
    want = jd.to_arrow(jb.with_mask(jb.mask & jax.numpy.asarray(keep)))
    got = td.to_arrow(tb.with_mask(tb.mask & torch.from_numpy(keep)))
    assert got.equals(want)
    assert got.num_rows == 2
    assert got.column("a").to_pylist() == [1, None]
    assert got.column("s").to_pylist() == ["x", "x"]


def test_with_mask_and_with_columns_keep_the_error_count():
    tb = td.from_arrow(_helper_table(), device="cpu")
    tb = td.DeviceBatch(tb.columns, tb.mask, torch.tensor(3))
    assert int(tb.with_mask(tb.mask).errors) == 3
    assert int(tb.with_columns(dict(tb.columns)).errors) == 3


def test_with_columns_matches_reference():
    table = _helper_table()
    jb, tb = jd.from_arrow(table), td.from_arrow(table, device="cpu")
    ja, ta = jb.column("a"), tb.column("a")
    jcols, tcols = dict(jb.columns), dict(tb.columns)
    jcols["a"] = jd.DeviceColumn(ja.data + 1, ja.validity, ja.dtype)
    tcols["a"] = td.DeviceColumn(ta.data + 1, ta.validity, ta.dtype)
    want, got = jd.to_arrow(jb.with_columns(jcols)), \
        td.to_arrow(tb.with_columns(tcols))
    assert got.equals(want)
    assert got.column("a").to_pylist() == [2, 3, None, 5]
    assert got.column("s").to_pylist() == ["x", "y", "x", None]


def test_stable_dictionary_remap_matches_reference():
    table = pa.table({"s": pa.array(["y", "x", "y"])})
    jstable = jd.Dictionary(["a", "b", "c", "x", "y"])
    tstable = td.Dictionary(["a", "b", "c", "x", "y"])
    jb = jd.from_arrow(table, dictionaries={"s": jstable})
    tb = td.from_arrow(table, dictionaries={"s": tstable}, device="cpu")
    assert tb.column("s").dictionary is tstable
    np.testing.assert_array_equal(
        td.column_to_numpy(tb.column("s"))[0][:3],
        jd.column_to_numpy(jb.column("s"))[0][:3])
    assert td.column_to_numpy(tb.column("s"))[0][:3].tolist() == [4, 3, 4]


def test_decimal_column_to_numpy_matches_reference():
    table = pa.table({"p": pa.array([None, 1, 2],
                                    type=pa.decimal128(12, 2))})
    jb, tb = jd.from_arrow(table), td.from_arrow(table, device="cpu")
    assert str(tb.column("p").dtype) == str(jb.column("p").dtype)
    (tdata, tvalid), (jdata, jvalid) = (td.column_to_numpy(tb.column("p")),
                                        jd.column_to_numpy(jb.column("p")))
    np.testing.assert_array_equal(tdata, jdata)
    np.testing.assert_array_equal(tvalid, jvalid)
    assert tdata[:3].tolist() == [0, 100, 200]


@pytest.mark.parametrize("values", [
    ["b", "a", "c"], ["", "ümlaut", "x" * 40], [b"\x00\xff", b"ab"], []])
def test_dictionary_arrow_matches_reference(values):
    jdict, tdict = jd.Dictionary(values), td.Dictionary(values)
    got = tdict.arrow()
    assert got.equals(jdict.arrow())
    assert got is tdict.arrow()  # converted once
    # a typed take in between does not change what arrow() gives
    tdict.arrow_take(np.zeros(len(values), np.int64), None, pa.large_string()
                     if values and isinstance(values[0], str)
                     else pa.large_binary())
    assert tdict.arrow().equals(jdict.arrow())

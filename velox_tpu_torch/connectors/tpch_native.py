"""ctypes bridge to the native TPC-H generator (``native/dbgen.cpp``).

Counterpart of ``velox_tpu/connectors/tpch_native.py``: the same C entry
points over the port's copy of the reference's source file, built by
``native/build.py`` into the port's own build directory. Its output is bit-identical to the numpy
generator in ``connectors/tpch.py``; each function returns None when no
C++ compiler is available, and the caller then uses numpy.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np

from velox_tpu_torch.native.build import load_dbgen

_I64 = ctypes.c_int64
_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)

_LINEITEM_LAYOUT = [
    ("l_orderkey", np.int64), ("l_partkey", np.int64),
    ("l_suppkey", np.int64), ("l_linenumber", np.int32),
    ("l_quantity", np.int64), ("l_extendedprice", np.int64),
    ("l_discount", np.int64), ("l_tax", np.int64),
    ("l_returnflag", np.int32), ("l_linestatus", np.int32),
    ("l_shipdate", np.int32), ("l_commitdate", np.int32),
    ("l_receiptdate", np.int32), ("l_shipinstruct", np.int32),
    ("l_shipmode", np.int32), ("l_comment", np.int32),
]

_ORDERS_LAYOUT = [
    ("o_orderkey", np.int64), ("o_custkey", np.int64),
    ("o_orderstatus", np.int32), ("o_totalprice", np.int64),
    ("o_orderdate", np.int32), ("o_orderpriority", np.int32),
    ("o_clerk", np.int32), ("o_shippriority", np.int32),
    ("o_comment", np.int32),
]


def _ptype(dt):
    return _P64 if dt == np.int64 else _P32


def _load():
    lib = load_dbgen()
    if lib is not None and lib.tpch_lineitem_rows.argtypes is None:
        lib.tpch_lineitem_rows.restype = _I64
        lib.tpch_lineitem_rows.argtypes = [_I64, _I64]
        lib.tpch_gen_lineitem.restype = None
        lib.tpch_gen_lineitem.argtypes = (
            [_I64] * 4 + [_ptype(dt) for _, dt in _LINEITEM_LAYOUT]
            + [_I64, _I64])
        lib.tpch_gen_orders.restype = None
        lib.tpch_gen_orders.argtypes = (
            [_I64] * 6 + [_ptype(dt) for _, dt in _ORDERS_LAYOUT]
            + [_I64, _I64])
    return lib


def _ptr(arr: Optional[np.ndarray], dt):
    ptype = _ptype(dt)
    if arr is None:
        return ptype()
    return arr.ctypes.data_as(ptype)


def lineitem_rows(lo: int, hi: int) -> Optional[int]:
    lib = _load()
    if lib is None:
        return None
    return int(lib.tpch_lineitem_rows(lo, hi))


def gen_lineitem(lo: int, hi: int, columns: Sequence[str], sf: float,
                 n_words_sq: int) -> Optional[Dict[str, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    n = int(lib.tpch_lineitem_rows(lo, hi))
    bufs = {name: (np.empty(n, dt) if name in columns else None)
            for name, dt in _LINEITEM_LAYOUT}
    # nthreads 0 = the machine's hardware concurrency
    lib.tpch_gen_lineitem(
        lo, hi, int(200000 * sf), int(10000 * sf),
        *[_ptr(bufs[name], dt) for name, dt in _LINEITEM_LAYOUT],
        n_words_sq, 0)
    return {c: bufs[c] for c in columns}


def gen_orders(lo: int, hi: int, columns: Sequence[str], sf: float,
               n_words_sq: int) -> Optional[Dict[str, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    bufs = {name: (np.empty(hi - lo, dt) if name in columns else None)
            for name, dt in _ORDERS_LAYOUT}
    ncust = int(150000 * sf)
    allowed = max(1, (ncust * 2) // 3)
    nclerk = max(1, int(10000 * sf) // 10) * 1000
    lib.tpch_gen_orders(
        lo, hi, int(200000 * sf), int(10000 * sf), allowed, nclerk,
        *[_ptr(bufs[name], dt) for name, dt in _ORDERS_LAYOUT],
        n_words_sq, 0)
    return {c: bufs[c] for c in columns}

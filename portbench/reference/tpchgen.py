"""The benchmark's own TPC-H tables, for the plain reference and the
Parquet files.

A frozen copy of the program's generator: lineitem and orders come from
``dbgen.cpp`` beside this file (built with the host's C++ compiler into
``portbench/_build/``), the other six tables from the numpy generators
copied here. Both follow the same counter-based splitmix64 streams over
(table, column, row), so the reference sees the tables the program
generates without reading anything the program produced.

Strings are dictionary ids plus the dictionary (``Dict``, or ``Formatted``
for per-row strings such as ``Customer#000000001``); money columns are
DECIMAL(12,2) scaled integers; dates are days since 1970-01-01.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "dbgen.cpp"
BUILD_DIR = HERE.parent / "_build"

_U64 = np.uint64


def _mix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def _rng(stream: int, idx: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        key = _U64(stream) * _U64(0x9E3779B97F4A7C15)
        return _mix64(idx.astype(np.uint64) + key)


def _uniform_int(stream: int, idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    span = _U64(hi - lo + 1)
    return (lo + (_rng(stream, idx) % span).astype(np.int64)).astype(np.int64)


ORDERS_PER_SF = 1_500_000
CUSTOMERS_PER_SF = 150_000
PARTS_PER_SF = 200_000
SUPPLIERS_PER_SF = 10_000

RETURN_FLAGS = ["A", "N", "R"]
LINE_STATUS = ["F", "O"]
SHIP_MODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
SHIP_INSTRUCTS = ["COLLECT COD", "DELIVER IN PERSON", "NONE",
                  "TAKE BACK RETURN"]
ORDER_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                    "5-LOW"]
MKT_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                "MACHINERY"]
ORDER_STATUS = ["F", "O", "P"]
NATIONS = [
    "ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
    "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
    "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA",
    "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES",
]
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
WORDS = ("final deposits regular quickly express ironic carefully pending"
         " furiously bold packages requests accounts theodolites platelets"
         " instructions foxes dependencies pinto beans green forest").split()
P_TYPES = sorted(f"{a} {b} {c}"
                 for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                           "PROMO")
                 for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                           "BRUSHED")
                 for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
P_CONTAINERS = sorted(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                      for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                                "CAN", "DRUM"))
P_BRANDS = sorted(f"Brand#{m}{b}" for m in range(1, 6) for b in range(1, 6))

_S = {
    "l_quantity": 1, "l_discount": 2, "l_tax": 3, "l_partkey": 4,
    "l_suppkey": 5, "l_shipdate": 6, "l_commit": 7, "l_receipt": 8,
    "l_shipmode": 9, "l_shipinstruct": 10, "l_comment": 11,
    "l_returnflag": 12,
    "o_custkey": 64, "o_date": 65, "o_priority": 66, "o_clerk": 67,
    "o_shippriority": 68, "o_comment": 69, "o_linecount": 70,
    "c_nation": 128, "c_acctbal": 129, "c_segment": 130, "c_comment": 131,
    "p_retail": 192, "p_size": 193, "p_comment": 194, "p_mfgr": 195,
    "p_brand": 196, "p_type": 197, "p_container": 198,
    "s_nation": 256, "s_acctbal": 257, "s_comment": 258,
    "ps_availqty": 320, "ps_supplycost": 321, "ps_comment": 322,
}
N_WORDS_SQ = len(WORDS) ** 2


class Dict:
    """A string dictionary: row values are ids into ``values``."""

    def __init__(self, values):
        self.values = np.asarray(values, dtype=object)
        self._index = {v: i for i, v in enumerate(self.values)}

    def __len__(self):
        return len(self.values)

    def id_of(self, value) -> int:
        return self._index.get(value, -1)

    def take(self, ids) -> np.ndarray:
        return self.values[np.asarray(ids, dtype=np.int64)]


class Formatted(Dict):
    """A dictionary of per-row strings formatted from their ids."""

    def __init__(self, size: int, fmt):
        self._size, self._fmt, self._values = size, fmt, None

    def __len__(self):
        return self._size

    @property
    def values(self):
        if self._values is None:
            self._values = self.take(np.arange(self._size))
        return self._values

    def take(self, ids) -> np.ndarray:
        return np.array(self._fmt(np.asarray(ids, dtype=np.int64)),
                        dtype=object)

    def id_of(self, value) -> int:
        digits = "".join(ch for ch in str(value) if ch.isdigit())
        i = int(digits) if digits else -1
        return i if 0 <= i < self._size and self.take([i])[0] == value \
            else -1


def _numbered(prefix: str):
    return lambda ids: [f"{prefix}#{i:09d}" for i in ids.tolist()]


def _phones(ids: np.ndarray) -> list:
    h = _mix64(ids.astype(_U64) * _U64(31) + _U64(7))
    cc, a, b, c = (p.tolist() for p in (
        10 + ids % 25, h % _U64(900) + _U64(100),
        (h >> _U64(10)) % _U64(900) + _U64(100),
        (h >> _U64(20)) % _U64(9000) + _U64(1000)))
    return [f"{w}-{x}-{y}-{z}" for w, x, y, z in zip(cc, a, b, c)]


def _comments() -> Dict:
    n = len(WORDS)
    return Dict(sorted(f"{WORDS[i]} {WORDS[j]}" for i in range(n)
                       for j in range(n)))


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
_LIB_LOCK = threading.Lock()
_LIB: list = []


def _ptype(dt):
    return ctypes.POINTER(ctypes.c_int64 if dt == np.int64
                          else ctypes.c_int32)


def native() -> ctypes.CDLL:
    """``dbgen.cpp`` compiled once per source hash into ``_build/``."""
    with _LIB_LOCK:
        if _LIB:
            return _LIB[0]
        cc = next((c for c in ("g++", "clang++", "c++") if shutil.which(c)),
                  None)
        if cc is None:
            raise RuntimeError("the reference generator needs a C++ "
                               "compiler (g++, clang++ or c++)")
        flags = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
        digest = hashlib.sha256(SOURCE.read_bytes()
                                + " ".join(flags).encode()).hexdigest()
        out = BUILD_DIR / f"refdbgen-{digest[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
            subprocess.run([cc, *flags, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        i64 = ctypes.c_int64
        lib.tpch_lineitem_rows.restype = i64
        lib.tpch_lineitem_rows.argtypes = [i64, i64]
        lib.tpch_gen_lineitem.restype = None
        lib.tpch_gen_lineitem.argtypes = (
            [i64] * 4 + [_ptype(dt) for _, dt in _LINEITEM_LAYOUT]
            + [i64, i64])
        lib.tpch_gen_orders.restype = None
        lib.tpch_gen_orders.argtypes = (
            [i64] * 6 + [_ptype(dt) for _, dt in _ORDERS_LAYOUT]
            + [i64, i64])
        _LIB.append(lib)
        return lib


def _ptr(arr, dt):
    return _ptype(dt)() if arr is None else arr.ctypes.data_as(_ptype(dt))


def _part_price_cents(partkey: np.ndarray) -> np.ndarray:
    p = partkey.astype(np.int64)
    return 90000 + ((p // 10) % 20001) + 100 * (p % 1000)


class TpchGen:
    """Every TPC-H table at scale factor ``sf``, a column range at a
    time: ``generate(table, lo, hi, columns)`` gives {column: array} of
    rows [lo, hi) (for lineitem, of the lines of orders [lo, hi))."""

    def __init__(self, sf: float):
        self.sf = sf
        ncust = int(CUSTOMERS_PER_SF * sf)
        nsupp = int(SUPPLIERS_PER_SF * sf)
        comment = _comments()
        self._dicts = {
            "lineitem": {"l_returnflag": Dict(RETURN_FLAGS),
                         "l_linestatus": Dict(LINE_STATUS),
                         "l_shipmode": Dict(SHIP_MODES),
                         "l_shipinstruct": Dict(SHIP_INSTRUCTS),
                         "l_comment": comment},
            "orders": {"o_orderstatus": Dict(ORDER_STATUS),
                       "o_orderpriority": Dict(ORDER_PRIORITIES),
                       "o_clerk": Formatted(max(1, nsupp // 10) * 1000 + 1,
                                            _numbered("Clerk")),
                       "o_comment": comment},
            "customer": {"c_name": Formatted(ncust + 1,
                                             _numbered("Customer")),
                         "c_address": comment,
                         "c_phone": Formatted(ncust + 1, _phones),
                         "c_mktsegment": Dict(MKT_SEGMENTS),
                         "c_comment": comment},
            "part": {"p_name": comment,
                     "p_mfgr": Dict([f"Manufacturer#{i}"
                                     for i in range(1, 6)]),
                     "p_brand": Dict(P_BRANDS),
                     "p_type": Dict(P_TYPES),
                     "p_container": Dict(P_CONTAINERS),
                     "p_comment": comment},
            "supplier": {"s_name": Formatted(nsupp + 1,
                                             _numbered("Supplier")),
                         "s_address": comment,
                         "s_phone": Formatted(nsupp + 1, _phones),
                         "s_comment": comment},
            "partsupp": {"ps_comment": comment},
            "nation": {"n_name": Dict(NATIONS), "n_comment": comment},
            "region": {"r_name": Dict(REGIONS), "r_comment": comment},
        }

    def dictionaries(self, table: str) -> Dict:
        return self._dicts.get(table, {})

    def num_rows(self, table: str) -> int:
        sf = self.sf
        n = {"orders": int(ORDERS_PER_SF * sf),
             "customer": int(CUSTOMERS_PER_SF * sf),
             "part": int(PARTS_PER_SF * sf),
             "supplier": int(SUPPLIERS_PER_SF * sf),
             "partsupp": int(PARTS_PER_SF * sf) * 4,
             "nation": 25, "region": 5}
        if table == "lineitem":
            return int(native().tpch_lineitem_rows(0, n["orders"]))
        return n[table]

    def generate(self, table: str, lo: int, hi: int,
                 columns: Sequence[str]) -> Dict[str, np.ndarray]:
        return getattr(self, f"gen_{table}")(lo, hi, columns)

    def table(self, table: str, columns: Sequence[str]):
        """Whole columns of a table (lineitem: of every order)."""
        n = self.num_rows("orders" if table == "lineitem" else table)
        return self.generate(table, 0, n, columns)

    def gen_lineitem(self, lo, hi, columns):
        lib = native()
        n = int(lib.tpch_lineitem_rows(lo, hi))
        bufs = {name: (np.empty(n, dt) if name in columns else None)
                for name, dt in _LINEITEM_LAYOUT}
        lib.tpch_gen_lineitem(
            lo, hi, int(PARTS_PER_SF * self.sf),
            int(SUPPLIERS_PER_SF * self.sf),
            *[_ptr(bufs[name], dt) for name, dt in _LINEITEM_LAYOUT],
            N_WORDS_SQ, 0)
        return {c: bufs[c] for c in columns}

    def gen_orders(self, lo, hi, columns):
        lib = native()
        bufs = {name: (np.empty(hi - lo, dt) if name in columns else None)
                for name, dt in _ORDERS_LAYOUT}
        ncust = int(CUSTOMERS_PER_SF * self.sf)
        nclerk = max(1, int(SUPPLIERS_PER_SF * self.sf) // 10) * 1000
        lib.tpch_gen_orders(
            lo, hi, int(PARTS_PER_SF * self.sf),
            int(SUPPLIERS_PER_SF * self.sf), max(1, (ncust * 2) // 3),
            nclerk, *[_ptr(bufs[name], dt) for name, dt in _ORDERS_LAYOUT],
            N_WORDS_SQ, 0)
        return {c: bufs[c] for c in columns}

    def gen_customer(self, lo, hi, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        key = idx + 1
        make = {
            "c_custkey": lambda: key,
            "c_name": lambda: key.astype(np.int32),
            "c_address": lambda: _uniform_int(
                _S["c_comment"] + 7, idx, 0, N_WORDS_SQ - 1).astype(np.int32),
            "c_nationkey": lambda: _uniform_int(_S["c_nation"], idx, 0, 24),
            "c_phone": lambda: key.astype(np.int32),
            "c_acctbal": lambda: _uniform_int(_S["c_acctbal"], idx, -99999,
                                              999999),
            "c_mktsegment": lambda: _uniform_int(
                _S["c_segment"], idx, 0, len(MKT_SEGMENTS) - 1
            ).astype(np.int32),
            "c_comment": lambda: _uniform_int(
                _S["c_comment"], idx, 0, N_WORDS_SQ - 1).astype(np.int32),
        }
        return {c: make[c]() for c in columns}

    def gen_part(self, lo, hi, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        key = idx + 1

        def pick(stream, top):
            return _uniform_int(stream, idx, 0, top).astype(np.int32)

        make = {
            "p_partkey": lambda: key,
            "p_name": lambda: pick(_S["p_comment"] + 3, N_WORDS_SQ - 1),
            "p_mfgr": lambda: pick(_S["p_mfgr"], 4),
            "p_brand": lambda: pick(_S["p_brand"], 24),
            "p_type": lambda: pick(_S["p_type"], 149),
            "p_size": lambda: _uniform_int(_S["p_size"], idx, 1, 50),
            "p_container": lambda: pick(_S["p_container"], 39),
            "p_retailprice": lambda: _part_price_cents(key),
            "p_comment": lambda: pick(_S["p_comment"], N_WORDS_SQ - 1),
        }
        return {c: make[c]() for c in columns}

    def gen_supplier(self, lo, hi, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        key = idx + 1
        make = {
            "s_suppkey": lambda: key,
            "s_name": lambda: key.astype(np.int32),
            "s_address": lambda: _uniform_int(
                _S["s_comment"] + 5, idx, 0, N_WORDS_SQ - 1).astype(np.int32),
            "s_nationkey": lambda: _uniform_int(_S["s_nation"], idx, 0, 24),
            "s_phone": lambda: key.astype(np.int32),
            "s_acctbal": lambda: _uniform_int(_S["s_acctbal"], idx, -99999,
                                              999999),
            "s_comment": lambda: _uniform_int(
                _S["s_comment"], idx, 0, N_WORDS_SQ - 1).astype(np.int32),
        }
        return {c: make[c]() for c in columns}

    def gen_partsupp(self, lo, hi, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        partkey = idx // 4 + 1
        nsupp = int(SUPPLIERS_PER_SF * self.sf)
        make = {
            "ps_partkey": lambda: partkey,
            "ps_suppkey": lambda: (partkey + (idx % 4) * (
                nsupp // 4 + partkey // nsupp)) % nsupp + 1,
            "ps_availqty": lambda: _uniform_int(_S["ps_availqty"], idx, 1,
                                                9999),
            "ps_supplycost": lambda: _uniform_int(_S["ps_supplycost"], idx,
                                                  100, 100000),
            "ps_comment": lambda: _uniform_int(
                _S["ps_comment"], idx, 0, N_WORDS_SQ - 1).astype(np.int32),
        }
        return {c: make[c]() for c in columns}

    def gen_nation(self, lo, hi, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        make = {
            "n_nationkey": lambda: idx,
            "n_name": lambda: idx.astype(np.int32),
            "n_regionkey": lambda: np.array(NATION_REGION,
                                            np.int64)[lo:hi],
            "n_comment": lambda: (idx % N_WORDS_SQ).astype(np.int32),
        }
        return {c: make[c]() for c in columns}

    def gen_region(self, lo, hi, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        make = {
            "r_regionkey": lambda: idx,
            "r_name": lambda: idx.astype(np.int32),
            "r_comment": lambda: (idx % N_WORDS_SQ).astype(np.int32),
        }
        return {c: make[c]() for c in columns}

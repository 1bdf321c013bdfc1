"""TPC-H connector: tables computed on the fly from a deterministic dbgen.

Counterpart of ``velox_tpu/connectors/tpch.py``. The generator
(``TpchTableGen``: counter-based splitmix64 streams over (table, column,
row), the native core in ``tpch_native.py``) is the reference's, copied so
that both engines see bit-identical tables at any scale factor. The data
source looks each split up in the device scan cache
(``connectors/cache.py``) and, on a miss, generates it on the host and
uploads it to the device of the query's ``QueryCtx``: each column is
narrowed in one host pass into a pinned buffer and copied asynchronously
on the source's own CUDA stream (on the CPU, into an ordinary tensor).
The split prefetch thread that overlaps this with the query is the scan
operator's (``exec/operator.py``).

Money/quantity columns are DECIMAL(12,2) stored as scaled integers
(cents); those whose generated values provably fit int32 are stored as
int32 (``_NARROW_INT32``), which the filter-sum kernel requires.
"""

from __future__ import annotations

import functools
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.connectors.cache import DataCache
from velox_tpu_torch.connectors.connector import (
    Connector, ConnectorSplit, DataSource, register_connector,
)
from velox_tpu_torch.vector.device import (
    DeviceBatch, DeviceColumn, Dictionary, default_capacity, prefix_mask,
)

# ---------------------------------------------------------------------------
# Counter-based RNG (splitmix64 finalizer over a (table, column, row) key).
# ---------------------------------------------------------------------------

_U64 = np.uint64


def _mix64(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def _rng(stream: int, idx: np.ndarray) -> np.ndarray:
    """uint64 uniform for each element of idx on the given stream."""
    with np.errstate(over="ignore"):
        key = _U64(stream) * _U64(0x9E3779B97F4A7C15)
        return _mix64(idx.astype(np.uint64) + key)


def _uniform_int(stream: int, idx: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Uniform integer in [lo, hi] inclusive (dbgen-style bounds)."""
    span = _U64(hi - lo + 1)
    return (lo + (_rng(stream, idx) % span).astype(np.int64)).astype(np.int64)


# ---------------------------------------------------------------------------
# Constants (TPC-H spec section 4.2; row counts per velox/tpch/gen/TpchGen.h).
# ---------------------------------------------------------------------------

_EPOCH_1992 = 8035          # days from 1970-01-01 to 1992-01-01
_EPOCH_1998_END = 10591     # days to 1998-12-31
_ORDER_DATE_SPAN = _EPOCH_1998_END - _EPOCH_1992 - 151  # last orderdate

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

# comment words for deterministic filler text (small stable dictionary).
# "green" and "forest" are real dbgen p_name words (dists.dss colors) —
# included so Q9 ('%green%') and Q20 ('forest%') select real rows.
_WORDS = ("final deposits regular quickly express ironic carefully pending"
          " furiously bold packages requests accounts theodolites platelets"
          " instructions foxes dependencies pinto beans green forest").split()

# RNG stream ids per (table, column) — table * 64 + column slot.
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


class VirtualDictionary(Dictionary):
    """Dictionary whose values are formatted on demand from ids.

    Used for per-row-unique strings (c_name = 'Customer#%09d', ...): the
    device column stores the integer id, and values materialize lazily.
    ``fmt`` maps an int64 id array to the list of its values.
    """

    def __init__(self, size: int, fmt):
        self._size = size
        self._fmt = fmt
        self._values: Optional[np.ndarray] = None
        self.is_sorted = True

    def __len__(self):
        return self._size

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            self._values = self.take(np.arange(self._size))
        return self._values

    def take(self, ids: np.ndarray) -> np.ndarray:
        return np.array(self._fmt(np.asarray(ids, dtype=np.int64)),
                        dtype=object)

    def id_of(self, value) -> int:
        # invert the format by scanning the embedded integer
        digits = "".join(ch for ch in str(value) if ch.isdigit())
        if not digits:
            return -1
        i = int(digits)
        return (i if 0 <= i < self._size
                and self.take(np.array([i]))[0] == value else -1)

    def __repr__(self):
        return f"VirtualDictionary({self._size})"

    def __reduce__(self):
        # pickled as its size and formatter, never its materialized values
        return (VirtualDictionary, (self._size, self._fmt))


def _format_numbered(prefix: str, ids: np.ndarray) -> list:
    return [f"{prefix}#{i:09d}" for i in ids.tolist()]


def _numbered(prefix: str):
    """``fmt`` for 'Prefix#%09d' values (a partial, so that a dictionary
    pickles: the scan cache's SSD tier writes batches with theirs)."""
    return functools.partial(_format_numbered, prefix)


def _comment_dict(stream: int) -> Dictionary:
    n = len(_WORDS)
    vals = [f"{_WORDS[i]} {_WORDS[j]}" for i in range(n) for j in range(n)]
    return Dictionary(sorted(vals))


# ---------------------------------------------------------------------------
# Order/line scaffolding.
# ---------------------------------------------------------------------------

def order_key_at(index: np.ndarray) -> np.ndarray:
    """Sparse order key: 8 used of every 32 (dbgen order-key spacing)."""
    index = index.astype(np.int64)
    return ((index >> 3) << 5) | (index & 7)


def line_count_at(index: np.ndarray) -> np.ndarray:
    """Lines per order, 1..7, derived from the order index."""
    return _uniform_int(_S["o_linecount"], index, 1, 7)


def _part_price_cents(partkey: np.ndarray) -> np.ndarray:
    """dbgen retail price formula (cents), spec 4.2.3."""
    p = partkey.astype(np.int64)
    return 90000 + ((p // 10) % 20001) + 100 * (p % 1000)


def _customer_key(stream: int, idx: np.ndarray, sf: float) -> np.ndarray:
    """Random custkey in [1, ncust] never divisible by 3 (dbgen rule)."""
    ncust = int(CUSTOMERS_PER_SF * sf)
    allowed = max(1, (ncust * 2) // 3)
    k = _uniform_int(stream, idx, 0, allowed - 1)
    return 3 * (k // 2) + 1 + (k % 2)


@dataclass
class _LineCols:
    """Per-line generated values for a block of orders (vectorized)."""
    quantity: np.ndarray
    extendedprice: np.ndarray
    discount: np.ndarray
    tax: np.ndarray
    shipdate: np.ndarray
    commitdate: np.ndarray
    receiptdate: np.ndarray
    partkey: np.ndarray
    suppkey: np.ndarray


def _gen_lines_flat(line_gid: np.ndarray, orderdate: np.ndarray,
                    sf: float) -> _LineCols:
    """Generate line-level columns for global line ids (order_idx*8 + ln).

    Money/quantity columns are DECIMAL(12,2) scaled ints (cents)."""
    nparts = int(PARTS_PER_SF * sf)
    nsupp = int(SUPPLIERS_PER_SF * sf)
    qty_raw = _uniform_int(_S["l_quantity"], line_gid, 1, 50)
    partkey = _uniform_int(_S["l_partkey"], line_gid, 1, nparts)
    # dbgen: suppkey = (partkey + (i * (nsupp/4 + partkey/nsupp))) % nsupp + 1
    i4 = (line_gid % 4).astype(np.int64)
    suppkey = (partkey + i4 * (nsupp // 4 + partkey // nsupp)) % nsupp + 1
    extendedprice = _part_price_cents(partkey) * qty_raw  # cents, scale 2
    discount = _uniform_int(_S["l_discount"], line_gid, 0, 10)  # scale 2
    tax = _uniform_int(_S["l_tax"], line_gid, 0, 8)  # scale 2
    shipdate = orderdate + _uniform_int(_S["l_shipdate"], line_gid, 1, 121)
    commitdate = orderdate + _uniform_int(_S["l_commit"], line_gid, 30, 90)
    receiptdate = shipdate + _uniform_int(_S["l_receipt"], line_gid, 1, 30)
    return _LineCols(qty_raw * 100, extendedprice,
                     discount, tax,
                     shipdate.astype(np.int32),
                     commitdate.astype(np.int32),
                     receiptdate.astype(np.int32), partkey, suppkey)


def _order_date(order_idx: np.ndarray) -> np.ndarray:
    return (_EPOCH_1992 + _uniform_int(_S["o_date"], order_idx, 0,
                                       _ORDER_DATE_SPAN)).astype(np.int32)


_CURRENT_DATE = 9298  # 1995-06-17, dbgen CURRENTDATE


# ---------------------------------------------------------------------------
# Table generators. Each returns {column -> numpy array} for a row range.
# ---------------------------------------------------------------------------

class TpchTableGen:
    """Deterministic columnar generators, one classmethod per table."""

    def __init__(self, sf: float):
        self.sf = sf
        self._dicts = self._build_dictionaries()

    # -- dictionaries ------------------------------------------------------

    def _build_dictionaries(self) -> Dict[str, Dict[str, Dictionary]]:
        sf = self.sf
        ncust = int(CUSTOMERS_PER_SF * sf)
        nsupp = int(SUPPLIERS_PER_SF * sf)
        nparts = int(PARTS_PER_SF * sf)
        comment = _comment_dict(0)
        d = {
            "lineitem": {
                "l_returnflag": Dictionary(RETURN_FLAGS),
                "l_linestatus": Dictionary(LINE_STATUS),
                "l_shipmode": Dictionary(SHIP_MODES),
                "l_shipinstruct": Dictionary(SHIP_INSTRUCTS),
                "l_comment": comment,
            },
            "orders": {
                "o_orderstatus": Dictionary(ORDER_STATUS),
                "o_orderpriority": Dictionary(ORDER_PRIORITIES),
                "o_clerk": VirtualDictionary(
                    max(1, nsupp // 10) * 1000 + 1, _numbered("Clerk")),
                "o_comment": comment,
            },
            "customer": {
                "c_name": VirtualDictionary(ncust + 1, _numbered("Customer")),
                "c_address": comment,
                "c_phone": VirtualDictionary(ncust + 1, _phones),
                "c_mktsegment": Dictionary(MKT_SEGMENTS),
                "c_comment": comment,
            },
            "part": {
                "p_name": comment,
                "p_mfgr": Dictionary(
                    [f"Manufacturer#{i}" for i in range(1, 6)]),
                "p_brand": Dictionary(
                    sorted(f"Brand#{m}{b}" for m in range(1, 6)
                           for b in range(1, 6))),
                "p_type": Dictionary(sorted(
                    f"{a} {b} {c}"
                    for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                              "ECONOMY", "PROMO")
                    for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                              "BRUSHED")
                    for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))),
                "p_container": Dictionary(sorted(
                    f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                    for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                              "CAN", "DRUM"))),
                "p_comment": comment,
            },
            "supplier": {
                "s_name": VirtualDictionary(nsupp + 1, _numbered("Supplier")),
                "s_address": comment,
                "s_phone": VirtualDictionary(nsupp + 1, _phones),
                "s_comment": comment,
            },
            "partsupp": {"ps_comment": comment},
            "nation": {
                "n_name": Dictionary(list(NATIONS)),
                "n_comment": comment,
            },
            "region": {
                "r_name": Dictionary(list(REGIONS)),
                "r_comment": comment,
            },
        }
        return d

    def dictionaries(self, table: str) -> Dict[str, Dictionary]:
        return self._dicts.get(table, {})

    # -- row counts ----------------------------------------------------------

    def num_rows(self, table: str) -> int:
        sf = self.sf
        if table == "orders":
            return int(ORDERS_PER_SF * sf)
        if table == "lineitem":
            # exact: sum of per-order line counts; computed in blocks
            n_orders = int(ORDERS_PER_SF * sf)
            from velox_tpu_torch.connectors import tpch_native
            native = tpch_native.lineitem_rows(0, n_orders)
            if native is not None:
                return native
            total = 0
            step = 4 << 20
            for lo in range(0, n_orders, step):
                idx = np.arange(lo, min(lo + step, n_orders), dtype=np.int64)
                total += int(line_count_at(idx).sum())
            return total
        if table == "customer":
            return int(CUSTOMERS_PER_SF * sf)
        if table == "part":
            return int(PARTS_PER_SF * sf)
        if table == "supplier":
            return int(SUPPLIERS_PER_SF * sf)
        if table == "partsupp":
            return int(PARTS_PER_SF * sf) * 4
        if table == "nation":
            return 25
        if table == "region":
            return 5
        raise KeyError(table)

    # -- generators ----------------------------------------------------------

    def gen_lineitem(self, order_lo: int, order_hi: int,
                     columns: Sequence[str]) -> Dict[str, np.ndarray]:
        """Lineitem rows for orders [order_lo, order_hi) — split by order
        index, matching the reference's order-keyed offsets
        (velox/tpch/gen/TpchGen.h:100-110)."""
        from velox_tpu_torch.connectors import tpch_native
        native = tpch_native.gen_lineitem(
            order_lo, order_hi, columns, self.sf, len(_WORDS) ** 2)
        if native is not None:
            return native
        oidx = np.arange(order_lo, order_hi, dtype=np.int64)
        counts = line_count_at(oidx)
        # flatten: row r belongs to order oidx[j], line ln
        order_rep = np.repeat(oidx, counts)
        ln = np.concatenate([np.arange(c) for c in counts]) \
            if len(counts) else np.zeros(0, np.int64)
        gid = order_rep * 8 + ln
        odate = _order_date(order_rep)
        lc = _gen_lines_flat(gid, odate.astype(np.int64), self.sf)
        out: Dict[str, np.ndarray] = {}
        for c in columns:
            if c == "l_orderkey":
                out[c] = order_key_at(order_rep)
            elif c == "l_partkey":
                out[c] = lc.partkey
            elif c == "l_suppkey":
                out[c] = lc.suppkey
            elif c == "l_linenumber":
                out[c] = (ln + 1).astype(np.int32)
            elif c == "l_quantity":
                out[c] = lc.quantity
            elif c == "l_extendedprice":
                out[c] = lc.extendedprice
            elif c == "l_discount":
                out[c] = lc.discount
            elif c == "l_tax":
                out[c] = lc.tax
            elif c == "l_returnflag":
                # R/A if receipt <= currentdate else N (spec 4.2.3)
                r = _uniform_int(_S["l_returnflag"], gid, 0, 1)
                flag = np.where(lc.receiptdate <= _CURRENT_DATE,
                                np.where(r == 0, 0, 2), 1)  # A=0,N=1,R=2
                out[c] = flag.astype(np.int32)
            elif c == "l_linestatus":
                out[c] = (lc.shipdate > _CURRENT_DATE).astype(np.int32)
            elif c == "l_shipdate":
                out[c] = lc.shipdate
            elif c == "l_commitdate":
                out[c] = lc.commitdate
            elif c == "l_receiptdate":
                out[c] = lc.receiptdate
            elif c == "l_shipinstruct":
                out[c] = _uniform_int(_S["l_shipinstruct"], gid, 0,
                                      len(SHIP_INSTRUCTS) - 1) \
                    .astype(np.int32)
            elif c == "l_shipmode":
                out[c] = _uniform_int(_S["l_shipmode"], gid, 0,
                                      len(SHIP_MODES) - 1).astype(np.int32)
            elif c == "l_comment":
                out[c] = _uniform_int(_S["l_comment"], gid, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            else:
                raise KeyError(f"lineitem has no column {c}")
        return out

    def gen_orders(self, lo: int, hi: int,
                   columns: Sequence[str]) -> Dict[str, np.ndarray]:
        from velox_tpu_torch.connectors import tpch_native
        native = tpch_native.gen_orders(lo, hi, columns, self.sf,
                                        len(_WORDS) ** 2)
        if native is not None:
            return native
        oidx = np.arange(lo, hi, dtype=np.int64)
        need_lines = any(c in ("o_totalprice", "o_orderstatus")
                         for c in columns)
        totalprice = status = None
        if need_lines:
            counts = line_count_at(oidx)
            odate64 = _order_date(oidx).astype(np.int64)
            total = np.zeros(len(oidx), np.int64)  # scale-6 scaled int
            all_f = np.ones(len(oidx), bool)
            all_o = np.ones(len(oidx), bool)
            for j in range(7):  # max 7 lines; masked accumulation
                has = counts > j
                gid = oidx * 8 + j
                lc = _gen_lines_flat(gid, odate64, self.sf)
                # ext(s2) * (1-disc)(s2) * (1+tax)(s2) -> scale 6, exact
                line_total = (lc.extendedprice * (100 - lc.discount)
                              * (100 + lc.tax))
                total += np.where(has, line_total, 0)
                shipped = lc.shipdate <= _CURRENT_DATE
                all_f &= ~has | shipped
                all_o &= ~has | ~shipped
            totalprice = (total + 5000) // 10000  # half-up to scale 2
            status = np.where(all_f, 0, np.where(all_o, 1, 2)) \
                .astype(np.int32)  # F=0, O=1, P=2
        out: Dict[str, np.ndarray] = {}
        for c in columns:
            if c == "o_orderkey":
                out[c] = order_key_at(oidx)
            elif c == "o_custkey":
                out[c] = _customer_key(_S["o_custkey"], oidx, self.sf)
            elif c == "o_orderstatus":
                out[c] = status
            elif c == "o_totalprice":
                out[c] = totalprice
            elif c == "o_orderdate":
                out[c] = _order_date(oidx)
            elif c == "o_orderpriority":
                out[c] = _uniform_int(_S["o_priority"], oidx, 0,
                                      len(ORDER_PRIORITIES) - 1) \
                    .astype(np.int32)
            elif c == "o_clerk":
                nclerk = max(1, int(SUPPLIERS_PER_SF * self.sf) // 10) * 1000
                out[c] = _uniform_int(_S["o_clerk"], oidx, 1, nclerk) \
                    .astype(np.int32)
            elif c == "o_shippriority":
                out[c] = np.zeros(len(oidx), np.int32)
            elif c == "o_comment":
                out[c] = _uniform_int(_S["o_comment"], oidx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            else:
                raise KeyError(f"orders has no column {c}")
        return out

    def gen_customer(self, lo: int, hi: int,
                     columns: Sequence[str]) -> Dict[str, np.ndarray]:
        cidx = np.arange(lo, hi, dtype=np.int64)
        custkey = cidx + 1
        out: Dict[str, np.ndarray] = {}
        for c in columns:
            if c == "c_custkey":
                out[c] = custkey
            elif c == "c_name":
                out[c] = custkey.astype(np.int32)
            elif c == "c_address":
                out[c] = _uniform_int(_S["c_comment"] + 7, cidx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            elif c == "c_nationkey":
                out[c] = _uniform_int(_S["c_nation"], cidx, 0, 24) \
                    .astype(np.int64)
            elif c == "c_phone":
                out[c] = custkey.astype(np.int32)
            elif c == "c_acctbal":
                out[c] = _uniform_int(_S["c_acctbal"], cidx, -99999,
                                      999999)  # cents, scale 2
            elif c == "c_mktsegment":
                out[c] = _uniform_int(_S["c_segment"], cidx, 0,
                                      len(MKT_SEGMENTS) - 1).astype(np.int32)
            elif c == "c_comment":
                out[c] = _uniform_int(_S["c_comment"], cidx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            else:
                raise KeyError(f"customer has no column {c}")
        return out

    def gen_part(self, lo: int, hi: int, columns) -> Dict[str, np.ndarray]:
        pidx = np.arange(lo, hi, dtype=np.int64)
        partkey = pidx + 1
        out: Dict[str, np.ndarray] = {}
        for c in columns:
            if c == "p_partkey":
                out[c] = partkey
            elif c == "p_name":
                out[c] = _uniform_int(_S["p_comment"] + 3, pidx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            elif c == "p_mfgr":
                out[c] = _uniform_int(_S["p_mfgr"], pidx, 0, 4) \
                    .astype(np.int32)
            elif c == "p_brand":
                out[c] = _uniform_int(_S["p_brand"], pidx, 0, 24) \
                    .astype(np.int32)
            elif c == "p_type":
                out[c] = _uniform_int(_S["p_type"], pidx, 0, 149) \
                    .astype(np.int32)
            elif c == "p_size":
                out[c] = _uniform_int(_S["p_size"], pidx, 1, 50)
            elif c == "p_container":
                out[c] = _uniform_int(_S["p_container"], pidx, 0, 39) \
                    .astype(np.int32)
            elif c == "p_retailprice":
                out[c] = _part_price_cents(partkey)  # cents, scale 2
            elif c == "p_comment":
                out[c] = _uniform_int(_S["p_comment"], pidx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            else:
                raise KeyError(f"part has no column {c}")
        return out

    def gen_supplier(self, lo: int, hi: int, columns):
        sidx = np.arange(lo, hi, dtype=np.int64)
        suppkey = sidx + 1
        out: Dict[str, np.ndarray] = {}
        for c in columns:
            if c == "s_suppkey":
                out[c] = suppkey
            elif c == "s_name":
                out[c] = suppkey.astype(np.int32)
            elif c == "s_address":
                out[c] = _uniform_int(_S["s_comment"] + 5, sidx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            elif c == "s_nationkey":
                out[c] = _uniform_int(_S["s_nation"], sidx, 0, 24) \
                    .astype(np.int64)
            elif c == "s_phone":
                out[c] = suppkey.astype(np.int32)
            elif c == "s_acctbal":
                out[c] = _uniform_int(_S["s_acctbal"], sidx, -99999,
                                      999999)  # cents, scale 2
            elif c == "s_comment":
                out[c] = _uniform_int(_S["s_comment"], sidx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            else:
                raise KeyError(f"supplier has no column {c}")
        return out

    def gen_partsupp(self, lo: int, hi: int, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        partkey = idx // 4 + 1
        i4 = idx % 4
        nsupp = int(SUPPLIERS_PER_SF * self.sf)
        out: Dict[str, np.ndarray] = {}
        for c in columns:
            if c == "ps_partkey":
                out[c] = partkey
            elif c == "ps_suppkey":
                out[c] = (partkey + i4 * (nsupp // 4 + partkey // nsupp)) \
                    % nsupp + 1
            elif c == "ps_availqty":
                out[c] = _uniform_int(_S["ps_availqty"], idx, 1, 9999)
            elif c == "ps_supplycost":
                out[c] = _uniform_int(_S["ps_supplycost"], idx, 100,
                                      100000)  # cents, scale 2
            elif c == "ps_comment":
                out[c] = _uniform_int(_S["ps_comment"], idx, 0,
                                      len(_WORDS) ** 2 - 1).astype(np.int32)
            else:
                raise KeyError(f"partsupp has no column {c}")
        return out

    def gen_nation(self, lo: int, hi: int, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        name_dict = self._dicts["nation"]["n_name"]
        name_ids = np.array([name_dict.id_of(NATIONS[i]) for i in idx],
                            np.int32)
        out = {}
        for c in columns:
            if c == "n_nationkey":
                out[c] = idx
            elif c == "n_name":
                out[c] = name_ids
            elif c == "n_regionkey":
                out[c] = np.array([NATION_REGION[i] for i in idx], np.int64)
            elif c == "n_comment":
                out[c] = (idx % len(_WORDS) ** 2).astype(np.int32)
            else:
                raise KeyError(f"nation has no column {c}")
        return out

    def gen_region(self, lo: int, hi: int, columns):
        idx = np.arange(lo, hi, dtype=np.int64)
        name_dict = self._dicts["region"]["r_name"]
        name_ids = np.array([name_dict.id_of(REGIONS[i]) for i in idx],
                            np.int32)
        out = {}
        for c in columns:
            if c == "r_regionkey":
                out[c] = idx
            elif c == "r_name":
                out[c] = name_ids
            elif c == "r_comment":
                out[c] = (idx % len(_WORDS) ** 2).astype(np.int32)
            else:
                raise KeyError(f"region has no column {c}")
        return out

    def generate(self, table: str, lo: int, hi: int, columns):
        return getattr(self, f"gen_{table}")(lo, hi, columns)


def _phones(ids: np.ndarray) -> list:
    """Phone numbers 'cc-aaa-bbb-cccc' of customer/supplier ids."""
    h = _mix64(ids.astype(_U64) * _U64(31) + _U64(7))
    cc = (10 + ids % 25).tolist()
    a = (h % _U64(900) + _U64(100)).tolist()
    b = ((h >> _U64(10)) % _U64(900) + _U64(100)).tolist()
    c = ((h >> _U64(20)) % _U64(9000) + _U64(1000)).tolist()
    return [f"{w}-{x}-{y}-{z}" for w, x, y, z in zip(cc, a, b, c)]


# ---------------------------------------------------------------------------
# Schemas (TPC-H spec 1.4). Money/quantity columns are DECIMAL(12,2) — the
# spec's type — stored as exact scaled integers.
# ---------------------------------------------------------------------------

_MONEY = T.decimal(12, 2)

TPCH_SCHEMAS: Dict[str, T.DataType] = {
    "lineitem": T.row(
        ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
         "l_quantity", "l_extendedprice", "l_discount", "l_tax",
         "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
         "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment"],
        [T.BIGINT, T.BIGINT, T.BIGINT, T.INTEGER,
         _MONEY, _MONEY, _MONEY, _MONEY,
         T.VARCHAR, T.VARCHAR, T.DATE, T.DATE,
         T.DATE, T.VARCHAR, T.VARCHAR, T.VARCHAR]),
    "orders": T.row(
        ["o_orderkey", "o_custkey", "o_orderstatus", "o_totalprice",
         "o_orderdate", "o_orderpriority", "o_clerk", "o_shippriority",
         "o_comment"],
        [T.BIGINT, T.BIGINT, T.VARCHAR, _MONEY, T.DATE, T.VARCHAR,
         T.VARCHAR, T.INTEGER, T.VARCHAR]),
    "customer": T.row(
        ["c_custkey", "c_name", "c_address", "c_nationkey", "c_phone",
         "c_acctbal", "c_mktsegment", "c_comment"],
        [T.BIGINT, T.VARCHAR, T.VARCHAR, T.BIGINT, T.VARCHAR, _MONEY,
         T.VARCHAR, T.VARCHAR]),
    "part": T.row(
        ["p_partkey", "p_name", "p_mfgr", "p_brand", "p_type", "p_size",
         "p_container", "p_retailprice", "p_comment"],
        [T.BIGINT, T.VARCHAR, T.VARCHAR, T.VARCHAR, T.VARCHAR, T.BIGINT,
         T.VARCHAR, _MONEY, T.VARCHAR]),
    "supplier": T.row(
        ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone",
         "s_acctbal", "s_comment"],
        [T.BIGINT, T.VARCHAR, T.VARCHAR, T.BIGINT, T.VARCHAR, _MONEY,
         T.VARCHAR]),
    "partsupp": T.row(
        ["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost",
         "ps_comment"],
        [T.BIGINT, T.BIGINT, T.BIGINT, _MONEY, T.VARCHAR]),
    "nation": T.row(
        ["n_nationkey", "n_name", "n_regionkey", "n_comment"],
        [T.BIGINT, T.VARCHAR, T.BIGINT, T.VARCHAR]),
    "region": T.row(
        ["r_regionkey", "r_name", "r_comment"],
        [T.BIGINT, T.VARCHAR, T.VARCHAR]),
}


# DECIMAL(12,2) columns whose generated values provably fit int32 (cents):
# max l_extendedprice ~ 1.1e9, quantity <= 5000, discounts/taxes <= 10,
# acctbal <= 1e6, supplycost <= 1e5, retailprice ~ 2.1e6.
_NARROW_INT32 = frozenset({
    "l_quantity", "l_extendedprice", "l_discount", "l_tax",
    "c_acctbal", "s_acctbal", "ps_supplycost", "p_retailprice",
})


@dataclass(frozen=True)
class TpchSplit(ConnectorSplit):
    """A contiguous index range. For lineitem the range is *order* indices
    (parity: velox/connectors/tpch/TpchConnector.h parts = row ranges)."""
    table: str = ""
    lo: int = 0
    hi: int = 0


def storage_dtype(table: str, column: str) -> torch.dtype:
    """The dtype a column is stored in on the device."""
    if column in _NARROW_INT32:
        # values provably fit int32: halves device-memory traffic, and the
        # filter-sum kernel takes int32 columns only
        return torch.int32
    return TPCH_SCHEMAS[table].field_type(column).torch_dtype()


def stage_column(arr: np.ndarray, dtype: torch.dtype, capacity: int,
                 pin: bool) -> torch.Tensor:
    """One host pass: ``arr`` narrowed (or widened) to ``dtype`` into a
    new host tensor of ``capacity`` rows, zero past ``len(arr)``; pinned
    when ``pin``, so that its upload can run asynchronously. A failed pin
    raises."""
    host = torch.empty((capacity,), dtype=dtype, pin_memory=pin)
    view = host.numpy()
    n = len(arr)
    np.copyto(view[:n], arr, casting="unsafe")
    view[n:] = 0
    return host


class TpchDataSource(DataSource):
    def __init__(self, gen: TpchTableGen, table: str,
                 columns: Sequence[str], capacity: int, device):
        self._gen = gen
        self._device = torch.device(device)
        self._table = table
        self._columns = list(columns)
        self._schema = TPCH_SCHEMAS[table]
        self._capacity = capacity
        self._pending: Optional[Tuple[TpchSplit, int]] = None
        self._stream = None  # the CUDA stream of this source's uploads

    def dictionaries(self) -> Dict[str, Dictionary]:
        return self._gen.dictionaries(self._table)

    def next(self, split: TpchSplit) -> Optional[DeviceBatch]:
        if self._pending is None or self._pending[0] is not split:
            self._pending = (split, split.lo)
        _, pos = self._pending
        if pos >= split.hi:
            return None
        # generate in one go per split (splits are sized by the connector)
        lo, hi = pos, split.hi
        self._pending = (split, hi)
        # the device in the key: a CPU query never gets a CUDA batch
        key = ("tpch", self._gen.sf, self._table, tuple(self._columns),
               lo, hi, self._capacity, str(self._device))
        cache = DataCache.instance()
        batch = cache.get(key)
        if batch is None:
            batch = self._to_batch(
                self._gen.generate(self._table, lo, hi, self._columns))
            cache.put(key, batch)
        return batch

    def _to_batch(self, arrays: Dict[str, np.ndarray]) -> DeviceBatch:
        n = len(next(iter(arrays.values()))) if arrays else 0
        cap = self._capacity
        if n * 4 <= cap:
            # a short tail split gets its own, smaller capacity: every
            # operation on the batch runs over all `cap` rows
            cap = max(1024, default_capacity(n))
        dicts = self._gen.dictionaries(self._table)
        cuda = self._device.type == "cuda"
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self._device)
        # on the card, each column's copy runs on this source's stream
        # while the host narrows the next column
        with torch.cuda.stream(self._stream) if cuda else nullcontext():
            cols = {}
            for name in self._columns:
                host = stage_column(arrays[name],
                                    storage_dtype(self._table, name), cap,
                                    pin=cuda)
                cols[name] = DeviceColumn(
                    host.to(self._device, non_blocking=True), None,
                    self._schema.field_type(name), dicts.get(name))
            mask = prefix_mask(n, cap, self._device)
        if cuda:
            # published complete: a batch in the cache or the prefetch
            # queue never needs its reader's stream to wait for the upload
            self._stream.synchronize()
        return DeviceBatch(cols, mask)


class TpchConnector(Connector):
    """Parity: velox/connectors/tpch/TpchConnector.h:71."""

    def __init__(self, connector_id: str = "tpch", scale_factor: float = 0.01,
                 rows_per_split: int = 65536):
        super().__init__(connector_id)
        self.scale_factor = scale_factor
        self.rows_per_split = rows_per_split
        self.gen = TpchTableGen(scale_factor)
        self._max_rows_cache: Dict = {}

    def table_schema(self, table: str) -> T.DataType:
        return TPCH_SCHEMAS[table]

    # storage-int (min, max) bounds known by construction of the generator
    # (stats-based planning: the analogue of velox VectorHasher analyze /
    # parquet row-group stats). Used e.g. to prove limb-decomposition
    # safety for the fused filter-reduce kernel (ops/filter_reduce.py).
    _COLUMN_STATS = {
        "lineitem": {
            "l_quantity": (100, 5000),       # 1.00 .. 50.00 scale 2
            "l_discount": (0, 10),           # 0.00 .. 0.10 scale 2
            "l_tax": (0, 8),                 # 0.00 .. 0.08 scale 2
            "l_linenumber": (1, 7),
            # price formula max = 90000+20000+99900 (spec 4.2.3), qty <= 50
            "l_extendedprice": (90000, 209_900 * 50),
        },
    }

    def column_stats(self, table: str, column: str):
        """(min, max) storage-int bounds, or None when unknown.
        Scale-dependent key/date bounds are computed from the generator's
        own formulas (sparse orderkeys, date span)."""
        fixed = self._COLUMN_STATS.get(table, {}).get(column)
        if fixed is not None:
            return fixed
        n_orders = int(ORDERS_PER_SF * self.gen.sf)
        n_cust = int(CUSTOMERS_PER_SF * self.gen.sf)
        max_okey = int(order_key_at(np.asarray([max(0, n_orders - 1)]))[0])
        dates = (_EPOCH_1992, _EPOCH_1998_END)
        dyn = {
            ("lineitem", "l_orderkey"): (0, max_okey),
            ("orders", "o_orderkey"): (0, max_okey),
            ("lineitem", "l_shipdate"): dates,
            ("lineitem", "l_commitdate"): dates,
            ("lineitem", "l_receiptdate"): dates,
            ("orders", "o_orderdate"): dates,
            ("orders", "o_custkey"): (1, max(1, n_cust)),
            ("customer", "c_custkey"): (1, max(1, n_cust)),
            ("orders", "o_shippriority"): (0, 0),
        }
        return dyn.get((table, column))

    # dbgen primary keys: no duplicate values by construction (TPC-H spec
    # 1.4.2.2). Feeds core/stats.resolve_column_unique, which lets join
    # builds on these columns skip the device dup-keys check.
    _UNIQUE_COLUMNS = {
        ("orders", "o_orderkey"), ("customer", "c_custkey"),
        ("part", "p_partkey"), ("supplier", "s_suppkey"),
        ("nation", "n_nationkey"), ("region", "r_regionkey"),
    }

    def column_unique(self, table: str, column: str) -> bool:
        return (table, column) in self._UNIQUE_COLUMNS

    def create_data_source(self, table: str, columns, ctx) -> TpchDataSource:
        """A source that uploads to ``ctx.device``. Capacities are the
        reference's, so a batch has the same shape and prefix mask in both
        engines: for lineitem the exact largest split (a split covers
        rows_per_split/5 orders of 1-7 lines each), otherwise the split
        size capped at the table's size. Eager PyTorch gains nothing from
        the padding itself."""
        n = self.num_index_rows(table)
        if table == "lineitem":
            cap = default_capacity(
                self._max_split_rows(self._split_step(table), n))
        else:
            cap = default_capacity(min(self.rows_per_split, n))
        return TpchDataSource(self.gen, table, columns, cap, ctx.device)

    def num_index_rows(self, table: str) -> int:
        """Split-index domain size (order count for lineitem)."""
        if table == "lineitem":
            return int(ORDERS_PER_SF * self.gen.sf)
        return self.gen.num_rows(table)

    def _split_step(self, table: str) -> int:
        # lineitem splits are order ranges producing ~4x rows
        step = (self.rows_per_split // 5 if table == "lineitem"
                else self.rows_per_split)
        return max(1, step)

    def _max_split_rows(self, step: int, n_orders: int) -> int:
        """Exact max lineitem rows over the [lo, lo+step) order splits
        (one cached cheap numpy pass over per-order line counts)."""
        key = (step, n_orders)
        cached = self._max_rows_cache.get(key)
        if cached is None:
            counts = line_count_at(np.arange(n_orders, dtype=np.int64))
            sums = [int(counts[lo:lo + step].sum())
                    for lo in range(0, n_orders, step)]
            cached = max(sums) if sums else 1
            self._max_rows_cache[key] = cached
        return cached

    def default_splits(self, table: str) -> List[TpchSplit]:
        n = self.num_index_rows(table)
        step = self._split_step(table)
        return [TpchSplit(self.connector_id, table, lo, min(lo + step, n))
                for lo in range(0, n, step)]


def register_tpch(scale_factor: float = 0.01,
                  connector_id: str = "tpch") -> TpchConnector:
    """Register the TPC-H connector with the reference's adaptive split
    size: few large batches, capped at 8M lines so one lineitem batch
    stays well inside device memory."""
    # ~2 lineitem splits per table (rows_per_split counts LINE rows;
    # lineitem has ~4 lines/order): every batch pays fixed per-launch
    # costs, so few big batches win
    orders = int(ORDERS_PER_SF * scale_factor)
    rows_per_split = min(max(65536, orders * 2), 8 << 20)
    conn = TpchConnector(connector_id, scale_factor, rows_per_split)
    register_connector(conn)
    return conn

"""Spark UnsafeRow serializer (row-wise shuffle interop).

A copy of ``velox_tpu/serializers/unsaferow.py``. Role parity:
``velox/row/UnsafeRowFast.h:23`` + ``serializers/
UnsafeRowSerializer.h:22`` (Gluten/Spark shuffle format). Layout per row:

  [null bitset: ceil(nfields/64) x 8B little-endian words]
  [8B per field: fixed-width value inline; strings as (offset<<32 | size)
   pointing into the trailing variable-length region, 8B-aligned
   (UnsafeRowFast.cpp:354, UnsafeRowDeserializers.h:50); REAL is a 4-byte
   float in the low word of its 8-byte slot]

The stream format frames each row with a 4-byte big-endian size, matching
the reference's UnsafeRowVectorSerializer.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from velox_tpu_torch import types as T


def _fixed_bytes(value, dt: T.DataType) -> bytes:
    k = dt.kind
    if k is T.TypeKind.BOOLEAN:
        return struct.pack("<q", 1 if value else 0)
    if dt.is_integral or k in (T.TypeKind.DATE, T.TypeKind.TIMESTAMP,
                               T.TypeKind.DECIMAL):
        return struct.pack("<q", int(value))
    if k is T.TypeKind.REAL:
        # 4-byte float in the low word of the 8-byte slot (Spark layout)
        return struct.pack("<f", float(np.float32(value))) + b"\0" * 4
    if k is T.TypeKind.DOUBLE:
        return struct.pack("<d", float(value))
    raise TypeError(f"unsupported UnsafeRow type {dt}")


def serialize_rows(table) -> bytes:
    """pyarrow Table -> framed UnsafeRow stream."""
    n_fields = table.num_columns
    null_words = (n_fields + 63) // 64
    types = [T.from_arrow(f.type) for f in table.schema]
    cols = [table.column(i).to_pylist() for i in range(n_fields)]
    out = bytearray()
    for r in range(table.num_rows):
        nulls = [0] * null_words
        fixed = bytearray()
        var = bytearray()
        base = 8 * null_words + 8 * n_fields
        for f in range(n_fields):
            v = cols[f][r]
            if v is None:
                nulls[f // 64] |= 1 << (f % 64)
                fixed += struct.pack("<q", 0)
            elif types[f].is_string:
                b = v.encode() if isinstance(v, str) else bytes(v)
                off = base + len(var)
                fixed += struct.pack("<q", (off << 32) | len(b))
                var += b
                if len(var) % 8:
                    var += b"\0" * (8 - len(var) % 8)
            elif types[f].kind is T.TypeKind.DECIMAL:
                import decimal as pydec
                unscaled = int(pydec.Decimal(v).scaleb(types[f].scale))
                fixed += struct.pack("<q", unscaled)
            elif types[f].kind is T.TypeKind.TIMESTAMP:
                ts = v
                micros = int(ts.timestamp() * 1e6) if hasattr(
                    ts, "timestamp") else int(ts)
                fixed += struct.pack("<q", micros)
            elif types[f].kind is T.TypeKind.DATE:
                days = (np.datetime64(v, "D")
                        - np.datetime64("1970-01-01")).astype(int)
                fixed += struct.pack("<q", int(days))
            else:
                fixed += _fixed_bytes(v, types[f])
        row = b"".join(struct.pack("<q", w) for w in nulls) \
            + bytes(fixed) + bytes(var)
        out += struct.pack(">i", len(row)) + row
    return bytes(out)


def deserialize_rows(buf: bytes, row_type: T.DataType):
    """Framed UnsafeRow stream -> pyarrow Table."""
    import pyarrow as pa
    n_fields = len(row_type.children)
    null_words = (n_fields + 63) // 64
    cols: List[List] = [[] for _ in range(n_fields)]
    pos = 0
    while pos < len(buf):
        (size,) = struct.unpack_from(">i", buf, pos)
        pos += 4
        row = buf[pos:pos + size]
        pos += size
        nulls = struct.unpack_from(f"<{null_words}q", row, 0)
        for f, dt in enumerate(row_type.children):
            if nulls[f // 64] & (1 << (f % 64)):
                cols[f].append(None)
                continue
            (slot,) = struct.unpack_from("<q", row, 8 * null_words + 8 * f)
            if dt.is_string:
                off = (slot >> 32) & 0xFFFFFFFF
                ln = slot & 0xFFFFFFFF
                b = row[off:off + ln]
                cols[f].append(b.decode() if dt.kind is
                               T.TypeKind.VARCHAR else b)
            elif dt.kind is T.TypeKind.DOUBLE:
                (x,) = struct.unpack_from(
                    "<d", row, 8 * null_words + 8 * f)
                cols[f].append(x)
            elif dt.kind is T.TypeKind.REAL:
                (x,) = struct.unpack_from(
                    "<f", row, 8 * null_words + 8 * f)
                cols[f].append(x)
            elif dt.kind is T.TypeKind.BOOLEAN:
                cols[f].append(bool(slot))
            elif dt.kind is T.TypeKind.DECIMAL:
                import decimal as pydec
                cols[f].append(pydec.Decimal(slot).scaleb(-dt.scale))
            elif dt.kind is T.TypeKind.DATE:
                cols[f].append(
                    np.datetime64("1970-01-01") + np.timedelta64(slot, "D"))
            elif dt.kind is T.TypeKind.TIMESTAMP:
                cols[f].append(np.datetime64(slot, "us"))
            else:
                cols[f].append(slot)
    arrays = [pa.array(c, T.to_arrow(dt))
              for c, dt in zip(cols, row_type.children)]
    return pa.table(arrays, names=list(row_type.names))

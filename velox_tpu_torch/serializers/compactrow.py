"""CompactRow serializer (Spark shuffle, compact layout).

A copy of ``velox_tpu/serializers/compactrow.py``. Role parity:
``velox/row/CompactRow.h:23`` + ``serializers/
CompactRowSerializer.h:23``. Unlike UnsafeRow's fixed 8-byte slots,
CompactRow packs values at their natural widths:

  [null byte-per-8-fields bitmap][field values in order; fixed-width values
   at native size; strings as 4B little-endian length + bytes]

Rows framed with a 4-byte big-endian size (CompactRowSerializer parity).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from velox_tpu_torch import types as T

_WIDTH = {
    T.TypeKind.BOOLEAN: 1, T.TypeKind.TINYINT: 1, T.TypeKind.SMALLINT: 2,
    T.TypeKind.INTEGER: 4, T.TypeKind.BIGINT: 8, T.TypeKind.REAL: 4,
    T.TypeKind.DOUBLE: 8, T.TypeKind.DATE: 4, T.TypeKind.TIMESTAMP: 8,
    T.TypeKind.DECIMAL: 8,
}
_FMT = {1: "<b", 2: "<h", 4: "<i", 8: "<q"}


def serialize_rows(table) -> bytes:
    types = [T.from_arrow(f.type) for f in table.schema]
    n_fields = len(types)
    nb = (n_fields + 7) // 8
    cols = [table.column(i).to_pylist() for i in range(n_fields)]
    out = bytearray()
    for r in range(table.num_rows):
        nulls = bytearray(nb)
        body = bytearray()
        for f, dt in enumerate(types):
            v = cols[f][r]
            if v is None:
                nulls[f // 8] |= 1 << (f % 8)
                continue
            if dt.is_string:
                b = v.encode() if isinstance(v, str) else bytes(v)
                body += struct.pack("<i", len(b)) + b
            elif dt.kind is T.TypeKind.DECIMAL:
                import decimal as pydec
                body += struct.pack(
                    "<q", int(pydec.Decimal(v).scaleb(dt.scale)))
            elif dt.kind is T.TypeKind.DATE:
                days = (np.datetime64(v, "D")
                        - np.datetime64("1970-01-01")).astype(int)
                body += struct.pack("<i", int(days))
            elif dt.kind is T.TypeKind.TIMESTAMP:
                micros = int(v.timestamp() * 1e6) if hasattr(
                    v, "timestamp") else int(v)
                body += struct.pack("<q", micros)
            elif dt.kind in (T.TypeKind.REAL, T.TypeKind.DOUBLE):
                body += struct.pack(
                    "<f" if dt.kind is T.TypeKind.REAL else "<d", float(v))
            elif dt.kind is T.TypeKind.BOOLEAN:
                body += struct.pack("<b", 1 if v else 0)
            else:
                body += struct.pack(_FMT[_WIDTH[dt.kind]], int(v))
        row = bytes(nulls) + bytes(body)
        out += struct.pack(">i", len(row)) + row
    return bytes(out)


def deserialize_rows(buf: bytes, row_type: T.DataType):
    import pyarrow as pa
    types = list(row_type.children)
    n_fields = len(types)
    nb = (n_fields + 7) // 8
    cols: List[List] = [[] for _ in range(n_fields)]
    pos = 0
    while pos < len(buf):
        (size,) = struct.unpack_from(">i", buf, pos)
        pos += 4
        row = buf[pos:pos + size]
        pos += size
        off = nb
        for f, dt in enumerate(types):
            if row[f // 8] & (1 << (f % 8)):
                cols[f].append(None)
                continue
            if dt.is_string:
                (ln,) = struct.unpack_from("<i", row, off)
                off += 4
                b = row[off:off + ln]
                off += ln
                cols[f].append(b.decode() if dt.kind is
                               T.TypeKind.VARCHAR else b)
            elif dt.kind is T.TypeKind.REAL:
                (x,) = struct.unpack_from("<f", row, off)
                off += 4
                cols[f].append(x)
            elif dt.kind is T.TypeKind.DOUBLE:
                (x,) = struct.unpack_from("<d", row, off)
                off += 8
                cols[f].append(x)
            else:
                w = _WIDTH[dt.kind]
                (x,) = struct.unpack_from(_FMT[w], row, off)
                off += w
                if dt.kind is T.TypeKind.DECIMAL:
                    import decimal as pydec
                    x = pydec.Decimal(x).scaleb(-dt.scale)
                elif dt.kind is T.TypeKind.DATE:
                    x = np.datetime64("1970-01-01") + np.timedelta64(x, "D")
                elif dt.kind is T.TypeKind.TIMESTAMP:
                    x = np.datetime64(x, "us")
                elif dt.kind is T.TypeKind.BOOLEAN:
                    x = bool(x)
                cols[f].append(x)
    arrays = [pa.array(c, T.to_arrow(dt))
              for c, dt in zip(cols, types)]
    return pa.table(arrays, names=list(row_type.names))

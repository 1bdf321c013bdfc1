"""Wire serialization: framed Arrow IPC pages with compression + checksum.

Counterpart of ``velox_tpu/serializers/pages.py``. Role parity:
``velox/serializers/PrestoSerializer.h:30-70`` (PrestoPage: numRows +
codec byte + uncompressedSize + size + crc64 checksum header,
PrestoSerializer.cpp:36-117) and the VectorSerde registry
(vector/VectorStream.h). Per SURVEY.md §A.1: intra-slice exchange stays in
device-native layout (collectives); pages exist for *host/DCN boundaries*
(cross-host shuffle, host spill files, trace files).

Page layout: 24-byte header =
  numRows u32 | codec u8 | pad u24 | uncompressedSize u32 | size u32 |
  crc32-of-payload u64 (crc32 zero-extended)
followed by the (optionally lz4/zstd-compressed) Arrow IPC stream body.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

_HEADER = struct.Struct("<IBxxxIIQ")

CODEC_NONE = 0
CODEC_ZLIB = 1
CODEC_LZ4 = 2
CODEC_ZSTD = 3

_NAMES = {"none": CODEC_NONE, "zlib": CODEC_ZLIB, "lz4": CODEC_LZ4,
          "zstd": CODEC_ZSTD}


def _compress(body: bytes, codec: int) -> bytes:
    if codec == CODEC_NONE:
        return body
    if codec == CODEC_ZLIB:
        return zlib.compress(body, 1)
    if codec == CODEC_LZ4:
        import lz4.frame
        return lz4.frame.compress(body)
    if codec == CODEC_ZSTD:
        import zstandard
        return zstandard.ZstdCompressor().compress(body)
    raise ValueError(f"unknown codec {codec}")


def _decompress(body: bytes, codec: int, size: int) -> bytes:
    if codec == CODEC_NONE:
        return body
    if codec == CODEC_ZLIB:
        return zlib.decompress(body)
    if codec == CODEC_LZ4:
        import lz4.frame
        return lz4.frame.decompress(body)
    if codec == CODEC_ZSTD:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(body, size)
    raise ValueError(f"unknown codec {codec}")


def available_codec(preferred: str = "zstd") -> str:
    """Best available codec name (zstd/lz4 may not be installed)."""
    for name in (preferred, "zstd", "lz4", "zlib"):
        try:
            _compress(b"x", _NAMES[name])
            return name
        except Exception:
            continue
    return "none"


def serialize_page(table, codec: str = "none") -> bytes:
    """pyarrow Table -> framed page bytes."""
    import pyarrow as pa
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as w:
        w.write_table(table)
    body = sink.getvalue().to_pybytes()
    c = _NAMES[codec]
    comp = _compress(body, c)
    crc = zlib.crc32(comp)
    header = _HEADER.pack(table.num_rows, c, len(body), len(comp), crc)
    return header + comp


def deserialize_page(buf: bytes):
    """Framed page bytes -> pyarrow Table (checksum-verified)."""
    import pyarrow as pa
    num_rows, codec, usize, size, crc = _HEADER.unpack_from(buf, 0)
    comp = buf[_HEADER.size:_HEADER.size + size]
    if zlib.crc32(comp) != crc:
        raise IOError("page checksum mismatch")
    body = _decompress(comp, codec, usize)
    with pa.ipc.open_stream(pa.BufferReader(body)) as r:
        t = r.read_all()
    assert t.num_rows == num_rows, (t.num_rows, num_rows)
    return t


class PageSerde:
    """Device-batch <-> page bytes (the VectorSerde registry analogue):
    a batch is copied to the host as Arrow to serialize, and a page is
    uploaded onto ``device`` to deserialize."""

    def __init__(self, codec: Optional[str] = None, *, device):
        self.codec = codec or available_codec("zstd")
        self.device = device

    def serialize(self, batch) -> bytes:
        from velox_tpu_torch.vector.device import to_arrow
        return serialize_page(to_arrow(batch), self.codec)

    def serialize_table(self, table) -> bytes:
        return serialize_page(table, self.codec)

    def deserialize(self, buf: bytes, capacity=None, dictionaries=None):
        from velox_tpu_torch.vector.device import from_arrow
        return from_arrow(deserialize_page(buf), capacity=capacity,
                          dictionaries=dictionaries, device=self.device)

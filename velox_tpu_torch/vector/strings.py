"""Raw string columns: padded byte matrices on the device.

Counterpart of ``velox_tpu/vector/strings.py`` (velox/type/StringView.h
flat strings and the byte-level kernels of functions/lib/StringImpl). A
raw VARCHAR column is

* ``data``: a ``uint8[capacity, W]`` byte matrix, zero-padded, where W is
  the column's size class (16, 32, ..., 2048: the power of two at or above
  the longest value);
* ``children[0]``: an INTEGER column of byte lengths (int32).

It is the layout for high-cardinality VARCHAR (UUIDs, URLs, comments),
where a host dictionary would hold the whole column. Every function here
is plain torch over the matrix on its device; none reads a device value
on the host, except the case mapping and trims of rows with a byte at or
above 0x80, which run through pyarrow's ``utf8_*`` kernels on the host
(the dictionary path's mapping) and are counted under ``K_HOST_ROWS``
(common/metrics.py).

Ordering: big-endian 32-bit words over the zero-padded bytes compare as
the bytes do, and equal prefixes break by length, so ``sort_key_words``
gives W/4 words and a length word, and raw keys ride the counting radix
sort of exec/sort.py. Words are int64 tensors holding values in
[0, 2^32), as everywhere in exec/sort.py.

Where the reference's raw forms differ from its own dictionary path, this
module follows the dictionary path: ``reverse`` reverses code points, not
bytes, and ``upper``/``lower``/the trims map every code point as pyarrow's
kernels do, not only ASCII.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.vector.device import DeviceColumn

MIN_WIDTH = 16
MAX_WIDTH = 2048

# Bytes that pyarrow's utf8_trim_whitespace strips among the ASCII range:
# \t \n \v \f \r, the four separators 0x1C-0x1F, and the space.
_ASCII_SPACE = (9, 10, 11, 12, 13, 28, 29, 30, 31, 32)

# metric: rows sent through pyarrow on the host by upper/lower and the
# trims (a row holding a byte >= 0x80)
K_HOST_ROWS = "velox_tpu.strings.host_case_rows"

# (rows x W) elements a string function works on at once: its lane
# indices are int64, so 2^27 elements hold 1 GiB of them (15M rows of 128
# bytes would hold 15 GiB)
ROW_CHUNK_ELEMS = 1 << 27


def size_class(max_len: int) -> int:
    w = MIN_WIDTH
    while w < max_len:
        w <<= 1
    if w > MAX_WIDTH:
        raise ValueError(
            f"string length {max_len} exceeds the raw-string max width "
            f"{MAX_WIDTH}; use dictionary encoding for this column")
    return w


def is_raw(col) -> bool:
    """True for a raw string column or value: VARCHAR, no dictionary, a
    2-D byte matrix."""
    return (col is not None and getattr(col, "dtype", None) is not None
            and col.dtype.is_string and col.dictionary is None
            and getattr(col, "data", None) is not None
            and col.data.dim() == 2)


def reject_raw(values, what: str) -> None:
    """Raise NotImplementedError when a raw string is among ``values``
    (columns or values): for the operators and forms that the reference
    cannot run over one either (ROADMAP C)."""
    if any(is_raw(v) for v in values):
        raise NotImplementedError(
            f"{what} over a raw (dictionary-less) string is not supported")


def lens_of(col) -> torch.Tensor:
    """int32 byte lengths of a raw string column or value."""
    return col.children[0].data


def raw_column(bytes2d, lens, validity=None) -> DeviceColumn:
    return DeviceColumn(bytes2d, validity, T.VARCHAR, None,
                        (DeviceColumn(lens.to(torch.int32), None,
                                      T.INTEGER),))


def raw_value(bytes2d, lens, validity=None):
    from velox_tpu_torch.expression.eval import EvalValue
    return EvalValue(bytes2d, validity, T.VARCHAR, None,
                     children=(DeviceColumn(lens.to(torch.int32), None,
                                            T.INTEGER),))


def pad_width(bytes2d: torch.Tensor, w: int) -> torch.Tensor:
    """The byte matrix zero-padded on the right to width ``w``."""
    if bytes2d.shape[1] >= w:
        return bytes2d
    return torch.nn.functional.pad(bytes2d, (0, w - bytes2d.shape[1]))


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------

def pack_pylist(values, capacity: int,
                width: Optional[int] = None) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Python str/bytes/None list -> (uint8[capacity, W], int32 lens) on
    the host. None packs as empty (callers carry validity)."""
    bs = [(v.encode() if isinstance(v, str) else (v or b""))
          for v in values]
    max_len = max((len(b) for b in bs), default=0)
    w = width if width is not None else size_class(max_len)
    out = np.zeros((capacity, w), np.uint8)
    lens = np.zeros((capacity,), np.int32)
    for i, b in enumerate(bs):
        out[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return out, lens


def _arrow_parts(arr):
    """(n, int64 starts, int32 lens, data bytes, validity) of a pyarrow
    string array; a NULL row has length 0."""
    import pyarrow as pa
    import pyarrow.compute as pc
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_large_string(arr.type) or \
            pa.types.is_large_binary(arr.type):
        arr = arr.cast(pa.string())
    n = len(arr)
    validity = np.asarray(pc.is_valid(arr)) if arr.null_count else None
    offs = np.frombuffer(arr.buffers()[1], np.int32,
                         count=n + 1 + arr.offset)[arr.offset:]
    databuf = arr.buffers()[2]
    data = (np.frombuffer(databuf, np.uint8, count=len(databuf))
            if databuf is not None else np.zeros((0,), np.uint8))
    lens = np.diff(offs).astype(np.int32)
    if validity is not None:
        lens = np.where(validity, lens, 0).astype(np.int32)
    return n, offs[:-1].astype(np.int64), lens, data, validity


def pack_arrow(arr, capacity: int,
               width: Optional[int] = None) -> Tuple[np.ndarray,
                                                     np.ndarray,
                                                     Optional[np.ndarray]]:
    """pyarrow string array -> (bytes2d, lens, validity) on the host: the
    reference's vectorized pack. It builds an int64 (rows x W) index
    matrix, so ``pack_arrow_device`` is the ingest path; this one is its
    oracle."""
    n, starts, lens, data, validity = _arrow_parts(arr)
    max_len = int(lens.max()) if n else 0
    w = width if width is not None else size_class(max_len)
    lane = np.arange(w, dtype=np.int64)[None, :]
    idx = starts[:, None] + lane
    valid = lane < lens[:, None]
    idx = np.where(valid, idx, 0)
    out = np.where(valid, data[idx] if len(data) else 0, 0).astype(np.uint8)
    full = np.zeros((capacity, w), np.uint8)
    full[:n] = out
    full_lens = np.zeros((capacity,), np.int32)
    full_lens[:n] = lens
    if validity is not None:
        v = np.zeros((capacity,), bool)
        v[:n] = validity
        validity = v
    return full, full_lens, validity


def _stage(arr: np.ndarray, dtype: torch.dtype, size: int, device):
    """``arr`` on ``device`` as ``size`` elements of ``dtype``, zero past
    its end: the scan's one-pass upload (connectors/tpch.py
    ``stage_column``, pinned and copied asynchronously on the card)."""
    from velox_tpu_torch.connectors.tpch import stage_column
    cuda = torch.device(device).type == "cuda"
    host = stage_column(arr, dtype, size, pin=cuda)
    return host.to(device, non_blocking=True) if cuda else host


# index elements one gather of pack_arrow_device builds at most
_PACK_CHUNK = 1 << 26


def pack_arrow_device(arr, capacity: int, device,
                      width: Optional[int] = None):
    """pyarrow string array -> (bytes2d, lens, validity) tensors on
    ``device``, equal to ``pack_arrow`` bit for bit. Only the Arrow
    offsets and data buffer cross to the device, each in one host pass;
    the byte matrix is built there by one gather a chunk of rows (at most
    ``_PACK_CHUNK`` index elements), not by a host index matrix of
    rows x W int64."""
    n, starts, lens, data, validity = _arrow_parts(arr)
    max_len = int(lens.max()) if n else 0
    w = width if width is not None else size_class(max_len)
    base = int(starts.min()) if n else 0
    end = int((starts + lens).max()) if n else 0
    # one trailing zero byte: masked lanes read it
    d_buf = _stage(data[base:end], torch.uint8, end - base + 1, device)
    d_starts = _stage(starts - base, torch.int64, n, device)
    d_lens = _stage(lens, torch.int32, capacity, device)
    out = torch.zeros((capacity, w), dtype=torch.uint8, device=device)
    lane = torch.arange(w, dtype=torch.int64, device=device)[None, :]
    step = max(1, _PACK_CHUNK // w)
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        valid = lane < d_lens[lo:hi, None]
        idx = torch.where(valid, d_starts[lo:hi, None] + lane, end - base)
        out[lo:hi] = d_buf[idx]
    d_valid = (None if validity is None
               else _stage(validity, torch.bool, capacity, device))
    return out, d_lens, d_valid


def unpack_numpy(bytes2d: np.ndarray, lens: np.ndarray) -> list:
    """Host byte matrix -> Python str list (invalid UTF-8 kept as bytes)."""
    out = []
    for row, ln in zip(bytes2d, lens):
        b = bytes(row[:int(ln)])
        try:
            out.append(b.decode())
        except UnicodeDecodeError:
            out.append(b)
    return out


def to_arrow(bytes2d: np.ndarray, lens: np.ndarray,
             validity: Optional[np.ndarray]):
    """Host byte matrix -> pyarrow string array (vectorized build)."""
    import pyarrow as pa
    n = len(lens)
    lens64 = lens.astype(np.int64)
    offs = np.zeros((n + 1,), np.int32)
    offs[1:] = np.cumsum(lens64).astype(np.int32)
    lane = np.arange(bytes2d.shape[1], dtype=np.int64)[None, :]
    flat = bytes2d[lane < lens64[:, None]]  # row-major: the strings in order
    mask_buf = None
    if validity is not None and not validity.all():
        mask_buf = pa.py_buffer(np.packbits(validity, bitorder="little")
                                .tobytes())
    return pa.Array.from_buffers(
        pa.string(), n,
        [mask_buf, pa.py_buffer(offs.tobytes()),
         pa.py_buffer(flat.tobytes())])


def decode_rows(bytes2d: torch.Tensor, lens: torch.Tensor) -> List[str]:
    """Device rows -> Python str list (UTF-8)."""
    b = bytes2d.cpu().numpy()
    ln = lens.cpu().numpy()
    return [bytes(r[:int(k)]).decode() for r, k in zip(b, ln)]


# ---------------------------------------------------------------------------
# device functions over (rows, W) uint8
# ---------------------------------------------------------------------------

def _by_rows(fn):
    """Run a row-wise function over slices of at most ``ROW_CHUNK_ELEMS``
    (rows x W) elements and concatenate the results (byte matrices padded
    to the widest slice's class). Every argument with the first
    argument's row count is sliced; the rest pass through."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        rows, w = args[0].shape
        step = max(1, ROW_CHUNK_ELEMS // max(1, w))
        if rows <= step:
            return fn(*args, **kwargs)
        parts = [fn(*(a[lo:lo + step] if isinstance(a, torch.Tensor)
                      and a.dim() >= 1 and a.shape[0] == rows else a
                      for a in args), **kwargs)
                 for lo in range(0, rows, step)]

        def cat(xs):
            if xs[0].dim() == 2:
                wmax = max(x.shape[1] for x in xs)
                xs = [pad_width(x, wmax) for x in xs]
            return torch.cat(xs)
        if isinstance(parts[0], tuple):
            return tuple(cat([p[i] for p in parts])
                         for i in range(len(parts[0])))
        return cat(parts)
    return wrapped


def _lane(w: int, device) -> torch.Tensor:
    return torch.arange(w, dtype=torch.int32, device=device)[None, :]


def sort_key_words(bytes2d, lens) -> Tuple[List[torch.Tensor], List[int]]:
    """(words, bit widths) whose lexicographic order is string order:
    big-endian byte words, most significant first, then the length word
    to break zero-padding ties. Words are int64 in [0, 2^32)."""
    cap, w = bytes2d.shape
    b = bytes2d.reshape(cap, w // 4, 4)
    words = [(b[:, j, 0].to(torch.int64) << 24)
             | (b[:, j, 1].to(torch.int64) << 16)
             | (b[:, j, 2].to(torch.int64) << 8) | b[:, j, 3].to(torch.int64)
             for j in range(w // 4)]
    words.append(lens.to(torch.int64))
    return words, [32] * (w // 4) + [max(1, int(w).bit_length() + 1)]


@_by_rows
def equal(a_bytes, a_lens, b_bytes, b_lens) -> torch.Tensor:
    w = max(a_bytes.shape[1], b_bytes.shape[1])
    a_bytes, b_bytes = pad_width(a_bytes, w), pad_width(b_bytes, w)
    return (a_bytes == b_bytes).all(dim=1) & (a_lens == b_lens)


@_by_rows
def less(a_bytes, a_lens, b_bytes, b_lens,
         or_equal: bool = False) -> torch.Tensor:
    """Byte-wise lexicographic a < b (or <=)."""
    w = max(a_bytes.shape[1], b_bytes.shape[1])
    a_bytes, b_bytes = pad_width(a_bytes, w), pad_width(b_bytes, w)
    ne = a_bytes != b_bytes
    # the first differing byte decides; all bytes equal -> the shorter
    first = torch.argmax(ne.to(torch.uint8), dim=1, keepdim=True)
    a_at = torch.gather(a_bytes, 1, first)[:, 0]
    b_at = torch.gather(b_bytes, 1, first)[:, 0]
    tie = (a_lens <= b_lens) if or_equal else (a_lens < b_lens)
    return torch.where(ne.any(dim=1), a_at < b_at, tie)


def broadcast_literal(value, capacity: int, width: int, device):
    """A Python string literal as (bytes2d, lens) broadcast to capacity."""
    b = value.encode() if isinstance(value, str) else bytes(value)
    w = max(width, size_class(max(1, len(b))))
    row = torch.zeros((w,), dtype=torch.uint8, device=device)
    if b:
        row[:len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8) \
            .to(device)
    bytes2d = row[None, :].expand(capacity, w)
    lens = torch.full((capacity,), len(b), dtype=torch.int32, device=device)
    return bytes2d, lens


def length_bytes(lens) -> torch.Tensor:
    return lens.to(torch.int64)


def _char_starts(bytes2d, lens) -> torch.Tensor:
    """(rows, W) bool: the byte begins a UTF-8 code point (within the
    length)."""
    lane = _lane(bytes2d.shape[1], bytes2d.device)
    return (lane < lens[:, None]) & ((bytes2d & 0xC0) != 0x80)


@_by_rows
def length_chars(bytes2d, lens) -> torch.Tensor:
    """UTF-8 code-point count: bytes that are not continuation bytes
    (0b10xxxxxx) within the length."""
    return _char_starts(bytes2d, lens).sum(dim=1, dtype=torch.int64)


def shift_left(bytes2d, lens, nbytes):
    """Drop the first ``nbytes`` (per row) bytes: a gather along the
    lanes."""
    w = bytes2d.shape[1]
    lane = _lane(w, bytes2d.device)
    src = (lane + nbytes[:, None]).clamp(0, w - 1).to(torch.int64)
    out = torch.gather(bytes2d, 1, src)
    new_len = (lens - nbytes).clamp(min=0).to(torch.int32)
    out = torch.where(lane < new_len[:, None], out, 0).to(torch.uint8)
    return out, new_len


def truncate(bytes2d, lens, nbytes):
    """Keep only the first ``nbytes`` (per row) bytes."""
    lane = _lane(bytes2d.shape[1], bytes2d.device)
    new_len = torch.minimum(lens, nbytes).clamp(min=0).to(torch.int32)
    out = torch.where(lane < new_len[:, None], bytes2d, 0).to(torch.uint8)
    return out, new_len


def _char_to_byte(bytes2d, lens, char_idx):
    """Byte offset of the 1-based code point ``char_idx`` (per row); an
    index past the end maps to the length."""
    w = bytes2d.shape[1]
    starts = _char_starts(bytes2d, lens)
    rank = torch.cumsum(starts.to(torch.int32), dim=1)
    lane = _lane(w, bytes2d.device)
    hit = starts & (rank == char_idx[:, None])
    off = torch.where(hit, lane, w).amin(dim=1)
    return torch.minimum(off, lens)


@_by_rows
def substr(bytes2d, lens, start, length=None):
    """SQL substr: 1-based ``start`` in code points, negative from the
    end; ``length`` in code points (None: to the end)."""
    nchars = length_chars(bytes2d, lens).to(torch.int32)
    start = start.to(torch.int32)
    s = torch.where(start < 0, nchars + start + 1, start)
    invalid = (start == 0) | (s < 1) | (s > nchars)
    s = s.clamp(min=1)
    b0 = _char_to_byte(bytes2d, lens, s)
    out, out_len = shift_left(bytes2d, lens, b0)
    if length is not None:
        ln = length.to(torch.int32)
        bend = _char_to_byte(out, out_len, ln.clamp(min=0) + 1)
        out, out_len = truncate(out, out_len, bend)
        invalid = invalid | (ln < 0)
    lane = _lane(out.shape[1], out.device)
    out_len = torch.where(invalid, 0, out_len).to(torch.int32)
    out = torch.where(invalid[:, None] | (lane >= out_len[:, None]), 0,
                      out).to(torch.uint8)
    return out, out_len


@_by_rows
def concat(a_bytes, a_lens, b_bytes, b_lens):
    """a || b, at the size class of the two widths' sum (at most
    MAX_WIDTH)."""
    wa, wb = a_bytes.shape[1], b_bytes.shape[1]
    w = size_class(min(wa + wb, MAX_WIDTH))
    lane = _lane(w, a_bytes.device)
    a_pad = pad_width(a_bytes, w)
    b_pad = pad_width(b_bytes, w)
    # b shifted right by a's length: out[j] = b[j - len(a)]
    src = (lane - a_lens[:, None]).clamp(0, w - 1).to(torch.int64)
    b_shift = torch.gather(b_pad, 1, src)
    new_len = torch.minimum(a_lens + b_lens,
                            torch.tensor(w, device=a_lens.device)
                            ).to(torch.int32)
    out = torch.where(lane < a_lens[:, None], a_pad,
                      torch.where(lane < new_len[:, None], b_shift, 0))
    return out.to(torch.uint8), new_len


def _window_equal(bytes2d, lens, needle: bytes, at):
    """Per row: bytes[at : at + len(needle)] == needle."""
    w = bytes2d.shape[1]
    ok = (at >= 0) & (at + len(needle) <= lens)
    for j, ch in enumerate(needle):
        col = torch.gather(bytes2d, 1, (at + j).clamp(0, w - 1)
                           .to(torch.int64)[:, None])[:, 0]
        ok = ok & (col == ch)
    return ok


@_by_rows
def starts_with(bytes2d, lens, needle: bytes) -> torch.Tensor:
    return _window_equal(bytes2d, lens, needle, torch.zeros_like(lens))


@_by_rows
def ends_with(bytes2d, lens, needle: bytes) -> torch.Tensor:
    return _window_equal(bytes2d, lens, needle, lens - len(needle))


@_by_rows
def contains_at(bytes2d, lens, needle: bytes) -> torch.Tensor:
    """First byte position (0-based) of ``needle``, or -1: a compare at
    every offset, one shifted compare a needle byte."""
    cap, w = bytes2d.shape
    p = len(needle)
    dev = bytes2d.device
    if p == 0:
        return torch.zeros((cap,), dtype=torch.int32, device=dev)
    if p > w:
        return torch.full((cap,), -1, dtype=torch.int32, device=dev)
    match = torch.ones((cap, w), dtype=torch.bool, device=dev)
    for j, ch in enumerate(needle):
        shifted = bytes2d[:, j:]
        if j:
            shifted = torch.nn.functional.pad(shifted, (0, j))
        match = match & (shifted == ch)
    lane = _lane(w, dev)
    match = match & (lane + p <= lens[:, None])
    pos = torch.where(match, lane, w).amin(dim=1)
    return torch.where(pos == w, -1, pos).to(torch.int32)


@_by_rows
def strpos_chars(bytes2d, lens, needle: bytes) -> torch.Tensor:
    """Presto strpos: 1-based code-point position of ``needle``, 0 if
    absent."""
    byte_pos = contains_at(bytes2d, lens, needle)
    rank = torch.cumsum(_char_starts(bytes2d, lens).to(torch.int32), dim=1)
    w = bytes2d.shape[1]
    char_pos = torch.gather(rank, 1, byte_pos.clamp(0, w - 1)
                            .to(torch.int64)[:, None])[:, 0]
    return torch.where(byte_pos < 0, 0, char_pos).to(torch.int64)


@_by_rows
def like(bytes2d, lens, pattern: str, escape=None) -> torch.Tensor:
    """SQL LIKE by the pattern's shape (velox Re2Functions.cpp
    determinePatternKind): exact, prefix, suffix, and ordered '%'-separated
    segments. '_' raises, as in the reference."""
    segs: List[bytes] = []
    cur = bytearray()
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape is not None and c == escape and i + 1 < len(pattern):
            cur.extend(pattern[i + 1].encode())
            i += 2
            continue
        if c == "%":
            segs.append(bytes(cur))
            cur = bytearray()
        elif c == "_":
            raise NotImplementedError(
                "LIKE with '_' on raw string columns is not supported; "
                "use a dictionary-encoded column")
        else:
            cur.extend(c.encode())
        i += 1
    segs.append(bytes(cur))
    cap = bytes2d.shape[0]
    dev = bytes2d.device
    if len(segs) == 1:  # exact
        blit, llit = broadcast_literal(segs[0], cap, bytes2d.shape[1], dev)
        return equal(bytes2d, lens, blit, llit)
    ok = torch.ones((cap,), dtype=torch.bool, device=dev)
    first, *mids, last = segs
    if first:
        ok = ok & starts_with(bytes2d, lens, first)
    if last:
        ok = ok & ends_with(bytes2d, lens, last)
    # middle segments in order, after the prefix and before the suffix
    consumed = torch.full((cap,), len(first), dtype=torch.int32, device=dev)
    for m in mids:
        if not m:
            continue
        shifted, sl = shift_left(bytes2d, lens, consumed)
        pos = contains_at(shifted, sl, m)
        ok = ok & (pos >= 0)
        ok = ok & (consumed + pos + len(m) + len(last) <= lens)
        consumed = consumed + pos.clamp(min=0) + len(m)
    return ok & (lens >= consumed + len(last))


def _non_ascii_rows(bytes2d, lens) -> torch.Tensor:
    lane = _lane(bytes2d.shape[1], bytes2d.device)
    return ((bytes2d >= 0x80) & (lane < lens[:, None])).any(dim=1)


def _host_map(bytes2d, lens, rows: torch.Tensor, pa_name: str, py_f):
    """Rows ``rows`` mapped through pyarrow's ``pa_name`` kernel on the
    host (``py_f`` where pyarrow rejects the input, as the dictionary
    path does), written back; the matrix widens if a result needs it."""
    import pyarrow as pa
    import pyarrow.compute as pc
    idx = torch.nonzero(rows).flatten()
    if idx.numel() == 0:
        return bytes2d, lens
    M.record_counter(K_HOST_ROWS, idx.numel())
    vals = decode_rows(bytes2d[idx], lens[idx])
    try:
        mapped = getattr(pc, pa_name)(pa.array(vals, pa.string()))
        mapped = mapped.to_pylist()
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        mapped = [py_f(s) for s in vals]
    mb, ml = pack_pylist(mapped, len(mapped))
    w = max(bytes2d.shape[1], mb.shape[1])
    out = pad_width(bytes2d, w).clone()
    out_lens = lens.clone()
    dev = bytes2d.device
    out[idx] = pad_width(torch.from_numpy(mb).to(dev), w)
    out_lens[idx] = torch.from_numpy(ml).to(dev)
    return out, out_lens


@_by_rows
def upper(bytes2d, lens):
    """ASCII rows mapped on the device; rows with a byte >= 0x80 through
    pyarrow's utf8_upper on the host."""
    is_lower = (bytes2d >= ord("a")) & (bytes2d <= ord("z"))
    out = torch.where(is_lower, bytes2d - 32, bytes2d).to(torch.uint8)
    return _host_map(out, lens, _non_ascii_rows(bytes2d, lens),
                     "utf8_upper", str.upper)


@_by_rows
def lower(bytes2d, lens):
    """ASCII rows mapped on the device; rows with a byte >= 0x80 through
    pyarrow's utf8_lower on the host."""
    is_upper = (bytes2d >= ord("A")) & (bytes2d <= ord("Z"))
    out = torch.where(is_upper, bytes2d + 32, bytes2d).to(torch.uint8)
    return _host_map(out, lens, _non_ascii_rows(bytes2d, lens),
                     "utf8_lower", str.lower)


def _spaces(bytes2d, lens):
    lane = _lane(bytes2d.shape[1], bytes2d.device)
    in_len = lane < lens[:, None]
    sp = torch.zeros_like(in_len)
    for c in _ASCII_SPACE:
        sp = sp | (bytes2d == c)
    return sp & in_len, lane, in_len


def _ltrim_ascii(bytes2d, lens):
    sp, lane, in_len = _spaces(bytes2d, lens)
    first = torch.where(in_len & ~sp, lane, lens[:, None]).amin(dim=1)
    return shift_left(bytes2d, lens, first.to(torch.int32))


def _rtrim_ascii(bytes2d, lens):
    sp, lane, in_len = _spaces(bytes2d, lens)
    last = torch.where(in_len & ~sp, lane + 1, 0).amax(dim=1)
    return truncate(bytes2d, lens, last.to(torch.int32))


def _trim_form(bytes2d, lens, left: bool, right: bool, pa_name, py_f):
    out, out_lens = bytes2d, lens
    if left:
        out, out_lens = _ltrim_ascii(out, out_lens)
    if right:
        out, out_lens = _rtrim_ascii(out, out_lens)
    return _host_map(out, out_lens, _non_ascii_rows(bytes2d, lens),
                     pa_name, py_f)


@_by_rows
def trim(bytes2d, lens):
    """pyarrow's utf8_trim_whitespace: ASCII rows on the device."""
    return _trim_form(bytes2d, lens, True, True, "utf8_trim_whitespace",
                      str.strip)


@_by_rows
def ltrim(bytes2d, lens):
    return _trim_form(bytes2d, lens, True, False, "utf8_ltrim_whitespace",
                      str.lstrip)


@_by_rows
def rtrim(bytes2d, lens):
    return _trim_form(bytes2d, lens, False, True, "utf8_rtrim_whitespace",
                      str.rstrip)


@_by_rows
def reverse(bytes2d, lens):
    """Code-point reversal within each row, on the device: the code point
    at bytes [s, e) moves to [len - e, len - s) with its bytes in order,
    so the result stays valid UTF-8 (a lead byte is known per byte)."""
    cap, w = bytes2d.shape
    lane = _lane(w, bytes2d.device).expand(cap, w)
    in_len = lane < lens[:, None]
    start = in_len & ((bytes2d & 0xC0) != 0x80)
    # s: the start of the code point holding each byte
    s = torch.cummax(torch.where(start, lane, 0), dim=1).values
    # e: the next code point's start (or the length)
    nxt = torch.where(start, lane, w)
    nxt = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], w)], dim=1)
    e = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    e = torch.minimum(e, lens[:, None])
    dst = torch.where(in_len, lens[:, None] - e + (lane - s), w)
    out = torch.zeros((cap, w + 1), dtype=torch.uint8, device=bytes2d.device)
    out.scatter_(1, dst.to(torch.int64), bytes2d)
    return out[:, :w].contiguous(), lens

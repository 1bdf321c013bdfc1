"""Device-resident columnar batches held as torch tensors.

Counterpart of ``velox_tpu/vector/device.py``. A ``DeviceBatch`` holds one
dense tensor per column, padded to a ``capacity`` (multiples of 1024 as in
the reference, so masks and batch shapes line up across the two engines),
plus a bool ``mask`` of active rows. Every tensor of a batch lies on one
``torch.device``; nothing here moves data between devices except the
Arrow bridge, which copies to and from the host.

Scan batches keep the reference's prefix contract: ``mask`` is
``arange(capacity) < n``. The filter-sum kernel relies on it
(``ops/filter_reduce.py``). Filters AND into the mask and keep rows in
place, as in the reference.

A VARCHAR column is either dictionary-encoded (int32 ids into a host
``Dictionary``) or raw: a (capacity, W) uint8 byte matrix with its int32
byte lengths as ``children[0]`` (vector/strings.py). ``from_arrow`` picks
the encoding by ``string_encoding``.

ARRAY and MAP columns (velox/vector/ComplexVector.h) keep Arrow's
offsets + values layout split in two: ``data`` holds each row's element
count (int32) and ``children`` the flattened element columns with their
own element capacity ([values] for ARRAY, [keys, values] for MAP). A
column fresh from ingest or from a function is *dense*: row i's elements
start at the sum of the counts before it. A row gather (a join, a sort,
a concatenation of batches) shares the children and gives the column
explicit per-row ``starts`` instead, as Velox's rawOffsets do. A ROW
column's children are its fields, row-aligned with it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common.process_trace import Span, site

# building and uploading an unsorted dictionary's rank table
_RANK_SITE = site("dictionary_rank")
# the maps of a dictionary's values (``Dictionary.mapped``) it keeps
MAX_MAPS = 16


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def default_capacity(n: int) -> int:
    """Pad row counts to multiples of 1024 with a floor of 1024."""
    return max(1024, round_up(n, 1024))


def order_of(keys: np.ndarray):
    """True where ``keys`` strictly increase with their index, else the
    dense rank of each key (int32: equal keys, equal ranks)."""
    if len(keys) < 2 or bool(np.all(keys[:-1] < keys[1:])):
        return True
    with Span(_RANK_SITE):
        _, inverse = np.unique(keys, return_inverse=True)
        return inverse.astype(np.int32).reshape(-1)


class Dictionary:
    """A host-side value dictionary for a string column.

    Hash/eq by identity, as in the reference. Values are a numpy object
    array of Python str/bytes; device columns hold int32 ids into it.

    The dictionary keeps one memo of its order (``ranks``): *sorted*
    where its values strictly increase with the id, so ids order and
    compare like the values, or else the dense rank of each id's value
    (equal values, equal rank). It is worked out once on the host, and
    its device copy is kept per device (``device_ranks``). A maker whose
    values are sorted by construction states it (``is_sorted=True``) and
    the memo costs nothing. Sort keys (exec/sort.py) and ordered string
    comparisons (functions/scalar.py) read it.

    It keeps, likewise, the maps of its values through a function with
    constant arguments (``mapped``): substr's new dictionary and id
    remap are built once a dictionary, not once a batch.
    """

    __slots__ = ("values", "_index", "_order", "_arrow", "_device_ranks",
                 "_maps")

    def __init__(self, values, is_sorted: bool = False):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[Dict] = None
        # the order memo: None until asked, True when sorted, else ranks
        self._order = True if is_sorted else None
        self._arrow = None  # (arrow type, the values as one Arrow array)
        self._device_ranks: Dict[torch.device, torch.Tensor] = {}
        self._maps: Dict = {}

    def __getstate__(self):
        # pickled (the SSD tier) by value and order, never a device copy
        return self.values, self._order

    def __setstate__(self, state):
        self.values, self._order = state
        self._index = self._arrow = None
        self._device_ranks, self._maps = {}, {}

    def ranks(self) -> Optional[np.ndarray]:
        """None when the dictionary is sorted; else each id's dense rank
        among the values (int32), built once."""
        if self._order is None:
            self._order = order_of(self._order_keys())
        return None if self._order is True else self._order

    def _order_keys(self) -> np.ndarray:
        """An array whose entries order as the values do."""
        return self.values

    @property
    def is_sorted(self) -> bool:
        """Whether ids order like the values (the ``ranks`` memo)."""
        return self.ranks() is None

    def device_ranks(self, device) -> torch.Tensor:
        """``ranks()`` of an unsorted dictionary as an int32 tensor on
        ``device``, uploaded once a device."""
        device = torch.device(device)
        t = self._device_ranks.get(device)
        if t is None:
            ranks = self.ranks()
            if ranks is None:
                raise ValueError("a sorted dictionary's ids are its ranks")
            with Span(_RANK_SITE):
                t = torch.from_numpy(ranks).to(device)
            self._device_ranks[device] = t
        return t

    def mapped(self, key, build):
        """``build()``, the map of the values that ``key`` names (a
        function and its constant arguments), built once a dictionary;
        past ``MAX_MAPS`` keys the oldest is dropped."""
        got = self._maps.get(key)
        if got is None:
            got = build()
            if len(self._maps) >= MAX_MAPS:
                self._maps.pop(next(iter(self._maps)))
            self._maps[key] = got
        return got

    def __len__(self):
        return len(self.values)

    def _arrow_values(self, arrow_type):
        """The values as one Arrow array of ``arrow_type`` (None: the type
        pyarrow infers), converted once per dictionary and type."""
        import pyarrow as pa
        if self._arrow is None or self._arrow[0] != arrow_type:
            self._arrow = (arrow_type, pa.array(self.values,
                                                type=arrow_type))
        return self._arrow[1]

    def arrow(self):
        """The values as one pyarrow array of the type pyarrow infers,
        converted once: the input of a vectorized dictionary-space
        transform."""
        return self._arrow_values(None)

    def id_of(self, value) -> int:
        """Return the id of `value`, or -1 if absent (never matches)."""
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index.get(value, -1)

    def take(self, ids: np.ndarray) -> np.ndarray:
        """Materialize values for the given ids (overridable for lazily
        formatted dictionaries, e.g. tpch c_name)."""
        return self.values[np.clip(ids, 0, len(self) - 1)]

    def arrow_take(self, ids: np.ndarray, validity: Optional[np.ndarray],
                   arrow_type):
        """The values of ``ids`` as one Arrow array of ``arrow_type``,
        NULL where ``validity`` is false: one Arrow take over the
        dictionary's values, converted to Arrow once per dictionary, so
        no Python object is built per row. Ids clip as ``take``'s do."""
        import pyarrow as pa
        import pyarrow.compute as pc
        idx = np.clip(ids, 0, max(len(self) - 1, 0)).astype(np.int64)
        mask = None if validity is None else ~validity
        return pc.take(self._arrow_values(arrow_type),
                       pa.array(idx, mask=mask))

    def __repr__(self):
        return f"Dictionary({len(self.values)} values)"


class DeviceColumn:
    """One column: dense data tensor + optional validity (True = non-null).

    ``validity is None`` means no nulls. Strings are int32 dictionary ids
    into ``dictionary``, or, without a dictionary, a raw (rows x W) uint8
    byte matrix with its int32 byte lengths as ``children[0]``. A
    DECIMAL(19..38) column keeps its low int64 limb in ``data`` and its
    high limb as ``children[0]`` (a BIGINT column). ARRAY/MAP: element
    counts in ``data``, element columns in ``children`` and, after a row
    gather, int64 element ``starts`` per row (None: dense). ROW: an int32
    placeholder in ``data`` and the fields in ``children``.
    """

    def __init__(self, data: torch.Tensor, validity=None,
                 dtype: T.DataType = T.BIGINT,
                 dictionary: Optional[Dictionary] = None,
                 children: Optional[tuple] = None,
                 starts: Optional[torch.Tensor] = None):
        self.data = data
        self.validity = validity
        self.dtype = dtype
        self.dictionary = dictionary
        self.children = tuple(children) if children else ()
        self.starts = starts

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def offsets(self) -> torch.Tensor:
        """Each row's first element (int64): the explicit starts, or the
        dense layout's exclusive prefix sum of the counts."""
        return element_offsets(self.data, self.starts)

    def __repr__(self):
        return (f"DeviceColumn({self.dtype}, cap={self.capacity}, "
                f"nulls={'y' if self.validity is not None else 'n'})")


def element_offsets(lengths: torch.Tensor,
                    starts: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-row element starts of an ARRAY/MAP value: ``starts`` when
    explicit, else the exclusive prefix sum of ``lengths``."""
    if starts is not None:
        return starts.to(torch.int64)
    lens = lengths.to(torch.int64)
    return torch.cumsum(lens, 0) - lens


class DeviceBatch:
    """A batch of rows on one device: named columns + an active-row mask.

    ``errors`` (optional) is a 0-dim int32 tensor counting checked-
    operation failures produced while computing this batch; the Task
    strips and sums them and reads the total once at query end
    (common/errors.py).
    """

    def __init__(self, columns: Dict[str, DeviceColumn], mask: torch.Tensor,
                 errors: Optional[torch.Tensor] = None):
        self.columns = columns
        self.mask = mask
        self.errors = errors

    @property
    def capacity(self) -> int:
        return self.mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mask.device

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> DeviceColumn:
        return self.columns[name]

    def num_active(self) -> torch.Tensor:
        """Count of active rows as a 0-dim int32 tensor (no host sync)."""
        return self.mask.sum(dtype=torch.int32)

    @property
    def nbytes(self) -> int:
        """Device-memory footprint: data + validity + mask bytes, with
        every child column's and explicit starts'."""
        def col_bytes(c) -> int:
            n = c.data.numel() * c.data.element_size()
            if c.validity is not None:
                n += c.validity.numel() * c.validity.element_size()
            if c.starts is not None:
                n += c.starts.numel() * c.starts.element_size()
            for ch in c.children:
                n += col_bytes(ch)
            return n
        total = self.mask.numel() * self.mask.element_size()
        for c in self.columns.values():
            total += col_bytes(c)
        return total

    def row_type(self) -> T.DataType:
        names = list(self.columns)
        return T.row(names, [self.columns[n].dtype for n in names])

    def with_mask(self, mask: torch.Tensor) -> "DeviceBatch":
        """The same columns under another active-row mask; the batch's
        error count goes with them."""
        return DeviceBatch(self.columns, mask, self.errors)

    def with_columns(self, columns: Dict[str, DeviceColumn]) -> "DeviceBatch":
        """Other columns under the same mask and error count."""
        return DeviceBatch(columns, self.mask, self.errors)

    def __repr__(self):
        return f"DeviceBatch(cap={self.capacity}, cols={list(self.columns)})"


def prefix_mask(n, capacity: int, device) -> torch.Tensor:
    """The scan-batch mask ``arange(capacity) < n``."""
    return torch.arange(capacity, dtype=torch.int32, device=device) < n


# ---------------------------------------------------------------------------
# Host bridges.
# ---------------------------------------------------------------------------

def _pad_np(arr: np.ndarray, capacity: int, fill=0) -> np.ndarray:
    n = arr.shape[0]
    if n == capacity:
        return arr
    out = np.full((capacity,), fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def _upload(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a view of an Arrow buffer
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def batch_from_numpy(columns: Dict[str, Sequence[np.ndarray]],
                     mask: np.ndarray,
                     dtypes: Dict[str, T.DataType],
                     dictionaries: Optional[Dict[str, Dictionary]] = None,
                     *, device) -> DeviceBatch:
    """Build a batch from host arrays, e.g. a reference batch after
    ``jax.device_get``.

    ``columns`` maps a name to ``(data, validity, *children)``: validity is
    a bool array or None, and each child array becomes a BIGINT child
    column (the high limb of a long decimal). Arrays keep their dtypes.
    """
    dictionaries = dictionaries or {}
    cols = {}
    for name, (data, validity, *kids) in columns.items():
        children = tuple(DeviceColumn(_upload(np.asarray(k), device), None,
                                      T.BIGINT) for k in kids)
        cols[name] = DeviceColumn(
            _upload(np.asarray(data), device),
            None if validity is None else _upload(np.asarray(validity,
                                                             bool), device),
            dtypes[name], dictionaries.get(name), children)
    return DeviceBatch(cols, _upload(np.asarray(mask, bool), device))


def _use_raw(arr, n: int, string_encoding: str) -> bool:
    """Whether a VARCHAR array goes raw: "raw" always, "auto" when its
    distinct count exceeds half the rows (a dictionary would hold about
    the column) and its longest value fits a size class."""
    import pyarrow.compute as pc
    from velox_tpu_torch.vector import strings as S
    if string_encoding == "raw":
        return True
    if string_encoding != "auto" or not n:
        return False
    distinct = pc.count_distinct(arr).as_py()
    max_len = pc.max(pc.binary_length(arr)).as_py() or 0
    return distinct > n // 2 and max_len <= S.MAX_WIDTH


def column_from_arrow(arr, capacity: int,
                      dictionary: Optional[Dictionary] = None,
                      string_encoding: str = "dict",
                      *, device) -> DeviceColumn:
    """One pyarrow Array/ChunkedArray -> DeviceColumn.

    ``string_encoding`` picks a VARCHAR column's layout: "dict" (sorted
    dictionary ids), "raw" (a byte matrix packed on the device,
    vector/strings.py) or "auto" (raw when the distinct count exceeds half
    the rows). A dictionary-typed Arrow array stays a dictionary. The
    element and field columns of ARRAY/MAP/ROW values are dictionary-
    encoded, as in the reference."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    dtype = T.from_arrow(arr.type)
    n = len(arr)
    if dtype.is_string and dictionary is None \
            and not pa.types.is_dictionary(arr.type) \
            and _use_raw(arr, n, string_encoding):
        from velox_tpu_torch.vector import strings as S
        return S.raw_column(*S.pack_arrow_device(arr, capacity, device))
    validity_np = np.asarray(pc.is_valid(arr)) if arr.null_count else None
    children = ()
    col_dict = None
    if dtype.is_complex:
        return _complex_from_arrow(arr, dtype, capacity, validity_np, device)
    if dtype.is_string:
        darr = (arr if pa.types.is_dictionary(arr.type)
                else pc.dictionary_encode(arr))
        ids = np.asarray(darr.indices.fill_null(0)).astype(np.int32)
        values = darr.dictionary.to_pylist()
        if dictionary is None and len(values) > 1:
            # sorted local dictionary: ids become order-preserving
            order = sorted(range(len(values)), key=lambda i: values[i])
            remap = np.empty(len(values), dtype=np.int32)
            remap[np.asarray(order)] = np.arange(len(values), dtype=np.int32)
            ids = remap[ids]
            values = [values[i] for i in order]
        if dictionary is not None:
            remap = np.array([dictionary.id_of(v) for v in values],
                             dtype=np.int32)
            if (remap < 0).any():
                missing = [v for v, r in zip(values, remap) if r < 0]
                raise ValueError(
                    f"values {missing[:5]} missing from stable dictionary")
            if len(values):  # else every row is NULL and keeps id 0
                ids = remap[ids]
            col_dict = dictionary
        else:
            # dictionary_encode's values are distinct, so sorted they
            # strictly increase; an Arrow dictionary may repeat values
            col_dict = Dictionary(
                values, is_sorted=not pa.types.is_dictionary(arr.type))
        data_np = _pad_np(ids, capacity)
    elif dtype.kind is T.TypeKind.DECIMAL:
        # decimal128 storage: little-endian (lo, hi) int64 limb pairs
        buf = arr.buffers()[1]
        limbs = np.frombuffer(buf, dtype=np.int64, count=2 * (arr.offset + n))
        limbs = limbs[2 * arr.offset:].reshape(-1, 2)
        data_np = _pad_np(np.ascontiguousarray(limbs[:, 0]), capacity)
        if dtype.is_long_decimal:
            children = (DeviceColumn(_upload(_pad_np(
                np.ascontiguousarray(limbs[:, 1]), capacity), device),
                None, T.BIGINT),)
    elif dtype.kind is T.TypeKind.TIMESTAMP:
        data_np = _pad_np(np.asarray(arr.cast(pa.timestamp("us")))
                          .astype(np.int64), capacity)
    elif dtype.kind is T.TypeKind.DATE:
        data_np = _pad_np(np.asarray(arr.cast(pa.int32())).astype(np.int32),
                          capacity)
    elif dtype.kind is T.TypeKind.UNKNOWN:
        data_np = np.zeros((capacity,), dtype=np.bool_)
        validity_np = np.zeros((n,), dtype=np.bool_)
    else:
        if arr.null_count:
            arr = arr.fill_null(False if pa.types.is_boolean(arr.type) else 0)
        data_np = _pad_np(np.asarray(arr).astype(dtype.np_dtype()), capacity)
    validity = (None if validity_np is None
                else _upload(_pad_np(validity_np, capacity, False), device))
    return DeviceColumn(_upload(data_np, device), validity, dtype, col_dict,
                        children)


def _complex_from_arrow(arr, dtype: T.DataType, capacity: int,
                        validity_np: Optional[np.ndarray],
                        device) -> DeviceColumn:
    """An ARRAY, MAP or ROW array in the dense layout. A NULL row's
    elements are dropped whatever its slot holds: Arrow lets a NULL list
    or map own a non-empty slot, and keeping it would shift every later
    row's elements (the reference's MAP ingest does, ROADMAP C)."""
    import pyarrow as pa
    n = len(arr)
    validity = (None if validity_np is None
                else _upload(_pad_np(validity_np, capacity, False), device))
    if dtype.kind is T.TypeKind.ROW:
        # fields are row-aligned: they share the parent's capacity
        kids = tuple(column_from_arrow(arr.field(i), capacity, device=device)
                     for i in range(arr.type.num_fields))
        data = torch.zeros((capacity,), dtype=torch.int32, device=device)
        return DeviceColumn(data, validity, dtype, None, kids)
    offs = np.asarray(arr.offsets, dtype=np.int64)
    lengths = np.diff(offs)
    if validity_np is not None:
        lengths = np.where(validity_np, lengths, 0)
    # the valid rows' slots, as positions into the (unsliced) values
    total = int(lengths.sum())
    first = np.repeat(offs[:-1] - (np.cumsum(lengths) - lengths), lengths)
    idx = pa.array(first + np.arange(total, dtype=np.int64))
    if dtype.kind is T.TypeKind.ARRAY:
        parts = (arr.values.take(idx),)
    else:  # MAP
        parts = (arr.keys.take(idx), arr.items.take(idx))
    elem_cap = default_capacity(total)
    kids = tuple(column_from_arrow(p, elem_cap, device=device) for p in parts)
    data = _upload(_pad_np(lengths.astype(np.int32), capacity), device)
    return DeviceColumn(data, validity, dtype, None, kids)


def from_arrow(table, capacity: Optional[int] = None,
               dictionaries: Optional[Dict[str, Dictionary]] = None,
               string_encoding="dict", *, device) -> DeviceBatch:
    """pyarrow Table/RecordBatch -> DeviceBatch (padded, masked).
    ``string_encoding`` is one encoding for every VARCHAR column or a dict
    of column name to encoding ("dict" for the columns it omits)."""
    n = table.num_rows
    cap = capacity if capacity is not None else default_capacity(n)
    if n > cap:
        raise ValueError(f"{n} rows exceed capacity {cap}")
    dictionaries = dictionaries or {}

    def enc(name):
        if isinstance(string_encoding, dict):
            return string_encoding.get(name, "dict")
        return string_encoding
    cols = {name: column_from_arrow(table.column(name), cap,
                                    dictionaries.get(name), enc(name),
                                    device=device)
            for name in table.schema.names}
    return DeviceBatch(cols, prefix_mask(n, cap, device))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def column_to_numpy(col: DeviceColumn
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A column's data and validity (None when it has none) on the host,
    every row of its capacity."""
    return _host(col.data), (None if col.validity is None
                             else _host(col.validity))


def to_arrow(batch: DeviceBatch):
    """DeviceBatch -> pyarrow Table (active rows only, in order)."""
    import pyarrow as pa

    mask = _host(batch.mask)
    n = int(mask.sum())
    # a scan batch's prefix mask takes each column's first n rows as a
    # view; any other mask gathers the active rows
    rows = slice(0, n) if mask[:n].all() else np.flatnonzero(mask)
    arrays = [_column_to_arrow(col, rows) for col in batch.columns.values()]
    return pa.table(arrays, names=list(batch.columns))


def _column_to_arrow(col: DeviceColumn, rows):
    """The column's values at row positions ``rows`` (an index array or a
    slice), as a pyarrow array."""
    if col.dtype.is_complex:
        return _complex_to_arrow(col, rows)
    data = _host(col.data)[rows]
    valid = None if col.validity is None else _host(col.validity)[rows]
    if col.dtype.is_string and col.dictionary is None and data.ndim == 2:
        from velox_tpu_torch.vector import strings as S
        lens = _host(col.children[0].data)[rows]
        return S.to_arrow(data, lens, valid)
    if col.dtype.is_long_decimal:
        hi = _host(col.children[0].data)[rows]
        return _decimal_to_arrow(data, hi, valid, col.dtype)
    return _np_to_arrow(data, valid, col)


def _complex_to_arrow(col: DeviceColumn, rows):
    """ARRAY/MAP/ROW values at ``rows``: each ROW field at the same rows,
    each ARRAY/MAP row's element slice [start, start + count) gathered
    from the children."""
    import pyarrow as pa
    valid = None if col.validity is None else _host(col.validity)[rows]
    if col.dtype.kind is T.TypeKind.ROW:
        out = pa.StructArray.from_arrays(
            [_column_to_arrow(c, rows) for c in col.children],
            names=list(col.dtype.names))
    else:
        if col.starts is not None and any(c.dtype.is_complex
                                          for c in col.children):
            # the reference raises here too (ROADMAP C)
            raise NotImplementedError(
                f"a nested {col.dtype} column whose rows were gathered "
                "(by a join, a sort or a concatenation of batches) cannot "
                "be read back; project the nested column before that")
        lens = _host(col.data).astype(np.int64)[rows]
        starts = _host(col.offsets())[rows]
        if valid is not None:
            lens = np.where(valid, lens, 0)
        offsets = np.concatenate([[0], np.cumsum(lens)])
        elems = (np.repeat(starts - offsets[:-1], lens)
                 + np.arange(offsets[-1], dtype=np.int64))
        kids = [_column_to_arrow(c, elems) for c in col.children]
        pa_offs = pa.array(offsets.astype(np.int32), pa.int32())
        if col.dtype.kind is T.TypeKind.ARRAY:
            out = pa.ListArray.from_arrays(pa_offs, kids[0])
        else:
            out = pa.MapArray.from_arrays(pa_offs, kids[0], kids[1])
    if valid is not None and not valid.all():
        # from_arrays takes no null bitmap: a take with null indices
        # re-wraps the rows
        idx = pa.array(np.arange(len(valid), dtype=np.int32),
                       pa.int32(), mask=~valid)
        out = out.take(idx)
    return out


def _decimal_to_arrow(lo: np.ndarray, hi: Optional[np.ndarray],
                      valid: Optional[np.ndarray], dt: T.DataType):
    """A DECIMAL column as an Arrow decimal128 array built from its
    buffers: the 16-byte little-endian values are the (lo, hi) int64 limb
    pairs, ``hi`` being the long decimal's high limb or, for DECIMAL(p <=
    18) (int64 or int32-narrowed storage), the sign extension of ``lo``.
    NULL slots hold zero."""
    import pyarrow as pa
    n = len(lo)
    limbs = np.empty((n, 2), dtype=np.int64)
    limbs[:, 0] = lo
    if hi is None:
        np.right_shift(limbs[:, 0], 63, out=limbs[:, 1])
    else:
        limbs[:, 1] = hi
    mask_buf = None
    if valid is not None and not valid.all():
        limbs[~valid] = 0
        mask_buf = pa.py_buffer(np.packbits(valid, bitorder="little")
                                .tobytes())
    return pa.Array.from_buffers(T.to_arrow(dt), n,
                                 [mask_buf, pa.py_buffer(limbs)])


def _np_to_arrow(data: np.ndarray, validity: Optional[np.ndarray],
                 col: DeviceColumn):
    """A 1-D column's values as an Arrow array of its declared type,
    whatever its storage width (a BIGINT stored as int32 comes out
    int64)."""
    import pyarrow as pa

    dt = col.dtype
    pa_mask = None if validity is None else ~validity
    if dt.is_string:
        if col.dictionary is None:
            raise ValueError("a 1-D string column without a dictionary")
        return col.dictionary.arrow_take(data, validity, T.to_arrow(dt))
    if dt.kind is T.TypeKind.DECIMAL:
        return _decimal_to_arrow(data, None, validity, dt)
    if dt.kind is T.TypeKind.TIMESTAMP:
        return pa.array(data.astype("datetime64[us]"), mask=pa_mask)
    if dt.kind is T.TypeKind.DATE:
        return pa.array(data, type=pa.date32(), mask=pa_mask)
    if dt.kind is T.TypeKind.UNKNOWN:
        return pa.nulls(len(data))
    return pa.array(data, type=T.to_arrow(dt), mask=pa_mask)

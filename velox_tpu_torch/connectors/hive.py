"""Hive connector: file-based table scans and writes (Parquet + ORC).

Counterpart of ``velox_tpu/connectors/hive.py`` (velox/connectors/hive
HiveDataSource splits and partitions, HiveDataSink, and the dwio reader
stack). pyarrow's Parquet and ORC readers decode on the host; a split is
one row group (Parquet) or stripe (ORC) of one file
(HiveConnectorSplit), read with its pruned columns and uploaded onto the
device of the query's ``QueryCtx``. Decoded splits are kept in the
device scan cache (connectors/cache.py) under the reference's key plus
the device.

String dictionaries: ordered comparisons run in dictionary-id space, which
needs one sorted, table-stable dictionary per column. ``HiveTable`` builds
each lazily, the first time a query scans the column, from every file of
the table. VARCHAR columns may read as raw byte matrices instead
("raw"/"auto" string encodings, vector/strings.py).

Writes: ``HiveDataSink`` converts each device batch to Arrow
(``vector/device.py to_arrow``) and writes, at close, one file, Hive
``key=value`` partition directories and/or murmur3 buckets
(``{bucket:05d}_0_part.{ext}``). A NULL partition value is written as
``key=__HIVE_DEFAULT_PARTITION__`` and reads back as NULL, as Hive does.
(The reference names such a directory ``key=nan`` and reads it back as
the string 'nan', and writes the integer keys of a column with NULLs as
'1.0'; ROADMAP C.)

The connector has no ``column_stats``, as in the reference: a Q6 over
Hive takes the generic aggregation, and its joins the sorted build.
"""

from __future__ import annotations

import glob as globmod
import os
import re
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.connectors.cache import DataCache
from velox_tpu_torch.connectors.connector import (
    Connector, ConnectorSplit, DataSink, DataSource, register_connector,
)
from velox_tpu_torch.vector.device import (
    DeviceBatch, Dictionary, default_capacity, from_arrow, to_arrow,
)

# Hive's directory name for a NULL partition value
HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


@dataclass(frozen=True)
class HiveSplit(ConnectorSplit):
    """One row-group range of one file.
    Parity: connectors/hive/HiveConnectorSplit."""
    path: str = ""
    row_group_lo: int = 0
    row_group_hi: int = 0  # exclusive


# ---------------------------------------------------------------------------
# File-format layer (dwio ReaderFactory dispatch): a Parquet row group and
# an ORC stripe are the same split unit. An ORC file is opened per call:
# a reader shared across driver and prefetch threads would need a lock.
# ---------------------------------------------------------------------------

def file_format(path: str) -> str:
    return "orc" if path.endswith(".orc") else "parquet"


def _orc_file(path: str, fs=None):
    import pyarrow.orc as orc
    return orc.ORCFile(fs.open_input_file(path) if fs is not None else path)


def _read_schema(path: str, fs=None):
    if file_format(path) == "orc":
        return _orc_file(path, fs).schema
    import pyarrow.parquet as pq
    return pq.read_schema(path, filesystem=fs)


def _num_row_groups(path: str, fs=None) -> int:
    if file_format(path) == "orc":
        return _orc_file(path, fs).nstripes
    import pyarrow.parquet as pq
    return pq.ParquetFile(path, filesystem=fs).metadata.num_row_groups


def _row_group_sizes(path: str, fs=None) -> List[int]:
    """Rows per row group / stripe. Parquet reads footer metadata; ORC
    (pyarrow exposes no per-stripe row counts) reads the first column of
    each stripe, once per table."""
    if file_format(path) == "orc":
        f = _orc_file(path, fs)
        col = [f.schema.names[0]] if f.schema.names else None
        return [f.read_stripe(i, columns=col).num_rows
                for i in range(f.nstripes)]
    import pyarrow.parquet as pq
    md = pq.ParquetFile(path, filesystem=fs).metadata
    return [md.row_group(i).num_rows for i in range(md.num_row_groups)]


def _read_row_groups(path: str, fs, lo: int, hi: int, columns):
    import pyarrow as pa
    if file_format(path) == "orc":
        f = _orc_file(path, fs)
        cols = list(columns)
        drop = []
        if not cols and f.schema.names:
            # a scan of partition columns only: ORC's read_stripe with no
            # columns returns no rows, so the first column carries the
            # row count and is dropped
            drop = [f.schema.names[0]]
            cols = drop
        batches = [f.read_stripe(i, columns=cols) for i in range(lo, hi)]
        t = pa.Table.from_batches(
            batches, schema=batches[0].schema if batches else None)
        return t.drop_columns(drop) if drop else t
    import pyarrow.parquet as pq
    pf = pq.ParquetFile(path, filesystem=fs)
    return pf.read_row_groups(list(range(lo, hi)), columns=columns)


def _read_table(path: str, fs, columns):
    if file_format(path) == "orc":
        return _orc_file(path, fs).read(columns=list(columns))
    import pyarrow.parquet as pq
    return pq.read_table(path, columns=columns, filesystem=fs)


def _path_partitions(path: str) -> Dict[str, Optional[str]]:
    """Hive partition values from ``key=value`` path segments; the
    default partition's segment is NULL."""
    out: Dict[str, Optional[str]] = {}
    for seg in os.path.dirname(path).split(os.sep):
        if "=" in seg:
            k, _, v = seg.partition("=")
            out[k] = None if v == HIVE_DEFAULT_PARTITION else v
    return out


class HiveTable:
    """A registered file-backed table (a list of Parquet/ORC files). Hive
    ``key=value`` directory segments become VARCHAR partition columns
    (HiveConnectorSplit partitionKeys). ``fs`` is a pyarrow filesystem for
    remote storage (connectors/hive/storage_adapters)."""

    def __init__(self, name: str, paths: List[str], fs=None,
                 string_encoding: str = "dict"):
        self.name = name
        self.fs = fs
        # VARCHAR representation: "dict" | "raw" | "auto" ("auto" probes
        # each string column's first row group once and reads it raw when
        # its distinct count exceeds half the rows)
        self.string_encoding = string_encoding
        self._raw_cols: Optional[set] = None
        self.paths = sorted(paths)
        if not self.paths:
            raise ValueError(f"hive table {name!r}: no files")
        self.schema_arrow = _read_schema(self.paths[0], fs)
        self.partitions = {p: _path_partitions(p) for p in self.paths}
        self.partition_cols = sorted(
            {k for ps in self.partitions.values() for k in ps})
        names = (list(self.schema_arrow.names)
                 + [c for c in self.partition_cols
                    if c not in self.schema_arrow.names])
        types = [T.from_arrow(f.type) for f in self.schema_arrow] \
            + [T.VARCHAR] * (len(names) - len(self.schema_arrow.names))
        self.row_type = T.row(names, types)
        self._dictionaries: Optional[Dict[str, Dictionary]] = None
        self._max_row_group_rows: Optional[int] = None

    def raw_string_cols(self, columns=None) -> set:
        """String columns read as raw byte matrices instead of
        dictionaries (one decision per table; see string_encoding)."""
        if self.string_encoding == "dict":
            return set()
        if self._raw_cols is None:
            self._raw_cols = set()
            str_cols = [f.name for f in self.schema_arrow
                        if T.from_arrow(f.type).is_string]
            if self.string_encoding == "raw":
                self._raw_cols.update(str_cols)
            elif str_cols:
                import pyarrow.compute as pc
                from velox_tpu_torch.vector import strings as S
                t = _read_row_groups(self.paths[0], self.fs, 0, 1, str_cols)
                for c in str_cols:
                    col = t.column(c)
                    n = len(col)
                    if not n:
                        continue
                    distinct = pc.count_distinct(col).as_py()
                    max_len = pc.max(pc.binary_length(col)).as_py() or 0
                    if distinct > n // 2 and max_len <= S.MAX_WIDTH:
                        self._raw_cols.add(c)
        return (self._raw_cols if columns is None
                else self._raw_cols & set(columns))

    def dictionaries(self, columns=None) -> Dict[str, Dictionary]:
        """Sorted table-stable dictionaries, built lazily per column: only
        the string columns a query scans pay the distinct pass over every
        file (partition columns take their values from the paths)."""
        if self._dictionaries is None:
            self._dictionaries = {}
            for c in self.partition_cols:
                vals = {ps.get(c) for ps in self.partitions.values()}
                self._dictionaries[c] = Dictionary(
                    sorted(v for v in vals if v is not None))
        raw = self.raw_string_cols()
        str_cols = [f.name for f in self.schema_arrow
                    if T.from_arrow(f.type).is_string
                    and (columns is None or f.name in columns)
                    and f.name not in self._dictionaries
                    and f.name not in raw]
        if str_cols:
            import pyarrow.compute as pc
            uniq = {c: set() for c in str_cols}
            for p in self.paths:
                t = _read_table(p, self.fs, str_cols)
                for c in str_cols:
                    vals = pc.unique(t.column(c).combine_chunks()).to_pylist()
                    uniq[c].update(v for v in vals if v is not None)
            for c in str_cols:
                self._dictionaries[c] = Dictionary(sorted(uniq[c]))
        return self._dictionaries

    def max_row_group_rows(self) -> int:
        if self._max_row_group_rows is None:
            m = 1
            for p in self.paths:
                m = max(m, max(_row_group_sizes(p, self.fs), default=1))
            self._max_row_group_rows = m
        return self._max_row_group_rows

    def splits(self) -> List[HiveSplit]:
        out = []
        for p in self.paths:
            for i in range(_num_row_groups(p, self.fs)):
                out.append(HiveSplit("hive", p, i, i + 1))
        return out


def _constant_strings(value: Optional[str], n: int):
    """``n`` rows of one VARCHAR value (NULL when None) as one Arrow
    array, without a Python object per row."""
    import pyarrow as pa
    if value is None:
        return pa.nulls(n, pa.string())
    return pa.array([value], pa.string()).take(
        pa.array(np.zeros(n, dtype=np.int64)))


class HiveDataSource(DataSource):
    """Parity: connectors/hive/HiveDataSource.cpp:205 (split readers with
    column pruning; batches padded to one table-wide capacity). Each split
    is decoded on the host and uploaded onto ``device``, once per device:
    the scan cache holds it for the next query."""

    def __init__(self, table: HiveTable, columns: Sequence[str],
                 capacity: Optional[int], device):
        self._table = table
        self._columns = list(columns)
        self._capacity = capacity or default_capacity(
            table.max_row_group_rows())
        self._device = torch.device(device)
        self._done: set = set()

    def dictionaries(self) -> Dict[str, Dictionary]:
        d = self._table.dictionaries(columns=self._columns)
        return {c: d[c] for c in self._columns if c in d}

    def next(self, split: HiveSplit) -> Optional[DeviceBatch]:
        key = (split.path, split.row_group_lo)
        if key in self._done:
            return None
        self._done.add(key)
        fs = self._table.fs
        if fs is None:
            mtime = os.path.getmtime(split.path)  # invalidates on rewrite
            size = os.path.getsize(split.path)
        else:
            info = fs.get_file_info(split.path)
            # some filesystems (fsspec memory) report no mtime; the size
            # rides the key so that a rewrite still invalidates there
            mtime = info.mtime_ns or 0
            size = info.size
        ckey = ("hive", split.path, mtime, size, split.row_group_lo,
                split.row_group_hi, tuple(self._columns), self._capacity,
                str(self._device))
        cache = DataCache.instance()
        cached = cache.get(ckey)
        if cached is not None:
            return cached
        pcols = [c for c in self._columns
                 if c in self._table.partition_cols]
        fcols = [c for c in self._columns if c not in pcols]
        t = _read_row_groups(split.path, fs, split.row_group_lo,
                             split.row_group_hi, fcols)
        if pcols:
            # partition values are path metadata: constant columns
            part = self._table.partitions[split.path]
            for c in pcols:
                t = t.append_column(c, _constant_strings(part.get(c),
                                                         t.num_rows))
            t = t.select(self._columns)
        enc = {c: "raw" for c in self._table.raw_string_cols(self._columns)}
        batch = from_arrow(t, capacity=self._capacity,
                           dictionaries=self.dictionaries(),
                           string_encoding=enc, device=self._device)
        cache.put(ckey, batch)
        return batch


def _np_murmur3(cols: List[np.ndarray]) -> np.ndarray:
    """Vectorized Spark murmur3 over int-valued columns (host side, for
    bucket assignment at write time; mirrors functions/sparksql.py). An
    8-byte column hashes its two 4-byte words, a narrower one its value
    as 4 bytes."""
    c1, c2 = np.uint32(0xCC9E2D51), np.uint32(0x1B873593)

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    def mix(h1, k1):
        k1 = rotl(k1 * c1, 15) * c2
        h1 = rotl(h1 ^ k1, 13)
        return h1 * np.uint32(5) + np.uint32(0xE6546B64)

    h = np.full(len(cols[0]), 42, np.uint32)
    with np.errstate(over="ignore"):
        for c in cols:
            if c.dtype.itemsize == 8:
                u = c.astype(np.int64).view(np.uint64)
                h = mix(h, (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))
                h = mix(h, (u >> np.uint64(32)).astype(np.uint32))
                nbytes = 8
            else:
                h = mix(h, c.astype(np.int32).view(np.uint32))
                nbytes = 4
            h = h ^ np.uint32(nbytes)
            h ^= h >> np.uint32(16)
            h *= np.uint32(0x85EBCA6B)
            h ^= h >> np.uint32(13)
            h *= np.uint32(0xC2B2AE35)
            h ^= h >> np.uint32(16)
    return h


def _partition_groups(table, keys: Sequence[str]):
    """The rows of ``table`` grouped by the values of ``keys``: a list of
    (segment values, int64 row positions), the groups in ascending key
    order with NULL last, each group's rows in input order (pandas'
    ``groupby(dropna=False)``). A segment value is the value's text
    (integers as integer text) or ``HIVE_DEFAULT_PARTITION`` for NULL."""
    import pyarrow as pa
    import pyarrow.compute as pc
    n = table.num_rows
    combined = np.zeros(n, dtype=np.int64)
    texts = []
    for k in keys:
        enc = pc.dictionary_encode(table.column(k).combine_chunks())
        values = enc.dictionary
        # codes in the values' sort order; NULL after every value
        order = np.asarray(pc.array_sort_indices(values), dtype=np.int64)
        rank = np.empty(len(values), dtype=np.int64)
        rank[order] = np.arange(len(values), dtype=np.int64)
        idx = enc.indices
        codes = np.asarray(idx.fill_null(0), dtype=np.int64)
        codes = rank[codes] if len(values) else codes
        if idx.null_count:
            codes[~np.asarray(pc.is_valid(idx))] = len(values)
        sorted_vals = values.take(pa.array(order)).to_pylist()
        texts.append([str(v) for v in sorted_vals] + [HIVE_DEFAULT_PARTITION])
        combined = combined * (len(values) + 1) + codes
    groups, inverse = np.unique(combined, return_inverse=True)
    rows = np.argsort(inverse, kind="stable")
    bounds = np.searchsorted(inverse[rows], np.arange(len(groups) + 1))
    out = []
    for g, code in enumerate(groups):
        segs = []
        for tx in reversed(texts):
            code, c = divmod(int(code), len(tx))
            segs.append(tx[c])
        out.append((tuple(reversed(segs)), rows[bounds[g]:bounds[g + 1]]))
    return out


class HiveDataSink(DataSink):
    """Writes device batches to Parquet or ORC files: plain,
    Hive-partitioned (``key=value`` directories, partition columns dropped
    from the file data), and/or bucketed (rows hashed on the bucket keys
    into ``bucket_count`` files per partition).
    Parity: connectors/hive/HiveDataSink.h:206-276.

    ``seconds`` holds the host seconds of each part of the write:
    ``to_arrow`` (the device batches' copy and conversion), ``bucketing``
    (grouping and hashing rows, and gathering each file's rows) and
    ``write`` (encoding and writing the files, up to ``WRITERS`` at a
    time)."""

    WRITERS = 8

    def __init__(self, path: str, partition_keys: Sequence[str] = (),
                 bucket_count: int = 0, bucket_keys: Sequence[str] = (),
                 file_format: str = None):
        self.path = path
        self.partition_keys = list(partition_keys)
        self.bucket_count = int(bucket_count)
        self.bucket_keys = list(bucket_keys)
        # the format from the target path's extension unless given
        # (HiveInsertTableHandle tableStorageFormat)
        self.file_format = file_format or globals()["file_format"](path)
        self._tables = []
        self.rows_written = 0
        self.bytes_written = 0
        self.files_written: List[str] = []
        self.seconds = {"to_arrow": 0.0, "bucketing": 0.0, "write": 0.0}

    def append(self, batch: DeviceBatch) -> None:
        t0 = time.perf_counter()
        t = to_arrow(batch)
        self.seconds["to_arrow"] += time.perf_counter() - t0
        self._tables.append(t)
        self.rows_written += t.num_rows

    def _ext(self) -> str:
        return "orc" if self.file_format == "orc" else "parquet"

    def _encode(self, table, path) -> int:
        """Write one file; returns its bytes."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if self.file_format == "orc":
            import pyarrow.orc as orc
            orc.write_table(table, path)
        else:
            import pyarrow.parquet as pq
            pq.write_table(table, path)
        return os.path.getsize(path)

    def _write_files(self, jobs) -> None:
        """Write each (table, path) of ``jobs``, up to ``WRITERS`` files at
        a time (pyarrow encodes without the GIL); the files are listed in
        the order of ``jobs``."""
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=max(1, min(
                self.WRITERS, len(jobs)))) as pool:
            sizes = list(pool.map(lambda job: self._encode(*job), jobs))
        for (_, path), n in zip(jobs, sizes):
            self.bytes_written += n
            self.files_written.append(path)
        self.seconds["write"] += time.perf_counter() - t0

    def _bucket_jobs(self, table, dirpath) -> list:
        """The (rows, path) of each non-empty bucket file of ``table``."""
        import pyarrow as pa
        t0 = time.perf_counter()
        cols = [np.asarray(table.column(k).combine_chunks().fill_null(0))
                for k in self.bucket_keys]
        bucket = np.abs(_np_murmur3(cols).view(np.int32) % self.bucket_count)
        # one stable gather: each bucket's rows in input order (numpy's
        # stable sort of 16-bit keys is a radix sort)
        if self.bucket_count <= 1 << 15:
            bucket = bucket.astype(np.int16)
        order = np.argsort(bucket, kind="stable")
        bounds = np.searchsorted(bucket[order],
                                 np.arange(self.bucket_count + 1))
        grouped = table.take(pa.array(order))
        self.seconds["bucketing"] += time.perf_counter() - t0
        return [(grouped.slice(bounds[b], bounds[b + 1] - bounds[b]),
                 os.path.join(dirpath, f"{b:05d}_0_part.{self._ext()}"))
                for b in range(self.bucket_count)
                if bounds[b + 1] > bounds[b]]

    def close(self):
        import pyarrow as pa
        if not self._tables:
            return
        table = pa.concat_tables(self._tables)
        self._tables = []
        if not self.partition_keys:
            self._write_files(self._bucket_jobs(table, self.path)
                              if self.bucket_count else [(table, self.path)])
            return
        # Hive layout: one key=value directory level per partition key;
        # partition columns are path metadata, not file data
        t0 = time.perf_counter()
        groups = _partition_groups(table, self.partition_keys)
        data = table.drop_columns(self.partition_keys)
        self.seconds["bucketing"] += time.perf_counter() - t0
        jobs = []
        for values, rows in groups:
            segs = [f"{k}={v}" for k, v in zip(self.partition_keys, values)]
            dirpath = os.path.join(self.path, *segs)
            t0 = time.perf_counter()
            sub = data.take(pa.array(rows))
            self.seconds["bucketing"] += time.perf_counter() - t0
            if self.bucket_count:
                jobs += self._bucket_jobs(sub, dirpath)
            else:
                jobs.append((sub, os.path.join(dirpath,
                                               f"part-0.{self._ext()}")))
        self._write_files(jobs)


class HiveConnector(Connector):
    """Parity: connectors/hive/HiveConnector.h."""

    def __init__(self, connector_id: str = "hive"):
        super().__init__(connector_id)
        self._tables: Dict[str, HiveTable] = {}

    def register_table(self, name: str, path_or_glob: str,
                       filesystem=None,
                       string_encoding: str = "dict") -> HiveTable:
        """Register Parquet/ORC files as a table. ``path_or_glob`` may be a
        local path, directory or glob, an ``s3://``/``gs://`` URI (resolved
        through pyarrow.fs, storage_adapters/s3fs and gcs), or any path
        paired with an explicit pyarrow ``filesystem``."""
        fs = filesystem
        path = path_or_glob
        if fs is None and "://" in path_or_glob \
                and not path_or_glob.startswith("file://"):
            from pyarrow import fs as pafs
            try:
                fs, path = pafs.FileSystem.from_uri(path_or_glob)
            except Exception as e:  # no credentials / unsupported scheme
                raise ValueError(
                    f"cannot open {path_or_glob!r}: {e}") from e
        if fs is not None:
            from pyarrow import fs as pafs
            info = fs.get_file_info(path)
            if info.type == pafs.FileType.Directory:
                sel = pafs.FileSelector(path, recursive=True)
                paths = [f.path for f in fs.get_file_info(sel)
                         if f.path.endswith((".parquet", ".orc"))]
            else:
                paths = [path]
            t = HiveTable(name, paths, fs=fs, string_encoding=string_encoding)
        else:
            if os.path.isdir(path):
                paths = (globmod.glob(os.path.join(path, "**", "*.parquet"),
                                      recursive=True)
                         + globmod.glob(os.path.join(path, "**", "*.orc"),
                                        recursive=True))
            else:
                paths = globmod.glob(path) or [path]
            t = HiveTable(name, paths, string_encoding=string_encoding)
        self._tables[name] = t
        return t

    def table_schema(self, table: str) -> T.DataType:
        return self._tables[table].row_type

    def create_data_source(self, table: str, columns, ctx) -> HiveDataSource:
        """A source that uploads onto ``ctx.device``, its batches of the
        ``hive.batch_capacity`` setting's capacity (by default the
        table's largest row group, rounded up)."""
        return HiveDataSource(self._tables[table], columns,
                              ctx.get("hive.batch_capacity"), ctx.device)

    def create_data_sink(self, path: str, partition_keys=(),
                         bucket_count=0, bucket_keys=(),
                         file_format: str = None) -> HiveDataSink:
        return HiveDataSink(path, partition_keys, bucket_count,
                            bucket_keys, file_format=file_format)

    def default_splits(self, table: str, ctx=None) -> List[HiveSplit]:
        return self._tables[table].splits()

    def split_groups(self, table: str) -> Optional[List[List[HiveSplit]]]:
        """Bucket-aligned split groups for grouped execution (exec/task.py
        ``GroupedTask``; velox Task.h:151). Bucket files are named
        ``{bucket:05d}_0_*`` (HiveDataSink); one bucket id across the
        partitions makes one group. None if the table is not bucketed."""
        by_bucket: Dict[int, List[HiveSplit]] = {}
        for s in self._tables[table].splits():
            m = re.match(r"^(\d{5})_", os.path.basename(s.path))
            if not m:
                return None
            by_bucket.setdefault(int(m.group(1)), []).append(s)
        if len(by_bucket) < 2:
            return None
        return [by_bucket[b] for b in sorted(by_bucket)]

    def prune_splits(self, table: str, splits: List[HiveSplit],
                     filter_expr) -> List[HiveSplit]:
        """Drop splits whose Parquet row-group statistics (or Hive
        partition values) cannot satisfy the pushed-down filter (dwio
        ScanSpec stride skipping and partition pruning). A split is
        dropped only when its stats prove that no row matches; ORC splits
        and missing stats keep theirs."""
        import pyarrow.parquet as pq
        ranges = extract_column_ranges(filter_expr)
        if not ranges:
            return splits
        t = self._tables[table]
        md_cache: Dict[str, object] = {}
        name_idx: Dict[str, Dict[str, int]] = {}
        kept = []
        for s in splits:
            part = t.partitions.get(s.path, {})
            drop = False
            for col, (lo, hi) in ranges.items():
                if col in part:
                    v = part[col]
                    if lo is not None and str(v) == v and v < str(lo):
                        drop = True
                    if hi is not None and str(v) == v and v > str(hi):
                        drop = True
                    if lo is not None and lo == hi and v != str(lo):
                        drop = True
                if drop:
                    break
            if not drop and file_format(s.path) == "orc":
                # pyarrow exposes no per-stripe ORC statistics: keep it
                kept.append(s)
                continue
            if not drop:
                md = md_cache.get(s.path)
                if md is None:
                    md = pq.ParquetFile(s.path, filesystem=t.fs).metadata
                    md_cache[s.path] = md
                    name_idx[s.path] = {md.schema.column(i).name: i
                                        for i in range(md.num_columns)}
                idx = name_idx[s.path]
                for rg_i in range(s.row_group_lo, s.row_group_hi):
                    rg = md.row_group(rg_i)
                    for col, (lo, hi) in ranges.items():
                        ci = idx.get(col)
                        if ci is None:
                            continue
                        st = rg.column(ci).statistics
                        if st is None or not st.has_min_max:
                            continue
                        try:
                            if lo is not None and st.max < lo:
                                drop = True
                            if hi is not None and st.min > hi:
                                drop = True
                        except TypeError:
                            continue  # an incomparable literal: keep
                    if drop:
                        break
            if not drop:
                kept.append(s)
        if len(kept) < len(splits):
            M.record_counter(M.K_SPLITS_PRUNED, len(splits) - len(kept))
        return kept


def register_hive(connector_id: str = "hive") -> HiveConnector:
    conn = HiveConnector(connector_id)
    register_connector(conn)
    return conn


# ---------------------------------------------------------------------------
# Row-group statistics pruning (dwio/common/ScanSpec filters + Parquet
# row-group stats).
# ---------------------------------------------------------------------------

def extract_column_ranges(expr) -> Dict[str, Tuple]:
    """Conjunctive (lo, hi) bounds per column from a pushed-down filter:
    walks AND trees of ``col <cmp> literal`` / BETWEEN. None bound = open."""
    from velox_tpu_torch.core import expressions as ex
    out: Dict[str, List] = {}

    def bound(col, lo, hi):
        cur = out.setdefault(col, [None, None])
        if lo is not None:
            cur[0] = lo if cur[0] is None else max(cur[0], lo)
        if hi is not None:
            cur[1] = hi if cur[1] is None else min(cur[1], hi)

    def lit(e):
        if not isinstance(e, ex.Constant):
            return None
        # scaled DECIMAL literals (0.05 stored as 5) do not compare with
        # raw file statistics: never prune on them
        if e.dtype.kind is T.TypeKind.DECIMAL:
            return None
        return e.value

    def walk(e):
        if not isinstance(e, ex.Call):
            return
        if e.name == "and":
            for a in e.args:
                walk(a)
            return
        if e.name == "between" and isinstance(e.args[0], ex.FieldAccess):
            bound(e.args[0].name, lit(e.args[1]), lit(e.args[2]))
            return
        if e.name in ("eq", "lt", "lte", "gt", "gte") and len(e.args) == 2:
            a, b = e.args
            flip = {"lt": "gt", "lte": "gte", "gt": "lt", "gte": "lte",
                    "eq": "eq"}
            if isinstance(b, ex.FieldAccess) and lit(a) is not None:
                a, b = b, a
                name = flip[e.name]
            elif isinstance(a, ex.FieldAccess) and lit(b) is not None:
                name = e.name
            else:
                return
            v = lit(b)
            if name == "eq":
                bound(a.name, v, v)
            elif name in ("lt", "lte"):
                bound(a.name, None, v)
            else:
                bound(a.name, v, None)

    walk(expr)
    return {k: tuple(v) for k, v in out.items()}

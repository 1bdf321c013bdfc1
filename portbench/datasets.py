"""The data a configuration serves: the program's TPC-H connector, or
Parquet files that the benchmark writes from its own generator and the
program reads through its Hive connector.

The files go into ``portbench/_data/<configuration>/`` and stay there
while ``manifest.json`` (each file's size and CRC-32, and a digest of the
layout and of the generator's source) matches, so only a checkout's first
run writes them.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import zlib
from pathlib import Path
from typing import Dict

import numpy as np

from portbench.reference import tpchgen

DATA_DIR = Path(__file__).resolve().parent / "_data"


def _arrow_type(name: str):
    import pyarrow as pa
    if name.startswith("decimal("):
        p, s = name[len("decimal("):-1].split(",")
        return pa.decimal128(int(p), int(s))
    return {"int64": pa.int64(), "int32": pa.int32(), "date32": pa.date32(),
            "string": pa.string()}[name]


def _arrow_column(values: np.ndarray, type_name: str, dictionary):
    import pyarrow as pa
    typ = _arrow_type(type_name)
    if pa.types.is_decimal(typ):
        # 16-byte little-endian two's complement: the value, then its sign
        buf = np.empty((len(values), 2), np.int64)
        buf[:, 0] = values
        buf[:, 1] = values >> 63
        return pa.Array.from_buffers(typ, len(values),
                                     [None, pa.py_buffer(buf)])
    if pa.types.is_string(typ):
        if isinstance(dictionary, tpchgen.Formatted):
            return pa.array(dictionary.take(values).tolist(), type=typ)
        return pa.DictionaryArray.from_arrays(
            pa.array(values.astype(np.int32)),
            pa.array(list(dictionary.values), type=typ)).cast(typ)
    return pa.array(values.astype(np.int32 if pa.types.is_date(typ)
                                  else typ.to_pandas_dtype()), type=typ)


def _table(gen: tpchgen.TpchGen, name: str, lo: int, hi: int,
           columns: Dict[str, str]):
    import pyarrow as pa
    arrays = gen.generate(name, lo, hi, list(columns))
    dicts = gen.dictionaries(name)
    return pa.table({c: _arrow_column(arrays[c], t, dicts.get(c))
                     for c, t in columns.items()})


def _write_tables(cfg: Dict, root: Path) -> None:
    import pyarrow.compute as pc
    import pyarrow.parquet as pq
    gen = tpchgen.TpchGen(cfg["scale_factor"])
    for name, spec in cfg["tables"].items():
        out = root / name
        out.mkdir(parents=True)
        rg = spec.get("row_group_rows", 1 << 20)
        cols = spec["columns"]
        if "partition_key" in spec:
            key = spec["partition_key"]
            t = _table(gen, name, 0, gen.num_rows(name), cols)
            for value in sorted(set(t.column(key).to_pylist())):
                part = out / f"{key}={value}"
                part.mkdir()
                pq.write_table(
                    t.filter(pc.equal(t.column(key), value)).drop([key]),
                    part / "00000_0_part.parquet", row_group_size=rg)
        elif "buckets" in spec:
            n, key = spec["buckets"], spec["bucket_key"]
            t = _table(gen, name, 0, gen.num_rows(name), cols)
            keys = t.column(key).to_numpy()
            for b in range(n):
                pq.write_table(t.filter(keys % n == b),
                               out / f"{b:05d}_0_part.parquet",
                               row_group_size=rg)
        else:
            # order ranges (lineitem: the lines of those orders)
            n_orders = gen.num_rows("orders" if name == "lineitem"
                                    else name)
            edges = np.linspace(0, n_orders, spec["files"] + 1).astype(int)
            for i, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
                pq.write_table(_table(gen, name, int(lo), int(hi), cols),
                               out / f"{i:05d}_0_part.parquet",
                               row_group_size=rg)


def _crc(path: Path) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            crc = zlib.crc32(chunk, crc)
    return crc


def _files(root: Path) -> Dict[str, list]:
    return {str(p.relative_to(root)): [p.stat().st_size, _crc(p)]
            for p in sorted(root.rglob("*.parquet"))}


def parquet_files(cfg: Dict) -> Path:
    """The configuration's Parquet files, written unless the manifest
    matches; returns their directory."""
    root = DATA_DIR / cfg["name"]
    manifest = root / "manifest.json"
    layout = hashlib.sha256(
        json.dumps([cfg["scale_factor"], cfg["tables"]],
                   sort_keys=True).encode()
        + tpchgen.SOURCE.read_bytes()
        + Path(tpchgen.__file__).read_bytes()).hexdigest()
    if manifest.exists():
        kept = json.loads(manifest.read_text())
        if kept.get("layout") == layout and kept["files"] == _files(root):
            return root
        print(f"portbench: {root} differs from its manifest; writing it "
              "anew", file=sys.stderr)
    shutil.rmtree(root, ignore_errors=True)
    _write_tables(cfg, root)
    manifest.write_text(json.dumps({"layout": layout,
                                    "files": _files(root)}, indent=1))
    return root


def register(cfg: Dict) -> str:
    """Register the configuration's connector in the program; returns its
    id."""
    if cfg["connector"] == "tpch":
        from velox_tpu_torch.connectors.tpch import register_tpch
        register_tpch(cfg["scale_factor"], "tpch")
        return "tpch"
    if cfg["connector"] == "hive_parquet":
        from velox_tpu_torch.connectors.hive import register_hive
        root = parquet_files(cfg)
        hive = register_hive("hive")
        for name in cfg["tables"]:
            hive.register_table(name, os.path.join(root, name))
        return "hive"
    raise ValueError(f"unknown connector {cfg['connector']!r}")

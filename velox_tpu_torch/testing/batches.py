"""Carry a ``velox_tpu`` DeviceBatch into the port's DeviceBatch.

The differential tests feed both engines the same batches: a batch the
reference produced (JAX arrays) is read through numpy and rebuilt here
with torch tensors. Nothing of the reference is imported: the batch is
read through its attributes (``columns``, ``mask``, each column's
``data``, ``validity``, ``dtype``, ``dictionary``, ``children``), and its
types through their names.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from velox_tpu_torch import types as T
from velox_tpu_torch.vector.device import (
    DeviceBatch, DeviceColumn, Dictionary, batch_from_numpy,
)


def batch_from_reference(batch, device="cpu",
                         dictionaries: Optional[Dict] = None) -> DeviceBatch:
    """The port's DeviceBatch holding the same arrays as `batch`, a
    reference DeviceBatch of flat columns (raw strings included). Columns
    sharing a dictionary keep sharing one, across calls too when they pass
    the same `dictionaries` dict (reference dictionary id -> port
    Dictionary)."""
    dicts = {} if dictionaries is None else dictionaries
    columns, dtypes, col_dicts = {}, {}, {}
    for name, col in batch.columns.items():
        dtype = T.parse_type(str(col.dtype))
        if dtype.is_complex or (dtype.is_string and col.dictionary is None
                                and np.ndim(col.data) != 2):
            raise NotImplementedError(
                f"{dtype} columns are not ported to velox_tpu_torch")
        validity = None if col.validity is None else np.asarray(col.validity)
        columns[name] = (np.asarray(col.data), validity,
                         *[np.asarray(c.data) for c in col.children])
        dtypes[name] = dtype
        if col.dictionary is not None:
            col_dicts[name] = dicts.setdefault(
                id(col.dictionary), Dictionary(col.dictionary.values))
    out = batch_from_numpy(columns, np.asarray(batch.mask), dtypes,
                           col_dicts, device=device)
    for col in out.columns.values():
        if col.dtype.is_string and col.dictionary is None:
            # a raw string's child is its int32 byte lengths
            col.children = tuple(DeviceColumn(c.data, None, T.INTEGER)
                                 for c in col.children)
    return out

"""Carry a ``velox_tpu`` DeviceBatch into the port's DeviceBatch.

The differential tests feed both engines the same batches: a batch the
reference produced (JAX arrays) is read through numpy and rebuilt here
with torch tensors. Nothing of the reference is imported: the batch is
read through its attributes (``columns``, ``mask``, each column's
``data``, ``validity``, ``dtype``, ``dictionary``, ``children``,
``starts``), and its types through their names.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from velox_tpu_torch import types as T
from velox_tpu_torch.vector.device import (
    DeviceBatch, DeviceColumn, Dictionary, _upload,
)


def batch_from_reference(batch, device="cpu",
                         dictionaries: Optional[Dict] = None) -> DeviceBatch:
    """The port's DeviceBatch holding the same arrays as `batch`, a
    reference DeviceBatch (raw strings, long decimals and ARRAY/MAP/ROW
    columns included). Columns sharing a dictionary keep sharing one,
    across calls too when they pass the same `dictionaries` dict
    (reference dictionary id -> port Dictionary)."""
    dicts = {} if dictionaries is None else dictionaries
    cols = {name: _column(col, T.parse_type(str(col.dtype)), device, dicts)
            for name, col in batch.columns.items()}
    return DeviceBatch(cols, _upload(np.asarray(batch.mask, bool), device))


def _column(col, dtype: T.DataType, device, dicts: Dict) -> DeviceColumn:
    data = np.asarray(col.data)
    validity = (None if col.validity is None
                else _upload(np.asarray(col.validity, bool), device))
    if dtype.is_string and col.dictionary is None and data.ndim != 2:
        raise NotImplementedError(
            f"a 1-D {dtype} column without a dictionary")
    if dtype.is_complex:
        kid_types = dtype.children
    elif dtype.is_string:
        kid_types = (T.INTEGER,) * len(col.children)  # raw byte lengths
    else:
        kid_types = (T.BIGINT,) * len(col.children)  # a long decimal's hi
    children = tuple(_column(c, t, device, dicts)
                     for c, t in zip(col.children, kid_types))
    starts = getattr(col, "starts", None)
    if starts is not None:
        starts = _upload(np.asarray(starts).astype(np.int64), device)
    dictionary = None
    if col.dictionary is not None:
        dictionary = dicts.setdefault(id(col.dictionary),
                                      Dictionary(col.dictionary.values))
    return DeviceColumn(_upload(data, device), validity, dtype, dictionary,
                        children, starts)

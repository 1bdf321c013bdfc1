"""CAST implementations.

Counterpart of ``velox_tpu/functions/casts.py`` (velox/expression/
CastExpr, the CAST/TRY_CAST special form). Casts between fixed-width
types are dtype conversions on the batch's device; casts from a string
run once over the column's dictionary on the host, then one device gather
of the parsed table by the column's ids.

A raw (dictionary-less) string column casts only to VARCHAR (itself);
casts from it raise, as in the reference. Casts to VARCHAR are not
ported: the reference performs them at output extraction.
"""

from __future__ import annotations

import datetime
import decimal as pydec

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue, ex_null
from velox_tpu_torch.functions.scalar import (
    _floor_div, _gather_table, _half_up_div,
)
from velox_tpu_torch.ops import int128 as I
from velox_tpu_torch.vector.device import DeviceColumn


def cast(ctx, v: EvalValue, to: T.DataType, is_try: bool = False
         ) -> EvalValue:
    frm = v.dtype
    if frm == to:
        return v
    k_from, k_to = frm.kind, to.kind
    if frm.is_numeric and to.is_numeric:
        return _cast_numeric(v, to)
    if k_from is T.TypeKind.BOOLEAN and to.is_numeric:
        return EvalValue(v.data.to(to.torch_dtype()), v.validity, to)
    if frm.is_numeric and k_to is T.TypeKind.BOOLEAN:
        return EvalValue(v.data != 0, v.validity, to)
    if k_from is T.TypeKind.DATE and k_to is T.TypeKind.TIMESTAMP:
        return EvalValue(v.data.to(torch.int64) * 86400_000_000,
                         v.validity, to)
    if k_from is T.TypeKind.TIMESTAMP and k_to is T.TypeKind.DATE:
        return EvalValue(_floor_div(v.data, 86400_000_000).to(torch.int32),
                         v.validity, to)
    if frm.is_string:
        return _cast_from_string(ctx, v, to, is_try)
    if to.is_string:
        raise NotImplementedError(
            "cast to varchar is performed at output extraction")
    if k_from is T.TypeKind.UNKNOWN:
        return ex_null(to, ctx.device)
    raise NotImplementedError(f"cast {frm} -> {to}")


def long_to_double(lo: torch.Tensor, hi: torch.Tensor, scale: int,
                   to: T.DataType) -> torch.Tensor:
    """A DECIMAL(19..38) value as a float: hi * 2^64 + unsigned(lo), then
    the scale, in the reference's order. unsigned(lo) is its two 32-bit
    halves, each exact in a double, added once: the same correctly rounded
    double as a uint64 -> float64 conversion."""
    lo = lo.to(torch.int64)
    ulo = (((lo >> 32) & 0xFFFFFFFF).to(torch.float64) * 4294967296.0
           + (lo & 0xFFFFFFFF).to(torch.float64))
    f = hi.to(torch.float64) * (2.0 ** 64) + ulo
    return (f / (10.0 ** scale)).to(to.torch_dtype())


def _cast_long_decimal(v: EvalValue, to: T.DataType) -> EvalValue:
    """Casts touching a long decimal: widening (short decimal or integer
    to long), long-to-long upscale, and long to a float. Downscaling a
    long decimal raises, as in the reference."""
    frm = v.dtype
    if to.is_long_decimal:
        fs = frm.scale if frm.kind is T.TypeKind.DECIMAL else 0
        if to.scale < fs:
            raise NotImplementedError(
                f"cast {frm} -> {to}: long-decimal downscale rounding")
        if frm.is_long_decimal:
            lo = v.data
            hi = (v.children[0].data if v.children
                  else torch.zeros_like(lo))
        elif frm.kind is T.TypeKind.DECIMAL or frm.is_integral:
            lo, hi = I.from_i64(v.data.to(torch.int64))
        else:
            raise NotImplementedError(f"cast {frm} -> {to}")
        lo, hi = I.rescale_up(lo, hi, to.scale - fs)
        return EvalValue(lo, v.validity, to,
                         children=(DeviceColumn(hi, None, T.BIGINT),))
    if to.is_floating:
        hi = (v.children[0].data if v.children
              else torch.zeros_like(v.data))
        return EvalValue(long_to_double(v.data, hi, frm.scale, to),
                         v.validity, to)
    raise NotImplementedError(f"cast {frm} -> {to}")


def _cast_numeric(v: EvalValue, to: T.DataType) -> EvalValue:
    frm = v.dtype
    if frm.is_long_decimal or to.is_long_decimal:
        return _cast_long_decimal(v, to)
    d = v.data
    if frm.kind is T.TypeKind.DECIMAL:
        if to.kind is T.TypeKind.DECIMAL:
            if to.scale >= frm.scale:
                data = d * (10 ** (to.scale - frm.scale)) \
                    if to.scale > frm.scale else d
            else:  # reduce the scale, half up
                data = _half_up_div(d, 10 ** (frm.scale - to.scale))
            return EvalValue(data, v.validity, to)
        if to.is_floating:
            return EvalValue(d.to(to.torch_dtype()) / (10.0 ** frm.scale),
                             v.validity, to)
        # decimal -> integer rounds half up (Presto)
        data = _half_up_div(d, 10 ** frm.scale)
        return EvalValue(data.to(to.torch_dtype()), v.validity, to)
    if to.kind is T.TypeKind.DECIMAL:
        if frm.is_integral:
            return EvalValue(d.to(torch.int64) * (10 ** to.scale),
                             v.validity, to)
        # float -> decimal: half up
        scaled = d.to(torch.float64) * (10.0 ** to.scale)
        data = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                           torch.ceil(scaled - 0.5)).to(torch.int64)
        return EvalValue(data, v.validity, to)
    if frm.is_floating and to.is_integral:
        # nearest, ties away from zero
        data = torch.where(d >= 0, torch.floor(d + 0.5),
                           torch.ceil(d - 0.5)).to(to.torch_dtype())
        return EvalValue(data, v.validity, to)
    return EvalValue(d.to(to.torch_dtype()), v.validity, to)


def _parse(s: str, to: T.DataType, is_try: bool):
    try:
        if to.kind is T.TypeKind.DATE:
            return (datetime.date.fromisoformat(s)
                    - datetime.date(1970, 1, 1)).days
        if to.is_integral:
            return int(s)
        if to.is_floating:
            return float(s)
        if to.kind is T.TypeKind.DECIMAL:
            return int(pydec.Decimal(s).scaleb(to.scale)
                       .to_integral_value(pydec.ROUND_HALF_UP))
        if to.kind is T.TypeKind.BOOLEAN:
            return s.lower() in ("true", "t", "1")
    except (ValueError, ArithmeticError):
        if is_try:
            return None
        raise
    raise NotImplementedError(f"cast varchar -> {to}")


def _cast_from_string(ctx, v: EvalValue, to: T.DataType, is_try: bool
                      ) -> EvalValue:
    if v.dictionary is None:
        if v.py_value is not None:  # a string literal
            return _const_from_string(v.py_value, to, ctx.device)
        raise NotImplementedError(
            "cast from a raw (dictionary-less) string column is not "
            "supported")
    parsed = [_parse(s, to, is_try) for s in v.dictionary.values]
    ok = np.array([p is not None for p in parsed], dtype=bool)
    table = np.array([0 if p is None else p for p in parsed],
                     dtype=to.np_dtype())
    validity = v.validity
    if not ok.all():
        good = _gather_table(ok, v)
        validity = good if validity is None else (validity & good)
    return EvalValue(_gather_table(table, v), validity, to)


def _const_from_string(s: str, to: T.DataType, dev) -> EvalValue:
    if to.kind is T.TypeKind.DATE:
        days = (datetime.date.fromisoformat(s)
                - datetime.date(1970, 1, 1)).days
        return EvalValue(torch.tensor(days, dtype=torch.int32, device=dev),
                         None, to)
    if to.is_integral or to.is_floating:
        val = int(s) if to.is_integral else float(s)
        return EvalValue(torch.tensor(val, dtype=to.torch_dtype(),
                                      device=dev), None, to)
    if to.kind is T.TypeKind.DECIMAL:
        with pydec.localcontext() as c:
            c.prec = 50  # the default 28 digits would round 38-digit values
            val = int(pydec.Decimal(s).scaleb(to.scale)
                      .to_integral_value(pydec.ROUND_HALF_UP))
        if not to.is_long_decimal:
            return EvalValue(torch.tensor(val, dtype=torch.int64,
                                          device=dev), None, to)
        # both limbs (the reference keeps an int64 alone; ROADMAP C)
        lo, hi = I.from_python_int(val)
        return EvalValue(torch.tensor(lo, dtype=torch.int64, device=dev),
                         None, to, children=(DeviceColumn(
                             torch.tensor(hi, dtype=torch.int64,
                                          device=dev), None, T.BIGINT),))
    raise NotImplementedError(f"cast constant varchar -> {to}")

"""Date and time functions (Presto semantics).

Counterpart of ``velox_tpu/functions/datetime.py`` (velox/functions/
prestosql/DateTimeFunctions.h): date_add, date_diff, date_trunc,
week/week_of_year, hour, minute, second, millisecond, to_unixtime,
from_unixtime, at_timezone, timezone_hour and timezone_minute, over the
device layouts DATE = int32 days since 1970-01-01 and TIMESTAMP = int64
microseconds. All of it is integer arithmetic on the batch's device (the
civil-date conversions are functions/scalar.py's ``_civil_from_days`` and
``_days_from_civil``).

Time zones: a zone's TZif table (RFC 8536) becomes two small device
tensors, transition instants and UTC offsets, and a row's offset is one
``searchsorted``. The table is read from ``/usr/share/zoneinfo``; the
``tzdata`` package is imported only when that directory lacks the zone
(the reference imports it first, so without the package every zone
function raises; ROADMAP C).
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.expression.eval import EvalValue, merge_validity
from velox_tpu_torch.functions.registry import _REGISTRY, register
from velox_tpu_torch.functions.scalar import (
    _civil_from_days, _date_days, _days_from_civil, _floor_div, fixed,
)

_US_DAY = 86_400_000_000
_US_PER = {
    "millisecond": 1_000,
    "second": 1_000_000,
    "minute": 60_000_000,
    "hour": 3_600_000_000,
    "day": _US_DAY,
}
_MONTHS = {"month": 1, "quarter": 3, "year": 12}
_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _unit_of(arg: EvalValue) -> str:
    if arg.py_value is None:
        raise ValueError("date_add/date_diff unit must be a string literal")
    return str(arg.py_value).lower()


def _is_datelike(t: T.DataType) -> bool:
    return t.kind in (T.TypeKind.DATE, T.TypeKind.TIMESTAMP)


def _split(micros):
    """(days, micros within the day) of a TIMESTAMP, floored."""
    days = _floor_div(micros, _US_DAY)
    return days, micros - days * _US_DAY


def _shift_months(days, n):
    """Days since the epoch plus ``n`` months, the day of the month
    clamped to the target month's length (Presto)."""
    y, m, d = _civil_from_days(days)
    total = y * 12 + (m - 1) + n
    y2 = _floor_div(total, 12)
    m2 = torch.remainder(total, 12) + 1
    leap = ((torch.remainder(y2, 4) == 0) & (torch.remainder(y2, 100) != 0)) \
        | (torch.remainder(y2, 400) == 0)
    mdays = torch.tensor(_MONTH_DAYS, dtype=torch.int64, device=days.device)
    dmax = mdays[m2 - 1] + ((m2 == 2) & leap).to(torch.int64)
    return _days_from_civil(y2, m2, torch.minimum(d, dmax))


def _date_add_eval(ctx, out_dtype, args):
    unit, n, v = args
    u = _unit_of(unit)
    amount = n.full_data(ctx.capacity).to(torch.int64)
    validity = merge_validity(n, v)
    if v.dtype.kind is T.TypeKind.DATE:
        days = v.full_data(ctx.capacity).to(torch.int64)
        if u == "day":
            out = days + amount
        elif u == "week":
            out = days + amount * 7
        elif u in _MONTHS:
            out = _shift_months(days, amount * _MONTHS[u])
        else:
            raise ValueError(f"date_add: unit {u!r} invalid for DATE")
        return EvalValue(out.to(torch.int32), validity, T.DATE)
    micros = v.full_data(ctx.capacity).to(torch.int64)
    if u in _US_PER:
        out = micros + amount * _US_PER[u]
    elif u == "week":
        out = micros + amount * 7 * _US_DAY
    elif u in _MONTHS:
        days, rem = _split(micros)
        out = _shift_months(days, amount * _MONTHS[u]) * _US_DAY + rem
    else:
        raise ValueError(f"date_add: unknown unit {u!r}")
    return EvalValue(out, validity, T.TIMESTAMP)


def _date_add_resolver(ts):
    if len(ts) == 3 and ts[0].is_string and ts[1].is_integral \
            and _is_datelike(ts[2]):
        return ts[2]
    return None


register("date_add", _date_add_resolver, _date_add_eval)


def _trunc_div(x, n: int):
    """Division truncating toward zero: complete elapsed units (velox
    DateTimeImpl.h diffTimestamp)."""
    return torch.sign(x) * _floor_div(torch.abs(x), n)


def _complete_months(da, rema, db, remb):
    """Complete calendar months from (da, rema) to (db, remb), epoch days
    and micros within the day; the partial month at the end does not
    count."""
    ya, ma, daya = _civil_from_days(da)
    yb, mb, dayb = _civil_from_days(db)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    # a positive span loses a month when the end's (day, time) is before
    # the start's; a negative one, the mirror image
    end_lt = (dayb < daya) | ((dayb == daya) & (remb < rema))
    end_gt = (dayb > daya) | ((dayb == daya) & (remb > rema))
    months = torch.where((months > 0) & end_lt, months - 1, months)
    return torch.where((months < 0) & end_gt, months + 1, months)


def _date_diff_eval(ctx, out_dtype, args):
    unit, a, b = args
    u = _unit_of(unit)
    validity = merge_validity(a, b)
    both_dates = (a.dtype.kind is T.TypeKind.DATE
                  and b.dtype.kind is T.TypeKind.DATE)
    ua = a.full_data(ctx.capacity).to(torch.int64)
    ub = b.full_data(ctx.capacity).to(torch.int64)
    if a.dtype.kind is T.TypeKind.DATE:
        ua = ua * _US_DAY
    if b.dtype.kind is T.TypeKind.DATE:
        ub = ub * _US_DAY
    if u in _US_PER:
        out = (_floor_div(ub - ua, _US_PER[u]) if both_dates and u == "day"
               else _trunc_div(ub - ua, _US_PER[u]))
        return EvalValue(out, validity, T.BIGINT)
    if u == "week":
        return EvalValue(_trunc_div(ub - ua, 7 * _US_DAY), validity,
                         T.BIGINT)
    if u in _MONTHS:
        (da, rema), (db, remb) = _split(ua), _split(ub)
        months = _complete_months(da, rema, db, remb)
        return EvalValue(_trunc_div(months, _MONTHS[u]), validity, T.BIGINT)
    raise ValueError(f"date_diff: unknown unit {u!r}")


def _date_diff_resolver(ts):
    if len(ts) == 3 and ts[0].is_string and _is_datelike(ts[1]) \
            and _is_datelike(ts[2]):
        return T.BIGINT
    return None


register("date_diff", _date_diff_resolver, _date_diff_eval)


def _date_trunc_eval(ctx, out_dtype, args):
    unit, v = args
    u = _unit_of(unit)
    if v.dtype.kind is T.TypeKind.DATE:
        days = v.full_data(ctx.capacity).to(torch.int64)
        rem = torch.zeros_like(days)
    else:
        days, rem = _split(v.full_data(ctx.capacity).to(torch.int64))
    if u in ("second", "minute", "hour"):
        q = _US_PER[u]
        return EvalValue(days * _US_DAY + _floor_div(rem, q) * q,
                         v.validity, T.TIMESTAMP)
    y, m, _ = _civil_from_days(days)
    one = torch.ones_like(m)
    if u == "day":
        td = days
    elif u == "week":
        td = days - torch.remainder(days + 3, 7)  # ISO weeks start Monday
    elif u == "month":
        td = _days_from_civil(y, m, one)
    elif u == "quarter":
        td = _days_from_civil(y, _floor_div(m - 1, 3) * 3 + 1, one)
    elif u == "year":
        td = _days_from_civil(y, one, one)
    else:
        raise ValueError(f"date_trunc: unknown unit {u!r}")
    if v.dtype.kind is T.TypeKind.DATE:
        return EvalValue(td.to(torch.int32), v.validity, T.DATE)
    return EvalValue(td * _US_DAY, v.validity, T.TIMESTAMP)


def _date_trunc_resolver(ts):
    if len(ts) == 2 and ts[0].is_string and _is_datelike(ts[1]):
        return ts[1]
    return None


register("date_trunc", _date_trunc_resolver, _date_trunc_eval)


def _week_eval(ctx, out_dtype, args):
    """ISO 8601 week of the year: the Thursday of the row's week names
    the ISO year."""
    (v,) = args
    days = _date_days(v).to(torch.int64)
    thu = days - torch.remainder(days + 3, 7) + 3
    y, _, _ = _civil_from_days(thu)
    jan1 = _days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return EvalValue(_floor_div(thu - jan1, 7) + 1, v.validity, T.BIGINT)


register("week", fixed(T.BIGINT, _is_datelike), _week_eval)
_REGISTRY["week_of_year"] = _REGISTRY["week"]


def _is_timestamp(t: T.DataType) -> bool:
    return t.kind is T.TypeKind.TIMESTAMP


def _time_part(name, divisor, modulus):
    def eval_fn(ctx, out_dtype, args):
        (v,) = args
        micros = v.full_data(ctx.capacity).to(torch.int64)
        out = torch.remainder(_floor_div(micros, divisor), modulus)
        return EvalValue(out, v.validity, T.BIGINT)
    register(name, fixed(T.BIGINT, _is_timestamp), eval_fn)


_time_part("hour", 3_600_000_000, 24)
_time_part("minute", 60_000_000, 60)
_time_part("second", 1_000_000, 60)
_time_part("millisecond", 1_000, 1000)


def _to_unixtime_eval(ctx, out_dtype, args):
    (v,) = args
    micros = v.full_data(ctx.capacity)
    return EvalValue(micros.to(torch.float64) / 1e6, v.validity, T.DOUBLE)


register("to_unixtime", fixed(T.DOUBLE, _is_timestamp), _to_unixtime_eval)


def _from_unixtime_eval(ctx, out_dtype, args):
    (v,) = args
    secs = v.full_data(ctx.capacity).to(torch.float64)
    # the cast truncates toward zero, as the reference's astype does
    return EvalValue((secs * 1e6).to(torch.int64), v.validity, T.TIMESTAMP)


register("from_unixtime",
         lambda ts: T.TIMESTAMP if len(ts) == 1 and ts[0].is_numeric
         else None, _from_unixtime_eval)


# ---------------------------------------------------------------------------
# IANA time zones (velox/type/tz/TimeZoneMap.h)
# ---------------------------------------------------------------------------

ZONEINFO = "/usr/share/zoneinfo"


def _zone_path(name: str) -> str:
    """The TZif file of zone ``name``: under ``ZONEINFO`` first, else in
    the ``tzdata`` package, imported only then."""
    path = os.path.join(ZONEINFO, name)
    if os.path.exists(path):
        return path
    try:
        import tzdata
    except ImportError:
        tzdata = None
    if tzdata is not None:
        path = os.path.join(os.path.dirname(tzdata.__file__), "zoneinfo",
                            name)
        if os.path.exists(path):
            return path
    raise ValueError(f"unknown time zone {name!r}")


@lru_cache(maxsize=None)
def _tz_table(name: str):
    """(transition micros int64[n+1], offset seconds int32[n+1]) from the
    zone's TZif file: offsets[i] applies to instants in
    [transitions[i], transitions[i+1]); transitions[0] is a -inf
    sentinel."""
    with open(_zone_path(name), "rb") as f:
        data = f.read()
    if data[:4] != b"TZif":
        raise ValueError(f"{name}: not a TZif file")

    def parse_block(off, tsize, fmt):
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt
         ) = struct.unpack(">6I", data[off + 20:off + 44])
        p = off + 44
        times = struct.unpack(f">{timecnt}{fmt}",
                              data[p:p + timecnt * tsize])
        p += timecnt * tsize
        idx = data[p:p + timecnt]
        p += timecnt
        types = [struct.unpack(">lBB", data[p + i * 6:p + i * 6 + 6])
                 for i in range(typecnt)]
        p += typecnt * 6 + charcnt + leapcnt * (tsize + 4) \
            + isstdcnt + isutcnt
        return times, idx, types, p

    version = data[4:5]
    times, idx, types, end = parse_block(0, 4, "l")
    if version in (b"2", b"3"):
        times, idx, types, _ = parse_block(end, 8, "q")
    if not types:
        raise ValueError(f"{name}: empty zone data")
    # the offset before the first transition: the first non-DST type (the
    # TZif convention), else type 0
    first = next((t for t in types if not t[1]), types[0])
    offs = [first[0]] + [types[i][0] for i in idx]
    trans = [-(1 << 62)] + [t * 1_000_000 for t in times]
    return np.asarray(trans, np.int64), np.asarray(offs, np.int32)


def _tz_offset_seconds(ts_micros, tz_name: str):
    """Each instant's UTC offset (int64 seconds) in the zone."""
    trans, offs = _tz_table(tz_name)
    dev = ts_micros.device
    i = torch.searchsorted(torch.from_numpy(trans).to(dev),
                           ts_micros.contiguous(), right=True) - 1
    return torch.from_numpy(offs).to(dev).to(torch.int64)[
        i.clamp(0, len(offs) - 1)]


def _const_str(v) -> str:
    if v.py_value is None:
        raise ValueError("time zone argument must be a constant string")
    return v.py_value


def _at_timezone_eval(ctx, out_dtype, args):
    ts, tz = args
    data = ts.full_data(ctx.capacity).to(torch.int64)
    off = _tz_offset_seconds(data, _const_str(tz))
    return EvalValue(data + off * 1_000_000, ts.validity, T.TIMESTAMP)


def _zone_resolver(out):
    return lambda ts: (out if len(ts) == 2 and _is_timestamp(ts[0])
                       else None)


register("at_timezone", _zone_resolver(T.TIMESTAMP), _at_timezone_eval)


def _tz_part_eval(minute: bool):
    def eval_fn(ctx, out_dtype, args):
        ts, tz = args
        data = ts.full_data(ctx.capacity).to(torch.int64)
        off = _tz_offset_seconds(data, _const_str(tz))
        # Presto truncates toward zero: -9:30 is hour -9, minute -30
        a = torch.abs(off)
        val = torch.remainder(a, 3600) // 60 if minute else a // 3600
        return EvalValue(torch.where(off < 0, -val, val), ts.validity,
                         T.BIGINT)
    return eval_fn


register("timezone_hour", _zone_resolver(T.BIGINT), _tz_part_eval(False))
register("timezone_minute", _zone_resolver(T.BIGINT), _tz_part_eval(True))

"""Date and time expressions — port of ``spark_rapids_tpu/expr/datetime.py``,
every class of it: the date fields (``Year`` ... ``WeekOfYear``,
``WeekDay``), the time fields (``Hour``, ``Minute``, ``Second``),
``LastDay``, ``NextDay``, date and month arithmetic, ``MonthsBetween``,
``TruncDate`` and ``TruncTimestamp``, the format family
(``FromUnixTime``, ``DateFormat`` over ``parse_format``'s token subset),
the zone shifts (``FromUTCTimestamp``, ``ToUTCTimestamp``,
``ConvertTimezone`` over ``tzdb.zone_tables``), the unix families,
``MakeDate``/``MakeTimestamp``, the captured clocks, ``ToDate``/
``ToTimestamp`` and their format-carrying forms, ``TimestampAdd``/
``TimestampDiff``, month and day names, ``DatePart`` and ``Extract``.

A DATE is int32 days since 1970-01-01, a TIMESTAMP int64 microseconds
since the epoch, UTC (the session time zone).  Every field rides the
branch-free civil-calendar math of ``expr/cast.py`` (``civil_from_days``,
``days_from_civil``) on int64 tensors, with floor division, so days before
1970 and before year 1000 come out as the proleptic Gregorian calendar
gives them.  A TIMESTAMP input to a date field is read as its day,
floored; ``months_between`` adds its time of day.  ``DateAdd``,
``DateSub`` and ``DateDiff`` take DATE inputs only (their rules in
``overrides/meta.py``).  A zone's transition tables move to the column's
device and every row finds its offset with one ``torch.searchsorted``.

Departures from the reference, each in ROADMAP Queue 3: the time fields
of a DATE read its midnight, 0 (Spark's value; the reference reads the
day number as microseconds, R29); ``extract(YEAROFWEEK ...)`` is the
calendar year and ``extract(SECOND ...)`` the whole seconds as an INT,
as the reference gives them (Spark gives the ISO week-numbering year and
a decimal(8,6), R30 and R31).
"""
from __future__ import annotations

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.expr.base import (BinaryExpression, Expression,
                                              Literal, UnaryExpression)
from spark_rapids_tpu_torch.expr.cast import (_fdiv, civil_from_days,
                                              days_from_civil)


_US_PER_DAY = 86_400_000_000


def _days_of(c: DeviceColumn, dtype: T.DataType) -> torch.Tensor:
    if isinstance(dtype, T.TimestampType):
        return torch.div(c.data, _US_PER_DAY, rounding_mode="floor")
    return c.data.to(torch.int64)


class _DateField(UnaryExpression):
    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        days = _days_of(c, self.child.dataType)
        y, m, d = civil_from_days(days)
        return DeviceColumn(T.INT, c.validity,
                            data=self._field(y, m, d, days).to(torch.int32))

    def _field(self, y, m, d, days):
        raise NotImplementedError


class Year(_DateField):
    def _field(self, y, m, d, days):
        return y


class Month(_DateField):
    def _field(self, y, m, d, days):
        return m


class DayOfMonth(_DateField):
    def _field(self, y, m, d, days):
        return d


class DayOfWeek(_DateField):
    """Spark: Sunday=1 ... Saturday=7; epoch day 0 was a Thursday."""

    def _field(self, y, m, d, days):
        return torch.remainder(days + 4, 7) + 1


class DayOfYear(_DateField):
    def _field(self, y, m, d, days):
        one = torch.ones_like(m)
        return days - days_from_civil(y, one, one) + 1


class Quarter(_DateField):
    def _field(self, y, m, d, days):
        return _fdiv(m - 1, 3) + 1


class WeekOfYear(_DateField):
    """ISO-8601 week number (Spark ``WeekOfYear``: the week holding the
    Thursday)."""

    def _field(self, y, m, d, days):
        dow0 = torch.remainder(days + 3, 7)          # Monday=0 ... Sunday=6
        thursday = days - dow0 + 3
        ty, _, _ = civil_from_days(thursday)
        one = torch.ones_like(ty)
        return _fdiv(thursday - days_from_civil(ty, one, one), 7) + 1


class LastDay(UnaryExpression):
    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        y, m, _ = civil_from_days(_days_of(c, self.child.dataType))
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, 1, m + 1)
        first_next = days_from_civil(ny, nm, torch.ones_like(nm))
        return DeviceColumn(T.DATE, c.validity,
                            data=(first_next - 1).to(torch.int32))


class _TimeField(UnaryExpression):
    """A time field of the microseconds within the day, floored.  A DATE
    is its midnight: every field 0, as Spark casts it (the reference
    reads the day number as microseconds, ROADMAP R29)."""

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        if isinstance(self.child.dataType, T.DateType):
            rem = torch.zeros_like(c.data, dtype=torch.int64)
        else:
            rem = c.data - _fdiv(c.data, _US_PER_DAY) * _US_PER_DAY
        return DeviceColumn(T.INT, c.validity,
                            data=self._field(rem).to(torch.int32))

    def _field(self, rem):
        raise NotImplementedError


class Hour(_TimeField):
    def _field(self, rem):
        return _fdiv(rem, 3_600_000_000)


class Minute(_TimeField):
    def _field(self, rem):
        return torch.remainder(_fdiv(rem, 60_000_000), 60)


class Second(_TimeField):
    def _field(self, rem):
        return torch.remainder(_fdiv(rem, 1_000_000), 60)


class DateAdd(BinaryExpression):
    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        d, n = cols
        return DeviceColumn(T.DATE, d.validity & n.validity,
                            data=d.data + n.data.to(torch.int32))


class DateSub(BinaryExpression):
    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        d, n = cols
        return DeviceColumn(T.DATE, d.validity & n.validity,
                            data=d.data - n.data.to(torch.int32))


class DateDiff(BinaryExpression):
    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        a, b = cols
        return DeviceColumn(T.INT, a.validity & b.validity,
                            data=(a.data - b.data).to(torch.int32))


class UnixTimestamp(UnaryExpression):
    """to_unix_timestamp(ts) -> seconds, floored (a DATE's midnight)."""

    def _resolve_type(self):
        self._dataType = T.LONG
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        if isinstance(self.child.dataType, T.DateType):
            secs = c.data.to(torch.int64) * 86_400
        else:
            secs = _fdiv(c.data, 1_000_000)
        return DeviceColumn(T.LONG, c.validity, data=secs)


def _month_len(y, m):
    """Days in month (y, m), as a difference of civil days."""
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, 1, m + 1)
    one = torch.ones_like(m)
    return days_from_civil(ny, nm, one) - days_from_civil(y, m, one)


def _clamped_ymd_to_days(y, m, d):
    """``days_from_civil`` with the day clamped to the month's length."""
    return days_from_civil(y, m, torch.minimum(d, _month_len(y, m)))


class AddMonths(BinaryExpression):
    """add_months(date, n): the day clamped to the target month's last
    day."""

    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c, n = cols
        y, m, d = civil_from_days(_days_of(c, self.children[0].dataType))
        total = (y * 12 + (m - 1)) + n.data.to(torch.int64)
        out = _clamped_ymd_to_days(_fdiv(total, 12),
                                   torch.remainder(total, 12) + 1, d)
        return DeviceColumn(T.DATE, c.validity & n.validity,
                            data=out.to(torch.int32))


class MonthsBetween(BinaryExpression):
    """months_between(ts1, ts2[, roundOff=true]) -> double: whole months
    when both are the same day of the month or both month ends, else the
    difference in days and time of day over 31 days added; rounded to 8
    digits when ``round_off``."""

    def __init__(self, left, right, round_off: bool = True):
        super().__init__(left, right)
        self.round_off = round_off

    def _resolve_type(self):
        self._dataType = T.DOUBLE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        a, b = cols

        def parts(c, dt):
            days = _days_of(c, dt)
            y, m, d = civil_from_days(days)
            if isinstance(dt, T.TimestampType):
                tod = (c.data - days * _US_PER_DAY).to(torch.float64) / \
                    torch.full_like(days, 1e6, dtype=torch.float64)
            else:
                tod = torch.zeros_like(days, dtype=torch.float64)
            return y, m, d, tod, _month_len(y, m)

        ya, ma, da, ta, la = parts(a, self.children[0].dataType)
        yb, mb, db, tb, lb = parts(b, self.children[1].dataType)
        whole = ((ya - yb) * 12 + (ma - mb)).to(torch.float64)
        # equal days of the month, or both month ends: whole months, the
        # time of day ignored, as Spark's DateTimeUtils.monthsBetween
        both_end = (da == la) & (db == lb)
        # divisors as tensors: a CUDA division by a Python scalar
        # multiplies by its reciprocal, one unit in the last place off
        month_s = torch.full_like(whole, 31.0 * 86400.0)
        frac = ((da - db).to(torch.float64) * 86400.0 + (ta - tb)) / month_s
        out = torch.where(both_end | (da == db), whole, whole + frac)
        if self.round_off:
            out = torch.round(out * 1e8) / torch.full_like(out, 1e8)
        return DeviceColumn(T.DOUBLE, a.validity & b.validity, data=out)


def _null_like(c: DeviceColumn, dt: T.DataType, days) -> DeviceColumn:
    """Every row null (a format or unit outside the supported set)."""
    return DeviceColumn(dt, torch.zeros_like(c.validity),
                        data=torch.zeros_like(days,
                                              dtype=column_torch_dtype(dt)))


def literal_text(e: Expression):
    """A non-null literal's text, else None."""
    if isinstance(e, Literal) and e.value is not None:
        return str(e.value)
    return None


def _trunc_days(days, unit: str):
    """Days truncated to the start of their year, quarter, month or ISO
    week."""
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(m)
    if unit == "year":
        return days_from_civil(y, one, one)
    if unit == "quarter":
        return days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    if unit == "month":
        return days_from_civil(y, m, one)
    return days - torch.remainder(days + 3, 7)          # back to Monday


class TruncDate(BinaryExpression):
    """trunc(date, fmt): ``fmt`` a plan-time literal (year, quarter, month
    or week); any other format gives null, as Spark does."""

    _FMTS = {"year": "year", "yyyy": "year", "yy": "year",
             "quarter": "quarter", "month": "month", "mon": "month",
             "mm": "month", "week": "week"}

    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def unit(self):
        text = literal_text(self.children[1])
        return None if text is None else self._FMTS.get(text.lower())

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        days = _days_of(c, self.children[0].dataType)
        unit = self.unit()
        if unit is None:
            return _null_like(c, T.DATE, days)
        return DeviceColumn(T.DATE, c.validity,
                            data=_trunc_days(days, unit).to(torch.int32))


class NextDay(BinaryExpression):
    """next_day(date, 'Mon'): the first later date on that weekday."""

    _DOW = {"su": 0, "sun": 0, "sunday": 0, "mo": 1, "mon": 1, "monday": 1,
            "tu": 2, "tue": 2, "tues": 2, "tuesday": 2, "we": 3, "wed": 3,
            "wednesday": 3, "th": 4, "thu": 4, "thur": 4, "thurs": 4,
            "thursday": 4, "fr": 5, "fri": 5, "friday": 5, "sa": 6,
            "sat": 6, "saturday": 6}

    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        text = literal_text(self.children[1])
        target = None if text is None else self._DOW.get(
            text.strip().lower())
        days = _days_of(c, self.children[0].dataType)
        if target is None:
            return _null_like(c, T.DATE, days)
        dow = torch.remainder(days + 4, 7)                 # Sunday=0
        delta = torch.remainder(target - dow, 7)
        delta = torch.where(delta == 0, 7, delta)
        return DeviceColumn(T.DATE, c.validity,
                            data=(days + delta).to(torch.int32))


# -- formatting (UTC session time zone) ---------------------------------------

_FMT_TOKENS = ("yyyy", "MM", "dd", "HH", "mm", "ss")


def parse_format(fmt: str):
    """A pattern -> a list of ('tok', name) and ('lit', char); None when
    it holds a letter outside the subset."""
    out = []
    i = 0
    while i < len(fmt):
        for t in _FMT_TOKENS:
            if fmt.startswith(t, i):
                out.append(("tok", t))
                i += len(t)
                break
        else:
            ch = fmt[i]
            if ch.isalpha():
                return None
            out.append(("lit", ch))
            i += 1
    return out


def _format_to_chars(segments, y, mo, d, h, mi, s):
    """The pattern rendered as an (n, width) uint8 char matrix (every row
    the same width)."""
    vals = {"yyyy": (y, 4), "MM": (mo, 2), "dd": (d, 2), "HH": (h, 2),
            "mm": (mi, 2), "ss": (s, 2)}
    cols = []
    for kind, v in segments:
        if kind == "lit":
            cols.extend(torch.full_like(y, b) for b in v.encode("utf-8"))
        else:
            num, w = vals[v]
            for k in range(w - 1, -1, -1):
                cols.append(torch.remainder(_fdiv(num, 10 ** k), 10)
                            + ord("0"))
    if not cols:
        return torch.zeros((y.shape[0], 0), dtype=torch.uint8,
                           device=y.device)
    return torch.stack(cols, 1).to(torch.uint8)


class _FormatBase(BinaryExpression):
    """from_unixtime and date_format with a literal pattern of
    ``parse_format``'s subset (the tagging keeps any other in a CPU
    stage)."""

    def _resolve_type(self):
        self._dataType = T.STRING
        self._nullable = True

    def _segments(self):
        text = literal_text(self.children[1])
        return None if text is None else parse_format(text)

    def _render(self, c, micros):
        days = _fdiv(micros, _US_PER_DAY)
        rem = micros - days * _US_PER_DAY
        y, mo, d = civil_from_days(days)
        chars = _format_to_chars(
            self._segments(), y, mo, d, _fdiv(rem, 3_600_000_000),
            torch.remainder(_fdiv(rem, 60_000_000), 60),
            torch.remainder(_fdiv(rem, 1_000_000), 60))
        lengths = torch.full((c.capacity,), int(chars.shape[1]),
                             dtype=torch.int32, device=c.device)
        return DeviceColumn(T.STRING, c.validity, chars=chars,
                            lengths=lengths)


class FromUnixTime(_FormatBase):
    """from_unixtime(seconds, fmt) -> string (UTC); seconds times 10^6
    wraps as Java's long multiply."""

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return self._render(c, c.data.to(torch.int64) * 1_000_000)


class DateFormat(_FormatBase):
    """date_format(ts or date, fmt) -> string (UTC)."""

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        if isinstance(self.children[0].dataType, T.DateType):
            micros = c.data.to(torch.int64) * _US_PER_DAY
        else:
            micros = c.data
        return self._render(c, micros)


def _zone_offsets(zone: str, secs: torch.Tensor, key: str) -> torch.Tensor:
    """The offset, in seconds, that ``zone``'s tables give each of
    ``secs`` (UTC instants for ``utc_instants``, wall times for
    ``wall_starts``): the zone's tables on ``secs``' device, one
    ``torch.searchsorted``."""
    from spark_rapids_tpu_torch.tzdb import zone_tables

    t = zone_tables(zone)
    bounds = torch.from_numpy(np.ascontiguousarray(t[key])).to(secs.device)
    offsets = torch.from_numpy(np.ascontiguousarray(t["offsets"])).to(
        secs.device)
    idx = torch.searchsorted(bounds, secs.contiguous(), right=True) - 1
    return offsets[idx.clamp(0, offsets.shape[0] - 1)]


class _UtcTzShift(BinaryExpression):
    """from_utc_timestamp / to_utc_timestamp with a literal zone known to
    ``tzdb`` (the tagging keeps any other in a CPU stage): each row's
    offset from the zone's transition tables (``_zone_offsets``)."""

    _to_utc = False

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True
        self._tz = literal_text(self.right)

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        secs = _fdiv(c.data.to(torch.int64), 1_000_000)
        key = "wall_starts" if self._to_utc else "utc_instants"
        shift = _zone_offsets(self._tz, secs, key) * 1_000_000
        data = c.data - shift if self._to_utc else c.data + shift
        return DeviceColumn(T.TIMESTAMP, c.validity & cols[1].validity,
                            data=data)


class FromUTCTimestamp(_UtcTzShift):
    """from_utc_timestamp(ts, tz): a UTC instant as tz's wall clock."""

    _to_utc = False


class ToUTCTimestamp(_UtcTzShift):
    """to_utc_timestamp(ts, tz): ts read as tz's wall time; a gap shifts
    forward and an overlap takes the earlier offset, as java.time."""

    _to_utc = True


class ToUnixTimestamp(UnixTimestamp):
    """to_unix_timestamp: unix_timestamp's code."""


class WeekDay(_DateField):
    """weekday(date): Monday=0 ... Sunday=6."""

    def _field(self, y, m, d, days):
        return torch.remainder(days + 3, 7)


def _all_valid(cols):
    validity = cols[0].validity
    for c in cols[1:]:
        validity = validity & c.validity
    return validity


class MakeDate(Expression):
    """make_date(y, m, d): an invalid civil date is null (under ANSI an
    error)."""

    def __init__(self, y, m, d):
        super().__init__([y, m, d])

    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def sql_string(self):
        return ("make_date("
                + ", ".join(c.sql_string() for c in self.children) + ")")

    def do_columnar_eval(self, ctx, cols):
        y, m, d = (c.data.to(torch.int64) for c in cols)
        days = days_from_civil(y, m, d)
        y2, m2, d2 = civil_from_days(days)
        ok = (y2 == y) & (m2 == m) & (d2 == d) & (y >= 1) & (y <= 9999)
        validity = _all_valid(cols)
        if ctx.ansi:
            ctx.add_error(~ok & validity, "invalid date in make_date (ANSI)")
        else:
            validity = validity & ok
        return DeviceColumn(T.DATE, validity, data=days.to(torch.int32))


class MakeTimestamp(Expression):
    """make_timestamp(y, m, d, h, min, sec) in the UTC session time zone;
    sec integral or fractional (a decimal's microseconds exact, a
    double's rounded)."""

    def __init__(self, y, m, d, h, mi, s):
        super().__init__([y, m, d, h, mi, s])

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True

    def sql_string(self):
        return ("make_timestamp("
                + ", ".join(c.sql_string() for c in self.children) + ")")

    def do_columnar_eval(self, ctx, cols):
        y, m, d, h, mi = (c.data.to(torch.int64) for c in cols[:5])
        sec = cols[5]
        st = self.children[5].dataType
        if isinstance(st, T.DecimalType):
            micros_in_sec = sec.data.to(torch.int64) * (10 ** (6 - st.scale))
        elif isinstance(st, (T.FloatType, T.DoubleType)):
            f = torch.round(sec.data.to(torch.float64) * 1e6)
            big = ~torch.isfinite(f) | (f.abs() >= 2.0 ** 62)
            micros_in_sec = torch.where(big, -1.0, f).to(torch.int64)
        else:
            micros_in_sec = sec.data.to(torch.int64) * 1_000_000
        days = days_from_civil(y, m, d)
        y2, m2, d2 = civil_from_days(days)
        # Spark: 60 seconds roll to the next minute only when exactly 60
        ok = ((y2 == y) & (m2 == m) & (d2 == d) & (y >= 1) & (y <= 9999)
              & (h >= 0) & (h <= 23) & (mi >= 0) & (mi <= 59)
              & (micros_in_sec >= 0) & (micros_in_sec <= 60_000_000))
        micros = (days * _US_PER_DAY + h * 3_600_000_000
                  + mi * 60_000_000 + micros_in_sec)
        validity = _all_valid(cols)
        if ctx.ansi:
            ctx.add_error(~ok & validity,
                          "invalid timestamp in make_timestamp (ANSI)")
        else:
            validity = validity & ok
        return DeviceColumn(T.TIMESTAMP, validity, data=micros)


class _CapturedNow(Expression):
    """current_date()/current_timestamp(): the instant is captured when
    the expression is built (Spark: once per query), so every row and
    every batch sees the same value."""

    def __init__(self):
        super().__init__([])
        import time

        self.captured_micros = int(time.time() * 1_000_000)

    def sql_string(self):
        return f"{self.pretty_name.lower()}()"

    def _constant(self, ctx, dt: T.DataType, value: int) -> DeviceColumn:
        cap, dev = ctx.batch.capacity, ctx.batch.device
        return DeviceColumn(dt, torch.ones(cap, dtype=torch.bool,
                                           device=dev),
                            data=torch.full((cap,), value,
                                            dtype=column_torch_dtype(dt),
                                            device=dev))


class CurrentDate(_CapturedNow):
    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        return self._constant(ctx, T.DATE,
                              self.captured_micros // _US_PER_DAY)


class CurrentTimestamp(_CapturedNow):
    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        return self._constant(ctx, T.TIMESTAMP, self.captured_micros)


class TimestampSeconds(UnaryExpression):
    """timestamp_seconds(n): integral or fractional seconds -> ts."""

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        if isinstance(self.child.dataType, (T.FloatType, T.DoubleType)):
            f = c.data.to(torch.float64) * 1e6
            ok = torch.isfinite(f) & (f.abs() < 2.0 ** 63)
            data = torch.where(ok, torch.round(f), 0.0).to(torch.int64)
            return DeviceColumn(T.TIMESTAMP, c.validity & ok, data=data)
        v = c.data.to(torch.int64)
        ok = (v >= -9223372036854) & (v <= 9223372036854)
        data = v * 1_000_000
        if ctx.ansi:
            ctx.add_error(~ok & c.validity,
                          "timestamp_seconds overflow (ANSI)")
            return DeviceColumn(T.TIMESTAMP, c.validity, data=data)
        return DeviceColumn(T.TIMESTAMP, c.validity & ok, data=data)


class TimestampMillis(UnaryExpression):
    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        v = c.data.to(torch.int64)
        ok = (v >= -9223372036854775) & (v <= 9223372036854775)
        return DeviceColumn(T.TIMESTAMP, c.validity & ok, data=v * 1_000)


class TimestampMicros(UnaryExpression):
    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.TIMESTAMP, c.validity,
                            data=c.data.to(torch.int64))


class UnixDate(UnaryExpression):
    """unix_date(date) -> days since the epoch."""

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.INT, c.validity, data=c.data.to(torch.int32))


class DateFromUnixDate(UnaryExpression):
    """date_from_unix_date(days)."""

    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.DATE, c.validity, data=c.data.to(torch.int32))


class _UnixExtract(UnaryExpression):
    """unix_seconds/millis/micros(ts), floored as Spark's
    DateTimeUtils."""

    _div = 1

    def _resolve_type(self):
        self._dataType = T.LONG
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        v = c.data.to(torch.int64)
        return DeviceColumn(T.LONG, c.validity,
                            data=_fdiv(v, self._div) if self._div != 1
                            else v)


class UnixSeconds(_UnixExtract):
    _div = 1_000_000


class UnixMillis(_UnixExtract):
    _div = 1_000


class UnixMicros(_UnixExtract):
    _div = 1


class ToDate(UnaryExpression):
    """to_date(e): the cast to DATE (a string by the civil parser, its
    errors null)."""

    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        from spark_rapids_tpu_torch.expr.cast import _string_to_date_v2

        c = cols[0]
        ct = self.child.dataType
        if isinstance(ct, T.DateType):
            return c
        if isinstance(ct, T.TimestampType):
            return DeviceColumn(T.DATE, c.validity, data=_fdiv(
                c.data, _US_PER_DAY).to(torch.int32))
        return _string_to_date_v2(ctx, c, ct, T.DATE, False)


class ToTimestamp(UnaryExpression):
    """to_timestamp(e): the cast to TIMESTAMP (a string by the civil
    parser, its errors null)."""

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        from spark_rapids_tpu_torch.expr.cast import _string_to_timestamp

        c = cols[0]
        ct = self.child.dataType
        if isinstance(ct, T.TimestampType):
            return c
        if isinstance(ct, T.DateType):
            return DeviceColumn(T.TIMESTAMP, c.validity,
                                data=c.data.to(torch.int64) * _US_PER_DAY)
        return _string_to_timestamp(ctx, c, ct, T.TIMESTAMP, False)


class TruncTimestamp(BinaryExpression):
    """date_trunc(fmt, ts) with a literal ``fmt``; any other is null."""

    _DAY_FMTS = dict(TruncDate._FMTS)
    _TIME = {"day": 86_400_000_000, "dd": 86_400_000_000,
             "hour": 3_600_000_000, "minute": 60_000_000,
             "second": 1_000_000, "millisecond": 1_000, "microsecond": 1}

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c = cols[1]                                  # date_trunc(fmt, ts)
        unit = (literal_text(self.children[0]) or "").lower()
        micros = c.data.to(torch.int64)
        if unit in self._TIME:
            q = self._TIME[unit]
            return DeviceColumn(T.TIMESTAMP, c.validity,
                                data=_fdiv(micros, q) * q)
        if unit in self._DAY_FMTS:
            days = _trunc_days(_fdiv(micros, _US_PER_DAY),
                               self._DAY_FMTS[unit])
            return DeviceColumn(T.TIMESTAMP, c.validity,
                                data=days * _US_PER_DAY)
        return _null_like(c, T.TIMESTAMP, micros)


_MONTH_UNITS = {"month": 1, "quarter": 3, "year": 12}


def _trunc_div(x, k: int):
    """x / k truncated toward zero."""
    return torch.div(x, k, rounding_mode="trunc")


class TimestampAdd(Expression):
    """timestampadd(unit, n, ts) with a plan-time ``unit``."""

    _FIXED = {"microsecond": 1, "millisecond": 1_000, "second": 1_000_000,
              "minute": 60_000_000, "hour": 3_600_000_000,
              "day": _US_PER_DAY, "week": 7 * _US_PER_DAY}

    def __init__(self, unit, n, ts):
        super().__init__([n, ts])
        self.unit = str(unit).lower()

    def sql_string(self):
        return (f"timestampadd({self.unit}, "
                f"{self.children[0].sql_string()}, "
                f"{self.children[1].sql_string()})")

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        n, c = cols
        micros = c.data.to(torch.int64)
        k = n.data.to(torch.int64)
        validity = n.validity & c.validity
        if self.unit in self._FIXED:
            return DeviceColumn(T.TIMESTAMP, validity,
                                data=micros + k * self._FIXED[self.unit])
        mult = _MONTH_UNITS.get(self.unit)
        if mult is None:
            return DeviceColumn(T.TIMESTAMP, torch.zeros_like(validity),
                                data=torch.zeros_like(micros))
        # the month units ride add_months' clamped civil add
        days = _fdiv(micros, _US_PER_DAY)
        tod = micros - days * _US_PER_DAY
        y, m, d = civil_from_days(days)
        tot = y * 12 + (m - 1) + k * mult
        out = _clamped_ymd_to_days(_fdiv(tot, 12),
                                   torch.remainder(tot, 12) + 1, d)
        return DeviceColumn(T.TIMESTAMP, validity,
                            data=out * _US_PER_DAY + tod)


class TimestampDiff(Expression):
    """timestampdiff(unit, start, end): whole units, truncated toward
    zero (java.time for the fixed units; civil month steps for the month
    units)."""

    def __init__(self, unit, start, end):
        super().__init__([start, end])
        self.unit = str(unit).lower()

    def sql_string(self):
        return (f"timestampdiff({self.unit}, "
                f"{self.children[0].sql_string()}, "
                f"{self.children[1].sql_string()})")

    def _resolve_type(self):
        self._dataType = T.LONG
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        a, b = cols
        validity = a.validity & b.validity
        s = a.data.to(torch.int64)
        e = b.data.to(torch.int64)
        fixed = TimestampAdd._FIXED.get(self.unit)
        if fixed is not None:
            return DeviceColumn(T.LONG, validity,
                                data=_trunc_div(e - s, fixed))
        mult = _MONTH_UNITS.get(self.unit)
        if mult is None:
            return DeviceColumn(T.LONG, torch.zeros_like(validity),
                                data=torch.zeros_like(s))
        sd = _fdiv(s, _US_PER_DAY)
        ed = _fdiv(e, _US_PER_DAY)
        sy, sm, sdd = civil_from_days(sd)
        ey, em, edd = civil_from_days(ed)
        months = (ey * 12 + em) - (sy * 12 + sm)
        # a partial month does not count: back off when the end's day of
        # the month and time have not reached the start's
        stod = s - sd * _US_PER_DAY
        etod = e - ed * _US_PER_DAY
        fwd = e >= s
        short = torch.where(
            fwd, (edd < sdd) | ((edd == sdd) & (etod < stod)),
            (edd > sdd) | ((edd == sdd) & (etod > stod)))
        months = months - (short & fwd).to(torch.int64) \
            + (short & ~fwd).to(torch.int64)
        return DeviceColumn(T.LONG, validity, data=_trunc_div(months, mult))


class ConvertTimezone(Expression):
    """convert_timezone(source_tz, target_tz, ts), both zones plan-time
    literals known to ``tzdb``: wall(source) -> UTC -> wall(target)."""

    def __init__(self, source_tz, target_tz, ts):
        super().__init__([ts])
        self.source_tz = str(source_tz)
        self.target_tz = str(target_tz)

    def sql_string(self):
        return (f"convert_timezone({self.source_tz}, {self.target_tz}, "
                f"{self.children[0].sql_string()})")

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = self.children[0].nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        micros = c.data.to(torch.int64)
        utc = micros - _zone_offsets(self.source_tz, _fdiv(
            micros, 1_000_000), "wall_starts") * 1_000_000
        off = _zone_offsets(self.target_tz, _fdiv(utc, 1_000_000),
                            "utc_instants")
        return DeviceColumn(T.TIMESTAMP, c.validity,
                            data=utc + off * 1_000_000)


class _NameLookup(_DateField):
    """Three-letter names from a fixed table, gathered on the device."""

    _NAMES: tuple = ()

    def _resolve_type(self):
        self._dataType = T.STRING
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        days = _days_of(c, self.child.dataType)
        y, m, d = civil_from_days(days)
        tbl = torch.tensor([list(nm.encode()) for nm in self._NAMES],
                           dtype=torch.uint8, device=c.device)
        idx = self._index(y, m, d, days).clamp(0, len(self._NAMES) - 1)
        return DeviceColumn(T.STRING, c.validity, chars=tbl[idx],
                            lengths=torch.full((c.capacity,), 3,
                                               dtype=torch.int32,
                                               device=c.device))

    def _index(self, y, m, d, days):
        raise NotImplementedError


class MonthName(_NameLookup):
    _NAMES = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
              "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")

    def _index(self, y, m, d, days):
        return m - 1


class DayName(_NameLookup):
    _NAMES = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")

    def _index(self, y, m, d, days):
        return torch.remainder(days + 3, 7)


class LocalTimestamp(CurrentTimestamp):
    """localtimestamp(): current_timestamp in the UTC session time zone."""


class DatePart(Expression):
    """date_part(field, source): the literal field routes to its
    extraction at resolve time; an unknown field is an analysis error."""

    _FIELDS = {"year": Year, "yr": Year, "years": Year,
               "month": Month, "mon": Month, "months": Month,
               "day": DayOfMonth, "d": DayOfMonth, "days": DayOfMonth,
               "dayofweek": DayOfWeek, "dow": DayOfWeek,
               "doy": DayOfYear, "quarter": Quarter, "qtr": Quarter,
               "week": WeekOfYear, "weeks": WeekOfYear,
               "hour": Hour, "hours": Hour, "h": Hour,
               "minute": Minute, "min": Minute, "minutes": Minute,
               "second": Second, "sec": Second, "seconds": Second}

    def __init__(self, field, source):
        super().__init__([source])
        self.field = str(field).lower()
        self._inner = None

    def sql_string(self):
        return f"date_part({self.field}, {self.children[0].sql_string()})"

    def resolve(self, schema):
        self.children = [c.resolve(schema) for c in self.children]
        cls = self._FIELDS.get(self.field)
        if cls is None:
            raise ValueError(
                f"date_part: unsupported extract field {self.field!r}")
        self._inner = cls(self.children[0])
        self._inner.resolved = True
        self._inner._resolve_type()
        self._resolve_type()
        self.resolved = True
        return self

    def _resolve_type(self):
        self._dataType = (self._inner.dataType if self._inner is not None
                          else T.INT)
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        return self._inner.do_columnar_eval(ctx, cols)


class ParseToDate(Expression):
    """to_date(e, fmt): the default grammar's formats ride ``ToDate``;
    another literal format is tagged off the device (the reference's
    ``_check_parse_to_datetime``), where the CPU engine runs it as the
    reference's oracle does, with the default grammar too."""

    def __init__(self, child: Expression, fmt: Expression = None):
        super().__init__([child] if fmt is None else [child, fmt])

    def _resolve_type(self):
        self._dataType = T.DATE
        self._nullable = True

    def sql_string(self):
        return f"to_date({', '.join(c.sql_string() for c in self.children)})"

    @property
    def fmt_literal(self):
        """None without a format; the format's text; False for a format
        that is not a non-null literal."""
        if len(self.children) == 1:
            return None
        text = literal_text(self.children[1])
        return False if text is None else text

    _inner_cls = ToDate

    def do_columnar_eval(self, ctx, cols):
        inner = self._inner_cls(self.children[0])
        inner._resolve_type()
        return inner.do_columnar_eval(ctx, cols[:1])


class ParseToTimestamp(ParseToDate):
    """to_timestamp(e, fmt): as ``ParseToDate``, over ``ToTimestamp``."""

    _inner_cls = ToTimestamp

    def _resolve_type(self):
        self._dataType = T.TIMESTAMP
        self._nullable = True

    def sql_string(self):
        return (f"to_timestamp("
                f"{', '.join(c.sql_string() for c in self.children)})")


_EXTRACT_FIELDS = {
    "year": Year, "yearofweek": Year, "month": Month, "mon": Month,
    "day": DayOfMonth, "days": DayOfMonth, "d": DayOfMonth,
    "dayofweek": DayOfWeek, "dow": DayOfWeek,
    "doy": DayOfYear, "quarter": Quarter, "qtr": Quarter,
    "week": WeekOfYear, "weeks": WeekOfYear, "w": WeekOfYear,
    "hour": Hour, "hours": Hour, "h": Hour,
    "minute": Minute, "minutes": Minute, "min": Minute,
    "second": Second, "seconds": Second, "s": Second,
}


class Extract(Expression):
    """extract(FIELD FROM source): its field's expression, chosen at
    resolve time (Spark resolves Extract so at analysis).  ``yearofweek``
    is the calendar year and ``second`` an INT, as in the reference
    (ROADMAP R30, R31)."""

    def __init__(self, field: Expression, source: Expression):
        super().__init__([field, source])

    def _resolve_type(self):
        f = self.children[0]
        name = str(f.value).lower() if isinstance(f, Literal) else None
        cls = _EXTRACT_FIELDS.get(name)
        self._delegate = None
        if cls is not None:
            d = cls(self.children[1])
            d._resolve_type()
            self._delegate = d
        self._dataType = (self._delegate._dataType if self._delegate
                          else T.INT)
        self._nullable = True

    def sql_string(self):
        return (f"extract({self.children[0].sql_string()} FROM "
                f"{self.children[1].sql_string()})")

    def do_columnar_eval(self, ctx, cols):
        return self._delegate.do_columnar_eval(ctx, cols[1:])


class TryToTimestamp(ParseToTimestamp):
    """try_to_timestamp: null instead of an error on a malformed input,
    ANSI or not."""

    def sql_string(self):
        return (f"try_to_timestamp("
                f"{', '.join(c.sql_string() for c in self.children)})")

    def do_columnar_eval(self, ctx, cols):
        saved = ctx.ansi
        ctx.ansi = False
        try:
            return super().do_columnar_eval(ctx, cols)
        finally:
            ctx.ansi = saved

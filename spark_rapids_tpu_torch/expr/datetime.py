"""Date expressions — port of the DATE part of
``spark_rapids_tpu/expr/datetime.py``: the fields (``Year``, ``Month``,
``DayOfMonth``, ``DayOfWeek``, ``DayOfYear``, ``Quarter``,
``WeekOfYear``), ``LastDay``, ``DateAdd``/``DateSub``/``DateDiff``,
``AddMonths`` with its month-end clamp, ``MonthsBetween`` and
``TruncDate``.

A DATE is int32 days since 1970-01-01.  Every field rides the branch-free
civil-calendar math of ``expr/cast.py`` (``civil_from_days``,
``days_from_civil``) on int64 tensors, with floor division, so days before
1970 and before year 1000 come out as the proleptic Gregorian calendar
gives them.  A TIMESTAMP input (int64 microseconds, UTC) is read as its
day, floored, as the reference reads it; ``months_between`` adds its time
of day.  ``DateAdd``, ``DateSub`` and ``DateDiff`` take DATE inputs only
(their rules in ``overrides/meta.py``).  The time fields (``Hour``,
``Minute``, ``Second``, ``UnixTimestamp``) wait for timestamp columns.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import BinaryExpression, UnaryExpression
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


def _month_len(y, m):
    """Days in month (y, m), as a difference of civil days."""
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, 1, m + 1)
    one = torch.ones_like(m)
    return days_from_civil(ny, nm, one) - days_from_civil(y, m, one)


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
        ny = _fdiv(total, 12)
        nm = torch.remainder(total, 12) + 1
        out = days_from_civil(ny, nm, torch.minimum(d, _month_len(ny, nm)))
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
        from spark_rapids_tpu_torch.expr.base import Literal

        fmt = self.children[1]
        if isinstance(fmt, Literal) and fmt.value is not None:
            return self._FMTS.get(str(fmt.value).lower())
        return None

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        days = _days_of(c, self.children[0].dataType)
        y, m, d = civil_from_days(days)
        one = torch.ones_like(m)
        unit = self.unit()
        if unit == "year":
            out = days_from_civil(y, one, one)
        elif unit == "quarter":
            out = days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
        elif unit == "month":
            out = days_from_civil(y, m, one)
        elif unit == "week":
            out = days - torch.remainder(days + 3, 7)     # back to Monday
        else:
            return DeviceColumn(T.DATE, torch.zeros_like(c.validity),
                                data=torch.zeros_like(days,
                                                      dtype=torch.int32))
        return DeviceColumn(T.DATE, c.validity, data=out.to(torch.int32))

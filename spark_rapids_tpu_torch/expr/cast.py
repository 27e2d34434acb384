"""Cast — the part of ``spark_rapids_tpu/expr/cast.py`` that comparison and
arithmetic coercion need: integral widening/narrowing, integral -> decimal,
and decimal -> decimal rescale (HALF_UP; overflow -> null, or an error
under ANSI), on the int64 path and on the 128-bit limb path.  Any other
cast raises at evaluation.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.expr.base import EvalContext, UnaryExpression

_INTEGRAL = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


# -- civil-calendar day math (reference ``expr/cast.py:43-65``) -------------

def _fdiv(a, b):
    """Floor division, as ``jnp.floor_divide`` (days before 1970 are
    negative)."""
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day) int64 tensors; Howard
    Hinnant's algorithm, branch-free, proleptic Gregorian."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days since 1970-01-01 (int64)."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(torch.int64)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The casts the port runs, on the device and in a CPU stage."""
    return (src == dst
            or (isinstance(src, _INTEGRAL)
                and isinstance(dst, _INTEGRAL + (T.DecimalType,)))
            or (isinstance(src, T.DecimalType)
                and isinstance(dst, T.DecimalType)))


class Cast(UnaryExpression):
    def __init__(self, child, to: T.DataType, ansi: bool = False):
        super().__init__(child)
        self.to = to
        self._dataType = to
        self.ansi_override = ansi

    def sql_string(self):
        return f"CAST({self.child.sql_string()} AS {self.to.simpleString})"

    def _resolve_type(self):
        self._dataType = self.to
        self._nullable = True

    def resolve(self, schema):
        if schema is not None and not self.child.resolved:
            self.children = [self.child.resolve(schema)]
        self._resolve_type()
        self.resolved = True
        return self

    def do_columnar_eval(self, ctx: EvalContext, cols):
        c = cols[0]
        src, dst = self.child.dataType, self.to
        ansi = ctx.ansi or self.ansi_override
        if src == dst:
            return c
        if isinstance(src, _INTEGRAL) and isinstance(dst, _INTEGRAL):
            return _int_to_int(ctx, c, src, dst, ansi)
        if isinstance(src, _INTEGRAL) and isinstance(dst, T.DecimalType):
            return _int_to_dec(ctx, c, src, dst, ansi)
        if isinstance(src, T.DecimalType) and isinstance(dst, T.DecimalType):
            return _dec_to_dec(ctx, c, src, dst, ansi)
        raise TypeError(f"cast {src} -> {dst} is not ported yet")


_I_MIN = {T.ByteType: -(2 ** 7), T.ShortType: -(2 ** 15),
          T.IntegerType: -(2 ** 31), T.LongType: -(2 ** 63)}
_I_MAX = {T.ByteType: 2 ** 7 - 1, T.ShortType: 2 ** 15 - 1,
          T.IntegerType: 2 ** 31 - 1, T.LongType: 2 ** 63 - 1}


def _int_to_int(ctx, c, src, dst, ansi):
    narrowing = (_I_MIN[type(dst)] > _I_MIN[type(src)]
                 or _I_MAX[type(dst)] < _I_MAX[type(src)])
    if ansi and narrowing:
        bad = (c.data < _I_MIN[type(dst)]) | (c.data > _I_MAX[type(dst)])
        ctx.add_error(bad & c.validity, f"cast overflow to {dst} (ANSI)")
    # narrowing wraps, Java semantics
    return DeviceColumn(dst, c.validity,
                        data=c.data.to(column_torch_dtype(dst)))


def _p10(k):
    return 10 ** int(min(max(k, 0), 18))


def _dec_rescale(ctx, data, validity, from_scale, to: T.DecimalType, ansi,
                 op):
    from spark_rapids_tpu_torch.expr.arithmetic import _decimal_bound_check

    diff = to.scale - from_scale
    if diff >= 0:
        out = data * _p10(diff)
    else:
        den = _p10(-diff)
        q = torch.div(data, den, rounding_mode="trunc")
        rem = data - q * den
        round_away = rem.abs() * 2 >= den
        out = q + torch.where(round_away, torch.sign(data),
                              torch.zeros_like(data))
    validity = _decimal_bound_check(ctx, out, to, validity, ansi, op)
    return out, validity


def _dec128_rescale(ctx, hi, lo, validity, from_scale, dst: T.DecimalType,
                    ansi, op):
    """(hi, lo) at from_scale -> dst scale/precision; 128-bit limb path."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    diff = dst.scale - from_scale
    over = torch.zeros_like(validity)
    if diff >= 0:
        over, hi, lo = D.mul128_pow10(hi, lo, diff)
    else:
        hi, lo = D.div128_pow10_half_up(hi, lo, -diff)
    ok = D.in_bounds(hi, lo, dst.precision) & ~over
    if ansi:
        ctx.add_error(~ok & validity, f"decimal {op} overflow (ANSI)")
    else:
        validity = validity & ok
    return hi, lo, validity


def _dec_to_dec(ctx, c, src: T.DecimalType, dst: T.DecimalType, ansi):
    if not src.is_128 and not dst.is_128:
        data, validity = _dec_rescale(ctx, c.data, c.validity, src.scale,
                                      dst, ansi, "cast")
        return DeviceColumn(dst, validity, data=data)
    from spark_rapids_tpu_torch.expr import decimal128 as D

    hi, lo = D.column_limbs(c)
    hi, lo, validity = _dec128_rescale(ctx, hi, lo, c.validity, src.scale,
                                       dst, ansi, "cast")
    if dst.is_128:
        return DeviceColumn(dst, validity, data=D.pack(hi, lo))
    # narrowing: the bound check guarantees |v| < 10^18, so lo IS the value
    return DeviceColumn(dst, validity, data=lo)


def _int_to_dec(ctx, c, src, dst: T.DecimalType, ansi):
    data = c.data.to(torch.int64)
    if dst.is_128:
        from spark_rapids_tpu_torch.expr import decimal128 as D

        hi, lo = D.from64(data)
        hi, lo, validity = _dec128_rescale(ctx, hi, lo, c.validity, 0, dst,
                                           ansi, "cast")
        return DeviceColumn(dst, validity, data=D.pack(hi, lo))
    data, validity = _dec_rescale(ctx, data, c.validity, 0, dst, ansi,
                                  "cast")
    return DeviceColumn(dst, validity, data=data)

"""Math expressions — port of ``spark_rapids_tpu/expr/mathfuncs.py``.

Spark specifics, as the reference has them: the log of a non-positive
value is null; ``round`` is HALF_UP (not banker's) and ``bround`` HALF_EVEN;
``floor``/``ceil`` of an integral return the input, of a decimal a decimal
of scale 0, of a double a LONG; pow, exp and the trigonometric functions
follow java.lang.Math as torch computes them (a few units in the last
place apart between XLA, torch on the CPU and CUDA's libdevice).

Divisions divide by tensors (CUDA divides by a Python scalar as a multiply
by its reciprocal), powers of ten come from a table of exact doubles, and
a double reaches an integer only through ``cast.long_of_double`` (torch's
conversion of NaN, an infinity or a value past 2^63 differs between the
CPU and CUDA).  ``round`` on a double is ``floor(x * 10^s + 0.5) / 10^s``,
as the reference's device computes it; Spark rounds the double's decimal
string (ROADMAP Queue 3, R13).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import (BinaryExpression, Expression,
                                              UnaryExpression)
from spark_rapids_tpu_torch.expr.cast import Cast, long_of_double

_POW10_LO = -300


def pow10_of(s: torch.Tensor) -> torch.Tensor:
    """10.0 ** s of an integer tensor, exact where 10^s is a double (the
    same doubles Python's ``10.0 ** k`` gives), from a table; ``s``
    clamped to [-300, 300]."""
    table = torch.tensor([10.0 ** k for k in range(_POW10_LO, 301)],
                         dtype=torch.float64, device=s.device)
    idx = torch.clamp(s.to(torch.int64), _POW10_LO, 300) - _POW10_LO
    return table[idx]


class _UnaryMathToDouble(UnaryExpression):
    def _resolve_type(self):
        if self.child.dataType != T.DOUBLE:
            self.children = [Cast(self.child, T.DOUBLE).resolve(None)]
        self._dataType = T.DOUBLE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        data, extra_null = self._fn(c.data)
        validity = (c.validity if extra_null is None
                    else c.validity & ~extra_null)
        return DeviceColumn(T.DOUBLE, validity, data=data)

    def _fn(self, x):
        raise NotImplementedError


def _where_bad(x, bad, fill: float):
    return torch.where(bad, torch.full_like(x, fill), x)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root: CUDA's ``sqrt`` is, torch's
    vectorized CPU ``sqrt`` is not (about one double in 120 is a unit in
    the last place off), so on the CPU numpy's (the hardware's) takes
    its place."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))


class Sqrt(_UnaryMathToDouble):
    def _fn(self, x):
        return sqrt_rn(_where_bad(x, x < 0, math.nan)), None


class Exp(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.exp(x), None


class Log(_UnaryMathToDouble):
    """Spark ln(x): null for x <= 0."""

    def _fn(self, x):
        bad = x <= 0
        return torch.log(_where_bad(x, bad, 1.0)), bad


class Log10(_UnaryMathToDouble):
    def _fn(self, x):
        bad = x <= 0
        return torch.log10(_where_bad(x, bad, 1.0)), bad


class Sin(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.sin(x), None


class Cos(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.cos(x), None


class Tan(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.tan(x), None


class Asin(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.asin(x), None


class Acos(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.acos(x), None


class Atan(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.atan(x), None


class Signum(_UnaryMathToDouble):
    def _fn(self, x):
        # torch.sign gives 0 for NaN; jnp.sign and Math.signum give NaN
        return torch.where(torch.isnan(x), x, torch.sign(x)), None


class Sinh(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.sinh(x), None


class Cosh(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.cosh(x), None


class Tanh(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.tanh(x), None


class Asinh(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.asinh(x), None


class Acosh(_UnaryMathToDouble):
    """java.lang.StrictMath semantics: x < 1 -> NaN."""

    def _fn(self, x):
        return torch.acosh(x), None


class Atanh(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.atanh(x), None


class Cbrt(_UnaryMathToDouble):
    """torch has no cbrt: ``|x|^(1/3)`` with the sign, then one Newton
    step (``y - (y - x / y^2) / 3``, no cube that could leave the normal
    range); 0, the infinities and NaN pass through."""

    def _fn(self, x):
        three = torch.full_like(x, 3.0)
        y = torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)
        y2 = y - (y - x / (y * y)) / three
        keep = (x == 0) | ~torch.isfinite(x)
        return torch.where(keep, x, y2), None


class Log2(_UnaryMathToDouble):
    """Spark log2(x): null for x <= 0."""

    def _fn(self, x):
        bad = x <= 0
        return torch.log2(_where_bad(x, bad, 1.0)), bad


class Log1p(_UnaryMathToDouble):
    """Spark log1p(x): null for x <= -1."""

    def _fn(self, x):
        bad = x <= -1.0
        return torch.log1p(_where_bad(x, bad, 0.0)), bad


class Expm1(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.expm1(x), None


class Rint(_UnaryMathToDouble):
    """Math.rint: round half to EVEN (unlike Spark round's HALF_UP)."""

    def _fn(self, x):
        return torch.round(x), None


class Cot(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.ones_like(x) / torch.tan(x), None


class Csc(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.ones_like(x) / torch.sin(x), None


class Sec(_UnaryMathToDouble):
    def _fn(self, x):
        return torch.ones_like(x) / torch.cos(x), None


class ToDegrees(_UnaryMathToDouble):
    def _fn(self, x):
        return x * (180.0 / math.pi), None        # as numpy's degrees


class ToRadians(_UnaryMathToDouble):
    def _fn(self, x):
        return x * (math.pi / 180.0), None        # as numpy's radians


class Pow(BinaryExpression):
    def _resolve_type(self):
        for i in (0, 1):
            if self.children[i].dataType != T.DOUBLE:
                self.children[i] = Cast(self.children[i],
                                        T.DOUBLE).resolve(None)
        self._dataType = T.DOUBLE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        return DeviceColumn(T.DOUBLE, l.validity & r.validity,
                            data=torch.pow(l.data, r.data))


class Floor(UnaryExpression):
    """floor returns LONG for a double, the input type for an integral, a
    decimal of scale 0 for a decimal."""

    def _resolve_type(self):
        ct = self.child.dataType
        if ct.is_integral:
            self._dataType = ct
        elif isinstance(ct, T.DecimalType):
            self._dataType = T.DecimalType(
                min(ct.precision - ct.scale + 1, 38), 0)
        else:
            if ct != T.DOUBLE:
                self.children = [Cast(self.child, T.DOUBLE).resolve(None)]
            self._dataType = T.LONG
        self._nullable = self.child.nullable

    def _round(self, x):
        return torch.floor(x)

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        ct = self.child.dataType
        if ct.is_integral:
            return c
        if isinstance(ct, T.DecimalType):
            den = 10 ** min(ct.scale, 18)
            q = torch.div(c.data, den, rounding_mode="floor")
            if isinstance(self, Ceil):
                q = q + (c.data - q * den != 0).to(q.dtype)
            return DeviceColumn(self.dataType, c.validity, data=q)
        return DeviceColumn(T.LONG, c.validity,
                            data=long_of_double(self._round(c.data)))


class Ceil(Floor):
    def _round(self, x):
        return torch.ceil(x)


class Round(Expression):
    """round(x, scale) HALF_UP (Spark/BigDecimal), not numpy banker's."""

    def __init__(self, child: Expression, scale: Expression):
        super().__init__([child, scale])

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.base import Literal

        ct = self.children[0].dataType
        if isinstance(ct, T.DecimalType):
            s = self.children[1]
            assert isinstance(s, Literal), "round scale must be literal"
            new_scale = min(max(int(s.value), 0), ct.scale)
            self._dataType = T.DecimalType(
                min(ct.precision - ct.scale + new_scale + 1, 38), new_scale)
        else:
            self._dataType = ct if ct.is_numeric else T.DOUBLE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c, s = cols
        ct = self.children[0].dataType
        dt = self.dataType
        if isinstance(ct, T.DecimalType):
            from spark_rapids_tpu_torch.expr.cast import _dec_rescale

            data, validity = _dec_rescale(ctx, c.data, c.validity, ct.scale,
                                          dt, ctx.ansi, "round")
            return DeviceColumn(dt, validity, data=data)
        if ct.is_integral:
            return c  # round(int, >= 0) is the identity
        x, scale_f = self._scaled(c, s)
        r = torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))
        return DeviceColumn(dt, c.validity & s.validity,
                            data=(r / scale_f).to(c.data.dtype))

    @staticmethod
    def _scaled(c, s):
        scale_f = pow10_of(s.data)
        return c.data.to(torch.float64) * scale_f, scale_f


class BRound(Round):
    """bround(x, scale) HALF_EVEN (banker's rounding); decimals stay off
    the device (``_check_bround``)."""

    def do_columnar_eval(self, ctx, cols):
        c, s = cols
        ct = self.children[0].dataType
        if ct.is_integral:
            return c
        x, scale_f = self._scaled(c, s)
        return DeviceColumn(self.dataType, c.validity & s.validity,
                            data=(torch.round(x) / scale_f).to(
                                c.data.dtype))


class _BinaryMathToDouble(BinaryExpression):
    def _resolve_type(self):
        self.children = [c if c.dataType == T.DOUBLE
                         else Cast(c, T.DOUBLE).resolve(None)
                         for c in self.children]
        self._dataType = T.DOUBLE
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        return DeviceColumn(T.DOUBLE, l.validity & r.validity,
                            data=self._fn(l.data, r.data))


class Atan2(_BinaryMathToDouble):
    def _fn(self, a, b):
        return torch.atan2(a, b)


class Hypot(_BinaryMathToDouble):
    def _fn(self, a, b):
        return torch.hypot(a, b)


class Logarithm(_BinaryMathToDouble):
    """log(base, x): null when x <= 0 or base <= 0 or base == 1."""

    def do_columnar_eval(self, ctx, cols):
        b, x = cols
        bad_b = (b.data <= 0) | (b.data == 1.0)
        bad = (x.data <= 0) | bad_b
        out = (torch.log(_where_bad(x.data, x.data <= 0, 1.0))
               / torch.log(_where_bad(b.data, bad_b, 2.0)))
        return DeviceColumn(T.DOUBLE, b.validity & x.validity & ~bad,
                            data=out)


class WidthBucket(Expression):
    """width_bucket(v, lo, hi, n) — 1-based bucket; 0 / n+1 outside."""

    def __init__(self, v, lo, hi, n):
        super().__init__([v, lo, hi, n])

    def sql_string(self):
        return ("width_bucket("
                + ", ".join(c.sql_string() for c in self.children) + ")")

    def _resolve_type(self):
        self._dataType = T.LONG
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        v, lo, hi = (c.data.to(torch.float64) for c in cols[:3])
        nb = cols[3].data.to(torch.int64)
        ok = ((nb > 0) & torch.isfinite(v) & torch.isfinite(lo)
              & torch.isfinite(hi) & (lo != hi))
        asc = lo < hi
        width = (hi - lo) / nb.to(torch.float64)
        b_asc = long_of_double(torch.floor((v - lo) / width)) + 1
        b_desc = long_of_double(torch.floor((lo - v) / -width)) + 1
        b = torch.where(asc, b_asc, b_desc)
        below = torch.where(asc, v < lo, v > lo)
        above = torch.where(asc, v >= hi, v <= hi)
        res = torch.where(below, torch.zeros_like(b),
                          torch.where(above, nb + 1, b))
        res = torch.minimum(torch.clamp(res, min=0), nb + 1)
        validity = ok
        for c in cols:
            validity = validity & c.validity
        return DeviceColumn(T.LONG, validity, data=res)


class Factorial(UnaryExpression):
    """factorial(n) for n in [0, 20]; outside -> null (Spark)."""

    def _resolve_type(self):
        self._dataType = T.LONG
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        table = torch.tensor([math.factorial(i) for i in range(21)] + [0],
                             dtype=torch.int64, device=c.device)
        v = c.data.to(torch.int64)
        ok = (v >= 0) & (v <= 20)
        return DeviceColumn(T.LONG, c.validity & ok,
                            data=table[torch.clamp(v, 0, 21)])


class BitwiseCount(UnaryExpression):
    """bit_count(x) — set bits (a boolean counts itself)."""

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        if isinstance(self.child.dataType, T.BooleanType):
            return DeviceColumn(T.INT, c.validity,
                                data=c.data.to(torch.int32))
        # Spark counts the bits of the SIGN-EXTENDED value (Java widening),
        # so bit_count(tinyint -1) is 64, not 8
        x = c.data.to(torch.int64)
        res = torch.zeros_like(x)
        for shift in range(0, 64, 8):
            b = (x >> shift) & 0xFF
            # 8-bit popcount, SWAR
            b = b - ((b >> 1) & 0x55)
            b = (b & 0x33) + ((b >> 2) & 0x33)
            res = res + ((b + (b >> 4)) & 0x0F)
        return DeviceColumn(T.INT, c.validity, data=res.to(torch.int32))

"""Arithmetic expressions with Spark semantics — port of
``spark_rapids_tpu/expr/arithmetic.py``.

  * integral overflow wraps (Java two's complement); ANSI mode raises.
  * Decimal +,- follow DecimalPrecision: s=max(s1,s2),
    p=max(p1-s1,p2-s2)+s+1; * gives p=p1+p2+1, s=s1+s2 (capped at 38).
    Results beyond the result precision are null (legacy) or an error
    (ANSI).  A product above 18 digits is exact in two int64 limbs
    (``decimal128.mul64_to_128``).
  * Divide on non-decimals is a double division (by a tensor: CUDA
    divides by a Python scalar as a multiply by its reciprocal); x/0 is
    null, or an error under ANSI.  A decimal divide scales the numerator
    by 10^shift in int64 and rounds HALF_UP; the tagging keeps one whose
    numerator could pass 18 digits off the device (``_check_decimal_div``).
  * IntegralDivide, Remainder and Pmod truncate as Java does (torch's
    ``div(rounding_mode="trunc")``, with Long.MIN_VALUE / -1 wrapping);
    Remainder and Pmod on doubles take the exact IEEE ``fmod`` (Java's
    ``%``; the reference's device computes ``a - trunc(a / b) * b``,
    ROADMAP Queue 3, R10); a decimal Remainder or Pmod rescales both
    operands to the result's scale (the reference's device skips the
    rescale, R11).
  * Shift amounts are masked to the value's width, as Java masks them.
  * ``try_*``: the ANSI operation with its errors as nulls.
"""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import (BinaryExpression, EvalContext,
                                              UnaryExpression)

_INT64_MIN = -(2 ** 63)
_INT_MIN = {T.ByteType: -(2 ** 7), T.ShortType: -(2 ** 15),
            T.IntegerType: -(2 ** 31), T.LongType: -(2 ** 63)}


def _pow10_i64(k: int):
    return 10 ** min(k, 18)


class BinaryArithmetic(BinaryExpression):
    symbol = "?"

    def sql_string(self):
        return (f"({self.left.sql_string()} {self.symbol} "
                f"{self.right.sql_string()})")

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        lt, rt = self.left.dataType, self.right.dataType
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            ld = lt if isinstance(lt, T.DecimalType) else _int_as_decimal(lt)
            rd = rt if isinstance(rt, T.DecimalType) else _int_as_decimal(rt)
            if not isinstance(lt, T.DecimalType):
                self.children[0] = Cast(self.left, ld).resolve(None)
            if not isinstance(rt, T.DecimalType):
                self.children[1] = Cast(self.right, rd).resolve(None)
            self._dataType = self._decimal_result(ld, rd)
            self._nullable = True
            return
        if lt != rt:
            common = T.numeric_promote(lt, rt)
            if lt != common:
                self.children[0] = Cast(self.left, common).resolve(None)
            if rt != common:
                self.children[1] = Cast(self.right, common).resolve(None)
        self._dataType = self.left.dataType
        self._nullable = self.left.nullable or self.right.nullable

    def _decimal_result(self, ld: T.DecimalType,
                        rd: T.DecimalType) -> T.DecimalType:
        raise NotImplementedError

    def do_columnar_eval(self, ctx: EvalContext, cols: List[DeviceColumn]):
        l, r = cols
        validity = l.validity & r.validity
        dt = self.dataType
        if isinstance(dt, T.DecimalType):
            return self._eval_decimal(ctx, l, r, validity)
        data = self._op(l.data, r.data)
        if ctx.ansi and dt.is_integral:
            over = self._overflow_flag(l.data, r.data, data)
            ctx.add_error(over & validity,
                          f"{self.pretty_name} caused overflow (ANSI)")
        return DeviceColumn(dt, validity, data=data)

    def _op(self, a, b):
        raise NotImplementedError

    def _overflow_flag(self, a, b, res):
        raise NotImplementedError

    def _eval_decimal(self, ctx, l, r, validity):
        raise NotImplementedError(f"decimal {self.pretty_name}")


def _int_as_decimal(t: T.DataType) -> T.DecimalType:
    digits = {T.ByteType: 3, T.ShortType: 5, T.IntegerType: 10,
              T.LongType: 20}.get(type(t))
    if digits is None:
        raise TypeError(f"cannot mix {t} with decimal")
    return T.DecimalType(min(digits, 38), 0)


def _decimal_bound_check(ctx, data, dt: T.DecimalType, validity, ansi: bool,
                         op: str, extra_invalid=None):
    """Null out (legacy) or flag (ANSI) results beyond 10^precision.  For
    precision >= 19 the int64 storage is the bound; only INT64_MIN is
    excluded, since callers use it as a wrap sentinel."""
    if dt.precision >= 19:
        bound_ok = data != _INT64_MIN
    else:
        bound = _pow10_i64(dt.precision)
        bound_ok = (data < bound) & (data > -bound)
    if extra_invalid is not None:
        bound_ok = bound_ok & ~extra_invalid
    if ansi:
        ctx.add_error(~bound_ok & validity, f"decimal {op} overflow (ANSI)")
        return validity
    return validity & bound_ok


class Add(BinaryArithmetic):
    symbol = "+"
    _dec_sign = 1

    def _op(self, a, b):
        return a + b

    def _overflow_flag(self, a, b, res):
        return (((a > 0) & (b > 0) & (res < 0))
                | ((a < 0) & (b < 0) & (res >= 0)))

    def _decimal_result(self, ld, rd):
        s = max(ld.scale, rd.scale)
        p = max(ld.precision - ld.scale, rd.precision - rd.scale) + s + 1
        return T.DecimalType(min(p, 38), s)

    def _eval_decimal(self, ctx, l, r, validity):
        dt: T.DecimalType = self.dataType
        lt: T.DecimalType = self.left.dataType
        rt: T.DecimalType = self.right.dataType
        op = "add" if self._dec_sign > 0 else "subtract"
        if dt.is_128 or lt.is_128 or rt.is_128:
            from spark_rapids_tpu_torch.expr import decimal128 as D

            ah, al = D.column_limbs(l)
            bh, bl = D.column_limbs(r)
            oa, ah, al = D.mul128_pow10(ah, al, dt.scale - lt.scale)
            ob, bh, bl = D.mul128_pow10(bh, bl, dt.scale - rt.scale)
            if self._dec_sign < 0:
                bh, bl = D.neg128(bh, bl)
            rh, rl = D.add128(ah, al, bh, bl)
            # signed 128 wrap: same operand signs, different result sign
            wrap = ((ah < 0) == (bh < 0)) & ((rh < 0) != (ah < 0))
            ok = D.in_bounds(rh, rl, dt.precision) & ~wrap & ~oa & ~ob
            if ctx.ansi:
                ctx.add_error(~ok & validity, f"decimal {op} overflow (ANSI)")
            else:
                validity = validity & ok
            data = D.pack(rh, rl) if dt.is_128 else rl
            return DeviceColumn(dt, validity, data=data)
        a = l.data * _pow10_i64(dt.scale - lt.scale)
        b = r.data * _pow10_i64(dt.scale - rt.scale)
        data = a + b if self._dec_sign > 0 else a - b
        validity = _decimal_bound_check(ctx, data, dt, validity, ctx.ansi, op)
        return DeviceColumn(dt, validity, data=data)


class Subtract(Add):
    symbol = "-"
    _dec_sign = -1

    def _op(self, a, b):
        return a - b

    def _overflow_flag(self, a, b, res):
        return (((a >= 0) & (b < 0) & (res < 0))
                | ((a < 0) & (b > 0) & (res >= 0)))


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _op(self, a, b):
        return a * b

    def _overflow_flag(self, a, b, res):
        # res/b != a detects overflow without widening; MIN * -1 needs its
        # own check (the division wraps back to MIN)
        imin = torch.iinfo(res.dtype).min
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        return (((b != 0)
                 & (torch.div(res, safe_b, rounding_mode="floor") != a))
                | ((a == imin) & (b == -1)))

    def _decimal_result(self, ld, rd):
        return T.DecimalType(min(ld.precision + rd.precision + 1, 38),
                             min(ld.scale + rd.scale, 38))

    def _eval_decimal(self, ctx, l, r, validity):
        dt: T.DecimalType = self.dataType
        lt: T.DecimalType = self.left.dataType
        rt: T.DecimalType = self.right.dataType
        if lt.is_128 or rt.is_128:
            # 128x128 needs 256-bit intermediates; the plan rewrite tags
            # it for a CPU stage first (overrides/meta._check_decimal_mult)
            raise NotImplementedError("decimal multiply operands > 18 digits")
        if dt.is_128:
            from spark_rapids_tpu_torch.expr import decimal128 as D

            rh, rl = D.mul64_to_128(l.data, r.data)   # exact, cannot wrap
            ok = D.in_bounds(rh, rl, dt.precision)
            if ctx.ansi:
                ctx.add_error(~ok & validity,
                              "decimal multiply overflow (ANSI)")
            else:
                validity = validity & ok
            return DeviceColumn(dt, validity, data=D.pack(rh, rl))
        data = l.data * r.data
        # int64 intermediate overflow, detected by a float magnitude estimate
        approx = l.data.to(torch.float64) * r.data.to(torch.float64)
        i64_over = approx.abs() > 9.1e18
        validity = _decimal_bound_check(ctx, data, dt, validity, ctx.ansi,
                                        "multiply", extra_invalid=i64_over)
        return DeviceColumn(dt, validity, data=data)


class Divide(BinaryArithmetic):
    """Spark Divide: non-decimal operands -> double division."""

    symbol = "/"

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        lt, rt = self.left.dataType, self.right.dataType
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            super()._resolve_type()
            return
        if lt != T.DOUBLE:
            self.children[0] = Cast(self.left, T.DOUBLE).resolve(None)
        if rt != T.DOUBLE:
            self.children[1] = Cast(self.right, T.DOUBLE).resolve(None)
        self._dataType = T.DOUBLE
        self._nullable = True

    def _decimal_result(self, ld, rd):
        s = max(6, ld.scale + rd.precision + 1)
        p = ld.precision - ld.scale + rd.scale + s
        if p > 38:
            # Spark reduces the scale to fit
            s = max(6, 38 - (p - s))
            p = 38
        return T.DecimalType(p, s)

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        if isinstance(self.dataType, T.DecimalType):
            return self._eval_decimal(ctx, l, r, l.validity & r.validity)
        div_by_zero = r.data == 0.0
        validity = l.validity & r.validity & ~div_by_zero
        if ctx.ansi:
            ctx.add_error(div_by_zero & l.validity & r.validity,
                          "division by zero (ANSI)")
        data = l.data / torch.where(div_by_zero, torch.ones_like(r.data),
                                    r.data)
        return DeviceColumn(T.DOUBLE, validity, data=data)

    def _eval_decimal(self, ctx, l, r, validity):
        dt: T.DecimalType = self.dataType
        lt: T.DecimalType = self.left.dataType
        rt: T.DecimalType = self.right.dataType
        div_by_zero = r.data == 0
        if ctx.ansi:
            ctx.add_error(div_by_zero & validity, "division by zero (ANSI)")
        validity = validity & ~div_by_zero
        # the numerator at scale s + rt.scale, then HALF_UP
        shift = dt.scale - lt.scale + rt.scale
        num_scale = _pow10_i64(max(shift, 0))
        # int64 intermediate overflow: |l| * 10^shift must fit
        num_over = l.data.abs() > (2 ** 63 - 1) // num_scale
        if ctx.ansi:
            ctx.add_error(num_over & validity,
                          "decimal divide overflow (ANSI)")
        validity = validity & ~num_over
        num = torch.where(num_over, torch.zeros_like(l.data),
                          l.data) * num_scale
        den = torch.where(div_by_zero, torch.ones_like(r.data),
                          r.data) * _pow10_i64(max(-shift, 0))
        data = div_half_up(num, den)
        validity = _decimal_bound_check(ctx, data, dt, validity, ctx.ansi,
                                        "divide")
        return DeviceColumn(dt, validity, data=data)


def div_half_up(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den (int64, den != 0) rounded HALF_UP: the truncated
    quotient, away from zero when 2 |rem| >= |den|, asked as |rem| >=
    |den| - |rem| so that nothing doubles past 2^63."""
    q = _trunc_div(num, den)
    rem = (num - q * den).abs()
    away = (rem != 0) & (rem >= den.abs() - rem)
    sign = torch.where((num < 0) ^ (den < 0), -1, 1).to(num.dtype)
    return q + torch.where(away, sign, torch.zeros_like(sign))


def _trunc_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java's integer division (b != 0): truncating, MIN / -1 == MIN."""
    wrap = (a == torch.iinfo(a.dtype).min) & (b == -1)
    return torch.div(a, torch.where(wrap, torch.ones_like(b), b),
                     rounding_mode="trunc")


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0 ** k for integers 0 <= k <= 1023, built from the exponent bits
    (exact, and the same on every device)."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _fmod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Java's ``%`` on doubles: the exact IEEE remainder with the sign of
    the dividend; b == 0 gives 0.  torch's CPU ``fmod`` gives NaN where
    a / b overflows (CUDA's is exact), so where a's exponent passes b's
    by more than 1000, a is first reduced modulo b * 2^k (a multiple of
    b, so a's class modulo b is kept), twice at most: exact, and the same
    on both devices."""
    b = torch.where(b == 0.0, torch.ones_like(b), b)
    r = a
    _, eb = torch.frexp(b)
    for _ in range(2):
        _, ea = torch.frexp(r)
        k = torch.clamp(ea.to(torch.int64) - eb.to(torch.int64) - 1000,
                        min=0)
        half = k // 2
        bk = b * _pow2(half) * _pow2(k - half)
        r = torch.where(k > 0, torch.fmod(r, bk), r)
    return torch.fmod(r, b)


class IntegralDivide(BinaryArithmetic):
    """`div` — integral division returning LONG (Spark semantics)."""

    symbol = "div"

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        for i in (0, 1):
            if self.children[i].dataType != T.LONG:
                self.children[i] = Cast(self.children[i],
                                        T.LONG).resolve(None)
        self._dataType = T.LONG
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        div_by_zero = r.data == 0
        validity = l.validity & r.validity & ~div_by_zero
        if ctx.ansi:
            ctx.add_error(div_by_zero & l.validity & r.validity,
                          "division by zero (ANSI)")
        den = torch.where(div_by_zero, torch.ones_like(r.data), r.data)
        return DeviceColumn(T.LONG, validity, data=_trunc_div(l.data, den))


class Remainder(BinaryArithmetic):
    symbol = "%"

    def _decimal_result(self, ld, rd):
        s = max(ld.scale, rd.scale)
        p = min(ld.precision - ld.scale, rd.precision - rd.scale) + s
        return T.DecimalType(min(p, 38), s)

    def _operands(self, ctx, l, r):
        """(a, b, validity) with a zero divisor null (an error under
        ANSI); decimals rescaled to the result's scale (the tagging keeps
        a rescale past 18 digits off the device, ``_check_decimal_rem``)."""
        dt = self.dataType
        a, b = l.data, r.data
        if isinstance(dt, T.DecimalType):
            a = a * _pow10_i64(dt.scale - self.left.dataType.scale)
            b = b * _pow10_i64(dt.scale - self.right.dataType.scale)
        zero = b == 0
        validity = l.validity & r.validity
        if ctx.ansi and not dt.is_floating:
            ctx.add_error(zero & validity, "division by zero (ANSI)")
        return a, b, validity & ~zero

    def do_columnar_eval(self, ctx, cols):
        a, b, validity = self._operands(ctx, *cols)
        return DeviceColumn(self.dataType, validity, data=self._rem(a, b))

    def _rem(self, a, b):
        if a.dtype.is_floating_point:
            return _fmod(a, b)
        den = torch.where(b == 0, torch.ones_like(b), b)
        return a - _trunc_div(a, den) * den


class Pmod(Remainder):
    """pmod(a, n): r = a % n (Java's truncated %); where r < 0, (r + n) % n
    — a negative divisor keeps its sign, as in Spark."""

    symbol = "pmod"

    def sql_string(self):
        return f"pmod({self.left.sql_string()}, {self.right.sql_string()})"

    def do_columnar_eval(self, ctx, cols):
        a, b, validity = self._operands(ctx, *cols)
        m = self._rem(a, b)
        return DeviceColumn(self.dataType, validity, data=torch.where(
            m < 0, self._rem(m + b, b), m))


class UnaryMinus(UnaryExpression):
    def sql_string(self):
        return f"(- {self.child.sql_string()})"

    def _resolve_type(self):
        self._dataType = self.child.dataType
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        dt = self.dataType
        if ctx.ansi and dt.is_integral:
            ctx.add_error((c.data == _INT_MIN[type(dt)]) & c.validity,
                          "negate overflow (ANSI)")
        return DeviceColumn(dt, c.validity, data=-c.data)


class Abs(UnaryExpression):
    def _resolve_type(self):
        self._dataType = self.child.dataType
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        dt = self.dataType
        if ctx.ansi and dt.is_integral:
            ctx.add_error((c.data == _INT_MIN[type(dt)]) & c.validity,
                          "abs overflow (ANSI)")
        return DeviceColumn(dt, c.validity, data=c.data.abs())


class UnaryPositive(UnaryExpression):
    """(+ e): identity (Spark keeps the node through analysis)."""

    def sql_string(self):
        return f"(+ {self.child.sql_string()})"

    def _resolve_type(self):
        self._dataType = self.child.dataType
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        return cols[0]


# -- bitwise and shifts -----------------------------------------------------

class _BitwiseBinary(BinaryExpression):
    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        lt, rt = self.left.dataType, self.right.dataType
        if not (lt.is_integral and rt.is_integral):
            raise TypeError(f"{self.pretty_name} needs integral operands")
        common = T.numeric_promote(lt, rt)
        self.children = [c if c.dataType == common
                         else Cast(c, common).resolve(None)
                         for c in self.children]
        self._dataType = common
        self._nullable = self.left.nullable or self.right.nullable

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        return DeviceColumn(self.dataType, l.validity & r.validity,
                            data=self._fn(l.data, r.data))


class BitwiseAnd(_BitwiseBinary):
    symbol = "&"

    def _fn(self, a, b):
        return a & b


class BitwiseOr(_BitwiseBinary):
    symbol = "|"

    def _fn(self, a, b):
        return a | b


class BitwiseXor(_BitwiseBinary):
    symbol = "^"

    def _fn(self, a, b):
        return a ^ b


class BitwiseNot(UnaryExpression):
    def _resolve_type(self):
        if not self.child.dataType.is_integral:
            raise TypeError("~ needs an integral operand")
        self._dataType = self.child.dataType
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(self.dataType, c.validity, data=~c.data)


class _Shift(BinaryExpression):
    """Java shift semantics: the amount is masked to the value's width
    (x << 33 on an int is x << 1), never widened; torch's shifts by the
    width or more differ between the CPU and CUDA, so no amount reaches
    them unmasked."""

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        lt = self.left.dataType
        if not isinstance(lt, (T.IntegerType, T.LongType)):
            self.children[0] = Cast(self.left, T.INT).resolve(None)
            lt = T.INT
        self._dataType = lt
        self._nullable = self.left.nullable or self.right.nullable

    @property
    def _bits(self) -> int:
        return 64 if isinstance(self.dataType, T.LongType) else 32

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        amt = (r.data.to(torch.int32) & (self._bits - 1)).to(l.data.dtype)
        return DeviceColumn(self.dataType, l.validity & r.validity,
                            data=self._fn(l.data, amt))


class ShiftLeft(_Shift):
    def _fn(self, a, amt):
        return a << amt


class ShiftRight(_Shift):
    def _fn(self, a, amt):
        return a >> amt   # arithmetic (sign-propagating)


class ShiftRightUnsigned(_Shift):
    def _fn(self, a, amt):
        # logical: the arithmetic shift with the copied sign bits masked
        # off; an amount of 0 keeps ``a`` (the mask would need 2^width)
        k = torch.clamp(amt, min=1)
        one = torch.ones_like(a)
        mask = (one << (self._bits - k)) - 1
        return torch.where(amt == 0, a, (a >> k) & mask)


# -- try_* ------------------------------------------------------------------

class _AnsiFlags:
    """An always-ANSI evaluation context that keeps the error flags (a
    ``try_*`` operation's rows to null)."""

    ansi = True

    def __init__(self):
        self.error_flags = []

    def add_error(self, flag_per_row, message: str):
        self.error_flags.append((flag_per_row, message))


class _TryMixin:
    """try_* arithmetic: the ANSI operation with errors becoming NULL
    (Spark's TryEval over the ANSI evaluator).  The child op runs with an
    always-ANSI context; its error flags null the result rows instead of
    raising."""

    _fn_name = "try_op"

    def sql_string(self):
        return (f"{self._fn_name}({self.left.sql_string()}, "
                f"{self.right.sql_string()})")

    def do_columnar_eval(self, ctx: EvalContext, cols):
        sub = _AnsiFlags()
        out = super().do_columnar_eval(sub, cols)
        bad = None
        for flag, _msg in sub.error_flags:
            bad = flag if bad is None else (bad | flag)
        if bad is None:
            return out
        return DeviceColumn(out.dtype, out.validity & ~bad, data=out.data)


class TryAdd(_TryMixin, Add):
    _fn_name = "try_add"


class TrySubtract(_TryMixin, Subtract):
    _fn_name = "try_subtract"


class TryMultiply(_TryMixin, Multiply):
    _fn_name = "try_multiply"


class TryDivide(_TryMixin, Divide):
    _fn_name = "try_divide"

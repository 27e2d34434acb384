"""Arithmetic expressions with Spark semantics — port of the Add, Subtract
and Multiply part of ``spark_rapids_tpu/expr/arithmetic.py``.

  * integral overflow wraps (Java two's complement); ANSI mode raises.
  * Decimal +,- follow DecimalPrecision: s=max(s1,s2),
    p=max(p1-s1,p2-s2)+s+1; * gives p=p1+p2+1, s=s1+s2 (capped at 38).
    Results beyond the result precision are null (legacy) or an error
    (ANSI).  A product above 18 digits is exact in two int64 limbs
    (``decimal128.mul64_to_128``).
"""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import BinaryExpression, EvalContext

_INT64_MIN = -(2 ** 63)


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

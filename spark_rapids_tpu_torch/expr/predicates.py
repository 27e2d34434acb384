"""Comparison and boolean predicates with Spark null semantics — port of
``spark_rapids_tpu/expr/predicates.py`` (flat and string columns), with
``In`` over a list of literals.

Comparisons coerce both sides to one type first, as the reference does:
two decimals meet at the wider integral part and the larger scale, an
integer meets a decimal as decimal(10,0)/decimal(20,0), and two other
numerics promote by Spark's tightest-common-type rule.

Strings compare by UTF-8 byte order, as Spark does, on the padded char
matrices (``string_compare``): both sides padded to the wider width, the
first differing byte decides, and when the padded bytes are equal the
shorter string is the smaller (so a string with trailing NUL bytes still
orders after its prefix).  The comparison with a string and a date is
not ported (the reference casts the date to a string).  ``EqualNullSafe``
(``<=>``) and ``IsNaN`` never return null.
"""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import (
    BinaryExpression,
    EvalContext,
    Expression,
    UnaryExpression,
)


def string_compare(l: DeviceColumn, r: DeviceColumn):
    """(lt, eq) bool vectors of two string columns, row by row."""
    w = max(l.width, r.width)
    a = l.with_width(w).chars
    b = r.with_width(w).chars
    diff = a != b
    any_diff = diff.any(dim=1)
    # the first differing byte: argmax over bools is the first True
    first = diff.to(torch.uint8).argmax(dim=1, keepdim=True)
    av = a.gather(1, first).squeeze(1)
    bv = b.gather(1, first).squeeze(1)
    lt = (any_diff & (av < bv)) | (~any_diff & (l.lengths < r.lengths))
    eq = ~any_diff & (l.lengths == r.lengths)
    return lt, eq


def _coerce_comparison(left: Expression, right: Expression):
    """Insert casts so both sides share a comparable type; returns (l, r)."""
    from spark_rapids_tpu_torch.expr.cast import Cast

    lt, rt = left.dataType, right.dataType
    if lt == rt:
        return left, right
    if isinstance(lt, T.DecimalType) and isinstance(rt, T.DecimalType):
        s = max(lt.scale, rt.scale)
        p = max(lt.precision - lt.scale, rt.precision - rt.scale) + s
        common = T.DecimalType(min(p, 38), s)
        return (Cast(left, common).resolve(None),
                Cast(right, common).resolve(None))
    if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
        from spark_rapids_tpu_torch.expr.arithmetic import _int_as_decimal

        ld = lt if isinstance(lt, T.DecimalType) else _int_as_decimal(lt)
        rd = rt if isinstance(rt, T.DecimalType) else _int_as_decimal(rt)
        l2 = left if lt == ld else Cast(left, ld).resolve(None)
        r2 = right if rt == rd else Cast(right, rd).resolve(None)
        return _coerce_comparison(l2, r2)
    if lt.is_numeric and rt.is_numeric:
        common = T.numeric_promote(lt, rt)
        l2 = left if lt == common else Cast(left, common).resolve(None)
        r2 = right if rt == common else Cast(right, common).resolve(None)
        return l2, r2
    if isinstance(lt, T.NullType):
        return Cast(left, rt).resolve(None), right
    if isinstance(rt, T.NullType):
        return left, Cast(right, lt).resolve(None)
    raise TypeError(f"cannot compare {lt} with {rt}")


class BinaryComparison(BinaryExpression):
    symbol = "?"

    def sql_string(self):
        return (f"({self.left.sql_string()} {self.symbol} "
                f"{self.right.sql_string()})")

    def _resolve_type(self):
        self.children = list(_coerce_comparison(self.left, self.right))
        self._dataType = T.BOOLEAN
        self._nullable = self.left.nullable or self.right.nullable

    def do_columnar_eval(self, ctx: EvalContext, cols: List[DeviceColumn]):
        l, r = cols
        validity = l.validity & r.validity
        if l.is_string:
            data = self._from_lt_eq(*string_compare(l, r))
        elif l.is_dec128:
            from spark_rapids_tpu_torch.expr import decimal128 as D

            ah, al = D.unpack(l.data)
            bh, bl = D.unpack(r.data)
            data = self._from_lt_eq(D.lt128(ah, al, bh, bl),
                                    D.eq128(ah, al, bh, bl))
        else:
            data = self._cmp(l.data, r.data)
        return DeviceColumn(T.BOOLEAN, validity, data=data)

    def _cmp(self, a, b):
        raise NotImplementedError

    def _from_lt_eq(self, lt, eq):
        raise NotImplementedError


class EqualTo(BinaryComparison):
    symbol = "="

    def _cmp(self, a, b):
        return a == b

    def _from_lt_eq(self, lt, eq):
        return eq


class LessThan(BinaryComparison):
    symbol = "<"

    def _cmp(self, a, b):
        return a < b

    def _from_lt_eq(self, lt, eq):
        return lt


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _cmp(self, a, b):
        return a <= b

    def _from_lt_eq(self, lt, eq):
        return lt | eq


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _cmp(self, a, b):
        return a > b

    def _from_lt_eq(self, lt, eq):
        return ~(lt | eq)


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _cmp(self, a, b):
        return a >= b

    def _from_lt_eq(self, lt, eq):
        return ~lt


class EqualNullSafe(BinaryComparison):
    """<=> : null <=> null is true; never returns null."""

    symbol = "<=>"

    def _resolve_type(self):
        super()._resolve_type()
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        if l.is_string:
            _, eq = string_compare(l, r)
        elif l.is_dec128:
            eq = (l.data == r.data).all(dim=-1)
        else:
            eq = l.data == r.data
        data = (l.validity & r.validity & eq) | (~l.validity & ~r.validity)
        return DeviceColumn(T.BOOLEAN, torch.ones_like(data), data=data)


class And(BinaryExpression):
    """Three-valued AND: false AND null = false."""

    def sql_string(self):
        return f"({self.left.sql_string()} AND {self.right.sql_string()})"

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = self.left.nullable or self.right.nullable

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        lv, rv = l.validity, r.validity
        definite_false = (lv & ~l.data) | (rv & ~r.data)
        data = (l.data & lv) & (r.data & rv)
        validity = (lv & rv) | definite_false
        return DeviceColumn(T.BOOLEAN, validity, data=data & ~definite_false)


class Or(BinaryExpression):
    """Three-valued OR: true OR null = true."""

    def sql_string(self):
        return f"({self.left.sql_string()} OR {self.right.sql_string()})"

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = self.left.nullable or self.right.nullable

    def do_columnar_eval(self, ctx, cols):
        l, r = cols
        lv, rv = l.validity, r.validity
        definite_true = (lv & l.data) | (rv & r.data)
        validity = (lv & rv) | definite_true
        data = definite_true | ((l.data & lv) | (r.data & rv))
        return DeviceColumn(T.BOOLEAN, validity, data=data)


class Not(UnaryExpression):
    def sql_string(self):
        return f"(NOT {self.child.sql_string()})"

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.BOOLEAN, c.validity, data=~c.data)


class IsNull(UnaryExpression):
    def sql_string(self):
        return f"({self.child.sql_string()} IS NULL)"

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.BOOLEAN, torch.ones_like(c.validity),
                            data=~c.validity)


class IsNotNull(UnaryExpression):
    def sql_string(self):
        return f"({self.child.sql_string()} IS NOT NULL)"

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.BOOLEAN, torch.ones_like(c.validity),
                            data=c.validity)


class IsNaN(UnaryExpression):
    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        data = torch.isnan(c.data) & c.validity
        return DeviceColumn(T.BOOLEAN, torch.ones_like(c.validity),
                            data=data)


class In(Expression):
    """value IN (list of literals), with Spark's null semantics: null when
    the value is null, or when nothing matches and the list holds a
    null."""

    def __init__(self, value: Expression, candidates: List[Expression]):
        super().__init__([value] + list(candidates))

    def sql_string(self):
        cands = ", ".join(c.sql_string() for c in self.children[1:])
        return f"({self.children[0].sql_string()} IN ({cands}))"

    def _resolve_type(self):
        # every candidate is coerced to a type comparable with the value
        # (Spark's ImplicitTypeCasts); a value-side promotion made by a
        # later candidate is applied to the earlier ones again
        value = self.children[0]
        cands = []
        for c in self.children[1:]:
            if _is_null_literal(c):
                cands.append(c)
                continue
            value, c2 = _coerce_comparison(value, c)
            cands.append(c2)
        final = [c if _is_null_literal(c) or c.dataType == value.dataType
                 else _coerce_comparison(value, c)[1] for c in cands]
        self.children = [value] + final
        self._dataType = T.BOOLEAN
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        v = cols[0]
        any_match = torch.zeros(v.capacity, dtype=torch.bool,
                                device=v.device)
        # a candidate's null-ness is a plan-time fact (they are literals)
        null_cand = any(_is_null_literal(c) for c in self.children[1:])
        for expr, c in zip(self.children[1:], cols[1:]):
            if _is_null_literal(expr):
                continue
            if v.is_string:
                _, eq = string_compare(v, c)
            elif v.is_dec128:
                eq = (v.data == c.data).all(dim=-1)
            else:
                eq = v.data == c.data
            any_match = any_match | (eq & c.validity)
        validity = v.validity & any_match if null_cand else v.validity
        return DeviceColumn(T.BOOLEAN, validity, data=any_match)


def _is_null_literal(e: Expression) -> bool:
    from spark_rapids_tpu_torch.expr.base import Literal

    return isinstance(e, Literal) and e.value is None

"""Conditional and null expressions — port of ``If``, ``CaseWhen``,
``Coalesce`` and ``Nvl`` from ``spark_rapids_tpu/expr/conditional.py``,
with the helpers they use (``select_column``, ``_common_type``), over
flat and string columns.

Like the reference, every branch is computed over every row and a
``torch.where`` picks one: there is no lazy side evaluation.  A null
condition takes the else branch.  String branches meet at the wider
width.  ``NaNvl``, ``Greatest``/``Least`` (NaN the greatest value, as in
Spark's ordering; strings by their bytes; decimals above 18 digits by
their limbs), ``Nvl2`` and ``NullIf`` as the reference has them.
"""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression


def select_column(pred, pred_valid, a: DeviceColumn, b: DeviceColumn,
                  dtype: T.DataType) -> DeviceColumn:
    """where(pred, a, b); a null ``pred`` takes ``b``."""
    take_a = pred & pred_valid
    validity = torch.where(take_a, a.validity, b.validity)
    if a.is_string:
        w = max(a.width, b.width)
        return DeviceColumn(dtype, validity, chars=torch.where(
            take_a[:, None], a.with_width(w).chars, b.with_width(w).chars),
            lengths=torch.where(take_a, a.lengths, b.lengths))
    pick = take_a[:, None] if a.data.dim() == 2 else take_a
    return DeviceColumn(dtype, validity, data=torch.where(pick, a.data,
                                                          b.data))


def _common_type(ts: List[T.DataType]) -> T.DataType:
    out = ts[0]
    for t in ts[1:]:
        if t == out or isinstance(t, T.NullType):
            continue
        if isinstance(out, T.NullType):
            out = t
        elif out.is_numeric and t.is_numeric and not (
                isinstance(out, T.DecimalType)
                or isinstance(t, T.DecimalType)):
            out = T.numeric_promote(out, t)
        elif isinstance(out, T.DecimalType) and isinstance(t, T.DecimalType):
            s = max(out.scale, t.scale)
            p = max(out.precision - out.scale, t.precision - t.scale) + s
            out = T.DecimalType(min(p, 38), s)
        else:
            raise TypeError(f"no common type for {out} and {t}")
    return out


class If(Expression):
    def __init__(self, pred: Expression, left: Expression,
                 right: Expression):
        super().__init__([pred, left, right])

    def sql_string(self):
        p, l, r = (c.sql_string() for c in self.children)
        return f"if({p}, {l}, {r})"

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        common = _common_type([self.children[1].dataType,
                               self.children[2].dataType])
        for i in (1, 2):
            if self.children[i].dataType != common:
                self.children[i] = Cast(self.children[i],
                                        common).resolve(None)
        self._dataType = common
        self._nullable = any(c.nullable for c in self.children)

    def do_columnar_eval(self, ctx: EvalContext, cols):
        p, a, b = cols
        return select_column(p.data, p.validity, a, b, self.dataType)


class CaseWhen(Expression):
    """CASE WHEN c1 THEN v1 [WHEN c2 THEN v2]... [ELSE e] END;
    ``children`` are ``[c1, v1, c2, v2, ..., (e)]``."""

    def __init__(self, branches, else_value=None):
        kids: List[Expression] = []
        for c, v in branches:
            kids.extend([c, v])
        self.has_else = else_value is not None
        if else_value is not None:
            kids.append(else_value)
        super().__init__(kids)

    @property
    def _n_branches(self) -> int:
        return (len(self.children) - (1 if self.has_else else 0)) // 2

    def sql_string(self):
        parts = [f"WHEN {self.children[2 * i].sql_string()} "
                 f"THEN {self.children[2 * i + 1].sql_string()}"
                 for i in range(self._n_branches)]
        if self.has_else:
            parts.append(f"ELSE {self.children[-1].sql_string()}")
        return "CASE " + " ".join(parts) + " END"

    def _value_children_idx(self) -> List[int]:
        idx = [2 * i + 1 for i in range(self._n_branches)]
        if self.has_else:
            idx.append(len(self.children) - 1)
        return idx

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        vidx = self._value_children_idx()
        common = _common_type([self.children[i].dataType for i in vidx])
        for i in vidx:
            if self.children[i].dataType != common:
                self.children[i] = Cast(self.children[i],
                                        common).resolve(None)
        self._dataType = common
        self._nullable = True

    def do_columnar_eval(self, ctx: EvalContext, cols):
        if self.has_else:
            acc = cols[-1]
        else:
            from spark_rapids_tpu_torch.expr.base import Literal

            acc = Literal(None, self.dataType).eval_tpu(ctx)
        # from the last branch back, so an earlier WHEN wins
        for i in reversed(range(self._n_branches)):
            cond, val = cols[2 * i], cols[2 * i + 1]
            acc = select_column(cond.data, cond.validity, val, acc,
                                self.dataType)
        return acc


class Coalesce(Expression):
    """The first non-null child, every child cast to their common type."""

    def __init__(self, children: List[Expression]):
        super().__init__(children)

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        common = _common_type([c.dataType for c in self.children])
        self.children = [c if c.dataType == common
                         else Cast(c, common).resolve(None)
                         for c in self.children]
        self._dataType = common
        self._nullable = all(c.nullable for c in self.children)

    def do_columnar_eval(self, ctx: EvalContext, cols):
        acc = cols[-1]
        for c in reversed(cols[:-1]):
            acc = select_column(c.validity, torch.ones_like(c.validity), c,
                                acc, self.dataType)
        return acc


class Nvl(Coalesce):
    def __init__(self, a: Expression, b: Expression):
        super().__init__([a, b])


class NaNvl(Expression):
    """nanvl(a, b): a unless a is NaN."""

    def __init__(self, a: Expression, b: Expression):
        super().__init__([a, b])

    def _resolve_type(self):
        self._dataType = self.children[0].dataType
        self._nullable = any(c.nullable for c in self.children)

    def do_columnar_eval(self, ctx, cols):
        a, b = cols
        is_nan = torch.isnan(a.data) & a.validity
        return select_column(~is_nan, torch.ones_like(is_nan), a, b,
                             self.dataType)


class Greatest(Expression):
    """Skips nulls (null only if every child is null); NaN is the
    greatest value."""

    def __init__(self, children):
        super().__init__(children)

    def _resolve_type(self):
        from spark_rapids_tpu_torch.expr.cast import Cast

        common = _common_type([c.dataType for c in self.children])
        self.children = [c if c.dataType == common
                         else Cast(c, common).resolve(None)
                         for c in self.children]
        self._dataType = common
        self._nullable = all(c.nullable for c in self.children)

    def _b_wins(self, a: DeviceColumn, b: DeviceColumn):
        """Rows where ``b`` is greater than ``a``."""
        if a.is_string:
            from spark_rapids_tpu_torch.expr.predicates import string_compare

            return string_compare(a, b)[0]
        if a.is_dec128:
            from spark_rapids_tpu_torch.expr import decimal128 as D

            return D.lt128(*D.unpack(a.data), *D.unpack(b.data))
        if a.data.dtype.is_floating_point:
            # NaN wins (torch.maximum propagates NaN, as jnp.maximum)
            return torch.isnan(b.data) | (a.data < b.data)
        return a.data < b.data

    def do_columnar_eval(self, ctx, cols):
        acc = cols[0]
        for c in cols[1:]:
            take = ~acc.validity | (c.validity & self._b_wins(acc, c))
            acc = select_column(take, torch.ones_like(take), c, acc,
                                self.dataType)
        return acc


class Least(Greatest):
    """Skips nulls; ignores NaN (NaN is the greatest value)."""

    def _b_wins(self, a, b):
        if a.is_string:
            from spark_rapids_tpu_torch.expr.predicates import string_compare

            lt, eq = string_compare(a, b)
            return ~lt & ~eq
        if a.is_dec128:
            from spark_rapids_tpu_torch.expr import decimal128 as D

            return D.lt128(*D.unpack(b.data), *D.unpack(a.data))
        if a.data.dtype.is_floating_point:
            return torch.isnan(a.data) & ~torch.isnan(b.data) | (
                b.data < a.data)
        return b.data < a.data


class Nvl2(Expression):
    """nvl2(a, b, c): b when a is not null, else c."""

    def __init__(self, a: Expression, b: Expression, c: Expression):
        super().__init__([a, b, c])

    def _resolve_type(self):
        self._dataType = self.children[1].dataType
        self._nullable = (self.children[1].nullable
                          or self.children[2].nullable)

    def do_columnar_eval(self, ctx, cols):
        a, b, c = cols
        return select_column(a.validity, torch.ones_like(a.validity), b, c,
                             self.dataType)


class NullIf(Expression):
    """nullif(a, b): null when a == b, else a."""

    def __init__(self, a: Expression, b: Expression):
        super().__init__([a, b])

    def _resolve_type(self):
        self._dataType = self.children[0].dataType
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        from spark_rapids_tpu_torch.expr.predicates import EqualTo

        a, b = cols
        eq = EqualTo(self.children[0], self.children[1])
        eq._dataType = T.BOOLEAN
        eq.resolved = True
        eqc = eq.do_columnar_eval(ctx, [a, b])
        return DeviceColumn(self.dataType, a.validity & ~(eqc.data
                                                          & eqc.validity),
                            data=a.data, chars=a.chars, lengths=a.lengths)

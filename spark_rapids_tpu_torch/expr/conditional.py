"""Null expressions — port of ``Coalesce`` and ``Nvl`` from
``spark_rapids_tpu/expr/conditional.py``, with the helpers they use
(``select_column``, ``_common_type``).

Like the reference, both sides are computed over every row and a
``torch.where`` picks one: there is no lazy side evaluation.  ``If``,
``CaseWhen``, ``NaNvl``, ``Greatest``/``Least``, ``Nvl2`` and ``NullIf``
are not ported yet; a plan can only name the expressions above.
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

"""Struct expressions over struct columns — port of
``spark_rapids_tpu/expr/complextypes.py``.

A struct column is a validity vector over one child column per field
(``columnar/column.py``), so extracting a field picks a child and creating
a struct bundles columns: neither copies data.
"""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import Expression, UnaryExpression


class GetStructField(UnaryExpression):
    """struct.field — the child column, its validity AND'd with the
    struct's (a null struct reads as a null field)."""

    def __init__(self, child: Expression, name: str):
        super().__init__(child)
        self.field_name = name

    def sql_string(self):
        return f"{self.child.sql_string()}.{self.field_name}"

    def _resolve_type(self):
        st = self.child.dataType
        if not isinstance(st, T.StructType):
            raise TypeError(f"GetStructField on {st.simpleString}")
        matches = [f for f in st.fields if f.name == self.field_name]
        if not matches:
            raise KeyError(
                f"no field '{self.field_name}' in {st.simpleString}")
        self._field_ordinal = st.fields.index(matches[0])
        self._dataType = matches[0].dataType
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        kid = c.children[self._field_ordinal]
        return DeviceColumn(kid.dtype, kid.validity & c.validity,
                            data=kid.data, children=kid.children)


class CreateNamedStruct(Expression):
    """named_struct('a', x, 'b', y) — the columns bundled into a struct
    that is never null."""

    def __init__(self, names: List[str], values: List[Expression]):
        super().__init__(values)
        self.field_names = list(names)

    def sql_string(self):
        parts = ", ".join(f"'{n}', {v.sql_string()}"
                          for n, v in zip(self.field_names, self.children))
        return f"named_struct({parts})"

    def _resolve_type(self):
        self._dataType = T.StructType(
            [T.StructField(n, c.dataType, c.nullable)
             for n, c in zip(self.field_names, self.children)])
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        validity = torch.ones(ctx.batch.capacity, dtype=torch.bool,
                              device=ctx.batch.device)
        return DeviceColumn(self.dataType, validity, children=list(cols))

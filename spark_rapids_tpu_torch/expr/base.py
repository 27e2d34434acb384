"""Expression tree core — port of ``spark_rapids_tpu/expr/base.py``.

Every expression knows its resolved ``dataType`` and ``nullable`` and
evaluates over a batch with ``eval_tpu(ctx) -> DeviceColumn`` (the
reference's name, kept so a reader finds each counterpart).  Evaluation is
plain torch tensor code on the batch's device: no host syncs and no
data-dependent Python control flow.

Spark null semantics: unless an expression overrides evaluation, output
validity is the AND of the input validities.  And/Or/IsNull override it.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from decimal import Decimal as _Dec
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.perfcounters import sync_get


class SparkArithmeticException(Exception):
    """ANSI-mode overflow / invalid operation (matches Spark's error class)."""


@dataclasses.dataclass
class EvalContext:
    """Per-batch evaluation context threaded through ``eval_tpu``.

    Device ops cannot raise, so ANSI violations record per-row flags here;
    ``check_errors`` reads them all back in one host sync per batch."""

    batch: ColumnarBatch
    ansi: bool = False
    error_flags: List = dataclasses.field(default_factory=list)

    @property
    def row_mask(self) -> torch.Tensor:
        return self.batch.row_mask

    def add_error(self, flag_per_row: torch.Tensor, message: str):
        self.error_flags.append((flag_per_row & self.row_mask, message))

    def check_errors(self):
        if not self.error_flags:
            return
        anys = sync_get(torch.stack([f.any() for f, _ in self.error_flags]))
        for hit, (_, message) in zip(anys[0], self.error_flags):
            if hit:
                raise SparkArithmeticException(message)
        self.error_flags.clear()


class Expression:
    """Base expression; subclasses set children and implement
    ``do_columnar_eval``."""

    def __init__(self, children: Sequence["Expression"] = ()):
        self.children: List[Expression] = list(children)
        self._dataType: Optional[T.DataType] = None
        self._nullable: bool = True
        self.resolved: bool = False

    @property
    def pretty_name(self) -> str:
        return type(self).__name__

    @property
    def name(self) -> str:
        return self.sql_string()

    def sql_string(self) -> str:
        args = ", ".join(c.sql_string() for c in self.children)
        return f"{self.pretty_name.lower()}({args})"

    @property
    def dataType(self) -> T.DataType:
        if self._dataType is None:
            raise ValueError(f"{self} not resolved")
        return self._dataType

    @property
    def nullable(self) -> bool:
        return self._nullable

    def resolve(self, schema: T.StructType) -> "Expression":
        """Bind attribute references and compute output types, bottom-up."""
        self.children = [c.resolve(schema) for c in self.children]
        self._resolve_type()
        self.resolved = True
        return self

    def _resolve_type(self):
        raise NotImplementedError(type(self).__name__)

    def eval_tpu(self, ctx: EvalContext) -> DeviceColumn:
        cols = [c.eval_tpu(ctx) for c in self.children]
        return self.do_columnar_eval(ctx, cols)

    def do_columnar_eval(self, ctx: EvalContext,
                         cols: List[DeviceColumn]) -> DeviceColumn:
        raise NotImplementedError(type(self).__name__)

    def __repr__(self):
        return self.sql_string()

    # -- operator sugar for the DataFrame API -------------------------------
    def _bin(self, other, cls):
        return cls(self, _wrap(other))

    def __add__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Add
        return self._bin(o, Add)

    def __sub__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Subtract
        return self._bin(o, Subtract)

    def __mul__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Multiply
        return self._bin(o, Multiply)

    def __truediv__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Divide
        return self._bin(o, Divide)

    def __mod__(self, o):
        from spark_rapids_tpu_torch.expr.arithmetic import Remainder
        return self._bin(o, Remainder)

    def __neg__(self):
        from spark_rapids_tpu_torch.expr.arithmetic import UnaryMinus
        return UnaryMinus(self)

    def __lt__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import LessThan
        return self._bin(o, LessThan)

    def __le__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import LessThanOrEqual
        return self._bin(o, LessThanOrEqual)

    def __gt__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import GreaterThan
        return self._bin(o, GreaterThan)

    def __ge__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import GreaterThanOrEqual
        return self._bin(o, GreaterThanOrEqual)

    def eq(self, o):
        from spark_rapids_tpu_torch.expr.predicates import EqualTo
        return self._bin(o, EqualTo)

    def __and__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import And
        return self._bin(o, And)

    def __or__(self, o):
        from spark_rapids_tpu_torch.expr.predicates import Or
        return self._bin(o, Or)

    def __invert__(self):
        from spark_rapids_tpu_torch.expr.predicates import Not
        return Not(self)

    def is_null(self):
        from spark_rapids_tpu_torch.expr.predicates import IsNull
        return IsNull(self)

    def is_not_null(self):
        from spark_rapids_tpu_torch.expr.predicates import IsNotNull
        return IsNotNull(self)

    def cast(self, dt: T.DataType):
        from spark_rapids_tpu_torch.expr.cast import Cast
        return Cast(self, dt)

    def alias(self, name: str):
        return Alias(self, name)

    def isin(self, *values):
        from spark_rapids_tpu_torch.expr.predicates import In
        return In(self, [lit(v) for v in values])

    def substr(self, pos, length):
        from spark_rapids_tpu_torch.expr.strings import Substring
        return Substring(self, _wrap(pos), _wrap(length))


def _wrap(v) -> Expression:
    return v if isinstance(v, Expression) else Literal.of(v)


class AttributeReference(Expression):
    """Unresolved column-by-name; resolve() binds it to an ordinal."""

    def __init__(self, colname: str):
        super().__init__()
        self.colname = colname

    def sql_string(self):
        return self.colname

    def resolve(self, schema: T.StructType) -> Expression:
        names = schema.field_names()
        matches = [i for i, n in enumerate(names) if n == self.colname]
        if not matches:
            matches = [i for i, n in enumerate(names)
                       if n.lower() == self.colname.lower()]
        if len(matches) != 1:
            raise KeyError(
                f"cannot resolve column '{self.colname}' in {names}")
        i = matches[0]
        return BoundReference(i, schema.fields[i].dataType,
                              schema.fields[i].nullable, name=self.colname)


class BoundReference(Expression):
    def __init__(self, ordinal: int, dtype: T.DataType, nullable: bool = True,
                 name: Optional[str] = None):
        super().__init__()
        self.ordinal = ordinal
        self._dataType = dtype
        self._nullable = nullable
        self._name = name
        self.resolved = True

    def sql_string(self):
        return self._name or f"input[{self.ordinal}]"

    def resolve(self, schema):
        return self

    def eval_tpu(self, ctx: EvalContext) -> DeviceColumn:
        return ctx.batch.columns[self.ordinal]


class Literal(Expression):
    def __init__(self, value: Any, dtype: T.DataType):
        super().__init__()
        self.value = value
        self._dataType = dtype
        self._nullable = value is None
        self.resolved = True

    @staticmethod
    def of(v) -> "Literal":
        if v is None:
            return Literal(None, T.NULL)
        if isinstance(v, bool):
            return Literal(v, T.BOOLEAN)
        if isinstance(v, int):
            return Literal(v, T.INT if -(2**31) <= v < 2**31 else T.LONG)
        if isinstance(v, float):
            return Literal(v, T.DOUBLE)
        if isinstance(v, str):
            return Literal(v, T.STRING)
        if isinstance(v, _Dec):
            sign, digits, exp = v.as_tuple()
            scale = max(0, -exp)
            precision = max(len(digits), scale + 1)
            return Literal(v, T.DecimalType(min(precision, 38), scale))
        if isinstance(v, _dt.datetime):
            from spark_rapids_tpu_torch.columnar.column import micros_of

            return Literal(micros_of(v), T.TIMESTAMP)
        if isinstance(v, _dt.date):
            return Literal((v - _dt.date(1970, 1, 1)).days, T.DATE)
        raise TypeError(f"cannot make literal from {type(v)}")

    def sql_string(self):
        return repr(self.value)

    def resolve(self, schema):
        return self

    def storage_value(self):
        """Value in storage representation (decimal -> unscaled int)."""
        v = self.value
        if isinstance(self._dataType, T.DecimalType) and isinstance(v, _Dec):
            return int(v.scaleb(self._dataType.scale).to_integral_value())
        return v

    def eval_tpu(self, ctx: EvalContext) -> DeviceColumn:
        """A literal column is one stored value broadcast (``expand``, no
        copy) over the batch's rows; a string's chars are one row of its
        UTF-8 bytes (a null string one zero row of 8)."""
        from spark_rapids_tpu_torch.expr.decimal128 import limbs_of

        cap, dev = ctx.batch.capacity, ctx.batch.device
        dt = self._dataType
        valid = torch.tensor(self.value is not None, device=dev).expand(cap)
        if isinstance(dt, T.StringType):
            b = b"" if self.value is None else self.value.encode("utf-8")
            row = np.zeros(8 if self.value is None else max(len(b), 1),
                           np.uint8)
            row[:len(b)] = np.frombuffer(b, np.uint8)
            return DeviceColumn(dt, valid, chars=torch.from_numpy(row).to(
                dev).expand(cap, len(row)), lengths=torch.tensor(
                len(b), dtype=torch.int32, device=dev).expand(cap))
        if isinstance(dt, T.DecimalType) and dt.is_128:
            limbs = limbs_of(int(self.storage_value())) \
                if self.value is not None else (0, 0)
            data = torch.tensor(limbs, dtype=torch.int64,
                                device=dev).expand(cap, 2)
            return DeviceColumn(dt, valid, data=data)
        tdt = torch.int32 if isinstance(dt, T.NullType) \
            else column_torch_dtype(dt)
        v = self.storage_value() if self.value is not None else 0
        return DeviceColumn(dt, valid, data=torch.tensor(
            v, dtype=tdt, device=dev).expand(cap))


class Alias(Expression):
    def __init__(self, child: Expression, alias_name: str):
        super().__init__([child])
        self.alias_name = alias_name

    def sql_string(self):
        return f"{self.children[0].sql_string()} AS {self.alias_name}"

    @property
    def name(self):
        return self.alias_name

    def _resolve_type(self):
        self._dataType = self.children[0].dataType
        self._nullable = self.children[0].nullable

    def eval_tpu(self, ctx):
        return self.children[0].eval_tpu(ctx)


def col(name: str) -> AttributeReference:
    return AttributeReference(name)


def lit(v) -> Literal:
    return Literal.of(v)


class UnaryExpression(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def child(self):
        return self.children[0]


class BinaryExpression(Expression):
    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

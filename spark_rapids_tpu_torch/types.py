"""Spark SQL type system — the port's own copy of ``spark_rapids_tpu/types.py``.

The port never imports the JAX package (its ``__init__`` imports jax), so it
keeps this numpy-only module verbatim.  ``storage_dtype`` and
``DecimalType.is_128`` must agree with the reference for every type; the
port's tests check that.  Each column maps a Spark SQL type onto a storage
dtype (torch tensors use the same dtypes):

  BooleanType    -> bool_
  ByteType       -> int8       ShortType -> int16
  IntegerType    -> int32      LongType  -> int64
  FloatType      -> float32    DoubleType-> float64
  DateType       -> int32 (days since epoch, Spark-compatible)
  TimestampType  -> int64 (microseconds since epoch, UTC)
  DecimalType    -> int64 unscaled value for precision<=18;
                    precision>18 (decimal128) stored as two int64 limbs.
  NullType       -> all-null marker column
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class DataType:
    """Base of the Spark-style SQL type lattice."""

    #: class-level simple name, e.g. "int"
    simpleString: str = "?"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self))

    def __repr__(self):
        return self.simpleString

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, NumericType)

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)

    @property
    def is_floating(self) -> bool:
        return isinstance(self, FractionalType) and not isinstance(self, DecimalType)

    def default_size(self) -> int:
        return 8


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    simpleString = "boolean"

    def default_size(self):
        return 1


class ByteType(IntegralType):
    simpleString = "tinyint"

    def default_size(self):
        return 1


class ShortType(IntegralType):
    simpleString = "smallint"

    def default_size(self):
        return 2


class IntegerType(IntegralType):
    simpleString = "int"

    def default_size(self):
        return 4


class LongType(IntegralType):
    simpleString = "bigint"

    def default_size(self):
        return 8


class FloatType(FractionalType):
    simpleString = "float"

    def default_size(self):
        return 4


class DoubleType(FractionalType):
    simpleString = "double"

    def default_size(self):
        return 8


class StringType(DataType):
    simpleString = "string"

    def default_size(self):
        return 20


class BinaryType(DataType):
    simpleString = "binary"

    def default_size(self):
        return 20


class DateType(DataType):
    simpleString = "date"

    def default_size(self):
        return 4


class TimestampType(DataType):
    simpleString = "timestamp"

    def default_size(self):
        return 8


class NullType(DataType):
    simpleString = "void"

    def default_size(self):
        return 1


class DecimalType(FractionalType):
    """Spark decimal(precision, scale); stored as unscaled integer.

    Reference analog: GpuDecimalMultiply / decimal_utils.cu operate on
    32/64/128-bit unscaled representations chosen by precision; we do the
    same (SURVEY.md §2.5 Arithmetic/decimal row).
    """

    MAX_INT_DIGITS = 9          # fits int32
    MAX_LONG_DIGITS = 18        # fits int64
    MAX_PRECISION = 38

    def __init__(self, precision: int = 10, scale: int = 0):
        if not (0 < precision <= self.MAX_PRECISION):
            raise ValueError(f"precision {precision} out of range")
        if not (0 <= scale <= precision):
            raise ValueError(f"scale {scale} out of range for precision {precision}")
        self.precision = precision
        self.scale = scale

    @property
    def simpleString(self):  # type: ignore[override]
        return f"decimal({self.precision},{self.scale})"

    def __eq__(self, other):
        return (
            isinstance(other, DecimalType)
            and other.precision == self.precision
            and other.scale == self.scale
        )

    def __hash__(self):
        return hash((DecimalType, self.precision, self.scale))

    def default_size(self):
        return 8 if self.precision <= self.MAX_LONG_DIGITS else 16

    @property
    def is_128(self) -> bool:
        return self.precision > self.MAX_LONG_DIGITS


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    dataType: DataType
    nullable: bool = True


class StructType(DataType):
    def __init__(self, fields):
        self.fields = list(fields)

    @property
    def simpleString(self):  # type: ignore[override]
        inner = ",".join(f"{f.name}:{f.dataType.simpleString}" for f in self.fields)
        return f"struct<{inner}>"

    def __eq__(self, other):
        return isinstance(other, StructType) and other.fields == self.fields

    def __hash__(self):
        return hash((StructType, tuple(self.fields)))

    def field_names(self):
        return [f.name for f in self.fields]

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)


class ArrayType(DataType):
    def __init__(self, elementType: DataType, containsNull: bool = True):
        self.elementType = elementType
        self.containsNull = containsNull

    @property
    def simpleString(self):  # type: ignore[override]
        return f"array<{self.elementType.simpleString}>"

    def __eq__(self, other):
        return (
            isinstance(other, ArrayType)
            and other.elementType == self.elementType
            and other.containsNull == self.containsNull
        )

    def __hash__(self):
        return hash((ArrayType, self.elementType, self.containsNull))


class MapType(DataType):
    def __init__(self, keyType: DataType, valueType: DataType,
                 valueContainsNull: bool = True):
        self.keyType = keyType
        self.valueType = valueType
        self.valueContainsNull = valueContainsNull

    @property
    def simpleString(self):  # type: ignore[override]
        return f"map<{self.keyType.simpleString},{self.valueType.simpleString}>"

    def __eq__(self, other):
        return (
            isinstance(other, MapType)
            and other.keyType == self.keyType
            and other.valueType == self.valueType
        )

    def __hash__(self):
        return hash((MapType, self.keyType, self.valueType))


# Singletons, Spark-style.
BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
STRING = StringType()
BINARY = BinaryType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()

_NUMPY_STORAGE = {
    BooleanType: np.bool_,
    ByteType: np.int8,
    ShortType: np.int16,
    IntegerType: np.int32,
    LongType: np.int64,
    FloatType: np.float32,
    DoubleType: np.float64,
    DateType: np.int32,
    TimestampType: np.int64,
}


def storage_dtype(dt: DataType) -> np.dtype:
    """numpy/jnp storage dtype for a (non-string) SQL type."""
    if isinstance(dt, DecimalType):
        return np.dtype(np.int64)  # <=18 digits; 128-bit handled as limb pairs
    t = _NUMPY_STORAGE.get(type(dt))
    if t is None:
        raise TypeError(f"no flat storage dtype for {dt}")
    return np.dtype(t)


_PROMOTE_ORDER = [ByteType, ShortType, IntegerType, LongType, FloatType, DoubleType]


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's findTightestCommonType for flat numeric types."""
    if a == b:
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        raise TypeError("decimal promotion handled by DecimalPrecision rules")
    ia = _PROMOTE_ORDER.index(type(a))
    ib = _PROMOTE_ORDER.index(type(b))
    return _PROMOTE_ORDER[max(ia, ib)]()


# ---------------------------------------------------------------------------
# TypeSig — which SQL types a rule supports (reference: TypeSig.scala).
# ---------------------------------------------------------------------------

class TypeSig:
    """A set of supported type *kinds*, with optional notes.

    The reference encodes this as a bitmask + per-type notes and uses it both
    for plan tagging and for the generated supported_ops.md docs; we keep the
    same shape so the docs generator (docs/gen_supported_ops.py) can walk it.
    """

    def __init__(self, kinds: frozenset, max_decimal_precision: int = DecimalType.MAX_PRECISION,
                 notes: Optional[dict] = None):
        self.kinds = frozenset(kinds)
        self.max_decimal_precision = max_decimal_precision
        self.notes = dict(notes or {})

    @staticmethod
    def none() -> "TypeSig":
        return TypeSig(frozenset())

    def __add__(self, other: "TypeSig") -> "TypeSig":
        notes = dict(self.notes)
        notes.update(other.notes)
        return TypeSig(self.kinds | other.kinds,
                       max(self.max_decimal_precision, other.max_decimal_precision),
                       notes)

    def with_max_decimal(self, p: int) -> "TypeSig":
        return TypeSig(self.kinds, p, self.notes)

    def with_note(self, kind: type, note: str) -> "TypeSig":
        notes = dict(self.notes)
        notes[kind] = note
        return TypeSig(self.kinds, self.max_decimal_precision, notes)

    def supports(self, dt: DataType) -> bool:
        if isinstance(dt, DecimalType):
            return DecimalType in self.kinds and dt.precision <= self.max_decimal_precision
        if isinstance(dt, StructType):
            return StructType in self.kinds and all(self.supports(f.dataType) for f in dt.fields)
        if isinstance(dt, ArrayType):
            return ArrayType in self.kinds and self.supports(dt.elementType)
        if isinstance(dt, MapType):
            return (MapType in self.kinds and self.supports(dt.keyType)
                    and self.supports(dt.valueType))
        return type(dt) in self.kinds

    def reason_not_supported(self, dt: DataType) -> str:
        note = self.notes.get(type(dt))
        base = f"{dt.simpleString} is not supported"
        return f"{base} ({note})" if note else base


def _sig(*kinds) -> TypeSig:
    return TypeSig(frozenset(kinds))


BOOLEAN_SIG = _sig(BooleanType)
INTEGRAL_SIG = _sig(ByteType, ShortType, IntegerType, LongType)
FP_SIG = _sig(FloatType, DoubleType)
DECIMAL_64_SIG = TypeSig(frozenset({DecimalType}), DecimalType.MAX_LONG_DIGITS)
DECIMAL_128_SIG = TypeSig(frozenset({DecimalType}), DecimalType.MAX_PRECISION)
STRING_SIG = _sig(StringType)
BINARY_SIG = _sig(BinaryType)
DATETIME_SIG = _sig(DateType, TimestampType)
NULL_SIG = _sig(NullType)

numeric = INTEGRAL_SIG + FP_SIG + DECIMAL_64_SIG
integral = INTEGRAL_SIG
gpu_numeric = numeric  # alias kept for parity grep-ability with the reference
commonTypes = BOOLEAN_SIG + numeric + STRING_SIG + DATETIME_SIG
all_basic = commonTypes + NULL_SIG + BINARY_SIG + DECIMAL_128_SIG
nested = _sig(StructType, ArrayType, MapType)
everything = all_basic + nested

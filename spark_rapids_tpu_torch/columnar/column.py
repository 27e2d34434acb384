"""Device/host column vectors — port of ``spark_rapids_tpu/columnar/column.py``.

Flat columns (int, long, date, bool, double, decimal64 and the
decimal128 limbs), string columns, array columns of flat elements and
struct columns, with the reference's value semantics so results compare
bit for bit:

* validity is a bool vector (True = valid);
* decimals of 18 digits or fewer are unscaled int64; above 18 digits a
  ``(n, 2)`` int64 ``[hi, lo]`` limb pair (see ``expr/decimal128.py``);
* DATE is int32 days since the epoch;
* a string is the reference's padded layout: a ``(n, width)`` uint8 char
  matrix (``chars``) plus int32 ``lengths``, bytes past a row's length
  zero, ``data`` None.  A device column's width comes from the
  ladder ``DEFAULT_WIDTH_BUCKETS`` (``round_up_bucket``), the default of
  ``spark.rapids.tpu.string.widthBuckets``, which the reference's layers
  use too;
  a host column's is its longest value.  Columns of different widths
  meet at the wider one (``with_width``) before they are compared or
  stacked.  A null row has length 0;
* an array of flat elements (not decimal128) is the reference's padded
  list layout (kind "array"): ``data`` ``(n, ewidth)`` of the element's
  storage dtype, ``lengths`` ``(n,)`` int32 element counts and
  ``elem_valid`` ``(n, ewidth)`` bool, elements past a row's length zero
  and invalid.  A device column's ``ewidth`` comes from the same ladder
  as a string's width; a host column's is its longest list.  Columns of
  different element widths meet at the wider one (``with_ewidth``).  A
  null list has length 0.  Arrays of strings, of decimal128 or of nested
  values, and maps, are not ported;
* a struct is a validity vector over one full child column per field
  (the reference's kind "struct", as cuDF stores STRUCT columns); its
  ``data`` is None.  A null struct row keeps whatever its children hold.

Every row operation (slice, gather, concat, host transfer, the spill
framework's buffers) works on every buffer of a column in one fixed order
(``tensors``/``rebuild_column``) and recurses into a struct's children.

The reference pads every column to a power-of-two row capacity to bound XLA
recompiles; PyTorch takes sizes at run time, so a port column holds exactly
``num_rows`` rows and ``capacity == num_rows``.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from decimal import Decimal
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.perfcounters import sync_get, to_device

_EPOCH = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


def micros_of(v: _dt.datetime) -> int:
    """A datetime's microseconds since the epoch (a naive one read as
    UTC), exact."""
    if v.tzinfo is None:
        v = v.replace(tzinfo=_dt.timezone.utc)
    return (v - _EPOCH_TS) // _dt.timedelta(microseconds=1)


DEFAULT_WIDTH_BUCKETS = (8, 32, 128, 512, 2048)


def round_up_bucket(n: int) -> int:
    """The smallest bucket holding ``n``; past the ladder the next power
    of two."""
    for b in DEFAULT_WIDTH_BUCKETS:
        if n <= b:
            return b
    p = 1
    while p < n:
        p <<= 1
    return p


def _fit_chars(chars, width: int):
    """A char matrix (or an array's element matrix) cut or zero-padded to
    ``width`` columns (numpy or torch)."""
    w = int(chars.shape[1])
    if w >= width:
        return chars[:, :width]
    if isinstance(chars, np.ndarray):
        return np.pad(chars, ((0, 0), (0, width - w)))
    return torch.nn.functional.pad(chars, (0, width - w))


def torch_dtype(np_dtype) -> torch.dtype:
    """torch dtype for a numpy storage dtype."""
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def column_torch_dtype(dt: T.DataType) -> torch.dtype:
    return torch_dtype(T.storage_dtype(dt))


@dataclasses.dataclass
class DeviceColumn:
    """One column on a torch device.

    data: (n,) tensor of the storage dtype, or (n, 2) int64 [hi, lo] limbs
    for decimal(p>18), or (n, ewidth) elements of an array (with
    ``lengths`` (n,) int32 and ``elem_valid`` (n, ewidth) bool); None for
    a struct, whose ``children`` hold one column per field, and for a
    string, whose ``chars`` (n, width) uint8 and ``lengths`` (n,) int32
    hold it.  validity: (n,) bool, True = valid.
    """

    dtype: T.DataType
    validity: torch.Tensor
    data: Optional[torch.Tensor] = None
    children: Optional[List["DeviceColumn"]] = None
    chars: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None
    elem_valid: Optional[torch.Tensor] = None

    @property
    def is_struct(self) -> bool:
        return self.children is not None

    @property
    def is_string(self) -> bool:
        return self.chars is not None

    @property
    def is_array(self) -> bool:
        return self.elem_valid is not None

    @property
    def ewidth(self) -> int:
        """An array column's element capacity per row (0 otherwise)."""
        return int(self.data.shape[1]) if self.is_array else 0

    def with_ewidth(self, ewidth: int) -> "DeviceColumn":
        """An array column's elements cut or zero-padded to ``ewidth``."""
        if self.ewidth == ewidth:
            return self
        return DeviceColumn(self.dtype, self.validity,
                            data=_fit_chars(self.data, ewidth),
                            lengths=self.lengths,
                            elem_valid=_fit_chars(self.elem_valid, ewidth))

    @property
    def width(self) -> int:
        return int(self.chars.shape[1]) if self.chars is not None else 0

    def with_width(self, width: int) -> "DeviceColumn":
        """A string column's chars cut or zero-padded to ``width``."""
        if self.width == width:
            return self
        return DeviceColumn(self.dtype, self.validity,
                            chars=_fit_chars(self.chars, width),
                            lengths=self.lengths)

    @property
    def is_dec128(self) -> bool:
        return isinstance(self.dtype, T.DecimalType) and self.dtype.is_128

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def nbytes(self) -> int:
        """Bytes of the validity (one a row) and the data (a string's
        chars and lengths), children included."""
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def tensors(self) -> List[torch.Tensor]:
        """Every buffer, depth first: the validity, then the data, a
        string's chars and lengths, an array's data, lengths and element
        validity, or each child's buffers."""
        return _buffers(self)

    def map_rows(self, fn) -> "DeviceColumn":
        """``fn`` (a row slice or gather) applied to every buffer."""
        return rebuild_column(self.dtype, iter([fn(t)
                                                for t in self.tensors()]))

    def gather(self, indices: torch.Tensor) -> "DeviceColumn":
        return self.map_rows(lambda t: t[indices])

    def slice(self, start: int, end: int) -> "DeviceColumn":
        """Rows ``[start, end)`` as views (no copy)."""
        return self.map_rows(lambda t: t[start:end])

    @staticmethod
    def concat(cols: Sequence["DeviceColumn"]) -> "DeviceColumn":
        """Rows of ``cols`` in order; strings at the widest width, arrays
        at the widest element width."""
        cols = _common_width(cols)
        per = [c.tensors() for c in cols]
        return rebuild_column(cols[0].dtype, iter(
            [torch.cat([p[i] for p in per]) for i in range(len(per[0]))]))

    @staticmethod
    def from_host(h: "HostColumn", device) -> "DeviceColumn":
        """Upload; a string's chars and an array's elements widen to
        their bucket first."""
        return rebuild_column(h.dtype, iter([to_device(a, device) for a in
                                             h.bucketed().arrays()]))

    def to_host(self, num_rows: int) -> "HostColumn":
        return rebuild_column(self.dtype, iter(sync_get(
            *[t[:num_rows] for t in self.tensors()])), HostColumn)


def _common_width(cols):
    """String columns at the widest of their widths, array columns at the
    widest of their element widths (others as given)."""
    if cols[0].is_array:
        w = max(c.ewidth for c in cols)
        return [c.with_ewidth(w) for c in cols]
    if not cols[0].is_string:
        return cols
    w = max(c.width for c in cols)
    return [c.with_width(w) for c in cols]


def _buffers(c) -> list:
    """A column's buffers (``DeviceColumn`` or ``HostColumn``) in the one
    order ``rebuild_column`` reads."""
    if c.is_struct:
        return [c.validity] + [t for k in c.children for t in _buffers(k)]
    if c.is_string:
        return [c.validity, c.chars, c.lengths]
    if c.is_array:
        return [c.validity, c.data, c.lengths, c.elem_valid]
    return [c.validity, c.data]


def rebuild_column(dtype: T.DataType, it: Iterator, cls=None):
    """A ``cls`` column (default ``DeviceColumn``) of ``dtype`` from the
    next buffers of ``it``, in ``tensors`` order (its inverse)."""
    cls = cls or DeviceColumn
    validity = next(it)
    if isinstance(dtype, T.StructType):
        kids = [rebuild_column(f.dataType, it, cls) for f in dtype.fields]
        return cls(dtype, validity, children=kids)
    if isinstance(dtype, T.StringType):
        return cls(dtype, validity, chars=next(it), lengths=next(it))
    if isinstance(dtype, T.ArrayType):
        return cls(dtype, validity, data=next(it), lengths=next(it),
                   elem_valid=next(it))
    return cls(dtype, validity, data=next(it))


@dataclasses.dataclass
class HostColumn:
    """Host-side column (numpy), the interchange point with Python; a
    struct holds one child column per field."""

    dtype: T.DataType
    validity: np.ndarray
    data: Optional[np.ndarray] = None
    children: Optional[List["HostColumn"]] = None
    chars: Optional[np.ndarray] = None       # (n, width) uint8
    lengths: Optional[np.ndarray] = None     # (n,) int32
    elem_valid: Optional[np.ndarray] = None  # (n, ewidth) bool (arrays)

    @property
    def is_struct(self) -> bool:
        return self.children is not None

    @property
    def is_string(self) -> bool:
        return self.chars is not None

    @property
    def is_array(self) -> bool:
        return self.elem_valid is not None

    @property
    def ewidth(self) -> int:
        return int(self.data.shape[1]) if self.is_array else 0

    def with_ewidth(self, ewidth: int) -> "HostColumn":
        if self.ewidth == ewidth:
            return self
        return HostColumn(self.dtype, self.validity,
                          data=_fit_chars(self.data, ewidth),
                          lengths=self.lengths,
                          elem_valid=_fit_chars(self.elem_valid, ewidth))

    @property
    def width(self) -> int:
        return int(self.chars.shape[1]) if self.chars is not None else 0

    @property
    def num_rows(self) -> int:
        return int(self.validity.shape[0])

    def arrays(self) -> List[np.ndarray]:
        """Every buffer in ``DeviceColumn.tensors`` order."""
        return _buffers(self)

    def with_width(self, width: int) -> "HostColumn":
        if self.width == width:
            return self
        return HostColumn(self.dtype, self.validity,
                          chars=_fit_chars(self.chars, width),
                          lengths=self.lengths)

    def bucketed(self) -> "HostColumn":
        """The column with every string (struct fields too) at the bucket
        of its longest value, and every array at the bucket of its longest
        list, as they live on the device."""
        if self.is_struct:
            return HostColumn(self.dtype, self.validity, children=[
                c.bucketed() for c in self.children])
        if not (self.is_string or self.is_array):
            return self
        longest = int(self.lengths.max()) if self.num_rows else 0
        w = round_up_bucket(max(longest, 1))
        return self.with_ewidth(w) if self.is_array else self.with_width(w)

    def slice_rows(self, start: int, end: int) -> "HostColumn":
        return rebuild_column(self.dtype, iter([a[start:end]
                                                for a in self.arrays()]),
                              HostColumn)

    @staticmethod
    def concat(cols: Sequence["HostColumn"]) -> "HostColumn":
        cols = _common_width(cols)
        per = [c.arrays() for c in cols]
        return rebuild_column(cols[0].dtype, iter(
            [np.concatenate([p[i] for p in per])
             for i in range(len(per[0]))]), HostColumn)

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: T.DataType,
                   validity: Optional[np.ndarray] = None) -> "HostColumn":
        """A column over ``arr`` in storage form; a string column takes an
        array of ``str`` or ``bytes`` (a null row's value is ignored)."""
        v = validity if validity is not None else np.ones(len(arr), np.bool_)
        if isinstance(dtype, T.StringType):
            return HostColumn.strings(arr, v)
        return HostColumn(dtype, v, data=np.ascontiguousarray(arr))

    @staticmethod
    def strings(values, validity: np.ndarray) -> "HostColumn":
        """A string column of ``values`` (``str``, UTF-8 encoded, or
        ``bytes``) at the width of the longest valid one."""
        validity = np.asarray(validity, np.bool_)
        enc = [b"" if not ok or v is None else
               v.encode("utf-8") if isinstance(v, str) else bytes(v)
               for v, ok in zip(values, validity)]
        lengths = np.fromiter((len(b) for b in enc), np.int32, len(enc))
        width = max(int(lengths.max()) if len(enc) else 0, 1)
        joined = np.frombuffer(b"".join(enc), np.uint8)
        rows = np.repeat(np.arange(len(enc)), lengths)
        starts = np.cumsum(lengths) - lengths
        cols = np.arange(len(joined)) - np.repeat(starts, lengths)
        chars = np.zeros((len(enc), width), np.uint8)
        chars[rows, cols] = joined
        return HostColumn(T.STRING, validity, chars=chars, lengths=lengths)

    @staticmethod
    def from_pylist(values: List, dtype: T.DataType) -> "HostColumn":
        from spark_rapids_tpu_torch.expr.decimal128 import limbs_of

        n = len(values)
        validity = np.array([v is not None for v in values], dtype=np.bool_)
        if isinstance(dtype, T.StringType):
            return HostColumn.strings(values, validity)
        if isinstance(dtype, T.ArrayType):
            return HostColumn._lists(values, validity, dtype)
        if isinstance(dtype, T.StructType):
            # rows are dicts (by field name) or sequences (by position);
            # a null row's children are null (Spark reads null.field as
            # null)
            kids = [HostColumn.from_pylist(
                [None if v is None else v.get(f.name)
                 if isinstance(v, dict) else v[fi] for v in values],
                f.dataType) for fi, f in enumerate(dtype.fields)]
            return HostColumn(dtype, validity, children=kids)
        if isinstance(dtype, T.DecimalType) and dtype.is_128:
            data = np.zeros((n, 2), dtype=np.int64)
            for i, v in enumerate(values):
                if v is not None:
                    d = Decimal(str(v)).scaleb(dtype.scale)
                    data[i] = limbs_of(int(d.to_integral_value()))
            return HostColumn(dtype, validity, data=data)
        data = np.zeros(n, dtype=T.storage_dtype(dtype))
        for i, v in enumerate(values):
            if v is None:
                continue
            if isinstance(dtype, T.DecimalType):
                d = Decimal(str(v)).scaleb(dtype.scale)
                data[i] = int(d.to_integral_value())
            elif isinstance(dtype, T.BooleanType):
                data[i] = bool(v)
            elif isinstance(dtype, T.DateType):
                data[i] = (v - _EPOCH).days if isinstance(v, _dt.date) else v
            elif isinstance(dtype, T.TimestampType):
                data[i] = micros_of(v) if isinstance(v, _dt.datetime) else v
            else:
                data[i] = v
        return HostColumn(dtype, validity, data=data)

    @staticmethod
    def _lists(values: List, validity: np.ndarray,
               dtype: T.ArrayType) -> "HostColumn":
        """An array column of Python lists (a null list ``None``, a null
        element ``None``) at the width of the longest list."""
        et = dtype.elementType
        if isinstance(et, (T.StringType, T.StructType, T.ArrayType,
                           T.MapType)) or (isinstance(et, T.DecimalType)
                                           and et.is_128):
            raise NotImplementedError(
                f"{dtype.simpleString} columns are not ported (flat "
                "elements only)")
        rows = [v if v is not None else [] for v in values]
        lengths = np.fromiter((len(v) for v in rows), np.int32, len(rows))
        elems = HostColumn.from_pylist([e for v in rows for e in v], et)
        width = max(int(lengths.max()) if len(rows) else 0, 1)
        data = np.zeros((len(rows), width), elems.data.dtype)
        ev = np.zeros((len(rows), width), np.bool_)
        take = np.arange(width)[None, :] < lengths[:, None]
        data[take] = elems.data
        ev[take] = elems.validity
        return HostColumn(dtype, validity, data=data, lengths=lengths,
                          elem_valid=ev)

    def to_pylist(self) -> List:
        from spark_rapids_tpu_torch.expr.decimal128 import to_py

        if self.is_array:
            et = self.dtype.elementType
            out = []
            for i in range(self.num_rows):
                if not self.validity[i]:
                    out.append(None)
                    continue
                ln = int(self.lengths[i])
                out.append(HostColumn(et, self.elem_valid[i, :ln],
                                      data=self.data[i, :ln]).to_pylist())
            return out
        if self.is_struct:
            kids = [c.to_pylist() for c in self.children]
            return [tuple(k[i] for k in kids) if self.validity[i] else None
                    for i in range(self.num_rows)]
        out: List = []
        for i in range(self.num_rows):
            if not self.validity[i]:
                out.append(None)
            elif self.is_string:
                out.append(bytes(self.chars[i, :self.lengths[i]]).decode(
                    "utf-8", "replace"))
            elif isinstance(self.dtype, T.DecimalType):
                v = (to_py(int(self.data[i, 0]), int(self.data[i, 1]))
                     if self.dtype.is_128 else int(self.data[i]))
                out.append(Decimal(v).scaleb(-self.dtype.scale))
            elif isinstance(self.dtype, T.BooleanType):
                out.append(bool(self.data[i]))
            elif isinstance(self.dtype, (T.FloatType, T.DoubleType)):
                out.append(float(self.data[i]))
            elif isinstance(self.dtype, T.DateType):
                out.append(_EPOCH + _dt.timedelta(days=int(self.data[i])))
            elif isinstance(self.dtype, T.TimestampType):
                out.append(_EPOCH_TS + _dt.timedelta(
                    microseconds=int(self.data[i])))
            else:
                out.append(int(self.data[i]))
        return out

"""The CPU stage engine — the port's own numpy copy of the part of
``spark_rapids_tpu/cpu/oracle.py`` that a CPU stage of a ported query
needs.

A plan node that the plan rewrite tags as unable to run on the device, by
the reference's own rules (``overrides/meta.py``), stays on the host and
runs here; its device children reach it through ``TpuMaterializedScan``
(``overrides/transitions.py``), and a device parent reads its output
through ``TpuRowToColumnarExec`` (``exec/transitions.py``).

The reference's oracle holds decimals, strings and structs as Python
objects, one per row.  This copy keeps every column in its storage form,
as the host columns hold it (``columnar/column.py``): unscaled int64 or
``[hi, lo]`` limbs for decimals, a zero-padded char matrix and lengths
for strings, one child column per struct field.  Moving a column through
a stage, selecting rows or picking a struct field is then a numpy view or
gather.  Decimal ``+``, ``-``, ``*`` and casts to a decimal run on int64
limbs, with the port's own ``expr/decimal128.py`` functions on CPU
tensors: exact in 128 bits, a result past 10^precision (or past 128 bits)
null, or an error under ANSI, as the reference's Python integers give
them.  A product of two 128-bit operands needs one of them within 64 bits
(``decimal128.mul128_checked``); a larger product is past 38 digits
anyway.  The Python-integer versions stay as the plain twins that the
tests hold the limb path against (``_h_binarith_py``, ``_h_cast_py``);
integer arithmetic and 128-bit comparisons still go through Python
integers.  A subtree without a column reference (the cast of a literal)
is evaluated for one row and broadcast.  So a stage of several decimal
products over tens of millions of rows takes seconds on a few cores,
where Python integers take minutes.

The nodes it runs are ``LocalTableScan``, ``Filter``, ``Project``,
``Union``, ``BroadcastNestedLoopJoin`` (every join type; the tagging
sends it the right and full outer ones), ``HashAggregate`` in each mode,
the ``SortMergeJoin``, ``ShuffledHashJoin`` and ``BroadcastHashJoin`` of
every type, ``Sort``, ``GlobalLimit``/``LocalLimit``, ``Window``, the
exchanges (passed through) and ``TpuMaterializedScan``.  The aggregate
and the window run the device operators' own code (``exec/aggregate.py``
group-by, reduce, merge and finish; ``exec/window.py``) on CPU tensors
over the columns this engine evaluates, the sort the device's key words,
so a CPU stage computes what the card computes; the inputs only a CPU
stage sees take the limb paths there (``avg`` and the variance family
over decimals above 18 digits, percentiles of them, a string's or a
decimal128's min/max over any frame).  A hash join sorts the right
side's keys, finds each left key's run by binary search and evaluates
its residual condition on the expanded pairs in chunks, with Spark's
meaning on every join type: the reference's oracle applies it to inner
joins only (ROADMAP R26).  Not run: a list column (``collect_*``,
``bloom_filter_agg``, a two-phase ``approx_count_distinct``'s registers:
ROADMAP Queue 1 item 5), ``approx_count_distinct`` of a decimal above 18
digits, and the windows the reference names invalid (a ``sum``, ``avg``
or variance of a string, a negative RANGE offset, a RANGE frame over a
string key).  The
expressions, those the port
runs on the card (references, literals, ``Alias``, comparisons, boolean
logic, ``IsNull``/``IsNotNull``, ``In``, ``If``/``CaseWhen``,
``Add``/``Subtract``/``Multiply``, every ``Cast``, ``Coalesce``/``Nvl``,
the date and time functions), the struct expressions and the hash
expressions (their device code; murmur3 and xxhash64 of a decimal above
18 digits are not ported).  Of the date and time shapes the reference's
rules tag off, the engine runs a ``date_format``/``from_unixtime``
pattern of the reference oracle's wider token set on the host, row by
row as that oracle renders it; a zone column by the device's table
search, one distinct zone at a time (an unknown zone raises, as in the
oracle); ``to_date``/``to_timestamp`` with another pattern, and the
string -> timestamp cast while its switch is off, by the device code
(the oracle too reads the default grammar); ``extract(EPOCH ...)`` as
seconds; and ``hive_hash`` of a TIMESTAMP over its low 32 bits, as the
oracle hashes it.  An array column cannot reach a stage.  A string
column passes through references, ``Alias``, ``If``/``CaseWhen``,
``Coalesce``/``Nvl`` and casts, and is read by comparisons (bytes, then
length, as on the card), ``In``, ``IsNull``/``IsNotNull`` and the string
functions and casts.  ``check_cpu_plan`` raises
``NotOnGpu`` at plan time for anything else, naming it.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import complextypes as CT
from spark_rapids_tpu_torch.expr import conditional as CO
from spark_rapids_tpu_torch.expr import datetime as DT
from spark_rapids_tpu_torch.expr import hashexprs as H
from spark_rapids_tpu_torch.expr import mathfuncs as M
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr import strings as S
from spark_rapids_tpu_torch.expr.base import (Alias, BoundReference,
                                              Expression, Literal,
                                              SparkArithmeticException)
from spark_rapids_tpu_torch.expr.cast import _INTEGRAL, Cast, cast_supported
from spark_rapids_tpu_torch.overrides.meta import PORTED_EXPRS
from spark_rapids_tpu_torch.plan import nodes as PN

_U64 = 1 << 64


@dataclasses.dataclass
class CpuCol:
    """One host column in storage form: ``values`` as ``HostColumn.data``
    (None for a struct, whose ``children`` hold its fields, and for a
    string, whose ``chars`` (n, width) uint8 and ``lengths`` int32 hold
    it, as in ``columnar/column.py``) and a bool ``validity``."""

    dtype: T.DataType
    values: Optional[np.ndarray]
    validity: np.ndarray
    children: Optional[List["CpuCol"]] = None
    chars: Optional[np.ndarray] = None
    lengths: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return len(self.validity)

    @property
    def is_string(self) -> bool:
        return self.chars is not None

    @staticmethod
    def from_host(h: HostColumn) -> "CpuCol":
        kids = (None if h.children is None
                else [CpuCol.from_host(c) for c in h.children])
        return CpuCol(h.dtype, h.data, h.validity, kids, h.chars, h.lengths)

    def to_host(self) -> HostColumn:
        kids = (None if self.children is None
                else [c.to_host() for c in self.children])
        return HostColumn(self.dtype, self.validity, data=self.values,
                          children=kids, chars=self.chars,
                          lengths=self.lengths)

    def take(self, rows) -> "CpuCol":
        """The rows ``rows`` (a bool mask or indices) selects."""
        kids = (None if self.children is None
                else [c.take(rows) for c in self.children])
        vals = None if self.values is None else self.values[rows]
        if self.is_string:
            return CpuCol(self.dtype, None, self.validity[rows], None,
                          self.chars[rows], self.lengths[rows])
        return CpuCol(self.dtype, vals, self.validity[rows], kids)

    def with_width(self, width: int) -> "CpuCol":
        """A string column's chars padded (zeros) or cut to ``width``."""
        if not self.is_string or self.chars.shape[1] == width:
            return self
        chars = np.zeros((self.n, width), np.uint8)
        w = min(width, self.chars.shape[1])
        chars[:, :w] = self.chars[:, :w]
        return CpuCol(self.dtype, None, self.validity, None, chars,
                      self.lengths)

    def broadcast(self, n: int) -> "CpuCol":
        """A one-row column as ``n`` equal rows (read-only views)."""
        def b(a):
            return None if a is None else np.broadcast_to(
                a, (n,) + a.shape[1:])
        kids = (None if self.children is None
                else [c.broadcast(n) for c in self.children])
        return CpuCol(self.dtype, b(self.values), b(self.validity), kids,
                      b(self.chars), b(self.lengths))

    def nulls(self, n: int) -> "CpuCol":
        """``n`` null rows of this column's type and layout (zero buffers,
        a string at this column's width)."""
        def z(a):
            return None if a is None else np.zeros((n,) + a.shape[1:],
                                                   a.dtype)
        kids = (None if self.children is None
                else [c.nulls(n) for c in self.children])
        return CpuCol(self.dtype, z(self.values), np.zeros(n, np.bool_),
                      kids, z(self.chars), z(self.lengths))

    @staticmethod
    def concat(cols: List["CpuCol"]) -> "CpuCol":
        first = cols[0]
        if first.is_string:
            w = max(c.chars.shape[1] for c in cols)
            cols = [c.with_width(w) for c in cols]
            return CpuCol(first.dtype, None,
                          np.concatenate([c.validity for c in cols]), None,
                          np.concatenate([c.chars for c in cols]),
                          np.concatenate([c.lengths for c in cols]))
        kids = (None if first.children is None
                else [CpuCol.concat([c.children[i] for c in cols])
                      for i in range(len(first.children))])
        vals = (None if first.values is None
                else np.concatenate([c.values for c in cols]))
        return CpuCol(first.dtype, vals,
                      np.concatenate([c.validity for c in cols]), kids)


CpuBatch = List[CpuCol]


# -- storage <-> Python integers -------------------------------------------

def _is_dec128(dt) -> bool:
    return isinstance(dt, T.DecimalType) and dt.is_128


def _py_ints(c: CpuCol) -> np.ndarray:
    """An object array of Python ints: unscaled decimals, or integers."""
    if _is_dec128(c.dtype):
        hi = c.values[:, 0].astype(object)
        lo = c.values[:, 1].view(np.uint64).astype(object)
        return hi * _U64 + lo
    return c.values.astype(object)


def _from_py_ints(vals: np.ndarray, validity: np.ndarray,
                  dt: T.DataType) -> np.ndarray:
    """Python ints (in range where valid) -> storage values."""
    v = np.where(validity, vals, 0)
    if _is_dec128(dt):
        out = np.empty((len(v), 2), np.int64)
        out[:, 0] = (v // _U64).astype(np.int64)
        out[:, 1] = (v % _U64).astype(np.uint64).view(np.int64)
        return out
    return v.astype(T.storage_dtype(dt))


def _dec_check(vals, validity, dt: T.DecimalType, ansi: bool, op: str):
    """Validity with results past 10^precision nulled (an error under
    ANSI), as the reference's ``_dec_check``."""
    bound = 10 ** dt.precision
    safe = np.where(validity, vals, 0)
    ok = (np.asarray(safe < bound, np.bool_)
          & np.asarray(safe > -bound, np.bool_))
    bad = validity & ~ok
    if bad.any():
        if ansi:
            raise SparkArithmeticException(f"decimal {op} overflow (ANSI)")
        return validity & ok
    return validity


_JMIN = {T.ByteType: -(2 ** 7), T.ShortType: -(2 ** 15),
         T.IntegerType: -(2 ** 31), T.LongType: -(2 ** 63)}


def _java_wrap(vals, validity, dt, ansi: bool, what: str) -> np.ndarray:
    """Python ints wrapped into the Java type; an error under ANSI when a
    valid row wraps."""
    lo = _JMIN[type(dt)]
    rng = -2 * lo
    v = np.where(validity, vals, 0)
    wrapped = (v - lo) % rng + lo
    if ansi and bool((validity & np.asarray(wrapped != v, np.bool_)).any()):
        raise SparkArithmeticException(f"{what} overflow (ANSI)")
    return wrapped.astype(T.storage_dtype(dt))


# -- expressions ------------------------------------------------------------

def _constant(e: Expression) -> bool:
    """No column reference below ``e``: one value for every row."""
    return not isinstance(e, BoundReference) and all(
        _constant(c) for c in e.children)


def eval_expr(e: Expression, cols: CpuBatch, n: int,
              ansi: bool = False) -> CpuCol:
    h = _HANDLERS.get(type(e))
    if h is None:
        raise NotOnGpu(f"expression {type(e).__name__} in a CPU stage")
    if n > 1 and not isinstance(e, Literal) and _constant(e):
        # a constant subtree (the cast of a literal) is evaluated once
        return h(e, cols, 1, ansi).broadcast(n)
    return h(e, cols, n, ansi)


def _kids(e, cols, n, ansi):
    return [eval_expr(c, cols, n, ansi) for c in e.children]


def _h_bound(e, cols, n, ansi):
    return cols[e.ordinal]


def _h_literal(e: Literal, cols, n, ansi):
    dt = e.dataType
    valid = np.full(n, e.value is not None, np.bool_)
    if isinstance(dt, T.NullType):
        return CpuCol(dt, np.zeros(n, np.int32), valid)
    if isinstance(dt, T.StringType):
        raw = (b"" if e.value is None else e.value if isinstance(
            e.value, bytes) else str(e.value).encode("utf-8"))
        row = np.zeros((1, max(len(raw), 1)), np.uint8)
        row[0, :len(raw)] = np.frombuffer(raw, np.uint8)
        return CpuCol(dt, None, valid, None,
                      np.broadcast_to(row, (n, row.shape[1])),
                      np.full(n, len(raw), np.int32))
    v = e.storage_value() if e.value is not None else 0
    if isinstance(dt, T.DecimalType):
        row = _from_py_ints(np.array([int(v)], object),
                            np.ones(1, np.bool_), dt)
        return CpuCol(dt, np.repeat(row, n, axis=0), valid)
    return CpuCol(dt, np.full(n, v, T.storage_dtype(dt)), valid)


def _h_alias(e, cols, n, ansi):
    return eval_expr(e.children[0], cols, n, ansi)


def _limbs(c: CpuCol):
    """A decimal or integer column's values as torch (hi, lo) int64 limbs
    on the CPU (views where the storage allows)."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    v = _tensor(c.values)
    if _is_dec128(c.dtype):
        return D.unpack(v)
    return D.from64(v)


def _from_limbs(hi, lo, dt: T.DecimalType) -> np.ndarray:
    from spark_rapids_tpu_torch.expr import decimal128 as D

    return (D.pack(hi, lo) if dt.is_128 else lo).numpy()


def _limb_check(ok, validity, ansi: bool, op: str) -> np.ndarray:
    """Validity with the rows where ``ok`` (torch) fails nulled, or under
    ANSI an error if a valid row fails (the reference's ``_dec_check``)."""
    bad = validity & ~ok.numpy()
    if bad.any():
        if ansi:
            raise SparkArithmeticException(f"decimal {op} overflow (ANSI)")
        return validity & ~bad
    return validity


def _tensor(a: np.ndarray):
    """A CPU tensor over ``a`` (torch's elementwise ops use every core)."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _valid_only(t, validity: np.ndarray):
    """``t`` with its invalid rows zeroed (as is, when every row is
    valid)."""
    return t if validity.all() else t.where(_tensor(validity), 0)


def _one_limb(c: CpuCol, validity):
    """A decimal column's values as an int64 tensor when every valid one
    fits a single limb (a 128-bit value whose high word is its low word's
    sign), else None."""
    if not _is_dec128(c.dtype):
        return _tensor(c.values.astype(np.int64, copy=False))
    hi, lo = _tensor(c.values[:, 0]), _tensor(c.values[:, 1])
    if bool(_valid_only(hi != (lo >> 63), validity).any()):
        return None
    return lo


def _small_product(l: CpuCol, r: CpuCol, validity):
    """The int64 product (a tensor) of two decimal columns where every
    valid product is below 2^62 in magnitude (the largest magnitudes, read
    on the host, say so), else None: the limb multiply is then exact but
    not needed."""
    a, b = _one_limb(l, validity), _one_limb(r, validity)
    if a is None or b is None or not validity.any():
        return None
    a, b = _valid_only(a, validity), _valid_only(b, validity)
    amax = max(int(a.max()), -int(a.min()))
    bmax = max(int(b.max()), -int(b.min()))
    if amax * bmax >= 1 << 62:
        return None
    return a * b


def _dec_binarith(e: A.BinaryArithmetic, l: CpuCol, r: CpuCol, validity,
                  ansi: bool) -> CpuCol:
    """Decimal ``+``, ``-`` and ``*`` on int64 limbs (torch on the CPU,
    ``expr/decimal128.py``): exact in 128 bits, a result past 10^precision
    (or past 128 bits) null, or an error under ANSI.  In one int64 where
    the operands and the result are within 18 digits, as on the card, and
    for a product above 18 digits whose operands' largest magnitudes
    multiply to less than 2^62 (``_small_product``).
    ``_h_binarith_py`` is its Python-integer twin."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    dt = e.dataType
    lt, rt = e.left.dataType, e.right.dataType
    name = type(e).__name__.removeprefix("Try")
    if not (dt.is_128 or lt.is_128 or rt.is_128):
        # every value within 18 digits: int64 cannot wrap (an operand
        # rescaled, a sum or a product stays below 10^18)
        a, b = _tensor(l.values), _tensor(r.values)
        if name == "Multiply":
            out = a * b
        else:
            a = a * 10 ** (dt.scale - lt.scale)
            b = b * 10 ** (dt.scale - rt.scale)
            out = a + b if name == "Add" else a - b
        bound = 10 ** dt.precision
        validity = _limb_check((out < bound) & (out > -bound), validity,
                               ansi, name.lower())
        return CpuCol(dt, _valid_only(out, validity).numpy(), validity)
    if name == "Multiply":
        small = _small_product(l, r, validity)
        if small is not None:
            # |product| < 2^62 < 10^19 <= 10^precision: in bounds
            return CpuCol(dt, _from_limbs(small >> 63, small, dt), validity)
    ah, al = _limbs(l)
    bh, bl = _limbs(r)
    if name == "Multiply":
        if lt.is_128 or rt.is_128:
            over, rh, rl = D.mul128_checked(ah, al, bh, bl)
        else:
            rh, rl = D.mul64_to_128(al, bl)     # exact, cannot wrap
            over = None
    else:
        oa, ah, al = D.mul128_pow10(ah, al, dt.scale - lt.scale)
        ob, bh, bl = D.mul128_pow10(bh, bl, dt.scale - rt.scale)
        if name == "Subtract":
            bh, bl = D.neg128(bh, bl)
        rh, rl = D.add128(ah, al, bh, bl)
        # signed 128 wrap: same operand signs, a different result sign
        over = oa | ob | (((ah < 0) == (bh < 0)) & ((rh < 0) != (ah < 0)))
    ok = D.in_bounds(rh, rl, dt.precision)
    if over is not None:
        ok = ok & ~over
    validity = _limb_check(ok, validity, ansi, name.lower())
    return CpuCol(dt, _from_limbs(rh, rl, dt), validity)


def _h_binarith(e: A.BinaryArithmetic, cols, n, ansi):
    if isinstance(e.dataType, T.DecimalType):
        l, r = _kids(e, cols, n, ansi)
        return _dec_binarith(e, l, r, l.validity & r.validity, ansi)
    return _h_binarith_py(e, cols, n, ansi)


def _h_binarith_py(e: A.BinaryArithmetic, cols, n, ansi):
    """Arithmetic through Python integers (decimals) or Java-wrapped ones
    (integers); for decimals the plain twin of ``_dec_binarith``."""
    l, r = _kids(e, cols, n, ansi)
    validity = l.validity & r.validity
    dt = e.dataType
    name = type(e).__name__
    if isinstance(dt, T.DecimalType):
        lt, rt = e.left.dataType, e.right.dataType
        a = np.where(validity, _py_ints(l), 0)
        b = np.where(validity, _py_ints(r), 0)
        if name == "Multiply":
            out = a * b
        else:
            a = a * (10 ** (dt.scale - lt.scale))
            b = b * (10 ** (dt.scale - rt.scale))
            out = a + b if name == "Add" else a - b
        validity = _dec_check(out, validity, dt, ansi, name.lower())
        return CpuCol(dt, _from_py_ints(out, validity, dt), validity)
    if dt.is_integral:
        a, b = _py_ints(l), _py_ints(r)
        out = a + b if name == "Add" else a - b if name == "Subtract" \
            else a * b
        return CpuCol(dt, _java_wrap(out, validity, dt, ansi, name),
                      validity)
    la = l.values.astype(np.float64)
    ra = r.values.astype(np.float64)
    with np.errstate(all="ignore"):
        out = la + ra if name == "Add" else la - ra if name == "Subtract" \
            else la * ra
    return CpuCol(dt, out.astype(T.storage_dtype(dt)), validity)


_CMP = {P.EqualTo: lambda a, b: a == b, P.LessThan: lambda a, b: a < b,
        P.LessThanOrEqual: lambda a, b: a <= b,
        P.GreaterThan: lambda a, b: a > b,
        P.GreaterThanOrEqual: lambda a, b: a >= b}


def _str_compare(l: CpuCol, r: CpuCol):
    """(lt, eq) of two string columns row by row: the first differing
    byte, else the shorter is smaller (``expr/predicates.py``'s
    ``string_compare``)."""
    w = max(l.chars.shape[1], r.chars.shape[1])
    a, b = l.with_width(w).chars, r.with_width(w).chars
    diff = a != b
    any_diff = diff.any(axis=1)
    first = diff.argmax(axis=1)
    rows = np.arange(len(first))
    lt = np.where(any_diff, a[rows, first] < b[rows, first],
                  l.lengths < r.lengths)
    eq = ~any_diff & (l.lengths == r.lengths)
    return lt, eq


_STR_CMP = {P.EqualTo: lambda lt, eq: eq, P.LessThan: lambda lt, eq: lt,
            P.LessThanOrEqual: lambda lt, eq: lt | eq,
            P.GreaterThan: lambda lt, eq: ~lt & ~eq,
            P.GreaterThanOrEqual: lambda lt, eq: ~lt}


def _h_comparison(e, cols, n, ansi):
    l, r = _kids(e, cols, n, ansi)
    validity = l.validity & r.validity
    if l.is_string:
        return CpuCol(T.BOOLEAN, _STR_CMP[type(e)](*_str_compare(l, r)),
                      validity)
    if _is_dec128(e.left.dataType):
        a, b = _py_ints(l), _py_ints(r)
    else:
        a, b = l.values, r.values
    with np.errstate(invalid="ignore"):
        data = np.asarray(_CMP[type(e)](a, b), np.bool_)
    return CpuCol(T.BOOLEAN, data, validity)


def _h_and(e, cols, n, ansi):
    l, r = _kids(e, cols, n, ansi)
    lv, rv = l.values.astype(bool), r.values.astype(bool)
    lf, rf = l.validity & ~lv, r.validity & ~rv
    return CpuCol(T.BOOLEAN, l.validity & lv & r.validity & rv,
                  (l.validity & r.validity) | lf | rf)


def _h_or(e, cols, n, ansi):
    l, r = _kids(e, cols, n, ansi)
    lt = l.validity & l.values.astype(bool)
    rt = r.validity & r.values.astype(bool)
    return CpuCol(T.BOOLEAN, lt | rt, (l.validity & r.validity) | lt | rt)


def _h_not(e, cols, n, ansi):
    (c,) = _kids(e, cols, n, ansi)
    return CpuCol(T.BOOLEAN, ~c.values.astype(bool), c.validity)


def _h_isnull(e, cols, n, ansi):
    (c,) = _kids(e, cols, n, ansi)
    return CpuCol(T.BOOLEAN, ~c.validity, np.ones(n, np.bool_))


def _h_isnotnull(e, cols, n, ansi):
    (c,) = _kids(e, cols, n, ansi)
    return CpuCol(T.BOOLEAN, c.validity.copy(), np.ones(n, np.bool_))


def _h_coalesce(e, cols, n, ansi):
    kids = _kids(e, cols, n, ansi)
    acc = kids[-1]
    for c in reversed(kids[:-1]):
        acc = _select(c.validity, c, acc, e.dataType)
    return acc


def _select(take, a: CpuCol, b: CpuCol, dt) -> CpuCol:
    """where(take, a, b) over values (a string's chars and lengths) and
    validity."""
    validity = np.where(take, a.validity, b.validity)
    if a.is_string:
        w = max(a.chars.shape[1], b.chars.shape[1])
        return CpuCol(dt, None, validity, None,
                      np.where(take[:, None], a.with_width(w).chars,
                               b.with_width(w).chars),
                      np.where(take, a.lengths, b.lengths))
    t = take if a.values.ndim == 1 else take[:, None]
    return CpuCol(dt, np.where(t, a.values, b.values), validity)


def _h_in(e, cols, n, ansi):
    kids = _kids(e, cols, n, ansi)
    v = kids[0]
    match = np.zeros(n, np.bool_)
    null_cand = False
    for c, ce in zip(kids[1:], e.children[1:]):
        if isinstance(ce, Literal) and ce.value is None:
            null_cand = True
            continue
        if v.is_string:
            eq = _str_compare(v, c)[1]
        else:
            eq = (v.values == c.values)
            eq = eq.all(axis=-1) if eq.ndim == 2 else eq
        match |= eq & c.validity
    validity = v.validity & match if null_cand else v.validity
    return CpuCol(T.BOOLEAN, match, validity)


def _h_if(e, cols, n, ansi):
    p, a, b = _kids(e, cols, n, ansi)
    return _select(p.values.astype(bool) & p.validity, a, b, e.dataType)


def _h_case_when(e, cols, n, ansi):
    kids = _kids(e, cols, n, ansi)
    acc = kids[-1] if e.has_else else _h_literal(
        Literal(None, e.dataType), cols, n, ansi)
    for i in reversed(range(e._n_branches)):
        cond, val = kids[2 * i], kids[2 * i + 1]
        acc = _select(cond.values.astype(bool) & cond.validity, val, acc,
                      e.dataType)
    return acc


def _h_cast(e: Cast, cols, n, ansi):
    """A cast to a decimal on limbs (``decimal128.mul128_pow10`` up,
    ``div128_pow10_half_up`` down), an integer narrowing by numpy's wrap;
    ``_h_cast_py`` is the Python-integer twin of these.  Every other cast
    runs its device code (``_h_torch``)."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    src, dst = e.child.dataType, e.to
    if isinstance(src, (T.FloatType, T.DoubleType)) and _is_dec128(dst):
        return _fp_to_dec128(e, cols, n, ansi)
    if src != dst and not (
            isinstance(src, _INTEGRAL + (T.DecimalType,))
            and isinstance(dst, T.DecimalType)) and not (
            isinstance(src, _INTEGRAL) and isinstance(dst, _INTEGRAL)):
        # the other casts run their device code (the limb paths for a
        # decimal above 18 digits to an integral or a double included)
        return _h_torch(e, cols, n, ansi)
    (c,) = _kids(e, cols, n, ansi)
    ansi = ansi or e.ansi_override
    if src == dst:
        return c
    if isinstance(dst, _INTEGRAL):
        out = c.values.astype(T.storage_dtype(dst))
        if ansi and bool((c.validity & (out.astype(np.int64)
                                        != c.values.astype(np.int64)))
                         .any()):
            raise SparkArithmeticException("cast overflow (ANSI)")
        return CpuCol(dst, out, c.validity)
    h, lo = _limbs(c)
    diff = dst.scale - (src.scale if isinstance(src, T.DecimalType) else 0)
    if diff >= 0:
        over, h, lo = D.mul128_pow10(h, lo, diff)
        ok = D.in_bounds(h, lo, dst.precision) & ~over
    else:
        h, lo = D.div128_pow10_half_up(h, lo, -diff)
        ok = D.in_bounds(h, lo, dst.precision)
    validity = _limb_check(ok, c.validity, ansi, "cast")
    return CpuCol(dst, _from_limbs(h, lo, dst), validity)


def _fp_to_dec128(e: Cast, cols, n, ansi):
    """A double to a decimal above 18 digits (the tagging keeps it off the
    device, as the reference's ``_check_cast``): the double's exact
    binary value scaled and rounded HALF_UP in Python's ``decimal``, as
    the reference's oracle casts; NaN and the infinities null, or an
    error under ANSI, as a result past 10^precision."""
    from decimal import ROUND_HALF_UP, Decimal, localcontext

    (c,) = _kids(e, cols, n, ansi)
    ansi = ansi or e.ansi_override
    dst = e.to
    vals = np.zeros(n, object)
    validity = c.validity.copy()
    with localcontext() as ctx:
        ctx.prec = 400                 # every double's digits, exactly
        for i in np.flatnonzero(validity):
            f = float(c.values[i])
            if not np.isfinite(f):
                if ansi:
                    raise SparkArithmeticException(
                        "cast NaN/Inf to decimal (ANSI)")
                validity[i] = False
                continue
            vals[i] = int(Decimal(f).scaleb(dst.scale).quantize(
                Decimal(1), rounding=ROUND_HALF_UP))
    validity = _dec_check(vals, validity, dst, ansi, "cast")
    return CpuCol(dst, _from_py_ints(vals, validity, dst), validity)


def _h_cast_py(e: Cast, cols, n, ansi):
    """``_h_cast`` through Python integers (the plain twin)."""
    (c,) = _kids(e, cols, n, ansi)
    src, dst = e.child.dataType, e.to
    ansi = ansi or e.ansi_override
    if src == dst:
        return c
    vals = np.where(c.validity, _py_ints(c), 0)
    if isinstance(dst, _INTEGRAL):
        return CpuCol(dst, _java_wrap(vals, c.validity, dst, ansi, "cast"),
                      c.validity)
    diff = dst.scale - (src.scale if isinstance(src, T.DecimalType) else 0)
    if diff >= 0:
        out = vals * (10 ** diff)
    else:                              # HALF_UP, as the reference's
        den = 10 ** (-diff)
        mag = np.abs(vals)
        q = mag // den
        q = q + np.asarray(2 * (mag - q * den) >= den, np.bool_)
        out = np.where(np.asarray(vals < 0, np.bool_), -q, q)
    validity = _dec_check(out, c.validity, dst, ansi, "cast")
    return CpuCol(dst, _from_py_ints(out, validity, dst), validity)


def _h_get_struct_field(e: CT.GetStructField, cols, n, ansi):
    (s,) = _kids(e, cols, n, ansi)
    kid = s.children[e._field_ordinal]
    return CpuCol(kid.dtype, kid.values, kid.validity & s.validity,
                  kid.children)


def _h_create_named_struct(e: CT.CreateNamedStruct, cols, n, ansi):
    return CpuCol(e.dataType, None, np.ones(n, np.bool_),
                  _kids(e, cols, n, ansi))


# -- strings and dates ---------------------------------------------------

def _to_torch(c: CpuCol):
    """A flat or string column as a ``DeviceColumn`` of CPU tensors."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn

    if c.is_string:
        return DeviceColumn(c.dtype, _tensor(c.validity),
                            chars=_tensor(c.chars),
                            lengths=_tensor(c.lengths))
    return DeviceColumn(c.dtype, _tensor(c.validity),
                        data=_tensor(c.values))


def _from_torch(d) -> CpuCol:
    def a(t):
        return None if t is None else t.contiguous().numpy()
    return CpuCol(d.dtype, a(d.data), a(d.validity), None, a(d.chars),
                  a(d.lengths))


class _HostCtx:
    """The evaluation context of device code run in a CPU stage: an ANSI
    error (a division by zero, a cast or an overflow) raises at once, as
    the reference's oracle raises."""

    batch = None

    def __init__(self, ansi: bool):
        self.ansi = ansi

    def add_error(self, flag_per_row, message: str):
        if bool(flag_per_row.any()):
            raise SparkArithmeticException(message)


def _h_torch(e, cols, n, ansi):
    """The string, date, math, bitwise, conditional and non-decimal
    arithmetic expressions run their device code on CPU tensors
    (``expr/strings.py``, ``expr/datetime.py``, ``expr/mathfuncs.py``,
    ...): a CPU stage computes what the card computes, bit for bit."""
    kids = _kids(e, cols, n, ansi)
    return _from_torch(e.do_columnar_eval(_HostCtx(ansi),
                                          [_to_torch(k) for k in kids]))


def _rows_text(c: CpuCol):
    """A string column's rows as ``str`` (None where null)."""
    return [bytes(c.chars[i, :c.lengths[i]]).decode("utf-8", "replace")
            if c.validity[i] else None for i in range(c.n)]


def _java_regex_to_python(pat: str) -> str:
    """The reference oracle's adjustment of Java against Python regexes
    for its patterns: Java's ``.`` excludes ``\\r`` too, and Java's ``$``
    also matches before a final ``\\r`` or ``\\r\\n``.  Walks the
    pattern skipping escapes and character classes."""
    out = []
    i = 0
    in_class = False
    while i < len(pat):
        c = pat[i]
        if c == "\\" and i + 1 < len(pat):
            out.append(pat[i:i + 2])
            i += 2
            continue
        if in_class:
            if c == "]":
                in_class = False
            out.append(c)
        elif c == "[":
            in_class = True
            out.append(c)
        elif c == ".":
            out.append(r"[^\n\r]")
        elif c == "$":
            out.append(r"(?=(?:\r\n|\n|\r)?\Z)")
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _h_pattern(e, cols, n, ansi):
    """``LIKE``, ``ILIKE`` and ``RLIKE``: a pattern the device runs (a fast
    path or a DFA) runs as on the card (``_h_torch``); one the transpiler
    rejects, the reason it is in this CPU stage, runs through Python's
    ``re`` row by row, as the reference's oracle runs every pattern."""
    import re

    from spark_rapids_tpu_torch.regex import (RegexUnsupported,
                                              compile_regex, like_to_regex)

    p = e.right.value
    if p is None:
        # a NULL pattern yields NULL on every row, as in Spark
        return CpuCol(T.BOOLEAN, np.zeros(n, np.bool_), np.zeros(n, np.bool_))
    if isinstance(e, S.RLike):
        try:
            e._dfa = getattr(e, "_dfa", None) or compile_regex(p)
            return _h_torch(e, cols, n, ansi)
        except RegexUnsupported:
            rx = re.compile(_java_regex_to_python(p))

            def hit(v):
                return rx.search(v) is not None
    else:
        if isinstance(e, S.ILike):
            p = str(p).lower()
        if S.try_compile_like(p)[0]:
            return _h_torch(e, cols, n, ansi)
        rx = re.compile(like_to_regex(p))
        fold = isinstance(e, S.ILike)

        def hit(v):
            if fold:
                v = "".join(chr(ord(ch) + 32) if "A" <= ch <= "Z" else ch
                            for ch in v)
            return rx.fullmatch(v) is not None
    (c, _) = _kids(e, cols, n, ansi)
    out = np.array([v is not None and hit(v) for v in _rows_text(c)],
                   np.bool_)
    return CpuCol(T.BOOLEAN, out, c.validity.copy())


# -- division, remainder and the decimal unary functions ----------------------

def _dec_operands(e):
    """(ka, kb): the decimal (or integral) operands' unscaled values are
    multiplied by 10^ka and 10^kb before the operation: for a divide the
    numerator by 10^shift (or the denominator by 10^-shift), for a
    remainder both to the result's scale."""
    dt = e.dataType
    lt, rt = e.left.dataType, e.right.dataType
    ls = lt.scale if isinstance(lt, T.DecimalType) else 0
    rs = rt.scale if isinstance(rt, T.DecimalType) else 0
    if isinstance(e, A.Divide):
        shift = dt.scale - ls + rs
        return max(shift, 0), max(-shift, 0)
    return dt.scale - ls, dt.scale - rs


def _divmod_limbs(e, l: CpuCol, r: CpuCol, validity):
    """Exact ``(q, rem)`` of the scaled operands on int64 limbs (torch on
    the CPU): a numerator below 2^127 in magnitude after its scaling, a
    denominator below 2^62 after its; the unsigned 128-bit quotient
    (hi, lo), the remainder's magnitude and the result's and the
    numerator's signs.  None where a valid row passes those bounds (the
    Python-integer path then takes the column)."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    ka, kb = _dec_operands(e)
    b = _one_limb(r, validity)
    if b is None:
        return None
    b = _valid_only(b, validity)
    bmax = max(int(b.max()), -int(b.min())) if len(b) else 0
    if bmax * 10 ** kb >= 1 << 62:       # a pmod's sum stays in int64
        return None
    den = b * 10 ** kb
    ah, al = _limbs(l)
    over, ah, al = D.mul128_pow10(ah, al, ka)
    if bool(_valid_only(over, validity).any()):
        return None
    safe = den.where(den != 0, 1)
    neg_a = D.is_neg(ah, al)
    uh, ul = D.abs128(ah, al)
    qh, ql, rem = D.udivmod128_by_u64(uh, ul, safe.abs())
    return qh, ql, rem, safe, neg_a, neg_a ^ (safe < 0)


def _limb_column(hi, lo, validity, dt: T.DecimalType, ansi: bool, op: str):
    from spark_rapids_tpu_torch.expr import decimal128 as D

    ok = D.in_bounds(hi, lo, dt.precision)
    validity = _limb_check(ok, validity, ansi, op)
    return CpuCol(dt, _from_limbs(hi, lo, dt), validity)


def _zero_divisors(r: CpuCol, validity, ansi: bool) -> np.ndarray:
    """Validity with the rows whose divisor is zero nulled, or under ANSI
    an error if a valid one is."""
    zero = (r.values == 0).all(axis=-1) if r.values.ndim == 2 \
        else r.values == 0
    if ansi and bool((zero & validity).any()):
        raise SparkArithmeticException("division by zero (ANSI)")
    return validity & ~zero


def _dec_divmod(e, l: CpuCol, r: CpuCol, ansi: bool) -> CpuCol:
    """A decimal Divide (HALF_UP), Remainder (the sign of the dividend) or
    Pmod (a negative remainder plus the divisor, then again its remainder,
    as Spark's pmod) on int64 limbs where the operands allow
    (``_divmod_limbs``), else through Python integers
    (``_dec_divmod_py``, also the plain twin the tests hold this to).  A
    zero divisor is null, or an error under ANSI; a quotient past
    10^precision null, or an error under ANSI."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    dt = e.dataType
    validity = _zero_divisors(r, l.validity & r.validity, ansi)
    parts = _divmod_limbs(e, l, r, validity)
    if parts is None:
        return _dec_divmod_py(e, l, r, validity, ansi)
    qh, ql, rem, den, neg_a, neg_q = parts
    zero64 = torch.zeros_like(rem)
    if isinstance(e, A.Divide):
        away = (rem != 0) & (rem >= den.abs() - rem)       # HALF_UP
        qh, ql = D.add128(qh, ql, zero64, away.to(torch.int64))
        nh, nl = D.neg128(qh, ql)
        hi, lo = torch.where(neg_q, nh, qh), torch.where(neg_q, nl, ql)
        return _limb_column(hi, lo, validity, dt, ansi, "divide")
    m = torch.where(neg_a, -rem, rem)
    if isinstance(e, A.Pmod):
        m2 = m + den
        m = torch.where(m < 0, m2 - torch.div(m2, den, rounding_mode="trunc")
                        * den, m)
    return CpuCol(dt, _from_limbs(m >> 63, m, dt), validity)


def _dec_divmod_py(e, l: CpuCol, r: CpuCol, validity, ansi: bool) -> CpuCol:
    """``_dec_divmod`` through Python integers (exact for any operands)."""
    dt = e.dataType
    ka, kb = _dec_operands(e)
    a = np.where(validity, _py_ints(l), 0) * (10 ** ka)
    b = np.where(validity, _py_ints(r), 1) * (10 ** kb)
    mag_q = np.abs(a) // np.abs(b)
    mag_r = np.abs(a) - mag_q * np.abs(b)
    neg_a = np.asarray(a < 0, np.bool_)
    if isinstance(e, A.Divide):
        away = np.asarray(2 * mag_r >= np.abs(b), np.bool_) \
            & np.asarray(mag_r != 0, np.bool_)
        mag_q = mag_q + away
        out = np.where(neg_a ^ np.asarray(b < 0, np.bool_), -mag_q, mag_q)
        validity = _dec_check(out, validity, dt, ansi, "divide")
    else:
        out = np.where(neg_a, -mag_r, mag_r)
        if isinstance(e, A.Pmod):
            m2 = out + b
            fix = np.where(np.asarray(m2 < 0, np.bool_),
                           -(np.abs(m2) % np.abs(b)), np.abs(m2) % np.abs(b))
            out = np.where(np.asarray(out < 0, np.bool_), fix, out)
    return CpuCol(dt, _from_py_ints(out, validity, dt), validity)


def _h_divmod(e, cols, n, ansi):
    """Divide, Remainder and Pmod: decimals exactly (``_dec_divmod``),
    the rest by the device code."""
    if not isinstance(e.dataType, T.DecimalType):
        return _h_torch(e, cols, n, ansi)
    l, r = _kids(e, cols, n, ansi)
    return _dec_divmod(e, l, r, ansi)


def _h_try(e, cols, n, ansi):
    """try_*: on decimals the operation with its errors as nulls (the
    non-ANSI result of ``_dec_binarith`` or ``_dec_divmod``), else the
    device code."""
    if not isinstance(e.dataType, T.DecimalType):
        return _h_torch(e, cols, n, ansi)
    l, r = _kids(e, cols, n, ansi)
    if isinstance(e, A.Divide):
        return _dec_divmod(e, l, r, False)
    return _dec_binarith(e, l, r, l.validity & r.validity, False)


def _h_dec_unary(e, cols, n, ansi):
    """UnaryMinus, Abs, Floor, Ceil and Round of a decimal above 18
    digits, and BRound (HALF_EVEN) of any decimal, through Python
    integers (the rules keep them off the device); the rest by the device
    code."""
    ct = e.children[0].dataType
    if not (_is_dec128(ct) or (isinstance(e, M.BRound)
                               and isinstance(ct, T.DecimalType))):
        return _h_torch(e, cols, n, ansi)
    c = _kids(e, cols, n, ansi)[0]
    v = np.where(c.validity, _py_ints(c), 0)
    dt = e.dataType
    validity = c.validity
    if isinstance(e, A.UnaryMinus):
        out = -v
    elif isinstance(e, A.Abs):
        out = np.abs(v)
    else:
        den = 10 ** (ct.scale - dt.scale)
        if isinstance(e, M.Ceil):
            out = -((-v) // den)
        elif isinstance(e, M.Floor):
            out = v // den
        else:                          # Round HALF_UP, BRound HALF_EVEN
            mag = np.abs(v)
            q = mag // den
            twice = 2 * (mag - q * den)
            up = twice > den if isinstance(e, M.BRound) else twice >= den
            if isinstance(e, M.BRound):
                up = up | ((twice == den) & (q % 2 == 1))
            q = q + np.asarray(up, np.bool_)
            out = np.where(np.asarray(v < 0, np.bool_), -q, q)
        validity = _dec_check(out, validity, dt, ansi, "round")
    return CpuCol(dt, _from_py_ints(out, validity, dt), validity)


# -- dates and times ----------------------------------------------------------

_DOW_ABBR = ("Sun", "Mon", "Tue", "Wed", "Thu", "Fri", "Sat")
_DOW_FULL = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
             "Friday", "Saturday")
_MON_FULL = ("January", "February", "March", "April", "May", "June",
             "July", "August", "September", "October", "November",
             "December")
#: the reference oracle's pattern tokens (a wider set than the device's)
_HOST_FMT_TOKENS = ("yyyy", "MMMM", "MMM", "MM", "dd", "DD", "HH", "mm",
                    "ss", "EEEE", "EEE", "a")


def host_format_tokens(fmt: str):
    """A pattern as the reference's oracle reads it: a list of tokens of
    ``_HOST_FMT_TOKENS`` and literal characters; None for another
    letter (the oracle cannot render it either)."""
    out, i = [], 0
    while i < len(fmt):
        for t in _HOST_FMT_TOKENS:
            if fmt.startswith(t, i):
                out.append(("tok", t))
                i += len(t)
                break
        else:
            if fmt[i].isalpha():
                return None
            out.append(("lit", fmt[i]))
            i += 1
    return out


def _format_micros(micros: np.ndarray, tokens) -> List[str]:
    """Instants rendered as the reference's oracle renders them (UTC),
    the fields by the device's civil math over all rows at once."""
    from spark_rapids_tpu_torch.expr.cast import (civil_from_days,
                                                  days_from_civil)

    days = np.floor_divide(micros, 86_400_000_000)
    rem = micros - days * 86_400_000_000
    y, mo, d = (t.numpy() for t in civil_from_days(torch.from_numpy(days)))
    one = torch.ones(len(days), dtype=torch.int64)
    doy = days - days_from_civil(torch.from_numpy(y), one, one).numpy() + 1
    fields = zip(y.tolist(), mo.tolist(), d.tolist(), doy.tolist(),
                 (rem // 3_600_000_000).tolist(),
                 (rem // 60_000_000 % 60).tolist(),
                 (rem // 1_000_000 % 60).tolist(),
                 ((days + 4) % 7).tolist())
    out = []
    for y_, mo_, d_, doy_, h, mi, s_, dow in fields:
        text = {"yyyy": f"{y_:04d}", "MM": f"{mo_:02d}",
                "MMM": DT.MonthName._NAMES[mo_ - 1],
                "MMMM": _MON_FULL[mo_ - 1], "dd": f"{d_:02d}",
                "DD": f"{doy_:03d}", "HH": f"{h:02d}", "mm": f"{mi:02d}",
                "ss": f"{s_:02d}", "EEE": _DOW_ABBR[dow],
                "EEEE": _DOW_FULL[dow], "a": "AM" if h < 12 else "PM"}
        out.append("".join(text[v] if k == "tok" else v
                           for k, v in tokens))
    return out


def _h_format_time(e, cols, n, ansi):
    """from_unixtime/date_format: a pattern of the device's subset runs
    the device code; a wider one (tagged off the device) is rendered on
    the host, as the reference's oracle renders it."""
    fmt = DT.literal_text(e.children[1])
    if DT.parse_format(fmt) is not None:
        return _h_torch(e, cols, n, ansi)
    c = eval_expr(e.children[0], cols, n, ansi)
    v = np.where(c.validity, c.values.astype(np.int64), 0)
    if isinstance(e, DT.FromUnixTime):
        micros = v * 1_000_000          # wraps, as Java's long multiply
    elif isinstance(e.children[0].dataType, T.DateType):
        micros = v * 86_400_000_000
    else:
        micros = v
    out = _format_micros(micros, host_format_tokens(fmt))
    return CpuCol.from_host(HostColumn.strings(out, c.validity.copy()))


def _h_utc_shift(e, cols, n, ansi):
    """from/to_utc_timestamp with any zone column: each distinct zone's
    rows shifted by the device code's table search on CPU tensors (an
    unknown zone raises, as in the reference's oracle)."""
    ts, tz = _kids(e, cols, n, ansi)
    to_utc = isinstance(e, DT.ToUTCTimestamp)
    validity = ts.validity & tz.validity
    zones = (np.array(_rows_text(tz), object) if tz.is_string
             else np.full(n, None, object))
    micros = torch.from_numpy(ts.values.astype(np.int64))
    secs = torch.div(micros, 1_000_000, rounding_mode="floor")
    out = np.zeros(n, np.int64)
    for zone in sorted({z for z, ok in zip(zones, validity) if ok}):
        rows = validity & (zones == zone)
        off = DT._zone_offsets(zone, secs[torch.from_numpy(rows)],
                               "wall_starts" if to_utc
                               else "utc_instants").numpy() * 1_000_000
        out[rows] = ts.values[rows] - off if to_utc \
            else ts.values[rows] + off
    return CpuCol(T.TIMESTAMP, out, validity)


def _h_captured(e, cols, n, ansi):
    v = (e.captured_micros // 86_400_000_000
         if isinstance(e, DT.CurrentDate) else e.captured_micros)
    return CpuCol(e.dataType, np.full(n, v, T.storage_dtype(e.dataType)),
                  np.ones(n, np.bool_))


def _h_extract(e, cols, n, ansi):
    """The field's expression; ``epoch`` (tagged off the device) the
    seconds since the epoch, as the reference's oracle gives them."""
    if e._delegate is not None:
        return eval_expr(e._delegate, cols, n, ansi)
    c = eval_expr(e.children[1], cols, n, ansi)
    v = c.values.astype(np.int64)
    out = (v * 86_400 if isinstance(e.children[1].dataType, T.DateType)
           else np.floor_divide(v, 1_000_000))
    return CpuCol(T.LONG, out, c.validity.copy())


def _h_date_part(e, cols, n, ansi):
    return eval_expr(e._inner, cols, n, ansi)


def _h_hive_hash(e, cols, n, ansi):
    """The device's Hive hash; a TIMESTAMP (tagged off the device) hashes
    its low 32 bits as an INT, as the reference's oracle hashes it."""
    kids = []
    for k in _kids(e, cols, n, ansi):
        if isinstance(k.dtype, T.TimestampType):
            k = CpuCol(T.INT, k.values.astype(np.int64).astype(np.int32),
                       k.validity)
        kids.append(k)
    return _from_torch(e.do_columnar_eval(_HostCtx(ansi),
                                          [_to_torch(k) for k in kids]))


_HANDLERS = {
    BoundReference: _h_bound, Literal: _h_literal, Alias: _h_alias,
    A.Add: _h_binarith, A.Subtract: _h_binarith, A.Multiply: _h_binarith,
    P.EqualTo: _h_comparison, P.LessThan: _h_comparison,
    P.LessThanOrEqual: _h_comparison, P.GreaterThan: _h_comparison,
    P.GreaterThanOrEqual: _h_comparison,
    P.And: _h_and, P.Or: _h_or, P.Not: _h_not,
    P.IsNull: _h_isnull, P.IsNotNull: _h_isnotnull,
    P.In: _h_in, CO.If: _h_if, CO.CaseWhen: _h_case_when,
    CO.Coalesce: _h_coalesce, CO.Nvl: _h_coalesce,
    Cast: _h_cast,
    CT.GetStructField: _h_get_struct_field,
    CT.CreateNamedStruct: _h_create_named_struct,
    S.Like: _h_pattern, S.ILike: _h_pattern, S.RLike: _h_pattern,
    A.Divide: _h_divmod, A.Remainder: _h_divmod, A.Pmod: _h_divmod,
    A.TryAdd: _h_try, A.TrySubtract: _h_try, A.TryMultiply: _h_try,
    A.TryDivide: _h_try,
    A.UnaryMinus: _h_dec_unary, A.Abs: _h_dec_unary, M.Floor: _h_dec_unary,
    M.Ceil: _h_dec_unary, M.Round: _h_dec_unary, M.BRound: _h_dec_unary,
}
_HANDLERS.update({cls: _h_torch for cls in (
    S.Length, S.OctetLength, S.BitLength, S.Upper, S.Lower, S.Substring,
    S.StringLeft, S.StringRight, S.Concat, S.StartsWith, S.EndsWith,
    S.Contains, S.StringInstr, S.StringLocate, S.StringTrim,
    S.StringTrimLeft, S.StringTrimRight,
    DT.Year, DT.Month, DT.DayOfMonth, DT.DayOfWeek, DT.DayOfYear,
    DT.Quarter, DT.WeekOfYear, DT.LastDay, DT.DateAdd, DT.DateSub,
    DT.DateDiff, DT.AddMonths, DT.MonthsBetween, DT.TruncDate,
    DT.Hour, DT.Minute, DT.Second, DT.UnixTimestamp, DT.NextDay,
    DT.ToUnixTimestamp, DT.WeekDay, DT.MakeDate, DT.MakeTimestamp,
    DT.TimestampSeconds, DT.TimestampMillis, DT.TimestampMicros,
    DT.UnixDate, DT.DateFromUnixDate, DT.UnixSeconds, DT.UnixMillis,
    DT.UnixMicros, DT.ToDate, DT.ToTimestamp, DT.TruncTimestamp,
    DT.TimestampAdd, DT.TimestampDiff, DT.ConvertTimezone, DT.MonthName,
    DT.DayName, DT.ParseToDate, DT.ParseToTimestamp, DT.TryToTimestamp,
    A.IntegralDivide, A.UnaryPositive, A.BitwiseAnd, A.BitwiseOr,
    A.BitwiseXor, A.BitwiseNot, A.ShiftLeft, A.ShiftRight,
    A.ShiftRightUnsigned, P.EqualNullSafe, P.IsNaN, CO.NaNvl, CO.Greatest,
    CO.Least, CO.Nvl2, CO.NullIf,
    M.Sqrt, M.Exp, M.Log, M.Log10, M.Sin, M.Cos, M.Tan, M.Asin, M.Acos,
    M.Atan, M.Signum, M.Sinh, M.Cosh, M.Tanh, M.Asinh, M.Acosh, M.Atanh,
    M.Cbrt, M.Log2, M.Log1p, M.Expm1, M.Rint, M.Cot, M.Csc, M.Sec,
    M.ToDegrees, M.ToRadians, M.Pow, M.Atan2, M.Hypot,
    M.Logarithm, M.WidthBucket, M.Factorial, M.BitwiseCount,
    H.Murmur3Hash, H.XxHash64, H.BloomFilterMightContain)})
_HANDLERS.update({
    DT.FromUnixTime: _h_format_time, DT.DateFormat: _h_format_time,
    DT.FromUTCTimestamp: _h_utc_shift, DT.ToUTCTimestamp: _h_utc_shift,
    DT.CurrentDate: _h_captured, DT.CurrentTimestamp: _h_captured,
    DT.LocalTimestamp: _h_captured, DT.Extract: _h_extract,
    DT.DatePart: _h_date_part, H.HiveHash: _h_hive_hash})


# -- plans ------------------------------------------------------------------

#: the expressions that yield a string in a CPU stage (a comparison,
#: ``In`` and ``IsNull``/``IsNotNull`` read one)
_STRING_EXPRS = frozenset({BoundReference, Literal, Alias, CO.If,
                           CO.CaseWhen, CO.Coalesce, CO.Nvl, CO.Greatest,
                           CO.Least, CO.Nvl2, CO.NullIf, S.Upper,
                           S.Lower, S.Substring, S.StringLeft,
                           S.StringRight, S.Concat, S.StringTrim,
                           S.StringTrimLeft, S.StringTrimRight, Cast,
                           DT.FromUnixTime, DT.DateFormat, DT.MonthName,
                           DT.DayName})

def _check_expr(e: Expression, why: str) -> None:
    if type(e) not in PORTED_EXPRS:
        raise NotOnGpu(f"expression {type(e).__name__} in a CPU stage "
                       f"({why}), which the port's CPU engine does not run")
    if isinstance(e, Cast) and not cast_supported(e.child.dataType, e.to):
        raise NotOnGpu(f"cast {e.child.dataType.simpleString} -> "
                       f"{e.to.simpleString} in a CPU stage ({why})")
    if isinstance(e, (S.Like, S.RLike)) and not isinstance(e.right, Literal):
        raise NotOnGpu(f"{type(e).__name__} with a pattern that is not a "
                       f"literal in a CPU stage ({why})")
    if isinstance(e, (H.Murmur3Hash, H.XxHash64)) and any(
            isinstance(c.dataType, T.DecimalType) and c.dataType.is_128
            for c in e.children):
        raise NotOnGpu(f"{type(e).__name__} of a decimal above 18 digits "
                       f"in a CPU stage ({why})")
    if isinstance(e, (DT.FromUTCTimestamp, DT.ToUTCTimestamp)) \
            and not isinstance(e.children[1].dataType,
                               (T.StringType, T.NullType)):
        raise NotOnGpu(f"{type(e).__name__} with a zone of type "
                       f"{e.children[1].dataType.simpleString} in a CPU "
                       f"stage ({why})")
    if isinstance(e, (DT.FromUnixTime, DT.DateFormat)) and (
            DT.literal_text(e.children[1]) is None
            or host_format_tokens(DT.literal_text(e.children[1])) is None):
        raise NotOnGpu(f"{type(e).__name__} with the format "
                       f"{e.children[1].sql_string()} in a CPU stage "
                       f"({why})")
    if isinstance(e, DT.Extract) and e._delegate is None and DT.literal_text(
            e.children[0]) != "epoch":
        raise NotOnGpu(f"extract of the field {e.children[0].sql_string()} "
                       f"in a CPU stage ({why})")
    if isinstance(e.dataType, (T.BinaryType, T.ArrayType,
                               T.MapType)) or (
            isinstance(e.dataType, T.StringType)
            and type(e) not in _STRING_EXPRS):
        raise NotOnGpu(f"type {e.dataType.simpleString} in a CPU stage "
                       f"({why})")
    for c in e.children:
        _check_expr(c, why)


#: the plan nodes this engine runs (a device subtree under one of them
#: reaches it as ``TpuMaterializedScan``)
CPU_PLAN_NODES = frozenset({
    PN.LocalTableScan, PN.Filter, PN.Project, PN.Union,
    PN.BroadcastNestedLoopJoin, PN.HashAggregate, PN.SortMergeJoin,
    PN.ShuffledHashJoin, PN.BroadcastHashJoin, PN.Sort, PN.GlobalLimit,
    PN.LocalLimit, PN.Window, PN.Exchange, PN.BroadcastExchange})

_NESTED = (T.ArrayType, T.MapType, T.StructType)
_NUMERIC = (T.ByteType, T.ShortType, T.IntegerType, T.LongType,
            T.FloatType, T.DoubleType, T.DecimalType)


def _node_exprs(node: PN.SparkPlan) -> List[Expression]:
    """The expressions this engine evaluates for ``node``."""
    if isinstance(node, PN.HashAggregate):
        out = list(node.grouping)
        for a in node.aggregates:
            out += [e for e in (a.child, a.child2) if e is not None]
        return out
    if isinstance(node, PN._BaseJoin):
        out = list(node.left_keys) + list(node.right_keys)
    elif isinstance(node, PN.Sort):
        out = [e for e, _ in node.orders]
    elif isinstance(node, PN.Window):
        out = list(node.partition_by) + [e for e, _ in node.order_by] + [
            f.child for f in node.functions if f.child is not None]
    else:
        out = list(getattr(node, "exprs", []))
    cond = getattr(node, "condition", None)
    return out + ([cond] if cond is not None else [])


def _unrun_aggregate(node: PN.HashAggregate) -> Optional[str]:
    """What of an aggregate this engine does not run, or None."""
    for a in node.aggregates:
        ct = a.child.dataType if a.child is not None else None
        if a.func == "approx_count_distinct" and _is_dec128(ct):
            return ("approx_count_distinct of a decimal above 18 digits "
                    "(its xxhash64 is not ported)")
        if a.func == "approx_count_distinct" and \
                node.mode != PN.AggregateMode.COMPLETE:
            return ("a two-phase approx_count_distinct, whose partial "
                    "buffer is an array<int> column (ROADMAP Queue 1 "
                    "item 5)")
        if a.func in PN.HIGHER_MOMENT_FUNCS | {
                "percentile", "approx_percentile", "median"} \
                and not isinstance(ct, _NUMERIC):
            return f"{a.func} of {ct.simpleString}, which is not a number"
        if (a.func in PN.COVARIANCE_FUNCS or a.func in PN.REGR_FUNCS) \
                and not all(isinstance(e.dataType, _NUMERIC)
                            for e in (a.child, a.child2)):
            return f"{a.func} of inputs that are not numbers"
        if a.func in PN.BIT_AGG_FUNCS and not ct.is_integral:
            return f"{a.func} of {ct.simpleString}, which is not integral"
        if a.func in ("percentile", "approx_percentile") and not (
                a.args and 0.0 <= float(a.args[0]) <= 1.0):
            return f"{a.func} with a percentage outside [0, 1]"
        if isinstance(ct, _NESTED):
            return f"{a.func} of the nested type {ct.simpleString}"
    return None


def _unrun_window(node: PN.Window) -> Optional[str]:
    """What of a window this engine does not run, or None: the shapes the
    reference's rules name invalid (a ``sum``, ``avg`` or variance of a
    string; a negative RANGE offset; a RANGE frame over a key that is not
    a number, a date or a timestamp, which the reference's oracle cannot
    bound either), and nested inputs.  A negative ROWS offset runs: the
    frame of ``("rows", -1, 1)`` is the row after, as in the oracle."""
    frame = node.frame
    for f in node.functions:
        ct = f.child.dataType if f.child is not None else None
        if isinstance(ct, T.StringType) and (
                f.func in ("sum", "avg") or f.func.startswith(
                    ("var", "stddev"))):
            return f"{f.func} of a string"
        if isinstance(ct, _NESTED):
            return f"{f.func} of the nested type {ct.simpleString}"
    if isinstance(frame, tuple) and frame[0] == "range" \
            and (frame[1] < 0 or frame[2] < 0):
        return "a negative RANGE frame offset"
    if (isinstance(frame, tuple) and frame[0] == "range") \
            or frame == "range_running":
        if not node.order_by:
            return "a RANGE frame without an ORDER BY"
    if isinstance(frame, tuple) and frame[0] == "range":
        ot = node.order_by[0][0].dataType
        if not (ot.is_integral or isinstance(
                ot, (T.FloatType, T.DoubleType, T.DateType,
                     T.TimestampType))):
            return f"a RANGE frame over a {ot.simpleString} order key"
    return None


def check_cpu_plan(node: PN.SparkPlan, why: str) -> None:
    """Raise ``NotOnGpu`` unless this engine runs ``node`` and its
    expressions (its children are checked where they are converted);
    ``why`` is the reason the node is not on the device."""
    if type(node) not in CPU_PLAN_NODES:
        raise NotOnGpu(f"{node.node_name} in a CPU stage ({why}), which "
                       "the port's CPU engine does not run")
    for f in node.output.fields:
        if isinstance(f.dataType, (T.ArrayType, T.MapType)):
            raise NotOnGpu(f"column {f.name} of type "
                           f"{f.dataType.simpleString} in a CPU stage "
                           f"({why}): the port's CPU engine holds no list "
                           f"column yet, so it does not run "
                           f"{node.node_name} in a CPU stage (ROADMAP "
                           "Queue 1 item 5)")
    what = (_unrun_aggregate(node) if isinstance(node, PN.HashAggregate)
            else _unrun_window(node) if isinstance(node, PN.Window)
            else None)
    if what is not None:
        raise NotOnGpu(f"{node.node_name} in a CPU stage ({why}): {what}, "
                       "which the port's CPU engine does not run")
    if isinstance(node, (PN.Exchange, PN.BroadcastExchange)):
        return                  # passed through: its keys are not read
    for e in _node_exprs(node):
        _check_expr(e, why)


def execute_cpu_plan(plan: PN.SparkPlan,
                     ansi: bool = False) -> Tuple[CpuBatch, int]:
    """Run a CPU plan; returns (columns, row count)."""
    if hasattr(plan, "materialize_cpu"):
        # TpuMaterializedScan: the device subtree under a CPU node
        return plan.materialize_cpu()
    if isinstance(plan, PN.LocalTableScan):
        cols = [CpuCol.from_host(h) for h in plan.host_columns]
        return cols, (cols[0].n if cols else 0)
    if isinstance(plan, PN.Project):
        cols, n = execute_cpu_plan(plan.child, ansi)
        return [eval_expr(e, cols, n, ansi) for e in plan.exprs], n
    if isinstance(plan, PN.Filter):
        cols, n = execute_cpu_plan(plan.child, ansi)
        pred = eval_expr(plan.condition, cols, n, ansi)
        keep = pred.values.astype(bool) & pred.validity
        return [c.take(keep) for c in cols], int(keep.sum())
    if isinstance(plan, PN.Union):
        parts = [execute_cpu_plan(c, ansi) for c in plan.children]
        cols = [CpuCol.concat([p[0][i] for p in parts])
                for i in range(len(parts[0][0]))]
        return cols, sum(p[1] for p in parts)
    if isinstance(plan, PN.HashAggregate):
        return _cpu_aggregate(plan, ansi)
    if isinstance(plan, PN._BaseJoin):
        return _cpu_join(plan, ansi)
    if isinstance(plan, PN.Sort):
        return _cpu_sort(plan, ansi)
    if isinstance(plan, PN.Window):
        return _cpu_window(plan, ansi)
    if isinstance(plan, (PN.GlobalLimit, PN.LocalLimit)):
        cols, n = execute_cpu_plan(plan.children[0], ansi)
        k = min(plan.n, n)
        return [c.take(slice(0, k)) for c in cols], k
    if isinstance(plan, (PN.Exchange, PN.BroadcastExchange)):
        return execute_cpu_plan(plan.children[0], ansi)
    raise NotOnGpu(f"plan node {plan.node_name} in a CPU stage")


# -- aggregate, hash join, sort, limit and window -----------------------------

class _HostInput:
    """The leaf that the device operators, run here on CPU tensors, read
    their device from (``TpuExec._device``)."""

    children: list = []
    device = torch.device("cpu")


def _empty_cols(schema: T.StructType) -> CpuBatch:
    return [CpuCol.from_host(HostColumn.from_pylist([], f.dataType))
            for f in schema.fields]


def _agg_exec(plan: PN.HashAggregate, ansi: bool):
    """The device aggregate over ``plan``'s functions, whose group-by,
    reduce, merge and finish (``exec/aggregate.py``) this engine runs on
    CPU tensors."""
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec

    agg = TpuHashAggregateExec(plan.grouping, plan.aggregates,
                               PN.AggregateMode.COMPLETE, None,
                               plan.child.output, plan.result_schema, ansi)
    agg.children = [_HostInput()]
    return agg


def _agg_inputs(plan: PN.HashAggregate, cols: CpuBatch, n: int, ansi: bool):
    """Each aggregate's input columns (CPU tensors): ``count(*)`` a column
    of ones, a string under ``avg`` or a variance parsed to doubles."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec.aggregate import string_input_as_double

    out = []
    for a in plan.aggregates:
        if a.child is None:
            out.append([DeviceColumn(T.LONG, torch.ones(n, dtype=torch.bool),
                                     data=torch.ones(n, dtype=torch.int64))])
            continue
        first = string_input_as_double(
            a, _to_torch(eval_expr(a.child, cols, n, ansi)), ansi)
        out.append([first] + ([_to_torch(eval_expr(a.child2, cols, n, ansi))]
                              if a.child2 is not None else []))
    return out


def _cpu_aggregate(plan: PN.HashAggregate, ansi: bool
                   ) -> Tuple[CpuBatch, int]:
    """The reference's ``_cpu_aggregate`` in each mode, vectorized: the
    device aggregate's sort-based group-by and segmented reductions on CPU
    tensors, so a CPU stage computes what the card computes.  COMPLETE
    reduces the rows and finishes; PARTIAL emits one buffer row per group
    (``HashAggregate.output``); FINAL merges buffer rows and finishes.  An
    empty grouped input gives no rows, an empty global one the device's
    row (counts 0, the rest null; a single-phase function's own row)."""
    from spark_rapids_tpu_torch.exec.aggregate import _null_column

    cols, n = execute_cpu_plan(plan.child, ansi)
    agg = _agg_exec(plan, ansi)
    mode = plan.mode
    if n == 0 and plan.grouping:
        return _empty_cols(plan.output), 0
    if n == 0:
        if mode == PN.AggregateMode.PARTIAL:
            inputs = [[_null_column(e.dataType, 1, "cpu") for e in
                       (a.child, a.child2) if e is not None]
                      or [_null_column(T.LONG, 1, "cpu")]
                      for a in plan.aggregates]
            out = agg._reduce([], inputs, torch.zeros(1, dtype=torch.bool),
                              False)
        elif any(a.func in PN.SINGLE_PHASE_FUNCS for a in plan.aggregates):
            out = agg._single_phase_empty()
        else:
            out = agg._global_agg_empty()
    else:
        mask = torch.ones(n, dtype=torch.bool)
        keys = [_to_torch(eval_expr(g, cols, n, ansi)) for g in plan.grouping]
        if mode == PN.AggregateMode.FINAL:
            k = len(plan.grouping)
            bufs = agg._split_buffer([_to_torch(c) for c in cols[k:]])
            out = agg._finish(agg._reduce(keys, bufs, mask, True))
        else:
            out = agg._reduce(keys, _agg_inputs(plan, cols, n, ansi), mask,
                              False)
            if mode == PN.AggregateMode.COMPLETE:
                out = agg._finish(out)
    return [_from_torch(c) for c in out.columns], out.num_rows


def _key_words(cols: CpuBatch) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The int64 key words of ``cols`` (``ops/sortkeys.py``: a string's
    bytes, then its length; a decimal128 both limbs; -0.0 with 0.0 and
    every NaN as one value) and where every key is valid."""
    from spark_rapids_tpu_torch.ops.sortkeys import _column_key_words

    words, valid = [], None
    for c in cols:
        d = _to_torch(c)
        words += _column_key_words(d)
        valid = d.validity if valid is None else valid & d.validity
    return words, valid


#: the most candidate pairs a residual condition is evaluated on at once
JOIN_PAIR_CHUNK = 1 << 22


def _join_matches(plan: PN._BaseJoin, lcols, nl, rcols, nr, ansi):
    """The matched (left, right) row pairs, left-major (each left row's
    right rows in the right side's order), of an equi-join: the right
    side's valid keys sorted, each left key's run found by binary search,
    the runs expanded and, with a residual condition, the condition
    evaluated on the pair table ``JOIN_PAIR_CHUNK`` pairs at a time.  A
    null key never matches; NaN matches NaN.  Without a condition a semi
    or anti join needs only whether a run is empty: (None, has-match)."""
    from spark_rapids_tpu_torch.ops.sortkeys import word_ranks

    lk = [eval_expr(k, lcols, nl, ansi) for k in plan.left_keys]
    rk = [eval_expr(k, rcols, nr, ansi) for k in plan.right_keys]
    for i, (a, b) in enumerate(zip(lk, rk)):
        if a.is_string:
            w = max(a.chars.shape[1], b.chars.shape[1])
            lk[i], rk[i] = a.with_width(w), b.with_width(w)
    if lk:
        lw, lvalid = _key_words(lk)
        rw, rvalid = _key_words(rk)
        words = [torch.cat([a, b]) for a, b in zip(lw, rw)]
        # one int64 a row, equal where every word is equal
        ids = words[0] if len(words) == 1 else word_ranks(words)[0]
        lid, rid = ids[:nl], ids[nl:]
    else:                      # a nested-loop or a cross join
        lid, rid = torch.zeros(nl, dtype=torch.int64), torch.zeros(
            nr, dtype=torch.int64)
        lvalid = torch.ones(nl, dtype=torch.bool)
        rvalid = torch.ones(nr, dtype=torch.bool)
    r_rows = torch.nonzero(rvalid).flatten()
    skey, order = torch.sort(rid[r_rows], stable=True)
    s_rows = r_rows[order]
    l_rows = torch.nonzero(lvalid).flatten()
    lkey = lid[l_rows]
    lo = torch.searchsorted(skey, lkey)
    cnt = torch.searchsorted(skey, lkey, right=True) - lo
    jt, J = plan.join_type, PN.JoinType
    if plan.condition is None and jt in (J.LEFT_SEMI, J.LEFT_ANTI):
        has = torch.zeros(nl, dtype=torch.bool)
        has[l_rows] = cnt > 0
        return None, has
    out_l, out_r = [], []
    ends = torch.cumsum(cnt, 0)
    start, m = 0, len(l_rows)
    while start < m:
        base = int(ends[start - 1]) if start else 0
        end = max(int(torch.searchsorted(ends, base + JOIN_PAIR_CHUNK,
                                         right=True)), start + 1)
        c = cnt[start:end]
        tot = int(c.sum())
        if tot:
            li = torch.repeat_interleave(l_rows[start:end], c)
            off = torch.arange(tot) - torch.repeat_interleave(
                torch.cumsum(c, 0) - c, c)
            ri = s_rows[torch.repeat_interleave(lo[start:end], c) + off]
            if plan.condition is not None:
                lin, rin = li.numpy(), ri.numpy()
                pairs = [x.take(lin) for x in lcols] + \
                    [x.take(rin) for x in rcols]
                pred = eval_expr(plan.condition, pairs, tot, ansi)
                ok = torch.from_numpy(pred.values.astype(bool)
                                      & pred.validity)
                li, ri = li[ok], ri[ok]
            out_l.append(li)
            out_r.append(ri)
        start = end
    empty = torch.zeros(0, dtype=torch.int64)
    return (torch.cat(out_l) if out_l else empty,
            torch.cat(out_r) if out_r else empty), None


def _cpu_join(plan: PN._BaseJoin, ansi: bool) -> Tuple[CpuBatch, int]:
    """The reference's ``_cpu_join`` for the sort-merge, shuffled hash and
    broadcast hash joins of every type, and its ``_cpu_bnlj`` for the
    nested-loop join (no keys: every pair a candidate), vectorized
    (``_join_matches``).  The condition applies on every type with
    Spark's meaning: an inner join keeps the pairs that pass it; a semi
    (anti) join keeps the left rows with (without) a pair that passes; an
    outer join gives a row whose every pair fails nulls on the other
    side.  The reference's oracle applies a hash join's condition to
    inner joins only (ROADMAP R26) and drops the unmatched right rows of
    a right or full outer nested-loop join (R5).  Output: the matched
    pairs left-major, then the unmatched left rows (left and full outer),
    then the unmatched right rows (right and full outer)."""
    lcols, nl = execute_cpu_plan(plan.left, ansi)
    rcols, nr = execute_cpu_plan(plan.right, ansi)
    jt, J = plan.join_type, PN.JoinType
    pairs, has = _join_matches(plan, lcols, nl, rcols, nr, ansi)
    if pairs is not None:
        li, ri = pairs
        has = torch.zeros(nl, dtype=torch.bool)
        has[li] = True
    if jt in (J.LEFT_SEMI, J.LEFT_ANTI):
        keep = (has if jt == J.LEFT_SEMI else ~has).numpy()
        return [c.take(keep) for c in lcols], int(keep.sum())
    lin, rin = li.numpy(), ri.numpy()
    out = [c.take(lin) for c in lcols] + [c.take(rin) for c in rcols]
    m = len(lin)
    if jt in (J.LEFT_OUTER, J.FULL_OUTER):
        um = ~has.numpy()
        k = int(um.sum())
        if k:
            out = [CpuCol.concat([o, c.take(um)])
                   for o, c in zip(out, lcols)] + \
                [CpuCol.concat([o, c.nulls(k)])
                 for o, c in zip(out[len(lcols):], rcols)]
            m += k
    if jt in (J.RIGHT_OUTER, J.FULL_OUTER):
        rhas = np.zeros(nr, np.bool_)
        rhas[rin] = True
        um = ~rhas
        k = int(um.sum())
        if k:
            out = [CpuCol.concat([o, c.nulls(k)])
                   for o, c in zip(out, lcols)] + \
                [CpuCol.concat([o, c.take(um)])
                 for o, c in zip(out[len(lcols):], rcols)]
            m += k
    return out, m


def _cpu_sort(plan: PN.Sort, ansi: bool) -> Tuple[CpuBatch, int]:
    """The reference's ``_cpu_sort``: one stable sort by the device's key
    words (``ops/sortkeys.py``): nulls first or last by each term, NaN the
    greatest value, -0.0 with 0.0, a string by its bytes, then its
    length, a descending term's words complemented."""
    from spark_rapids_tpu_torch.ops.sortkeys import sort_permutation

    cols, n = execute_cpu_plan(plan.child, ansi)
    keys = [_to_torch(eval_expr(e, cols, n, ansi)) for e, _ in plan.orders]
    perm = sort_permutation(keys, [s for _, s in plan.orders],
                            torch.ones(n, dtype=torch.bool)).numpy()
    return [c.take(perm) for c in cols], n


def _cpu_window(plan: PN.Window, ansi: bool) -> Tuple[CpuBatch, int]:
    """The reference's ``_cpu_window`` for the windows its rules keep off
    the device: the device window (``exec/window.py``) on CPU tensors,
    over the partition keys, order keys and inputs this engine evaluates.
    Its frames and functions are the reference oracle's (a RANGE frame's
    bounds over the first order key, as the oracle's ``_frame_rows``),
    with Spark's values where the oracle errs: ``avg`` and the variance
    family over a decimal read the scaled value (ROADMAP R27)."""
    import dataclasses as _dc

    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.exec.window import TpuWindowExec

    cols, n = execute_cpu_plan(plan.child, ansi)
    if n == 0:
        return cols + _empty_cols(T.StructType(
            plan.output.fields[len(cols):])), 0
    exprs = list(plan.partition_by) + [e for e, _ in plan.order_by] + [
        f.child for f in plan.functions if f.child is not None]
    dcols = [_to_torch(eval_expr(e, cols, n, ansi)) for e in exprs]
    refs = [BoundReference(i, e.dataType, e.nullable, e.sql_string())
            for i, e in enumerate(exprs)]
    npb, nob = len(plan.partition_by), len(plan.order_by)
    fns, i = [], npb + nob
    for f in plan.functions:
        if f.child is not None:
            f = _dc.replace(f, child=refs[i])
            i += 1
        fns.append(f)
    schema = T.StructType([T.StructField(f"_w{i}", e.dataType)
                           for i, e in enumerate(exprs)])
    win = TpuWindowExec(fns, refs[:npb],
                        [(r, s) for r, (_, s) in zip(refs[npb:npb + nob],
                                                     plan.order_by)],
                        None, schema, plan.frame, ansi)
    win.children = [_HostInput()]
    res = win._window(ColumnarBatch(dcols, n, schema))[len(dcols):]
    return cols + [_from_torch(c) for c in res], n

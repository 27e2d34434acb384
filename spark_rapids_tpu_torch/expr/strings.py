"""String expressions over the padded char-matrix layout — port of the part
of ``spark_rapids_tpu/expr/strings.py`` that TPC-H's predicates and
projections use: ``Length``, ``OctetLength``, ``BitLength``, ``Upper``,
``Lower``, ``Substring``, ``StringLeft``, ``StringRight``, ``Concat``,
``StartsWith``, ``EndsWith``, ``Contains``, ``StringInstr``,
``StringLocate``, ``StringTrim``/``StringTrimLeft``/``StringTrimRight``,
``Like`` (with ``try_compile_like``), ``ILike``, ``RLike`` and
``run_dfa``.

A string column is a ``(rows, width)`` uint8 matrix, int32 lengths and a
validity (``columnar/column.py``).  Every op is a dense transform of that
matrix: gathers along the width with index arithmetic, compares, and for
``LIKE`` patterns that are not a prefix, suffix, substring or exact test
(an inner ``%``, ``_``, an escape) the full-match DFA of the port's
transpiler (``regex/transpiler.py``), run one byte column at a time.
Byte arithmetic widens to int16 first (``ch - 32`` would wrap in uint8).

Semantics follow the reference's device path: ``Length`` and the
positions of ``instr``/``locate`` count UTF-8 code points;
``Substring``, ``left`` and ``right`` cut bytes (the same as characters
for ASCII); ``Upper``/``Lower`` and ``ILIKE``'s folding are ASCII only;
the trims strip spaces (0x20) only.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    _fit_chars as _pad_to)
from spark_rapids_tpu_torch.expr.base import (BinaryExpression, Expression,
                                              Literal, UnaryExpression)

#: the most elements one chunk of ``_first_match_pos``'s start positions
#: gathers: (rows x starts x needle width) bytes, about 256 MB
_MATCH_SCRATCH = 1 << 28


def _positions(c: DeviceColumn, width: int = None) -> torch.Tensor:
    """(1, width) int64 byte positions."""
    return torch.arange(c.width if width is None else width,
                        device=c.device)[None, :]


def _in_str(c: DeviceColumn) -> torch.Tensor:
    """(rows, width) bool: the byte lies inside the row's string."""
    return _positions(c) < c.lengths[:, None]


def _take_window(c: DeviceColumn, start: torch.Tensor,
                 out_len: torch.Tensor) -> torch.Tensor:
    """Each row's bytes [start, start + out_len) at the row's front, zero
    past it, at the column's width."""
    w = c.width
    pos = _positions(c)
    idx = (start.to(torch.int64)[:, None] + pos).clamp(0, w - 1)
    g = c.chars.gather(1, idx)
    return torch.where(pos < out_len[:, None], g, 0).to(torch.uint8)


def _needle(text: str, like: DeviceColumn) -> DeviceColumn:
    """A literal string as a column of ``like``'s rows (one row of bytes,
    expanded), as ``Literal.eval_tpu`` builds it."""
    b = text.encode("utf-8")
    row = np.zeros(max(len(b), 1), np.uint8)
    row[:len(b)] = np.frombuffer(b, np.uint8)
    n, dev = like.capacity, like.device
    return DeviceColumn(
        T.STRING, torch.ones((), dtype=torch.bool, device=dev).expand(n),
        chars=torch.from_numpy(row).to(dev).expand(n, len(row)),
        lengths=torch.tensor(len(b), dtype=torch.int32,
                             device=dev).expand(n))


class Length(UnaryExpression):
    """UTF-8 code-point count (Spark ``length``), not byte count."""

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        # bytes that are not UTF-8 continuation bytes (0b10xxxxxx)
        is_cont = (c.chars & 0xC0) == 0x80
        n = (_in_str(c) & ~is_cont).sum(dim=1)
        return DeviceColumn(T.INT, c.validity, data=n.to(torch.int32))


class OctetLength(UnaryExpression):
    """octet_length(str): the byte count (the layout stores it)."""

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.INT, c.validity, data=c.lengths)


class BitLength(UnaryExpression):
    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        return DeviceColumn(T.INT, c.validity, data=c.lengths * 8)


def _shift_case(c: DeviceColumn, lo: str, hi: str,
                delta: int) -> DeviceColumn:
    """The bytes in [lo, hi] moved by ``delta`` (in int16: a uint8
    ``ch - 32`` would wrap)."""
    ch = c.chars.to(torch.int16)
    ch = torch.where((ch >= ord(lo)) & (ch <= ord(hi)), ch + delta, ch)
    return DeviceColumn(T.STRING, c.validity, chars=ch.to(torch.uint8),
                        lengths=c.lengths)


class Upper(UnaryExpression):
    """ASCII-only case conversion, as the reference's."""

    case = ("a", "z", -32)

    def _resolve_type(self):
        self._dataType = T.STRING
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        return _shift_case(cols[0], *self.case)


class Lower(Upper):
    case = ("A", "Z", 32)


class Substring(Expression):
    """substring(str, pos, len) with Spark's 1-based and negative ``pos``:
    the window [start, start + len) is taken on the unclamped start, then
    clipped to the string, so a start before the string eats length.
    Byte-based, as the reference's device path (the same as characters
    for ASCII)."""

    def __init__(self, s: Expression, pos: Expression, length: Expression):
        super().__init__([s, pos, length])

    def _resolve_type(self):
        self._dataType = T.STRING
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c, p, ln = cols
        n = c.lengths.to(torch.int64)
        pos = p.data.to(torch.int64)
        start0 = torch.where(pos > 0, pos - 1,
                             torch.where(pos < 0, n + pos, 0))
        end0 = start0 + ln.data.to(torch.int64).clamp(min=0)
        zero = torch.zeros_like(n)
        start = torch.minimum(torch.maximum(start0, zero), n)
        out_len = (torch.minimum(torch.maximum(end0, zero), n)
                   - start).clamp(min=0)
        return DeviceColumn(T.STRING, c.validity & p.validity & ln.validity,
                            chars=_take_window(c, start, out_len),
                            lengths=out_len.to(torch.int32))


class _LeftRight(BinaryExpression):
    def _resolve_type(self):
        self._dataType = T.STRING
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        c, k = cols
        n = c.lengths.to(torch.int64)
        take_n = torch.minimum(k.data.to(torch.int64).clamp(min=0), n)
        return DeviceColumn(T.STRING, c.validity & k.validity,
                            chars=_take_window(c, self._start(n, take_n),
                                               take_n),
                            lengths=take_n.to(torch.int32))


class StringLeft(_LeftRight):
    """left(str, n): the first n bytes (ASCII-exact)."""

    def _start(self, n, take_n):
        return torch.zeros_like(n)


class StringRight(_LeftRight):
    """right(str, n): the last n bytes (ASCII-exact)."""

    def _start(self, n, take_n):
        return n - take_n


class Concat(Expression):
    """concat(s1, s2, ...): null if any input is null (Spark); the output
    width is the sum of the inputs' widths."""

    def __init__(self, children: List[Expression]):
        super().__init__(children)

    def _resolve_type(self):
        self._dataType = T.STRING
        self._nullable = any(c.nullable for c in self.children)

    def do_columnar_eval(self, ctx, cols):
        total_w = sum(c.width for c in cols)
        first = cols[0]
        out = torch.zeros((first.capacity, total_w), dtype=torch.uint8,
                          device=first.device)
        out_len = torch.zeros(first.capacity, dtype=torch.int64,
                              device=first.device)
        validity = first.validity
        for c in cols[1:]:
            validity = validity & c.validity
        pos = _positions(first, total_w)
        for c in cols:
            # output byte j takes c's byte j - out_len
            src_idx = pos - out_len[:, None]
            write = (src_idx >= 0) & (src_idx < c.lengths[:, None])
            src = _pad_to(c.chars, total_w).gather(
                1, src_idx.clamp(0, total_w - 1))
            out = torch.where(write, src, out)
            out_len = out_len + c.lengths
        return DeviceColumn(T.STRING, validity, chars=out,
                            lengths=out_len.to(torch.int32))


class _FixedCompare(BinaryExpression):
    """contains/startswith/endswith with an arbitrary (usually literal)
    needle."""

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = True


def _starts_with(s: DeviceColumn, pre: DeviceColumn) -> torch.Tensor:
    w = max(s.width, pre.width)
    a, b = _pad_to(s.chars, w), _pad_to(pre.chars, w)
    relevant = _positions(s, w) < pre.lengths[:, None]
    return (~relevant | (a == b)).all(dim=1) & (s.lengths >= pre.lengths)


def _ends_with(s: DeviceColumn, suf: DeviceColumn) -> torch.Tensor:
    sw = suf.width
    start = (s.lengths - suf.lengths).to(torch.int64)
    idx = (start[:, None] + _positions(s, sw)).clamp(0, s.width - 1)
    gathered = s.chars.gather(1, idx)
    relevant = _positions(s, sw) < suf.lengths[:, None]
    eq = (~relevant | (gathered == suf.chars)).all(dim=1)
    return eq & (s.lengths >= suf.lengths)


class StartsWith(_FixedCompare):
    def do_columnar_eval(self, ctx, cols):
        s, pre = cols
        return DeviceColumn(T.BOOLEAN, s.validity & pre.validity,
                            data=_starts_with(s, pre))


class EndsWith(_FixedCompare):
    def do_columnar_eval(self, ctx, cols):
        s, suf = cols
        return DeviceColumn(T.BOOLEAN, s.validity & suf.validity,
                            data=_ends_with(s, suf))


class Contains(_FixedCompare):
    def do_columnar_eval(self, ctx, cols):
        s, needle = cols
        if isinstance(self.right, Literal) and self.right.value is not None:
            data = _match_literal_at(
                s, str(self.right.value).encode("utf-8")).any(dim=1)
        else:
            data = _first_match_pos(s, needle) > 0
        return DeviceColumn(T.BOOLEAN, s.validity & needle.validity,
                            data=data)


def _match_literal_at(c: DeviceColumn, needle: bytes) -> torch.Tensor:
    """(rows, width) bool: ``needle`` matches starting at byte i."""
    w = c.width
    m = torch.ones((c.capacity, w), dtype=torch.bool, device=c.device)
    for k, b in enumerate(needle):
        if k >= w:
            m = torch.zeros_like(m)
            break
        shifted = torch.nn.functional.pad(c.chars[:, k:], (0, k))
        m = m & (shifted == b)
    return m & (_positions(c) + len(needle) <= c.lengths[:, None])


def _first_match_pos(s: DeviceColumn, needle: DeviceColumn,
                     from_idx=None) -> torch.Tensor:
    """1-based CHARACTER position of the first ``needle`` occurrence at or
    after character index ``from_idx`` (0-based, per row), 0 if absent;
    an empty needle gives 1 whatever the start.  Spark's instr and locate
    count code points (``UTF8String.indexOf``): matching is byte-wise,
    positions count the bytes that are not UTF-8 continuation bytes.

    Start positions are scanned in chunks, each a gather of every row's
    needle-wide window at each start of the chunk and one compare; the
    chunk size caps that scratch at about 256 MB (``_MATCH_SCRATCH``).
    No host sync."""
    w, nw, cap = s.width, needle.width, s.capacity
    dev = s.device
    relevant = _positions(s, nw) < needle.lengths[:, None]       # (cap, nw)
    noncont = (s.chars < 0x80) | (s.chars >= 0xC0)
    before = None
    if from_idx is not None:
        nc = noncont.to(torch.int32)
        before = nc.cumsum(dim=1, dtype=torch.int32) - nc          # (cap, w)
    chunk = max(1, min(w, _MATCH_SCRATCH // max(cap * nw, 1)))
    found = torch.zeros(cap, dtype=torch.bool, device=dev)
    first = torch.zeros(cap, dtype=torch.int64, device=dev)
    offs = torch.arange(nw, device=dev)[None, :]
    for lo in range(0, w, chunk):
        k = min(chunk, w - lo)
        starts = torch.arange(lo, lo + k, device=dev)
        idx = (starts[:, None] + offs).clamp(max=w - 1)            # (k, nw)
        seg = s.chars[:, idx.reshape(-1)].reshape(cap, k, nw)
        eq = (~relevant[:, None, :]
              | (seg == needle.chars[:, None, :])).all(dim=2)      # (cap, k)
        hit = eq & (starts[None, :] + needle.lengths[:, None]
                    <= s.lengths[:, None])
        if before is not None:
            hit = hit & (before[:, lo:lo + k] >= from_idx[:, None])
        has = hit.any(dim=1)
        j = hit.to(torch.uint8).argmax(dim=1) + lo
        first = torch.where(has & ~found, j, first)
        found = found | has
    # characters before the first matching byte, plus one
    cpos = (noncont & (_positions(s) < first[:, None])).sum(dim=1) + 1
    out = torch.where(found, cpos, 0)
    return torch.where(needle.lengths == 0, 1, out).to(torch.int32)


class StringInstr(BinaryExpression):
    """instr(str, substr): 1-based first occurrence; 0 if absent."""

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        s, needle = cols
        return DeviceColumn(T.INT, s.validity & needle.validity,
                            data=_first_match_pos(s, needle))


class StringLocate(Expression):
    """locate(substr, str, start): a start below 1 or null gives 0 (valid);
    an empty substr gives 1."""

    def __init__(self, substr: Expression, s: Expression, start: Expression):
        super().__init__([substr, s, start])

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        needle, s, st = cols
        start = st.data.to(torch.int64)
        first = _first_match_pos(s, needle, (start - 1).clamp(min=0))
        out = torch.where(st.validity & (start >= 1), first, 0)
        return DeviceColumn(T.INT, s.validity & needle.validity,
                            data=out.to(torch.int32))


class StringTrimLeft(UnaryExpression):
    """ltrim(s): strips leading spaces (Spark trims 0x20 only)."""

    left, right = True, False

    def _resolve_type(self):
        self._dataType = T.STRING
        self._nullable = self.child.nullable

    def do_columnar_eval(self, ctx, cols):
        c = cols[0]
        n = c.lengths.to(torch.int64)
        nonws = _in_str(c) & (c.chars != ord(" "))
        any_nonws = nonws.any(dim=1)
        nonws = nonws.to(torch.uint8)
        first = torch.where(any_nonws, nonws.argmax(dim=1), 0) \
            if self.left else torch.zeros_like(n)
        end = torch.where(any_nonws,
                          c.width - nonws.flip(1).argmax(dim=1), 0) \
            if self.right else n
        out_len = torch.where(any_nonws, end - first, 0)
        return DeviceColumn(T.STRING, c.validity,
                            chars=_take_window(c, first, out_len),
                            lengths=out_len.to(torch.int32))


class StringTrimRight(StringTrimLeft):
    """rtrim(s)."""

    left, right = False, True


class StringTrim(StringTrimLeft):
    """trim(s): both sides."""

    left, right = True, True


class Like(BinaryExpression):
    """SQL ``LIKE`` with a literal pattern: a prefix, suffix, substring or
    exact test where the pattern is one (no ``_``, no escape, ``%`` only
    at its ends), else the full-match DFA of ``like_to_regex`` — compiled
    at tag time (``overrides/meta.py::_check_like`` stashes it as
    ``_dfa``) or at first use."""

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        s = cols[0]
        p: str = self.right.value
        return DeviceColumn(T.BOOLEAN, s.validity, data=_like(self, s, p))


def _like(e: Expression, s: DeviceColumn, p: str) -> torch.Tensor:
    if "_" not in p and "\\" not in p and "%" not in p.strip("%"):
        core = p.strip("%")
        if p.startswith("%") and p.endswith("%"):
            return _match_literal_at(s, core.encode("utf-8")).any(dim=1)
        needle = _needle(core, s)
        if p.endswith("%"):
            return _starts_with(s, needle)
        if p.startswith("%"):
            return _ends_with(s, needle)
        from spark_rapids_tpu_torch.expr.predicates import string_compare

        return string_compare(s, needle)[1]
    from spark_rapids_tpu_torch.regex import compile_regex, like_to_regex

    compiled = getattr(e, "_dfa", None)
    if compiled is None:
        compiled = e._dfa = compile_regex(like_to_regex(p), full_match=True)
    return run_dfa(s, compiled)


def try_compile_like(p):
    """-> (supported, compiled or None).  The fast paths (prefix, suffix,
    contains, exact) need no DFA; every other pattern (``_``, an inner
    ``%``, an escape) compiles to a full-match DFA, returned so that the
    tag-time caller can stash it on the expression."""
    if p is None:
        return False, None
    if "_" not in p and "\\" not in p:
        core = p.strip("%")
        if "%" not in core:
            return True, None
    from spark_rapids_tpu_torch.regex import (RegexUnsupported,
                                              compile_regex, like_to_regex)

    try:
        return True, compile_regex(like_to_regex(p), full_match=True)
    except (RegexUnsupported, ValueError):
        # an invalid escape fails the same way in the CPU stage
        return False, None


class ILike(Like):
    """ILIKE: ASCII-lower both the data and the pattern, then ``Like``'s
    machinery (the tag-time compilation of the lowered pattern reused)."""

    def do_columnar_eval(self, ctx, cols):
        s = cols[0]
        return DeviceColumn(T.BOOLEAN, s.validity, data=_like(
            self, _shift_case(s, *Lower.case), str(self.right.value).lower()))


def run_dfa(c: DeviceColumn, compiled) -> torch.Tensor:
    """Run a compiled DFA over every row -> (rows,) bool matched.

    One step per byte column, on the chars transposed once so that each
    step reads one contiguous column: a gather from the flat (states x
    256) table at ``state * 256 + byte``, rows past their length keeping
    their state.  No host sync."""
    dev = c.device
    table = torch.from_numpy(compiled.table.reshape(-1).astype(
        np.int64)).to(dev)
    accept = torch.from_numpy(compiled.accept).to(dev)
    state = torch.zeros(c.capacity, dtype=torch.int64, device=dev)
    cols = c.chars.t().contiguous()
    for j in range(c.width):
        nxt = table.take(state * 256 + cols[j])
        state = torch.where(c.lengths > j, nxt, state)
    return accept[state]


class RLike(BinaryExpression):
    """str RLIKE pattern (a literal), transpiled to a find-anywhere DFA at
    tag time (``_check_rlike``) or at first use."""

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = True

    def _compiled(self):
        from spark_rapids_tpu_torch.regex import compile_regex

        cached = getattr(self, "_dfa", None)
        if cached is None:
            cached = self._dfa = compile_regex(self.right.value)
        return cached

    def do_columnar_eval(self, ctx, cols):
        s = cols[0]
        return DeviceColumn(T.BOOLEAN, s.validity,
                            data=run_dfa(s, self._compiled()))

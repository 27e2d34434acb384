"""Regex transpiler: a Java-regex subset -> a byte DFA — the port's own copy
of ``spark_rapids_tpu/regex/transpiler.py`` (numpy and the standard
library only, so it is copied, not imported).

Supported patterns compile to a **DFA table** (Thompson NFA, then subset
construction), and matching is one pass over the padded char matrix: a
step per byte column, one gather into the flat (states x 256) table,
vectorized across rows (``expr/strings.py::run_dfa``).  Patterns that
cannot compile (backrefs, lookaround, lazy/possessive quantifiers, word
boundaries, huge counted repetitions, non-ASCII) raise ``RegexUnsupported``
at plan time, and the tagging keeps the expression in a CPU stage, the
reference's transpiler-reject path.

Byte-level semantics: ASCII patterns over UTF-8 bytes.  Since supported
patterns are ASCII-only, byte-wise matching agrees with Java's char-wise
matching on any input (UTF-8 continuation bytes >= 0x80 never collide with
ASCII classes).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

MAX_NFA_STATES = 2000
MAX_DFA_STATES = 256


class RegexUnsupported(Exception):
    """Pattern cannot run on the device; the plan-time fallback signal."""


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RLit:           # one byte-class
    mask: np.ndarray  # (256,) bool


@dataclasses.dataclass
class RSeq:
    parts: List


@dataclasses.dataclass
class RAlt:
    options: List


@dataclasses.dataclass
class RRep:           # {lo, hi} repetition; hi=None -> unbounded
    node: object
    lo: int
    hi: Optional[int]


def _ascii_mask(*ranges) -> np.ndarray:
    m = np.zeros(256, np.bool_)
    for lo, hi in ranges:
        m[lo:hi + 1] = True
    return m


_ASCII = _ascii_mask((0, 127))
_DIGIT = _ascii_mask((ord("0"), ord("9")))
_WORD = _ascii_mask((ord("0"), ord("9")), (ord("a"), ord("z")),
                    (ord("A"), ord("Z")), (ord("_"), ord("_")))
_SPACE = np.zeros(256, np.bool_)
for _c in " \t\n\x0b\f\r":
    _SPACE[ord(_c)] = True

# ASCII-positive classes stay plain byte classes; complements must also
# match multi-byte UTF-8 characters (Java matches per CHAR, we per byte)
_ESCAPE_CLASSES = {"d": _DIGIT, "w": _WORD, "s": _SPACE}
_COMPLEMENT_CLASSES = {"D": _DIGIT, "W": _WORD, "S": _SPACE}


def _utf8_multibyte_node():
    """One non-ASCII UTF-8 character: lead byte + continuation bytes.
    This is how a byte DFA counts CHARACTERS like Java does."""
    cont = RLit(_ascii_mask((0x80, 0xBF)))
    two = RSeq([RLit(_ascii_mask((0xC2, 0xDF))), cont])
    three = RSeq([RLit(_ascii_mask((0xE0, 0xEF))), cont, cont])
    four = RSeq([RLit(_ascii_mask((0xF0, 0xF4))), cont, cont, cont])
    return RAlt([two, three, four])


def _char_node(ascii_mask: np.ndarray, include_non_ascii: bool):
    """A one-CHARACTER matcher: ASCII byte class, plus (for complements /
    any-char) every multi-byte UTF-8 character."""
    lit = RLit(ascii_mask & _ASCII)
    if not include_non_ascii:
        return lit
    return RAlt([lit, _utf8_multibyte_node()])


def _dot_node():
    m = _ASCII.copy()
    m[ord("\n")] = False
    m[ord("\r")] = False  # Java `.` excludes line terminators
    return _char_node(m, include_non_ascii=True)
_ESCAPE_LITERALS = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "a": "\x07",
                    "e": "\x1b", "0": "\0"}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.depth = 0          # group nesting depth
        self.top_alt = False    # pattern has a `|` at depth 0

    def error(self, why: str):
        raise RegexUnsupported(f"regex {self.p!r}: {why} (at {self.i})")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    # -- grammar ------------------------------------------------------------
    def parse(self):
        """-> (node, anchored_start, anchored_end)"""
        anchored_start = False
        if self.peek() == "^":
            self.next()
            anchored_start = True
        node = self.alternation()
        if anchored_start and self.top_alt:
            # Java precedence binds a leading `^` to the FIRST branch only
            # (`^a|b` == `(^a)|b`); the DFA anchor flag is whole-pattern, so
            # compiling this would silently anchor every branch.  Reject at
            # plan time -> CPU fallback, like mid-pattern `^`/`$`.
            # (`^(a|b)` is fine: the alternation is inside a group.)
            self.error("`^` binds to the first alternation branch only")
        anchored_end = False
        # `$` only meaningful at the very end (deeper `$`s are rejected in
        # atom())
        if self.i != len(self.p):
            self.error("unexpected trailing input")
        if isinstance(node, RSeq) and node.parts and node.parts[-1] == "$":
            node.parts.pop()
            anchored_end = True
        elif node == "$":
            node = RSeq([])
            anchored_end = True
        return node, anchored_start, anchored_end

    def alternation(self):
        opts = [self.sequence()]
        while self.peek() == "|":
            self.next()
            opts.append(self.sequence())
        if len(opts) > 1 and self.depth == 0:
            self.top_alt = True
        return opts[0] if len(opts) == 1 else RAlt(opts)

    def sequence(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.quantified())
        if len(parts) == 1:
            return parts[0]
        return RSeq(parts)

    def quantified(self):
        atom = self.atom()
        c = self.peek()
        if c not in ("*", "+", "?", "{"):
            return atom
        if atom == "$":
            self.error("quantifier on `$` anchor")
        if c == "{":
            lo, hi = self.counted()
        else:
            self.next()
            lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[c]
        nxt = self.peek()
        if nxt in ("?", "+"):
            self.error("lazy/possessive quantifiers are not supported")
        if nxt in ("*", "{") or (nxt == "?"):
            self.error("double quantifier")
        return RRep(atom, lo, hi)

    def counted(self) -> Tuple[int, Optional[int]]:
        assert self.next() == "{"
        body = ""
        while self.peek() is not None and self.peek() != "}":
            body += self.next()
        if self.peek() != "}":
            self.error("unterminated {")
        self.next()
        try:
            if "," not in body:
                lo = hi = int(body)
            else:
                l, h = body.split(",", 1)
                lo = int(l)
                hi = int(h) if h.strip() else None
        except ValueError:
            self.error(f"bad counted repetition {{{body}}}")
        if lo < 0 or (hi is not None and hi < 0):
            self.error(f"negative repetition bound {{{body}}}")
        if lo > 100 or (hi is not None and hi > 100):
            raise RegexUnsupported(
                f"counted repetition {{{body}}} too large for DFA expansion")
        if hi is not None and hi < lo:
            self.error("{m,n} with n < m")
        return lo, hi

    def atom(self):
        c = self.next()
        if c == "(":
            if self.peek() == "?":
                self.next()
                if self.peek() == ":":
                    self.next()
                else:
                    self.error("lookaround / named groups are not supported")
            self.depth += 1
            node = self.alternation()
            self.depth -= 1
            if self.peek() != ")":
                self.error("unterminated group")
            self.next()
            return node
        if c == "[":
            return self.char_class()
        if c == ".":
            return _dot_node()
        if c == "\\":
            return self.escape()
        if c == "$":
            # legal only at the very end / end of alternation branch
            if self.peek() not in (None, "|", ")"):
                self.error("`$` mid-pattern is not supported")
            return "$"
        if c == "^":
            self.error("`^` mid-pattern is not supported")
        if c in "*+?{":
            self.error(f"dangling quantifier {c!r}")
        if ord(c) > 127:
            raise RegexUnsupported(f"non-ASCII literal {c!r}")
        m = np.zeros(256, np.bool_)
        m[ord(c)] = True
        return RLit(m)

    def escape(self):
        c = self.peek()
        if c is None:
            self.error("trailing backslash")
        self.next()
        if c in _ESCAPE_CLASSES:
            return RLit(_ESCAPE_CLASSES[c].copy())
        if c in _COMPLEMENT_CLASSES:
            base = _COMPLEMENT_CLASSES[c]
            return _char_node(~base & _ASCII, include_non_ascii=True)
        if c in _ESCAPE_LITERALS:
            m = np.zeros(256, np.bool_)
            m[ord(_ESCAPE_LITERALS[c])] = True
            return RLit(m)
        if c in ("b", "B", "A", "Z", "z", "G"):
            raise RegexUnsupported(f"\\{c} boundary matchers not supported")
        if c.isdigit():
            raise RegexUnsupported("backreferences are not supported")
        if c.isalpha():
            raise RegexUnsupported(f"escape \\{c} not supported")
        m = np.zeros(256, np.bool_)
        m[ord(c)] = True
        return RLit(m)

    def char_class(self):
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        mask = np.zeros(256, np.bool_)
        non_ascii = False  # class also matches multi-byte UTF-8 chars
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            self.next()
            if c == "\\":
                e = self.peek()
                if e in _ESCAPE_CLASSES:
                    self.next()
                    mask |= _ESCAPE_CLASSES[e]
                    continue
                if e in _COMPLEMENT_CLASSES:
                    self.next()
                    mask |= ~_COMPLEMENT_CLASSES[e] & _ASCII
                    non_ascii = True
                    continue
                sub = self.escape()
                if not isinstance(sub, RLit):
                    self.error("unsupported escape in character class")
                lo_ch = int(np.argmax(sub.mask))
            else:
                if ord(c) > 127:
                    raise RegexUnsupported(f"non-ASCII literal {c!r}")
                lo_ch = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.next()
                hi_c = self.next()
                if hi_c == "\\":
                    hi_sub = self.escape()
                    if not isinstance(hi_sub, RLit):
                        self.error("unsupported escape in character class")
                    hi_ch = int(np.argmax(hi_sub.mask))
                else:
                    hi_ch = ord(hi_c)
                if hi_ch < lo_ch:
                    self.error("bad character range")
                mask[lo_ch:hi_ch + 1] = True
            else:
                mask[lo_ch] = True
        if negate:
            # Java [^...] matches any CHAR not listed — including every
            # non-ASCII character, realized as the multi-byte alternation
            mask = ~mask & _ASCII
            non_ascii = not non_ascii
        return _char_node(mask, include_non_ascii=non_ascii)


# ---------------------------------------------------------------------------
# NFA (Thompson construction)
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []      # eps[s] -> targets
        self.trans: List[Tuple[int, np.ndarray, int]] = []  # (src, mask, dst)

    def new_state(self) -> int:
        if len(self.eps) >= MAX_NFA_STATES:
            raise RegexUnsupported("pattern too large (NFA state cap)")
        self.eps.append([])
        return len(self.eps) - 1

    def build(self, node) -> Tuple[int, int]:
        """-> (start, accept) fragment."""
        if node == "$":
            raise RegexUnsupported("`$` in unsupported position")
        if isinstance(node, RLit):
            s, a = self.new_state(), self.new_state()
            self.trans.append((s, node.mask, a))
            return s, a
        if isinstance(node, RSeq):
            s = a = self.new_state()
            for part in node.parts:
                ps, pa = self.build(part)
                self.eps[a].append(ps)
                a = pa
            return s, a
        if isinstance(node, RAlt):
            s, a = self.new_state(), self.new_state()
            for opt in node.options:
                os_, oa = self.build(opt)
                self.eps[s].append(os_)
                self.eps[oa].append(a)
            return s, a
        if isinstance(node, RRep):
            s = a = self.new_state()
            for _ in range(node.lo):
                ps, pa = self.build(node.node)
                self.eps[a].append(ps)
                a = pa
            if node.hi is None:
                ls, la = self.build(node.node)
                self.eps[a].append(ls)
                self.eps[la].append(a)  # loop
            else:
                end = self.new_state()
                self.eps[a].append(end)
                for _ in range(node.hi - node.lo):
                    ps, pa = self.build(node.node)
                    self.eps[a].append(ps)
                    self.eps[pa].append(end)
                    a = pa
                a = end
            return s, a
        raise AssertionError(f"unknown node {node}")


def _closure(states: frozenset, eps) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


# ---------------------------------------------------------------------------
# Compile: pattern -> DFA table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompiledRegex:
    table: np.ndarray    # (n_states, 256) int32
    accept: np.ndarray   # (n_states,) bool
    n_states: int


def compile_regex(pattern: str, full_match: bool = False) -> CompiledRegex:
    """Compile for RLike (find-anywhere) or full-match semantics.

    find semantics = implicit `.*` on each un-anchored side; the trailing
    `.*` is realized by making accept states absorbing.
    """
    node, anch_start, anch_end = _Parser(pattern).parse()
    if full_match:
        anch_start = anch_end = True
    elif anch_end:
        # Java (and Python) `$` also matches just before a FINAL line
        # terminator: "a$" finds a match in "a\n" / "a\r\n" / "a\r"
        nl = np.zeros(256, np.bool_)
        nl[ord("\n")] = True
        cr = np.zeros(256, np.bool_)
        cr[ord("\r")] = True
        term = RAlt([RSeq([RLit(cr), RLit(nl)]), RLit(nl), RLit(cr)])
        node = RSeq([node, RRep(term, 0, 1)])
    nfa = _NFA()
    start, accept = nfa.build(node)
    if not anch_start:
        # self-loop on any byte at a new start state feeding the fragment
        s0 = nfa.new_state()
        nfa.trans.append((s0, np.ones(256, np.bool_), s0))
        nfa.eps[s0].append(start)
        start = s0
    # byte equivalence classes to keep subset construction fast
    tmasks = [m for (_, m, _) in nfa.trans]
    if tmasks:
        sig = np.stack(tmasks, axis=0)          # (T, 256)
        _, classes = np.unique(sig, axis=1, return_inverse=True)
    else:
        classes = np.zeros(256, np.int64)
    n_classes = int(classes.max()) + 1
    class_rep = [int(np.argmax(classes == k)) for k in range(n_classes)]

    d0 = _closure(frozenset([start]), nfa.eps)
    dfa_states = {d0: 0}
    order = [d0]
    table_c = []  # per state: per class target
    accepting = []
    i = 0
    while i < len(order):
        S = order[i]
        i += 1
        is_acc = accept in S
        accepting.append(is_acc)
        row = []
        for k in range(n_classes):
            b = class_rep[k]
            if is_acc and not anch_end:
                row.append(-1)  # absorbing accept, patched below
                continue
            tgt = frozenset(
                d for (src, m, d) in nfa.trans if src in S and m[b])
            tgt = _closure(tgt, nfa.eps)
            if not tgt:
                row.append(-2)  # dead
                continue
            if tgt not in dfa_states:
                if len(dfa_states) >= MAX_DFA_STATES:
                    raise RegexUnsupported(
                        "pattern too complex (DFA state cap)")
                dfa_states[tgt] = len(order)
                order.append(tgt)
            row.append(dfa_states[tgt])
        table_c.append(row)
    n = len(order)
    dead = n           # explicit dead state (self-loop, non-accepting)
    absorb = n + 1     # absorbing accept state
    table = np.zeros((n + 2, 256), np.int32)
    acc = np.zeros(n + 2, np.bool_)
    acc[absorb] = True
    table[dead, :] = dead
    table[absorb, :] = absorb
    for si, row in enumerate(table_c):
        acc[si] = accepting[si]
        for k, t in enumerate(row):
            bs = classes == k
            if t == -1:
                table[si, bs] = absorb
            elif t == -2:
                table[si, bs] = dead
            else:
                table[si, bs] = t
    return CompiledRegex(table=table, accept=acc, n_states=n + 2)


def like_to_regex(pattern: str, escape: str = "\\") -> str:
    """SQL LIKE pattern -> regex (full-match), honoring the escape char.

    Spark only permits the escape char before '%', '_' or itself
    (StringUtils.escapeLikeRegex); anything else is an invalid pattern."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape:
            if i + 1 >= len(pattern):
                raise ValueError(
                    f"the LIKE pattern {pattern!r} ends with the escape "
                    f"character")
            nxt = pattern[i + 1]
            if nxt not in ("%", "_", escape):
                raise ValueError(
                    f"the LIKE pattern {pattern!r} has an invalid escape "
                    f"sequence {escape + nxt!r}")
            out.append("\\" + nxt if nxt in ".^$*+?()[]{}|\\" else nxt)
            i += 2
            continue
        if c == "%":
            out.append(r"[\s\S]*")  # Spark LIKE wildcards span newlines
        elif c == "_":
            out.append(r"[\s\S]")
        elif c in ".^$*+?()[]{}|\\":
            out.append("\\" + c)
        else:
            out.append(c)
        i += 1
    return "".join(out)

"""Fingerprints of plan pieces — the part of
``spark_rapids_tpu/compilecache/keys.py`` that the query journal and the
hot-table cache read.

The reference keys its shared compiled programs with these; the port
compiles no programs, so here they key what must never be mixed up across
plans: a stage checkpoint (``exec/exchange.py::_registry_scope``) and a
cached scan (``io/hot_cache.py``).  A key errs on the side of including too
much: a spurious difference costs a miss, a collision serves another
plan's rows.  Every key is built from the expression list (SQL string and
result type per node), the schema (name and type per field), static mode
flags passed by the call site, and the conf's fingerprint.

Expressions that close over Python state are not fingerprintable: two
different lambdas can print the same SQL.  ``exprs_fp`` returns None for
those and the caller does without a key.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, Optional

from spark_rapids_tpu_torch import types as T


def fingerprint(*parts) -> str:
    """Stable digest of an arbitrary (repr-able) part tuple."""
    h = hashlib.sha1(repr(parts).encode("utf-8", "replace"))
    return h.hexdigest()


def schema_fp(schema: Optional[T.StructType]):
    """Schema fingerprint: (name, type) per field.  Nullability is left
    out, as in the reference: materialized batches upgrade plan-declared
    non-nullable fields to nullable, and the programs never read it."""
    if schema is None:
        return None
    return tuple((f.name, str(f.dataType)) for f in schema.fields)


# expressions whose result depends on per-instance or per-batch state that
# sql_string() cannot capture (row offsets, the current file, seeds)
_UNSAFE_EXPR_CLASSES = frozenset({
    "MonotonicallyIncreasingID", "SparkPartitionID", "InputFileName",
    "InputFileBlockStart", "InputFileBlockLength", "Rand", "Uuid",
})


def _expr_unsafe(e) -> bool:
    """True when the expression depends on Python state its SQL string
    cannot capture: UDF callables, seeded nondeterministic streams,
    ambient-state readers and wall-clock captures.  The reference also
    refuses host-kernel callbacks (``jax.pure_callback`` closures); the
    port has no such expression, and the ``is_host_kernel`` test stays
    for any that declares itself one."""
    if callable(getattr(e, "fn", None)):
        return True
    if getattr(e, "is_host_kernel", False):
        return True
    if type(e).__name__ in _UNSAFE_EXPR_CLASSES:
        return True
    if hasattr(e, "captured_micros"):
        return True
    for c in getattr(e, "children", []) or []:
        if _expr_unsafe(c):
            return True
    return False


def _nested_seeds(e, acc=None):
    acc = acc if acc is not None else []
    seed = getattr(e, "seed", None)
    if isinstance(seed, int):
        acc.append((type(e).__name__, seed))
    for c in getattr(e, "children", []) or []:
        _nested_seeds(c, acc)
    return tuple(acc)


def exprs_fp(exprs: Optional[Iterable]):
    """Fingerprint parts for an expression list, or None when any
    expression is not safely fingerprintable."""
    parts = []
    for e in exprs or []:
        if e is None:
            parts.append(None)
            continue
        if _expr_unsafe(e):
            return None
        try:
            sql = e.sql_string()
        except Exception:
            return None
        try:
            dt = str(e.dataType)
        except Exception:
            dt = type(e).__name__
        # deterministic numeric parameters sql_string may not print (hash
        # seeds, anywhere in the tree) are part of the identity
        parts.append((type(e).__name__, sql, dt, _nested_seeds(e)))
    return tuple(parts)


def conf_fp(conf) -> str:
    """Fingerprint of a conf's settings.  The reference reads the ambient
    execution conf; the port has none, so the caller passes the conf its
    exec or session holds."""
    settings = getattr(conf, "settings", None) or {}
    return fingerprint(tuple(sorted((str(k), str(v))
                                    for k, v in settings.items())))

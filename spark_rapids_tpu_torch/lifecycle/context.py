"""QueryContext and CancelToken — the per-query lifecycle state (a copy
of ``spark_rapids_tpu/lifecycle/context.py``, stdlib only).

One :class:`QueryContext` exists per admitted collect (installed in a
contextvar by ``lifecycle.query_lifecycle``); it carries the optional
deadline and the :class:`CancelToken` every blocking site observes.

Cancellation is cooperative: ``trip()`` never interrupts a thread, it sets
an event that each blocking site polls (or sleeps on); the site that
notices raises :class:`QueryCancelled` or :class:`QueryDeadlineExceeded`,
which ``resilience/classify.py`` treats as PROPAGATE.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from contextvars import ContextVar
from typing import Optional, Tuple, Type


class QueryCancelled(RuntimeError):
    """The query's CancelToken was tripped (a user cancel)."""


class QueryDeadlineExceeded(QueryCancelled):
    """The query ran past spark.rapids.tpu.query.timeoutMs and the
    watchdog tripped its token."""


class QueryRejected(RuntimeError):
    """Admission fast-reject: the wait queue was full or the queue wait
    timed out.  Raised before any planning or device work, so the caller
    can shed load or retry later; ``queue_depth`` is the admission queue's
    depth at the rejection."""

    def __init__(self, msg: str, queue_depth: Optional[int] = None):
        super().__init__(msg)
        self.queue_depth = queue_depth


class CancelToken:
    """A trip-once cancellation flag blocking sites sleep on.

    ``trip(exc_type, reason)`` stores the exception class and message and
    sets the event; each observer raises a fresh instance from ``check()``
    so a traceback points at the site that noticed."""

    __slots__ = ("_evt", "_lock", "_exc")

    def __init__(self):
        self._evt = threading.Event()
        self._lock = threading.Lock()
        self._exc: Optional[Tuple[Type[BaseException], str]] = None

    def trip(self, exc_type: Type[BaseException], reason: str) -> bool:
        """Arm the token; True if this call tripped it (the first reason
        wins)."""
        with self._lock:
            if self._exc is not None:
                return False
            self._exc = (exc_type, reason)
        self._evt.set()
        return True

    @property
    def cancelled(self) -> bool:
        return self._evt.is_set()

    def check(self) -> None:
        """Raise the tripped exception (no-op while untripped)."""
        if self._evt.is_set():
            exc_type, reason = self._exc
            raise exc_type(reason)


_QUERY_SEQ = itertools.count(1)


def mint_trace_id(seq: int) -> str:
    """The trace id minted at collect start: ``query_id`` ("q3") is unique
    within one engine process only, so the trace id adds a wall-clock
    millisecond and the engine's pid.  The coordinator stamps it on every
    data-plane frame (``trace``), and workers attribute their spans to
    it."""
    return f"{int(time.time() * 1000):x}-{os.getpid():x}-{seq:x}"


class QueryContext:
    """Everything the lifecycle layer tracks for one collect."""

    __slots__ = ("query_id", "trace_id", "token", "admission_wait_ns",
                 "deadline_ns", "watchdog_period_s", "started_ns")

    def __init__(self, watchdog_period_s: float = 0.05):
        n = next(_QUERY_SEQ)
        self.query_id = f"q{n}"
        self.trace_id = mint_trace_id(n)
        self.token = CancelToken()
        self.admission_wait_ns = 0
        self.deadline_ns: Optional[int] = None   # time.monotonic_ns basis
        self.watchdog_period_s = watchdog_period_s
        self.started_ns = time.monotonic_ns()

    def cancel(self, reason: str = "query cancelled") -> bool:
        """User-facing abort: trip the token (idempotent)."""
        return self.token.trip(
            QueryCancelled, f"{self.query_id}: {reason}")

    def check_cancel(self) -> None:
        self.token.check()

    def deadline_expired(self, now_ns: Optional[int] = None) -> bool:
        if self.deadline_ns is None:
            return False
        return (now_ns if now_ns is not None
                else time.monotonic_ns()) >= self.deadline_ns


# the active QueryContext of the current logical thread of execution: a
# contextvar, since the exec iterator chain runs on the query's thread and
# helper threads get the token through closures
CURRENT: "ContextVar[Optional[QueryContext]]" = ContextVar(
    "srt_query_context", default=None)


def current() -> Optional[QueryContext]:
    """The active QueryContext, or None outside a lifecycle-managed
    collect."""
    return CURRENT.get()


def current_token() -> Optional[CancelToken]:
    ctx = CURRENT.get()
    return ctx.token if ctx is not None else None


def check_cancel() -> None:
    """Raise if the current query's token is tripped; no-op outside a
    query or while untripped."""
    ctx = CURRENT.get()
    if ctx is not None:
        ctx.token.check()

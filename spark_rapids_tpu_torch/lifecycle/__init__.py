"""Query lifecycle — admission control, deadlines and cooperative
cancellation (port of ``spark_rapids_tpu/lifecycle/``).

* ``context.py``   — QueryContext (one per collect, in a contextvar) and
  CancelToken; QueryCancelled, QueryDeadlineExceeded, QueryRejected.
* ``admission.py`` — the FIFO admission gate
  (``spark.rapids.tpu.concurrentQueries``) with a bounded wait queue.
* ``watchdog.py``  — one daemon thread trips queries past
  ``spark.rapids.tpu.query.timeoutMs``.

``query_lifecycle`` (around ``DataFrame.collect_host``, which ``collect``
and ``count`` run through) ties them together: admission before planning,
the deadline armed at entry, and on exit — success, error or a mid-batch
unwind — guaranteed cleanup: the query's tracked spillables closed, its
shuffle registrations dropped (which releases what it placed on
distributed workers), and the admission slot returned.  With
``spark.rapids.tpu.recovery.enabled`` the admission and the end are
journaled (``journal.py``); off, no call reaches the journal module.  The
reference's semaphore, accounting, writer, serving and telemetry branches
and its per-query cleanup hooks (the writer's) are not ported.
"""
from __future__ import annotations

import time
from typing import List, Optional

from spark_rapids_tpu_torch.lifecycle import watchdog as _watchdog
from spark_rapids_tpu_torch.lifecycle.admission import (AdmissionController,
                                                        get_admission)
from spark_rapids_tpu_torch.lifecycle.context import (CURRENT, CancelToken,
                                                      QueryCancelled,
                                                      QueryContext,
                                                      QueryDeadlineExceeded,
                                                      QueryRejected,
                                                      check_cancel, current,
                                                      current_token)

class query_lifecycle:
    """Context manager around one collect.

    Yields the new :class:`QueryContext`, or None when a collect is
    nested in another (the inner one shares the outer query's context,
    token and admission slot)."""

    def __init__(self, conf):
        self._conf = conf
        self._ctx: Optional[QueryContext] = None
        self._ctl: Optional[AdmissionController] = None
        self._cv_token = None
        self._journaled = False

    def __enter__(self) -> Optional[QueryContext]:
        from spark_rapids_tpu_torch.config import (ADMISSION_MAX_QUEUE,
                                                   ADMISSION_QUEUE_TIMEOUT_MS,
                                                   CONCURRENT_QUERIES,
                                                   QUERY_TIMEOUT_MS,
                                                   QUERY_WATCHDOG_PERIOD_MS)

        conf = self._conf
        if current() is not None:
            return None
        period_s = max(float(conf.get(QUERY_WATCHDOG_PERIOD_MS)),
                       1.0) / 1000.0
        ctx = QueryContext(watchdog_period_s=period_s)
        # the deadline is armed and the watchdog registered BEFORE the
        # admission wait: a query stuck in the queue must be trippable
        timeout_ms = int(conf.get(QUERY_TIMEOUT_MS))
        if timeout_ms > 0:
            ctx.deadline_ns = time.monotonic_ns() + timeout_ms * 1_000_000
        _watchdog.register(ctx)
        limit = int(conf.get(CONCURRENT_QUERIES))
        if limit > 0:
            ctl = get_admission(limit, int(conf.get(ADMISSION_MAX_QUEUE)))
            try:
                ctx.admission_wait_ns = ctl.acquire(
                    ctx, int(conf.get(ADMISSION_QUEUE_TIMEOUT_MS)))
            except BaseException as e:
                from spark_rapids_tpu_torch import perfcounters as PC

                _watchdog.unregister(ctx)
                if isinstance(e, QueryCancelled):
                    PC.bump("queries_cancelled")
                raise
            self._ctl = ctl
        self._cv_token = CURRENT.set(ctx)
        self._ctx = ctx
        # crash-consistent recovery: journal the admission so a dead
        # driver's successor can classify this query (one conf read when
        # recovery is off, and no journal call)
        from spark_rapids_tpu_torch.config import RECOVERY_ENABLED

        if bool(conf.get(RECOVERY_ENABLED)):
            from spark_rapids_tpu_torch.lifecycle import journal as _journal

            try:
                _journal.journal_admit(ctx, conf)
                self._journaled = True
            except Exception:
                # a journal that cannot append voids this query's
                # recovery guarantee, never its admission
                pass
        return ctx

    def __exit__(self, exc_type, exc, tb):
        ctx = self._ctx
        if ctx is None:
            return False
        from spark_rapids_tpu_torch import perfcounters as PC

        try:
            CURRENT.reset(self._cv_token)
            _watchdog.unregister(ctx)
            if exc is not None and isinstance(exc, QueryCancelled):
                PC.bump("queries_cancelled")
            _cleanup_query(ctx)
            if self._journaled:
                from spark_rapids_tpu_torch.lifecycle import (
                    journal as _journal)

                status = ("ok" if exc_type is None else
                          "cancelled" if isinstance(exc, QueryCancelled)
                          else getattr(exc_type, "__name__", "error"))
                try:
                    _journal.journal_end(ctx, status)
                except Exception:
                    # the end record only lets the checkpoints go; a
                    # missing one replays as a crash, the safe default
                    pass
        finally:
            if self._ctl is not None:
                self._ctl.release()
        return False


def _cleanup_query(ctx: QueryContext) -> None:
    """Release everything the query may still hold after its exec tree
    unwound (possibly mid-batch).  Every step peeks its singleton —
    cleanup creates nothing — and every step is idempotent."""
    # 1. spillable handles this query tracked and never closed
    from spark_rapids_tpu_torch.memory import spill as _spill

    fw = _spill.peek_spill_framework()
    if fw is not None:
        fw.close_owned_by(ctx.query_id)
    # 2. shuffle registrations its exchanges left behind (unregistering
    #    releases what they placed on distributed workers)
    from spark_rapids_tpu_torch.shuffle import manager as _shuffle

    mgr = _shuffle.peek_shuffle_manager()
    if mgr is not None:
        mgr.unregister_owned(ctx.query_id)


def leak_report_all() -> List[str]:
    """Leaks across the process's singletons: unclosed spillables (the
    hot-table cache's persistent ones aside), live shuffle registrations,
    exchanges still placed on remote workers, and the recovery journal's
    un-ended queries and leftover checkpoints.  Empty after a well-behaved
    query."""
    out: List[str] = []
    from spark_rapids_tpu_torch.memory import spill as _spill

    fw = _spill.peek_spill_framework()
    if fw is not None:
        out.extend(fw.leak_report())
    from spark_rapids_tpu_torch.shuffle import manager as _shuffle

    mgr = _shuffle.peek_shuffle_manager()
    if mgr is not None:
        for sid in mgr.active_shuffles():
            out.append(f"LEAK: shuffle {sid} still registered")
    from spark_rapids_tpu_torch import distributed as _dist

    out.extend(_dist.leak_report())
    # a journaled query that never ended, a pending checkpoint or a
    # checkpoint dir left on disk would mis-classify at the next restart
    from spark_rapids_tpu_torch.lifecycle import journal as _journal

    out.extend(_journal.journal_leak_report())
    return out


def reset_leaked_state() -> None:
    """Best-effort recovery after a detected leak, so one leaky query
    cannot poison what runs after it: close leaked handles, drop orphaned
    shuffle registrations, release remote placements."""
    from spark_rapids_tpu_torch.memory import spill as _spill
    from spark_rapids_tpu_torch.shuffle import manager as _shuffle

    fw = _spill.peek_spill_framework()
    if fw is not None:
        # persistent handles (the hot-table cache's) are not a query's
        # leak: the cache owns them and closes them itself
        fw.close_all(include_persistent=False)
    mgr = _shuffle.peek_shuffle_manager()
    if mgr is not None:
        for sid in mgr.active_shuffles():
            try:
                mgr.unregister_shuffle(sid)
            except Exception:
                pass
    from spark_rapids_tpu_torch import distributed as _dist

    coord = _dist.peek_coordinator()
    if coord is not None:
        try:
            coord.release_all()
        except Exception:
            pass
    # purge every recovery root this process touched, so one leaky
    # query's WAL cannot seed a false "resumable" in the next replay
    from spark_rapids_tpu_torch.lifecycle import journal as _journal

    _journal.reset_journal(purge=True)


__all__ = [
    "CancelToken", "QueryCancelled", "QueryContext",
    "QueryDeadlineExceeded", "QueryRejected",
    "check_cancel", "current", "current_token",
    "get_admission",
    "leak_report_all", "reset_leaked_state", "query_lifecycle",
]

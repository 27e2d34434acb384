"""The deadline watchdog — one daemon thread trips expired queries (port
of ``spark_rapids_tpu/lifecycle/watchdog.py``).

Every lifecycle-managed query registers here for the length of its
collect; the watchdog scans the registry every
``spark.rapids.tpu.query.watchdogPeriodMs`` (the least across active
queries) and trips the CancelToken of any query past its deadline with
:class:`QueryDeadlineExceeded`.  The reference's flight-recorder and
progress-stall hooks, and its ``active_queries`` view, are not ported.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from spark_rapids_tpu_torch.lifecycle.context import (QueryContext,
                                                      QueryDeadlineExceeded)

_COND = threading.Condition()
_ACTIVE: "set[QueryContext]" = set()
_THREAD: Optional[threading.Thread] = None
_IDLE_PERIOD_S = 0.5


def register(ctx: QueryContext) -> None:
    global _THREAD
    with _COND:
        _ACTIVE.add(ctx)
        if _THREAD is None or not _THREAD.is_alive():
            _THREAD = threading.Thread(
                target=_run, name="srt-query-watchdog", daemon=True)
            _THREAD.start()
        _COND.notify_all()


def unregister(ctx: QueryContext) -> None:
    with _COND:
        _ACTIVE.discard(ctx)
        _COND.notify_all()


def _run() -> None:
    from spark_rapids_tpu_torch import perfcounters as PC

    while True:
        with _COND:
            targets = list(_ACTIVE)
            period = min(
                [c.watchdog_period_s for c in targets] or [_IDLE_PERIOD_S])
        now = time.monotonic_ns()
        for ctx in targets:
            if ctx.deadline_expired(now) and not ctx.token.cancelled:
                over_ms = (now - ctx.deadline_ns) / 1e6
                if ctx.token.trip(
                        QueryDeadlineExceeded,
                        f"{ctx.query_id} exceeded "
                        f"spark.rapids.tpu.query.timeoutMs "
                        f"(deadline passed {over_ms:.0f}ms ago)"):
                    PC.bump("deadline_trips")
        with _COND:
            _COND.wait(max(period, 0.005))

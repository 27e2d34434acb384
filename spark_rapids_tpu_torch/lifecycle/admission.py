"""Admission control — a gate on concurrently running queries (port of
``spark_rapids_tpu/lifecycle/admission.py``).

``spark.rapids.tpu.concurrentQueries`` admits at most L queries; up to
``admission.maxQueueDepth`` more wait in a FIFO queue, and any beyond
that fast-reject with :class:`QueryRejected`.  Waiters poll in short
slices, so a tripped CancelToken (a user cancel or the watchdog's
deadline) aborts the wait within about 50 ms.  The reference's governor
shed and the serving tier's fair-share scheduler are not ported: the
order is always FIFO.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional, Tuple

from spark_rapids_tpu_torch.lifecycle.context import (QueryContext,
                                                      QueryRejected)

_POLL_S = 0.05


class AdmissionController:
    def __init__(self, limit: int, max_queue: int):
        self.limit = max(1, int(limit))
        self.max_queue = max(0, int(max_queue))
        self._cond = threading.Condition()
        self._running = 0
        self._waiters: deque = deque()      # FIFO arrival order

    def acquire(self, ctx: QueryContext, timeout_ms: int = 0) -> int:
        """Admit ``ctx``, returning the queue wait in ns.  Raises
        :class:`QueryRejected` at once when the wait queue is full, or
        after ``timeout_ms`` (0: wait indefinitely); raises the token's
        exception if the query is cancelled while queued."""
        from spark_rapids_tpu_torch import perfcounters as PC

        t0 = time.perf_counter_ns()
        with self._cond:
            if self._running < self.limit and not self._waiters:
                self._running += 1
                PC.bump("queries_admitted")
                return 0
            depth = len(self._waiters)
            if depth >= self.max_queue:
                PC.bump("queries_rejected")
                raise QueryRejected(
                    f"admission queue full ({depth} queued, "
                    f"{self._running}/{self.limit} running; "
                    f"spark.rapids.tpu.admission.maxQueueDepth="
                    f"{self.max_queue})", queue_depth=depth)
            ticket = object()
            self._waiters.append(ticket)
            deadline = (None if timeout_ms <= 0
                        else time.monotonic() + timeout_ms / 1000.0)
            try:
                while not (self._running < self.limit
                           and self._waiters[0] is ticket):
                    ctx.token.check()
                    if deadline is not None and time.monotonic() >= deadline:
                        PC.bump("queries_rejected")
                        raise QueryRejected(
                            f"{ctx.query_id}: admission wait exceeded "
                            f"queueTimeoutMs={timeout_ms}",
                            queue_depth=len(self._waiters))
                    self._cond.wait(_POLL_S)
                self._waiters.remove(ticket)
                self._running += 1
            except BaseException:
                try:
                    self._waiters.remove(ticket)
                except ValueError:
                    pass
                self._cond.notify_all()
                raise
            # the head moved: the next waiter may now be eligible
            self._cond.notify_all()
        wait_ns = time.perf_counter_ns() - t0
        PC.bump("queries_admitted")
        PC.bump("admission_wait_ns", wait_ns)
        return wait_ns

    def release(self) -> None:
        with self._cond:
            self._running = max(0, self._running - 1)
            self._cond.notify_all()


_lock = threading.Lock()
_controller: Optional[AdmissionController] = None
_controller_key: Optional[Tuple[int, int]] = None


def get_admission(limit: int, max_queue: int) -> AdmissionController:
    """The process's controller, rebuilt when the confs change."""
    global _controller, _controller_key
    with _lock:
        key = (int(limit), int(max_queue))
        if _controller is None or key != _controller_key:
            _controller = AdmissionController(limit, max_queue)
            _controller_key = key
        return _controller


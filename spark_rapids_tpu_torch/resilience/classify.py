"""Failure classification — one taxonomy for everything escaping a stage
(port of ``spark_rapids_tpu/resilience/classify.py``).

Classes:

* DEVICE_OOM      — ``torch.cuda.OutOfMemoryError`` anywhere in the
  cause chain, a CUDA "out of memory" error, or the cooperative
  ``TpuRetryOOM``/``TpuSplitAndRetryOOM`` pair: spill and retry
  (``memory/retry.py``).
* TRANSIENT       — errors that may heal on their own: connection
  errors, timeouts, broken pipes and network-flavoured ``OSError``s.
* DETERMINISTIC   — everything else, corruption errors included:
  retrying re-derives the same failure.
* PROPAGATE       — errors that are the query's correct result (ANSI
  errors) and the lifecycle's control flow (cancel, deadline, reject).
* WORKER_LOST     — a distributed worker is gone for good: the tier
  answers with re-placement and re-drive, never with backoff.
* WORKER_DEGRADED — a distributed worker is slow, not dead.

Types are matched by name along the cause chain, as in the reference, so
this module imports neither the memory runtime nor the distributed tier.
The reference reads XLA's status codes (``_status_of``); torch has its own
OOM type, which takes their place.
"""
from __future__ import annotations

import errno as _errno
from typing import Iterator

DEVICE_OOM = "deviceOom"
TRANSIENT = "transient"
DETERMINISTIC = "deterministic"
PROPAGATE = "propagate"
WORKER_LOST = "workerLost"
WORKER_DEGRADED = "workerDegraded"

# cooperative OOM exceptions from memory/retry.py
_OOM_TYPE_NAMES = ("TpuRetryOOM", "TpuSplitAndRetryOOM")

# the query's correct observable behaviour, and the lifecycle's control
# flow: surfaced unchanged, never retried
_PROPAGATE_TYPE_NAMES = ("SparkArithmeticException",
                         "SparkDateTimeException",
                         "SparkNumberFormatException",
                         "QueryCancelled",
                         "QueryDeadlineExceeded",
                         "QueryRejected")

# integrity-check failures (shuffle frame CRC, disk-spill CRC, control
# frame CRC): reading again re-derives them
_DETERMINISTIC_TYPE_NAMES = ("ShuffleCorruption", "SpillCorruption",
                             "ProtocolCorruption")

# matched BEFORE the ConnectionError check: WorkerLost subclasses it, but
# backoff is the wrong answer once the loss is declared
_WORKER_LOST_TYPE_NAMES = ("WorkerLost",)
_WORKER_DEGRADED_TYPE_NAMES = ("WorkerDegraded",)

# the fault-injection harness's errors (the reference's
# resilience/faults.py), matched by name
_INJECTED_TRANSIENT = "InjectedTransientError"
_INJECTED_COMPILE = "InjectedCompileError"

# what CUDA calls outside the caching allocator raise on an OOM
_OOM_MARKERS = ("Out of memory", "out of memory")

_TRANSIENT_ERRNOS = frozenset((
    _errno.EAGAIN, _errno.EINTR, _errno.ETIMEDOUT, _errno.ECONNRESET,
    _errno.ECONNABORTED, _errno.ECONNREFUSED, _errno.EHOSTUNREACH,
    _errno.ENETUNREACH, _errno.ENETRESET, _errno.EPIPE, _errno.EBUSY,
))


def exception_chain(exc: BaseException) -> Iterator[BaseException]:
    """``exc`` and every ``__cause__``/``__context__`` beneath it (cause
    preferred, cycle-guarded).  ``raise X from None`` ends the walk: the
    raiser declared the context unrelated."""
    seen = set()
    cur: BaseException = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        yield cur
        if cur.__cause__ is not None:
            cur = cur.__cause__
        elif cur.__suppress_context__:
            cur = None
        else:
            cur = cur.__context__


def _is_torch_oom(exc: BaseException) -> bool:
    import sys

    torch = sys.modules.get("torch")     # no torch, no torch OOM
    return torch is not None and isinstance(exc,
                                            torch.cuda.OutOfMemoryError)


def is_device_oom(exc: BaseException) -> bool:
    """A device OOM anywhere in the cause chain."""
    for link in exception_chain(exc):
        if type(link).__name__ in _OOM_TYPE_NAMES or _is_torch_oom(link):
            return True
        s = repr(link)
        if any(m in s for m in _OOM_MARKERS):
            return True
    return False


def classify_failure(exc: BaseException) -> str:
    """Map an exception (walking its cause chain) to a failure class."""
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return PROPAGATE
    chain = list(exception_chain(exc))
    names = [type(link).__name__ for link in chain]
    for table, cls in ((_PROPAGATE_TYPE_NAMES, PROPAGATE),
                       (_WORKER_DEGRADED_TYPE_NAMES, WORKER_DEGRADED),
                       (_WORKER_LOST_TYPE_NAMES, WORKER_LOST),
                       (_DETERMINISTIC_TYPE_NAMES, DETERMINISTIC)):
        if any(n in table for n in names):
            return cls
    if is_device_oom(exc):
        return DEVICE_OOM
    for link, name in zip(chain, names):
        if name == _INJECTED_TRANSIENT:
            return TRANSIENT
        if name == _INJECTED_COMPILE:
            return DETERMINISTIC
        if isinstance(link, (ConnectionError, TimeoutError,
                             BrokenPipeError)):
            return TRANSIENT
        if isinstance(link, OSError) and link.errno in _TRANSIENT_ERRNOS:
            return TRANSIENT
    return DETERMINISTIC

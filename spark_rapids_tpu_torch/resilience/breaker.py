"""Process-global circuit breaker (port of
``spark_rapids_tpu/resilience/breaker.py``).

Entries are keyed by (class name, fingerprint).  The reference keys plan
nodes by their class and a digest of their expressions (``plan_key``),
and the distributed coordinator keys workers
``("DistributedWorker", <id>)``: a worker declared lost opens its entry,
so the same id rejoining is QUARANTINED until the TTL admits a probe.

    CLOSED --N failures--> OPEN
    OPEN   --TTL expiry, next consult--> HALF_OPEN (one probe admitted)
    HALF_OPEN --probe succeeds--> CLOSED (entry dropped)
    HALF_OPEN --probe fails--> OPEN (fresh TTL)

The clock is injectable for TTL tests.  The reference's flight-recorder
hook on a trip is not ported.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Optional, Tuple

CLOSED = "CLOSED"
OPEN = "OPEN"
HALF_OPEN = "HALF_OPEN"

Key = Tuple[str, str]


class _Entry:
    __slots__ = ("failures", "state", "opened_at", "probed_at",
                 "last_reason")

    def __init__(self):
        self.failures = 0
        self.state = CLOSED
        self.opened_at = 0.0
        self.probed_at = 0.0
        self.last_reason = ""


class CircuitBreakerRegistry:
    def __init__(self, now=time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._entries: Dict[Key, _Entry] = {}

    def record_failure(self, key: Key, threshold: int,
                       reason: str = "") -> bool:
        """One failure; True when this one tripped the entry OPEN."""
        with self._lock:
            e = self._entries.setdefault(key, _Entry())
            e.failures += 1
            e.last_reason = reason
            if e.state == HALF_OPEN or (e.state == CLOSED
                                        and e.failures >= threshold):
                e.state = OPEN
                e.opened_at = self._now()
                return True
            if e.state == OPEN:
                e.opened_at = self._now()
            return False

    def record_success(self, key: Key) -> None:
        """A completed run closes a half-open entry (the probe passed) and
        decays closed-state failure counts."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            if e.state == HALF_OPEN:
                del self._entries[key]
            elif e.state == CLOSED and e.failures:
                e.failures -= 1

    def consult(self, key: Key, ttl_sec: float) -> Optional[str]:
        """Why ``key`` is held, or None.  An OPEN entry past its TTL flips
        to HALF_OPEN and admits ONE probe."""
        if not self._entries:
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.state == CLOSED:
                return None
            if e.state == OPEN and self._now() - e.opened_at >= ttl_sec:
                e.state = HALF_OPEN
                e.probed_at = self._now()
                return None
            if e.state == HALF_OPEN:
                if self._now() - e.probed_at >= ttl_sec:
                    # the admitted probe never resolved: admit another
                    e.probed_at = self._now()
                    return None
                return (f"circuit breaker half-open for {key[0]} "
                        f"(probe in flight)")
            remaining = ttl_sec - (self._now() - e.opened_at)
            why = f" ({e.last_reason})" if e.last_reason else ""
            return (f"circuit breaker open for {key[0]} after "
                    f"{e.failures} deterministic failure(s){why}; "
                    f"re-probing in {max(remaining, 0):.0f}s")

    def clear_key(self, key: Key) -> bool:
        """Drop one entry whatever its state (a worker re-attaching after
        a driver restart must not inherit the dead incarnation's
        quarantine).  True when an entry existed."""
        with self._lock:
            return self._entries.pop(key, None) is not None

    def has_entries(self) -> bool:
        return bool(self._entries)

    def state_of(self, key: Key) -> str:
        with self._lock:
            e = self._entries.get(key)
            return e.state if e is not None else CLOSED

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


_BREAKER = CircuitBreakerRegistry()


def get_breaker() -> CircuitBreakerRegistry:
    return _BREAKER


def reset_breaker() -> None:
    _BREAKER.reset()
    _BREAKER._now = time.monotonic


def expr_fingerprint(exprs) -> str:
    """Digest of the expression list that parameterizes a plan node."""
    parts = []
    for e in exprs or []:
        try:
            parts.append(e.sql_string())
        except Exception:
            parts.append(type(e).__name__)
    h = hashlib.sha1(";".join(parts).encode("utf-8", "replace"))
    return h.hexdigest()[:12]


def plan_key(plan) -> Key:
    """(plan-node class name, expression fingerprint): the breaker key of
    a plan node, over the expressions the tagging reads
    (``overrides/meta.py::_exprs_of``)."""
    from spark_rapids_tpu_torch.overrides.meta import _exprs_of

    try:
        exprs = _exprs_of(plan)
    except Exception:
        exprs = []
    return (type(plan).__name__, expr_fingerprint(exprs))


def consult_plan(plan, conf) -> Optional[str]:
    """The reason the breaker holds this plan node off the device, or
    None."""
    if not _BREAKER.has_entries():
        return None
    from spark_rapids_tpu_torch.config import (RESILIENCE_BREAKER_TTL_SEC,
                                               RESILIENCE_ENABLED)

    if not conf.get(RESILIENCE_ENABLED):
        return None
    return _BREAKER.consult(plan_key(plan),
                            float(conf.get(RESILIENCE_BREAKER_TTL_SEC)))

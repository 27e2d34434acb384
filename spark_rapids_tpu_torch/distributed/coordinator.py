"""Coordinator — membership, heartbeat liveness, placement and the re-drive
plan of the distributed tier (port of
``spark_rapids_tpu/distributed/coordinator.py``).

The coordinator runs in the engine process and never holds partition data:

* **membership** — workers join (HELLO on the control listener) and
  leave (GOODBYE, or a dead control socket); every join bumps
  ``workers_joined``.
* **liveness** — workers heartbeat every ``distributed.heartbeatMs``; the
  monitor counts late workers (``worker_heartbeat_misses``) and, past
  ``workerLostMs`` of silence, pings the worker's data port before it
  declares it LOST: an engine process busy in one long call starves the
  threads that read heartbeats, and the ping tells that apart from a dead
  worker.
  A loss bumps ``worker_lost`` and records a breaker entry
  ``("DistributedWorker", <id>)``, so the same id rejoining is QUARANTINED
  until the breaker TTL admits a probe.
* **placement** — ``place()`` spreads an exchange's reduce partitions over
  the placeable workers, least loaded by advertised memory first.
* **re-drive** — a loss re-places the lost worker's partitions on
  survivors and queues them; the exchange client claims the queue and
  re-pushes its retained blocks (``partitions_replayed``).
* **gray failure** — every data-plane op feeds a per-worker p95-biased
  latency EWMA; a worker past ``slowFactor`` x the fleet median, or that
  misses ``degradeAfterMisses`` soft deadlines in a row, is DEGRADED
  (demoted in placement, its partitions re-driven onto healthy workers,
  not declared lost) and is promoted back after ``promoteAfterOks``
  in-deadline observations.  ``soft_deadline_s`` is what the client's
  hedged fetch races.

The wire id of an exchange (in put, fetch and release headers) is minted
here and never reused.  Heartbeats carry each worker's counters and span
ring (``collect_trace``).

Crash recovery: with ``spark.rapids.tpu.recovery.enabled`` the coordinator
publishes its endpoint under the recovery root, and workers that outlived
a dead driver re-attach to it with the inventory of what they hold.  Such
a re-HELLO clears the dead incarnation's breaker entry for the worker and
raises the wire-id counter above every held wire id, so no new exchange
can collide with a stale (CRC-valid) block.  ``adopt_exchange`` rebuilds a
journaled lease's placement under its original wire id, and
``release_orphan_holdings`` drops what no lease will adopt.  The
reference's diagnostics events, flight recorder post-mortems and live
telemetry pulls are not ported.
"""
from __future__ import annotations

import itertools
import random
import socket
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.distributed import protocol as P
from spark_rapids_tpu_torch.distributed.protocol import (WorkerDegraded,
                                                         WorkerLost)

ALIVE = "ALIVE"
QUARANTINED = "QUARANTINED"
LOST = "LOST"
LEFT = "LEFT"
DEGRADED = "DEGRADED"

# the per-worker breaker key family
BREAKER_OP = "DistributedWorker"


def _full_jitter_sleep(attempt: int, base_s: float = 0.02,
                       cap_s: float = 0.2) -> None:
    """Full-jitter backoff: sleep uniform(0, min(base * 2^(attempt-1),
    cap)), so callers retrying one hiccup do not re-arrive in lockstep."""
    time.sleep(random.random()
               * min(base_s * (2 ** max(attempt - 1, 0)), cap_s))


class WorkerInfo:
    __slots__ = ("worker_id", "host", "data_port", "pid", "mem_bytes",
                 "state", "last_hb", "control", "hb_missed", "probe_failed",
                 "counters", "store_stats", "mirror", "mirror_last_n",
                 "clock_offset_s", "lat_ewma_s", "lat_samples",
                 "miss_streak", "ok_streak", "slow_ticks", "held")

    def __init__(self, worker_id: str, host: str, data_port: int,
                 pid: int, mem_bytes: int, control: socket.socket,
                 mirror_capacity: int = 512):
        self.worker_id = worker_id
        self.host = host
        self.data_port = data_port
        self.pid = pid
        self.mem_bytes = max(int(mem_bytes), 1)
        self.state = ALIVE
        self.last_hb = time.monotonic()
        self.control = control
        self.hb_missed = False
        self.probe_failed = False
        # what the heartbeats carry: the worker's counter snapshot and
        # store stats, a mirror of its span ring (deduplicated on the ring
        # sequence), and the clock offset (coordinator wall - worker wall, the
        # least over samples)
        self.counters: Dict[str, int] = {}
        self.store_stats: Dict[str, int] = {}
        self.mirror: deque = deque(maxlen=max(int(mirror_capacity), 1))
        self.mirror_last_n = 0
        self.clock_offset_s: Optional[float] = None
        # gray failure: the latency EWMA, consecutive soft-deadline miss
        # and in-deadline streaks, and monitor scans spent past slowFactor
        # x the fleet median
        self.lat_ewma_s: Optional[float] = None
        self.lat_samples = 0
        self.miss_streak = 0
        self.ok_streak = 0
        self.slow_ticks = 0
        # a re-attaching worker's inventory: [(wire, pid, n_blocks,
        # max_seq)]
        self.held: List[Tuple[int, int, int, int]] = []


class Coordinator:
    """One per engine process, built by ``distributed.get_coordinator``."""

    def __init__(self, conf=None):
        from spark_rapids_tpu_torch.config import (
            DISTRIBUTED_DEGRADE_AFTER_MISSES, DISTRIBUTED_HEARTBEAT_MS,
            DISTRIBUTED_HEDGE_ENABLED, DISTRIBUTED_LOSS_BREAKER_THRESHOLD,
            DISTRIBUTED_OP_TIMEOUT_MS, DISTRIBUTED_PROMOTE_AFTER_OKS,
            DISTRIBUTED_PUT_RETRIES, DISTRIBUTED_SLOW_FACTOR,
            DISTRIBUTED_SOFT_DEADLINE_FACTOR,
            DISTRIBUTED_SOFT_DEADLINE_MIN_MS, DISTRIBUTED_TELEMETRY_RING,
            DISTRIBUTED_TRACE_ENABLED, DISTRIBUTED_WORKER_LOST_MS,
            DISTRIBUTED_WORKER_MEM, RESILIENCE_BREAKER_TTL_SEC, TpuConf)

        c = conf if conf is not None else TpuConf()
        self.heartbeat_s = max(
            int(c.get(DISTRIBUTED_HEARTBEAT_MS)), 10) / 1000.0
        self.lost_s = max(int(c.get(DISTRIBUTED_WORKER_LOST_MS)),
                          int(c.get(DISTRIBUTED_HEARTBEAT_MS))) / 1000.0
        self.op_timeout_s = max(
            int(c.get(DISTRIBUTED_OP_TIMEOUT_MS)), 100) / 1000.0
        self.put_retries = int(c.get(DISTRIBUTED_PUT_RETRIES))
        self.breaker_threshold = int(
            c.get(DISTRIBUTED_LOSS_BREAKER_THRESHOLD))
        self.breaker_ttl_s = float(c.get(RESILIENCE_BREAKER_TTL_SEC))
        self.trace_enabled = bool(c.get(DISTRIBUTED_TRACE_ENABLED))
        self.telemetry_ring = int(c.get(DISTRIBUTED_TELEMETRY_RING))
        self.worker_mem = int(c.get(DISTRIBUTED_WORKER_MEM))
        self.hedge_enabled = bool(c.get(DISTRIBUTED_HEDGE_ENABLED))
        self.soft_factor = max(
            float(c.get(DISTRIBUTED_SOFT_DEADLINE_FACTOR)), 1.0)
        self.soft_min_s = max(
            int(c.get(DISTRIBUTED_SOFT_DEADLINE_MIN_MS)), 1) / 1000.0
        self.slow_factor = max(float(c.get(DISTRIBUTED_SLOW_FACTOR)), 1.0)
        self.degrade_after = max(
            int(c.get(DISTRIBUTED_DEGRADE_AFTER_MISSES)), 1)
        self.promote_after = max(
            int(c.get(DISTRIBUTED_PROMOTE_AFTER_OKS)), 1)

        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerInfo] = {}
        # wire ids: minted here, never reused for the coordinator's
        # lifetime.  A caller's exchange id can repeat (a test, or a
        # direct place() caller), and a stale worker-store entry under a
        # colliding key would satisfy the consumer's completeness check
        # with wrong (CRC-valid) rows
        self._wire_ids = itertools.count(1)
        self._wire_of: Dict[int, int] = {}
        # (exch, pid) -> worker_id
        self._placement: Dict[Tuple[int, int], str] = {}
        # (exch, pid) -> blocks held remotely (load weighting, leak gate)
        self._holdings: Dict[Tuple[int, int], int] = {}
        # pids a loss re-placed, awaiting the producer's re-drive
        self._redrives: Dict[int, Set[int]] = {}
        # workers speculation moved an exchange's partitions away from:
        # a DEGRADED worker still runs, so the release goes to it too
        self._former_owners: Dict[int, Set[str]] = {}
        # data-plane connections, one per worker, each serialized by a
        # per-worker lock
        self._conns: Dict[str, socket.socket] = {}
        self._conn_locks: Dict[str, threading.Lock] = {}
        self._stop = threading.Event()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(32)
        self.port = self._listener.getsockname()[1]
        # crash recovery: publish this incarnation's endpoint so workers
        # that outlived a dead driver re-dial its successor
        from spark_rapids_tpu_torch.config import RECOVERY_ENABLED

        if bool(c.get(RECOVERY_ENABLED)):
            from spark_rapids_tpu_torch.lifecycle import journal as _journal

            try:
                _journal.write_endpoint(_journal.resolve_root(c),
                                        "127.0.0.1", self.port)
            except OSError:
                # an unwritable endpoint file costs re-attach, not the
                # coordinator
                pass
        self._threads: List[threading.Thread] = []
        for target, name in ((self._accept_loop, "accept"),
                             (self._monitor_loop, "monitor")):
            t = threading.Thread(target=target, daemon=True,
                                 name=f"srt-dist-coord-{name}")
            t.start()
            self._threads.append(t)

    # -- membership ------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except OSError:
                if self._stop.is_set():
                    return
                # a transient accept failure (EMFILE, an interrupted
                # call): keep serving joins
                time.sleep(self.heartbeat_s)
                continue
            conn.settimeout(self.lost_s * 2 + 1.0)
            t = threading.Thread(
                target=self._control_conn, args=(conn, addr[0]),
                daemon=True, name="srt-dist-coord-control")
            t.start()

    def _control_conn(self, conn: socket.socket, host: str) -> None:
        """One worker's control connection: HELLO, then heartbeats until
        EOF or an error (a dead socket)."""
        wid = None
        try:
            header, _ = P.recv_msg(conn)
            if header.get("op") != "hello":
                P.send_msg(conn, {"error": "expected hello"})
                return
            wid = str(header["worker_id"])
            self._admit(wid, host, header, conn)
            P.send_msg(conn, {"op": "welcome", "worker_id": wid})
            while not self._stop.is_set():
                msg, _ = P.recv_msg(conn)
                op = msg.get("op")
                if op == "heartbeat":
                    self._heartbeat(wid, msg)
                elif op == "goodbye":
                    self._leave(wid)
                    return
        except (OSError, ConnectionError, P.ProtocolCorruption):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if wid is not None and not self._stop.is_set():
                # EOF without goodbye: a dead socket, LOST — unless a
                # rejoin superseded this connection or the worker already
                # left or was lost
                with self._lock:
                    w = self._workers.get(wid)
                    stale = w is None or w.control is not conn \
                        or w.state in (LOST, LEFT)
                if not stale:
                    self.declare_lost(wid, "control socket closed")

    def _admit(self, wid: str, host: str, header: Dict,
               conn: socket.socket) -> None:
        from spark_rapids_tpu_torch.resilience.breaker import get_breaker

        info = WorkerInfo(wid, host, int(header["data_port"]),
                          int(header.get("pid", 0)),
                          int(header.get("mem_bytes", 1 << 20)), conn,
                          mirror_capacity=self.telemetry_ring)
        if "t_wall" in header:
            info.clock_offset_s = time.time() - float(header["t_wall"])
        inventory = header.get("held") or []
        if inventory:
            # a re-attach after a driver's death: the loss that left a
            # breaker entry was the crash, not this worker, and
            # quarantining the process that holds the checkpointed blocks
            # would turn a resumable query into a full re-execution
            info.held = [(int(e), int(p), int(n), int(mx))
                         for e, p, n, mx in inventory]
            get_breaker().clear_key((BREAKER_OP, wid))
        # a worker id whose loss history holds its breaker entry OPEN
        # joins QUARANTINED (heartbeats, never placed) until the TTL probe
        if get_breaker().consult((BREAKER_OP, wid),
                                 self.breaker_ttl_s) is not None:
            info.state = QUARANTINED
        with self._lock:
            if info.held:
                # the worker keys its blocks by the dead incarnation's
                # wire ids, and this counter restarted at 1: mint above
                # every held id before any place() can run
                top = max(e for e, _p, _n, _mx in info.held) + 1
                self._wire_ids = itertools.count(
                    max(next(self._wire_ids), top))
            old = self._workers.get(wid)
            self._workers[wid] = info
            self._conn_locks.setdefault(wid, threading.Lock())
            # a rejoin supersedes the old data connection too
            stale_conn = self._conns.pop(wid, None)
        for s in ((old.control if old is not None
                   and old.control is not conn else None), stale_conn):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        PC.bump("workers_joined")

    def _heartbeat(self, wid: str, msg: Optional[Dict] = None) -> None:
        with self._lock:
            w = self._workers.get(wid)
            if w is not None:
                w.last_hb = time.monotonic()
                w.hb_missed = False
                w.probe_failed = False
                if msg is not None:
                    self._fold_telemetry_locked(w, msg)

    def _fold_telemetry_locked(self, w: WorkerInfo, msg: Dict) -> None:
        """Fold one heartbeat into the worker's state (caller holds the
        lock): its counters also feed the latency EWMA, one mean-per-op
        sample per heartbeat, so a slow spill disk shows even when the
        engine sent the worker no op in the interval."""
        counters = msg.get("counters")
        if isinstance(counters, dict):
            new = {k: int(v) for k, v in counters.items()}

            def delta(*keys):
                return sum(new.get(k, 0) - int(w.counters.get(k, 0))
                           for k in keys)

            d_wall = delta("put_wall_ns", "fetch_wall_ns")
            d_ops = delta("store_puts", "store_put_dedups", "store_fetches")
            # a rejoin restarts the counters: negative deltas are skipped
            if d_ops > 0 and d_wall >= 0:
                self._note_sample_locked(w, (d_wall / d_ops) / 1e9)
            w.counters = new
        w.store_stats = {k: int(msg[k]) for k in
                         ("blocks", "bytes", "mem_used", "spilled_blocks",
                          "partitions") if k in msg}
        for e in msg.get("ring") or ():
            n = int(e.get("n", 0))
            if n > w.mirror_last_n:
                w.mirror.append(e)
                w.mirror_last_n = n
        if "t_wall" in msg:
            off = time.time() - float(msg["t_wall"])
            if w.clock_offset_s is None or off < w.clock_offset_s:
                w.clock_offset_s = off

    def _leave(self, wid: str) -> None:
        with self._lock:
            w = self._workers.get(wid)
            if w is None:
                return
            w.state = LEFT
            conn = self._conns.pop(wid, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    # -- liveness --------------------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            now = time.monotonic()
            late: List[str] = []
            lost: List[str] = []
            degraded: List[str] = []
            with self._lock:
                for wid, w in self._workers.items():
                    if w.state not in (ALIVE, QUARANTINED, DEGRADED):
                        continue
                    age = now - w.last_hb
                    if age > self.lost_s:
                        lost.append(wid)
                    elif age > self.heartbeat_s * 2 and not w.hb_missed:
                        w.hb_missed = True
                        late.append(wid)
                    if w.state == DEGRADED and wid not in lost:
                        degraded.append(wid)
            for _ in late:
                PC.bump("worker_heartbeat_misses")
            self._scan_stragglers()
            for wid in degraded:
                # a DEGRADED worker may carry no traffic, so a timed ping
                # each scan keeps its EWMA fed toward promotion
                t0 = time.monotonic()
                alive, _refused = self._probe_alive(wid)
                if alive:
                    self.note_op_latency(wid, time.monotonic() - t0)
            for wid in lost:
                # silence alone is ambiguous on a busy engine: a ping
                # tells a live worker (answers) from a stopped one (times
                # out) and a killed one (refuses); a timed-out ping must
                # fail twice in a row before the loss is declared
                alive, refused = self._probe_alive(wid)
                if alive:
                    self._heartbeat(wid)
                    continue
                with self._lock:
                    w = self._workers.get(wid)
                    first_failure = w is not None and not w.probe_failed
                    if w is not None:
                        w.probe_failed = True
                if first_failure and not refused:
                    continue
                self.declare_lost(
                    wid, f"no heartbeat for {self.lost_s * 1000:.0f}ms "
                         f"and data-port probe failed")

    def _probe_alive(self, wid: str) -> Tuple[bool, bool]:
        """One ping on a fresh connection to the worker's data listener:
        (alive, connection refused)."""
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state in (LOST, LEFT):
                return False, True
            host, port = w.host, w.data_port
        try:
            s = P.connect(host, port, self.op_timeout_s)
            try:
                rep, _ = P.request(s, {"op": "ping"})
                return bool(rep.get("ok")), False
            finally:
                s.close()
        except ConnectionRefusedError:
            return False, True
        except (OSError, ConnectionError, RuntimeError,
                P.ProtocolCorruption):
            return False, False

    def declare_lost(self, wid: str, reason: str) -> bool:
        """Idempotent LOST declaration: re-place the worker's partitions on
        survivors, queue them for re-drive, and open its breaker entry.
        True when this call made the declaration."""
        from spark_rapids_tpu_torch.resilience.breaker import get_breaker

        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state in (LOST, LEFT):
                return False
            w.state = LOST
            control, conn = w.control, self._conns.pop(wid, None)
            owned = [k for k, owner in self._placement.items()
                     if owner == wid]
        for s in (control, conn):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        # the re-drive plan is queued before anything else, so an observer
        # of the LOST state finds it in place
        self._replace_owner(owned)
        PC.bump("worker_lost")
        get_breaker().record_failure((BREAKER_OP, wid),
                                     self.breaker_threshold,
                                     reason=f"worker lost: {reason}")
        return True

    # -- gray failure ----------------------------------------------------
    def _note_sample_locked(self, w: WorkerInfo, wall_s: float) -> None:
        """Fold one op wall into the worker's p95-biased EWMA (caller holds
        the lock): overshoots pull it up fast, undershoots bleed off
        slowly."""
        if w.lat_ewma_s is None:
            w.lat_ewma_s = wall_s
        else:
            a = 0.5 if wall_s > w.lat_ewma_s else 0.05
            w.lat_ewma_s += a * (wall_s - w.lat_ewma_s)
        w.lat_samples += 1

    def soft_deadline_s(self, wid: str) -> Optional[float]:
        """max(softDeadlineMinMs, softDeadlineFactor x the worker's EWMA),
        the floor alone before any sample; None when hedging is off."""
        if not self.hedge_enabled:
            return None
        with self._lock:
            w = self._workers.get(wid)
            ewma = None if w is None else w.lat_ewma_s
        if ewma is None:
            return self.soft_min_s
        return max(self.soft_min_s, self.soft_factor * ewma)

    def note_op_latency(self, wid: str, wall_s: float) -> None:
        """One completed op's wall against one worker: feed the EWMA, judge
        the op against the deadline of the PRIOR estimate, and step the
        degrade and promote streaks."""
        degrade_evidence = None
        promote = False
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state in (LOST, LEFT):
                return
            prior = w.lat_ewma_s
            self._note_sample_locked(w, wall_s)
            if prior is None:
                return
            deadline = max(self.soft_min_s, self.soft_factor * prior)
            if wall_s > deadline:
                w.miss_streak += 1
                w.ok_streak = 0
                if w.state == ALIVE \
                        and w.miss_streak >= self.degrade_after:
                    degrade_evidence = (
                        f"{w.miss_streak} consecutive soft-deadline "
                        f"misses (last {wall_s * 1e3:.1f}ms > "
                        f"{deadline * 1e3:.1f}ms)")
            else:
                w.ok_streak += 1
                w.miss_streak = 0
                promote = (w.state == DEGRADED
                           and w.ok_streak >= self.promote_after
                           and self._recovered_locked(w))
        if degrade_evidence is not None:
            self.declare_degraded(wid, degrade_evidence)
        elif promote:
            self._promote(wid)

    def note_soft_deadline_miss(self, wid: str) -> None:
        """The hedged fetch saw an op pass its soft deadline while still in
        flight: count the miss now (its wall feeds the EWMA when the op
        lands)."""
        evidence = None
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state in (LOST, LEFT):
                return
            w.miss_streak += 1
            w.ok_streak = 0
            if w.state == ALIVE and w.miss_streak >= self.degrade_after:
                evidence = (f"{w.miss_streak} consecutive soft-deadline "
                            f"misses (hedged fetches)")
        if evidence is not None:
            self.declare_degraded(wid, evidence)

    def _recovered_locked(self, w: WorkerInfo) -> bool:
        """Is the worker's EWMA back under slowFactor x the healthy
        fleet's median (true with no healthy peer)?"""
        peers = [x.lat_ewma_s for x in self._workers.values()
                 if x.state == ALIVE and x.lat_ewma_s is not None]
        if not peers or w.lat_ewma_s is None:
            return True
        med = sorted(peers)[len(peers) // 2]
        return med <= 0 or w.lat_ewma_s <= self.slow_factor * med

    def _scan_stragglers(self) -> None:
        """One monitor scan of the fleet-median rule: an ALIVE worker whose
        EWMA stays past slowFactor x the median for degradeAfterMisses
        scans in a row is DEGRADED."""
        victims: List[Tuple[str, float, float]] = []
        with self._lock:
            sam = [w.lat_ewma_s for w in self._workers.values()
                   if w.state in (ALIVE, DEGRADED)
                   and w.lat_ewma_s is not None and w.lat_samples >= 3]
            if len(sam) >= 2:
                med = sorted(sam)[len(sam) // 2]
                for wid, w in self._workers.items():
                    if w.state != ALIVE or w.lat_ewma_s is None \
                            or w.lat_samples < 3:
                        continue
                    if med > 0 and w.lat_ewma_s > self.slow_factor * med:
                        w.slow_ticks += 1
                        if w.slow_ticks >= self.degrade_after:
                            victims.append((wid, w.lat_ewma_s, med))
                    else:
                        w.slow_ticks = 0
        for wid, ewma, med in victims:
            self.declare_degraded(
                wid, f"latency EWMA {ewma * 1e3:.1f}ms persistently > "
                     f"slowFactor({self.slow_factor:g}) x fleet median "
                     f"{med * 1e3:.1f}ms")

    def _speculate_away(self, wid: str) -> None:
        """Re-place what a DEGRADED worker still owns onto healthy workers
        (when one exists), remembering it as a former owner."""
        with self._lock:
            owned = [k for k, o in self._placement.items() if o == wid]
            healthy = any(x.state == ALIVE for x in self._workers.values())
        if not (owned and healthy):
            return
        moved = self._replace_owner(owned)
        if moved:
            with self._lock:
                for (e, _p) in moved:
                    self._former_owners.setdefault(e, set()).add(wid)
            PC.bump("speculative_redrives", len(moved))

    def declare_degraded(self, wid: str, evidence: str) -> bool:
        """Demote one ALIVE worker to DEGRADED: its partitions are
        re-driven onto healthy workers, without a loss declaration or the
        quarantine breaker.  True when this call demoted it."""
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state != ALIVE:
                return False
            w.state = DEGRADED
            w.ok_streak = 0
            w.slow_ticks = 0
        PC.bump("workers_degraded")
        self._speculate_away(wid)
        return True

    def _promote(self, wid: str) -> None:
        """DEGRADED -> ALIVE on sustained recovery."""
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state != DEGRADED:
                return
            w.state = ALIVE
            w.miss_streak = 0
            w.slow_ticks = 0

    def _replace_owner(
            self, keys: List[Tuple[int, int]]
    ) -> Dict[Tuple[int, int], str]:
        """Re-place (exch, pid) keys on surviving placeable workers and
        queue them for re-drive.  With no survivor the keys stay mapped to
        the lost worker (the client's re-drive then raises WorkerLost)."""
        survivors = self.placeable_workers()
        out: Dict[Tuple[int, int], str] = {}
        with self._lock:
            # re-checked under the lock: a concurrent loss may have taken
            # a survivor since the scan above
            live = [w for w in survivors if w.state == ALIVE] \
                or [w for w in survivors if w.state == DEGRADED]
            if not live:
                for e, p in keys:
                    self._redrives.setdefault(e, set()).add(p)
                return out
            loads: Dict[str, float] = {w.worker_id: 0.0 for w in live}
            for k, owner in self._placement.items():
                if owner in loads:
                    loads[owner] += self._holdings.get(k, 0)
            by_id = {w.worker_id: w for w in live}
            for e, p in sorted(keys):
                wid = min(loads, key=lambda i: (loads[i] / by_id[i]
                                                .mem_bytes, i))
                self._placement[(e, p)] = wid
                self._holdings.pop((e, p), None)
                loads[wid] += 1
                self._redrives.setdefault(e, set()).add(p)
                out[(e, p)] = wid
        return out

    # -- placement -------------------------------------------------------
    def placeable_workers(self) -> List[WorkerInfo]:
        """ALIVE and DEGRADED workers, and QUARANTINED ones whose breaker
        TTL expired (the consult admits the probe and makes them ALIVE)."""
        from spark_rapids_tpu_torch.resilience.breaker import get_breaker

        out = []
        with self._lock:
            candidates = list(self._workers.values())
        for w in candidates:
            if w.state in (ALIVE, DEGRADED):
                out.append(w)
            elif w.state == QUARANTINED:
                if get_breaker().consult((BREAKER_OP, w.worker_id),
                                         self.breaker_ttl_s) is None:
                    with self._lock:
                        if w.state == QUARANTINED:
                            w.state = ALIVE
                            out.append(w)
        return out

    def live_worker_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers.values()
                       if w.state == ALIVE)

    def worker_state(self, wid: str) -> Optional[str]:
        with self._lock:
            w = self._workers.get(wid)
            return w.state if w is not None else None

    def redrive_backlog(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._redrives.values())

    def wait_for_workers(self, n: int, timeout_s: float = 15.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.live_worker_count() >= n:
                return True
            time.sleep(0.02)
        return self.live_worker_count() >= n

    def place(self, exch: int, n_parts: int,
              est_bytes: Optional[int] = None) -> Dict[int, str]:
        """Spread an exchange's reduce partitions over the placeable
        workers, least loaded by capacity first; a DEGRADED worker's
        memory counts at 1/slowFactor."""
        workers = self.placeable_workers()
        if not workers:
            raise WorkerLost("<none>", "no placeable workers")
        per_pid = (est_bytes / n_parts) if est_bytes else 1.0
        loads = {w.worker_id: 0.0 for w in workers}
        cap = {w.worker_id: (w.mem_bytes / self.slow_factor
                             if w.state == DEGRADED else
                             float(w.mem_bytes))
               for w in workers}
        out: Dict[int, str] = {}
        with self._lock:
            self._wire_of.setdefault(exch, next(self._wire_ids))
            for pid in range(n_parts):
                wid = min(loads, key=lambda i: (loads[i] / cap[i], i))
                loads[wid] += per_pid
                out[pid] = wid
                self._placement[(exch, pid)] = wid
        return out

    def wire_of(self, exch: int) -> int:
        """The wire id a stage lease journals: worker stores key blocks by
        it, so it survives a driver restart."""
        return self._wire(exch)

    def placement_of(self, exch: int) -> Dict[int, str]:
        with self._lock:
            return {p: w for (e, p), w in self._placement.items()
                    if e == exch}

    def worker_inventory(self) -> Dict[str, List[Tuple[int, int, int,
                                                       int]]]:
        """Each ALIVE worker's re-attach inventory: worker id -> [(wire,
        pid, n_blocks, max_seq)] (empty for a worker that joined fresh).
        A journaled lease adopts only what this covers."""
        with self._lock:
            return {wid: list(w.held)
                    for wid, w in self._workers.items()
                    if w.state == ALIVE}

    def adopt_exchange(self, wire: int, placement: Dict[int, str],
                       counts: Optional[Dict[int, int]] = None) -> None:
        """Rebuild one journaled exchange's placement from re-attached
        workers: registered under its original wire id (the key the
        stores hold), holdings restored for the leak report, and the
        wire-id counter raised past it."""
        with self._lock:
            self._wire_of[wire] = wire
            for pid, wid in placement.items():
                self._placement[(wire, pid)] = wid
                if counts:
                    self._holdings[(wire, pid)] = int(counts.get(pid, 0))
            self._wire_ids = itertools.count(
                max(next(self._wire_ids), wire + 1))

    def release_orphan_holdings(self, keep: Set[int]) -> int:
        """Release every re-attach-held wire id that is neither in
        ``keep`` (adoptable leases) nor placed now (an adoption being
        served): blocks a dead incarnation shipped but never committed
        must not outlive its journal.  Returns the releases sent."""
        with self._lock:
            placed = set(self._wire_of.values())
            victims: Dict[str, Set[int]] = {}
            for wid, w in self._workers.items():
                if w.state != ALIVE or not w.held:
                    continue
                drop = {e for (e, _p, _n, _mx) in w.held
                        if e not in keep and e not in placed}
                if drop:
                    victims[wid] = drop
                    w.held = [h for h in w.held if h[0] not in drop]
        n = 0
        for wid, wires in sorted(victims.items()):
            for wire in sorted(wires):
                try:
                    self._request(wid, {"op": "release", "exch": wire},
                                  cancellable=False)
                    n += 1
                except (WorkerLost, RuntimeError, OSError):
                    # a dead worker's store dies with its process
                    pass
        return n

    def worker_stats(self, wid: str) -> Dict:
        """One worker's store stats, asked over the data plane."""
        rep, _ = self._request(wid, {"op": "stats"})
        return rep

    def _wire(self, exch: int) -> int:
        """The never-reused wire id of an exchange (the raw id for an
        unplaced one)."""
        with self._lock:
            return self._wire_of.get(exch, exch)

    def owner_of(self, exch: int, pid: int) -> str:
        with self._lock:
            wid = self._placement.get((exch, pid))
        if wid is None:
            raise KeyError(f"partition ({exch}, {pid}) is not placed")
        return wid

    def claim_redrives(self, exch: int) -> Set[int]:
        """Take (and clear) the exchange's pending re-drive pids."""
        with self._lock:
            return self._redrives.pop(exch, set())

    def mark_redrive(self, exch: int, pid: int) -> None:
        """Queue one partition for re-drive (its owner's copy was short)."""
        with self._lock:
            self._redrives.setdefault(exch, set()).add(pid)

    # -- data plane ------------------------------------------------------
    def _worker_and_lock(self, wid: str):
        with self._lock:
            w = self._workers.get(wid)
            if w is None or w.state in (LOST, LEFT):
                raise WorkerLost(wid,
                                 f"state={'?' if w is None else w.state}")
            return w, self._conn_locks.setdefault(wid, threading.Lock())

    def _dial(self, wid: str, w: WorkerInfo) -> socket.socket:
        conn = P.connect(w.host, w.data_port, self.op_timeout_s)
        with self._lock:
            self._conns[wid] = conn
        return conn

    def _evict_conn(self, wid: str, conn=None) -> None:
        with self._lock:
            cur = self._conns.get(wid)
            if cur is None or (conn is not None and cur is not conn):
                return
            del self._conns[wid]
        try:
            cur.close()
        except OSError:
            pass

    def _request(self, wid: str, header: Dict, blobs=(),
                 cancellable: bool = True) -> Tuple[Dict, List[bytes]]:
        """One data-plane request to one worker with bounded transient
        retry; exhausted retries, or a lost or unknown worker, declare the
        loss and raise :class:`WorkerLost`.  ``cancellable=False`` is the
        cleanup contract: a release for a cancelled query must still reach
        the workers."""
        from spark_rapids_tpu_torch.lifecycle.context import check_cancel
        from spark_rapids_tpu_torch.resilience.classify import (
            TRANSIENT, classify_failure)

        attempt = 0
        while True:
            if cancellable:
                check_cancel()
            w, lock = self._worker_and_lock(wid)
            t0 = time.monotonic()
            try:
                with lock:
                    conn = self._conns.get(wid) or self._dial(wid, w)
                    try:
                        out = P.request(conn, header, blobs)
                    except (OSError, ConnectionError):
                        # one reconnect inside the same attempt: the
                        # pooled connection may simply be stale
                        self._evict_conn(wid, conn)
                        out = P.request(self._dial(wid, w), header, blobs)
                self.note_op_latency(wid, time.monotonic() - t0)
                return out
            except (OSError, ConnectionError, socket.timeout,
                    P.RemoteOpError, P.ProtocolCorruption) as e:
                # always evict: a corrupted frame leaves the stream
                # mid-frame, and reusing it would fail every later op
                self._evict_conn(wid)
                attempt += 1
                # a RemoteOpError (the worker answered but cannot serve)
                # is treated as a dead socket; a corrupted frame retries
                # on a fresh connection
                retryable = isinstance(e, P.ProtocolCorruption) \
                    or (not isinstance(e, P.RemoteOpError)
                        and classify_failure(e) == TRANSIENT)
                if retryable and attempt <= self.put_retries:
                    _full_jitter_sleep(attempt)
                    continue
                if self.worker_state(wid) == DEGRADED:
                    # slow, not dead: speculate what it still owns and
                    # raise the typed degradation (the caller re-drives)
                    self._speculate_away(wid)
                    raise WorkerDegraded(
                        wid, f"{type(e).__name__}: {e}") from e
                self.declare_lost(wid, f"{type(e).__name__}: {e}")
                raise WorkerLost(wid, f"{type(e).__name__}: {e}") from e

    def _trace_fields(self) -> Dict:
        """The trace stamp of an outgoing data-plane header: the active
        query's trace id, or nothing when tracing is off or no
        lifecycle-managed query runs."""
        if not self.trace_enabled:
            return {}
        from spark_rapids_tpu_torch.lifecycle.context import current

        ctx = current()
        if ctx is None:
            return {}
        return {"trace": ctx.trace_id or ctx.query_id}

    def _ensure_live_owner(self, exch: int, pid: int) -> str:
        """The partition's owner, re-placed first if a concurrent loss left
        it mapped to a dead worker."""
        wid = self.owner_of(exch, pid)
        with self._lock:
            w = self._workers.get(wid)
            dead = w is None or w.state in (LOST, LEFT)
        if dead:
            wid = self._replace_owner([(exch, pid)]).get((exch, pid))
            if wid is None:
                raise WorkerLost(
                    "<none>", f"partition ({exch}, {pid}) owner dead "
                              f"and no placeable survivors")
        return wid

    def put_block(self, exch: int, pid: int, seq: int,
                  blob: bytes, redrive: bool = False) -> str:
        """Ship one block to the partition's owner; returns the owner's id
        (raises WorkerLost when the owner died and the retries ran out —
        the caller then re-drives).  ``redrive`` marks a lineage replay."""
        wid = self._ensure_live_owner(exch, pid)
        header = {"op": "put", "exch": self._wire(exch),
                  "pid": pid, "seq": seq, **self._trace_fields()}
        if redrive:
            header["redrive"] = 1
        self._request(wid, header, [blob])
        with self._lock:
            # distinct blocks, not sends: replays re-send sequences the
            # worker deduplicates
            self._holdings[(exch, pid)] = max(
                self._holdings.get((exch, pid), 0), seq + 1)
        PC.bump("dist_blocks_shipped")
        PC.bump("dist_block_bytes", len(blob))
        return wid

    def fetch_blocks(self, exch: int, pid: int, after_seq: int = -1,
                     max_bytes: int = 0
                     ) -> Tuple[List[int], List[bytes], int]:
        """One page of a partition from its owner (sequences above
        ``after_seq``, about ``max_bytes``): (seqs, blobs, the owner's
        total block count of the partition)."""
        wid = self._ensure_live_owner(exch, pid)
        rep, blobs = self._request(
            wid, {"op": "fetch", "exch": self._wire(exch), "pid": pid,
                  "after_seq": after_seq, "max_bytes": max_bytes,
                  **self._trace_fields()})
        return ([int(s) for s in rep.get("seqs", [])], blobs,
                int(rep.get("n_total", len(blobs))))

    def note_worker_ok(self, wid: str) -> None:
        """A probed (once quarantined) worker served: close its breaker
        entry."""
        from spark_rapids_tpu_torch.resilience.breaker import get_breaker

        get_breaker().record_success((BREAKER_OP, wid))

    # -- release and leaks -----------------------------------------------
    def release_exchange(self, exch: int) -> None:
        """Drop one exchange everywhere — placement, holdings, pending
        re-drives — and tell every worker that held any of it (the query
        committed or died: remote copies must not outlive it)."""
        with self._lock:
            owners = {w for (e, _), w in self._placement.items()
                      if e == exch}
            owners |= self._former_owners.pop(exch, set())
            for k in [k for k in self._placement if k[0] == exch]:
                del self._placement[k]
                self._holdings.pop(k, None)
            self._redrives.pop(exch, None)
            wire = self._wire_of.pop(exch, exch)
        for wid in sorted(owners):
            try:
                self._request(wid, {"op": "release", "exch": wire,
                                    **self._trace_fields()},
                              cancellable=False)
            except (WorkerLost, RuntimeError, OSError):
                # a dead worker's store dies with its process
                pass

    def release_all(self) -> None:
        with self._lock:
            exchanges = {e for (e, _) in self._placement}
        for e in sorted(exchanges):
            self.release_exchange(e)

    def leak_report(self) -> List[str]:
        """One line per exchange still placed remotely."""
        with self._lock:
            by_exch: Dict[int, int] = {}
            for (e, _p) in self._placement:
                by_exch[e] = by_exch.get(e, 0) + 1
        return [f"LEAK: distributed exchange {e} still placed "
                f"({n} partitions on remote workers)"
                for e, n in sorted(by_exch.items())]

    def collect_trace(self, trace_id: Optional[str] = None) -> List[Dict]:
        """Each worker's telemetry as its heartbeats last carried it: state,
        pid, clock offset, counters, store stats, and the spans of its ring
        (those of ``trace_id`` when given).  A SIGKILLed worker keeps what
        its last heartbeat shipped."""
        out = []
        with self._lock:
            for w in self._workers.values():
                ring = [e for e in w.mirror
                        if not trace_id or e.get("trace") == trace_id]
                if ring or w.counters:
                    out.append({"worker_id": w.worker_id, "state": w.state,
                                "pid": w.pid,
                                "clock_offset_s": w.clock_offset_s,
                                "counters": dict(w.counters),
                                "store_stats": dict(w.store_stats),
                                "ring": ring})
        return out

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            socks = list(self._conns.values()) + [
                w.control for w in self._workers.values()
                if w.control is not None]
            self._conns.clear()
            # membership ends with the coordinator: threads waking on the
            # closed sockets must not declare stray losses
            for w in self._workers.values():
                if w.state in (ALIVE, QUARANTINED, DEGRADED):
                    w.state = LEFT
        for s in socks:
            try:
                s.close()
            except OSError:
                pass

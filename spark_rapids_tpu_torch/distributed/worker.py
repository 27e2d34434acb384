"""Worker process — one exchange-buffer node of the distributed tier (port
of ``spark_rapids_tpu/distributed/worker.py``, stdlib only).

A worker owns the reduce partitions the coordinator places on it: it keeps
their CRC-framed TKU2 blocks (in memory up to a budget, then one file per
block in a spill directory), serves fetches, and heartbeats so the
coordinator can tell a live worker from a dead one.  Everything it holds
can be re-driven from the engine's retained copies, so killing one loses
no query.  Ops on the data listener (the control socket to the
coordinator carries only HELLO and heartbeats):

  put     {exch, pid, seq}+blob -> {ok}     store one partition block
  fetch   {exch, pid} -> {seqs}+blobs       one page of a partition
  release {exch} -> {ok}                    drop one exchange's blocks
  stats   {} -> {ok, blocks, bytes, ...}    the store's stats
  ping    {} -> {ok}

Every op bumps worker-local counters (:data:`WORKER_COUNTER_KEYS`), and an
op whose header carries ``trace``/``span`` records a span in a bounded
ring.  Heartbeats carry the counter snapshot, the ring entries since the
last beat and the store's stats.

With a re-attach window (``--reattach-ms``) the worker outlives a dead
driver: when its heartbeats find the control socket dead it re-dials for
up to that long, re-reading the endpoint file (``--endpoint-file``, which
the successor coordinator publishes under the recovery root), and its
HELLO then carries the inventory of what it holds, so a journaled lease
on those blocks can be adopted.  Without it, membership ends with the
control socket.

Run as a process:

    python -m spark_rapids_tpu_torch.distributed.worker \
        (--coordinator 127.0.0.1:<port> | --endpoint-file FILE) \
        [--reattach-ms 120000] [--worker-id w0] \
        [--mem-bytes 67108864] [--heartbeat-ms 200] [--spill-dir DIR]

It imports neither torch nor anything of the engine but ``protocol``, so
it starts in well under a second and never opens a CUDA context.  The
reference's compile-cache warm (``--warm-compile-dir``, accepted and
ignored here) and its ``dump`` op are not ported.
"""
from __future__ import annotations

import argparse
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.distributed import protocol as P

# the worker-local counter vocabulary; these live in the worker process and
# reach the engine only as the snapshot each heartbeat carries
WORKER_COUNTER_KEYS = (
    "store_puts",            # blocks landed (idempotent dedups excluded)
    "store_put_bytes",       # bytes landed
    "store_put_dedups",      # idempotent re-sends dropped (seq existed)
    "store_redrive_puts",    # puts flagged as lineage re-drives
    "store_fetches",         # fetch pages served
    "store_blocks_served",   # blocks returned across fetch pages
    "store_bytes_served",    # bytes returned across fetch pages
    "store_overflow_blocks",  # puts that overflowed memory to disk
    "store_overflow_bytes",  # bytes written to the spill directory
    "put_wall_ns",           # wall inside put handling
    "fetch_wall_ns",         # wall inside fetch handling (page walls)
)


class WorkerTelemetry:
    """Worker-local counters and a bounded span ring.

    The ring holds one event per traced data-plane op:
    ``{"n": ring-seq, "kind": put|redrive_put|spill|fetch|release,
    "trace": query trace id, "span": engine operator path, "exch",
    "pid", "seq": block seq (-1 when n/a), "bytes", "ts_wall":
    time.time() at op start, "dur_ns"}``.  ``n`` is monotonic per
    worker incarnation, so the coordinator's mirror deduplicates the
    heartbeat deltas on it."""

    def __init__(self, ring_capacity: int = 512):
        self._lock = threading.Lock()
        self.ring_capacity = max(int(ring_capacity), 0)
        self.counters: Dict[str, int] = {k: 0 for k in WORKER_COUNTER_KEYS}
        self._ring: deque = deque(maxlen=self.ring_capacity or 1)
        self._seq = 0
        self._last_shipped = 0     # ring seq already heartbeat-shipped

    def bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def span(self, kind: str, trace: str, span: str, exch: int,
             pid: int, seq: int, nbytes: int, ts_wall: float,
             dur_ns: int) -> None:
        if self.ring_capacity <= 0:
            return
        with self._lock:
            self._seq += 1
            self._ring.append({
                "n": self._seq, "kind": kind, "trace": trace,
                "span": span, "exch": int(exch), "pid": int(pid),
                "seq": int(seq), "bytes": int(nbytes),
                "ts_wall": round(float(ts_wall), 6),
                "dur_ns": int(dur_ns)})

    def counters_snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counters)

    def drain_unshipped(self) -> List[Dict]:
        """Ring entries recorded since the previous heartbeat (the
        piggyback payload) — the mirror dedups on ``n`` anyway, so a
        lost heartbeat only costs the window the ring itself rotated
        out."""
        with self._lock:
            out = [e for e in self._ring if e["n"] > self._last_shipped]
            if out:
                self._last_shipped = out[-1]["n"]
            return out


class PartitionStore:
    """Blocks keyed (exchange, pid) -> ordered (seq, blob) entries, with
    bounded memory residency; over-budget blocks land as files in the
    spill dir (one file per block — blocks are already CRC-framed, so
    disk rot surfaces at deserialize time as ShuffleCorruption)."""

    def __init__(self, mem_bytes: int, spill_dir: Optional[str] = None,
                 telemetry: Optional[WorkerTelemetry] = None):
        self.mem_bytes = max(int(mem_bytes), 0)
        self.telemetry = telemetry
        self._spill_dir = spill_dir
        self._made_spill_dir = spill_dir is None
        self._lock = threading.Lock()
        # (exch, pid) -> {seq: ("mem"|"disk", blob|path)} — keyed by
        # sequence so the idempotent-put dedup is O(1), not a linear
        # scan per block on a thousands-of-blocks partition
        self._parts: Dict[Tuple[int, int],
                          Dict[int, Tuple[str, object]]] = {}
        self._mem_used = 0
        self.blocks = 0
        self.bytes = 0
        self.spilled_blocks = 0

    def _spill_path(self, exch: int, pid: int, seq: int) -> str:
        if self._spill_dir is None:
            # pid-stamped (not mkdtemp-random): a SIGKILLed worker —
            # the central scenario of this tier — cannot clean up after
            # itself, so the name must let reap_stale_spill_dirs()
            # identify dead owners' leftovers later
            self._spill_dir = os.path.join(
                tempfile.gettempdir(), f"srt_dist_worker_{os.getpid()}")
        os.makedirs(self._spill_dir, exist_ok=True)
        return os.path.join(self._spill_dir,
                            f"part_{exch}_{pid}_{seq}.blk")

    def put(self, exch: int, pid: int, seq: int, blob: bytes) -> str:
        """Store one block; returns where it landed — ``"mem"``,
        ``"disk"`` (memory budget overflowed to the spill dir), or
        ``"dup"`` (idempotent re-drive: the block already landed)."""
        tel = self.telemetry
        with self._lock:
            entries = self._parts.setdefault((exch, pid), {})
            if seq in entries:
                if tel is not None:
                    tel.bump("store_put_dedups")
                return "dup"
            if self._mem_used + len(blob) <= self.mem_bytes:
                entries[seq] = ("mem", blob)
                self._mem_used += len(blob)
                kind = "mem"
            else:
                path = self._spill_path(exch, pid, seq)
                with open(path, "wb") as f:
                    f.write(blob)
                entries[seq] = ("disk", path)
                self.spilled_blocks += 1
                kind = "disk"
            self.blocks += 1
            self.bytes += len(blob)
        if tel is not None:
            tel.bump("store_puts")
            tel.bump("store_put_bytes", len(blob))
            if kind == "disk":
                tel.bump("store_overflow_blocks")
                tel.bump("store_overflow_bytes", len(blob))
        return kind

    def fetch(self, exch: int, pid: int, after_seq: int = -1,
              max_bytes: int = 0) -> Tuple[List[int], List[bytes], int]:
        """One PAGE of a partition's blocks: sequences above
        ``after_seq``, up to ~``max_bytes`` (0 = everything; at least
        one block always returns).  Paging keeps a huge reduce
        partition out of any single wire frame and off this process's
        heap — spilled blocks load lazily per page.  Returns (seqs,
        blobs, total block count for the partition)."""
        with self._lock:
            part = self._parts.get((exch, pid), {})
            n_total = len(part)
            entries = sorted((s, kv) for s, kv in part.items()
                             if s > after_seq)
        seqs: List[int] = []
        blobs: List[bytes] = []
        total = 0
        for seq, (kind, x) in entries:
            if kind == "mem":
                blob = x
            else:
                with open(x, "rb") as f:
                    blob = f.read()
            if blobs and max_bytes and total + len(blob) > max_bytes:
                break
            seqs.append(seq)
            blobs.append(blob)
            total += len(blob)
        tel = self.telemetry
        if tel is not None:
            tel.bump("store_fetches")
            tel.bump("store_blocks_served", len(seqs))
            tel.bump("store_bytes_served", total)
        return seqs, blobs, n_total

    def release(self, exch: int) -> int:
        with self._lock:
            victims = [k for k in self._parts if k[0] == exch]
            dropped = 0
            for k in victims:
                for kind, x in self._parts.pop(k).values():
                    dropped += 1
                    self.blocks -= 1
                    if kind == "mem":
                        self._mem_used -= len(x)
                        self.bytes -= len(x)
                    else:
                        try:
                            self.bytes -= os.path.getsize(x)
                            os.unlink(x)
                        except OSError:
                            pass
            return dropped

    def inventory(self) -> List[Tuple[int, int, int, int]]:
        """Every held partition as (exch, pid, n_blocks, max_seq): what a
        re-attaching HELLO enumerates, so a reborn coordinator can adopt
        journaled leases on them."""
        with self._lock:
            return [(e, p, len(d), max(d) if d else -1)
                    for (e, p), d in sorted(self._parts.items())]

    def stats(self) -> Dict:
        with self._lock:
            return {"blocks": self.blocks, "bytes": self.bytes,
                    "mem_used": self._mem_used,
                    "mem_bytes": self.mem_bytes,
                    "spilled_blocks": self.spilled_blocks,
                    "partitions": len(self._parts)}

    def close(self) -> None:
        with self._lock:
            self._parts.clear()
            self._mem_used = 0
        if self._made_spill_dir and self._spill_dir:
            shutil.rmtree(self._spill_dir, ignore_errors=True)


def reap_stale_spill_dirs() -> int:
    """Remove ``srt_dist_worker_<pid>`` spill dirs whose owning process
    is gone — SIGKILLed workers cannot clean up after themselves, so
    every STARTING worker sweeps the graveyard (best-effort; foreign
    dirs that refuse to die are left alone).  Returns dirs removed."""
    reaped = 0
    tmp = tempfile.gettempdir()
    try:
        names = os.listdir(tmp)
    except OSError:
        return 0
    for name in names:
        if not name.startswith("srt_dist_worker_"):
            continue
        pid_s = name[len("srt_dist_worker_"):]
        if not pid_s.isdigit() or int(pid_s) == os.getpid():
            continue
        try:
            os.kill(int(pid_s), 0)
            continue              # owner still alive
        except ProcessLookupError:
            pass
        except OSError:
            continue              # e.g. EPERM: someone else's pid space
        shutil.rmtree(os.path.join(tmp, name), ignore_errors=True)
        reaped += 1
    return reaped


class WorkerServer:
    """The in-process server object (``main`` runs one; tests drive it
    directly)."""

    def __init__(self, coordinator: Optional[Tuple[str, int]],
                 worker_id: str,
                 mem_bytes: int = 64 << 20, heartbeat_ms: int = 200,
                 spill_dir: Optional[str] = None,
                 op_timeout_ms: int = 4000,
                 telemetry_ring: int = 512,
                 reattach_ms: int = 0,
                 endpoint_file: Optional[str] = None):
        self.coordinator = coordinator
        self.worker_id = worker_id
        self.heartbeat_s = max(heartbeat_ms, 10) / 1000.0
        self.op_timeout_s = max(op_timeout_ms, 100) / 1000.0
        # with a re-attach window the worker outlives a dead driver and
        # re-dials its successor; 0 ends membership with the control
        # socket
        self.reattach_ms = max(int(reattach_ms), 0)
        self.endpoint_file = endpoint_file
        if spill_dir is None:
            reap_stale_spill_dirs()
        self.telemetry = WorkerTelemetry(telemetry_ring)
        self.store = PartitionStore(mem_bytes, spill_dir,
                                    telemetry=self.telemetry)
        self.mem_bytes = mem_bytes
        self._stop = threading.Event()
        self._reattaching = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._control: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self.data_port: Optional[int] = None

    # -- lifecycle -------------------------------------------------------
    def _resolve_endpoint(self) -> Optional[Tuple[str, int]]:
        """The coordinator to dial: the endpoint file (re-read at every
        attempt, since a reborn coordinator listens on a new port) when
        one is given and readable, else ``--coordinator``."""
        if self.endpoint_file:
            try:
                with open(self.endpoint_file) as f:
                    host, port = f.read().strip().rsplit(":", 1)
                return host, int(port)
            except (OSError, ValueError):
                pass
        return self.coordinator

    def _join(self, endpoint: Tuple[str, int],
              reattach: bool) -> socket.socket:
        """Dial, HELLO and the coordinator's welcome on one control
        socket.  A re-attaching HELLO carries the held inventory."""
        c = P.connect(endpoint[0], endpoint[1], self.op_timeout_s)
        try:
            P.send_msg(c, {"op": "hello", "worker_id": self.worker_id,
                           "data_port": self.data_port, "pid": os.getpid(),
                           "mem_bytes": self.mem_bytes,
                           "reattach": bool(reattach),
                           "held": (self.store.inventory() if reattach
                                    else []),
                           "t_wall": time.time()})
            rep, _ = P.recv_msg(c)
            if rep.get("op") != "welcome":
                raise ConnectionError(f"unexpected join reply: {rep}")
        except BaseException:
            c.close()
            raise
        return c

    def start(self) -> None:
        """Open the data listener, then join."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(32)
        self.data_port = self._listener.getsockname()[1]
        endpoint = self._resolve_endpoint()
        if endpoint is None and self.endpoint_file:
            # the worker may start before the coordinator publishes
            deadline = time.monotonic() + self.op_timeout_s * 4
            while endpoint is None and time.monotonic() < deadline:
                time.sleep(0.05)
                endpoint = self._resolve_endpoint()
        if endpoint is None:
            raise ConnectionError("no coordinator endpoint (neither "
                                  "--coordinator nor a readable endpoint "
                                  "file)")
        self._control = self._join(endpoint, reattach=False)
        for target, name in ((self._serve_loop, "accept"),
                             (self._heartbeat_loop, "heartbeat")):
            t = threading.Thread(
                target=target, daemon=True,
                name=f"srt-dist-worker-{self.worker_id}-{name}")
            t.start()
            self._threads.append(t)

    def stop(self, goodbye: bool = True) -> None:
        self._stop.set()
        if goodbye and self._control is not None:
            try:
                P.send_msg(self._control, {"op": "goodbye",
                                           "worker_id": self.worker_id})
            except OSError:
                pass
        for s in (self._control, self._listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._control = self._listener = None
        self.store.close()

    def run_forever(self) -> None:
        """Block until the control socket dies (the coordinator is gone or
        evicted this worker) or ``stop()`` is called.  A re-attach in
        progress is not a dead control socket: the process stays up
        through the window, or its blocks would die with it."""
        while not self._stop.wait(self.heartbeat_s):
            if self._control is None and not self._reattaching.is_set():
                break

    # -- heartbeats ------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            c = self._control
            if c is None:
                return
            try:
                P.send_msg(c, {"op": "heartbeat",
                               "worker_id": self.worker_id,
                               "counters":
                                   self.telemetry.counters_snapshot(),
                               "ring": self.telemetry.drain_unshipped(),
                               "t_wall": time.time(),
                               **self.store.stats()})
            except OSError:
                # the coordinator hung up: a LOST declaration closed our
                # socket, or the coordinator itself is gone.  With a
                # re-attach window the driver's death is survivable
                if self._try_reattach():
                    continue
                self._stop.set()
                self._control = None
                return

    def _try_reattach(self) -> bool:
        """Re-dial for up to ``reattach_ms``: resolve the endpoint anew,
        HELLO with the held inventory, and resume heartbeating.  False
        when the window is 0, ``stop()`` raced, or the window ran out."""
        if self.reattach_ms <= 0 or self._stop.is_set():
            return False
        self._reattaching.set()
        try:
            old, self._control = self._control, None
            if old is not None:
                try:
                    old.close()
                except OSError:
                    pass
            deadline = time.monotonic() + self.reattach_ms / 1000.0
            while not self._stop.is_set() \
                    and time.monotonic() < deadline:
                endpoint = self._resolve_endpoint()
                if endpoint is not None:
                    try:
                        self._control = self._join(endpoint, reattach=True)
                        return True
                    except (OSError, ConnectionError,
                            P.ProtocolCorruption):
                        pass
                if self._stop.wait(min(self.heartbeat_s, 0.2)):
                    return False
            return False
        finally:
            self._reattaching.clear()

    # -- data plane ------------------------------------------------------
    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.settimeout(self.op_timeout_s * 4)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True,
                                 name=f"srt-dist-data-{self.worker_id}")
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    header, blobs = P.recv_msg(conn)
                except (OSError, ConnectionError):
                    return
                try:
                    reply, rblobs = self._handle(header, blobs)
                except P.ProtocolCorruption as e:
                    reply, rblobs = {"error": f"corrupt: {e}"}, []
                except Exception as e:   # a bad op must not kill the conn
                    reply, rblobs = {
                        "error": f"{type(e).__name__}: {e}"}, []
                # echo the request's correlation id so the client can
                # detect duplicated or reordered reply frames
                # (protocol.ProtocolDesync)
                if "rid" in header:
                    reply.setdefault("rid", header["rid"])
                try:
                    P.send_msg(conn, reply, rblobs)
                except OSError:
                    return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, h: Dict, blobs: List[bytes]) -> Tuple[Dict, list]:
        op = h.get("op")
        trace = str(h.get("trace", "") or "")
        span = str(h.get("span", "") or "")
        tel = self.telemetry
        if op == "put":
            t_wall = time.time()
            t0 = time.perf_counter_ns()
            blob = blobs[0] if blobs else b""
            redrive = bool(h.get("redrive"))
            landed = self.store.put(int(h["exch"]), int(h["pid"]),
                                    int(h["seq"]), blob)
            dur = time.perf_counter_ns() - t0
            tel.bump("put_wall_ns", dur)
            if redrive and landed != "dup":
                tel.bump("store_redrive_puts")
            # untraced frames (tracing off, non-query tooling) record
            # counters only — a span without a trace id could never be
            # attributed and would just rotate attributed history out
            # of the bounded ring
            if trace and landed != "dup":
                kind = ("redrive_put" if redrive
                        else "spill" if landed == "disk" else "put")
                tel.span(kind, trace, span, int(h["exch"]),
                         int(h["pid"]), int(h["seq"]), len(blob),
                         t_wall, dur)
            return {"ok": True}, []
        if op == "fetch":
            t_wall = time.time()
            t0 = time.perf_counter_ns()
            seqs, out, n_total = self.store.fetch(
                int(h["exch"]), int(h["pid"]),
                after_seq=int(h.get("after_seq", -1)),
                max_bytes=int(h.get("max_bytes", 0)))
            dur = time.perf_counter_ns() - t0
            tel.bump("fetch_wall_ns", dur)
            if trace and seqs:
                tel.span("fetch", trace, span, int(h["exch"]),
                         int(h["pid"]), seqs[-1],
                         sum(len(b) for b in out), t_wall, dur)
            return {"ok": True, "seqs": seqs, "n_total": n_total}, out
        if op == "release":
            t_wall = time.time()
            t0 = time.perf_counter_ns()
            dropped = self.store.release(int(h["exch"]))
            if trace and dropped:
                tel.span("release", trace, span, int(h["exch"]), -1, -1,
                         0, t_wall, time.perf_counter_ns() - t0)
            return {"ok": True, "dropped": dropped}, []
        if op == "stats":
            return {"ok": True, **self.store.stats()}, []
        if op == "ping":
            return {"ok": True, "worker_id": self.worker_id}, []
        return {"error": f"unknown op {op!r}"}, []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the coordinator's listener (or "
                         "--endpoint-file)")
    ap.add_argument("--endpoint-file", default=None,
                    help="the coordinator.endpoint file under the "
                         "recovery root, re-read at every (re-)attach so "
                         "a reborn coordinator's new port is found")
    ap.add_argument("--reattach-ms", type=int, default=0,
                    help="on heartbeat loss, re-dial the coordinator for "
                         "up to this many ms instead of exiting (0: exit)")
    ap.add_argument("--worker-id", default=f"w-{os.getpid()}")
    ap.add_argument("--mem-bytes", type=int, default=64 << 20)
    ap.add_argument("--heartbeat-ms", type=int, default=200)
    ap.add_argument("--op-timeout-ms", type=int, default=4000)
    ap.add_argument("--spill-dir", default=None)
    ap.add_argument("--warm-compile-dir", default=None,
                    help="accepted for the reference's command line and "
                         "ignored: the port has no compile cache to warm")
    ap.add_argument("--telemetry-ring", type=int, default=512,
                    help="span ring capacity (0 disables span recording; "
                         "counters still travel on the heartbeats)")
    args = ap.parse_args(argv)
    if not args.coordinator and not args.endpoint_file:
        ap.error("one of --coordinator and --endpoint-file is required")

    srv = WorkerServer(
        (P.parse_endpoint(args.coordinator) if args.coordinator
         else None), args.worker_id,
        mem_bytes=args.mem_bytes, heartbeat_ms=args.heartbeat_ms,
        spill_dir=args.spill_dir, op_timeout_ms=args.op_timeout_ms,
        telemetry_ring=args.telemetry_ring,
        reattach_ms=args.reattach_ms, endpoint_file=args.endpoint_file)
    try:
        srv.start()
    except OSError as e:
        print(f"worker {args.worker_id}: cannot join: {e}",
              file=sys.stderr)
        return 1
    try:
        srv.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The distributed tier — port of ``spark_rapids_tpu/distributed/``.

Worker processes hold an exchange's reduce partitions, a coordinator in
the engine places them, and blocks cross as CRC-framed TKU2 blocks over
the TKD1 control protocol.  The engine's spill-backed partition queues
double as the lineage buffer: every shipped block is retained until the
consuming stage has read its partition, so a SIGKILLed worker is recovered
by re-placing its partitions on survivors and re-driving the retained
blocks.

* ``protocol.py``    — TKD1 framing and the WorkerLost taxonomy;
* ``worker.py``      — the worker process (store, heartbeats, data server);
* ``coordinator.py`` — membership, liveness, placement, the re-drive plan;
* ``client.py``      — DistributedExchange (produce, consume, lineage
  retry, hedged fetches).

    JOINED --heartbeats--> ALIVE <--> DEGRADED
    ALIVE --workerLostMs silence and a failed ping, or a dead socket--> LOST
    LOST --rejoin, breaker OPEN--> QUARANTINED --TTL probe--> ALIVE

A worker process imports this package and ``protocol`` only, neither of
which imports torch: the coordinator is imported behind the accessors.
Cleanup paths only ever *peek* (a leak sweep must never build a
coordinator), and ``reset_coordinator`` tears the listener down.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import List, Optional

from spark_rapids_tpu_torch.distributed.protocol import (  # noqa: F401
    ProtocolCorruption, WorkerLost)

_lock = threading.Lock()
_coordinator = None


def get_coordinator(conf=None):
    """The process's coordinator, built on first use."""
    global _coordinator
    with _lock:
        if _coordinator is None:
            from spark_rapids_tpu_torch.distributed.coordinator import (
                Coordinator)

            _coordinator = Coordinator(conf)
        return _coordinator


def peek_coordinator():
    """The coordinator if it exists; never creates one."""
    return _coordinator


def reset_coordinator() -> None:
    global _coordinator
    with _lock:
        c, _coordinator = _coordinator, None
    if c is not None:
        c.shutdown()


def spawn_local_worker(coordinator, worker_id: str,
                       mem_bytes: Optional[int] = None,
                       reattach_ms: Optional[int] = None,
                       endpoint_file: Optional[str] = None
                       ) -> subprocess.Popen:
    """Launch one worker process against ``coordinator`` (fork and exec of
    a fresh interpreter, never a fork of this one: the engine process may
    hold a CUDA context).  The worker holds serialized blocks, not device state,
    so it is started with ``CUDA_VISIBLE_DEVICES`` empty and never sees
    the card.  Its heartbeat period, op timeout and span ring are the
    coordinator's, and so is its store size unless ``mem_bytes`` is given
    (``spark.rapids.tpu.distributed.workerMemoryBytes``).  ``reattach_ms``
    and ``endpoint_file`` arm crash recovery: the worker survives this
    driver's death and re-dials whatever endpoint its successor
    publishes."""
    if mem_bytes is None:
        mem_bytes = coordinator.worker_mem
    cmd = [sys.executable, "-m", "spark_rapids_tpu_torch.distributed.worker",
           "--coordinator", f"127.0.0.1:{coordinator.port}",
           "--worker-id", worker_id,
           "--mem-bytes", str(int(mem_bytes)),
           "--heartbeat-ms", str(int(coordinator.heartbeat_s * 1000)),
           "--op-timeout-ms", str(int(coordinator.op_timeout_s * 1000)),
           "--telemetry-ring", str(int(coordinator.telemetry_ring))]
    if reattach_ms:
        cmd += ["--reattach-ms", str(int(reattach_ms))]
    if endpoint_file:
        cmd += ["--endpoint-file", endpoint_file]
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def leak_report() -> List[str]:
    """Exchanges still placed on remote workers (a lifecycle leak-report
    hook)."""
    c = peek_coordinator()
    return c.leak_report() if c is not None else []

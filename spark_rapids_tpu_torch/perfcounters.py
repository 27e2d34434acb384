"""Performance accounting — the counting half of ``spark_rapids_tpu/perfcounters.py``.

The counts are the portable truth about engine quality: how many host
round trips a query costs and how many bytes cross the host<->device link.
The reference counts syncs by patching jax's array dunders; the port instead
routes every device->host read of the engine through :func:`sync_get`, and
every upload through :func:`count_h2d`.  Kernel launches are counted by each
kernel's wrapper (``pallas/decode.py::unpack_launches``).

Counters are process-global, read with ``snapshot``/``since``.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np
import torch

_LOCK = threading.Lock()

COUNTERS: Dict[str, int] = {
    "host_syncs": 0,
    "bytes_d2h": 0,
    "bytes_h2d": 0,
    # bytes_h2d counts PHYSICAL link bytes (a compressed page counts its
    # compressed size); bytes_h2d_logical the decoded bytes they carry
    "bytes_h2d_logical": 0,
    "pages_device_decompressed": 0,
    "chunk_decode_fallbacks": 0,
    "scan_transfer_ns": 0,
    "snappy_gather_passes": 0,
    "partitions_coalesced": 0,
    # out-of-core exchange: sized exchanges planned; wall inside the
    # partition-id / slice work and inside the spill-backed queues
    # (serialize, track, materialize); slices framed across the host
    # boundary and their bytes
    "exchange_partitions_planned": 0,
    "exchange_partition_ns": 0,
    "exchange_spill_ns": 0,
    "exchange_host_blocks": 0,
    "exchange_host_block_bytes": 0,
    # OOM retry outcomes (memory/retry.py): a split of the input, and the
    # reference's governor preemption, which the port does not run
    "oom_retry_preempts": 0,
    "oom_retry_splits": 0,
    # out-of-core sort (exec/sort.py): sorted runs, merge windows, and the
    # bytes_h2d the merge's window reads moved
    "ooc_sort_runs": 0,
    "ooc_sort_merge_windows": 0,
    "ooc_sort_merge_upload_bytes": 0,
    # query lifecycle (lifecycle/): admissions, fast rejects, cancelled
    # queries, watchdog deadline trips, and wall spent queued
    "queries_admitted": 0,
    "queries_rejected": 0,
    "queries_cancelled": 0,
    "deadline_trips": 0,
    "admission_wait_ns": 0,
    # distributed tier (distributed/): worker joins (quarantined rejoins
    # included), LOST declarations, monitor scans that caught a late
    # heartbeat, reduce partitions re-driven from the engine's retained
    # blocks after a loss, and the blocks shipped to workers
    "workers_joined": 0,
    "worker_lost": 0,
    "worker_heartbeat_misses": 0,
    "partitions_replayed": 0,
    "dist_blocks_shipped": 0,
    "dist_block_bytes": 0,
    # gray failure: hedged page fetches launched after a soft-deadline
    # miss, hedges the retained copy won, DEGRADED declarations, and
    # partitions re-driven off a DEGRADED worker
    "fetch_hedges": 0,
    "hedges_won": 0,
    "workers_degraded": 0,
    "speculative_redrives": 0,
    # plan nodes the circuit breaker kept off the device at tagging
    "breaker_plan_fallbacks": 0,
    # crash-consistent recovery (lifecycle/journal.py): journal records
    # appended, stages served from a checkpoint, queries that served at
    # least one, checkpoints or journal files discarded as damaged or
    # orphaned, and checkpoints retired past their lease
    "journal_records_written": 0,
    "stages_recovered": 0,
    "queries_resumed": 0,
    "journal_recovery_discards": 0,
    "recovery_leases_expired": 0,
    # hot-table cache (io/hot_cache.py): scans served from the cache,
    # scans that missed, and entries evicted past its bound
    "hot_cache_hits": 0,
    "hot_cache_misses": 0,
    "hot_cache_evictions": 0,
}

# High-water marks, set to 0 by ``reset_peaks`` and read by ``peaks`` (the
# idiom of ``torch.cuda.reset_peak_memory_stats``); a difference of two
# snapshots means nothing for a maximum, so they stay out of ``COUNTERS``.
PEAKS: Dict[str, int] = {
    # the most bytes_h2d one out-of-core merge window moved
    "ooc_sort_merge_window_upload_bytes": 0,
}


def bump(key: str, n: int = 1) -> None:
    """Thread-safe increment (``COUNTERS[k] += n`` is not atomic)."""
    with _LOCK:
        COUNTERS[key] = COUNTERS.get(key, 0) + n


def note_peak(key: str, n: int) -> None:
    with _LOCK:
        PEAKS[key] = max(PEAKS.get(key, 0), n)


def reset_peaks() -> None:
    with _LOCK:
        for k in PEAKS:
            PEAKS[k] = 0


def peaks() -> Dict[str, int]:
    with _LOCK:
        return dict(PEAKS)


def read(key: str) -> int:
    with _LOCK:
        return COUNTERS[key]


def snapshot() -> Dict[str, int]:
    with _LOCK:
        return dict(COUNTERS)


def since(snap: Dict[str, int]) -> Dict[str, int]:
    cur = snapshot()
    return {k: cur[k] - snap.get(k, 0) for k in cur}


def count_h2d(nbytes: int, logical: Optional[int] = None) -> None:
    """Host->device transfer accounting (called from upload sites)."""
    bump("bytes_h2d", int(nbytes))
    bump("bytes_h2d_logical", int(nbytes if logical is None else logical))


def to_device(arr: np.ndarray, device, logical: Optional[int] = None
              ) -> torch.Tensor:
    """Upload one numpy array, counting its bytes."""
    count_h2d(arr.nbytes, logical)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:      # torch.from_numpy wants a writable view
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def sync_get(*tensors: torch.Tensor):
    """Fetch tensors to host numpy as ONE logical host sync."""
    bump("host_syncs")
    out = []
    for t in tensors:
        a = t.detach().cpu().numpy()
        bump("bytes_d2h", a.nbytes)
        out.append(a)
    return out

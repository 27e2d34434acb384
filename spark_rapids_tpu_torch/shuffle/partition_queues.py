"""Spill-backed exchange partition queues — port of
``spark_rapids_tpu/shuffle/partition_queues.py``.

One queue per reduce partition, appended map-side slice by slice and
drained partition by partition.  Slices stay on the device as
``SpillFramework`` handles up to a device budget (the pool's LRU may still
move them to the host); past it a slice crosses the host boundary at once
as a CRC-framed TKU2 block (``shuffle/serializer.py``), and past an
optional host budget that block goes to a file.  A flipped bit in a block
raises ``ShuffleCorruption`` when it is read.

Wall inside the queue (serialize, track, materialize) is counted in
``exchange_spill_ns``; host-boundary blocks in ``exchange_host_blocks`` and
``exchange_host_block_bytes``.  Every append and read observes the current
query's CancelToken.

Run with a device budget of 0, the queues are the distributed exchange's
lineage buffer: ``append_framed`` keeps the very block shipped to a
worker, ``peek_blobs`` reads a partition's blocks back for a re-drive or a
hedged fetch without draining them, and ``release_partition`` drops them
once the partition was read.  ``snapshot_framed`` copies a partition as
framed blocks without draining it: the source of a stage checkpoint
(``lifecycle/journal.py``).  The reference's query accounting is not
ported.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import (EXCHANGE_DEVICE_RESIDENT_BYTES,
                                           EXCHANGE_TARGET_PARTITION_FRACTION,
                                           ICI_HOST_BOUNDARY_CODEC,
                                           SHUFFLE_COMPRESSION_CODEC)
from spark_rapids_tpu_torch.lifecycle.context import check_cancel
from spark_rapids_tpu_torch.memory.device_manager import get_device_manager
from spark_rapids_tpu_torch.memory.spill import get_spill_framework
from spark_rapids_tpu_torch.shuffle.serializer import (deserialize_concat,
                                                       serialize_batch)


class SpillBackedPartitionQueues:
    """Per-partition queues of exchange output slices with bounded device
    residency (the spill-backed exchange's block store)."""

    def __init__(self, n_parts: int, schema: T.StructType,
                 device_budget: int, codec: Optional[str] = None,
                 host_budget: int = 0, spill_dir: Optional[str] = None):
        self.n_parts = n_parts
        self.schema = schema
        self.device = None          # the device of the slices appended
        self.device_budget = max(int(device_budget), 0)
        # host bytes of retained blobs (0 = unbounded); past it, files
        self.host_budget = max(int(host_budget), 0)
        self._spill_dir = spill_dir
        self._made_spill_dir = False
        self.codec = codec
        self._fw = get_spill_framework()
        # per-partition entries: ("dev", handle) | ("host", blob) |
        # ("hostfile", path)
        self._queues: Dict[int, List[Tuple[str, object]]] = {
            p: [] for p in range(n_parts)}
        self._device_bytes = 0
        self._host_mem_bytes = 0
        self._next_file = 0
        self.host_blocks = 0
        self.host_block_bytes = 0

    @property
    def device_bytes(self) -> int:
        """Device bytes queued as resident handles (the queue's own budget;
        the framework's pool is the second, global, limit)."""
        return self._device_bytes

    def append(self, pid: int, batch: ColumnarBatch) -> None:
        """Queue one map-side slice for reduce partition ``pid``."""
        check_cancel()
        if batch is None or batch.num_rows == 0:
            return
        t0 = time.perf_counter_ns()
        self.device = batch.device
        nb = batch.nbytes()
        if self._device_bytes + nb <= self.device_budget:
            self._queues[pid].append(("dev", self._fw.track(batch)))
            self._device_bytes += nb
        else:
            self._queue_blob(pid, serialize_batch(batch, codec=self.codec))
        PC.bump("exchange_spill_ns", time.perf_counter_ns() - t0)

    def append_framed(self, pid: int, blob: bytes) -> None:
        """Queue one block framed already (the distributed exchange frames
        each slice once and keeps the same bytes here as its lineage
        copy), counted like any host-boundary block."""
        check_cancel()
        if blob:
            self._queue_blob(pid, blob)

    def _queue_blob(self, pid: int, blob: bytes) -> None:
        self._queues[pid].append(self._host_entry(blob))
        self.host_blocks += 1
        self.host_block_bytes += len(blob)
        PC.bump("exchange_host_blocks")
        PC.bump("exchange_host_block_bytes", len(blob))

    def peek_blobs(self, pid: int) -> List[bytes]:
        """The partition's host blocks, without draining (those in files
        read back): the source of a re-drive after a worker loss.  Device
        entries are not wire blocks and are skipped; the distributed
        exchange runs its queues with a device budget of 0."""
        out: List[bytes] = []
        for kind, x in (self._queues.get(pid) or []):
            if kind == "host":
                out.append(x)
            elif kind == "hostfile":
                with open(x, "rb") as f:
                    out.append(f.read())
        return out

    def snapshot_framed(self, pid: int) -> List[bytes]:
        """Every queued entry of one partition as a CRC-framed block,
        without draining: a device-resident slice is pinned, framed and
        unpinned with its entry still queued (the checkpoint is a copy;
        the read phase drains the queue as usual afterwards)."""
        out: List[bytes] = []
        for kind, x in (self._queues.get(pid) or []):
            if kind == "host":
                out.append(x)
            elif kind == "hostfile":
                with open(x, "rb") as f:
                    out.append(f.read())
            else:
                x.pin()
                try:
                    out.append(serialize_batch(x.get_batch(),
                                               codec=self.codec))
                finally:
                    x.unpin()
        return out

    def release_partition(self, pid: int) -> None:
        """Drop one partition's entries: the consuming stage read all of
        it, so its lineage copy can go."""
        entries = self._queues.get(pid) or []
        self._queues[pid] = []
        for kind, x in entries:
            self._release_entry(kind, x)

    def _host_entry(self, blob: bytes) -> Tuple[str, object]:
        """One host entry: in memory up to ``host_budget``, past it a file
        in the spill dir (the blob is framed already, so rot on disk is
        caught when it is decoded)."""
        if not self.host_budget \
                or self._host_mem_bytes + len(blob) <= self.host_budget:
            self._host_mem_bytes += len(blob)
            return ("host", blob)
        if self._spill_dir is None:
            self._spill_dir = tempfile.mkdtemp(prefix="srt_exch_")
            self._made_spill_dir = True
        os.makedirs(self._spill_dir, exist_ok=True)
        path = os.path.join(self._spill_dir,
                            f"part_{id(self):x}_{self._next_file}.blk")
        self._next_file += 1
        with open(path, "wb") as f:
            f.write(blob)
        return ("hostfile", path)

    def _release_entry(self, kind: str, x) -> None:
        if kind == "host":
            self._host_mem_bytes -= len(x)
        elif kind == "hostfile":
            try:
                os.unlink(x)
            except OSError:
                pass
        else:
            self._device_bytes -= x.device_bytes
            x.close()

    def read(self, pid: int) -> Optional[ColumnarBatch]:
        """Drain reduce partition ``pid`` into one batch (None if empty)."""
        chunks = list(self.read_chunks(pid))
        if not chunks:
            return None
        return (chunks[0] if len(chunks) == 1
                else ColumnarBatch.concat(chunks))

    @staticmethod
    def _entry_bytes(kind: str, x) -> int:
        if kind == "dev":
            return x.device_bytes
        if kind == "hostfile":
            return os.path.getsize(x)
        return len(x)

    def _drain_group(self, group) -> ColumnarBatch:
        t0 = time.perf_counter_ns()
        handles = [x for kind, x in group if kind == "dev"]
        try:
            for h in handles:
                h.pin()
            parts: List[ColumnarBatch] = []
            blobs = []
            for kind, x in group:
                if kind == "dev":
                    parts.append(x.get_batch())
                elif kind == "hostfile":
                    with open(x, "rb") as f:
                        blobs.append(f.read())
                else:
                    blobs.append(x)
            if blobs:
                parts.append(deserialize_concat(
                    blobs, self.schema, codec=self.codec,
                    device=self.device))
            out = (parts[0] if len(parts) == 1
                   else ColumnarBatch.concat(parts))
        finally:
            for h in handles:
                h.unpin()
        for kind, x in group:
            self._release_entry(kind, x)
        PC.bump("exchange_spill_ns", time.perf_counter_ns() - t0)
        return out

    def read_chunks(self, pid: int, target_bytes: int = 0):
        """Drain reduce partition ``pid`` as device batches of about
        ``target_bytes`` each (0: one chunk).  One chunk at a time is
        materialised and released, so the drain's device working set is a
        chunk, never the whole partition."""
        check_cancel()
        entries = self._queues.get(pid) or []
        if not entries:
            return
        self._queues[pid] = []
        group: List[Tuple[str, object]] = []
        group_bytes = 0
        try:
            while entries:
                kind, x = entries[0]
                nb = self._entry_bytes(kind, x)
                if group and target_bytes \
                        and group_bytes + nb > target_bytes:
                    out = self._drain_group(group)
                    group, group_bytes = [], 0
                    yield out
                    check_cancel()
                group.append(entries.pop(0))
                group_bytes += nb
            if group:
                out = self._drain_group(group)
                group = []
                yield out
        finally:
            # an abandoned drain releases what it has not read
            for kind, x in group + entries:
                self._release_entry(kind, x)

    def close(self) -> None:
        """Release every remaining entry (the error-unwind path; a clean
        drain has released everything already)."""
        for pid, entries in self._queues.items():
            for kind, x in entries:
                self._release_entry(kind, x)
            self._queues[pid] = []
        self._device_bytes = 0
        self._host_mem_bytes = 0
        if self._made_spill_dir and self._spill_dir:
            shutil.rmtree(self._spill_dir, ignore_errors=True)
            self._spill_dir = None
            self._made_spill_dir = False


def queue_device_budget(conf) -> int:
    """The queues' device budget: the conf when set, else twice one target
    partition (so the next partition's slices can stage while the current
    one computes)."""
    fixed = conf.get(EXCHANGE_DEVICE_RESIDENT_BYTES)
    if fixed:
        return int(fixed)
    pool = get_device_manager().pool_bytes
    frac = conf.get(EXCHANGE_TARGET_PARTITION_FRACTION)
    return max(int(pool * frac * 2), 1 << 20)


def host_boundary_codec(conf) -> Optional[str]:
    """Codec of the CRC-framed host-boundary blocks: the host-boundary
    override when set, else the shuffle codec."""
    return conf.get(ICI_HOST_BOUNDARY_CODEC) \
        or conf.get(SHUFFLE_COMPRESSION_CODEC)

"""DistributedExchange — the engine's side of one exchange over the worker
tier, with lineage retry (port of
``spark_rapids_tpu/distributed/client.py``).

* Every partition slice is framed once as a TKU2 block
  (``exec/ici.py::ici_host_frame``) and lands in two places: the placed
  worker (``Coordinator.put_block``) and the engine's spill-backed
  partition queue, the lineage copy.
* The engine keeps its copy until the consuming stage has read the whole
  partition (``release_partition``), so a worker lost at any point before
  that is recoverable.
* A loss re-places the lost worker's partitions on survivors; the client
  claims the re-drive queue at every produce and consume step and
  re-pushes the retained blocks to the new owners
  (``partitions_replayed`` counts each re-driven partition).
* The consumer checks completeness by block count (a worker that came back
  empty under the same id returns fewer blocks than were shipped) and
  re-drives instead of returning short data; a corrupted block raises
  ``ShuffleCorruption`` when it is decoded.
* ``redriveMaxAttempts`` bounds how often one partition may be re-driven;
  past it :class:`WorkerLost` escapes.

Hedged fetches: since the engine keeps every framed slice until the
partition is read, its lineage queue is a free replica.  A page fetch that
passes the owner's soft deadline is served from that copy instead,
first answer wins (``fetch_hedges`` counts launches, ``hedges_won`` the
wins); on a healthy fleet both stay 0.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.distributed.protocol import WorkerLost

# a test and benchmark hook: called as (exch, pid, seq) after every block
# shipped by ``add_slice``; set only by tests and harnesses
TEST_SHIP_HOOK = None

# one reduce partition streams back in pages of about this many bytes, so a
# partition larger than a wire frame (or the worker's memory) never
# materializes whole on the worker
FETCH_PAGE_BYTES = 8 << 20


class DistributedExchange:
    """One exchange's view of the worker tier (engine side)."""

    def __init__(self, coordinator, exch_id: int, n_parts: int,
                 schema, codec: Optional[str], queues,
                 est_bytes: Optional[int] = None,
                 redrive_max_attempts: int = 4):
        self.coord = coordinator
        self.exch_id = exch_id
        self.n_parts = n_parts
        self.schema = schema
        self.codec = codec
        self.queues = queues          # SpillBackedPartitionQueues
        self.redrive_max_attempts = max(int(redrive_max_attempts), 1)
        self.device = None            # the device of the slices added
        self._counts: Dict[int, int] = {}
        self._redriven: Dict[int, int] = {}
        self._lock = threading.Lock()
        self.placement = coordinator.place(exch_id, n_parts, est_bytes)

    def block_counts(self) -> Dict[int, int]:
        """Per-partition shipped-block counts (sequences run from 0, so a
        count is the completeness bar a consumer, or a recovery lease,
        checks against)."""
        with self._lock:
            return dict(self._counts)

    # -- produce ---------------------------------------------------------
    def add_slice(self, pid: int, batch) -> None:
        """Frame one partition slice, retain it in the lineage queue, and
        ship it to the placed worker."""
        if batch is None or batch.num_rows == 0:
            return
        from spark_rapids_tpu_torch.exec.ici import ici_host_frame

        self.device = batch.device
        blob = ici_host_frame(batch, codec=self.codec)
        with self._lock:
            seq = self._counts.get(pid, 0)
            self._counts[pid] = seq + 1
        self.queues.append_framed(pid, blob)
        self._drain_redrives()
        self._ship(pid, seq, blob)

    def _ship(self, pid: int, seq: int, blob: bytes) -> None:
        while True:
            try:
                self.coord.put_block(self.exch_id, pid, seq, blob)
                if TEST_SHIP_HOOK is not None:
                    TEST_SHIP_HOOK(self.exch_id, pid, seq)
                return
            except WorkerLost:
                # the owner died mid-put and the coordinator re-placed its
                # partitions: replay this pid's retained blocks (this one
                # included) to the new owner
                self._bump_redrive_budget(pid)
                self._drain_redrives(include=pid)

    def _bump_redrive_budget(self, pid: int) -> None:
        with self._lock:
            used = self._redriven.get(pid, 0) + 1
            self._redriven[pid] = used
        if used > self.redrive_max_attempts:
            raise WorkerLost(
                str(self.placement.get(pid, "?")),
                f"partition {pid} exceeded {self.redrive_max_attempts} "
                f"re-drive attempts")

    def _drain_redrives(self, include: Optional[int] = None) -> None:
        """Claim and replay every partition a loss re-placed: the full
        retained block list of each claimed pid goes to its new owner
        (worker stores are idempotent per sequence, so blocks that landed
        already are harmless).  A replacement owner dying mid-replay folds
        its re-placed pids into this pass and restarts the current pid
        from sequence 0."""
        pending = self.coord.claim_redrives(self.exch_id)
        if include is not None:
            pending.add(include)
        while pending:
            pid = min(pending)
            pending.discard(pid)
            blobs = self.queues.peek_blobs(pid)
            if not blobs:
                # never produced, or already read and released
                continue
            seq = 0
            while seq < len(blobs):
                try:
                    self.coord.put_block(self.exch_id, pid, seq,
                                         blobs[seq], redrive=True)
                    seq += 1
                except WorkerLost:
                    self._bump_redrive_budget(pid)
                    pending |= self.coord.claim_redrives(self.exch_id)
                    pending.discard(pid)
                    seq = 0
            # counted once all of the partition's blocks landed
            PC.bump("partitions_replayed")

    # -- consume ---------------------------------------------------------
    def read_partition_chunks(self, pid: int,
                              target_bytes: int = 0) -> Iterator:
        """Drain one reduce partition from its owner as device batches of
        about ``target_bytes``, page by page (the engine holds one decode
        group, never the whole partition).  The lineage copy is released
        only after the whole partition was decoded."""
        from spark_rapids_tpu_torch.lifecycle.context import check_cancel
        from spark_rapids_tpu_torch.shuffle.serializer import (
            deserialize_concat)

        expected = self._counts.get(pid, 0)
        if expected == 0:
            self.queues.release_partition(pid)
            return
        self._ensure_remote_complete(pid, expected)
        # the owner holds exactly sequences 0..expected-1, so pages stream
        # in ascending order with no gaps.  A WorkerLost after the first
        # yield propagates: rows already delivered cannot be retracted
        group: List[bytes] = []
        group_bytes = 0
        next_seq = 0
        while next_seq < expected:
            check_cancel()
            seqs, blobs, _n = self._fetch_page(pid, next_seq)
            if not seqs:
                raise WorkerLost(
                    str(self.placement.get(pid, "?")),
                    f"partition {pid} truncated mid-stream "
                    f"(at seq {next_seq}/{expected})")
            for s, blob in zip(seqs, blobs):
                next_seq = s + 1
                if group and target_bytes \
                        and group_bytes + len(blob) > target_bytes:
                    yield deserialize_concat(group, self.schema,
                                             codec=self.codec,
                                             device=self.device)
                    check_cancel()
                    group, group_bytes = [], 0
                group.append(blob)
                group_bytes += len(blob)
        if group:
            yield deserialize_concat(group, self.schema, codec=self.codec,
                                     device=self.device)
        # a probed (once quarantined) owner earns its breaker entry back
        self.coord.note_worker_ok(self.coord.owner_of(self.exch_id, pid))
        self.queues.release_partition(pid)

    def _fetch_page(self, pid: int, next_seq: int):
        """One page of the partition (sequences from ``next_seq``) from its
        owner, hedged: the remote fetch runs on a side thread racing the
        owner's soft deadline; past it, the page is served from the
        lineage copy (it holds the whole remainder until release) and the
        straggler's reply is dropped when it lands."""
        def remote():
            return self.coord.fetch_blocks(
                self.exch_id, pid, after_seq=next_seq - 1,
                max_bytes=FETCH_PAGE_BYTES)

        deadline = None
        owner = None
        if self.coord.hedge_enabled:
            try:
                owner = self.coord.owner_of(self.exch_id, pid)
                deadline = self.coord.soft_deadline_s(owner)
            except KeyError:
                pass
        if deadline is None:
            return remote()
        box: Dict[str, object] = {}
        done = threading.Event()

        def run():
            try:
                box["out"] = remote()
            except BaseException as e:
                box["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True,
                             name="srt-dist-hedge-fetch")
        t.start()
        if not done.wait(deadline):
            PC.bump("fetch_hedges")
            self.coord.note_soft_deadline_miss(owner)
            blobs = self.queues.peek_blobs(pid)
            if len(blobs) > next_seq:
                # byte-identical by construction: these ARE the shipped
                # frames
                PC.bump("hedges_won")
                return (list(range(next_seq, len(blobs))),
                        blobs[next_seq:], len(blobs))
            done.wait()
        err = box.get("err")
        if err is not None:
            raise err
        return box["out"]

    def _ensure_remote_complete(self, pid: int, expected: int) -> None:
        """Re-drive until the owner holds the whole partition (its block
        count reaches ``expected``) without fetching any data; bounded by
        ``redriveMaxAttempts``."""
        while True:
            self._drain_redrives()
            try:
                _seqs, _blobs, n_total = self.coord.fetch_blocks(
                    self.exch_id, pid, after_seq=-1, max_bytes=1)
            except WorkerLost:
                self._bump_redrive_budget(pid)
                self._drain_redrives(include=pid)
                continue
            if n_total >= expected:
                return
            # a short copy: the worker came back empty under the same id
            self._bump_redrive_budget(pid)
            self.coord.mark_redrive(self.exch_id, pid)

    # -- cleanup ---------------------------------------------------------
    def close(self) -> None:
        """Drop the lineage queues and the remote copies (idempotent; the
        shuffle manager's unregister releases them too)."""
        self.queues.close()
        try:
            self.coord.release_exchange(self.exch_id)
        except WorkerLost:
            pass

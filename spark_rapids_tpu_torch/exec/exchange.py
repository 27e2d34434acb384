"""Exchanges — port of ``TpuBroadcastExchangeExec``,
``TpuShuffleExchangeExec`` and ``TpuAdaptiveShuffleReaderExec``
(``spark_rapids_tpu/exec/exchange.py``).

On one device a broadcast is a materialisation: the child's batches are
concatenated into one batch for the join's build side.  A single-partition
shuffle is an identity over the child's batches, as in the reference: one
reduce partition receives every map output in order.

A shuffle over several partitions (hash, round-robin or range) gives each
row Spark's partition id (``ops/hashing.py`` for hash), sorts the rows of a
batch stably by it, and reads the partitions' bounds back in one host sync
a batch (``partition_slices``).  Its slices stream through spill-backed
partition queues (``shuffle/partition_queues.py``): device-resident up to
a budget, CRC-framed host blocks past it.  The reduce partitions then
drain in partition order, in chunks of ``spark.rapids.sql.batchSizeBytes``.
With ``exchange.spill.enabled=false`` or ``shuffle.mode=CACHE_ONLY`` the
slices go through the shuffle manager (``shuffle/manager.py``) instead,
each input batch a map task, as in the reference.

With ``spark.rapids.tpu.distributed.enabled`` and a coordinator that has a
placeable worker, the exchange runs over the worker tier
(``_execute_distributed``): each slice is framed once, shipped to the
worker its partition is placed on, and kept in a lineage queue in the
engine until its partition is read back; a worker lost mid-shuffle is
recovered by re-driving those blocks.  With no coordinator or no
placeable worker the exchange runs in process (the reference's elastic
membership).

With ``spark.rapids.tpu.recovery.enabled`` the stage boundary is a durable
checkpoint (``lifecycle/journal.py``): an exchange first looks up a dead
incarnation's committed output under its plan-stage fingerprint and serves
it instead of executing its child; otherwise, once its write phase has
landed, the spill-backed path commits its partitions as checkpoint files
and the distributed path journals a lease on the worker-held blocks.  A
commit that fails leaves the stage uncheckpointed and never fails the
query.
"""
from __future__ import annotations

import copy
import time
from typing import Iterator, List, Tuple

import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import (BATCH_SIZE_BYTES,
                                           DISTRIBUTED_ENABLED,
                                           DISTRIBUTED_REDRIVE_MAX,
                                           EXCHANGE_SPILL_ENABLED,
                                           RECOVERY_ENABLED, SHUFFLE_MODE,
                                           SPILL_DIR, TpuConf)
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext
from spark_rapids_tpu_torch.lifecycle.context import (QueryCancelled,
                                                      check_cancel, current)
from spark_rapids_tpu_torch.ops.filterops import gather_columns
from spark_rapids_tpu_torch.ops.hashing import spark_partition_ids
from spark_rapids_tpu_torch.ops.sortkeys import sort_permutation
from spark_rapids_tpu_torch.perfcounters import sync_get
from spark_rapids_tpu_torch.plan.nodes import (HashPartitioning,
                                               RangePartitioning,
                                               RoundRobinPartitioning,
                                               SinglePartitioning)


class TpuBroadcastExchangeExec(TpuExec):
    def __init__(self, child: TpuExec):
        super().__init__([child])

    @property
    def output(self):
        return self.children[0].output

    def execute_columnar(self):
        batches = list(self.children[0].execute_columnar())
        if not batches:
            return
        yield (batches[0] if len(batches) == 1
               else ColumnarBatch.concat(batches))


def partition_order(ids: torch.Tensor, n_parts: int
                    ) -> Tuple[torch.Tensor, List[int]]:
    """(row order, bounds) of partition ids ``ids`` (int64 in
    ``[0, n_parts)``): one stable sort, so each partition's rows keep their
    order, and the ``n_parts + 1`` bounds of the partitions in that order,
    read back in one host sync."""
    sorted_ids, perm = torch.sort(ids, stable=True)
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(n_parts + 1, dtype=sorted_ids.dtype,
                                 device=ids.device))
    (b,) = sync_get(bounds)
    return perm, b.tolist()


def gather_slice(batch: ColumnarBatch, perm: torch.Tensor, lo: int,
                 hi: int) -> ColumnarBatch:
    """Rows ``perm[lo:hi]`` of ``batch`` as new tensors (a slice that stays
    queued keeps no other partition's rows alive)."""
    return ColumnarBatch(gather_columns(perm[lo:hi], batch.columns),
                         hi - lo, batch.schema)


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, partitioning, child: TpuExec, ansi: bool = False,
                 conf: TpuConf = None):
        super().__init__([child])
        # partition sizing grows the count in place: keep the CPU plan's
        # partitioning as it was planned
        self.partitioning = copy.copy(partitioning)
        self.ansi = ansi
        self.conf = conf if conf is not None else TpuConf()

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        d = getattr(self, "sized_decision", None)
        return (f"TpuShuffleExchange {self.partitioning.describe()}"
                + (f" [{d}]" if d else ""))

    @property
    def num_partitions(self) -> int:
        return getattr(self.partitioning, "num_partitions", 1)

    def aot_output_rows(self):
        # one partition is an identity over the child; the slices of
        # several depend on the data
        if self.num_partitions == 1:
            return self.aot_input_rows()
        return None

    def aot_output_caps(self):
        return self.aot_input_caps() if self.num_partitions == 1 else None

    def partition_slices(self, batch: ColumnarBatch
                         ) -> Iterator[Tuple[int, ColumnarBatch]]:
        """The non-empty partition slices of one batch, in partition order,
        made one at a time (reference: GpuPartitioning.
        sliceInternalGpuOrCpu, which yields the empty ones too)."""
        p = self.partitioning
        if isinstance(p, SinglePartitioning) or self.num_partitions == 1:
            yield 0, batch
            return
        t0 = time.perf_counter_ns()
        if isinstance(p, HashPartitioning):
            ids = self._hash_ids(batch)
        elif isinstance(p, RoundRobinPartitioning):
            ids = torch.arange(batch.num_rows, dtype=torch.int64,
                               device=batch.device) % self.num_partitions
        elif isinstance(p, RangePartitioning):
            ids = self._range_ids(batch)
        else:
            raise NotOnGpu(f"partitioning {type(p).__name__}")
        perm, bounds = partition_order(ids, self.num_partitions)
        PC.bump("exchange_partition_ns", time.perf_counter_ns() - t0)
        # lazily, so each slice is queued before the next is gathered
        for pid in range(self.num_partitions):
            lo, hi = bounds[pid], bounds[pid + 1]
            if hi > lo:
                yield pid, gather_slice(batch, perm, lo, hi)

    def _hash_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        ctx = EvalContext(batch, ansi=self.ansi)
        key_cols = [k.eval_tpu(ctx) for k in self.partitioning.keys]
        ctx.check_errors()
        return spark_partition_ids(key_cols, self.num_partitions)

    def _range_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        """Range partitioning on this batch's own order (the reference's
        round-1 simplification of sampled bounds): a row's rank over the
        rows a partition takes."""
        ctx = EvalContext(batch, ansi=self.ansi)
        orders = self.partitioning.orders
        key_cols = [e.eval_tpu(ctx) for e, _ in orders]
        ctx.check_errors()
        perm = sort_permutation(key_cols, [s for _, s in orders],
                                batch.row_mask)
        n = batch.num_rows
        rank = torch.empty_like(perm)
        rank[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
        per = max(-(-n // self.num_partitions), 1)
        return (rank // per).clamp(0, self.num_partitions - 1)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        if isinstance(self.partitioning, SinglePartitioning):
            yield from self.children[0].execute_columnar()
            return
        c = self.conf
        # recovery off: one conf read and no journal call
        ckpt = None
        if bool(c.get(RECOVERY_ENABLED)):
            ckpt = self._recovery_ckpt()
            if ckpt is not None:
                served = self._serve_recovered(*ckpt)
                if served is not None:
                    yield from served
                    return
        if c.get(DISTRIBUTED_ENABLED):
            from spark_rapids_tpu_torch.distributed import peek_coordinator

            coord = peek_coordinator()
            if coord is not None and coord.placeable_workers():
                yield from self._execute_distributed(coord, ckpt)
                return
        if c.get(EXCHANGE_SPILL_ENABLED) \
                and str(c.get(SHUFFLE_MODE)).upper() != "CACHE_ONLY":
            yield from self._execute_spill_backed(ckpt)
            return
        yield from self._execute_shuffle_manager()

    # -- crash-consistent recovery ---------------------------------------
    def _registry_scope(self, kind: str):
        """The exchange's identity: partitioning, its expressions, the
        partition count, the output schema, ANSI mode and the conf; None
        when an expression has no stable fingerprint."""
        from spark_rapids_tpu_torch.compilecache.keys import (conf_fp,
                                                              exprs_fp,
                                                              schema_fp)

        p = self.partitioning
        if isinstance(p, HashPartitioning):
            efp = exprs_fp(p.keys)
        elif isinstance(p, RangePartitioning):
            efp = exprs_fp([e for e, _ in p.orders])
            if efp is not None:
                efp = efp + tuple((s.ascending, s.nulls_first)
                                  for _, s in p.orders)
        else:
            efp = ()
        if efp is None:
            return None
        return ("exchange", kind, type(p).__name__, efp,
                self.num_partitions, schema_fp(self.output),
                bool(self.ansi), conf_fp(self.conf))

    def _recovery_ckpt(self):
        """(journal, plan-stage fingerprint), or None when recovery cannot
        apply: partitioning without a stable fingerprint, or a journal
        that cannot open.  The fingerprint adds the child subtree's plan
        identity to the exchange's, so two exchanges of one partitioning
        and schema over different children never trade checkpoints."""
        from spark_rapids_tpu_torch.compilecache.keys import fingerprint
        from spark_rapids_tpu_torch.lifecycle import journal as _jn

        scope = self._registry_scope("ckpt")
        if scope is None:
            return None
        fp = fingerprint(scope, _jn.plan_tree_fp(self.children[0]))
        try:
            return _jn.get_journal(self.conf), fp
        except Exception:
            # a journal that cannot open disables recovery for this
            # query, never fails it
            return None

    def _serve_recovered(self, jn, fp):
        """A generator over a dead incarnation's committed output for this
        stage, or None (nothing adoptable: execute as usual).  A local
        checkpoint is CRC-checked whole before the first batch; a lease
        streams from the re-attached workers."""
        from spark_rapids_tpu_torch.shuffle.partition_queues import (
            host_boundary_codec)

        hit = jn.lookup_stage(fp)
        if hit is None:
            return None
        ctx = current()
        qid = ctx.query_id if ctx is not None else "-"
        codec = host_boundary_codec(self.conf)
        if hit[0] == "local":
            return self._gen_recovered_local(jn, fp, qid, codec, hit[1])
        _, wire, _placement, counts = hit
        return self._gen_recovered_lease(jn, fp, qid, codec, wire, counts)

    def _gen_recovered_local(self, jn, fp, qid, codec, parts):
        from spark_rapids_tpu_torch.shuffle.serializer import (
            deserialize_concat)

        device = self._device()
        for pid in range(self.num_partitions):
            blobs = parts.get(pid) or []
            if not blobs:
                continue
            out = deserialize_concat(blobs, self.output, codec=codec,
                                     device=device)
            if out.num_rows > 0:
                yield out
        jn.mark_recovered(fp, qid, len(parts))

    def _gen_recovered_lease(self, jn, fp, qid, codec, wire, counts):
        from spark_rapids_tpu_torch.distributed import (ProtocolCorruption,
                                                        peek_coordinator)
        from spark_rapids_tpu_torch.shuffle.serializer import (
            deserialize_concat)

        coord = peek_coordinator()
        goal = int(self.conf.get(BATCH_SIZE_BYTES))
        device = self._device()
        try:
            for pid in sorted(counts):
                check_cancel()
                expected = counts[pid]
                next_seq = 0
                while next_seq < expected:
                    seqs, blobs, _n = coord.fetch_blocks(
                        wire, pid, after_seq=next_seq - 1, max_bytes=goal)
                    if not seqs:
                        raise ProtocolCorruption(
                            f"recovered stage {fp}: worker returned no "
                            f"blocks for pid {pid} at seq "
                            f"{next_seq}/{expected}")
                    next_seq = seqs[-1] + 1
                    out = deserialize_concat(blobs, self.output,
                                             codec=codec, device=device)
                    if out.num_rows > 0:
                        yield out
        finally:
            # the adopted placement ends with the serve, on success and on
            # unwind (a failed serve re-executes; the workers' copies are
            # no longer adoptable either way)
            coord.release_exchange(wire)
        jn.mark_recovered(fp, qid, len(counts))

    @staticmethod
    def _commit_stage(commit_fn) -> None:
        """Run one checkpoint commit; a failure leaves the stage not
        recoverable and never fails the query.  Cancellation and any
        BaseException (a kill) pass through."""
        try:
            commit_fn()
        except QueryCancelled:
            raise
        except Exception:
            pass

    def _execute_shuffle_manager(self) -> Iterator[ColumnarBatch]:
        """Each input batch a map task whose slices the shuffle manager
        writes (serialized on its pool, or kept on the device under
        CACHE_ONLY); each reduce partition assembled by its reader."""
        from spark_rapids_tpu_torch.shuffle.manager import get_shuffle_manager

        mgr = get_shuffle_manager(self.conf)
        shuffle_id = mgr.register_shuffle()
        device = None
        try:
            for map_id, b in enumerate(self.children[0].execute_columnar()):
                device = b.device
                slices: List = [None] * self.num_partitions
                for pid, sl in self.partition_slices(b):
                    slices[pid] = sl
                mgr.write_map_output(shuffle_id, map_id, slices)
            for pid in range(self.num_partitions):
                check_cancel()
                out = mgr.read_partition(shuffle_id, pid, self.output,
                                         device=device)
                if out is not None and out.num_rows > 0:
                    yield out
        finally:
            mgr.unregister_shuffle(shuffle_id)

    def _execute_distributed(self, coord,
                             ckpt=None) -> Iterator[ColumnarBatch]:
        """The exchange over the worker tier: each slice framed once as a
        TKU2 block, shipped to the worker its partition is placed on, and
        kept in a lineage queue in the engine (device budget 0, host
        memory bounded by ``spark.rapids.shuffle.hostStoreSize``, then
        files) until its partition is read back.  The shuffle
        registration ties the remote copies to the query, so its cleanup
        releases them even after a mid-batch unwind."""
        from spark_rapids_tpu_torch.distributed.client import (
            DistributedExchange)
        from spark_rapids_tpu_torch.exec.partition_sizing import (
            estimate_input_bytes)
        from spark_rapids_tpu_torch.shuffle.manager import (
            SHUFFLE_HOST_STORE_LIMIT, get_shuffle_manager)
        from spark_rapids_tpu_torch.shuffle.partition_queues import (
            SpillBackedPartitionQueues, host_boundary_codec)

        c = self.conf
        mgr = get_shuffle_manager(c)
        exch_id = mgr.register_shuffle()
        queues = None
        dist = None
        # everything fallible, placement included (it raises WorkerLost
        # when the last placeable worker died since the check above), sits
        # in the try, so the finally always unregisters and closes
        try:
            codec = host_boundary_codec(c)
            queues = SpillBackedPartitionQueues(
                self.num_partitions, self.output, device_budget=0,
                codec=codec, host_budget=int(c.get(SHUFFLE_HOST_STORE_LIMIT)),
                spill_dir=c.get(SPILL_DIR))
            dist = DistributedExchange(
                coord, exch_id, self.num_partitions, self.output, codec,
                queues, est_bytes=estimate_input_bytes(self.children[0], c),
                redrive_max_attempts=int(c.get(DISTRIBUTED_REDRIVE_MAX)))
            for b in self.children[0].execute_columnar():
                for pid, sl in self.partition_slices(b):
                    dist.add_slice(pid, sl)
            if ckpt is not None:
                # the stage boundary: the worker-held partitions are the
                # checkpoint, and a lease pins them past the driver's
                # death (the read phase below releases no worker copy;
                # only dist.close() does)
                jn, fp = ckpt
                ctx = current()
                self._commit_stage(lambda: jn.commit_lease(
                    fp, ctx.query_id if ctx is not None else "-",
                    coord.wire_of(exch_id), coord.placement_of(exch_id),
                    dist.block_counts()))
            goal = int(c.get(BATCH_SIZE_BYTES))
            for pid in range(self.num_partitions):
                check_cancel()
                for out in dist.read_partition_chunks(pid,
                                                      target_bytes=goal):
                    if out.num_rows > 0:
                        yield out
        finally:
            if dist is not None:
                dist.close()
            elif queues is not None:
                queues.close()
            mgr.unregister_shuffle(exch_id)

    def _execute_spill_backed(self, ckpt=None) -> Iterator[ColumnarBatch]:
        """Each input batch sliced once, each slice queued (on the device
        or framed to the host) before the next is made; the reduce
        partitions drain in partition order, in chunks of the batch-size
        goal, released as they are read."""
        from spark_rapids_tpu_torch.shuffle.partition_queues import (
            SpillBackedPartitionQueues, host_boundary_codec,
            queue_device_budget)

        c = self.conf
        queues = SpillBackedPartitionQueues(
            self.num_partitions, self.output, queue_device_budget(c),
            codec=host_boundary_codec(c))
        goal = int(c.get(BATCH_SIZE_BYTES))
        try:
            for b in self.children[0].execute_columnar():
                for pid, sl in self.partition_slices(b):
                    queues.append(pid, sl)
            if ckpt is not None:
                # the stage boundary: every partition framed and committed
                # durably before the read phase drains the queues, so a
                # driver killed past this point serves the checkpoint
                jn, fp = ckpt
                ctx = current()
                self._commit_stage(lambda: jn.commit_local_stage(
                    fp, ctx.query_id if ctx is not None else "-",
                    {pid: queues.snapshot_framed(pid)
                     for pid in range(self.num_partitions)}))
            for pid in range(self.num_partitions):
                check_cancel()
                for out in queues.read_chunks(pid, target_bytes=goal):
                    if out.num_rows > 0:
                        yield out
        finally:
            queues.close()


class TpuAdaptiveShuffleReaderExec(TpuExec):
    """Reads an exchange's reduce partitions while recording their rows and
    bytes (``stats``), and joins adjacent small partitions (below
    ``small_bytes``) into one batch of at most ``target_bytes``; a
    partition at or above ``small_bytes`` is emitted alone.  Each window of
    k > 1 partitions adds k - 1 to ``partitions_coalesced``."""

    def __init__(self, exchange: TpuShuffleExchangeExec, target_bytes: int,
                 small_bytes: int = 4 << 20):
        super().__init__([exchange])
        self.target_bytes = target_bytes
        self.small_bytes = small_bytes
        self.stats = []
        self.decision = None

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        d = f" decided={self.decision}" if self.decision else ""
        return (f"TpuAdaptiveShuffleReader(target="
                f"{self.target_bytes}B small={self.small_bytes}B){d}")

    @staticmethod
    def _flush(pending):
        if len(pending) > 1:
            PC.bump("partitions_coalesced", len(pending) - 1)
        return (pending[0] if len(pending) == 1
                else ColumnarBatch.concat(pending))

    def execute_columnar(self):
        pending = []
        pending_bytes = 0
        n_in = n_out = 0
        self.stats = []
        for b in self.children[0].execute_columnar():
            n_in += 1
            nb = b.nbytes()
            self.stats.append((b.num_rows, nb))
            if nb >= self.small_bytes:
                # right-sized already: flush the open window, emit alone
                if pending:
                    n_out += 1
                    out = self._flush(pending)
                    pending, pending_bytes = [], 0
                    yield out
                n_out += 1
                yield b
                continue
            if pending and pending_bytes + nb > self.target_bytes:
                n_out += 1
                out = self._flush(pending)
                pending, pending_bytes = [], 0
                yield out
            pending.append(b)
            pending_bytes += nb
            if pending_bytes >= self.target_bytes:
                n_out += 1
                out = self._flush(pending)
                pending, pending_bytes = [], 0
                yield out
        if pending:
            n_out += 1
            yield self._flush(pending)
        self.decision = f"coalesced {n_in}->{n_out} partitions"

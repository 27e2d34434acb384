"""Exchanges — port of ``TpuBroadcastExchangeExec``, of
``TpuShuffleExchangeExec`` for one partition and of
``TpuAdaptiveShuffleReaderExec`` (``spark_rapids_tpu/exec/exchange.py``).

On one device a broadcast is a materialisation: the child's batches are
concatenated into one batch for the join's build side.  A single-partition
shuffle is an identity over the child's batches, as in the reference: one
reduce partition receives every map output in order.  Hash, round-robin
and range partitioning over several partitions are not ported; the plan
rewrite elides the single-device hash exchange between the two phases of
an aggregate, and raises for any other.
"""
from __future__ import annotations

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.plan.nodes import SinglePartitioning


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


class TpuShuffleExchangeExec(TpuExec):
    def __init__(self, partitioning, child: TpuExec):
        super().__init__([child])
        if not isinstance(partitioning, SinglePartitioning):
            raise NotOnGpu(f"exchange {partitioning.describe()} (only a "
                           "single-partition shuffle is ported)")
        self.partitioning = partitioning

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"TpuShuffleExchange {self.partitioning.describe()}"

    def execute_columnar(self):
        yield from self.children[0].execute_columnar()


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

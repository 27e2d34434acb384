"""TpuCoalesceBatchesExec — batch concatenation to a size goal (port of
``spark_rapids_tpu/exec/coalesce.py``).

Small batches are concatenated up to ``spark.rapids.sql.batchSizeBytes``
(reference: GpuCoalesceBatches / CoalesceGoal).  The plan rewrite puts one
over each exchange when adaptive execution is off.  Pending batches are
held as spillable handles while more input streams in, and the concat runs
under ``with_retry_no_split``.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
from spark_rapids_tpu_torch.memory.spill import get_spill_framework


class CoalesceGoal:
    """A target batch size (the reference's ``RequireSingleBatch`` goal
    has no caller in the port)."""

    def __init__(self, target_bytes: Optional[int] = None):
        self.target_bytes = target_bytes or (1 << 30)


class TpuCoalesceBatchesExec(TpuExec):
    def __init__(self, goal: CoalesceGoal, child: TpuExec):
        super().__init__([child])
        self.goal = goal

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"TpuCoalesceBatches TargetSize({self.goal.target_bytes})"

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        fw = get_spill_framework()
        pending: List = []   # SpillableColumnarBatch
        pending_bytes = 0
        try:
            for b in self.children[0].execute_columnar():
                nb = b.nbytes()
                if pending and pending_bytes + nb > self.goal.target_bytes:
                    out = self._flush(pending)
                    pending, pending_bytes = [], 0
                    yield out
                pending.append(fw.track(b))
                pending_bytes += nb
            if pending:
                out = self._flush(pending)
                pending = []
                yield out
        finally:
            for s in pending:
                s.close()

    @staticmethod
    def _flush(pending: List) -> ColumnarBatch:
        def concat():
            for s in pending:
                s.pin()
            try:
                batches = [s.get_batch() for s in pending]
                return (batches[0] if len(batches) == 1
                        else ColumnarBatch.concat(batches))
            finally:
                for s in pending:
                    s.unpin()

        out = with_retry_no_split(concat)
        for s in pending:
            s.close()
        return out

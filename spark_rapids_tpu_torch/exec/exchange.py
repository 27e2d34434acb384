"""Exchanges — port of ``TpuBroadcastExchangeExec``
(``spark_rapids_tpu/exec/exchange.py``).

On one device a broadcast is a materialisation: the child's batches are
concatenated into one batch for the join's build side.  The shuffle
exchange is not ported; the plan rewrite elides the single-device hash
exchange between the two phases of an aggregate.
"""
from __future__ import annotations

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec


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

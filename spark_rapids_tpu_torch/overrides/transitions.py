"""The device -> CPU stage boundary — port of ``TpuMaterializedScan``
(``spark_rapids_tpu/overrides/transitions.py``).  The port's other
post-conversion passes live in ``overrides/overrides.py``."""
from __future__ import annotations

from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.plan.nodes import SparkPlan


class TpuMaterializedScan(SparkPlan):
    """A CPU plan node backed by a device subtree: its batches come down to
    the host as the CPU stage's input (the columnar -> row boundary)."""

    def __init__(self, tpu_child: TpuExec):
        super().__init__([])
        self.tpu_child = tpu_child

    @property
    def output(self):
        return self.tpu_child.output

    def describe(self):
        return f"ColumnarToRow <- {self.tpu_child.describe()}"

    def materialize_cpu(self):
        from spark_rapids_tpu_torch.cpu.oracle import CpuCol
        from spark_rapids_tpu_torch.exec.transitions import (
            TpuColumnarToRowExec)

        host = TpuColumnarToRowExec(self.tpu_child).collect_host()
        cols = [CpuCol.from_host(h) for h in host]
        return cols, (cols[0].n if cols else 0)

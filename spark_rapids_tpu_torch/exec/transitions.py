"""Device -> host transition — port of ``TpuColumnarToRowExec``
(``spark_rapids_tpu/exec/transitions.py``)."""
from __future__ import annotations

from typing import List

import numpy as np

from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.exec.base import TpuExec


class TpuColumnarToRowExec(TpuExec):
    """Device batches -> host rows (the top of every collected plan)."""

    def __init__(self, child: TpuExec):
        super().__init__([child])

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return "TpuColumnarToRow"

    def execute_columnar(self):
        yield from self.children[0].execute_columnar()

    def collect_host(self) -> List[HostColumn]:
        """All batches as host columns, one host sync per batch."""
        per_batch = [b.to_host_columns()
                     for b in self.children[0].execute_columnar()]
        if not per_batch:
            return [HostColumn.from_pylist([], f.dataType)
                    for f in self.output.fields]
        return [HostColumn(pb0.dtype,
                           np.concatenate([pb[ci].validity
                                           for pb in per_batch]),
                           data=np.concatenate([pb[ci].data
                                                for pb in per_batch]))
                for ci, pb0 in enumerate(per_batch[0])]

    def collect_rows(self) -> List[tuple]:
        cols = [c.to_pylist() for c in self.collect_host()]
        return list(zip(*cols))

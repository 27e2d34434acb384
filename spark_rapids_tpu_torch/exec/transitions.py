"""Host <-> device transitions — port of ``TpuRowToColumnarExec`` and
``TpuColumnarToRowExec`` (``spark_rapids_tpu/exec/transitions.py``).

A CPU stage (``cpu/oracle.py``) under a device operator reaches the card
through ``TpuRowToColumnarExec``: it runs the stage, then uploads its
columns in chunks of ``target_batch_rows`` rows.  ``TpuColumnarToRowExec``
is the top of every collected plan, and the source of a
``TpuMaterializedScan`` under a CPU stage.
"""
from __future__ import annotations

from typing import Iterator, List

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.exec.base import TpuExec


class TpuRowToColumnarExec(TpuExec):
    """Runs a CPU plan subtree and uploads its output to ``device``."""

    def __init__(self, cpu_plan, device, ansi: bool = False,
                 target_batch_rows: int = 1 << 20):
        super().__init__([])
        self.cpu_plan = cpu_plan
        self.device = device
        self.ansi = ansi
        self.target_batch_rows = target_batch_rows

    @property
    def output(self):
        return self.cpu_plan.output

    def describe(self):
        return f"TpuRowToColumnar <- {self.cpu_plan.describe()}"

    def run_cpu_stage(self) -> List[HostColumn]:
        """The CPU stage's output as host columns."""
        from spark_rapids_tpu_torch.cpu.oracle import execute_cpu_plan

        cols, _ = execute_cpu_plan(self.cpu_plan, ansi=self.ansi)
        return [c.to_host() for c in cols]

    def upload(self, host: List[HostColumn]) -> Iterator[ColumnarBatch]:
        """``host`` in batches of ``target_batch_rows`` rows on the device
        (one empty batch for no rows)."""
        n = host[0].num_rows if host else 0
        names = self.output.field_names()
        step = self.target_batch_rows
        for start in range(0, max(n, 1), step):
            chunk = [h.slice_rows(start, min(start + step, n)) for h in host]
            yield ColumnarBatch.from_host_columns(chunk, names, self.device)

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        yield from self.upload(self.run_cpu_stage())


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
        return [HostColumn.concat([pb[ci] for pb in per_batch])
                for ci in range(len(per_batch[0]))]

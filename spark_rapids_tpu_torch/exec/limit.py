"""Limits — port of ``TpuLocalLimitExec`` and ``TpuGlobalLimitExec``
(``spark_rapids_tpu/exec/limit.py``): pass batches on until n rows have
gone, cutting the last one."""
from __future__ import annotations

from spark_rapids_tpu_torch.exec.base import TpuExec


class TpuLocalLimitExec(TpuExec):
    def __init__(self, n: int, child: TpuExec):
        super().__init__([child])
        self.n = n

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"TpuLocalLimit {self.n}"

    def execute_columnar(self):
        remaining = self.n
        for b in self.children[0].execute_columnar():
            if remaining <= 0:
                break
            if b.num_rows <= remaining:
                remaining -= b.num_rows
                yield b
            else:
                yield b.slice_rows(0, remaining)
                remaining = 0


class TpuGlobalLimitExec(TpuLocalLimitExec):
    def describe(self):
        return f"TpuGlobalLimit {self.n}"

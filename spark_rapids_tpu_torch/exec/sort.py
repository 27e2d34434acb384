"""Sort and top-N — port of ``TpuSortExec`` (in-core) and ``TpuTopNExec``
(``spark_rapids_tpu/exec/sort.py``).

A sort evaluates its key expressions, orders the rows with
``ops/sortkeys.py::sort_permutation`` (stable) and gathers every column.
``TpuSortExec`` concatenates its whole input and sorts it in one pass; the
reference's out-of-core path (sorted runs and a windowed merge, for inputs
past ``spark.rapids.sql.batchSizeBytes``) is not ported, so a large input
sorts in device memory.  ``TpuTopNExec`` sorts each batch, keeps its first
n rows and merges the survivors, so it never holds more than about nine
batches' worth of n rows.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.ops.filterops import gather_columns
from spark_rapids_tpu_torch.ops.sortkeys import SortSpec, sort_permutation


def sort_batch(batch: ColumnarBatch, orders, ansi: bool) -> ColumnarBatch:
    """One batch in ``orders`` order."""
    ctx = EvalContext(batch, ansi=ansi)
    key_cols = [e.eval_tpu(ctx) for e, _ in orders]
    ctx.check_errors()
    perm = sort_permutation(key_cols, [s for _, s in orders], batch.row_mask)
    return ColumnarBatch(gather_columns(perm, batch.columns),
                         batch.num_rows, batch.schema)


class TpuSortExec(TpuExec):
    def __init__(self, orders: List[Tuple[Expression, SortSpec]],
                 is_global: bool, child: TpuExec, ansi: bool = False):
        super().__init__([child])
        self.orders = orders
        self.is_global = is_global
        self.ansi = ansi

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        o = ", ".join(f"{e.sql_string()} {'ASC' if s.ascending else 'DESC'}"
                      for e, s in self.orders)
        return f"TpuSort [{o}]"

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        batches = list(self.children[0].execute_columnar())
        if not batches:
            return
        batch = (batches[0] if len(batches) == 1
                 else ColumnarBatch.concat(batches))
        del batches
        yield sort_batch(batch, self.orders, self.ansi)


class TpuTopNExec(TpuExec):
    """Sort + limit: sort each batch, keep n rows, concat, re-sort, keep n."""

    def __init__(self, n: int, orders: List[Tuple[Expression, SortSpec]],
                 child: TpuExec, ansi: bool = False):
        super().__init__([child])
        self.n = n
        self.orders = orders
        self.ansi = ansi

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"TpuTopN {self.n}"

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        pending: List[ColumnarBatch] = []
        for b in self.children[0].execute_columnar():
            pending.append(self._first_n(b))
            if len(pending) > 8:
                pending = [self._merge(pending)]
        if pending:
            yield self._merge(pending)

    def _first_n(self, batch: ColumnarBatch) -> ColumnarBatch:
        sb = sort_batch(batch, self.orders, self.ansi)
        return sb.slice_rows(0, min(self.n, sb.num_rows))

    def _merge(self, batches: List[ColumnarBatch]) -> ColumnarBatch:
        return self._first_n(batches[0] if len(batches) == 1
                             else ColumnarBatch.concat(batches))

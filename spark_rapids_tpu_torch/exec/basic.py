"""Scan / Project / Filter / Union and whole-stage fusion — port of the
part of ``spark_rapids_tpu/exec/basic.py`` that the port's queries use.

``TpuStageExec`` runs a chain of narrow ops (project/filter) over each
batch.  The reference traces the chain into one XLA program; the port runs
it as eager torch ops.  A stage that feeds an aggregate is absorbed
into the aggregate (``fuse_stages``): its filters then only narrow a row
mask (``apply_masked``), so filtered rows are never compacted.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.ops.filterops import compact_columns


class _StageOp:
    """One narrow op inside a fused stage."""

    def apply(self, ctx: EvalContext, batch: ColumnarBatch) -> ColumnarBatch:
        raise NotImplementedError

    def apply_masked(self, ctx: EvalContext, batch: ColumnarBatch, mask):
        """Selection-vector mode: filters only narrow the row mask."""
        raise NotImplementedError

    def out_schema(self, in_schema: T.StructType) -> T.StructType:
        raise NotImplementedError


def _project_schema(exprs):
    return T.StructType([T.StructField(e.name, e.dataType, e.nullable)
                         for e in exprs])


class ProjectOp(_StageOp):
    def __init__(self, exprs: List[Expression]):
        self.exprs = exprs

    def apply(self, ctx, batch):
        ctx.batch = batch
        cols = [e.eval_tpu(ctx) for e in self.exprs]
        return ColumnarBatch(cols, batch.num_rows,
                             self.out_schema(batch.schema))

    def apply_masked(self, ctx, batch, mask):
        return self.apply(ctx, batch), mask

    def out_schema(self, in_schema):
        return _project_schema(self.exprs)


class FilterOp(_StageOp):
    def __init__(self, condition: Expression):
        self.condition = condition

    def _mask(self, ctx, batch, mask):
        ctx.batch = batch
        pred = self.condition.eval_tpu(ctx)
        return pred.data & pred.validity & mask

    def apply(self, ctx, batch):
        mask = self._mask(ctx, batch, batch.row_mask)
        cols, count = compact_columns(mask, batch.columns)
        return ColumnarBatch(cols, count, batch.schema)

    def apply_masked(self, ctx, batch, mask):
        return batch, self._mask(ctx, batch, mask)

    def out_schema(self, in_schema):
        return in_schema


class FilterProjectOp(_StageOp):
    """Filter immediately followed by Project, fused: projections evaluate on
    the uncompacted batch, then only the projected columns are compacted.
    Not used under ANSI (a removed row must not raise)."""

    def __init__(self, condition: Expression, exprs: List[Expression]):
        self.condition = condition
        self.exprs = exprs

    def apply(self, ctx, batch):
        ctx.batch = batch
        pred = self.condition.eval_tpu(ctx)
        mask = pred.data & pred.validity & batch.row_mask
        cols = [e.eval_tpu(ctx) for e in self.exprs]
        out, count = compact_columns(mask, cols)
        return ColumnarBatch(out, count, self.out_schema(batch.schema))

    def apply_masked(self, ctx, batch, mask):
        ctx.batch = batch
        pred = self.condition.eval_tpu(ctx)
        mask = pred.data & pred.validity & mask
        cols = [e.eval_tpu(ctx) for e in self.exprs]
        return ColumnarBatch(cols, batch.num_rows,
                             self.out_schema(batch.schema)), mask

    def out_schema(self, in_schema):
        return _project_schema(self.exprs)


def _fuse_filter_project(ops: List[_StageOp], ansi: bool) -> List[_StageOp]:
    if ansi:
        return ops
    out: List[_StageOp] = []
    i = 0
    while i < len(ops):
        if (i + 1 < len(ops) and isinstance(ops[i], FilterOp)
                and isinstance(ops[i + 1], ProjectOp)):
            out.append(FilterProjectOp(ops[i].condition, ops[i + 1].exprs))
            i += 2
        else:
            out.append(ops[i])
            i += 1
    return out


class TpuStageExec(TpuExec):
    """A fused chain of narrow ops over one child."""

    def __init__(self, ops: Sequence[_StageOp], child: TpuExec,
                 ansi: bool = False):
        super().__init__([child])
        self.ops = _fuse_filter_project(list(ops), ansi)
        self.ansi = ansi
        self._out_schema = child.output
        for op in self.ops:
            self._out_schema = op.out_schema(self._out_schema)

    @property
    def output(self):
        return self._out_schema

    def describe(self):
        names = "+".join(type(o).__name__.replace("Op", "") for o in self.ops)
        return f"TpuStageExec[{names}]"

    def aot_output_rows(self):
        # projections keep the row count; a filter's is data-dependent
        if any(isinstance(o, (FilterOp, FilterProjectOp)) for o in self.ops):
            return None
        return self.aot_input_rows()

    def aot_output_caps(self):
        return self.aot_input_caps()

    def execute_columnar(self):
        for batch in self.children[0].execute_columnar():
            ctx = EvalContext(batch, ansi=self.ansi)
            for op in self.ops:
                batch = op.apply(ctx, batch)
            ctx.check_errors()
            yield ColumnarBatch(batch.columns, batch.num_rows,
                                self._out_schema)


class TpuProjectExec(TpuStageExec):
    def __init__(self, exprs: List[Expression], child: TpuExec,
                 ansi: bool = False):
        super().__init__([ProjectOp(exprs)], child, ansi)
        self.exprs = exprs

    def describe(self):
        return ("TpuProject [" +
                ", ".join(e.sql_string() for e in self.exprs) + "]")


class TpuFilterExec(TpuStageExec):
    def __init__(self, condition: Expression, child: TpuExec,
                 ansi: bool = False):
        super().__init__([FilterOp(condition)], child, ansi)
        self.condition = condition

    def describe(self):
        return f"TpuFilter ({self.condition.sql_string()})"


def fuse_stages(root: TpuExec) -> TpuExec:
    """Collapse adjacent TpuStageExec chains, and absorb a stage feeding a
    PARTIAL or COMPLETE aggregate into the aggregate (mask mode)."""
    from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
    from spark_rapids_tpu_torch.plan.nodes import AggregateMode

    root.children = [fuse_stages(c) for c in root.children]
    if isinstance(root, TpuStageExec):
        child = root.children[0]
        if isinstance(child, TpuStageExec) and child.ansi == root.ansi:
            merged = TpuStageExec(child.ops + root.ops, child.children[0],
                                  root.ansi)
            return fuse_stages(merged)
    if isinstance(root, TpuHashAggregateExec):
        child = root.children[0]
        if (isinstance(child, TpuStageExec) and not child.ansi
                and not root.ansi and not root.pre_ops
                and root.mode in (AggregateMode.PARTIAL,
                                  AggregateMode.COMPLETE)):
            root.pre_ops = list(child.ops)
            root.input_schema = child.children[0].output
            root.children = [child.children[0]]
    return root


class TpuLocalTableScanExec(TpuExec):
    """Host columns -> device batches of at most ``target_batch_rows``."""

    def __init__(self, host_columns: List[HostColumn], schema: T.StructType,
                 device, target_batch_rows: Optional[int] = None):
        super().__init__([])
        self.host_columns = host_columns
        self._schema = schema
        self.device = device
        self.target_batch_rows = target_batch_rows

    @property
    def output(self):
        return self._schema

    def aot_output_rows(self):
        """The exact row count of each batch ``execute_columnar`` yields."""
        n = self.host_columns[0].num_rows if self.host_columns else 0
        step = self.target_batch_rows or max(n, 1)
        return [min(start + step, n) - start if n else 0
                for start in range(0, max(n, 1), step)]

    def execute_columnar(self):
        n = self.host_columns[0].num_rows if self.host_columns else 0
        step = self.target_batch_rows or max(n, 1)
        for start in range(0, max(n, 1), step):
            end = min(start + step, n)
            cols = [DeviceColumn.from_host(h.slice_rows(start, end),
                                           self.device)
                    for h in self.host_columns]
            yield ColumnarBatch(cols, end - start, self._schema)
            if n == 0:
                break


class TpuUnionExec(TpuExec):
    """UNION ALL: each child's batches in turn."""

    @property
    def output(self):
        return self.children[0].output

    def aot_output_rows(self):
        out = []
        for c in self.children:
            rows = c.aot_output_rows()
            if rows is None:
                return None
            out.extend(rows)
        return out

    def execute_columnar(self):
        for c in self.children:
            yield from c.execute_columnar()

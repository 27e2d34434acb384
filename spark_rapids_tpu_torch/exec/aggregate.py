"""Global hash aggregation — port of the no-key COMPLETE path of
``spark_rapids_tpu/exec/aggregate.py`` (``TpuHashAggregateExec`` with
``_global_agg``, ``_sum_dec128`` and ``_global_agg_empty``), for sum and
count.  The plan rewrite builds it only in COMPLETE mode.

It absorbs the stage below it as ``pre_ops`` (filters only narrow the
row mask).  One input batch gives the result directly; several
batches give one buffer row each, merged as the reference's PARTIAL twins
merge under FINAL: sums add the valid partial sums exactly in 128 bits,
counts add.  Grouped aggregation is a later slice.
"""
from __future__ import annotations

from typing import Iterator, List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.plan.nodes import (AggregateExpression,
                                               AggregateMode)


class TpuHashAggregateExec(TpuExec):
    def __init__(self, grouping: List[Expression],
                 aggregates: List[AggregateExpression],
                 mode: AggregateMode, child: TpuExec,
                 child_plan_output: T.StructType,
                 output_schema: T.StructType,
                 ansi: bool = False):
        super().__init__([child])
        if grouping:
            raise NotOnGpu("grouped aggregation is not ported yet")
        self.grouping = grouping
        self.aggregates = aggregates
        self.mode = mode
        self.child_schema = child_plan_output
        self._output = output_schema
        self.ansi = ansi
        # stage ops absorbed by fuse_stages, applied in row-mask mode
        self.pre_ops = []
        self.input_schema = child_plan_output

    @property
    def output(self):
        return self._output

    def describe(self):
        g = ", ".join(e.sql_string() for e in self.grouping)
        a = ", ".join(a.describe() for a in self.aggregates)
        fused = ""
        if self.pre_ops:
            names = "+".join(type(o).__name__.replace("Op", "")
                             for o in self.pre_ops)
            fused = f" fused=[{names}]"
        return (f"TpuHashAggregate({self.mode.value}) keys=[{g}] "
                f"aggs=[{a}]{fused}")

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        partials = [self._aggregate_batch(b)
                    for b in self.children[0].execute_columnar()]
        if not partials:
            out = self._global_agg_empty()
        elif len(partials) == 1:
            out = partials[0]
        else:
            out = self._merge_batch(ColumnarBatch.concat(partials))
        yield out

    # ------------------------------------------------------------------
    def _aggregate_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Raw input rows -> one result row (the reference's ``_agg_fn``
        with no keys: pre_ops in mask mode, then ``_global_agg``)."""
        ctx = EvalContext(batch, ansi=self.ansi)
        mask = batch.row_mask
        for op in self.pre_ops:
            batch, mask = op.apply_masked(ctx, batch, mask)
        ctx.batch = batch
        out = []
        for a, f in zip(self.aggregates, self._output.fields):
            if a.func == "count_star":
                out.append(DeviceColumn(T.LONG, _ones(mask),
                                        data=mask.sum(0, keepdim=True)))
                continue
            c = a.child.eval_tpu(ctx)
            validity = c.validity & mask
            if a.func == "count":
                out.append(DeviceColumn(T.LONG, _ones(mask),
                                        data=validity.sum(0, keepdim=True)))
            else:
                out.append(_sum_col(c, validity, f.dataType))
        ctx.check_errors()
        return ColumnarBatch(out, 1, self._output)

    def _merge_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Buffer rows (one per partial) -> one row: counts add, sums add
        the valid partial sums."""
        out = []
        for ci, (a, f) in enumerate(zip(self.aggregates,
                                        self._output.fields)):
            c = batch.columns[ci]
            if a.func in ("count", "count_star"):
                out.append(DeviceColumn(
                    T.LONG, _ones(c.validity),
                    data=torch.where(c.validity, c.data, 0).sum(
                        0, keepdim=True)))
            else:
                out.append(_sum_col(c, c.validity, f.dataType))
        return ColumnarBatch(out, 1, self._output)

    def _global_agg_empty(self) -> ColumnarBatch:
        """No input batch: counts are a valid 0, sums are null."""
        dev = self._device()
        cols = []
        for a, f in zip(self.aggregates, self._output.fields):
            shape = ((1, 2) if isinstance(f.dataType, T.DecimalType)
                     and f.dataType.is_128 else (1,))
            counted = a.func in ("count", "count_star")
            cols.append(DeviceColumn(
                f.dataType, torch.full((1,), counted, device=dev),
                data=torch.zeros(shape, dtype=column_torch_dtype(f.dataType),
                                 device=dev)))
        return ColumnarBatch(cols, 1, self._output)

    def _device(self):
        node = self
        while node.children:
            node = node.children[0]
        return node.device


def _ones(like: torch.Tensor) -> torch.Tensor:
    return torch.ones(1, dtype=torch.bool, device=like.device)


def _sum_col(c: DeviceColumn, validity, dt: T.DataType) -> DeviceColumn:
    if isinstance(dt, T.DecimalType) and (dt.is_128 or c.is_dec128):
        return _sum_dec128(c, validity, dt)
    if isinstance(dt, (T.FloatType, T.DoubleType)):
        x = c.data.to(torch.float64)
    else:
        x = c.data.to(torch.int64)
    s = torch.where(validity, x, torch.zeros_like(x)).sum(0, keepdim=True)
    has = validity.any().reshape(1)
    return DeviceColumn(dt, has, data=s.to(column_torch_dtype(dt)))


def _sum_dec128(c: DeviceColumn, validity, dt: T.DecimalType
                ) -> DeviceColumn:
    """Sum of a decimal column into a >18-digit result: exact 128-bit limb
    sums; a sum past 10^precision is null (Spark nullOnOverflow)."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    hi, lo = D.column_limbs(c)
    ok, has, sh, sl = D.sum128_global(hi, lo, validity)
    ok = ok & D.in_bounds(sh, sl, dt.precision)
    data = D.pack(sh, sl) if dt.is_128 else sl
    return DeviceColumn(dt, has & ok, data=data)

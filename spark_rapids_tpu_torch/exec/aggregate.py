"""Hash aggregation — port of ``TpuHashAggregateExec``
(``spark_rapids_tpu/exec/aggregate.py``) for ``sum``, ``count``, ``min``
and ``max``, with and without grouping keys.

Group-by is sort-based, as in the reference: the key columns become key
words (``ops/sortkeys.py``), one stable lexicographic sort orders the rows,
equal consecutive keys form segments, and the segmented reductions of
``ops/segment.py`` reduce each segment.  The group count is a host sync
per aggregated batch (the reference syncs it too, to size its output).
Sums are exact in int64, decimal sums above 18 digits exact in 128-bit
limbs and null past their precision (an error under ANSI); float sums add
in the card's order.

The plan rewrite builds the exec only in COMPLETE mode.  Each input batch
is reduced to a buffer (one row per group) as it arrives; several buffers
are concatenated once and reduced once more, with merge semantics (counts
add).  A buffer has the output's columns plus an overflow flag for each
decimal sum above 18 digits, so a sum that overflowed in one batch stays
null through the merge (Spark's sum buffer keeps the same flag); the
finish drops the flags.  Each input batch is reduced under ``with_retry``
over a spillable handle, as in the reference.  The reference's
PARTIAL/FINAL twins, pairwise merges and finalize let it spill buffers
between merges, which the port does not do: the buffers stay on the card
until the one merge.  It absorbs the stage below it as ``pre_ops``
(filters only narrow the row mask).  An empty grouped input yields no rows; an empty global input yields one row (counts 0,
everything else null).  ``avg``, the moments, HLL, percentile and collect
are not ported: the session rejects them.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.memory.retry import with_retry
from spark_rapids_tpu_torch.memory.spill import get_spill_framework
from spark_rapids_tpu_torch.ops import segment as SEG
from spark_rapids_tpu_torch.ops.sortkeys import (_column_key_words,
                                                 group_segments, lexsort)
from spark_rapids_tpu_torch.perfcounters import sync_get
from spark_rapids_tpu_torch.plan.nodes import (AggregateExpression,
                                               AggregateMode)

_INT64_MAX = 0x7FFFFFFFFFFFFFFF


def _is_float(dt: T.DataType) -> bool:
    return isinstance(dt, (T.FloatType, T.DoubleType))


class _Groups:
    """Rows of one batch grouped by key: ``perm`` orders the rows (None
    without keys), ``seg`` gives each sorted row its group, rows outside
    the mask falling in the extra last segment; ``first`` is each group's
    first sorted row."""

    def __init__(self, perm, seg, num_groups: int, mask_sorted, first):
        self.perm = perm
        self.seg = seg
        self.num_groups = num_groups
        self.mask_sorted = mask_sorted
        self.first = first

    @property
    def nseg(self) -> int:
        return self.num_groups + (1 if self.perm is not None else 0)


def _group(key_cols: List[DeviceColumn], mask: torch.Tensor) -> _Groups:
    """Sort rows by their keys (nulls first, rows outside ``mask`` last)
    and segment them.  One host sync for the group count, with keys."""
    n = mask.shape[0]
    if not key_cols:
        seg = torch.zeros(n, dtype=torch.int64, device=mask.device)
        return _Groups(None, seg, 1, mask, None)
    pad = torch.tensor(_INT64_MAX, dtype=torch.int64, device=mask.device)
    keys: List[torch.Tensor] = []
    for kc in key_cols:
        keys.append(torch.where(mask, torch.where(kc.validity, 0, -1), pad))
        for w in _column_key_words(kc):
            keys.append(torch.where(mask, torch.where(kc.validity, w, 0),
                                    pad))
    perm = lexsort(keys)
    mask_sorted = mask[perm]
    seg, ngroups = group_segments([k[perm] for k in keys], mask_sorted)
    (ng,) = sync_get(ngroups)
    ng = int(ng)
    seg = torch.where(mask_sorted, seg, ng)
    first = SEG.seg_first_index(seg, mask_sorted, ng + 1)[:ng]
    return _Groups(perm, seg, ng, mask_sorted, first)


class TpuHashAggregateExec(TpuExec):
    def __init__(self, grouping: List[Expression],
                 aggregates: List[AggregateExpression],
                 mode: AggregateMode, child: TpuExec,
                 child_plan_output: T.StructType,
                 output_schema: T.StructType,
                 ansi: bool = False):
        super().__init__([child])
        self.grouping = grouping
        self.aggregates = aggregates
        self.mode = mode
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

    # ------------------------------------------------------------------
    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        """A buffer per input batch, reduced before the next batch is read
        under ``with_retry`` over a tracked handle (a split input gives a
        buffer per half); several buffers merge in one pass."""
        fw = get_spill_framework()
        bufs = []
        for b in self.children[0].execute_columnar():
            bufs.extend(with_retry(fw.track(b), self._aggregate_batch))
        if not bufs:
            out = (empty_batch(self._output, self._device()) if self.grouping
                   else self._global_agg_empty())
        else:
            out = self._finish(bufs[0] if len(bufs) == 1 else
                               self._merge_batch(ColumnarBatch.concat(bufs)))
        yield out

    def _flagged(self) -> List[int]:
        """Positions of the aggregates whose buffer carries an overflow
        flag: the decimal sums above 18 digits."""
        k = len(self.grouping)
        return [i for i, (a, f) in enumerate(zip(
            self.aggregates, self._output.fields[k:]))
            if a.func == "sum" and isinstance(f.dataType, T.DecimalType)
            and (f.dataType.is_128 or (a.child is not None and isinstance(
                a.child.dataType, T.DecimalType)
                and a.child.dataType.is_128))]

    def _buffer_schema(self) -> T.StructType:
        return T.StructType(list(self._output.fields) + [
            T.StructField(f"_overflow{i}", T.BOOLEAN, False)
            for i in self._flagged()])

    def _merge_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Buffer rows -> one row per group (the reference's ``_merge_fn``):
        counts add, sums add, min/max take min/max, overflow flags OR."""
        k = len(self.grouping)
        m = len(self.aggregates)
        return self._reduce(batch.columns[:k], batch.columns[k:k + m],
                            batch.row_mask, True, batch.columns[k + m:])

    def _finish(self, buf: ColumnarBatch) -> ColumnarBatch:
        """A buffer -> the output: a sum whose flag is set is null, or under
        ANSI an error (one host sync, only under ANSI)."""
        k = len(self.grouping)
        n_out = len(self._output.fields)
        cols = list(buf.columns[:n_out])
        flags = buf.columns[n_out:]
        if self.ansi and flags:
            from spark_rapids_tpu_torch.expr.base import (
                SparkArithmeticException)

            (hit,) = sync_get(torch.stack([f.data.any() for f in flags]))
            if hit.any():
                raise SparkArithmeticException(
                    "decimal sum overflow (ANSI)")
        for i, f in zip(self._flagged(), flags):
            c = cols[k + i]
            cols[k + i] = DeviceColumn(c.dtype, c.validity & ~f.data,
                                       data=c.data)
        return ColumnarBatch(cols, buf.num_rows, self._output)

    def _aggregate_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Input rows -> one buffer row per group: pre_ops in mask mode,
        then group and reduce (the reference's ``_agg_fn``)."""
        ctx = EvalContext(batch, ansi=self.ansi)
        mask = batch.row_mask
        for op in self.pre_ops:
            batch, mask = op.apply_masked(ctx, batch, mask)
        ctx.batch = batch
        keys = [g.eval_tpu(ctx) for g in self.grouping]
        inputs = [self._input_col(a, ctx) for a in self.aggregates]
        out = self._reduce(keys, inputs, mask, False, [])
        ctx.check_errors()
        return out

    def _input_col(self, a: AggregateExpression, ctx) -> DeviceColumn:
        if a.child is None:                      # count(*)
            cap = ctx.batch.capacity
            dev = ctx.batch.device
            return DeviceColumn(T.LONG,
                                torch.ones(cap, dtype=torch.bool, device=dev),
                                data=torch.ones(cap, dtype=torch.int64,
                                                device=dev))
        return a.child.eval_tpu(ctx)

    def _reduce(self, keys, inputs, mask, merge: bool,
                flags_in) -> ColumnarBatch:
        """Rows (or, with ``merge``, buffer rows and their overflow flags
        ``flags_in``) -> one buffer row per group."""
        g = _group(keys, mask)
        out: List[DeviceColumn] = []
        if g.perm is not None:
            rows = g.perm[g.first]
            out += [kc.gather(rows) for kc in keys]
        fields = self._output.fields[len(keys):]
        flags = []
        for a, c, f in zip(self.aggregates, inputs, fields):
            col, flag = self._eval_agg(a, f, c, g, merge)
            out.append(col.slice(0, g.num_groups))
            if flag is not None:
                flags.append(flag)
        for j, fin in enumerate(flags_in):
            fs = fin.data if g.perm is None else fin.data[g.perm]
            flags[j] = flags[j] | (SEG.seg_count(fs & g.mask_sorted, g.seg,
                                                 g.nseg) > 0)
        out += [DeviceColumn(T.BOOLEAN, torch.ones_like(fl), data=fl)
                .slice(0, g.num_groups) for fl in flags]
        return ColumnarBatch(out, g.num_groups, self._buffer_schema())

    def _eval_agg(self, a: AggregateExpression, f: T.StructField,
                  c: DeviceColumn, g: _Groups, merge: bool):
        """One aggregate over the groups -> (column, overflow flag or
        None).  Update semantics for raw rows; with ``merge`` the input is
        a buffer (the reference's ``_eval_merge``): a count buffer is
        summed."""
        cs = c if g.perm is None else c.gather(g.perm)
        validity = cs.validity & g.mask_sorted
        nseg, seg = g.nseg, g.seg
        func = "count" if a.func == "count_star" else a.func
        if func == "count":
            if merge:
                cnt, _ = SEG.seg_sum(cs.data.to(torch.int64), validity, seg,
                                     nseg)
            else:
                cnt = SEG.seg_count(validity, seg, nseg)
            return DeviceColumn(T.LONG, torch.ones_like(cnt, dtype=torch.bool),
                                data=cnt), None
        dt = f.dataType
        if func == "sum":
            if isinstance(dt, T.DecimalType) and (dt.is_128 or cs.is_dec128):
                return _sum_dec128(cs, validity, seg, nseg, dt)
            s, has = SEG.seg_sum(_sum_input(cs, dt), validity, seg, nseg)
            return DeviceColumn(dt, has, data=s.to(column_torch_dtype(dt))), \
                None
        if func in ("min", "max"):
            if cs.is_dec128:
                return _minmax_dec128(cs, func, seg, validity, nseg, dt), None
            fn = SEG.seg_min if func == "min" else SEG.seg_max
            m, has = fn(cs.data, validity, seg, nseg, _is_float(dt))
            return DeviceColumn(dt, has, data=m), None
        raise NotImplementedError(f"aggregate {func} is not ported yet")

    def _global_agg_empty(self) -> ColumnarBatch:
        """No input batch and no keys: counts are a valid 0, the rest null."""
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


def _sum_input(c: DeviceColumn, out_dtype: Optional[T.DataType]):
    """Sum operand: float64 for floats, else int64 (an integer sum wraps as
    Spark's non-ANSI sum does; a decimal64 sum is not bounds-checked, as in
    the reference)."""
    if _is_float(c.dtype) or (out_dtype is not None and _is_float(out_dtype)):
        return c.data.to(torch.float64)
    return c.data.to(torch.int64)


def _sum_dec128(c: DeviceColumn, validity, seg, nseg: int,
                dt: T.DecimalType):
    """Sum of a decimal column into a result above 18 digits (or over
    128-bit input): exact 128-bit limb sums -> (the sums, valid where a
    group has a value; the overflow flag, set where a sum is past
    10^precision, which the finish turns into Spark's null)."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    hi, lo = D.column_limbs(c)
    ok, has, sh, sl = D.sum128_segments(hi, lo, validity, seg, nseg)
    ok = ok & D.in_bounds(sh, sl, dt.precision)
    data = D.pack(sh, sl) if dt.is_128 else sl
    return DeviceColumn(dt, has, data=data), has & ~ok


def _minmax_dec128(c: DeviceColumn, func: str, seg, validity, nseg: int,
                   dt: T.DataType) -> DeviceColumn:
    """min/max of decimal128: the optimum of the high word, then of the low
    word among the rows that reach it."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    kh, kl = D.key_words(*D.unpack(c.data))
    if func == "max":
        kh, kl = ~kh, ~kl
    big = torch.full_like(kh, _INT64_MAX)
    kh_m = torch.where(validity, kh, big)
    mh = SEG._seg_min_raw(kh_m, seg, nseg)
    tie = validity & (kh_m == mh[seg])
    ml = SEG._seg_min_raw(torch.where(tie, kl, big), seg, nseg)
    has = SEG.seg_count(validity, seg, nseg) > 0
    if func == "max":
        mh, ml = ~mh, ~ml
    return DeviceColumn(dt, has, data=D.pack(mh, ml ^ D._SIGN64))

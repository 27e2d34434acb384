"""Hash aggregation — port of ``TpuHashAggregateExec``
(``spark_rapids_tpu/exec/aggregate.py``) for ``sum``, ``count``, ``min``,
``max`` (strings too), ``avg``, the variance family (``var_pop``,
``var_samp``, ``stddev_pop``, ``stddev_samp``), the higher moments, the
covariance and regression families, ``count_if``,
``bool_and``/``bool_or``, ``bit_and``/``bit_or``/``bit_xor``,
``first``/``last``/``any_value``, ``approx_count_distinct`` and the
single-phase ``collect_list``, ``collect_set``, ``percentile``,
``median``, ``approx_percentile`` and ``bloom_filter_agg``, with and
without grouping keys.

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
are concatenated once and reduced once more, with merge semantics, and the
finish turns the buffer into the output.  Each aggregate's buffer is the
reference's partial buffer: ``avg`` a (sum, count) pair, the variance
family (n, mean, m2) doubles, merged by Chan's formula (the reference
computes the moments of a whole batch in one pass; the port merges
per-batch triples, so doubles may differ in the last digits), the others
their result.  The port adds flags: a decimal sum above 18 digits and an
``avg`` over one carry an overflow flag, so a sum that overflowed in one
batch stays null through the merge (Spark's sum buffer keeps the same
flag), and ``first``/``last``/``any_value`` a seen flag, so a batch that
kept no row does not win the merge.  ``first``/``last``/``any_value``
keep nulls (ignoreNulls false), as the reference's.  A decimal ``avg``
is HALF_UP at the result scale; over a 128-bit sum it divides exactly by
any count, where the reference nulls a group of 2^31 rows or more (ROADMAP
Queue 3).  Each input batch is reduced under ``with_retry``
over a spillable handle, as in the reference.  The reference's
PARTIAL/FINAL twins, pairwise merges and finalize let it spill buffers
between merges, which the port does not do: the buffers stay on the card
until the one merge.  It absorbs the stage below it as ``pre_ops``
(filters only narrow the row mask).  An empty grouped input yields no
rows; an empty global input yields one row (counts 0, everything else
null).  ``skewness`` and ``kurtosis`` extend the variance buffer with m3
(and m4), merged by the reference's closed forms (Pébay's, as segmented
sums); ``covar_pop``, ``covar_samp``, ``corr`` and the nine ``regr_*``
keep (n, xavg, yavg, ck[, xm2, ym2]) over the rows where both inputs are
valid, merged Chan-style.  ``approx_count_distinct`` keeps 2^9
HyperLogLog registers per group (xxhash64, seed 42) as an array<int>
buffer, merged by max, estimated without Spark's bias tables, as the
reference does.  A string ``min``/``max`` sorts each segment by the
value's key words and takes its first row.

An aggregate with a single-phase function (``SINGLE_PHASE_FUNCS``; the
session plans it over an exchange that co-locates each key's rows) runs
the reference's ``_execute_collect``: every input batch concatenated, one
pass, no merge, ``approx_count_distinct`` among them included.  A
collect's lists are as wide as the bucket (``round_up_bucket``) of the
largest group's rows, one host sync; ``collect_list`` keeps arrival
order (the key sort is stable), ``collect_set`` ascends by key word and
drops duplicates, both skip nulls.  ``percentile``/``median`` sort each
group by the float total order and interpolate ``(v_lo (1 - frac) +
v_hi frac) scale`` in that order, ``approx_percentile`` takes the value
at ``floor(p (n - 1))``.  ``bloom_filter_agg`` sets each value's bits
(``expr/hashexprs.py``) and packs them into int64 words by ORs.  An
empty global input gives the reference's ``_collect_empty_global`` row.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   empty_batch, empty_column)
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype,
                                                    round_up_bucket)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.expr.cast import unscaled_double
from spark_rapids_tpu_torch.expr.hashexprs import bloom_bit_indices
from spark_rapids_tpu_torch.memory.retry import with_retry
from spark_rapids_tpu_torch.memory.spill import get_spill_framework
from spark_rapids_tpu_torch.ops import segment as SEG
from spark_rapids_tpu_torch.ops.hashing import _lsr, xxhash64_column
from spark_rapids_tpu_torch.ops.sortkeys import (_CANONICAL_NAN,
                                                 _column_key_words,
                                                 _float_total_order,
                                                 group_segments, lexsort)
from spark_rapids_tpu_torch.perfcounters import sync_get
from spark_rapids_tpu_torch.plan.nodes import (COVARIANCE_FUNCS,
                                               HIGHER_MOMENT_FUNCS,
                                               HLL_DEFAULT_P,
                                               MOMENT_BUFFERS, REGR_FUNCS,
                                               SINGLE_PHASE_FUNCS,
                                               VARIANCE_FUNCS,
                                               AggregateExpression,
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
        self._max_rows = None

    @property
    def nseg(self) -> int:
        return self.num_groups + (1 if self.perm is not None else 0)

    def max_rows(self) -> int:
        """The most rows in one group (one host sync, made once): the
        bound of a collect's element width."""
        if self._max_rows is None:
            cnt = SEG.seg_count(self.mask_sorted, self.seg, self.nseg)
            (mx,) = sync_get(cnt[:self.num_groups].max()
                             if self.num_groups else cnt.sum())
            self._max_rows = int(mx)
        return self._max_rows


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
        buffer per half); several buffers merge in one pass.  With a
        single-phase function, all input in one pass instead."""
        if any(a.func in SINGLE_PHASE_FUNCS for a in self.aggregates):
            yield self._single_phase()
            return
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

    def _single_phase(self) -> ColumnarBatch:
        """Every input batch (the exchange below has co-located each key's
        rows) concatenated and aggregated in one pass, as the reference's
        ``_execute_collect``: a group's list, percentile or filter needs
        all its rows, and no buffer of theirs is merged.  An empty grouped
        input has no rows; an empty global one the reference's
        ``_collect_empty_global`` row."""
        batches = list(self.children[0].execute_columnar())
        if not batches:
            return (empty_batch(self._output, self._device())
                    if self.grouping else self._single_phase_empty())
        batch = (batches[0] if len(batches) == 1
                 else ColumnarBatch.concat(batches))
        return self._finish(self._aggregate_batch(batch))

    def _single_phase_empty(self) -> ColumnarBatch:
        """The reference's global row over no input: an empty list for a
        collect, an all-zero filter for ``bloom_filter_agg``, 0 for
        ``count``, null for every other function."""
        dev = self._device()
        one = torch.ones(1, dtype=torch.bool, device=dev)
        cols = []
        for a, f in zip(self.aggregates, self._output.fields):
            if a.func in ("collect_list", "collect_set"):
                c = _null_column(f.dataType, 1, dev)
                cols.append(_with_validity(c, one))
            elif a.func == "bloom_filter_agg":
                words = int(a.args[1]) // 64
                cols.append(_array_col(f.dataType, torch.zeros(
                    (1, words), dtype=torch.int64, device=dev)))
            elif a.func in ("count", "count_star"):
                cols.append(_count_col(torch.zeros(1, dtype=torch.int64,
                                                   device=dev)))
            else:
                cols.append(_null_column(f.dataType, 1, dev))
        return ColumnarBatch(cols, 1, self._output)

    # -- buffers ----------------------------------------------------------
    def _buffer_layout(self):
        """Per aggregate: (its output field, its buffer fields)."""
        k = len(self.grouping)
        return [(f, buffer_fields(a, f)) for a, f in
                zip(self.aggregates, self._output.fields[k:])]

    def _buffer_schema(self) -> T.StructType:
        k = len(self.grouping)
        return T.StructType(list(self._output.fields[:k]) + [
            bf for _, bfs in self._buffer_layout() for bf in bfs])

    def _split_buffer(self, cols):
        """Buffer columns after the keys -> one list per aggregate."""
        out, pos = [], 0
        for _, bfs in self._buffer_layout():
            out.append(list(cols[pos:pos + len(bfs)]))
            pos += len(bfs)
        return out

    def _merge_batch(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Buffer rows -> one buffer row per group (the reference's
        ``_merge_fn``)."""
        k = len(self.grouping)
        return self._reduce(batch.columns[:k],
                            self._split_buffer(batch.columns[k:]),
                            batch.row_mask, True)

    def _finish(self, buf: ColumnarBatch) -> ColumnarBatch:
        """A buffer -> the output: a sum or avg whose overflow flag is set
        is null, or under ANSI an error (one host sync, only under ANSI
        and only with flags)."""
        k = len(self.grouping)
        per = self._split_buffer(buf.columns[k:])
        if self.ansi:
            flags = [bc[-1].data for (_, bfs), bc in
                     zip(self._buffer_layout(), per)
                     if bfs[-1].name.endswith("_overflow")]
            if flags:
                from spark_rapids_tpu_torch.expr.base import (
                    SparkArithmeticException)

                (hit,) = sync_get(torch.stack([fl.any() for fl in flags]))
                if hit.any():
                    raise SparkArithmeticException(
                        "decimal sum overflow (ANSI)")
        cols = list(buf.columns[:k])
        for a, (f, bfs), bc in zip(self.aggregates, self._buffer_layout(),
                                   per):
            cols.append(_final(a, f.dataType, bfs, bc))
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
        inputs = [[self._input_col(a, ctx)] + (
            [a.child2.eval_tpu(ctx)] if a.child2 is not None else [])
            for a in self.aggregates]
        out = self._reduce(keys, inputs, mask, False)
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
        return string_input_as_double(a, a.child.eval_tpu(ctx), self.ansi)

    def _reduce(self, keys, inputs, mask, merge: bool) -> ColumnarBatch:
        """Rows (each aggregate's input column) or, with ``merge``, buffer
        rows (each aggregate's buffer columns) -> one buffer row per
        group."""
        g = _group(keys, mask)
        out: List[DeviceColumn] = []
        if g.perm is not None:
            rows = g.perm[g.first]
            out += [kc.gather(rows) for kc in keys]
        for a, (f, bfs), cols in zip(self.aggregates, self._buffer_layout(),
                                     inputs):
            cs = [c if g.perm is None else c.gather(g.perm) for c in cols]
            fn = _merge_agg if merge else _update_agg
            out += [c.slice(0, g.num_groups)
                    for c in fn(a, f.dataType, bfs, cs, g)]
        return ColumnarBatch(out, g.num_groups, self._buffer_schema())

    def _global_agg_empty(self) -> ColumnarBatch:
        """No input batch and no keys: one buffer row of one masked-out
        row, finished (counts a valid 0, the rest null)."""
        dev = self._device()
        inputs = [[_null_column(e.dataType, 1, dev) for e in
                   (a.child, a.child2) if e is not None]
                  or [_null_column(T.LONG, 1, dev)]
                  for a in self.aggregates]
        buf = self._reduce([], inputs,
                           torch.zeros(1, dtype=torch.bool, device=dev),
                           False)
        return self._finish(buf)


_PICK_FUNCS = ("first", "last", "any_value")

#: an ``approx_count_distinct`` buffer: its registers, one row per group
_HLL_TYPE = T.ArrayType(T.INT, containsNull=False)

_BIT_OPS = {"bit_and": (torch.bitwise_and, -1),
            "bit_or": (torch.bitwise_or, 0),
            "bit_xor": (torch.bitwise_xor, 0)}


def buffer_fields(a: AggregateExpression, f: T.StructField
                  ) -> List[T.StructField]:
    """One aggregate's buffer columns (the reference's
    ``partial_buffer_schema``, plus the port's flags): a sum above 18
    digits and an ``avg`` over such a sum carry an overflow flag,
    ``first``/``last``/``any_value`` a seen flag; an
    ``approx_count_distinct`` keeps its registers as an array<int>.
    ``f`` is the aggregate's output field."""
    name = f.name
    if a.func == "approx_count_distinct":
        return [T.StructField(f"{name}_hll", _HLL_TYPE, False)]
    flag = T.StructField(f"{name}_overflow", T.BOOLEAN, False)
    if a.func == "sum":
        return [f] + ([flag] if _sum_flagged(a, f.dataType) else [])
    if a.func == "avg":
        sdt = _avg_sum_type(a)
        return ([T.StructField(f"{name}_sum", sdt),
                 T.StructField(f"{name}_count", T.LONG, False)]
                + ([flag] if _is_dec128_type(sdt) else []))
    if a.func in MOMENT_BUFFERS:
        return [T.StructField(name + sfx, T.DOUBLE)
                for sfx in MOMENT_BUFFERS[a.func]]
    if a.func in _PICK_FUNCS:
        return [f, T.StructField(f"{name}_seen", T.BOOLEAN, False)]
    return [f]


def _is_dec128_type(dt) -> bool:
    return isinstance(dt, T.DecimalType) and dt.is_128


def _sum_flagged(a: AggregateExpression, dt: T.DataType) -> bool:
    """A decimal sum above 18 digits (or over 128-bit input) carries an
    overflow flag."""
    return isinstance(dt, T.DecimalType) and (
        dt.is_128 or (a.child is not None and _is_dec128_type(
            a.child.dataType)))


def _avg_sum_type(a: AggregateExpression) -> T.DataType:
    """``avg``'s sum buffer: decimal(p + 10, s) for a decimal input (128
    bits above 8 digits of input, as the reference's ``buf128``), double
    for every other number: an integer input adds as float64, as Spark's
    ``Average`` and the reference's ``partial_buffer_schema`` do, so a sum
    past 2^63 does not wrap."""
    ct = a.child.dataType
    if isinstance(ct, T.DecimalType):
        return T.DecimalType(min(ct.precision + 10, 38), ct.scale)
    return T.DOUBLE


def _null_column(dt: T.DataType, n: int, device) -> DeviceColumn:
    """``n`` null rows of ``dt`` (zero buffers)."""
    return empty_column(dt, device).map_rows(
        lambda t: torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device))


def _with_validity(c: DeviceColumn, validity) -> DeviceColumn:
    return DeviceColumn(c.dtype, validity, data=c.data, chars=c.chars,
                        lengths=c.lengths, children=c.children,
                        elem_valid=c.elem_valid)


def _array_col(dt: T.DataType, data: torch.Tensor) -> DeviceColumn:
    """Valid rows of full lists: every row of ``data`` (rows, width)."""
    n, w = data.shape
    dev = data.device
    return DeviceColumn(dt, torch.ones(n, dtype=torch.bool, device=dev),
                        data=data,
                        lengths=torch.full((n,), w, dtype=torch.int32,
                                           device=dev),
                        elem_valid=torch.ones((n, w), dtype=torch.bool,
                                              device=dev))


def _flag_col(fl: torch.Tensor) -> DeviceColumn:
    return DeviceColumn(T.BOOLEAN, torch.ones_like(fl), data=fl)


def _count_col(cnt: torch.Tensor) -> DeviceColumn:
    return DeviceColumn(T.LONG, torch.ones_like(cnt, dtype=torch.bool),
                        data=cnt)


def _sum_cols(c: DeviceColumn, validity, g: _Groups, dt: T.DataType,
              flagged: bool) -> List[DeviceColumn]:
    """A sum buffer (and its overflow flag when ``flagged``) over the
    sorted column ``c``."""
    if isinstance(dt, T.DecimalType) and (dt.is_128 or c.is_dec128):
        col, flag = _sum_dec128(c, validity, g.seg, g.nseg, dt)
        return [col] + ([_flag_col(flag)] if flagged else [])
    s, has = SEG.seg_sum(_sum_input(c, dt), validity, g.seg, g.nseg)
    return [DeviceColumn(dt, has, data=s.to(column_torch_dtype(dt)))]


def _or_flags(flag: DeviceColumn, buf_flag: DeviceColumn,
              g: _Groups) -> DeviceColumn:
    """A merged overflow flag: the new sum's, or any merged buffer's."""
    hit = SEG.seg_count(buf_flag.data & g.mask_sorted, g.seg, g.nseg) > 0
    return _flag_col(flag.data | hit)


def _pick(c: DeviceColumn, idx, seen, nseg: int) -> DeviceColumn:
    """The rows ``idx`` of ``c`` (one per segment), null where not
    ``seen``."""
    if c.capacity == 0:
        return _null_column(c.dtype, nseg, c.device)
    v = c.gather(idx.clamp(0, c.capacity - 1))
    return _with_validity(v, v.validity & seen)


def _minmax_cols(c, func, validity, g, dt) -> List[DeviceColumn]:
    if c.is_string:
        return [_minmax_string(c, func, validity, g)]
    if c.is_dec128:
        return [_minmax_dec128(c, func, g.seg, validity, g.nseg, dt)]
    fn = SEG.seg_min if func == "min" else SEG.seg_max
    m, has = fn(c.data, validity, g.seg, g.nseg, _is_float(dt))
    return [DeviceColumn(dt, has, data=m)]


def _moments(x, valid, g: _Groups):
    """(n, mean, m2) of the valid doubles per segment: two passes in the
    batch, as the reference's ``_eval_variance``."""
    n = SEG.seg_count(valid, g.seg, g.nseg).to(torch.float64)
    s, _ = SEG.seg_sum(x, valid, g.seg, g.nseg)
    nz = n > 0
    mean = s / torch.where(nz, n, 1.0)
    d = torch.where(valid, x - mean[g.seg], 0.0)
    m2, _ = SEG.seg_sum(d * d, valid, g.seg, g.nseg)
    return n, mean, m2


def _moment_cols(n, *moments) -> List[DeviceColumn]:
    """A moment buffer: n (always valid), then its moments (valid where n
    is positive)."""
    nz = n > 0
    return [DeviceColumn(T.DOUBLE, torch.ones_like(nz), data=n)] + [
        DeviceColumn(T.DOUBLE, nz, data=m) for m in moments]


def _cov_cols(func: str, a: DeviceColumn, b: DeviceColumn,
              g: _Groups) -> List[DeviceColumn]:
    """(n, xavg, yavg, ck[, xm2, ym2]) over the rows where both inputs are
    valid, two passes in the batch (the reference's ``_eval_covariance``):
    ``regr_f(y, x)`` takes x from its second input, the others from their
    first."""
    xc, yc = (b, a) if func in REGR_FUNCS else (a, b)
    valid = xc.validity & yc.validity & g.mask_sorted
    x = torch.where(valid, _as_double(xc), 0.0)
    y = torch.where(valid, _as_double(yc), 0.0)
    n = SEG.seg_count(valid, g.seg, g.nseg).to(torch.float64)
    safe = torch.where(n > 0, n, 1.0)
    xavg = SEG.seg_sum(x, valid, g.seg, g.nseg)[0] / safe
    yavg = SEG.seg_sum(y, valid, g.seg, g.nseg)[0] / safe
    dx = torch.where(valid, x - xavg[g.seg], 0.0)
    dy = torch.where(valid, y - yavg[g.seg], 0.0)
    sums = [dx * dy] + ([dx * dx, dy * dy]
                        if len(MOMENT_BUFFERS[func]) > 4 else [])
    return _moment_cols(n, xavg, yavg, *[
        SEG.seg_sum(t, valid, g.seg, g.nseg)[0] for t in sums])


def _update_agg(a: AggregateExpression, dt: T.DataType, bfs,
                cols: List[DeviceColumn], g: _Groups) -> List[DeviceColumn]:
    """One aggregate over raw rows (its input columns, sorted) -> its
    buffer columns, one row per segment (the reference's ``_eval_agg``)."""
    if a.func in COVARIANCE_FUNCS or a.func in REGR_FUNCS:
        return _cov_cols(a.func, *cols, g)
    c = cols[0]
    validity = c.validity & g.mask_sorted
    func = a.func
    if func in ("count", "count_star"):
        return [_count_col(SEG.seg_count(validity, g.seg, g.nseg))]
    if func == "count_if":
        hit = validity & c.data.to(torch.bool)
        return [_count_col(SEG.seg_count(hit, g.seg, g.nseg))]
    if func == "sum":
        return _sum_cols(c, validity, g, dt, len(bfs) > 1)
    if func == "avg":
        sums = _sum_cols(c, validity, g, bfs[0].dataType, len(bfs) > 2)
        return (sums[:1] + [_count_col(SEG.seg_count(validity, g.seg,
                                                     g.nseg))] + sums[1:])
    if func in ("min", "max", "bool_and", "bool_or"):
        mm = {"bool_and": "min", "bool_or": "max"}.get(func, func)
        return _minmax_cols(c, mm, validity, g, dt)
    if func in _BIT_OPS:
        op, ident = _BIT_OPS[func]
        m, has = SEG.seg_fold(c.data, validity, g.seg, g.nseg, op, ident)
        return [DeviceColumn(dt, has, data=m)]
    if func in _PICK_FUNCS:
        # ignoreNulls false, as the reference's: the group's first (last)
        # row, null or not
        if func == "last":
            idx = SEG.seg_last_index(g.seg, g.mask_sorted, g.nseg)
            seen = idx >= 0
        else:
            idx = SEG.seg_first_index(g.seg, g.mask_sorted, g.nseg)
            seen = idx < c.capacity
        return [_pick(c, idx, seen, g.nseg), _flag_col(seen)]
    if func in VARIANCE_FUNCS:
        x = torch.where(validity, _as_double(c), 0.0)
        return _moment_cols(*_moments(x, validity, g))
    if func in HIGHER_MOMENT_FUNCS:
        x = torch.where(validity, _as_double(c), 0.0)
        n, mean, m2 = _moments(x, validity, g)
        d = torch.where(validity, x - mean[g.seg], 0.0)
        higher = [SEG.seg_sum(d ** k, validity, g.seg, g.nseg)[0]
                  for k in ((3, 4) if func == "kurtosis" else (3,))]
        return _moment_cols(n, mean, m2, *higher)
    if func == "approx_count_distinct":
        return [_hll_registers(c, validity, g)]
    if func in ("percentile", "median", "approx_percentile"):
        return [_percentile(a, dt, c, validity, g)]
    if func == "bloom_filter_agg":
        return [_bloom_filter(a, dt, c, validity, g)]
    if func in ("collect_list", "collect_set"):
        return [_collect(func, dt, c, validity, g)]
    raise NotImplementedError(f"aggregate {func} is not ported yet")


def _merge_agg(a: AggregateExpression, dt: T.DataType, bfs,
               cols: List[DeviceColumn], g: _Groups) -> List[DeviceColumn]:
    """One aggregate over buffer rows (sorted) -> its merged buffer (the
    reference's ``_eval_merge``): counts add, sums add and their flags
    OR, min/max and the folds fold again, first/last take the first
    (last) buffer row that saw a row, moments Chan-merge."""
    func = a.func
    if func in ("count", "count_star", "count_if"):
        (c,) = cols
        cnt, _ = SEG.seg_sum(c.data.to(torch.int64), g.mask_sorted, g.seg,
                             g.nseg)
        return [_count_col(cnt)]
    if func in ("sum", "avg"):
        c = cols[0]
        sdt = bfs[0].dataType
        flagged = bfs[-1].name.endswith("_overflow")
        out = _sum_cols(c, c.validity & g.mask_sorted, g, sdt, flagged)
        if flagged:
            out[1] = _or_flags(out[1], cols[-1], g)
        if func == "avg":
            cnt, _ = SEG.seg_sum(cols[1].data, g.mask_sorted, g.seg, g.nseg)
            out.insert(1, _count_col(cnt))
        return out
    if func in _PICK_FUNCS:
        c, seen = cols
        mask = g.mask_sorted & seen.data
        if func == "last":
            idx = SEG.seg_last_index(g.seg, mask, g.nseg)
            got = idx >= 0
        else:
            idx = SEG.seg_first_index(g.seg, mask, g.nseg)
            got = idx < c.capacity
        return [_pick(c, idx, got, g.nseg), _flag_col(got)]
    if func in VARIANCE_FUNCS or func in HIGHER_MOMENT_FUNCS:
        return _moment_cols(*_merge_moment_bufs(cols, g))
    if func in COVARIANCE_FUNCS or func in REGR_FUNCS:
        return _moment_cols(*_merge_cov_bufs(cols, g))
    if func == "approx_count_distinct":
        (c,) = cols
        m = c.ewidth
        seg = torch.where(c.validity & g.mask_sorted, g.seg, g.nseg)
        regs = torch.zeros((g.nseg + 1, m), dtype=torch.int32,
                           device=c.device)
        regs.scatter_reduce_(0, seg[:, None].expand(-1, m), c.data, "amax")
        return [_array_col(_HLL_TYPE, regs[:g.nseg])]
    return _update_agg(a, dt, bfs, cols, g)


def _final(a: AggregateExpression, dt: T.DataType, bfs,
           cols: List[DeviceColumn]) -> DeviceColumn:
    """One aggregate's buffer -> its result column."""
    func = a.func
    if func == "sum":
        c = cols[0]
        if len(cols) > 1:
            return _with_validity(c, c.validity & ~cols[1].data)
        return c
    if func == "avg":
        return _avg_final(a, dt, cols)
    if func in VARIANCE_FUNCS:
        n, mean, m2 = (c.data for c in cols)
        pop = func.endswith("_pop")
        den = n if pop else n - 1.0
        # Spark's nullOnDivideByZero: a sample of one row is null
        ok = (n > 0) & (den > 0.0)
        var = m2 / torch.where(ok, den, 1.0)
        res = var if func.startswith("var") else torch.sqrt(var)
        return DeviceColumn(T.DOUBLE, ok, data=res)
    if func in HIGHER_MOMENT_FUNCS:
        return _moment_final(func, *(c.data for c in cols))
    if func in COVARIANCE_FUNCS or func in REGR_FUNCS:
        return _cov_final(func, *(c.data for c in cols))
    if func == "approx_count_distinct":
        return _count_col(_hll_estimate(cols[0].data))
    return cols[0]


def _avg_final(a: AggregateExpression, dt: T.DataType,
               cols: List[DeviceColumn]) -> DeviceColumn:
    """sum / count: a double for numbers, HALF_UP at the result scale for
    decimals (exact 128-bit division above 18 digits of sum, the
    reference's int64 path below)."""
    s, cnt = cols[0], cols[1].data
    nz = cnt > 0
    valid = s.validity & nz
    if len(cols) > 2:
        valid = valid & ~cols[2].data
    den = torch.where(nz, cnt, 1)
    if not isinstance(dt, T.DecimalType):
        return DeviceColumn(T.DOUBLE, valid,
                            data=s.data.to(torch.float64) / den)
    shift = dt.scale - a.child.dataType.scale
    if s.is_dec128:
        from spark_rapids_tpu_torch.expr import decimal128 as D

        over, qh, ql = D.div128_by_count_half_up(*D.unpack(s.data), den,
                                                 shift)
        valid = valid & ~over & D.in_bounds(qh, ql, dt.precision)
        return DeviceColumn(dt, valid,
                            data=D.pack(qh, ql) if dt.is_128 else ql)
    num = s.data * (10 ** shift)
    q = torch.div(num, den, rounding_mode="trunc")
    rem = num - q * den
    q = q + torch.where(rem.abs() * 2 >= den, torch.sign(num), 0) \
        * (rem != 0)
    return DeviceColumn(dt, valid, data=q)


def _as_double(c: DeviceColumn) -> torch.Tensor:
    """A numeric column as doubles (a decimal scaled, as Spark casts it;
    a decimal above 18 digits, which only a CPU stage aggregates, from its
    limbs, as the cast to DOUBLE reads them)."""
    if c.is_dec128:
        return unscaled_double(c) * (10.0 ** -c.dtype.scale)
    x = c.data.to(torch.float64)
    if isinstance(c.dtype, T.DecimalType):
        x = x * (10.0 ** -c.dtype.scale)
    return x


def string_input_as_double(a: AggregateExpression, c: DeviceColumn,
                           ansi: bool) -> DeviceColumn:
    """``avg`` and the variance family read a string input as doubles
    (``expr/cast.py::strings_to_double``, on the host, as the reference's
    cast); every other input as it is."""
    if c.is_string and (a.func == "avg" or a.func in VARIANCE_FUNCS):
        from spark_rapids_tpu_torch.expr.cast import strings_to_double

        return strings_to_double(c, ansi)
    return c


def _merged_mean(cols: List[DeviceColumn], g: _Groups, valid, n_r):
    """The weighted mean of buffer rows' means (``cols[1]``) per segment:
    (their total n, the mean, each row's distance from it)."""
    ntot, _ = SEG.seg_sum(n_r, valid, g.seg, g.nseg)
    means = torch.where(valid, cols[0].data, 0.0)
    s, _ = SEG.seg_sum(n_r * means, valid, g.seg, g.nseg)
    mean = s / torch.where(ntot > 0, ntot, 1.0)
    return ntot, mean, torch.where(valid, means - mean[g.seg], 0.0)


def _merge_moment_bufs(cols: List[DeviceColumn], g: _Groups):
    """(n, mean, m2[, m3[, m4]]) buffer rows merged per segment by the
    order-independent closed forms: Chan's for m2, Pébay's for m3 and m4,
    as segmented sums (the reference's ``_chan_merge`` and
    ``_merge_moment_bufs``)."""
    cn = cols[0]
    valid = cn.validity & g.mask_sorted & (cn.data > 0)
    n_r = torch.where(valid, cn.data, 0.0)
    ntot, mean, d = _merged_mean(cols[1:], g, valid, n_r)
    m = [torch.where(valid, c.data, 0.0) for c in cols[2:]]

    def ssum(t):
        return SEG.seg_sum(t, valid, g.seg, g.nseg)[0]

    out = [ssum(m[0] + n_r * d * d)]
    if len(m) > 1:
        out.append(ssum(m[1] + 3.0 * m[0] * d + n_r * d ** 3))
    if len(m) > 2:
        out.append(ssum(m[2] + 4.0 * m[1] * d + 6.0 * m[0] * d * d
                        + n_r * d ** 4))
    return (ntot, mean, *out)


def _merge_cov_bufs(cols: List[DeviceColumn], g: _Groups):
    """(n, xavg, yavg, ck[, xm2, ym2]) buffer rows merged per segment (the
    reference's ``_merge_cov_bufs``)."""
    cn = cols[0]
    valid = cn.validity & g.mask_sorted & (cn.data > 0)
    n_r = torch.where(valid, cn.data, 0.0)
    ntot, xavg, dx = _merged_mean(cols[1:2], g, valid, n_r)
    _, yavg, dy = _merged_mean(cols[2:3], g, valid, n_r)

    def ssum(i, t):
        return SEG.seg_sum(torch.where(valid, cols[i].data, 0.0) + n_r * t,
                           valid, g.seg, g.nseg)[0]

    out = [ssum(3, dx * dy)]
    if len(cols) > 4:
        out += [ssum(4, dx * dx), ssum(5, dy * dy)]
    return (ntot, xavg, yavg, *out)


def _moment_final(func: str, n, mean, m2, m3, m4=None) -> DeviceColumn:
    """skewness sqrt(n) m3 / m2^1.5, kurtosis n m4 / m2^2 - 3; null where
    n is 0 or m2 is 0 (Spark's nullOnDivideByZero)."""
    ok = (n > 0) & (m2 != 0.0)
    m2 = torch.where(ok, m2, 1.0)
    if func == "kurtosis":
        return DeviceColumn(T.DOUBLE, ok, data=n * m4 / (m2 * m2) - 3.0)
    return DeviceColumn(T.DOUBLE, ok,
                        data=torch.sqrt(n) * m3 / torch.pow(m2, 1.5))


def _cov_final(func: str, n, xavg, yavg, ck, xm2=None,
               ym2=None) -> DeviceColumn:
    """The covariance and regression results from their buffer, with the
    reference's null rules: n of 0 is null (``regr_count`` 0), a sample
    covariance of one row null, a zero-variance ``corr`` NaN, a zero x
    variance null for the slope, intercept and r2, a zero y variance an r2
    of 1."""
    nz = n > 0
    if func == "regr_count":
        return DeviceColumn(T.LONG, torch.ones_like(nz),
                            data=n.to(torch.int64))
    plain = {"regr_avgx": xavg, "regr_avgy": yavg, "regr_sxx": xm2,
             "regr_syy": ym2, "regr_sxy": ck}
    if func in plain:
        return DeviceColumn(T.DOUBLE, nz, data=plain[func])
    if func == "corr":
        return DeviceColumn(T.DOUBLE, nz, data=ck / torch.sqrt(xm2 * ym2))
    if func == "covar_pop":
        return DeviceColumn(T.DOUBLE, nz,
                            data=ck / torch.where(nz, n, 1.0))
    if func == "covar_samp":
        ok = n > 1.0
        return DeviceColumn(T.DOUBLE, ok,
                            data=ck / torch.where(ok, n - 1.0, 1.0))
    ok = nz & (xm2 != 0.0)
    slope = ck / torch.where(xm2 != 0.0, xm2, 1.0)
    if func == "regr_slope":
        return DeviceColumn(T.DOUBLE, ok, data=slope)
    if func == "regr_intercept":
        return DeviceColumn(T.DOUBLE, ok, data=yavg - slope * xavg)
    den = xm2 * ym2
    r2 = torch.where(ym2 == 0.0, 1.0,
                     ck * ck / torch.where(den != 0.0, den, 1.0))
    return DeviceColumn(T.DOUBLE, ok, data=r2)


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


def _minmax_string(c: DeviceColumn, func: str, validity, g: _Groups
                   ) -> DeviceColumn:
    """min/max of strings (the reference's ``_minmax_string``): the rows
    sorted by (segment, null last, the value's key words, complemented for
    max); each segment's first row.  The words carry the length (ops/
    sortkeys.py), so "a" sorts below "a\\x00" as in Spark."""
    if c.capacity == 0:
        return _null_column(c.dtype, g.nseg, c.device)
    words = _column_key_words(c)
    order = lexsort([g.seg, (~validity).to(torch.int64)]
                    + [w if func == "min" else ~w for w in words])
    first = SEG.seg_first_index(g.seg[order],
                                torch.ones_like(validity), g.nseg)
    out = c.gather(order[first.clamp(0, c.capacity - 1)])
    has = SEG.seg_count(validity, g.seg, g.nseg) > 0
    return _with_validity(out, out.validity & has)


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zero bits of each int64 word read as unsigned (64 for 0):
    a binary search by shifts, exact for every word."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = _lsr(x, 64 - s) == 0
        n = n + torch.where(top_zero, s, 0)
        x = torch.where(top_zero, x << s, x)
    return n + (x == 0).to(torch.int64)


def _hll_registers(c: DeviceColumn, validity, g: _Groups) -> DeviceColumn:
    """approx_count_distinct's registers (the reference's ``_eval_hll``):
    each valid value's xxhash64 (seed 42) picks register ``h >>> (64 -
    p)`` and offers the rank ``min(clz(h << p) + 1, 65 - p)``; each
    register keeps its largest rank (a scatter-max), 2^p per group."""
    p, m = HLL_DEFAULT_P, 1 << HLL_DEFAULT_P
    h = xxhash64_column(c, torch.full((c.capacity,), 42, dtype=torch.int64,
                                      device=c.device))
    rank = (_clz64(h << p) + 1).clamp(max=65 - p).to(torch.int32)
    slot = torch.where(validity, g.seg, g.nseg) * m + _lsr(h, 64 - p)
    regs = torch.zeros((g.nseg + 1) * m, dtype=torch.int32, device=c.device)
    regs.scatter_reduce_(0, slot, rank, "amax")
    return _array_col(_HLL_TYPE, regs.view(g.nseg + 1, m)[:g.nseg])


def _hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """The reference's HyperLogLog estimate of each row of registers
    (without Spark's bias tables): linear counting ``m ln(m / zeros)``
    while the raw estimate is at most 2.5 m and a register is still 0,
    else the raw ``alpha m^2 / sum(2^-register)``; rounded half to even.
    Every division is tensor by tensor (a scalar over a tensor multiplies
    by the reciprocal), and 2^-r is exact (``ldexp``)."""
    m = regs.shape[1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    one = torch.ones_like(regs, dtype=torch.float64)
    inv = torch.ldexp(one, -regs.to(torch.int64)).sum(dim=1)
    raw = torch.full_like(inv, alpha * m * m) / inv
    zeros = (regs == 0).sum(dim=1).to(torch.float64)
    lin = m * torch.log(torch.full_like(zeros, float(m))
                        / zeros.clamp(min=1.0))
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), lin, raw)
    return torch.round(est).to(torch.int64)


def _percentile(a: AggregateExpression, dt: T.DataType, c: DeviceColumn,
                validity, g: _Groups) -> DeviceColumn:
    """percentile and median (interpolated) and approx_percentile (the
    value at floor(p (n - 1)), exact while a group is one batch, as the
    reference's): the rows sorted stably by (segment, null last, the
    value's key: the float total order with NaN canonical and last, -0.0
    below 0.0), then each group's two ranks read from its run;
    ``(v_lo (1 - frac) + v_hi frac) scale`` in that order of operations,
    the reference's ``_eval_percentile``."""
    pct = 0.5 if a.func == "median" else float(a.args[0])
    n = c.capacity
    if n == 0:
        return _null_column(dt, g.nseg, c.device)
    dec128 = c.is_dec128
    if _is_float(c.dtype):
        f = c.data.to(torch.float64)
        bits = torch.where(torch.isnan(f), _CANONICAL_NAN,
                           f.view(torch.int64))
        vkeys = [_float_total_order(bits)]
    elif dec128:
        # only a CPU stage reaches here (the rules keep it off the card)
        vkeys = _column_key_words(c)
    else:
        vkeys = [c.data.to(torch.int64)]
    order = lexsort([torch.where(g.mask_sorted, g.seg, g.nseg),
                     (~validity).to(torch.int64)] + vkeys)
    sdata = c.data[order]
    rows = SEG.seg_count(g.mask_sorted, g.seg, g.nseg)
    starts = torch.cumsum(rows, 0) - rows
    nv = SEG.seg_count(validity, g.seg, g.nseg)
    r = pct * (nv.clamp(min=1) - 1).to(torch.float64)
    lo = torch.floor(r).to(torch.int64)
    v_lo = sdata[(starts + lo).clamp(0, n - 1)]
    if a.func == "approx_percentile":
        return DeviceColumn(dt, nv > 0, data=v_lo)
    frac = r - lo.to(torch.float64)
    v_hi = sdata[(starts + torch.ceil(r).to(torch.int64)).clamp(0, n - 1)]
    scale = (10.0 ** -c.dtype.scale if isinstance(c.dtype, T.DecimalType)
             else 1.0)
    if dec128:
        v_lo = unscaled_double(DeviceColumn(c.dtype, nv > 0, data=v_lo))
        v_hi = unscaled_double(DeviceColumn(c.dtype, nv > 0, data=v_hi))
    res = (v_lo.to(torch.float64) * (1.0 - frac)
           + v_hi.to(torch.float64) * frac) * scale
    return DeviceColumn(T.DOUBLE, nv > 0, data=res)


def _bloom_filter(a: AggregateExpression, dt: T.DataType, c: DeviceColumn,
                  validity, g: _Groups) -> DeviceColumn:
    """bloom_filter_agg (the reference's ``_eval_bloom``): each valid
    value sets its ``k`` bits (``expr/hashexprs.py``) in its group's
    ``num_bits``; the bits pack into ``num_bits / 64`` int64 words, bit
    ``b`` at bit ``b % 64`` of word ``b // 64``, by bitwise ORs."""
    num_items, num_bits = int(a.args[0]), int(a.args[1])
    base = torch.where(validity, g.seg, g.nseg) * num_bits
    bits = torch.zeros((g.nseg + 1) * num_bits, dtype=torch.bool,
                       device=c.device)
    for bit in bloom_bit_indices(c, num_items, num_bits):
        bits[base + bit] = True
    x = bits.view(g.nseg + 1, num_bits // 64, 64)[:g.nseg].to(torch.int64) \
        << torch.arange(64, dtype=torch.int64, device=c.device)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] | x[..., half:]
    return _array_col(dt, x[..., 0])


def _collect(func: str, dt: T.DataType, c: DeviceColumn, validity,
             g: _Groups) -> DeviceColumn:
    """collect_list and collect_set (the reference's ``_eval_collect``):
    each group's valid values in a list as wide as the largest group's
    row bucket (``round_up_bucket``); a list in arrival order (the stable
    key sort keeps it), a set ascending by the value's key words with
    duplicates dropped.  Nulls are skipped."""
    ew = round_up_bucket(max(g.max_rows(), 1))
    seg = g.seg
    n = c.capacity
    if func == "collect_set" and n:
        words = [torch.where(validity, w, 0) for w in _column_key_words(c)]
        order = lexsort([seg, (~validity).to(torch.int64)] + words)
        seg, validity, c = seg[order], validity[order], c.gather(order)
        dup = torch.zeros_like(validity)
        dup[1:] = seg[1:] == seg[:-1]
        for w in words:
            w = w[order]
            dup[1:] &= w[1:] == w[:-1]
        validity = validity & ~dup
    csum = torch.cumsum(validity.to(torch.int64), 0)
    rank = csum
    if n:
        # the valid rows before each row's segment
        first = SEG.seg_first_index(seg, torch.ones_like(validity), g.nseg)
        before = (csum - validity.to(torch.int64))[first.clamp(0, n - 1)]
        rank = csum - 1 - before[seg]
    slot = torch.where(validity, seg * ew + rank, g.nseg * ew)
    edt = column_torch_dtype(dt.elementType)
    data = torch.zeros(g.nseg * ew + 1, dtype=edt, device=c.device)
    ev = torch.zeros(g.nseg * ew + 1, dtype=torch.bool, device=c.device)
    data[slot] = c.data.to(edt)
    ev[slot] = True
    lengths = SEG.seg_count(validity, seg, g.nseg).to(torch.int32)
    return DeviceColumn(dt, torch.ones(g.nseg, dtype=torch.bool,
                                       device=c.device),
                        data=data[:-1].view(g.nseg, ew), lengths=lengths,
                        elem_valid=ev[:-1].view(g.nseg, ew))

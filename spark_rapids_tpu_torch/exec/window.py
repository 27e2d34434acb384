"""TpuWindowExec — window functions via segmented scans (port of
``spark_rapids_tpu/exec/window.py``).

As in the reference's in-core window, the input batches are concatenated,
the rows sorted by (partition keys, order keys) with ``ops/sortkeys``'
``lexsort``, and every function computed in sorted order from three flags
and indices: where a partition starts, where the order key changes (a new
peer group), and each row's position in its partition.  The results are
scattered back to the input's row order.  Every function and frame of the
reference's ``_WINDOW_FUNCS_SUPPORTED`` runs:

* ``row_number``, ``rank``, ``dense_rank``, ``percent_rank``,
  ``cume_dist`` and ``ntile``: positions, each peer group's first row and
  partition sizes;
* ``lead``/``lag``: a shifted gather inside the partition, with a literal
  default (strings included);
* ``first_value``/``last_value``: a gather at the frame's first (last)
  row; with IGNORE NULLS through the next-valid (prev-valid) index scans;
* ``sum``, ``count``, ``avg``, ``min``, ``max`` and the variance family
  over the ``running`` frame (ROWS UNBOUNDED PRECEDING .. CURRENT ROW):
  the segmented scans of ``ops/segment.py`` (the variance family a scan
  of Chan's (n, mean, m2) merge); over ``range_running`` (RANGE
  UNBOUNDED PRECEDING .. CURRENT ROW) the running value at the row's last
  order-key peer; over ``unbounded`` the running value at the partition's
  last row;
* bounded ROWS frames ``("rows", a, b)``: integer sums and counts as
  prefix differences (exact under int64 wrap), the rest as ``a + b + 1``
  shifted combines (the variance family in two passes, as the reference);
* bounded RANGE frames ``("range", a, b)`` over one integral, floating or
  DATE order key: each row's frame found by a binary search inside its
  partition's non-null rows (null and NaN keys frame their own peers,
  int64 bounds saturate, a descending key flips the bounds), then prefix
  differences for counts and integer sums, block-decomposed merges over
  doubling tables for float sums and the variance family, and a sparse
  table for min/max;
* string ``min``/``max`` over ``running``, ``range_running`` and
  ``unbounded``: the segmented lexicographic arg-min/arg-max scan;
* a ``sum`` whose decimal result is above 18 digits: 128-bit frame sums of
  32-bit limb prefix sums, exact as the reference's oracle (its device
  raises there, ROADMAP R23).

The first row of a partition or of a peer group is found with a cumsum
and one scatter (``ops/segment.py::seg_first_rows``), where the reference
takes a ``cummax``; its last row with a cumsum and one ``scatter_reduce``,
where the reference takes a reversed ``cummin``.  The reference finds a
RANGE frame's bounds with one stable four-key sort over 2N keys; the
binary search gives the same indices without a sort.  The doubling tables
are built only to the bit length of the widest frame (one host sync a
window) and shared by the functions over the same input, where the
reference builds every level of the batch for each function.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_column
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression, Literal
from spark_rapids_tpu_torch.ops import segment as SEG
from spark_rapids_tpu_torch.ops.sortkeys import (SortSpec, _column_key_words,
                                                 float_order_key, lexsort,
                                                 pack_sort_keys, word_ranks)
from spark_rapids_tpu_torch.perfcounters import sync_get
from spark_rapids_tpu_torch.plan.nodes import WindowFunction

_VAR_FUNCS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")
_I64_MAX = 9223372036854775807
_I64_MIN = -9223372036854775808


def _change_flags(cols: List[DeviceColumn], perm: torch.Tensor,
                  flags: torch.Tensor) -> torch.Tensor:
    """``flags`` or-ed with "this sorted row's key differs from the row
    before": a null bit, then the key words with nulls set to 0."""
    out = flags.clone()
    for c in cols:
        words = [(~c.validity).to(torch.int64)[perm]]
        words += [torch.where(c.validity, w, 0)[perm]
                  for w in _column_key_words(c)]
        for w in words:
            out[1:] |= w[1:] != w[:-1]
    return out


def _run_last(run_starts: torch.Tensor, mask_s: torch.Tensor,
              iota: torch.Tensor) -> torch.Tensor:
    """For each sorted row, the index of the last valid row of its run
    (runs are contiguous, each flagged at its first row)."""
    run = torch.cumsum(run_starts.to(torch.int64), 0) - 1
    last = torch.full_like(iota, -1).scatter_reduce_(
        0, run, torch.where(mask_s, iota, -1), "amax")
    return last[run]


def _prefix(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums with a leading 0: ``p[e] - p[s]`` sums
    ``x[s:e]``."""
    return torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                      torch.cumsum(x, 0)])


def _with_validity(c: DeviceColumn, validity) -> DeviceColumn:
    return DeviceColumn(c.dtype, validity, data=c.data, chars=c.chars,
                        lengths=c.lengths)


def _var_from_m2(func: str, m2, n):
    """var/stddev from Σ(x−μ)² and n — Spark's nullOnDivideByZero: a
    sample of at most one row (and any empty frame) is null; a population
    of one row is 0."""
    den = n if func.endswith("pop") else n - 1.0
    ok = den > 0.0
    var = torch.clamp(m2, min=0.0) / torch.where(ok, den, 1.0)
    return (var if func.startswith("var") else torch.sqrt(var)), ok


class TpuWindowExec(TpuExec):
    def __init__(self, functions: List[WindowFunction],
                 partition_by: List[Expression],
                 order_by: List[Tuple[Expression, SortSpec]],
                 child: TpuExec, output_schema: T.StructType,
                 frame="running", ansi: bool = False):
        super().__init__([child])
        self.functions = functions
        self.partition_by = partition_by
        self.order_by = order_by
        self._output = output_schema
        self.frame = frame
        self.ansi = ansi

    @property
    def output(self):
        return self._output

    def describe(self):
        fns = ", ".join(f.func for f in self.functions)
        return f"TpuWindow [{fns}] frame={self.frame}"

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        batches = list(self.children[0].execute_columnar())
        if not batches:
            return
        batch = (batches[0] if len(batches) == 1
                 else ColumnarBatch.concat(batches))
        yield ColumnarBatch(self._window(batch), batch.num_rows,
                            self._output)

    def _window(self, batch: ColumnarBatch) -> List[DeviceColumn]:
        ctx = EvalContext(batch, ansi=self.ansi)
        n = batch.num_rows
        dev = batch.device
        mask = batch.row_mask
        out_cols = list(batch.columns)
        if n == 0:
            return out_cols + [empty_column(wf.result_type, dev)
                               for wf in self.functions]
        pcols = [e.eval_tpu(ctx) for e in self.partition_by]
        ocols = [e.eval_tpu(ctx) for e, _ in self.order_by]
        ospecs = [s for _, s in self.order_by]
        keys = pack_sort_keys(pcols, [SortSpec()] * len(pcols), mask)
        keys += pack_sort_keys(ocols, ospecs, mask)
        iota = torch.arange(n, dtype=torch.int64, device=dev)
        perm = lexsort(keys) if keys else iota
        inv_perm = torch.empty_like(perm).scatter_(0, perm, iota)
        mask_s = mask[perm]
        first_row = iota == 0
        starts = _change_flags(pcols, perm, first_row)
        ochange = _change_flags(ocols, perm, starts)
        geom = _Geometry(self.frame, iota, starts, ochange, mask_s,
                         iota - SEG.seg_first_rows(starts),
                         [c.gather(perm) for c in ocols[:1]], ospecs[:1])
        if len(ocols) > 1:
            # a RANGE frame bounds by the first order key alone (only a
            # CPU stage runs one over several keys, as the reference's
            # oracle does)
            geom.key1_change = _change_flags(ocols[:1], perm, starts)
        for wf in self.functions:
            res = self._one_function(wf, ctx, perm, geom)
            if isinstance(res, DeviceColumn):
                col = res.gather(inv_perm)
                out_cols.append(_with_validity(col, col.validity & mask))
                continue
            vals_s, valid_s = res
            valid = valid_s[inv_perm] & mask
            data = vals_s[inv_perm].to(column_torch_dtype(wf.result_type))
            out_cols.append(DeviceColumn(wf.result_type, valid, data=data))
        ctx.check_errors()
        return out_cols

    # -- function dispatch ---------------------------------------------------

    def _one_function(self, wf: WindowFunction, ctx, perm, g: "_Geometry"):
        """-> (values, validity) of one function in sorted row order, or a
        column in sorted row order."""
        ones = torch.ones_like(g.starts)
        pos = g.pos_in_part
        if wf.func == "row_number":
            return pos + 1, ones
        if wf.func == "rank":
            return g.rank(), ones
        if wf.func == "dense_rank":
            d, _ = SEG.seg_scan_sum(g.ochange.to(torch.int64), ones,
                                    g.starts)
            return d, ones
        if wf.func == "percent_rank":
            den = torch.clamp(g.part_sizes() - 1, min=1)
            return (g.rank() - 1).to(torch.float64) / den, ones
        if wf.func == "cume_dist":
            last_pos = pos[g.peer_last()]
            return ((last_pos + 1).to(torch.float64)
                    / torch.clamp(g.part_sizes(), min=1)), ones
        if wf.func == "ntile":
            nb = max(int(wf.buckets), 1)
            nrows = g.part_sizes()
            q = nrows // nb
            r = nrows % nb
            big = r * (q + 1)
            bucket = torch.where(
                pos < big, pos // torch.clamp(q + 1, min=1),
                r + (pos - big) // torch.clamp(q, min=1))
            return bucket + 1, ones
        c = wf.child.eval_tpu(ctx)
        cs = c.gather(perm)
        valid_s = cs.validity & g.mask_s
        if wf.func in ("lead", "lag"):
            return self._lead_lag(wf, ctx, cs, g)
        if wf.func in ("first_value", "last_value"):
            return self._first_last(wf, cs, valid_s, g)
        wide = cs.is_string or cs.is_dec128
        if cs.is_string and wf.func in ("min", "max") \
                and not isinstance(self.frame, tuple):
            arg, seen = SEG.seg_scan_arg_words(
                _column_key_words(cs), valid_s, g.starts, wf.func == "min")
            at = g.running_at()
            res = cs.gather(arg[at])
            return _with_validity(res, seen[at])
        if wide and wf.func in ("min", "max"):
            return self._ranked_minmax(wf, cs, valid_s, g)
        if wf.func == "count":
            return self._count(valid_s, g), ones
        rt = wf.result_type
        if isinstance(rt, T.DecimalType) and rt.is_128:
            return self._sum128(rt, cs, valid_s, g)
        is_f = isinstance(rt, (T.FloatType, T.DoubleType))
        if is_f and isinstance(cs.dtype, T.DecimalType):
            # avg and the variance family of a decimal, which only a CPU
            # stage runs: the scaled value, as Spark reads it
            from spark_rapids_tpu_torch.exec.aggregate import _as_double

            x = _as_double(cs)
        else:
            x = cs.data.to(torch.float64 if is_f else torch.int64)
        return self._numeric(wf, x, valid_s, is_f, g)

    def _numeric(self, wf, x, valid_s, is_f: bool, g: "_Geometry"):
        """sum, avg, min, max and the variance family over numbers ``x``
        (sorted order) in the window's frame."""
        if isinstance(self.frame, tuple):
            return self._bounded(wf, x, valid_s, is_f, g)
        res, ok = self._running_agg(wf.func, x, valid_s, g.starts, is_f)
        at = g.running_at()
        return res[at], ok[at]

    def _ranked_minmax(self, wf, cs: DeviceColumn, valid_s,
                       g: "_Geometry") -> DeviceColumn:
        """min/max of strings over a bounded frame, or of decimals above
        18 digits over any frame, which only a CPU stage runs: each value
        replaced by its dense rank among the column's key words (equal
        words, equal values), the integer min/max taken over the ranks,
        and the value of the winning rank read back."""
        n = g.iota.shape[0]
        rank, holder = word_ranks(_column_key_words(cs))
        m, ok = self._numeric(wf, rank, valid_s, False, g)
        res = cs.gather(holder[m.clamp(0, n - 1)])
        return _with_validity(res, ok)

    def _lead_lag(self, wf, ctx, cs: DeviceColumn, g: "_Geometry"):
        """The row ``offset`` after (``lead``) or before (``lag``) in the
        partition; outside it the literal default, or null."""
        n = g.iota.shape[0]
        idx = g.iota + int(wf.offset) * (1 if wf.func == "lead" else -1)
        safe = idx.clamp(0, n - 1)
        inside = ((idx >= 0) & (idx < n) & (g.seg_id()[safe] == g.seg_id())
                  & g.mask_s & g.mask_s[safe])
        shifted = cs.gather(safe)
        out = _with_validity(shifted, inside & shifted.validity)
        if wf.default is None:
            return out
        from spark_rapids_tpu_torch.expr.conditional import select_column

        dflt = Literal(wf.default, wf.result_type).eval_tpu(ctx)
        return select_column(inside, torch.ones_like(inside), out, dflt,
                             wf.result_type)

    def _first_last(self, wf, cs: DeviceColumn, valid_s, g: "_Geometry"):
        """The frame's first (last) row; with IGNORE NULLS its first (last)
        valid row, null when the frame has none."""
        n = g.iota.shape[0]
        fs, fe = g.frame_bounds()
        nonempty = fe > fs
        if wf.ignore_nulls:
            if wf.func == "first_value":
                at = SEG.next_valid_index(valid_s)[fs.clamp(0, n - 1)]
                ok = nonempty & (at < fe)
            else:
                at = SEG.prev_valid_index(valid_s)[(fe - 1).clamp(0, n - 1)]
                ok = nonempty & (at >= fs)
            res = cs.gather(at.clamp(0, n - 1))
            return _with_validity(res, ok)
        at = fs if wf.func == "first_value" else fe - 1
        res = cs.gather(at.clamp(0, n - 1))
        return _with_validity(res, nonempty & res.validity
                              & g.mask_s[at.clamp(0, n - 1)])

    def _count(self, valid_s, g: "_Geometry"):
        p = _prefix(valid_s.to(torch.int64))
        fs, fe = g.frame_bounds()
        return p[fe] - p[fs]

    def _sum128(self, rt: T.DecimalType, cs: DeviceColumn, valid_s,
                g: "_Geometry") -> DeviceColumn:
        """A decimal sum above 18 digits over any frame: the 32-bit limbs'
        prefix sums differenced over [fs, fe) (each exact in int64 for
        fewer than 2^31 rows), recombined into 128 bits."""
        from spark_rapids_tpu_torch.expr import decimal128 as D

        fs, fe = g.frame_bounds()
        sums = []
        for limb in D._limbs32(*D.column_limbs(cs)):
            p = _prefix(torch.where(valid_s, limb, 0))
            sums.append(p[fe] - p[fs])
        ok, hi, lo = D._recombine(sums)
        has = self._count(valid_s, g) > 0
        return DeviceColumn(rt, has & ok & D.in_bounds(hi, lo, rt.precision),
                            data=D.pack(hi, lo))

    # -- running, range_running and unbounded frames -------------------------

    def _running_agg(self, func: str, x, valid_s, starts, is_f: bool):
        if func == "sum":
            s, cnt = SEG.seg_scan_sum(x, valid_s, starts)
            return s, cnt > 0
        if func == "avg":
            s, cnt = SEG.seg_scan_sum(x, valid_s, starts)
            return s.to(torch.float64) / torch.clamp(cnt, min=1), cnt > 0
        if func == "min":
            return SEG.seg_scan_min(x, valid_s, starts, is_f)
        if func == "max":
            return SEG.seg_scan_max(x, valid_s, starts, is_f)
        n, _, m2 = SEG.seg_scan_moments(x.to(torch.float64), valid_s,
                                        starts)
        return _var_from_m2(func, m2, n)

    # -- bounded frames ------------------------------------------------------

    def _bounded(self, wf, x, valid_s, is_f: bool, g: "_Geometry"):
        fs, fe = g.frame_bounds()
        cnt = self._count(valid_s, g)
        has = cnt > 0
        func = wf.func
        if func == "sum" and not is_f:
            # integers: prefix differences, exact under int64 wrap
            p = _prefix(torch.where(valid_s, x, 0))
            return p[fe] - p[fs], has
        if self.frame[0] == "rows":
            return self._rows_frame(func, x, valid_s, is_f, fs, fe, cnt, g)
        return self._range_frame(wf, x, valid_s, is_f, fs, fe, cnt, g)

    def _rows_frame(self, func, x, valid_s, is_f, fs, fe, cnt, g):
        """ROWS BETWEEN a PRECEDING AND b FOLLOWING: ``a + b + 1`` shifted
        combines, each row's in-frame neighbours only."""
        _, a, b = self.frame
        n = x.shape[0]
        iota = g.iota
        has = cnt > 0

        def shifted():
            for d in range(-int(a), int(b) + 1):
                idx = iota + d
                safe = idx.clamp(0, n - 1)
                yield (idx >= fs) & (idx < fe) & valid_s[safe], x[safe]

        if func in ("sum", "avg") or func in _VAR_FUNCS:
            total = torch.zeros_like(x)
            for ok, v in shifted():
                total = total + torch.where(ok, v, 0.0)
            if func == "sum":
                return total, has
            mean = total / torch.clamp(cnt, min=1)
            if func == "avg":
                return mean, has
            # the variance family's second pass: deviations from the
            # frame's mean, as the reference and its oracle
            m2 = torch.zeros_like(x)
            for ok, v in shifted():
                dev = v - mean
                m2 = m2 + torch.where(ok, dev * dev, 0.0)
            return _var_from_m2(func, m2, cnt.to(torch.float64))
        want_min = func == "min"
        if is_f:
            m = torch.full_like(x, float("inf") if want_min
                                else float("-inf"))
            nonnan = torch.zeros_like(cnt)
            nan = torch.zeros_like(has)
            for ok, v in shifted():
                isnan = torch.isnan(v)
                use = ok & ~isnan
                m = torch.where(use, torch.minimum(m, v) if want_min
                                else torch.maximum(m, v), m)
                nonnan = nonnan + use.to(torch.int64)
                nan = nan | (ok & isnan)
            return self._float_minmax(m, want_min, has, nonnan == 0, nan)
        info = torch.iinfo(x.dtype)
        m = torch.full_like(x, info.max if want_min else info.min)
        for ok, v in shifted():
            m = torch.where(ok, torch.minimum(m, v) if want_min
                            else torch.maximum(m, v), m)
        return m, has

    @staticmethod
    def _float_minmax(m, want_min, has, no_number, any_nan):
        """NaN is the greatest float: a min is NaN only over NaNs alone, a
        max is NaN over any NaN."""
        nan = torch.full_like(m, float("nan"))
        if want_min:
            return torch.where(has & no_number, nan, m), has
        return torch.where(any_nan, nan, m), has

    def _range_frame(self, wf, x, valid_s, is_f, fs, fe, cnt, g):
        """RANGE frame aggregates over each row's contiguous [fs, fe):
        block-decomposed merges for float sums and the variance family
        (no global prefix sums: one inf or NaN row would poison every later
        frame), a sparse table for min/max."""
        func = wf.func
        has = cnt > 0
        key = wf.child.sql_string()
        zero = torch.zeros_like(x)
        if func in ("sum", "avg"):
            (total,) = g.block_merge(
                ("sum", key), (torch.where(valid_s, x, zero),),
                lambda a, b: (a[0] + b[0],), (0.0,), fs, fe)
            if func == "sum":
                return total, has
            return total / torch.clamp(cnt, min=1), has
        if func in _VAR_FUNCS:
            base = (valid_s.to(torch.float64), torch.where(valid_s, x, zero),
                    torch.zeros_like(x))
            n, _, m2 = g.block_merge(
                ("moments", key), base, lambda a, b: SEG.chan_merge(*a, *b),
                (0.0, 0.0, 0.0), fs, fe)
            return _var_from_m2(func, m2, n)
        want_min = func == "min"
        op = torch.minimum if want_min else torch.maximum
        if is_f:
            isnan = torch.isnan(x)
            usable = valid_s & ~isnan
            ident = float("inf") if want_min else float("-inf")
            base = torch.where(usable, x, torch.full_like(x, ident))
            m = g.sparse_query((func, key), base, op, ident, fs, fe)
            p_num = _prefix(usable.to(torch.int64))
            p_nan = _prefix((valid_s & isnan).to(torch.int64))
            return self._float_minmax(m, want_min, has,
                                      p_num[fe] - p_num[fs] == 0,
                                      p_nan[fe] - p_nan[fs] > 0)
        info = torch.iinfo(x.dtype)
        ident = info.max if want_min else info.min
        base = torch.where(valid_s, x, torch.full_like(x, ident))
        return g.sparse_query((func, key), base, op, ident, fs, fe), has


class _Geometry:
    """Sorted-order frame geometry shared by a window's functions; each
    piece is computed on first use."""

    def __init__(self, frame, iota, starts, ochange, mask_s, pos_in_part,
                 ocol_sorted, ospecs):
        self.frame = frame
        self.iota = iota
        self.starts = starts
        self.ochange = ochange
        self.mask_s = mask_s
        self.pos_in_part = pos_in_part
        self.ocol_sorted = ocol_sorted
        self.ospecs = ospecs
        self.key1_change = ochange
        self._memo = {}

    def _once(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def seg_id(self):
        return self._once("seg_id", lambda: torch.cumsum(
            self.starts.to(torch.int64), 0) - 1)

    def seg_first(self):
        return self._once("seg_first",
                          lambda: self.iota - self.pos_in_part)

    def seg_last(self):
        return self._once("seg_last", lambda: _run_last(
            self.starts, self.mask_s, self.iota).clamp(min=0))

    def peer_first(self):
        return self._once("peer_first",
                          lambda: SEG.seg_first_rows(self.ochange))

    def peer_last(self):
        return self._once("peer_last", lambda: _run_last(
            self.ochange, self.mask_s, self.iota).clamp(min=0))

    def part_sizes(self):
        """Rows of each row's partition."""
        return self._once("sizes",
                          lambda: self.pos_in_part[self.seg_last()] + 1)

    def rank(self):
        """1 + the position of the row's first peer (partition starts are
        peer starts)."""
        return self._once("rank", lambda: self.pos_in_part[
            self.peer_first()] + 1)

    def running_at(self):
        """The row whose running value is each row's frame value:
        itself (``running``), its last peer (``range_running``), its
        partition's last row (``unbounded``)."""
        if self.frame == "range_running":
            return self.peer_last()
        if self.frame == "unbounded":
            return self.seg_last()
        return self.iota

    def frame_bounds(self):
        """Each sorted row's frame as ``[fs, fe)`` sorted indices."""
        return self._once("frame", self._frame_bounds)

    def _frame_bounds(self):
        fr = self.frame
        if fr == "running":
            return self.seg_first(), self.iota + 1
        if fr == "range_running":
            return self.seg_first(), self.peer_last() + 1
        if fr == "unbounded":
            return self.seg_first(), self.seg_last() + 1
        kind, a, b = fr
        if kind == "rows":
            fs = torch.maximum(self.seg_first(), self.iota - int(a))
            fe = torch.minimum(self.seg_last() + 1, self.iota + int(b) + 1)
            return fs, torch.maximum(fe, fs)
        return self._range_bounds(a, b)

    def _range_bounds(self, a, b):
        """RANGE BETWEEN a PRECEDING AND b FOLLOWING over the one order
        key: the frame of a non-null, non-NaN key is the rows of its
        partition whose key lies in [v - a, v + b] (PRECEDING points at the
        partition's start, so a descending key frames [v - b, v + a]);
        found by two binary searches over the partition's non-null rows,
        whose key words are monotone there.  A null key frames the null
        peers, a NaN key the NaN peers (the reference's oracle,
        ``cpu/oracle.py::_frame_rows``)."""
        oc = self.ocol_sorted[0]
        asc = self.ospecs[0].ascending
        n = self.iota.shape[0]
        valid = oc.validity
        is_f = isinstance(oc.dtype, (T.FloatType, T.DoubleType))
        if is_f:
            v = oc.data.to(torch.float64)
            key = float_order_key
            lo_v, hi_v = (v - float(a), v + float(b)) if asc \
                else (v - float(b), v + float(a))
        else:
            v = oc.data.to(torch.int64)
            a, b = int(a), int(b)

            def key(t):
                return t

            # saturating: a bound past the int64 range frames the same
            # rows as the exact bound
            def sub(k):
                return torch.where(v < _I64_MIN + k,
                                   torch.full_like(v, _I64_MIN), v - k)

            def add(k):
                return torch.where(v > _I64_MAX - k,
                                   torch.full_like(v, _I64_MAX), v + k)

            lo_v, hi_v = (sub(a), add(b)) if asc else (sub(b), add(a))
        ks = key(v) if asc else ~key(v)
        q_lo, q_hi = (key(lo_v), key(hi_v)) if asc \
            else (~key(hi_v), ~key(lo_v))
        # each row's partition's non-null rows [blo, bhi)
        seg_first, seg_end = self.seg_first(), self.seg_last() + 1
        p_null = _prefix((~valid).to(torch.int64))
        nulls = p_null[seg_end] - p_null[seg_first]
        if self.ospecs[0].nulls_first:
            blo, bhi = seg_first + nulls, seg_end
        else:
            blo, bhi = seg_first, seg_end - nulls
        (widest,) = sync_get(torch.clamp(bhi - blo, min=0).max())
        steps = int(widest).bit_length() + 1
        fs = _search(ks, q_lo, blo, bhi, False, steps, n)
        fe = _search(ks, q_hi, blo, bhi, True, steps, n)
        peers = ~valid
        if is_f:
            peers = peers | torch.isnan(v)
        fs = torch.where(peers, SEG.seg_first_rows(self.key1_change), fs)
        fe = torch.where(peers, _run_last(self.key1_change, self.mask_s,
                                          self.iota).clamp(min=0) + 1, fe)
        return fs, torch.maximum(fe, fs)

    def levels(self) -> int:
        """The doubling tables' top level: the bit length of the widest
        frame less one (one host sync a window)."""
        def top():
            fs, fe = self.frame_bounds()
            (w,) = sync_get(torch.where(self.mask_s, fe - fs, 0).max())
            return max(int(w).bit_length() - 1, 0)
        return self._once("levels", top)

    def tables(self, key, base, merge):
        """Doubling tables of ``base`` (a tuple of tensors): level k at i
        is the merge over [i, i + 2^k), past the end the merge of what
        remains; built once per ``key`` (an input and its merge)."""
        def build():
            top = self.levels()
            n = base[0].shape[0]
            tabs = [torch.empty((top + 1, n), dtype=t.dtype, device=t.device)
                    for t in base]
            for t, b0 in zip(tabs, base):
                t[0] = b0
            for k in range(1, top + 1):
                s = 1 << (k - 1)
                if s >= n:
                    for t in tabs:
                        t[k] = t[k - 1]
                    continue
                merged = merge(tuple(t[k - 1, :n - s] for t in tabs),
                               tuple(t[k - 1, s:] for t in tabs))
                for t, m in zip(tabs, merged):
                    t[k, :n - s] = m
                    t[k, n - s:] = t[k - 1, n - s:]
            return tabs
        return self._once(("tables", key), build)

    def block_merge(self, key, base, merge, ident, fs, fe):
        """The merge of ``base`` over each row's [fs, fe): the bits of the
        frame's width taken high to low, one table block each (at most
        ``levels() + 1`` merges a row)."""
        tabs = self.tables(key, base, merge)
        n = fs.shape[0]
        acc = tuple(torch.full_like(t[0], iv) for t, iv in zip(tabs, ident))
        pos = fs
        rem = fe - fs
        for k in range(self.levels(), -1, -1):
            size = 1 << k
            take = rem >= size
            at = pos.clamp(0, n - 1)
            merged = merge(acc, tuple(t[k][at] for t in tabs))
            acc = tuple(torch.where(take, m, a) for m, a in zip(merged, acc))
            pos = pos + torch.where(take, size, 0)
            rem = rem - torch.where(take, size, 0)
        return acc

    def sparse_query(self, key, base, op, ident, fs, fe):
        """An idempotent ``op`` (min or max) over each row's [fs, fe): two
        overlapping blocks of the largest power of two inside the frame;
        ``ident`` for an empty frame."""
        (tab,) = self.tables(key, (base,), lambda a, b: (op(a[0], b[0]),))
        n = fs.shape[0]
        w = fe - fs
        k = torch.zeros_like(w)
        for j in range(1, self.levels() + 1):
            k = k + (w >= (1 << j)).to(torch.int64)
        span = torch.ones_like(w) << k
        flat = tab.reshape(-1)
        i1 = k * n + fs.clamp(0, n - 1)
        i2 = k * n + (fe - span).clamp(0, n - 1)
        m = op(flat[i1], flat[i2])
        return torch.where(w > 0, m, torch.full_like(m, ident))


def _search(ks, q, lo, hi, upper: bool, steps: int, n: int):
    """Vectorized binary search of each row's ``q`` in ``ks[lo:hi]``
    (non-decreasing there): the first index whose key is >= ``q`` (``>``
    with ``upper``), ``hi`` when none is."""
    lo, hi = lo.clone(), hi.clone()
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        kv = ks[mid.clamp(0, n - 1)]
        right = (kv <= q) if upper else (kv < q)
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo

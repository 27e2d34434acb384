"""TpuWindowExec — window functions via segmented scans (port of the
ranking functions and the running and unbounded numeric frames of
``spark_rapids_tpu/exec/window.py``).

As in the reference's in-core window, the input batches are concatenated,
the rows sorted by (partition keys, order keys) with ``ops/sortkeys``'
``lexsort``, and every function computed in sorted order from three flags
and indices: where a partition starts, where the order key changes (a new
peer group), and each row's position in its partition.  The results are
scattered back to the input's row order.

* ``row_number``, ``rank``, ``dense_rank``, ``percent_rank``,
  ``cume_dist`` and ``ntile``: positions, each peer group's first row and
  partition sizes;
* ``sum``, ``count``, ``min`` and ``max`` over the ``running`` frame (ROWS
  UNBOUNDED PRECEDING .. CURRENT ROW): the segmented scans of
  ``ops/segment.py``; over ``unbounded``: the running value at the
  partition's last row.

The first row of a partition or of a peer group is found with a cumsum
and one scatter (``ops/segment.py::seg_first_rows``), where the reference
takes a ``cummax``; its last row with a cumsum and one
``scatter_reduce``, where the reference takes a reversed ``cummin``.
``lead``/``lag``, ``first_value``/``last_value``, ``avg`` and the
variance family, string min/max and the ``range_running`` and bounded
frames are not ported; the plan rewrite (``overrides._window_check``)
raises ``NotOnGpu`` for them.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.ops import segment as SEG
from spark_rapids_tpu_torch.ops.sortkeys import (SortSpec, _column_key_words,
                                                 lexsort, pack_sort_keys)
from spark_rapids_tpu_torch.plan.nodes import WindowFunction


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
            for wf in self.functions:
                out_cols.append(DeviceColumn(
                    wf.result_type, torch.zeros(0, dtype=torch.bool,
                                                device=dev),
                    data=torch.zeros(0, dtype=column_torch_dtype(
                        wf.result_type), device=dev)))
            return out_cols
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
        geom = _Geometry(iota, starts, ochange, mask_s,
                         iota - SEG.seg_first_rows(starts))
        for wf in self.functions:
            vals_s, valid_s = self._one_function(wf, ctx, perm, geom)
            valid = valid_s[inv_perm] & mask
            data = vals_s[inv_perm].to(column_torch_dtype(wf.result_type))
            out_cols.append(DeviceColumn(wf.result_type, valid, data=data))
        ctx.check_errors()
        return out_cols

    # -- function dispatch ---------------------------------------------------

    def _one_function(self, wf: WindowFunction, ctx, perm, g: "_Geometry"):
        """-> (values, validity) of one function, in sorted row order."""
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
        return self._numeric_agg(wf, wf.child.eval_tpu(ctx), ctx, perm, g)

    def _numeric_agg(self, wf, c: DeviceColumn, ctx, perm, g: "_Geometry"):
        is_f = isinstance(wf.result_type, (T.FloatType, T.DoubleType))
        vals_s = c.data[perm]
        valid_s = (c.validity & ctx.batch.row_mask)[perm]
        acc = vals_s.to(torch.float64 if is_f else torch.int64)
        starts = g.starts
        if wf.func == "count":
            _, cnt = SEG.seg_scan_sum(acc, valid_s, starts)
            res, ok = cnt, torch.ones_like(starts)
        elif wf.func == "sum":
            res, cnt = SEG.seg_scan_sum(acc, valid_s, starts)
            ok = cnt > 0
        elif wf.func == "min":
            res, ok = SEG.seg_scan_min(acc, valid_s, starts, is_f)
        else:
            res, ok = SEG.seg_scan_max(acc, valid_s, starts, is_f)
        if self.frame == "unbounded":
            sl = g.seg_last()
            res, ok = res[sl], ok[sl]
        return res, ok


class _Geometry:
    """Sorted-order frame geometry shared by a window's functions; the
    run ends are computed on first use."""

    def __init__(self, iota, starts, ochange, mask_s, pos_in_part):
        self.iota = iota
        self.starts = starts
        self.ochange = ochange
        self.mask_s = mask_s
        self.pos_in_part = pos_in_part
        self._memo = {}

    def _once(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def seg_last(self):
        return self._once("seg_last", lambda: _run_last(
            self.starts, self.mask_s, self.iota).clamp(min=0))

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
            SEG.seg_first_rows(self.ochange)] + 1)

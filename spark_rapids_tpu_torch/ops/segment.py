"""Segmented reductions and scans — port of the reductions of
``spark_rapids_tpu/ops/segment.py`` (the group-by primitive) and of its
segmented scans (``seg_scan_*``, the window's running frames).

Rows carry a segment id in ``[0, num_segments)``; each function reduces
every segment with Spark's null rules: aggregates skip nulls, a segment
with no valid input is null (the second result, ``has``), and float
min/max order NaN above every number.  Sums and counts are
``index_add_``, min and max ``scatter_reduce_``, and plain reductions for
a single segment: exact for integers, while CUDA adds floats in an order
of its own.  The bitwise folds (``seg_fold``) have no scatter in torch:
they run the segmented scan below over the sorted rows and keep each
segment's last row, as the reference's ``seg_fold`` does.

The reference's ``SegBounds``/``bounds_scope`` (a cumsum-and-gather form
that avoids full-width scatters, which are slow on the TPU) are not ported:
a scatter-add is a cheap primitive on the GPU.

The scans run over rows sorted so that each segment is a contiguous run,
its first row flagged in ``starts``.  An integer running sum is a global
``cumsum`` minus the segment's base, as in the reference (int64 wrap
cancels exactly).  torch has ``cummax``/``cummin`` but no segmented form,
and an offset that folds the segment into the value is not safe for every
int64; so min, max and float sums use a log-step doubling scan
(``_seg_scan``: ⌈log2 n⌉ passes of one shifted combine each), which adds
floats in a tree order of its own, as the reference's
``lax.associative_scan`` does in another: float running sums may differ
from it in the last bits.  The window's other scans, which the reference
keeps inside its window exec, live here too: Chan's (n, mean, m2) merge
as a segmented scan (``seg_scan_moments``), the previous and next valid
row (``prev_valid_index``, ``next_valid_index``: a ``cummax`` and its
flipped twin) and the lexicographic arg-min/arg-max of string key words
(``seg_scan_arg_words``).
"""
from __future__ import annotations

from typing import Tuple

import torch

Pair = Tuple[torch.Tensor, torch.Tensor]


def _scatter(op: str, values, seg_ids, num_segments: int, fill):
    out = torch.full((num_segments,), fill, dtype=values.dtype,
                     device=values.device)
    if num_segments == 1:
        # one segment: a plain reduction, not a scatter into one address
        if values.shape[0] == 0:
            return out
        if op == "amin":
            return torch.minimum(out, values.amin(0, keepdim=True))
        return torch.maximum(out, values.amax(0, keepdim=True))
    return out.scatter_reduce_(0, seg_ids, values, op, include_self=True)


def _seg_isum(values, seg_ids, num_segments: int) -> torch.Tensor:
    if num_segments == 1:
        return values.sum(0, keepdim=True, dtype=values.dtype)
    out = torch.zeros(num_segments, dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_ids, values)


def seg_sum(values, validity, seg_ids, num_segments: int) -> Pair:
    """-> (per-segment sum of the valid values, has a valid value)."""
    contrib = torch.where(validity, values, torch.zeros_like(values))
    return (_seg_isum(contrib, seg_ids, num_segments),
            seg_count(validity, seg_ids, num_segments) > 0)


def seg_count(validity, seg_ids, num_segments: int) -> torch.Tensor:
    return _seg_isum(validity.to(torch.int64), seg_ids, num_segments)


def _seg_min_raw(v, seg_ids, num_segments: int) -> torch.Tensor:
    fill = (float("inf") if v.is_floating_point()
            else torch.iinfo(v.dtype).max)
    return _scatter("amin", v, seg_ids, num_segments, fill)


def _seg_max_raw(v, seg_ids, num_segments: int) -> torch.Tensor:
    fill = (float("-inf") if v.is_floating_point()
            else torch.iinfo(v.dtype).min)
    return _scatter("amax", v, seg_ids, num_segments, fill)


def _seg_minmax(values, validity, seg_ids, num_segments: int,
                is_float: bool, is_min: bool) -> Pair:
    raw = _seg_min_raw if is_min else _seg_max_raw
    any_valid = seg_count(validity, seg_ids, num_segments) > 0
    if is_float:
        nan = torch.isnan(values)
        ok = validity & ~nan
        edge = float("inf") if is_min else float("-inf")
        m = raw(torch.where(ok, values, torch.full_like(values, edge)),
                seg_ids, num_segments)
        nan_out = torch.full_like(m, float("nan"))
        if is_min:
            # NaN is greatest: the min is NaN only when nothing else exists
            has_num = seg_count(ok, seg_ids, num_segments) > 0
            return torch.where(has_num, m, nan_out), any_valid
        has_nan = seg_count(validity & nan, seg_ids, num_segments) > 0
        return torch.where(has_nan, nan_out, m), any_valid
    if values.dtype == torch.bool:
        v = torch.where(validity, values, is_min).to(torch.int32)
        return raw(v, seg_ids, num_segments).to(torch.bool), any_valid
    info = torch.iinfo(values.dtype)
    edge = info.max if is_min else info.min
    v = torch.where(validity, values, torch.full_like(values, edge))
    return raw(v, seg_ids, num_segments), any_valid


def seg_min(values, validity, seg_ids, num_segments: int,
            is_float: bool) -> Pair:
    return _seg_minmax(values, validity, seg_ids, num_segments, is_float,
                       True)


def seg_max(values, validity, seg_ids, num_segments: int,
            is_float: bool) -> Pair:
    return _seg_minmax(values, validity, seg_ids, num_segments, is_float,
                       False)


def seg_first_index(seg_ids, row_mask, num_segments: int) -> torch.Tensor:
    """Index of the first row of each segment inside ``row_mask``; the row
    count for a segment with no such row."""
    n = seg_ids.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=seg_ids.device)
    return _scatter("amin", torch.where(row_mask, iota, n), seg_ids,
                    num_segments, n)


def seg_last_index(seg_ids, row_mask, num_segments: int) -> torch.Tensor:
    """Index of the last row of each segment inside ``row_mask``; -1 for a
    segment with no such row (the reference's ``_seg_last_index``)."""
    n = seg_ids.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=seg_ids.device)
    return _scatter("amax", torch.where(row_mask, iota, -1), seg_ids,
                    num_segments, -1)


def seg_fold(values, validity, seg_ids, num_segments: int, op,
             identity: int) -> Pair:
    """Segmented fold with a combine that torch has no scatter for (the
    bitwise aggregates): the log-step segmented scan, then each segment's
    last row.  ``seg_ids`` must be non-decreasing (the group-by's sorted
    rows).  -> (per-segment fold of the valid values, has a valid
    value)."""
    n = values.shape[0]
    # one slot past the segments takes the rows that end none
    out = torch.full((num_segments + 1,), identity, dtype=values.dtype,
                     device=values.device)
    has = seg_count(validity, seg_ids, num_segments) > 0
    if n == 0:
        return out[:num_segments], has
    v = torch.where(validity, values, torch.full_like(values, identity))
    starts = torch.ones(n, dtype=torch.bool, device=values.device)
    starts[1:] = seg_ids[1:] != seg_ids[:-1]
    run = _seg_scan(v, starts, op)
    ends = torch.ones(n, dtype=torch.bool, device=values.device)
    ends[:-1] = starts[1:]
    out.scatter_(0, torch.where(ends, seg_ids, num_segments), run)
    return out[:num_segments], has


# -- segmented scans (window running frames) --------------------------------

def _seg_scan(values, starts, combine):
    """Inclusive segmented scan that restarts at the rows where ``starts``
    holds: log-step doubling, each pass combining every row with the row
    ``d`` before it unless a start lies between them."""
    return _seg_scan_many((values,), starts,
                          lambda a, b: (combine(a[0], b[0]),))[0]


def _seg_scan_many(values, starts, combine):
    """``_seg_scan`` over a tuple of tensors: ``combine(earlier, later)``
    takes and returns tuples (an associative merge of partial results)."""
    v, f = tuple(values), starts
    n = f.shape[0]
    d = 1
    while d < n:
        merged = combine(tuple(x[:-d] for x in v), tuple(x[d:] for x in v))
        nv = []
        for x, m in zip(v, merged):
            y = x.clone()
            y[d:] = torch.where(f[d:], x[d:], m)
            nv.append(y)
        nf = f.clone()
        nf[d:] = f[d:] | f[:-d]
        v, f = tuple(nv), nf
        d *= 2
    return v


def seg_first_rows(starts) -> torch.Tensor:
    """Index of the first row of each row's segment (row 0 always starts
    one): a cumsum and one scatter, which the card runs faster than
    ``torch.cummax`` over the start indices."""
    n = starts.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=starts.device)
    starts = starts | (iota == 0)
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    first = torch.zeros(n + 1, dtype=torch.int64, device=starts.device)
    first.scatter_(0, torch.where(starts, seg, n), iota)
    return first[seg]


def _seg_csum(x, first) -> torch.Tensor:
    cs = torch.cumsum(x, 0)
    return cs - (cs[first] - x[first])


def seg_scan_sum(values, validity, starts) -> Pair:
    """-> (running sum of the valid values, running count of them) within
    each segment.  Integers: a cumsum minus the segment base; floats: the
    exact segmented scan (a cumsum difference would cancel against large
    values in earlier segments)."""
    if values.shape[0] == 0:
        return values, torch.zeros(0, dtype=torch.int64,
                                   device=values.device)
    first = seg_first_rows(starts)
    contrib = torch.where(validity, values, torch.zeros_like(values))
    if contrib.is_floating_point():
        total = _seg_scan(contrib, starts, torch.add)
    else:
        total = _seg_csum(contrib, first)
    return total, _seg_csum(validity.to(torch.int64), first)


def _seg_seen(flags, starts) -> torch.Tensor:
    if flags.shape[0] == 0:
        return flags
    return _seg_csum(flags.to(torch.int64), seg_first_rows(starts)) > 0


def seg_scan_min(values, validity, starts, is_float: bool) -> Pair:
    """-> (running min of the valid values, a valid value seen); NaN is
    the greatest float, so the min is NaN only while nothing else was
    seen."""
    if is_float:
        nan = torch.isnan(values)
        v = torch.where(validity & ~nan, values,
                        torch.full_like(values, float("inf")))
        m = _seg_scan(v, starts, torch.minimum)
        m = torch.where(_seg_seen(validity & ~nan, starts), m,
                        torch.full_like(m, float("nan")))
        return m, _seg_seen(validity, starts)
    ident = torch.iinfo(values.dtype).max
    v = torch.where(validity, values, torch.full_like(values, ident))
    return (_seg_scan(v, starts, torch.minimum),
            _seg_seen(validity, starts))


def seg_scan_max(values, validity, starts, is_float: bool) -> Pair:
    """-> (running max of the valid values, a valid value seen); NaN is
    the greatest float."""
    if is_float:
        nan = torch.isnan(values)
        v = torch.where(validity & ~nan, values,
                        torch.full_like(values, float("-inf")))
        m = _seg_scan(v, starts, torch.maximum)
        m = torch.where(_seg_seen(validity & nan, starts),
                        torch.full_like(m, float("nan")), m)
        return m, _seg_seen(validity, starts)
    ident = torch.iinfo(values.dtype).min
    v = torch.where(validity, values, torch.full_like(values, ident))
    return (_seg_scan(v, starts, torch.maximum),
            _seg_seen(validity, starts))


def chan_merge(na, ma, m2a, nb, mb, m2b):
    """Chan's pairwise merge of two (n, mean, m2) partial moments, the
    earlier first (the reference's ``exec/window.py::_chan_merge``)."""
    n = na + nb
    nsafe = torch.clamp(n, min=1.0)
    d = mb - ma
    return n, ma + d * nb / nsafe, m2a + m2b + d * d * na * nb / nsafe


def seg_scan_moments(x, validity, starts):
    """-> the running (n, mean, m2) of the valid doubles within each
    segment: the doubling scan of Chan's merge, which is associative, so
    the scan is exact up to rounding where a running sum of squares would
    cancel (the reference's ``lax.associative_scan`` of the same merge)."""
    valid = validity.to(torch.float64)
    base = (valid, torch.where(validity, x, torch.zeros_like(x)),
            torch.zeros_like(valid))
    return _seg_scan_many(base, starts, lambda a, b: chan_merge(*a, *b))


def prev_valid_index(validity) -> torch.Tensor:
    """Each row's index of the last valid row at or before it; -1 where
    there is none.  Not segmented: a window frame lies inside its
    partition, and its caller takes the index only when it falls inside
    the frame (IGNORE NULLS' ``last_value``)."""
    n = validity.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=validity.device)
    if n == 0:
        return iota
    return torch.cummax(torch.where(validity, iota, -1), 0).values


def next_valid_index(validity) -> torch.Tensor:
    """Each row's index of the first valid row at or after it; ``n`` where
    there is none (``prev_valid_index``'s flipped twin, IGNORE NULLS'
    ``first_value``)."""
    n = validity.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=validity.device)
    if n == 0:
        return iota
    v = torch.where(validity, iota, n).flip(0)
    return torch.cummin(v, 0).values.flip(0)


def seg_scan_arg_words(words, validity, starts, is_min: bool) -> Pair:
    """Segmented lexicographic arg-min (arg-max) scan over key words (a
    string's ``_column_key_words``): -> (each row's index of a row holding
    its segment's running optimum of the valid rows, a valid row seen).
    One stable lexsort ranks the rows (equal words share a rank), and the
    running optimum of the ranks is the integer doubling scan; invalid
    rows never win."""
    from spark_rapids_tpu_torch.ops.sortkeys import word_ranks

    n = validity.shape[0]
    dev = validity.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev), validity
    rank, holder = word_ranks(words)
    if is_min:
        r = _seg_scan(torch.where(validity, rank, n), starts, torch.minimum)
    else:
        r = _seg_scan(torch.where(validity, rank, -1), starts,
                      torch.maximum)
    return holder[r.clamp(0, n - 1)], _seg_seen(validity, starts)

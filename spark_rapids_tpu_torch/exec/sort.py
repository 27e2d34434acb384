"""Sort and top-N — port of ``TpuSortExec`` (in core and out of core) and
``TpuTopNExec`` (``spark_rapids_tpu/exec/sort.py``).

A sort evaluates its key expressions, packs them into key words
(``ops/sortkeys.py``), orders the rows by ``lexsort`` (stable) and gathers
every column.  ``TpuSortExec`` tracks each input batch in the spill
framework.  An input
of one batch, or of no more than ``ooc_bytes``
(``spark.rapids.sql.batchSizeBytes``), is concatenated and sorted in one
pass.  A larger one takes the reference's out-of-core path: each batch is
sorted into a spillable run, and the runs are merged in windows of at
most ``ooc_chunk_rows`` rows a run.  A window's bound is the smallest
last key, word by word, of the runs that have rows past the window (an
exhausted or empty run imposes none); the window is sorted, the rows whose
key is at most the bound go out, and each run advances by the rows it gave.
Ties and nulls keep every row exactly once: the rows at most the bound are
a prefix of each run and of the sorted window.

Where the reference pads every window to ``ooc_chunk_rows`` rows a run and
masks, the port works on exact row counts.  The reference reads a window
by bringing the whole run back to the device and slicing it; the port
reads only the window's rows from wherever the run lives
(``SpillableColumnarBatch.get_rows``: a view of a run on the device, a
non-blocking upload of those rows from a run in pinned host memory), so
no window moves a whole run.  The consumed counts of a window come back in
one host sync, where the reference reads the emitted count and each run's
count apart.  The ``ooc_sort_*`` perfcounters count the runs, the windows
and the ``bytes_h2d`` the window reads moved (an upload of a whole run
would show there); the peak ``ooc_sort_merge_window_upload_bytes`` keeps
the most that one window moved.

``TpuTopNExec`` sorts each batch, keeps its first n rows and merges the
survivors, so it never holds more than about nine batches' worth of n
rows.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.ops.filterops import gather_columns
from spark_rapids_tpu_torch.ops.sortkeys import (SortSpec, lexsort,
                                                 pack_sort_keys)

_INT64_MAX = 0x7FFFFFFFFFFFFFFF


def sort_key_words(batch: ColumnarBatch, orders,
                   ansi: bool) -> List[torch.Tensor]:
    """The packed key words of ``batch`` under ``orders``."""
    ctx = EvalContext(batch, ansi=ansi)
    key_cols = [e.eval_tpu(ctx) for e, _ in orders]
    ctx.check_errors()
    return pack_sort_keys(key_cols, [s for _, s in orders], batch.row_mask)


def sort_batch(batch: ColumnarBatch, orders, ansi: bool) -> ColumnarBatch:
    """One batch in ``orders`` order (stable)."""
    perm = lexsort(sort_key_words(batch, orders, ansi))
    return ColumnarBatch(gather_columns(perm, batch.columns),
                         batch.num_rows, batch.schema)


def lex_min_row(words: List[torch.Tensor],
                rows: torch.Tensor) -> List[torch.Tensor]:
    """The lexicographically smallest key among ``rows``, word by word,
    as 0-dim tensors (no host sync)."""
    cand = [w[rows] for w in words]
    alive = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    for c in cand:
        low = torch.where(alive, c, _INT64_MAX).min()
        alive &= c == low
    pick = torch.argmax(alive.to(torch.int8))
    return [c[pick] for c in cand]


def le_bound(words: List[torch.Tensor],
             bound: List[torch.Tensor]) -> torch.Tensor:
    """Per row: key <= bound, lexicographically over the words."""
    lt = torch.zeros_like(words[0], dtype=torch.bool)
    eq = torch.ones_like(words[0], dtype=torch.bool)
    for w, b in zip(words, bound):
        lt |= eq & (w < b)
        eq &= w == b
    return lt | eq


class _Run:
    """A sorted run in the spill framework and how far the merge read."""

    def __init__(self, handle, n: int):
        self.handle = handle
        self.n = n
        self.off = 0


class TpuSortExec(TpuExec):
    def __init__(self, orders: List[Tuple[Expression, SortSpec]],
                 is_global: bool, child: TpuExec, ansi: bool = False,
                 ooc_bytes: int = 1 << 30, ooc_chunk_rows: int = 1024):
        super().__init__([child])
        self.orders = orders
        self.is_global = is_global
        self.ansi = ansi
        self.ooc_bytes = ooc_bytes
        self.ooc_chunk_rows = ooc_chunk_rows

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        o = ", ".join(f"{e.sql_string()} {'ASC' if s.ascending else 'DESC'}"
                      for e, s in self.orders)
        return f"TpuSort [{o}]"

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        from spark_rapids_tpu_torch.memory.retry import with_retry_no_split
        from spark_rapids_tpu_torch.memory.spill import get_spill_framework

        fw = get_spill_framework()
        spillables = []
        total_bytes = 0
        for b in self.children[0].execute_columnar():
            total_bytes += b.nbytes()
            spillables.append(fw.track(b))
            del b
        if not spillables:
            return
        if len(spillables) > 1 and total_bytes > self.ooc_bytes:
            yield from self._merge_runs(self._sorted_runs(spillables, fw))
            return

        def run():
            for s in spillables:
                s.pin()
            try:
                batches = [s.get_batch() for s in spillables]
                batch = (batches[0] if len(batches) == 1
                         else ColumnarBatch.concat(batches))
                del batches
                return sort_batch(batch, self.orders, self.ansi)
            finally:
                for s in spillables:
                    s.unpin()

        out = with_retry_no_split(run)
        for s in spillables:
            s.close()
        yield out

    def _sorted_runs(self, spillables, fw) -> List[_Run]:
        """Each input batch sorted (under ``with_retry_no_split``) into a
        run tracked by the spill framework; the input handle is closed."""
        from spark_rapids_tpu_torch.memory.retry import with_retry_no_split

        runs = []
        for s in spillables:
            def one(s=s):
                s.pin()
                try:
                    return sort_batch(s.get_batch(), self.orders, self.ansi)
                finally:
                    s.unpin()

            sorted_b = with_retry_no_split(one)
            s.close()
            runs.append(_Run(fw.track(sorted_b), sorted_b.num_rows))
            del sorted_b
        PC.bump("ooc_sort_runs", len(runs))
        return runs

    def _merge_runs(self, runs: List[_Run]) -> Iterator[ColumnarBatch]:
        """Windows of the runs, each sorted, its rows up to the bound out;
        one host sync a window reads what each run gave."""
        from spark_rapids_tpu_torch.perfcounters import sync_get

        C = self.ooc_chunk_rows
        schema = self.output
        windows = upload_bytes = 0
        try:
            while True:
                live = [r for r in runs if r.off < r.n]
                if not live:
                    break
                chunks, bounding = [], []
                h2d = PC.read("bytes_h2d")
                for r in live:
                    chunks.append(r.handle.get_rows(r.off,
                                                    min(C, r.n - r.off)))
                    bounding.append(r.n - r.off > C)
                moved = PC.read("bytes_h2d") - h2d
                upload_bytes += moved
                PC.note_peak("ooc_sort_merge_window_upload_bytes", moved)
                window = (chunks[0] if len(chunks) == 1
                          else ColumnarBatch.concat(chunks))
                takes = [c.num_rows for c in chunks]
                del chunks
                words = sort_key_words(window, self.orders, self.ansi)
                perm = lexsort(words)
                if any(bounding):
                    ends = torch.tensor(takes).cumsum(0) - 1
                    last = ends[torch.tensor(bounding)].to(window.device)
                    ok = le_bound(words, lex_min_row(words, last))
                    (used,) = sync_get(torch.stack(
                        [p.sum() for p in ok.split(takes)]))
                    used = [int(u) for u in used]
                else:                      # every run ends in this window
                    used = takes
                for r, u in zip(live, used):
                    r.off += u
                windows += 1
                emit = sum(used)
                if emit:
                    yield ColumnarBatch(
                        gather_columns(perm[:emit], window.columns), emit,
                        schema)
        finally:
            for r in runs:
                r.handle.close()
            PC.bump("ooc_sort_merge_windows", windows)
            PC.bump("ooc_sort_merge_upload_bytes", upload_bytes)


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

"""Equi-joins — port of the hash joins of ``spark_rapids_tpu/exec/join.py``
(inner, left, right and full outer, left semi, left anti): the broadcast
join, the shuffled join and the adaptive join that picks one of them at
run time.

The join is sort-based, as in the reference: the build side keeps its rows
with valid keys, sorted by their key words (``ops/sortkeys.py``); every
probe row finds its run of equal build keys, and the matched pairs are
expanded into gather maps.  A build row with a null key never matches, and
neither does a probe row with one.  A left outer join keeps every probe row
without a match (a null key included) once, after the pairs, with every
build column null.  The pair total and the unmatched count are the one
host sync per probe batch (the reference's ``sync_get`` of both).

Each probe row searches once, for its first build position: one key word
with ``torch.searchsorted``, several word by word with ``searchsorted``
over rank tables built once per build side (``_rank_search``), where the
reference sorts build and probe words together for each probe batch.  The
end of its run of equal build keys comes from ``run_end``, computed once
per build side, where the reference searches a second time.

The build side's batches are tracked by the spill framework as they
stream in, and each probe batch runs under ``with_retry`` over a tracked
handle, as in the reference.  A build side over ``sub_partition_bytes``
(``spark.rapids.sql.batchSizeBytes``; the broadcast and the shuffled join
alike) takes the sub-partitioned join: both sides are hashed into 2**k
spillable buckets with a seed of their own, and the buckets join one by
one, so about 1/2**k of the build side is on the card at a time
(reference: GpuSubPartitionHashJoin).

String keys take the build side's width: a probe key is padded or cut to
it, and a probe row longer than that width cannot match.  A string
column is joined on bytes and length (``ops/sortkeys.py``).

Left semi and left anti joins keep or drop each probe row on its match
count and output the probe side's columns only; a null key never
matches, so the anti join keeps it.  A full outer join is a left outer
join that also ORs, per probe batch, the build rows its pairs covered
into one flag (idempotent, so a re-run or split probe batch under
``with_retry`` may repeat it), and after the last probe batch emits the
build rows never covered once, with null probe columns; each bucket of
the sub-partitioned join emits its own.  A right outer join is the left
outer join with the sides swapped (the left side built) and the columns
put back in order.

An inner join's residual condition is evaluated on each probe batch's
pairs, which are then compacted (the reference's ``_apply_condition``),
so every route applies it after its own pairs: broadcast, shuffled,
adaptive after its decision, and each bucket of the sub-partitioned join.
The tagging keeps a residual condition on any other join type off the
device, as the reference's does.

``TpuAdaptiveJoinExec`` wraps a shuffled join whose children are
exchanges: it runs the build side first and joins by broadcast when the
built bytes are within ``spark.sql.autoBroadcastJoinThreshold``, else
replays them into the shuffled join.

``TpuCartesianProductExec`` is the cross join: every pair by index
arithmetic (``left_row = j // n_right``, ``right_row = j % n_right``),
at most ``MAX_PRODUCT_ROWS`` pairs a step.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   empty_batch, empty_column)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.exec.exchange import (gather_slice,
                                                  partition_order)
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.memory.retry import with_retry
from spark_rapids_tpu_torch.memory.spill import get_spill_framework
from spark_rapids_tpu_torch.ops.filterops import (compact_columns,
                                                  gather_columns)
from spark_rapids_tpu_torch.ops.hashing import spark_partition_ids
from spark_rapids_tpu_torch.ops.segment import seg_first_rows
from spark_rapids_tpu_torch.ops.sortkeys import _column_key_words, lexsort
from spark_rapids_tpu_torch.perfcounters import sync_get
from spark_rapids_tpu_torch.plan.nodes import JoinType

_INT64_MAX = 0x7FFFFFFFFFFFFFFF


def _key_words_of(key_cols: List[DeviceColumn]) -> List[torch.Tensor]:
    words: List[torch.Tensor] = []
    for kc in key_cols:
        words.extend(_column_key_words(kc))
    return words


def _run_ends(sorted_words: List[torch.Tensor], n_valid) -> torch.Tensor:
    """For each sorted build position, the end (exclusive, at most
    ``n_valid``) of its run of equal keys."""
    n = sorted_words[0].shape[0]
    dev = sorted_words[0].device
    first = torch.zeros(n, dtype=torch.int64, device=dev)
    first[:1] = 1
    for w in sorted_words:
        first[1:] |= (w[1:] != w[:-1]).to(torch.int64)
    run = torch.cumsum(first, 0) - 1
    iota = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    end = torch.zeros(n, dtype=torch.int64, device=dev).scatter_reduce_(
        0, run, iota, "amax")
    return torch.minimum(end[run], n_valid)


def _rank_tables(sorted_words: List[torch.Tensor]):
    """For each key word after the first, (that word's values sorted, the
    rank of each sorted build row's key prefix up to that word).  A rank
    is ``first * (n + 1) + r``: ``first`` the position of the first row
    of the shorter prefix's run, ``r`` the word's left position among the
    sorted values; both are at most n, so the rank fits int64 for n below
    2**31, and it grows with the prefix."""
    n = sorted_words[0].shape[0]
    change = torch.zeros(n, dtype=torch.bool, device=sorted_words[0].device)
    w0 = sorted_words[0]
    change[1:] |= w0[1:] != w0[:-1]
    first = seg_first_rows(change)
    tables = []
    for w in sorted_words[1:]:
        vals = torch.sort(w).values
        tables.append((vals, first * (n + 1) + torch.searchsorted(vals, w)))
        change[1:] |= w[1:] != w[:-1]
        first = seg_first_rows(change)
    return tables


def _rank_search(sorted_words: List[torch.Tensor], tables, n_valid,
                 query_words: List[torch.Tensor]) -> torch.Tensor:
    """searchsorted (side left) of several key words with one-word
    searches: word by word, the query's prefix rank is searched among the
    build's (``_rank_tables``).  Once a prefix is missing, the later words
    count 0, so the rank still lands where the prefix would sort."""
    n = sorted_words[0].shape[0]
    first = torch.searchsorted(sorted_words[0], query_words[0])
    if n == 0:
        return first
    hit = (first < n) & (sorted_words[0][first.clamp(max=n - 1)]
                         == query_words[0])
    for (vals, ranks), q in zip(tables, query_words[1:]):
        r = torch.searchsorted(vals, q)
        rank = first * (n + 1) + torch.where(hit, r, 0)
        first = torch.searchsorted(ranks, rank)
        # a missing word's left position may equal the next word's rank:
        # the word itself must be there
        hit &= (r < n) & (vals[r.clamp(max=n - 1)] == q) & (first < n) \
            & (ranks[first.clamp(max=n - 1)] == rank)
    return torch.minimum(first, n_valid)


def _equal_range(sorted_words: List[torch.Tensor], run_end, n_valid,
                 query_words: List[torch.Tensor], tables=None):
    """-> (lo, hi): the run of valid build keys equal to each query's key,
    as ``searchsorted`` left and right would give it.  ``tables``: the
    build's ``_rank_tables`` for several words (built here if not
    given)."""
    if len(sorted_words) == 1:
        # the build tail holds the largest word, so the whole vector stays
        # sorted; clamping to n_valid drops the tail
        lo = torch.searchsorted(sorted_words[0], query_words[0])
        lo = torch.minimum(lo, n_valid)
    else:
        if tables is None:
            tables = _rank_tables(sorted_words)
        lo = _rank_search(sorted_words, tables, n_valid, query_words)
    n = sorted_words[0].shape[0]
    if n == 0:
        return lo, lo
    at = lo.clamp(max=n - 1)
    match = lo < n_valid
    for sw, qw in zip(sorted_words, query_words):
        match &= sw[at] == qw
    return lo, torch.where(match, run_end[at], lo)


def _slots_to_probe_rows(excl: torch.Tensor, counts: torch.Tensor,
                         out_cap: int) -> torch.Tensor:
    """probe_row[j] for every output pair slot j: each matched probe row's
    index goes to its first slot, then a running max fills the rest."""
    n = counts.shape[0]
    iota = torch.arange(n, dtype=torch.int64, device=counts.device)
    # excl is strictly increasing over the rows with count > 0
    idx = torch.where(counts > 0, excl, out_cap)
    m = torch.full((out_cap + 1,), -1, dtype=torch.int64,
                   device=counts.device).scatter_(0, idx, iota)[:out_cap]
    return torch.cummax(m, 0).values.clamp(0, max(n - 1, 0))


def _fit_key_widths(key_cols: List[DeviceColumn], widths
                    ) -> List[DeviceColumn]:
    """Probe key columns at the build side's string widths (``widths``:
    one per key, 0 for a flat key); a row longer than its build width is
    null, since no build key can equal it."""
    out = []
    for kc, w in zip(key_cols, widths):
        if kc.is_string and kc.width != w:
            kc = kc.with_width(w)
            kc = DeviceColumn(kc.dtype, kc.validity & (kc.lengths <= w),
                              chars=kc.chars, lengths=kc.lengths)
        out.append(kc)
    return out


class _SortedBuildSide:
    """Build-side state: the rows with valid keys first, sorted by their
    key words; past ``n_valid`` every word holds the largest value."""

    def __init__(self, words, row_index, n_valid, batch, key_widths):
        self.words = words            # sorted key words
        self.row_index = row_index    # original row of each sorted position
        self.n_valid = n_valid        # device scalar
        self.batch = batch            # the build batch
        self.key_widths = key_widths  # each string key's width, else 0
        self.run_end = _run_ends(words, n_valid)
        self.tables = _rank_tables(words) if len(words) > 1 else None


#: the equi-join types the port runs
PORTED_JOIN_TYPES = (JoinType.INNER, JoinType.LEFT_OUTER,
                      JoinType.RIGHT_OUTER, JoinType.FULL_OUTER,
                      JoinType.LEFT_SEMI, JoinType.LEFT_ANTI)

_SUB_PARTITION_SEED = 100407   # decorrelated from exchange partitioning


class _MaterializedExec(TpuExec):
    """Leaf replaying spillable batches already made (the per-bucket
    children of a sub-partitioned join)."""

    def __init__(self, spillables, schema: T.StructType):
        super().__init__([])
        self._spillables = spillables
        self._schema = schema

    @property
    def output(self):
        return self._schema

    @property
    def device(self):
        return self._spillables[0].device if self._spillables else None

    def execute_columnar(self):
        for s in self._spillables:
            s.pin()
            try:
                b = s.get_batch()
            finally:
                s.unpin()
            yield b


def _null_rows(cols: List[DeviceColumn], n: int) -> List[DeviceColumn]:
    """``cols`` with ``n`` null rows appended (zero buffers; a string's
    lengths 0)."""
    return [DeviceColumn.concat([c, c.map_rows(
        lambda t: torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device))]) for c in cols]


def _null_columns(schema: T.StructType, n: int, device
                  ) -> List[DeviceColumn]:
    """``n`` null rows of each field of ``schema`` (a string at the
    narrowest width, as the reference's tail)."""
    return _null_rows([empty_column(f.dataType, device)
                       for f in schema.fields], n)


def true_rows(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The indices where ``mask`` holds, in order, given their ``count``
    (already on the host, so no further sync)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    to = torch.where(mask, pos, count)
    iota = torch.arange(n, dtype=torch.int64, device=mask.device)
    return torch.zeros(count + 1, dtype=torch.int64,
                       device=mask.device).scatter_(0, to, iota)[:count]


def condition_mask(condition: Expression, batch: ColumnarBatch,
                   ansi: bool) -> torch.Tensor:
    """Where ``condition`` holds (true, not null) on the rows of
    ``batch``; an ANSI error in it raises, all its flags read in one
    host sync."""
    ctx = EvalContext(batch, ansi=ansi)
    pred = condition.eval_tpu(ctx)
    ctx.check_errors()
    return pred.data.to(torch.bool) & pred.validity & batch.row_mask


def apply_condition(condition: Optional[Expression], batch: ColumnarBatch,
                    ansi: bool) -> Optional[ColumnarBatch]:
    """An inner join's pairs kept where its residual ``condition`` holds
    (the reference's ``_apply_condition``): the pair batch compacted, its
    kept count one host sync; None when no pair is kept."""
    if condition is None:
        return batch
    cols, n = compact_columns(condition_mask(condition, batch, ansi),
                              batch.columns)
    return ColumnarBatch(cols, n, batch.schema) if n else None


def _covered_build_rows(build: "_SortedBuildSide", lo, counts
                        ) -> torch.Tensor:
    """bool per original build row: in some matched pair of this probe
    batch (a difference array over the sorted positions, mapped back to
    the rows; the reference's ``_covered_build_rows``)."""
    n = build.row_index.shape[0]
    dev = counts.device
    has = counts > 0
    diff = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    diff.index_add_(0, torch.where(has, lo, n),
                    has.to(torch.int64))
    diff.index_add_(0, torch.where(has, lo + counts, n),
                    -has.to(torch.int64))
    covered_sorted = torch.cumsum(diff[:-1], 0) > 0
    return torch.zeros(n, dtype=torch.bool, device=dev).scatter_(
        0, build.row_index, covered_sorted)


class _BaseTpuJoinExec(TpuExec):
    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: List[Expression], right_keys: List[Expression],
                 join_type: JoinType, condition: Optional[Expression],
                 output_schema: T.StructType, ansi: bool = False,
                 sub_partition_bytes: int = 1 << 30):
        super().__init__([left, right])
        if join_type not in PORTED_JOIN_TYPES or not left_keys or (
                condition is not None and join_type != JoinType.INNER):
            raise NotOnGpu(f"{join_type.value} join (only the inner, "
                           "outer, semi and anti equi-joins, and a residual "
                           "condition on an inner one, are ported)")
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.join_type = join_type
        self.condition = condition
        self._output = output_schema
        self.ansi = ansi
        # a built side over this many bytes takes the sub-partitioned join
        self.sub_partition_bytes = sub_partition_bytes
        self.sub_partitions: Optional[int] = None   # buckets of the last run

    @property
    def output(self):
        return self._output

    def describe(self):
        keys = ", ".join(f"{l.sql_string()}={r.sql_string()}"
                         for l, r in zip(self.left_keys, self.right_keys))
        return f"{self.node_name} {self.join_type.value} [{keys}]"

    def _build_child(self) -> TpuExec:
        return self.children[1]

    def _probe_child(self) -> TpuExec:
        return self.children[0]

    # -- build side -----------------------------------------------------
    def _prepare_build(self, batch: ColumnarBatch,
                       keys: List[Expression]) -> _SortedBuildSide:
        ctx = EvalContext(batch, ansi=self.ansi)
        key_cols = [k.eval_tpu(ctx) for k in keys]
        valid = batch.row_mask
        for kc in key_cols:
            valid = valid & kc.validity
        words = _key_words_of(key_cols)
        perm = lexsort([(~valid).to(torch.int64)] + words)
        n_valid = valid.sum()
        tail = torch.arange(batch.num_rows, device=valid.device) >= n_valid
        sorted_words = [torch.where(tail, _INT64_MAX, w[perm]) for w in words]
        ctx.check_errors()
        return _SortedBuildSide(sorted_words, perm, n_valid, batch,
                                [kc.width for kc in key_cols])

    # -- probe ----------------------------------------------------------
    def _probe_counts(self, build: _SortedBuildSide, batch: ColumnarBatch):
        """-> (first matching build position, match count) per probe row,
        their device total, the probe rows without a match (a null key
        included) and their device count."""
        ctx = EvalContext(batch, ansi=self.ansi)
        key_cols = _fit_key_widths(
            [k.eval_tpu(ctx) for k in self.left_keys], build.key_widths)
        valid = batch.row_mask
        for kc in key_cols:
            valid = valid & kc.validity
        qwords = _key_words_of(key_cols)
        lo, hi = _equal_range(build.words, build.run_end, build.n_valid,
                              qwords, build.tables)
        counts = torch.where(valid, hi - lo, 0)
        ctx.check_errors()
        unmatched = batch.row_mask & (counts == 0)
        return lo, counts, counts.sum(), unmatched, unmatched.sum()

    @staticmethod
    def materialize_pairs(row_index, b_cols, p_cols, lo, counts,
                          out_cap: int):
        """Gather-map expansion of the matched pairs: probe columns and
        build columns, ``out_cap`` (the pair total) rows each."""
        offsets = torch.cumsum(counts, 0)
        excl = offsets - counts
        j = torch.arange(out_cap, dtype=torch.int64, device=counts.device)
        probe_row = _slots_to_probe_rows(excl, counts, out_cap)
        build_pos = lo[probe_row] + (j - excl[probe_row])
        build_row = row_index[build_pos]
        return (gather_columns(probe_row, list(p_cols)),
                gather_columns(build_row, list(b_cols)))

    def _probe_one(self, build: _SortedBuildSide, probe: ColumnarBatch,
                   covered: Optional[List[torch.Tensor]] = None
                   ) -> Optional[ColumnarBatch]:
        """One probe batch against the build side.  Semi and anti joins
        keep or drop each probe row on its match count (the compaction's
        count is their one sync, as the reference's ``_semi_anti``); the
        full outer join ORs the build rows this batch covered into
        ``covered[0]``, which a re-run or a split batch may repeat."""
        jt = self.join_type
        lo, counts, total, unmatched, n_um = self._probe_counts(build, probe)
        if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            keep = (counts == 0) if jt == JoinType.LEFT_ANTI else counts > 0
            cols, n = compact_columns(keep & probe.row_mask, probe.columns)
            return ColumnarBatch(cols, n, self._output) if n else None
        if jt == JoinType.FULL_OUTER:
            covered[0] = covered[0] | _covered_build_rows(build, lo, counts)
        total_host, um_host = (int(x) for x in sync_get(total, n_um))
        if jt == JoinType.INNER:
            um_host = 0
        if total_host + um_host == 0:
            return None
        lcols, bcols = self.materialize_pairs(
            build.row_index, build.batch.columns, probe.columns, lo, counts,
            total_host)
        if um_host:
            rows = true_rows(unmatched, um_host)
            um_cols = gather_columns(rows, list(probe.columns))
            lcols = [DeviceColumn.concat([a, b])
                     for a, b in zip(lcols, um_cols)]
            bcols = _null_rows(bcols, um_host)
        # the residual condition (inner only) over this batch's pairs, so
        # every route (broadcast, shuffled, adaptive, each bucket of the
        # sub-partitioned join) applies it after its own pairs
        return apply_condition(self.condition, ColumnarBatch(
            lcols + bcols, total_host + um_host, self._output), self.ansi)

    def _unmatched_build_tail(self, build_batch: ColumnarBatch,
                              covered: torch.Tensor
                              ) -> Optional[ColumnarBatch]:
        """The full outer join's build rows that no probe row matched, once
        after the last probe batch, with every probe column null (the
        reference's ``_unmatched_build_tail``)."""
        cols, n = compact_columns(build_batch.row_mask & ~covered,
                                  build_batch.columns)
        if n == 0:
            return None
        nulls = _null_columns(self._probe_child().output, n,
                              build_batch.device)
        return ColumnarBatch(nulls + cols, n, self._output)

    def _execute_right_outer(self) -> Iterator[ColumnarBatch]:
        """RIGHT OUTER is LEFT OUTER with the sides swapped (the left side
        built, the right side probed), its columns reordered (the
        reference's ``_execute_right_outer``)."""
        left_out = self._probe_child().output
        right_out = self._build_child().output
        swapped = TpuShuffledSymmetricHashJoinExec(
            self.children[1], self.children[0], self.right_keys,
            self.left_keys, JoinType.LEFT_OUTER, self.condition,
            T.StructType(list(right_out.fields) + [
                T.StructField(f.name, f.dataType, True)
                for f in left_out.fields]),
            self.ansi, sub_partition_bytes=self.sub_partition_bytes)
        nr = len(right_out.fields)
        try:
            for b in swapped.execute_columnar():
                yield ColumnarBatch(b.columns[nr:] + b.columns[:nr],
                                    b.num_rows, self._output)
        finally:
            self.sub_partitions = swapped.sub_partitions

    # -- sub-partitioning (GpuSubPartitionHashJoin analog) ----------------
    def _sub_partition(self, spillables, keys, n_parts: int, schema, fw):
        """Hash the rows of ``spillables`` into ``n_parts`` lists of
        spillable buckets: per batch one id computation, one stable sort
        by id and one host sync for the bounds (the reference compacts
        once, with a sync, per bucket)."""
        buckets = [[] for _ in range(n_parts)]
        try:
            for s in spillables:
                s.pin()
                try:
                    b = s.get_batch()
                    ctx = EvalContext(b, ansi=self.ansi)
                    key_cols = [k.eval_tpu(ctx) for k in keys]
                    ctx.check_errors()
                    ids = spark_partition_ids(key_cols, n_parts,
                                              seed=_SUB_PARTITION_SEED)
                    perm, bounds = partition_order(ids, n_parts)
                    for pid in range(n_parts):
                        lo, hi = bounds[pid], bounds[pid + 1]
                        if hi > lo:
                            buckets[pid].append(
                                fw.track(gather_slice(b, perm, lo, hi)))
                finally:
                    s.unpin()
                    s.close()
        except BaseException:
            for bucket in buckets:
                for h in bucket:
                    h.close()
            raise
        return buckets

    def _execute_sub_partitioned(self, build_spillables, total_bytes: int
                                 ) -> Iterator[ColumnarBatch]:
        """The build side exceeds the goal: hash both sides into buckets
        and join bucket by bucket."""
        fw = get_spill_framework()
        n_parts = 1
        while n_parts * self.sub_partition_bytes < total_bytes:
            n_parts <<= 1
        n_parts = max(2, n_parts)
        self.sub_partitions = n_parts
        bschema = self._build_child().output
        pschema = self._probe_child().output
        build_buckets = probe_buckets = [[] for _ in range(n_parts)]
        try:
            build_buckets = self._sub_partition(
                build_spillables, self.right_keys, n_parts, bschema, fw)
            probe_buckets = self._sub_partition(
                (fw.track(b) for b in self._probe_child().execute_columnar()),
                self.left_keys, n_parts, pschema, fw)
            for pid in range(n_parts):
                if not probe_buckets[pid] and not (
                        self.join_type == JoinType.FULL_OUTER
                        and build_buckets[pid]):
                    # nothing to probe with: only a full outer join keeps
                    # a build row of this bucket (its tail)
                    continue
                sub = TpuShuffledSymmetricHashJoinExec(
                    _MaterializedExec(probe_buckets[pid], pschema),
                    _MaterializedExec(build_buckets[pid], bschema),
                    self.left_keys, self.right_keys, self.join_type,
                    self.condition, self._output, self.ansi,
                    sub_partition_bytes=1 << 62)  # buckets never re-split
                yield from sub.execute_columnar()
                for s in build_buckets[pid] + probe_buckets[pid]:
                    s.close()
                build_buckets[pid] = []
                probe_buckets[pid] = []
        finally:
            # an abandoned generator must not leave handles tracked
            for s in build_spillables:
                s.close()
            for bucket in build_buckets + probe_buckets:
                for s in bucket:
                    s.close()

    # -- execution -------------------------------------------------------
    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        if self.join_type == JoinType.RIGHT_OUTER:
            yield from self._execute_right_outer()
            return
        fw = get_spill_framework()
        # track the build batches as they stream in, so the framework can
        # shed them while the rest arrives
        build_spill = []
        total_build_bytes = 0
        try:
            for b in self._build_child().execute_columnar():
                total_build_bytes += b.nbytes()
                build_spill.append(fw.track(b))
        except BaseException:
            for s in build_spill:
                s.close()
            raise
        if total_build_bytes > self.sub_partition_bytes:
            yield from self._execute_sub_partitioned(build_spill,
                                                     total_build_bytes)
            return
        for s in build_spill:
            s.pin()
        try:
            batches = [s.get_batch() for s in build_spill]
            build_batch = (empty_batch(self._build_child().output,
                                       self._device()) if not batches
                           else batches[0] if len(batches) == 1
                           else ColumnarBatch.concat(batches))
        finally:
            for s in build_spill:
                s.unpin()
                s.close()
        del build_spill, batches
        build = self._prepare_build(build_batch, self.right_keys)
        covered = None
        if self.join_type == JoinType.FULL_OUTER:
            covered = [torch.zeros(build_batch.num_rows, dtype=torch.bool,
                                   device=build_batch.device)]
        for probe in self._probe_child().execute_columnar():
            # re-runnable and splittable by probe rows, as the reference's
            outs = list(with_retry(
                fw.track(probe),
                lambda p: self._probe_one(build, p, covered)))
            for out in outs:
                if out is not None:
                    yield out
        if covered is not None:
            tail = self._unmatched_build_tail(build_batch, covered[0])
            if tail is not None:
                yield tail


class TpuBroadcastHashJoinExec(_BaseTpuJoinExec):
    """Join against a broadcast build side: the build child (a
    ``TpuBroadcastExchangeExec``, or the adaptive join's replay) arrives
    whole, as one batch."""


class TpuShuffledSymmetricHashJoinExec(_BaseTpuJoinExec):
    """The shuffled join (after the exchanges); on one device its build
    side is the whole right side, joined as the broadcast join joins it."""


#: the most pairs one step of a cross or nested-loop join expands
MAX_PRODUCT_ROWS = 1 << 20


def cross_pairs(lb: ColumnarBatch, rb: ColumnarBatch, schema: T.StructType
                ) -> ColumnarBatch:
    """Every (left row, right row) pair, left-major: pair ``j`` is left
    row ``j // n_right`` and right row ``j % n_right``.  A right side of
    one row pairs with the left batch as it is, its row a stride-0
    ``expand`` over the left rows: nothing is copied (a bloom filter's
    words would be copied into every probe row)."""
    nr = rb.num_rows
    if nr == 1:
        n = lb.num_rows
        return ColumnarBatch(list(lb.columns) + [
            c.map_rows(lambda t: t[:1].expand(n, *t.shape[1:]))
            for c in rb.columns], n, schema)
    total = lb.num_rows * nr
    j = torch.arange(total, dtype=torch.int64, device=lb.device)
    return ColumnarBatch(gather_columns(j // max(nr, 1), lb.columns)
                         + gather_columns(j % max(nr, 1), rb.columns),
                         total, schema)


def left_chunks(lb: ColumnarBatch, n_right: int, max_pairs: int):
    """``lb`` in slices (views) of at most ``max_pairs // n_right`` rows,
    so that no step expands more than ``max_pairs`` pairs; whole against
    a right side of one row, which expands nothing."""
    if n_right == 1:
        yield lb
        return
    step = max(1, max_pairs // max(n_right, 1))
    for start in range(0, lb.num_rows, step):
        yield lb.slice_rows(start, min(step, lb.num_rows - start))


def whole_batch(child: TpuExec) -> ColumnarBatch:
    """Everything ``child`` yields as one batch (an empty one of its
    schema when it yields nothing): a broadcast side."""
    batches = list(child.execute_columnar())
    if not batches:
        return empty_batch(child.output, child._device())
    return batches[0] if len(batches) == 1 else ColumnarBatch.concat(batches)


class TpuCartesianProductExec(TpuExec):
    """The cross join (the reference's ``TpuCartesianProductExec``,
    GpuCartesianProductExec): the right side whole, then each left batch
    expanded by index arithmetic in steps of at most ``MAX_PRODUCT_ROWS``
    pairs (a right side of one row as a view, ``cross_pairs``), then the
    condition, if any."""

    MAX_PRODUCT = MAX_PRODUCT_ROWS

    def __init__(self, left: TpuExec, right: TpuExec,
                 output_schema: T.StructType,
                 condition: Optional[Expression] = None, ansi: bool = False):
        super().__init__([left, right])
        self._output = output_schema
        self.condition = condition
        self.ansi = ansi

    @property
    def output(self):
        return self._output

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        rb = whole_batch(self.children[1])
        if rb.num_rows == 0:
            return
        for lb in self.children[0].execute_columnar():
            for piece in left_chunks(lb, rb.num_rows, self.MAX_PRODUCT):
                out = apply_condition(self.condition,
                                      cross_pairs(piece, rb, self._output),
                                      self.ansi)
                if out is not None:
                    yield out


class _ReplayExec(TpuExec):
    """Re-emits batches the adaptive join already built, once.  They come
    as spillable handles (tracked while the decision was pending, so an
    oversized build side can move to the host) and close as they go."""

    def __init__(self, handles, output_schema):
        super().__init__([])
        self._handles = handles
        self._output = output_schema

    @property
    def output(self):
        return self._output

    @property
    def device(self):
        return self._handles[0].device if self._handles else None

    def describe(self):
        return f"Replay[{len(self._handles)} batches]"

    def execute_columnar(self):
        handles, self._handles = self._handles, []
        for h in handles:
            b = h.get_batch()
            h.close()
            yield b


def _logical_bytes(batches) -> int:
    """Bytes of the batches' columns (a port batch holds only its rows, so
    the reference's row-weighting of padded capacity is the identity)."""
    return sum(b.nbytes() for b in batches)


class TpuAdaptiveJoinExec(TpuExec):
    """The run-time join-strategy switch (the reference's AQE analog).

    Wraps a planned shuffled join whose children are exchanges.  At run
    time the build side below its exchange runs first; when its bytes are
    within ``threshold`` (``spark.sql.autoBroadcastJoinThreshold``) the
    join runs as a broadcast join with both exchanges elided, else the
    shuffled join runs with the built batches replayed into its exchange,
    so nothing is computed twice.  ``decision`` records which, with the
    bytes."""

    def __init__(self, shuffled: TpuShuffledSymmetricHashJoinExec,
                 threshold: int):
        super().__init__(list(shuffled.children))
        self.shuffled = shuffled
        self.threshold = threshold
        self.decision: Optional[str] = None

    @property
    def output(self):
        return self.shuffled.output

    def describe(self):
        d = f" decided={self.decision}" if self.decision else ""
        return (f"TpuAdaptiveJoin(threshold={self.threshold})"
                f"[{self.shuffled.describe()}]{d}")

    def execute_columnar(self):
        left_ex, right_ex = self.shuffled.children
        build_inner = right_ex.children[0]
        fw = get_spill_framework()
        handles = []
        size = 0
        for b in build_inner.execute_columnar():
            size += _logical_bytes([b])
            handles.append(fw.track(b))
        if 0 <= self.threshold and size <= self.threshold:
            self.decision = f"broadcast({size}B)"
            sh = self.shuffled
            bj = TpuBroadcastHashJoinExec(
                left_ex.children[0], _ReplayExec(handles, build_inner.output),
                sh.left_keys, sh.right_keys, sh.join_type, sh.condition,
                sh.output, sh.ansi, sub_partition_bytes=sh.sub_partition_bytes)
            yield from bj.execute_columnar()
            return
        self.decision = f"shuffled({size}B)"
        # the replay child is single-shot: restore the real build subtree
        # afterwards, so a repeated run of this plan builds again instead
        # of joining an empty replay (the reference found that a second
        # collect joined an empty build side and dropped every match)
        right_ex.children[0] = _ReplayExec(handles, build_inner.output)
        try:
            yield from self.shuffled.execute_columnar()
        finally:
            right_ex.children[0] = build_inner

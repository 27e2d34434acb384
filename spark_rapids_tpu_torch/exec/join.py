"""Equi-joins — port of the inner broadcast hash join of
``spark_rapids_tpu/exec/join.py``.

The join is sort-based, as in the reference: the build side keeps its rows
with valid keys, sorted by their key words (``ops/sortkeys.py``); every
probe row finds its run of equal build keys with two searches, and the
matched pairs are expanded into gather maps.  A build row with a null key
never matches, and neither does a probe row with one.  The output row
count is the one host sync per probe batch (the reference's ``sync_get``
of the pair total).

Each probe row searches once, for its first build position: one key word
with ``torch.searchsorted``, several through one shared sort of build and
probe words (``_merge_rank``).  The end of its run of equal build keys
comes from ``run_end``, computed once per build side, where the reference
searches a second time.  Left outer,
semi, anti, right, full and cross joins, a residual condition, the
sub-partitioned join and the shuffled join are not ported: the plan
rewrite raises ``NotOnGpu`` for them.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.expr.base import EvalContext, Expression
from spark_rapids_tpu_torch.ops.filterops import gather_columns
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


def _equal_range(sorted_words: List[torch.Tensor], run_end, n_valid,
                 query_words: List[torch.Tensor]):
    """-> (lo, hi): the run of valid build keys equal to each query's key,
    as ``searchsorted`` left and right would give it."""
    if len(sorted_words) == 1:
        # the build tail holds the largest word, so the whole vector stays
        # sorted; clamping to n_valid drops the tail
        lo = torch.searchsorted(sorted_words[0], query_words[0])
        lo = torch.minimum(lo, n_valid)
    else:
        lo = _merge_rank(sorted_words, n_valid, query_words)
    n = sorted_words[0].shape[0]
    if n == 0:
        return lo, lo
    at = lo.clamp(max=n - 1)
    match = lo < n_valid
    for sw, qw in zip(sorted_words, query_words):
        match &= sw[at] == qw
    return lo, torch.where(match, run_end[at], lo)


def _merge_rank(sorted_words: List[torch.Tensor], n_valid,
                query_words: List[torch.Tensor]) -> torch.Tensor:
    """searchsorted (side left) through one shared sort: each query's rank
    among the valid build keys.  Per row the key is (invalid,
    word_0..word_k, tie): ``invalid`` puts the build tail after everything,
    ``tie`` puts a query before equal build keys."""
    n = sorted_words[0].shape[0]
    nq = query_words[0].shape[0]
    dev = sorted_words[0].device
    b_inv = (torch.arange(n, device=dev) >= n_valid).to(torch.int64)
    q_inv = torch.zeros(nq, dtype=torch.int64, device=dev)
    words = [torch.cat([b_inv, q_inv])]
    words += [torch.cat([sw, qw]) for sw, qw in zip(sorted_words,
                                                    query_words)]
    words.append(torch.cat([torch.ones_like(b_inv), q_inv]))
    pos = lexsort(words)
    is_build = (pos < n).to(torch.int64)
    nb_before = torch.cumsum(is_build, 0) - is_build
    qpos = torch.where(is_build == 1, nq, pos - n)
    out = torch.zeros(nq + 1, dtype=torch.int64, device=dev)
    return out.scatter_(0, qpos, nb_before)[:nq]


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


class _SortedBuildSide:
    """Build-side state: the rows with valid keys first, sorted by their
    key words; past ``n_valid`` every word holds the largest value."""

    def __init__(self, words, row_index, n_valid, batch):
        self.words = words            # sorted key words
        self.row_index = row_index    # original row of each sorted position
        self.n_valid = n_valid        # device scalar
        self.batch = batch            # the build batch
        self.run_end = _run_ends(words, n_valid)


class _BaseTpuJoinExec(TpuExec):
    def __init__(self, left: TpuExec, right: TpuExec,
                 left_keys: List[Expression], right_keys: List[Expression],
                 join_type: JoinType, condition: Optional[Expression],
                 output_schema: T.StructType, ansi: bool = False):
        super().__init__([left, right])
        if join_type != JoinType.INNER or condition is not None \
                or not left_keys:
            raise NotOnGpu(f"{join_type.value} join (only the inner "
                           "equi-join without a condition is ported)")
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.join_type = join_type
        self.condition = condition
        self._output = output_schema
        self.ansi = ansi

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
        return _SortedBuildSide(sorted_words, perm, n_valid, batch)

    # -- probe ----------------------------------------------------------
    def _probe_counts(self, build: _SortedBuildSide, batch: ColumnarBatch):
        """-> (first matching build position, match count) per probe row,
        and their device total."""
        ctx = EvalContext(batch, ansi=self.ansi)
        key_cols = [k.eval_tpu(ctx) for k in self.left_keys]
        valid = batch.row_mask
        for kc in key_cols:
            valid = valid & kc.validity
        qwords = _key_words_of(key_cols)
        lo, hi = _equal_range(build.words, build.run_end, build.n_valid,
                              qwords)
        counts = torch.where(valid, hi - lo, 0)
        ctx.check_errors()
        return lo, counts, counts.sum()

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

    def _probe_one(self, build: _SortedBuildSide, probe: ColumnarBatch
                   ) -> Optional[ColumnarBatch]:
        lo, counts, total = self._probe_counts(build, probe)
        (total_host,) = sync_get(total)
        total_host = int(total_host)
        if total_host == 0:
            return None
        lcols, bcols = self.materialize_pairs(
            build.row_index, build.batch.columns, probe.columns, lo, counts,
            total_host)
        return ColumnarBatch(lcols + bcols, total_host, self._output)

    # -- execution -------------------------------------------------------
    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        batches = list(self._build_child().execute_columnar())
        bschema = self._build_child().output
        if not batches:
            build_batch = empty_batch(bschema, self._device())
        else:
            build_batch = (batches[0] if len(batches) == 1
                           else ColumnarBatch.concat(batches))
        del batches
        build = self._prepare_build(build_batch, self.right_keys)
        for probe in self._probe_child().execute_columnar():
            out = self._probe_one(build, probe)
            if out is not None:
                yield out


class TpuBroadcastHashJoinExec(_BaseTpuJoinExec):
    """Join against a broadcast build side: the build child (a
    ``TpuBroadcastExchangeExec``) arrives whole, as one batch."""

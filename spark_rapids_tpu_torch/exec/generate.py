"""The broadcast nested-loop join — port of ``TpuBroadcastNestedLoopJoinExec``
(``spark_rapids_tpu/exec/generate.py``); the module's ``Generate`` and
``Expand`` execs are not ported yet.

A join without equi-keys checks its condition on every (left row, right
row) pair.  The right side arrives whole (a broadcast); each left batch is
cut into chunks of at most ``MAX_PRODUCT`` pairs, and each chunk is
expanded by index arithmetic (``left_row = j // n_right``, ``right_row =
j % n_right``), the condition evaluated over the expansion, and each left
row's ``any_match`` taken by a scatter-max over the left index.  Then, as
the reference does for each type:

  * inner and cross keep the matched pairs;
  * left outer keeps them and adds the left rows without a match, their
    right columns null;
  * left semi keeps the left rows with a match, left anti those without.

An empty right side gives no row for inner, cross and semi, and every
left row for left outer (with a null right side) and anti.  Right and
full outer nested-loop joins are kept off the device by the tagging
(``overrides/meta.py``) and run in the CPU engine (``cpu/oracle.py``).
Each chunk costs one host sync for its counts, plus one for the
condition's ANSI error flags when it has any.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.exec.join import (MAX_PRODUCT_ROWS, _null_rows,
                                              condition_mask, cross_pairs,
                                              left_chunks, true_rows,
                                              whole_batch)
from spark_rapids_tpu_torch.expr.base import Expression
from spark_rapids_tpu_torch.ops.filterops import gather_columns
from spark_rapids_tpu_torch.perfcounters import sync_get
from spark_rapids_tpu_torch.plan.nodes import JoinType


class TpuBroadcastNestedLoopJoinExec(TpuExec):
    """Non-equi join: the condition over the cartesian expansion, chunked
    so that one chunk expands at most ``MAX_PRODUCT`` pairs."""

    MAX_PRODUCT = MAX_PRODUCT_ROWS

    def __init__(self, left: TpuExec, right: TpuExec, join_type: JoinType,
                 condition: Optional[Expression],
                 output_schema: T.StructType, ansi: bool = False):
        super().__init__([left, right])
        self.join_type = join_type
        self.condition = condition
        self._output = output_schema
        self.ansi = ansi

    @property
    def output(self):
        return self._output

    def describe(self):
        c = self.condition.sql_string() if self.condition is not None else ""
        return f"TpuBroadcastNestedLoopJoin {self.join_type.value} [{c}]"

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        rb = whole_batch(self.children[1])
        lschema = self.children[0].output
        pair_schema = T.StructType(
            list(lschema.fields) + [T.StructField(f.name, f.dataType, True)
                                    for f in rb.schema.fields])
        for lb in self.children[0].execute_columnar():
            for piece in left_chunks(lb, rb.num_rows, self.MAX_PRODUCT):
                out = self._join_chunk(piece, rb, pair_schema)
                if out is not None:
                    yield out

    def _join_chunk(self, lb: ColumnarBatch, rb: ColumnarBatch,
                    pair_schema: T.StructType) -> Optional[ColumnarBatch]:
        jt = self.join_type
        nl, nr = lb.num_rows, rb.num_rows
        if nr == 0:
            # anti keeps every left row, left outer every left row with a
            # null right side (at the right side's string widths)
            if jt == JoinType.LEFT_ANTI:
                return ColumnarBatch(list(lb.columns), nl, self._output)
            if jt == JoinType.LEFT_OUTER:
                return ColumnarBatch(
                    list(lb.columns) + _null_rows(rb.columns, nl), nl,
                    self._output)
            return None
        pairs = cross_pairs(lb, rb, pair_schema)
        ok = (condition_mask(self.condition, pairs, self.ansi)
              if self.condition is not None
              else torch.ones(nl * nr, dtype=torch.bool, device=lb.device))
        left_row = torch.arange(nl * nr, dtype=torch.int64,
                                device=lb.device) // nr
        any_match = torch.zeros(nl, dtype=torch.int64,
                                device=lb.device).scatter_reduce_(
            0, left_row, ok.to(torch.int64), "amax") > 0
        if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            keep = any_match if jt == JoinType.LEFT_SEMI else ~any_match
            (n,) = (int(x) for x in sync_get(keep.sum()))
            if n == 0:
                return None
            return ColumnarBatch(
                gather_columns(true_rows(keep, n), lb.columns), n,
                self._output)
        # inner, cross, left outer: the matched pairs; left outer adds the
        # left rows without a match after them, their right side null
        unmatched = ~any_match
        n_ok, n_um = (int(x) for x in sync_get(ok.sum(), unmatched.sum()))
        if jt != JoinType.LEFT_OUTER:
            n_um = 0
        if n_ok + n_um == 0:
            return None
        pcols = gather_columns(true_rows(ok, n_ok), pairs.columns)
        if n_um == 0:
            return ColumnarBatch(pcols, n_ok, self._output)
        k = len(lb.columns)
        um_cols = gather_columns(true_rows(unmatched, n_um), lb.columns)
        lcols = [DeviceColumn.concat([a, b])
                 for a, b in zip(pcols[:k], um_cols)]
        return ColumnarBatch(lcols + _null_rows(pcols[k:], n_um),
                             n_ok + n_um, self._output)

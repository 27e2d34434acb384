"""ColumnarBatch — port of ``spark_rapids_tpu/columnar/batch.py``.

A batch is a list of ``DeviceColumn``s (flat, string, array or struct) of
exactly ``num_rows`` rows (no capacity padding, see ``column.py``) plus
its schema.  Concatenation meets a string column's batches at their
widest width, an array column's at their widest element width.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DEFAULT_WIDTH_BUCKETS,
                                                    DeviceColumn, HostColumn,
                                                    column_torch_dtype,
                                                    rebuild_column)
from spark_rapids_tpu_torch.perfcounters import sync_get


@dataclasses.dataclass
class ColumnarBatch:
    columns: List[DeviceColumn]
    num_rows: int
    schema: T.StructType

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else self.num_rows

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    def nbytes(self) -> int:
        return sum(c.nbytes() for c in self.columns)

    @property
    def row_mask(self) -> torch.Tensor:
        """(capacity,) bool — every row of an unpadded batch is logical."""
        return torch.arange(self.capacity, device=self.device) \
            < self.num_rows

    @staticmethod
    def from_host_columns(cols: Sequence[HostColumn], names: Sequence[str],
                          device) -> "ColumnarBatch":
        n = cols[0].num_rows if cols else 0
        schema = T.StructType(
            [T.StructField(nm, c.dtype) for nm, c in zip(names, cols)])
        return ColumnarBatch([DeviceColumn.from_host(c, device)
                              for c in cols], n, schema)

    def to_host_columns(self) -> List[HostColumn]:
        """All buffers of all columns in ONE logical host sync."""
        n = self.num_rows
        it = iter(sync_get(*[t[:n] for c in self.columns
                             for t in c.tensors()]))
        return [rebuild_column(c.dtype, it, HostColumn)
                for c in self.columns]

    def to_pydict(self) -> dict:
        host = self.to_host_columns()
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema.fields, host)}

    def to_rows(self) -> List[tuple]:
        cols = [c.to_pylist() for c in self.to_host_columns()]
        return list(zip(*cols)) if cols else [()] * self.num_rows

    def slice_rows(self, start: int, length: int) -> "ColumnarBatch":
        """Rows ``[start, start + length)`` as views (no copy)."""
        return ColumnarBatch([c.slice(start, start + length)
                              for c in self.columns], length, self.schema)

    @staticmethod
    def concat(batches: Sequence["ColumnarBatch"]) -> "ColumnarBatch":
        first = batches[0]
        cols = [DeviceColumn.concat([b.columns[i] for b in batches])
                for i in range(len(first.columns))]
        return ColumnarBatch(cols, sum(b.num_rows for b in batches),
                             first.schema)


def empty_batch(schema: T.StructType, device) -> ColumnarBatch:
    """A batch of no rows."""
    return ColumnarBatch([empty_column(f.dataType, device)
                          for f in schema.fields], 0, schema)


def empty_column(dt: T.DataType, device) -> DeviceColumn:
    validity = torch.zeros(0, dtype=torch.bool, device=device)
    if isinstance(dt, T.StringType):
        # the narrowest bucket, as the reference's empty string column
        return DeviceColumn(dt, validity, chars=torch.zeros(
            (0, DEFAULT_WIDTH_BUCKETS[0]), dtype=torch.uint8, device=device),
            lengths=torch.zeros(0, dtype=torch.int32, device=device))
    if isinstance(dt, T.StructType):
        return DeviceColumn(dt, validity, children=[
            empty_column(f.dataType, device) for f in dt.fields])
    if isinstance(dt, T.ArrayType):
        ew = DEFAULT_WIDTH_BUCKETS[0]
        return DeviceColumn(dt, validity, data=torch.zeros(
            (0, ew), dtype=column_torch_dtype(dt.elementType),
            device=device),
            lengths=torch.zeros(0, dtype=torch.int32, device=device),
            elem_valid=torch.zeros((0, ew), dtype=torch.bool, device=device))
    shape = (0, 2) if isinstance(dt, T.DecimalType) and dt.is_128 else (0,)
    return DeviceColumn(dt, validity, data=torch.zeros(
        shape, dtype=column_torch_dtype(dt), device=device))

"""Hash expressions — port of ``spark_rapids_tpu/expr/hashexprs.py``:
``hash()`` (Murmur3Hash), ``xxhash64()``, ``hive_hash()`` and the bloom
filter probe ``might_contain``.

Each hash chains its columns as Spark's HashExpression does (a column's
hash seeds the next, a null column passes the seed through) over the
column layouts of ``ops/hashing.py``, and is never null.

``BloomFilterMightContain`` probes a ``bloom_filter_agg`` result: an
array<long> of ``num_bits / 64`` words, bit ``b`` at bit ``b % 64``
(least significant first) of word ``b // 64``, set by double hashing,
``k = max(1, round(num_bits / num_items * ln 2))`` bits per value at
``remainder(h1 + j * h2, num_bits)`` for ``j < k``, with ``h1`` and
``h2`` the value's xxhash64 under seeds 42 and 77 (int64 arithmetic that
wraps, ``remainder`` taking the divisor's sign).  The layout is the
reference's, not Spark's serialized sketch.  The probe reads each row's
words through ``torch.gather``, so a filter that a one-row cross join
spread over every probe row as a stride-0 view is never copied.
"""
from __future__ import annotations

import math
from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expr.base import Expression
from spark_rapids_tpu_torch.ops.hashing import (hive_hash_columns,
                                                murmur3_columns,
                                                xxhash64_column,
                                                xxhash64_columns)

#: the seeds of a bloom filter's two hashes (the reference's)
BLOOM_SEEDS = (42, 77)


def bloom_hash_count(num_items: int, num_bits: int) -> int:
    """The bits a bloom filter sets per value."""
    return max(1, round(num_bits / num_items * math.log(2)))


def bloom_bit_indices(c: DeviceColumn, num_items: int, num_bits: int
                      ) -> List[torch.Tensor]:
    """Each row's ``k`` bit positions in a filter of ``num_bits`` bits
    (int64 in ``[0, num_bits)``), from its two xxhash64s."""
    seeds = [torch.full((c.capacity,), s, dtype=torch.int64,
                        device=c.device) for s in BLOOM_SEEDS]
    h1, h2 = (xxhash64_column(c, s) for s in seeds)
    return [torch.remainder(h1 + j * h2, num_bits)
            for j in range(bloom_hash_count(num_items, num_bits))]


class Murmur3Hash(Expression):
    """hash(c1, c2, ...) -> int32, never null (seed 42)."""

    def __init__(self, children: List[Expression], seed: int = 42):
        super().__init__(children)
        self.seed = seed

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        return DeviceColumn(T.INT, torch.ones_like(cols[0].validity),
                            data=murmur3_columns(cols, seed=self.seed))


class XxHash64(Expression):
    """xxhash64(c1, c2, ...) -> int64, never null (seed 42)."""

    def __init__(self, children: List[Expression], seed: int = 42):
        super().__init__(children)
        self.seed = seed

    def _resolve_type(self):
        self._dataType = T.LONG
        self._nullable = False

    def do_columnar_eval(self, ctx, cols):
        return DeviceColumn(T.LONG, torch.ones_like(cols[0].validity),
                            data=xxhash64_columns(cols, seed=self.seed))


class HiveHash(Expression):
    """hive_hash(c1, c2, ...) -> int32, never null:
    ``h = 31 * h + hash(ci)`` from 0."""

    def _resolve_type(self):
        self._dataType = T.INT
        self._nullable = False

    def sql_string(self):
        return ("hive_hash("
                + ", ".join(c.sql_string() for c in self.children) + ")")

    def do_columnar_eval(self, ctx, cols):
        return DeviceColumn(T.INT, torch.ones_like(cols[0].validity),
                            data=hive_hash_columns(cols))


class BloomFilterMightContain(Expression):
    """might_contain(bloom, value): whether every one of the value's bits
    is set in the row's filter (null where either input is); ``num_items``
    and ``num_bits`` must be the build's."""

    def __init__(self, bloom: Expression, value: Expression,
                 num_items: int = 4096, num_bits: int = 65536):
        super().__init__([bloom, value])
        self.num_items = int(num_items)
        self.num_bits = int(num_bits)

    def _resolve_type(self):
        self._dataType = T.BOOLEAN
        self._nullable = True

    def do_columnar_eval(self, ctx, cols):
        bloom, v = cols
        last = max(bloom.ewidth, 1) - 1
        hit = torch.ones_like(v.validity)
        for bit in bloom_bit_indices(v, self.num_items, self.num_bits):
            word = torch.gather(bloom.data, 1,
                                (bit // 64).clamp(0, last)[:, None])[:, 0]
            hit = hit & (((word >> (bit % 64)) & 1) == 1)
        return DeviceColumn(T.BOOLEAN, bloom.validity & v.validity,
                            data=hit)

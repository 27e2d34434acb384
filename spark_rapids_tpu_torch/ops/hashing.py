"""Spark-compatible murmur3 — port of the murmur3 half of
``spark_rapids_tpu/ops/hashing.py``.

Hash partitioning must give Spark's exact partition ids: ``pmod(murmur3(
keys, 42), numPartitions)``, column hashes chained through the seed, a
null passing the seed through unchanged.

torch has no uint32 arithmetic on the CPU, so every 32-bit word lives in an
int64 tensor holding its unsigned value in ``[0, 2**32)``:

* a multiply by a 32-bit constant is split into two 16-bit halves, so no
  product leaves int64 (``_mul32``);
* a right shift of a masked word is logical, since the word is
  non-negative;
* a rotate or left shift is masked back to 32 bits.

Ported types: int, long, date, byte, short, bool, float and double (-0.0
hashes as 0.0, every NaN as Java's canonical NaN) and decimals up to 18
digits (their unscaled long), and strings (their UTF-8 bytes, as Spark's
hashUnsafeBytes).  Decimals above 18 digits raise ``NotOnGpu``, as the
reference's plan rewrite refuses them; xxhash64 and Hive hash are not
ported yet.
"""
from __future__ import annotations

from typing import List

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.base import NotOnGpu

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_FLOAT_NAN_BITS = 0x7FC00000          # Java Float.floatToIntBits(NaN)
_DOUBLE_NAN_BITS = 0x7FF8000000000000  # Java Double.doubleToLongBits(NaN)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and a 32-bit constant c,
    without leaving int64: c's low and high 16-bit halves separately."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _mix_k1(k1):
    return _mul32(_rotl32(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (_mul32(h1, 5) + 0xE6546B64) & _M32


def _fmix(h1, length):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _hash_int_block(seed, block):
    """Spark's hashInt: one 4-byte block."""
    return _fmix(_mix_h1(seed, _mix_k1(block)), 4)


def _hash_long(seed, bits: torch.Tensor):
    """Spark's hashLong of int64 ``bits``: the low word, then the high."""
    low = bits & _M32
    high = (bits >> 32) & _M32      # arithmetic shift, masked: logical
    h = _mix_h1(seed, _mix_k1(low))
    h = _mix_h1(h, _mix_k1(high))
    return _fmix(h, 8)


def murmur3_column(c: DeviceColumn, seed: torch.Tensor) -> torch.Tensor:
    """Per-row murmur3 of ``c`` chained onto ``seed`` (int64 words in
    [0, 2**32)).  Null rows pass the seed through unchanged, as Spark's
    HashExpression does."""
    dt = c.dtype
    if c.is_string:
        h = _murmur3_string(c, seed)
    elif isinstance(dt, T.FloatType):
        f = c.data.to(torch.float32)
        f = torch.where(f == 0.0, torch.zeros_like(f), f)   # -0.0 -> 0.0
        bits = f.view(torch.int32).to(torch.int64) & _M32
        bits = torch.where(torch.isnan(f), _FLOAT_NAN_BITS, bits)
        h = _hash_int_block(seed, bits)
    elif isinstance(dt, T.DoubleType):
        d = c.data.to(torch.float64)
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
        bits = d.view(torch.int64)
        bits = torch.where(torch.isnan(d), _DOUBLE_NAN_BITS, bits)
        h = _hash_long(seed, bits)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = _hash_long(seed, c.data.to(torch.int64))
    elif isinstance(dt, T.DecimalType):
        # Spark hashes a decimal of up to 18 digits as its unscaled long;
        # above that as a BigInteger's bytes, which is not ported
        if dt.precision > 18:
            raise NotOnGpu("murmur3 of a decimal above 18 digits (the "
                           "BigInteger byte-array path)")
        h = _hash_long(seed, c.data.to(torch.int64))
    elif isinstance(dt, T.BooleanType):
        h = _hash_int_block(seed, c.data.to(torch.int64))
    elif isinstance(dt, (T.ByteType, T.ShortType, T.IntegerType,
                         T.DateType)):
        # sign-extended to 32 bits, as Java widens them to int
        h = _hash_int_block(seed, c.data.to(torch.int64) & _M32)
    else:
        raise NotOnGpu(f"murmur3 of {dt.simpleString}")
    return torch.where(c.validity, h, seed)


def _murmur3_string(c: DeviceColumn, seed: torch.Tensor) -> torch.Tensor:
    """Spark's hashUnsafeBytes of each row's UTF-8 bytes: the whole 4-byte
    little-endian blocks, then each tail byte as its own sign-extended
    block, then fmix with the byte length (the reference's
    ``_murmur3_string``, over the padded char matrix)."""
    w = c.width
    h = seed
    lengths = c.lengths.to(torch.int64)
    aligned = (lengths // 4) * 4
    ch = c.chars.to(torch.int64)
    for base in range(0, w - 3, 4):
        block = (ch[:, base] | (ch[:, base + 1] << 8)
                 | (ch[:, base + 2] << 16) | (ch[:, base + 3] << 24))
        h = torch.where(base + 4 <= aligned, _mix_h1(h, _mix_k1(block)), h)
    for t in range(min(3, w)):
        idx = aligned + t
        byte = torch.gather(ch, 1, idx.clamp(0, w - 1)[:, None])[:, 0]
        sbyte = torch.where(byte > 127, byte | 0xFFFFFF00, byte)
        h = torch.where(idx < lengths, _mix_h1(h, _mix_k1(sbyte)), h)
    return _fmix(h, lengths)


def murmur3_columns(cols: List[DeviceColumn], seed: int = 42
                    ) -> torch.Tensor:
    """Spark's Murmur3Hash(cols) as int32: the column hashes chained,
    starting at ``seed``."""
    c0 = cols[0]
    h = torch.full((c0.capacity,), seed & _M32, dtype=torch.int64,
                   device=c0.device)
    for c in cols:
        h = murmur3_column(c, h)
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def spark_partition_ids(cols: List[DeviceColumn], num_partitions: int,
                        seed: int = 42) -> torch.Tensor:
    """Spark's HashPartitioning: ``pmod(murmur3(keys), numPartitions)``
    (int64).  The sub-partitioned join passes another seed, so its buckets
    do not follow the exchange's partitions."""
    h = murmur3_columns(cols, seed=seed).to(torch.int64)
    return torch.remainder(h, num_partitions)

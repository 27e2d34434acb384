"""Spark-compatible murmur3, xxhash64 and Hive hash — port of
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
reference's plan rewrite refuses them.

xxhash64 (Spark's XxHash64, seed-chained per column as murmur3) keeps its
64-bit words in int64 tensors, since torch has no uint64 arithmetic:
adds and multiplies wrap mod 2**64 as unsigned ones do, and a right shift
or rotate masks off the bits the arithmetic shift copies from the sign
(``_lsr``).  It hashes the same types as murmur3, strings over the padded
layout (``_xxh_string``: the 32-byte stripes, then the 8-, 4- and 1-byte
tails of each row's length).  Hive hash (``h = 31 * h + hash(column)`` in
int32, a null column 0) hashes integers as themselves, a long or double
as ``v ^ (v >>> 32)``, a float's bits (NaN canonical; -0.0 is not folded,
as in the reference), a string as the polynomial of its signed bytes, and
a decimal as the low 32 bits of its unscaled value, as the reference's
CPU oracle does.
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


# -- xxhash64 ----------------------------------------------------------------

_M64 = (1 << 64) - 1


def _s64(x: int) -> int:
    """A 64-bit word as the int64 that holds its bits."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 words: the arithmetic shift with the
    copied sign bits masked off."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _lsr(x, 64 - r)


def _xxh_fmix(h):
    h = h ^ _lsr(h, 33)
    h = h * _P2
    h = h ^ _lsr(h, 29)
    h = h * _P3
    return h ^ _lsr(h, 32)


def _xxh_int(u32: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashInt of 32-bit patterns held in ``[0, 2**32)``."""
    h = seed + _s64(_P5 + 4)
    h = h ^ (u32 * _P1)
    h = _rotl64(h, 23) * _P2 + _P3
    return _xxh_fmix(h)


def _xxh_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashLong of int64 words."""
    h = seed + _s64(_P5 + 8)
    h = h ^ (_rotl64(v * _P2, 31) * _P1)
    h = _rotl64(h, 27) * _P1 + _P4
    return _xxh_fmix(h)


def _xxh_round(acc, k):
    return _rotl64(acc + k * _P2, 31) * _P1


def _le_word(ch: torch.Tensor, base: torch.Tensor, nbytes: int
             ) -> torch.Tensor:
    """Little-endian words of ``nbytes`` bytes at each row's ``base``
    (positions past the width read as its last byte; callers use only
    words inside the row's length)."""
    w = ch.shape[1]
    v = torch.zeros_like(base)
    for t in range(nbytes):
        idx = (base + t).clamp(0, w - 1)[:, None]
        v = v | (torch.gather(ch, 1, idx)[:, 0] << (8 * t))
    return v


def _xxh_string(c: DeviceColumn, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashUnsafeBytes of each row's UTF-8 bytes over the padded
    char matrix (the reference's ``_xxh_string``): a row of 32 bytes or
    more runs its whole 32-byte stripes through four accumulators, then
    every row takes its remaining 8-byte words, one 4-byte word and its
    last bytes."""
    w = c.width
    ch = c.chars.to(torch.int64)
    lengths = c.lengths.to(torch.int64)
    nstripes = lengths // 32
    acc = [seed + _s64(_P1 + _P2), seed + _P2, seed, seed - _P1]
    for b in range(w // 32):
        active = b < nstripes
        for j in range(4):
            base = 32 * b + 8 * j
            k = ch[:, base]
            for t in range(1, 8):
                k = k | (ch[:, base + t] << (8 * t))
            acc[j] = torch.where(active, _xxh_round(acc[j], k), acc[j])
    merged = (_rotl64(acc[0], 1) + _rotl64(acc[1], 7)
              + _rotl64(acc[2], 12) + _rotl64(acc[3], 18))
    for v in acc:
        merged = (merged ^ _xxh_round(torch.zeros_like(v), v)) * _P1 + _P4
    h = torch.where(lengths >= 32, merged, seed + _P5) + lengths
    if w == 0:
        return _xxh_fmix(h)
    base = nstripes * 32
    rem = lengths - base
    for j in range(3):
        k = _le_word(ch, base + 8 * j, 8)
        nh = _rotl64(h ^ _xxh_round(torch.zeros_like(k), k), 27) * _P1 + _P4
        h = torch.where((j + 1) * 8 <= rem, nh, h)
    o4 = base + (rem // 8) * 8
    has4 = lengths - o4 >= 4
    k4 = _le_word(ch, o4, 4)
    h = torch.where(has4, _rotl64(h ^ (k4 * _P1), 23) * _P2 + _P3, h)
    ob = o4 + torch.where(has4, 4, 0)
    for t in range(3):
        idx = ob + t
        byte = _le_word(ch, idx, 1)
        h = torch.where(idx < lengths, _rotl64(h ^ (byte * _P5), 11) * _P1,
                        h)
    return _xxh_fmix(h)


def xxhash64_column(c: DeviceColumn, seed: torch.Tensor) -> torch.Tensor:
    """Per-row xxhash64 of ``c`` chained onto ``seed`` (int64 words); a
    null row passes the seed through, as Spark's HashExpression does."""
    dt = c.dtype
    if c.is_string:
        h = _xxh_string(c, seed)
    elif isinstance(dt, T.FloatType):
        f = c.data.to(torch.float32)
        f = torch.where(f == 0.0, torch.zeros_like(f), f)
        bits = f.view(torch.int32).to(torch.int64) & _M32
        h = _xxh_int(torch.where(torch.isnan(f), _FLOAT_NAN_BITS, bits),
                     seed)
    elif isinstance(dt, T.DoubleType):
        d = c.data.to(torch.float64)
        d = torch.where(d == 0.0, torch.zeros_like(d), d)
        bits = d.view(torch.int64)
        h = _xxh_long(torch.where(torch.isnan(d), _DOUBLE_NAN_BITS, bits),
                      seed)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = _xxh_long(c.data.to(torch.int64), seed)
    elif isinstance(dt, T.DecimalType):
        if dt.precision > 18:
            raise NotOnGpu("xxhash64 of a decimal above 18 digits (the "
                           "BigInteger byte-array path)")
        h = _xxh_long(c.data.to(torch.int64), seed)
    elif isinstance(dt, (T.BooleanType, T.ByteType, T.ShortType,
                         T.IntegerType, T.DateType)):
        # the 32-bit pattern of the int Java widens them to
        h = _xxh_int(c.data.to(torch.int64) & _M32, seed)
    else:
        raise NotOnGpu(f"xxhash64 of {dt.simpleString}")
    return torch.where(c.validity, h, seed)


def xxhash64_columns(cols: List[DeviceColumn], seed: int = 42
                     ) -> torch.Tensor:
    """Spark's XxHash64(cols) as int64: the column hashes chained,
    starting at ``seed``."""
    c0 = cols[0]
    h = torch.full((c0.capacity,), _s64(seed), dtype=torch.int64,
                   device=c0.device)
    for c in cols:
        h = xxhash64_column(c, h)
    return h


# -- Hive hash ----------------------------------------------------------------

def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 ``x`` as int32."""
    return (((x & _M32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _fold_long(v: torch.Tensor) -> torch.Tensor:
    """Java's ``(int) (v ^ (v >>> 32))``."""
    return _to_i32(v ^ _lsr(v, 32))


def hive_hash_column(c: DeviceColumn) -> torch.Tensor:
    """Per-row Hive hash of one column (int32); a null row hashes 0."""
    dt = c.dtype
    if c.is_string:
        ch = c.chars.to(torch.int64)
        sbytes = torch.where(ch >= 128, ch - 256, ch)    # Java bytes
        lengths = c.lengths.to(torch.int64)
        h = torch.zeros_like(lengths)
        for i in range(c.width):
            h = torch.where(i < lengths, (h * 31 + sbytes[:, i]) & _M32, h)
        h = _to_i32(h)
    elif isinstance(dt, (T.LongType, T.TimestampType)):
        h = _fold_long(c.data.to(torch.int64))
    elif isinstance(dt, T.FloatType):
        f = c.data.to(torch.float32)
        bits = f.view(torch.int32)
        h = torch.where(torch.isnan(f), _FLOAT_NAN_BITS, bits)
    elif isinstance(dt, T.DoubleType):
        d = c.data.to(torch.float64)
        bits = torch.where(torch.isnan(d), _DOUBLE_NAN_BITS,
                           d.view(torch.int64))
        h = _fold_long(bits)
    elif isinstance(dt, T.DecimalType):
        h = _to_i32(c.data[:, 1] if dt.is_128 else c.data.to(torch.int64))
    else:                       # boolean, byte, short, int, date
        h = c.data.to(torch.int32)
    return torch.where(c.validity, h.to(torch.int32), 0)


def hive_hash_columns(cols: List[DeviceColumn]) -> torch.Tensor:
    """HiveHash(cols): ``h = 31 * h + hash(column)`` in int32 from 0."""
    h = torch.zeros(cols[0].capacity, dtype=torch.int64,
                    device=cols[0].device)
    for c in cols:
        h = (h * 31 + hive_hash_column(c).to(torch.int64)) & _M32
    return _to_i32(h)


def spark_partition_ids(cols: List[DeviceColumn], num_partitions: int,
                        seed: int = 42) -> torch.Tensor:
    """Spark's HashPartitioning: ``pmod(murmur3(keys), numPartitions)``
    (int64).  The sub-partitioned join passes another seed, so its buckets
    do not follow the exchange's partitions."""
    h = murmur3_columns(cols, seed=seed).to(torch.int64)
    return torch.remainder(h, num_partitions)

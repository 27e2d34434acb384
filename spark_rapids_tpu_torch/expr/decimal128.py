"""128-bit decimal limb arithmetic — port of ``spark_rapids_tpu/expr/decimal128.py``.

A decimal with precision > 18 is a two-limb value ``(hi, lo)``: ``hi`` holds
the signed high 64 bits and ``lo`` the unsigned low 64 bits as an int64 bit
pattern.  Every limb operation is wrapping int64 tensor arithmetic, which
torch performs the same way on the CPU and on CUDA, so the functions are
the reference's line for line with ``jnp`` replaced by ``torch``.

Column storage packs the limbs as ``data`` of shape ``(n, 2)`` with
``data[:, 0] = hi`` and ``data[:, 1] = lo``.

Sums split each value into 32-bit limbs, so up to 2^31 rows accumulate in
int64 without overflow, with a sign-extension limb that makes the
reconstruction exact past 2^128.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_SIGN64 = -0x8000000000000000   # 1 << 63 bit

Pair = Tuple[torch.Tensor, torch.Tensor]


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned < on int64 bit patterns."""
    return (a ^ _SIGN64) < (b ^ _SIGN64)


def from64(x: torch.Tensor) -> Pair:
    """Sign-extend an int64 unscaled value to (hi, lo)."""
    x = x.to(torch.int64)
    return x >> 63, x


def pack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) -> (n, 2) column storage."""
    return torch.stack([hi, lo], dim=-1)


def unpack(data: torch.Tensor) -> Pair:
    """(n, 2) column storage -> (hi, lo)."""
    return data[..., 0], data[..., 1]


def to_py(hi: int, lo: int) -> int:
    """Host-side: limbs -> arbitrary-precision python int."""
    return (int(hi) << 64) | (int(lo) & 0xFFFFFFFFFFFFFFFF)


def limbs_of(v: int) -> Tuple[int, int]:
    """Host-side: python int -> (hi, lo) int64 bit patterns."""
    masked = v & ((1 << 128) - 1)
    lo = masked & 0xFFFFFFFFFFFFFFFF
    hi = (masked >> 64) & 0xFFFFFFFFFFFFFFFF
    if lo >= 1 << 63:
        lo -= 1 << 64
    if hi >= 1 << 63:
        hi -= 1 << 64
    return hi, lo


def add128(ah, al, bh, bl) -> Pair:
    lo = al + bl                       # wraps mod 2^64
    carry = ult(lo, al).to(torch.int64)
    return ah + bh + carry, lo


def neg128(h, l) -> Pair:
    return -h - (l != 0).to(torch.int64), -l


def sub128(ah, al, bh, bl) -> Pair:
    nh, nl = neg128(bh, bl)
    return add128(ah, al, nh, nl)


def is_neg(h, l) -> torch.Tensor:
    return h < 0


def abs128(h, l) -> Pair:
    nh, nl = neg128(h, l)
    n = is_neg(h, l)
    return torch.where(n, nh, h), torch.where(n, nl, l)


def eq128(ah, al, bh, bl) -> torch.Tensor:
    return (ah == bh) & (al == bl)


def lt128(ah, al, bh, bl) -> torch.Tensor:
    """Signed 128-bit <."""
    return (ah < bh) | ((ah == bh) & ult(al, bl))


def umulhi64(a, b) -> torch.Tensor:
    """High 64 bits of the unsigned 64x64 product (int64 bit patterns).
    The 32x32 partial products wrap int64 on purpose; only their low and
    high 32-bit halves are used."""
    a0 = a & _M32
    a1 = (a >> 32) & _M32
    b0 = b & _M32
    b1 = (b >> 32) & _M32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = ((p00 >> 32) & _M32) + (p01 & _M32) + (p10 & _M32)
    return (p11 + ((p01 >> 32) & _M32) + ((p10 >> 32) & _M32)
            + ((mid >> 32) & _M32))


def mul64_to_128(a, b) -> Pair:
    """Signed 64x64 -> exact signed 128-bit product."""
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    lo = a * b                         # low 64 bits, signed == unsigned
    uhi = umulhi64(a, b)
    zero = torch.zeros_like(a)
    # signed correction: mulhs = umulh - (a<0 ? b : 0) - (b<0 ? a : 0)
    hi = uhi - torch.where(a < 0, b, zero) - torch.where(b < 0, a, zero)
    return hi, lo


def umul128_by_u32(h, l, m: int):
    """Unsigned 128-bit value times a uint32 scalar -> (carry, hi, lo);
    ``carry`` (bits 128..159) is zero iff the product fits 128 bits."""
    l0 = l & _M32
    l1 = (l >> 32) & _M32
    h0 = h & _M32
    h1 = (h >> 32) & _M32
    p0 = l0 * m
    p1 = l1 * m + ((p0 >> 32) & _M32)
    p2 = h0 * m + ((p1 >> 32) & _M32)
    p3 = h1 * m + ((p2 >> 32) & _M32)
    lo = (p0 & _M32) | (p1 << 32)
    hi = (p2 & _M32) | (p3 << 32)
    carry = (p3 >> 32) & _M32
    return carry, hi, lo


_POW10_32 = [10 ** k for k in range(10)]   # fits uint32 up to 10^9


def mul128_pow10(h, l, k: int):
    """Signed 128 x 10^k -> (overflowed, hi, lo); k is a python int."""
    if k == 0:
        return torch.zeros_like(h, dtype=torch.bool), h, l
    neg = is_neg(h, l)
    uh, ul = abs128(h, l)
    over = torch.zeros_like(h, dtype=torch.bool)
    kk = k
    while kk > 0:
        step = min(kk, 9)
        carry, uh, ul = umul128_by_u32(uh, ul, _POW10_32[step])
        over = over | (carry != 0)
        kk -= step
    over = over | (uh < 0)             # magnitude crossed into the sign bit
    rh, rl = neg128(uh, ul)
    return over, torch.where(neg, rh, uh), torch.where(neg, rl, ul)


def udivmod128_by_u32(h, l, d: int):
    """Unsigned 128-bit // d -> (qhi, qlo, rem) for 1 <= d <= 2^31-1:
    long division over four 32-bit limbs; every partial remainder fits a
    signed int64."""
    limbs = [(h >> 32) & _M32, h & _M32, (l >> 32) & _M32, l & _M32]
    q = []
    rem = torch.zeros_like(h)
    for limb in limbs:
        cur = (rem << 32) | limb
        q.append(torch.div(cur, d, rounding_mode="floor"))
        rem = cur - q[-1] * d
    return (q[0] << 32) | q[1], (q[2] << 32) | q[3], rem


_U31 = 1 << 31


def _udivmod128_bits(h, l, d):
    """Unsigned 128-bit // d -> (qhi, qlo, rem) for a per-row int64 ``d``
    in [1, 2^63): restoring division, one quotient bit a step (the
    partial remainder, below 2^64, is compared unsigned)."""
    rem = torch.zeros_like(h)
    qh = torch.zeros_like(h)
    ql = torch.zeros_like(h)
    for word, is_hi in ((h, True), (l, False)):
        for bit in range(63, -1, -1):
            rem = (rem << 1) | ((word >> bit) & 1)
            ge = ~ult(rem, d)
            rem = torch.where(ge, rem - d, rem)
            q = ge.to(torch.int64) << bit
            if is_hi:
                qh = qh | q
            else:
                ql = ql | q
    return qh, ql, rem


def udivmod128_by_u64(h, l, d):
    """Unsigned 128-bit // d -> (qhi, qlo, rem) for a per-row int64 ``d``
    in [1, 2^63): the four-limb long division where every ``d`` is below
    2^31 (one host sync decides), else the bit-by-bit division for all
    rows."""
    from spark_rapids_tpu_torch.perfcounters import sync_get

    big = d >= _U31
    (any_big,) = sync_get(big.any())
    if not bool(any_big):
        return udivmod128_by_u32(h, l, d)
    return _udivmod128_bits(h, l, d)


def div128_by_count_half_up(h, l, n, shift: int):
    """Signed 128-bit ``(h, l)`` / a per-row count ``n`` (>= 1), scaled by
    10^shift and rounded HALF_UP (Spark's decimal ``avg``) -> (overflowed,
    hi, lo).  Exact for every count below 2^63: the quotient, then the
    remainder times 10^shift divided again."""
    neg = is_neg(h, l)
    uh, ul = abs128(h, l)
    qh, ql, rem = udivmod128_by_u64(uh, ul, n)
    over, qh, ql = mul128_pow10(qh, ql, shift)
    nh, nl = mul64_to_128(rem, torch.full_like(rem, 10 ** shift))
    _, eq, er = udivmod128_by_u64(nh, nl, n)
    # HALF_UP: 2 * er >= n, asked without doubling er
    eq = eq + (er >= n - er).to(torch.int64)
    qh, ql = add128(qh, ql, *from64(eq))
    over = over | (qh < 0)
    rh, rl = neg128(qh, ql)
    return over, torch.where(neg, rh, qh), torch.where(neg, rl, ql)


def mul128_checked(ah, al, bh, bl):
    """Signed 128 x 128 -> (overflowed, hi, lo): exact where the product
    fits signed 128 bits, ``overflowed`` elsewhere (a CPU stage's decimal
    multiply with an operand above 18 digits).  One operand's magnitude
    must fit 64 bits; the other's high word times it must not carry."""
    neg = is_neg(ah, al) ^ is_neg(bh, bl)
    xh, xl = abs128(ah, al)
    yh, yl = abs128(bh, bl)
    # |MIN| stays negative; both magnitudes past 2^64 cannot fit
    over = (xh < 0) | (yh < 0) | ((xh != 0) & (yh != 0))
    swap = xh == 0
    bh_, bl_ = torch.where(swap, yh, xh), torch.where(swap, yl, xl)
    m = torch.where(swap, xl, yl)              # the 64-bit magnitude
    lo = bl_ * m
    hi1 = umulhi64(bl_, m)
    over = over | (umulhi64(bh_, m) != 0)
    hi = hi1 + bh_ * m
    over = over | ult(hi, hi1) | (hi < 0)
    rh, rl = neg128(hi, lo)
    return over, torch.where(neg, rh, hi), torch.where(neg, rl, lo)


def div128_pow10_trunc(h, l, k: int) -> Pair:
    """Signed 128 / 10^k truncating toward zero."""
    if k == 0:
        return h, l
    neg = is_neg(h, l)
    uh, ul = abs128(h, l)
    kk = k
    while kk > 0:
        step = min(kk, 9)
        uh, ul, _ = udivmod128_by_u32(uh, ul, _POW10_32[step])
        kk -= step
    rh, rl = neg128(uh, ul)
    return torch.where(neg, rh, uh), torch.where(neg, rl, ul)


def div128_pow10_half_up(h, l, k: int) -> Pair:
    """Signed 128 / 10^k with HALF_UP rounding (Spark decimal scale change)."""
    if k == 0:
        return h, l
    neg = is_neg(h, l)
    uh0, ul0 = abs128(h, l)
    uh, ul = uh0, ul0
    kk = k
    while kk > 0:
        step = min(kk, 9)
        uh, ul, _ = udivmod128_by_u32(uh, ul, _POW10_32[step])
        kk -= step
    # exact remainder: rem = |v| - q * 10^k; round away from zero when
    # rem >= 10^k / 2 (compared with the halved divisor, not 2*rem, which
    # would overflow signed 128 bits at k=38)
    _, qph, qpl = mul128_pow10(uh, ul, k)
    rem_h, rem_l = sub128(uh0, ul0, qph, qpl)
    bh_, bl_ = limbs_of(10 ** k // 2)
    round_up = ~lt128(rem_h, rem_l, torch.full_like(h, bh_),
                      torch.full_like(l, bl_))
    uh, ul = add128(uh, ul, torch.zeros_like(h), round_up.to(torch.int64))
    rh, rl = neg128(uh, ul)
    return torch.where(neg, rh, uh), torch.where(neg, rl, ul)


def bound128(precision: int) -> Tuple[int, int]:
    """(hi, lo) limbs of 10^precision (the exclusive overflow bound)."""
    return limbs_of(10 ** precision)


def in_bounds(h, l, precision: int) -> torch.Tensor:
    """|value| < 10^precision."""
    bh, bl = bound128(precision)
    ah, al = abs128(h, l)
    return lt128(ah, al, torch.full_like(h, bh), torch.full_like(l, bl))


def _limbs32(h, l):
    """Two's-complement 128-bit -> four 32-bit value limbs plus one 32-bit
    sign-extension limb, each an int64 vector."""
    return (l & _M32, (l >> 32) & _M32, h & _M32, (h >> 32) & _M32,
            torch.where(h < 0, _M32, 0).to(torch.int64))


def _recombine(sums):
    """Limb sums -> (ok, hi, lo); ``ok`` is False where the true sum does
    not fit in signed 128 bits."""
    s0, s1, s2, s3, s4 = sums
    c0 = s0
    r0 = c0 & _M32
    c1 = s1 + ((c0 >> 32) & _M32)
    r1 = c1 & _M32
    c2 = s2 + ((c1 >> 32) & _M32)
    r2 = c2 & _M32
    c3 = s3 + ((c2 >> 32) & _M32)
    r3 = c3 & _M32
    # limbs 4 and 5 both receive every row's sign mask; the result must be
    # pure sign extension of its own sign
    c4 = s4 + ((c3 >> 32) & _M32)
    r4 = c4 & _M32
    c5 = s4 + ((c4 >> 32) & _M32)
    r5 = c5 & _M32
    lo = r0 | (r1 << 32)
    hi = r2 | (r3 << 32)
    sign_limb = torch.where(hi < 0, _M32, 0).to(torch.int64)
    ok = (r4 == sign_limb) & (r5 == sign_limb)
    return ok, hi, lo


def sum128_global(h, l, validity):
    """Masked global sum -> (ok, any_valid, hi, lo), each of shape (1,).
    Exact for up to 2^31 rows."""
    sums = [torch.where(validity, x, 0).sum(dim=0, keepdim=True)
            for x in _limbs32(h, l)]
    ok, hi, lo = _recombine(sums)
    any_valid = validity.sum(dim=0, keepdim=True) > 0
    return ok, any_valid, hi, lo


def sum128_segments(h, l, validity, seg_ids, num_segments: int):
    """Masked segmented sum -> (ok, any_valid, hi, lo) per segment."""
    if num_segments == 1:
        return sum128_global(h, l, validity)

    def seg_sum(x):
        return torch.zeros(num_segments, dtype=torch.int64,
                           device=h.device).index_add_(0, seg_ids, x)

    ok, hi, lo = _recombine([seg_sum(torch.where(validity, x, 0))
                             for x in _limbs32(h, l)])
    return ok, seg_sum(validity.to(torch.int64)) > 0, hi, lo


def key_words(h, l) -> Pair:
    """Sort-key words: ``hi`` signed, ``lo`` rebased to signed; their
    lexicographic signed order is the signed 128-bit order."""
    return h, l ^ _SIGN64


def column_limbs(c) -> Pair:
    """Any decimal column -> (hi, lo): unpack two-limb storage or
    sign-extend 64-bit storage."""
    if c.is_dec128:
        return unpack(c.data)
    return from64(c.data)

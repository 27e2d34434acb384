"""Cast — port of ``spark_rapids_tpu/expr/cast.py``, its whole dispatch
table (``_CASTS``):

  * integral widening/narrowing (narrowing wraps, Java semantics; ANSI
    raises on a value out of range);
  * integral <-> floating point, boolean <-> numeric; floating point ->
    integral truncates, NaN is 0, and the value saturates at the long
    range before a narrowing wrap, by explicit comparisons (torch's
    conversion of NaN, an infinity or a value past 2^63 differs between
    the CPU and CUDA);
  * decimal rescale (HALF_UP; overflow -> null, or an error under ANSI),
    integral -> decimal, decimal -> integral (truncating) and decimal ->
    floating point, on the int64 path and on the 128-bit limb path;
    floating point -> decimal on the int64 path;
  * DATE <-> TIMESTAMP, TIMESTAMP <-> LONG (seconds, floored), NULL -> any;
  * integral, boolean, decimal (up to 18 digits), DATE and TIMESTAMP ->
    string: digit decomposition as torch ops on the column's device, on
    non-positive int64 values so that Long.MIN_VALUE needs no uint64;
  * string -> integral, boolean, DATE and TIMESTAMP: trim and parse as
    masked torch ops over the char matrix; the DATE and TIMESTAMP parses
    share the reference's variable-width civil parser (``_FieldCursor``,
    Spark's stringToTimestamp subset, named zones invalid);
  * floating point <-> string: host code, value by value, as the
    reference's host kernels (Java's shortest repr; Java's
    ``Double.parseDouble`` grammar), the result moved back to the
    column's device.

The reference's first ``_string_to_date`` (fixed ``yyyy-MM-dd``) is not
copied: its table entry is replaced by ``_string_to_date_v2`` at import.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    _fit_chars,
                                                    column_torch_dtype)
from spark_rapids_tpu_torch.expr.base import EvalContext, UnaryExpression

_INTEGRAL = (T.ByteType, T.ShortType, T.IntegerType, T.LongType)


# -- civil-calendar day math (reference ``expr/cast.py:43-65``) -------------

def _fdiv(a, b):
    """Floor division, as ``jnp.floor_divide`` (days before 1970 are
    negative)."""
    return torch.div(a, b, rounding_mode="floor")


def civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day) int64 tensors; Howard
    Hinnant's algorithm, branch-free, proleptic Gregorian."""
    z = days.to(torch.int64) + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def days_from_civil(y: torch.Tensor, m: torch.Tensor, d: torch.Tensor):
    """(year, month, day) -> days since 1970-01-01 (int64)."""
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = _fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).to(torch.int64)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _kind(t: T.DataType) -> str:
    if isinstance(t, T.DecimalType):
        return "dec"
    if isinstance(t, (T.FloatType, T.DoubleType)):
        return "fp"
    if isinstance(t, _INTEGRAL):
        return "int"
    if isinstance(t, T.BooleanType):
        return "bool"
    if isinstance(t, T.StringType):
        return "str"
    if isinstance(t, T.DateType):
        return "date"
    if isinstance(t, T.TimestampType):
        return "ts"
    if isinstance(t, T.NullType):
        return "null"
    return "?"


def _dispatch(src: T.DataType, dst: T.DataType):
    """The cast function for ``src`` -> ``dst``, or None (the reference's
    ``_dispatch``)."""
    return _CASTS.get((_kind(src), _kind(dst)))


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    """The casts the port runs, on the device and in a CPU stage: the
    reference's table (``GpuCast.canCast``)."""
    return src == dst or _dispatch(src, dst) is not None


class Cast(UnaryExpression):
    def __init__(self, child, to: T.DataType, ansi: bool = False):
        super().__init__(child)
        self.to = to
        self._dataType = to
        self.ansi_override = ansi

    def sql_string(self):
        return f"CAST({self.child.sql_string()} AS {self.to.simpleString})"

    def _resolve_type(self):
        self._dataType = self.to
        self._nullable = True

    def resolve(self, schema):
        if schema is not None and not self.child.resolved:
            self.children = [self.child.resolve(schema)]
        self._resolve_type()
        self.resolved = True
        return self

    def do_columnar_eval(self, ctx: EvalContext, cols):
        c = cols[0]
        src, dst = self.child.dataType, self.to
        ansi = ctx.ansi or self.ansi_override
        if src == dst:
            return c
        fn = _dispatch(src, dst)
        if fn is None:
            raise TypeError(f"cast {src} -> {dst} is not ported yet")
        return fn(ctx, c, src, dst, ansi)


_I_MIN = {T.ByteType: -(2 ** 7), T.ShortType: -(2 ** 15),
          T.IntegerType: -(2 ** 31), T.LongType: -(2 ** 63)}
_I_MAX = {T.ByteType: 2 ** 7 - 1, T.ShortType: 2 ** 15 - 1,
          T.IntegerType: 2 ** 31 - 1, T.LongType: 2 ** 63 - 1}


def _int_to_int(ctx, c, src, dst, ansi):
    narrowing = (_I_MIN[type(dst)] > _I_MIN[type(src)]
                 or _I_MAX[type(dst)] < _I_MAX[type(src)])
    if ansi and narrowing:
        bad = (c.data < _I_MIN[type(dst)]) | (c.data > _I_MAX[type(dst)])
        ctx.add_error(bad & c.validity, f"cast overflow to {dst} (ANSI)")
    # narrowing wraps, Java semantics
    return DeviceColumn(dst, c.validity,
                        data=c.data.to(column_torch_dtype(dst)))


def _p10(k):
    return 10 ** int(min(max(k, 0), 18))


def _dec_rescale(ctx, data, validity, from_scale, to: T.DecimalType, ansi,
                 op):
    from spark_rapids_tpu_torch.expr.arithmetic import _decimal_bound_check

    diff = to.scale - from_scale
    if diff >= 0:
        out = data * _p10(diff)
    else:
        den = _p10(-diff)
        q = torch.div(data, den, rounding_mode="trunc")
        rem = data - q * den
        round_away = rem.abs() * 2 >= den
        out = q + torch.where(round_away, torch.sign(data),
                              torch.zeros_like(data))
    validity = _decimal_bound_check(ctx, out, to, validity, ansi, op)
    return out, validity


def _dec128_rescale(ctx, hi, lo, validity, from_scale, dst: T.DecimalType,
                    ansi, op):
    """(hi, lo) at from_scale -> dst scale/precision; 128-bit limb path."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    diff = dst.scale - from_scale
    over = torch.zeros_like(validity)
    if diff >= 0:
        over, hi, lo = D.mul128_pow10(hi, lo, diff)
    else:
        hi, lo = D.div128_pow10_half_up(hi, lo, -diff)
    ok = D.in_bounds(hi, lo, dst.precision) & ~over
    if ansi:
        ctx.add_error(~ok & validity, f"decimal {op} overflow (ANSI)")
    else:
        validity = validity & ok
    return hi, lo, validity


def _dec_to_dec(ctx, c, src: T.DecimalType, dst: T.DecimalType, ansi):
    if not src.is_128 and not dst.is_128:
        data, validity = _dec_rescale(ctx, c.data, c.validity, src.scale,
                                      dst, ansi, "cast")
        return DeviceColumn(dst, validity, data=data)
    from spark_rapids_tpu_torch.expr import decimal128 as D

    hi, lo = D.column_limbs(c)
    hi, lo, validity = _dec128_rescale(ctx, hi, lo, c.validity, src.scale,
                                       dst, ansi, "cast")
    if dst.is_128:
        return DeviceColumn(dst, validity, data=D.pack(hi, lo))
    # narrowing: the bound check guarantees |v| < 10^18, so lo IS the value
    return DeviceColumn(dst, validity, data=lo)


def _int_to_dec(ctx, c, src, dst: T.DecimalType, ansi):
    data = c.data.to(torch.int64)
    if dst.is_128:
        from spark_rapids_tpu_torch.expr import decimal128 as D

        hi, lo = D.from64(data)
        hi, lo, validity = _dec128_rescale(ctx, hi, lo, c.validity, 0, dst,
                                           ansi, "cast")
        return DeviceColumn(dst, validity, data=D.pack(hi, lo))
    data, validity = _dec_rescale(ctx, data, c.validity, 0, dst, ansi,
                                  "cast")
    return DeviceColumn(dst, validity, data=data)


def _tdt(dt: T.DataType) -> torch.dtype:
    return column_torch_dtype(dt)


def _int_to_fp(ctx, c, src, dst, ansi):
    return DeviceColumn(dst, c.validity, data=c.data.to(_tdt(dst)))


_LMAX_F = 9.223372036854775808e18      # 2^63 exactly as a double


def long_of_double(x: torch.Tensor) -> torch.Tensor:
    """Java's ``(long) trunc(x)`` of a double tensor: NaN is 0, a value at
    or past 2^63 saturates; by comparisons, never by converting a value
    out of range."""
    x = x.to(torch.float64)
    nan = torch.isnan(x)
    tr = torch.trunc(torch.where(nan, torch.zeros_like(x), x))
    hi = tr >= _LMAX_F
    lo = tr < -_LMAX_F
    safe = torch.where(hi | lo, torch.zeros_like(tr), tr).to(torch.int64)
    return torch.where(hi, _I_MAX[T.LongType],
                       torch.where(lo, _I_MIN[T.LongType], safe))


def _fp_to_int(ctx, c, src, dst, ansi):
    mn, mx = _I_MIN[type(dst)], _I_MAX[type(dst)]
    x = c.data.to(torch.float64)
    if ansi:
        tr = torch.trunc(x)
        bad = torch.isnan(x) | (tr < mn) | (tr > mx)
        ctx.add_error(bad & c.validity, f"cast overflow to {dst} (ANSI)")
    # Java: (long) saturates, then a narrowing wraps
    return DeviceColumn(dst, c.validity,
                        data=long_of_double(x).to(_tdt(dst)))


def _fp_to_fp(ctx, c, src, dst, ansi):
    return DeviceColumn(dst, c.validity, data=c.data.to(_tdt(dst)))


def _num_to_bool(ctx, c, src, dst, ansi):
    return DeviceColumn(dst, c.validity, data=c.data != 0)


def _bool_to_num(ctx, c, src, dst, ansi):
    return DeviceColumn(dst, c.validity, data=c.data.to(_tdt(dst)))


def _p10_tensor(k: int, like: torch.Tensor) -> torch.Tensor:
    """10^k as a float64 tensor on ``like``'s device: CUDA divides by a
    Python scalar as a multiply by its reciprocal, by a tensor exactly."""
    return torch.full_like(like, 10.0 ** k, dtype=torch.float64)


def _dec_to_int(ctx, c, src: T.DecimalType, dst, ansi):
    mn, mx = _I_MIN[type(dst)], _I_MAX[type(dst)]
    if src.is_128:
        from spark_rapids_tpu_torch.expr import decimal128 as D

        hi, lo = D.unpack(c.data)
        qh, ql = D.div128_pow10_trunc(hi, lo, src.scale)
        fits64 = qh == (ql >> 63)          # pure sign extension
        bad = ~fits64 | (ql < mn) | (ql > mx)
        q = ql
    else:
        q = torch.div(c.data, _p10(src.scale), rounding_mode="trunc")
        bad = (q < mn) | (q > mx)
    if ansi:
        ctx.add_error(bad & c.validity, f"cast overflow to {dst} (ANSI)")
        validity = c.validity
    else:
        validity = c.validity & ~bad
    return DeviceColumn(dst, validity, data=q.to(_tdt(dst)))


def unscaled_double(c: DeviceColumn) -> torch.Tensor:
    """A decimal128 column's unscaled values as doubles: ``hi * 2^64 +
    lo``, ``lo`` read unsigned."""
    from spark_rapids_tpu_torch.expr import decimal128 as D

    hi, lo = D.unpack(c.data)
    lo_f = lo.to(torch.float64)
    lo_u = torch.where(lo < 0, lo_f + 18446744073709551616.0, lo_f)
    return hi.to(torch.float64) * 18446744073709551616.0 + lo_u


def _dec_to_fp(ctx, c, src: T.DecimalType, dst, ansi):
    val = unscaled_double(c) if src.is_128 else c.data.to(torch.float64)
    data = val / _p10_tensor(src.scale, val)
    return DeviceColumn(dst, c.validity, data=data.to(_tdt(dst)))


def _fp_to_dec(ctx, c, src, dst: T.DecimalType, ansi):
    """The int64 layout only (the tagging keeps a DOUBLE -> decimal above
    18 digits off the device, as the reference's ``_check_cast``): the
    double times 10^scale, rounded half to even as the reference's
    ``jnp.round`` (ROADMAP Queue 3, R12), NaN and infinities null."""
    from spark_rapids_tpu_torch.expr.arithmetic import _decimal_bound_check

    scaled = c.data.to(torch.float64) * float(_p10(dst.scale))
    nan = torch.isnan(scaled) | torch.isinf(scaled)
    r = torch.round(torch.where(nan, torch.zeros_like(scaled), scaled))
    # |r| at or past 2^63 cannot convert; it is past every precision
    big = r.abs() >= _LMAX_F
    data = torch.where(big, torch.zeros_like(r), r).to(torch.int64)
    validity = c.validity & ~nan
    if ansi:
        ctx.add_error(nan & c.validity, "cast NaN/Inf to decimal (ANSI)")
    validity = _decimal_bound_check(ctx, data, dst, validity, ansi, "cast",
                                    extra_invalid=big)
    return DeviceColumn(dst, validity, data=data)


_US_PER_DAY = 86_400_000_000


def _date_to_ts(ctx, c, src, dst, ansi):
    return DeviceColumn(T.TIMESTAMP, c.validity,
                        data=c.data.to(torch.int64) * _US_PER_DAY)


def _ts_to_date(ctx, c, src, dst, ansi):
    return DeviceColumn(T.DATE, c.validity,
                        data=_fdiv(c.data, _US_PER_DAY).to(torch.int32))


def _ts_to_long(ctx, c, src, dst, ansi):
    return DeviceColumn(dst, c.validity,
                        data=_fdiv(c.data, 1_000_000).to(_tdt(dst)))


def _long_to_ts(ctx, c, src, dst, ansi):
    return DeviceColumn(T.TIMESTAMP, c.validity,
                        data=c.data.to(torch.int64) * 1_000_000)


def _null_to_any(ctx, c, src, dst, ansi):
    """Every row null, in ``dst``'s layout."""
    n, dev = c.capacity, c.device
    valid = torch.zeros(n, dtype=torch.bool, device=dev)
    if isinstance(dst, T.DecimalType) and dst.is_128:
        return DeviceColumn(dst, valid, data=torch.zeros(
            n, 2, dtype=torch.int64, device=dev))
    if isinstance(dst, T.StringType):
        return DeviceColumn(dst, valid, chars=torch.zeros(
            n, 8, dtype=torch.uint8, device=dev), lengths=torch.zeros(
            n, dtype=torch.int32, device=dev))
    return DeviceColumn(dst, valid, data=torch.zeros(
        n, dtype=_tdt(dst), device=dev))


# -- string -> double, for avg and the variance family over a string ----------

def spark_string_to_double(s: str):
    """Spark's cast(string as double), a copy of the reference's
    ``spark_string_to_double``: the trimmed Java ``Double.parseDouble``
    grammar; None for input Spark reads as invalid.  Python-only syntax
    that Java rejects (digit underscores, the bare 'inf'/'-inf') is
    rejected; Java's trailing d/f suffix is accepted."""
    t = s.strip()
    if not t or "_" in t:
        return None
    low = t.lower()
    if low.lstrip("+-") in ("inf",):
        return None              # Java wants 'Infinity'
    if low and low[-1] in "df" and any(ch.isdigit() for ch in low[:-1]) \
            and "x" not in low:
        t = t[:-1]               # Java FP suffix
    try:
        return float(t)
    except ValueError:
        return None


def _parse_doubles(c: DeviceColumn):
    """A string column parsed to doubles on the host, row by row, with
    ``spark_string_to_double``: (values, parsed, bad) tensors on the
    column's device; ``bad`` marks a valid row that does not parse."""
    valid = c.validity.cpu().numpy()
    lengths = c.lengths.cpu().numpy()
    chars = c.chars.cpu().numpy()
    n = len(valid)
    vals = [0.0] * n
    ok = [False] * n
    bad = [False] * n
    for i in range(n):
        if not valid[i]:
            continue
        f = spark_string_to_double(
            bytes(chars[i, :lengths[i]]).decode("utf-8", "replace"))
        if f is None:
            bad[i] = True
        else:
            vals[i], ok[i] = f, True
    dev = c.validity.device
    return (torch.tensor(vals, dtype=torch.float64, device=dev),
            torch.tensor(ok, dtype=torch.bool, device=dev),
            torch.tensor(bad, dtype=torch.bool, device=dev))


def strings_to_double(c: DeviceColumn, ansi: bool) -> DeviceColumn:
    """A string column parsed to doubles on the host, row by row, as the
    reference's ``_string_to_fp`` host kernel parses: a string that does
    not parse is null, or under ANSI an error in the reference's words.
    The result lies on the column's device."""
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException

    vals, ok, bad = _parse_doubles(c)
    if ansi and bool(bad.any()):
        raise SparkArithmeticException(
            "invalid input syntax for type numeric (ANSI)")
    return DeviceColumn(T.DOUBLE, ok, data=vals)


# -- to string (digit decomposition on the device) ---------------------------

_MAX_I64_DIGITS = 19


def _digits_of(vneg: torch.Tensor, ndig_max: int):
    """Non-positive int64 values (a magnitude negated, so that
    |Long.MIN_VALUE| needs no uint64) -> ((n, ndig_max) digits, the digit
    at 10^i in column i; (n,) significant digit count, at least 1)."""
    pows = torch.tensor([10 ** i for i in range(ndig_max)],
                        dtype=torch.int64, device=vneg.device)
    q = torch.div(vneg[:, None], pows[None, :], rounding_mode="trunc")
    ds = -torch.fmod(q, 10)
    ndig = (vneg[:, None] <= -pows[None, :]).sum(1).clamp(min=1)
    return ds, ndig


def _neg_magnitude(x: torch.Tensor) -> torch.Tensor:
    """-|x| as int64, exact for Long.MIN_VALUE."""
    x = x.to(torch.int64)
    return torch.where(x < 0, x, -x)


def _emit_int_string(vneg, neg, ndig_max: int, width: int):
    """The (n, width) char matrix and lengths of signed integers, from
    their negated magnitudes ``vneg`` and signs ``neg``."""
    ds, ndig = _digits_of(vneg, ndig_max)
    negi = neg.to(torch.int64)
    lengths = ndig + negi
    pos = torch.arange(width, device=vneg.device)[None, :]
    digit_idx = ndig[:, None] - 1 - (pos - negi[:, None])
    in_digits = (digit_idx >= 0) & (digit_idx < ndig_max) \
        & (pos < lengths[:, None])
    dig = torch.gather(ds, 1, digit_idx.clamp(0, ndig_max - 1))
    chars = torch.where(in_digits, dig + ord("0"), 0)
    chars = torch.where((pos == 0) & neg[:, None], ord("-"), chars)
    return chars.to(torch.uint8), lengths.to(torch.int32)


def _int_to_string(ctx, c, src, dst, ansi):
    chars, lengths = _emit_int_string(_neg_magnitude(c.data), c.data < 0,
                                      _MAX_I64_DIGITS, 20)
    return DeviceColumn(T.STRING, c.validity, chars=chars, lengths=lengths)


def _bool_to_string(ctx, c, src, dst, ansi):
    dev = c.device
    t = torch.tensor(list(b"true\0"), dtype=torch.uint8, device=dev)
    f = torch.tensor(list(b"false"), dtype=torch.uint8, device=dev)
    b = c.data.to(torch.bool)
    chars = torch.where(b[:, None], t[None, :], f[None, :])
    lengths = torch.where(b, 4, 5).to(torch.int32)
    return DeviceColumn(T.STRING, c.validity, chars=chars, lengths=lengths)


def _dec_to_string(ctx, c, src: T.DecimalType, dst, ansi):
    """Spark: unscaled / 10^s with exactly s fractional digits (decimals
    of up to 18 digits: the tagging keeps a wider one off the device, as
    the reference's ``_check_cast``)."""
    s = src.scale
    if s == 0:
        return _int_to_string(ctx, c, src, dst, ansi)
    neg = c.data < 0
    vneg = _neg_magnitude(c.data)
    intpart = torch.div(vneg, _p10(s), rounding_mode="trunc")
    frac = torch.fmod(vneg, _p10(s))
    width = _MAX_I64_DIGITS + s + 3
    ds_int, ndig_int = _digits_of(intpart, _MAX_I64_DIGITS)
    ds_frac, _ = _digits_of(frac, s)
    negi = neg.to(torch.int64)[:, None]
    lengths = ndig_int + 1 + s + negi[:, 0]
    pos = torch.arange(width, device=c.device)[None, :]
    int_idx = ndig_int[:, None] - 1 - (pos - negi)
    in_int = (int_idx >= 0) & (int_idx < _MAX_I64_DIGITS)
    dot_pos = negi + ndig_int[:, None]
    frac_idx = s - 1 - (pos - dot_pos - 1)
    in_frac = (pos > dot_pos) & (frac_idx >= 0) & (frac_idx < s)
    dig_i = torch.gather(ds_int, 1, int_idx.clamp(0, _MAX_I64_DIGITS - 1))
    dig_f = torch.gather(ds_frac, 1, frac_idx.clamp(0, max(s - 1, 0)))
    chars = torch.zeros((c.capacity, width), dtype=torch.int64,
                        device=c.device)
    chars = torch.where(in_int, dig_i + ord("0"), chars)
    chars = torch.where(pos == dot_pos, ord("."), chars)
    chars = torch.where(in_frac, dig_f + ord("0"), chars)
    chars = torch.where((pos == 0) & neg[:, None], ord("-"), chars)
    chars = torch.where(pos < lengths[:, None], chars, 0)
    return DeviceColumn(T.STRING, c.validity, chars=chars.to(torch.uint8),
                        lengths=lengths.to(torch.int32))


def _put_digits(cols: list, v: torch.Tensor, k: int) -> None:
    """Append the ``k`` low decimal digits of non-negative ``v``, most
    significant first, as char columns."""
    for i in range(k - 1, -1, -1):
        cols.append(torch.remainder(_fdiv(v, 10 ** i), 10) + ord("0"))


def _put_char(cols: list, like: torch.Tensor, ch: str) -> None:
    cols.append(torch.full_like(like, ord(ch)))


def _date_to_string(ctx, c, src, dst, ansi):
    """yyyy-MM-dd, the year's magnitude's four low digits (the reference
    pads to four and drops a sign or a fifth digit)."""
    y, m, d = civil_from_days(c.data)
    cols: list = []
    _put_digits(cols, y.abs(), 4)
    _put_char(cols, y, "-")
    _put_digits(cols, m, 2)
    _put_char(cols, y, "-")
    _put_digits(cols, d, 2)
    chars = torch.stack(cols, 1).to(torch.uint8)
    lengths = torch.full((c.capacity,), 10, dtype=torch.int32,
                         device=c.device)
    return DeviceColumn(T.STRING, c.validity, chars=chars, lengths=lengths)


def _ts_to_string(ctx, c, src, dst, ansi):
    """yyyy-MM-dd HH:mm:ss[.ffffff] in UTC, the fraction's trailing zeros
    trimmed, as Spark renders it."""
    us = c.data
    days = _fdiv(us, _US_PER_DAY)
    rem = us - days * _US_PER_DAY
    y, m, d = civil_from_days(days)
    hh = _fdiv(rem, 3_600_000_000)
    mm = torch.remainder(_fdiv(rem, 60_000_000), 60)
    ss = torch.remainder(_fdiv(rem, 1_000_000), 60)
    frac = torch.remainder(rem, 1_000_000)
    cols: list = []
    _put_digits(cols, y.abs(), 4)
    _put_char(cols, y, "-")
    _put_digits(cols, m, 2)
    _put_char(cols, y, "-")
    _put_digits(cols, d, 2)
    _put_char(cols, y, " ")
    _put_digits(cols, hh, 2)
    _put_char(cols, y, ":")
    _put_digits(cols, mm, 2)
    _put_char(cols, y, ":")
    _put_digits(cols, ss, 2)
    has_frac = frac > 0
    cols.append(torch.where(has_frac, ord("."), 0))
    ds, _ = _digits_of(-frac, 6)
    # the number of trailing zeros: the first nonzero digit from the lsd
    tz = torch.argmax((ds > 0).to(torch.int32), dim=1)
    ndigits = 6 - torch.where(has_frac, tz, 6)
    for i in range(6):
        cols.append(torch.where(i < ndigits, ds[:, 5 - i] + ord("0"), 0))
    ch = torch.stack(cols, 1)
    lengths = torch.where(has_frac, 20 + ndigits, 19)
    pos = torch.arange(26, device=c.device)[None, :]
    ch = torch.where(pos < lengths[:, None], ch, 0)
    return DeviceColumn(T.STRING, c.validity, chars=ch.to(torch.uint8),
                        lengths=lengths.to(torch.int32))


# -- from string -------------------------------------------------------------

def _chars_of(c: DeviceColumn) -> torch.Tensor:
    """A string column's chars, at least one column wide."""
    return c.chars if c.width > 0 else _fit_chars(c.chars, 1)


def _parse_trim(c: DeviceColumn):
    """ASCII whitespace stripped at both ends: (any non-space, first,
    last) per row, positions as int64."""
    ch = _chars_of(c)
    w = int(ch.shape[1])
    pos = torch.arange(w, device=ch.device)[None, :]
    is_ws = (ch == ord(" ")) | ((ch >= 9) & (ch <= 13))
    nonws = (pos < c.lengths[:, None]) & ~is_ws
    any_nonws = nonws.any(1)
    nw = nonws.to(torch.int32)
    first = torch.argmax(nw, dim=1)
    last = w - 1 - torch.argmax(torch.flip(nw, [1]), dim=1)
    return any_nonws, first, last


def _error_or_null(ctx, c, ok, ansi: bool, message: str):
    """The validity of a parse: an invalid row is null, or under ANSI an
    error."""
    if ansi:
        ctx.add_error(~ok & c.validity, message)
        return c.validity
    return c.validity & ok


def _string_to_int(ctx, c, src, dst, ansi):
    any_nonws, first, last = _parse_trim(c)
    chars = _chars_of(c)
    pos = torch.arange(int(chars.shape[1]), device=c.device)[None, :]
    active = (pos >= first[:, None]) & (pos <= last[:, None])
    ch = torch.where(active, chars, 0).to(torch.int64)
    sign_char = torch.gather(ch, 1, first[:, None])[:, 0]
    neg = sign_char == ord("-")
    has_sign = neg | (sign_char == ord("+"))
    dig_start = first + has_sign.to(torch.int64)
    is_digit = (ch >= ord("0")) & (ch <= ord("9"))
    digit_active = (pos >= dig_start[:, None]) & (pos <= last[:, None])
    all_digits = (~digit_active | is_digit).all(1)
    ndig = last - dig_start + 1
    valid_parse = any_nonws & all_digits & (ndig >= 1) & (ndig <= 19)
    # the magnitude, at most 19 digits, as its digit at 10^18 and the
    # rest (each within int64)
    exp = last[:, None] - pos
    p10 = torch.tensor([10 ** i for i in range(18)] + [0],
                       dtype=torch.int64, device=c.device)
    dig = torch.where(digit_active & is_digit, ch - ord("0"), 0)
    low = (dig * p10[exp.clamp(0, 18)]
           * ((exp >= 0) & (exp < 18))).sum(1)
    top = (dig * (exp == 18)).sum(1)
    cap = torch.where(neg, 223372036854775808, 223372036854775807)
    fits_i64 = (top < 9) | ((top == 9) & (low <= cap))
    top_v = torch.where(fits_i64, top, 0) * 10 ** 18
    low_v = torch.where(fits_i64, low, 0)
    val = torch.where(neg, -top_v - low_v, top_v + low_v)
    in_range = fits_i64 & (val >= _I_MIN[type(dst)]) \
        & (val <= _I_MAX[type(dst)])
    validity = _error_or_null(ctx, c, valid_parse & in_range, ansi,
                              f"invalid cast string->{dst} (ANSI)")
    return DeviceColumn(dst, validity, data=val.to(_tdt(dst)))


def _string_to_bool(ctx, c, src, dst, ansi):
    """true/t/yes/y/1 or false/f/no/n/0, ASCII case-insensitive, after
    trimming ASCII whitespace as Spark does (the reference's device does
    not trim, its oracle does: ROADMAP R32)."""
    any_nonws, first, last = _parse_trim(c)
    chars = _fit_chars(_chars_of(c), 5)
    w = int(chars.shape[1])
    pos = torch.arange(w, device=c.device)[None, :]
    lower = torch.where((chars >= 65) & (chars <= 90), chars + 32, chars)
    trimmed = torch.gather(lower, 1, (first[:, None] + pos).clamp(max=w - 1))
    length = torch.where(any_nonws, last - first + 1, 0)

    def match(word: str):
        b = list(word.encode())
        tgt = torch.tensor(b, dtype=torch.uint8, device=c.device)
        return (length == len(b)) & (trimmed[:, :len(b)]
                                     == tgt[None, :]).all(1)

    true_m = match("true") | match("t") | match("yes") | match("y") \
        | match("1")
    false_m = match("false") | match("f") | match("no") | match("n") \
        | match("0")
    validity = _error_or_null(ctx, c, true_m | false_m, ansi,
                              "invalid cast string->boolean (ANSI)")
    return DeviceColumn(T.BOOLEAN, validity, data=true_m)


def java_fp_to_string(v: float, is_float: bool) -> str:
    """Java ``Float``/``Double.toString``: the shortest round-trip digits,
    positional for 1e-3 <= |v| < 1e7, else ``d.dddEnn`` (a copy of the
    reference's)."""
    import math

    import numpy as np

    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    if v == 0.0:
        return "-0.0" if math.copysign(1.0, v) < 0 else "0.0"
    x = np.float32(v) if is_float else np.float64(v)
    s = np.format_float_scientific(x, unique=True, trim="-")
    mant, _, exps = s.partition("e")
    exp = int(exps)
    neg = mant.startswith("-")
    if neg:
        mant = mant[1:]
    digits = (mant.replace(".", "").rstrip("0")) or "0"
    if -3 <= exp <= 6:
        if exp >= 0:
            ip = digits[: exp + 1].ljust(exp + 1, "0")
            fp = digits[exp + 1:] or "0"
        else:
            ip = "0"
            fp = "0" * (-exp - 1) + digits
        out = f"{ip}.{fp}"
    else:
        out = f"{digits[0]}.{digits[1:] or '0'}E{exp}"
    return ("-" if neg else "") + out


def _fp_to_string(ctx, c, src, dst, ansi):
    """Host code, as the reference's host kernel: Java's shortest repr of
    each value, the strings moved to the column's device."""
    from spark_rapids_tpu_torch.columnar.column import HostColumn

    vals = c.data.cpu().tolist()
    valid = c.validity.cpu().numpy()
    is_f = isinstance(src, T.FloatType)
    out = [java_fp_to_string(float(v), is_f) if ok else ""
           for v, ok in zip(vals, valid)]
    return DeviceColumn.from_host(HostColumn.strings(out, valid), c.device)


def _string_to_fp(ctx, c, src, dst, ansi):
    """Host code, as the reference's host kernel: Spark's string ->
    double parse (``spark_string_to_double``); a string that does not
    parse is null, or under ANSI an error."""
    vals, ok, bad = _parse_doubles(c)
    if ansi:
        ctx.add_error(bad, "invalid input syntax for type numeric (ANSI)")
    return DeviceColumn(dst, ok, data=vals.to(_tdt(dst)))


# -- string -> timestamp / date: variable-width civil parsing ----------------

_P10_I64 = [10 ** i for i in range(19)]


class _FieldCursor:
    """Masked torch ops over each row's trimmed chars: digit runs and
    single-char matches, no per-row loop (the reference's cursor).

    The grammar (a documented subset of Spark's stringToTimestamp):
      [y]yyyy[-[m]m[-[d]d[( |T)[h]h[:[m]m[:[s]s[.f{1,9}]]]][tz]]]]
      tz := Z | z | +-h[h] | +-hh:mm | +-h:mm | +-hhmm
    A named zone ("UTC", "America/New_York") does not parse."""

    def __init__(self, c: DeviceColumn):
        self.any_nonws, self.first, self.last = _parse_trim(c)
        chars = _chars_of(c)
        self.w = int(chars.shape[1])
        self.pos = torch.arange(self.w, device=c.device)[None, :]
        active = ((self.pos >= self.first[:, None])
                  & (self.pos <= self.last[:, None])
                  & (self.pos < c.lengths[:, None]))
        self.ch = torch.where(active, chars, 0).to(torch.int64)
        self.is_digit = (self.ch >= ord("0")) & (self.ch <= ord("9"))

    def char_at(self, p):
        v = torch.gather(self.ch, 1, p.clamp(0, self.w - 1)[:, None])[:, 0]
        return torch.where((p >= 0) & (p < self.w), v, 0)

    def digit_run_end(self, p):
        """The exclusive end of the digit run from ``p`` (at most last+1)."""
        nd = ((self.pos >= p[:, None]) & ~self.is_digit
              & (self.pos <= self.last[:, None]))
        idx = torch.argmax(nd.to(torch.int32), dim=1)
        return torch.where(nd.any(1), idx, self.last + 1)

    def parse_int(self, start, end_excl, max_digits: int):
        """The integer of the digits in [start, end_excl); the caller
        checks the length."""
        exp = end_excl[:, None] - 1 - self.pos
        active = (self.pos >= start[:, None]) & (self.pos < end_excl[:, None])
        p10 = torch.tensor(_P10_I64[:max_digits] + [0], dtype=torch.int64,
                           device=self.ch.device)
        mult = p10[exp.clamp(0, max_digits)]
        return torch.where(active, (self.ch - ord("0")) * mult, 0).sum(1)


def _parse_civil_string(c: DeviceColumn):
    """The shared date prefix and the optional time and zone suffix: a
    dict of fields and of per-shape flags (the DATE cast ignores what
    follows the day)."""
    cur = _FieldCursor(c)
    last = cur.last
    ys = cur.first
    ye = cur.digit_run_end(ys)
    ylen = ye - ys
    y = cur.parse_int(ys, ye, 6)
    # the year capped at 9999: a collected value is a Python datetime
    year_ok = cur.any_nonws & (ylen >= 4) & (ylen <= 6) & (y <= 9999)
    only_year = ye > last
    dash1 = cur.char_at(ye) == ord("-")
    ms = ye + 1
    me = cur.digit_run_end(ms)
    mlen = me - ms
    m = cur.parse_int(ms, me, 2)
    month_ok = (mlen >= 1) & (mlen <= 2)
    only_ym = me > last
    dash2 = cur.char_at(me) == ord("-")
    ds = me + 1
    de = cur.digit_run_end(ds)
    dlen = de - ds
    d = cur.parse_int(ds, de, 2)
    day_ok = (dlen >= 1) & (dlen <= 2)
    only_date = de > last
    sepc = cur.char_at(de)
    sep = (sepc == ord(" ")) | (sepc == ord("T"))
    hs = de + 1
    he = cur.digit_run_end(hs)
    hlen = he - hs
    h = cur.parse_int(hs, he, 2)
    hour_ok = (hlen >= 1) & (hlen <= 2)
    colon1 = cur.char_at(he) == ord(":")
    mins = he + 1
    mine = cur.digit_run_end(mins)
    minlen = mine - mins
    mi = cur.parse_int(mins, mine, 2)
    min_ok = (minlen >= 1) & (minlen <= 2)
    colon2 = cur.char_at(mine) == ord(":")
    ss = mine + 1
    se = cur.digit_run_end(ss)
    slen = se - ss
    s = cur.parse_int(ss, se, 2)
    sec_ok = (slen >= 1) & (slen <= 2)
    dot = cur.char_at(se) == ord(".")
    fs = se + 1
    fe = cur.digit_run_end(fs)
    flen = fe - fs
    frac_ok = (flen >= 1) & (flen <= 9)
    frac_raw = cur.parse_int(fs, fe, 9)
    # the fraction in microseconds, digits past the sixth truncated
    scale = torch.tensor(_P10_I64[:7], dtype=torch.int64, device=c.device)
    up = scale[(6 - flen).clamp(0, 6)]
    down = scale[(flen - 6).clamp(0, 6)]
    frac_us = torch.where(flen <= 6, frac_raw * up, _fdiv(frac_raw, down))
    time_end = torch.where(
        dot & frac_ok, fe,
        torch.where(colon2 & sec_ok, se,
                    torch.where(colon1 & min_ok, mine, he)))
    has_min = colon1 & min_ok
    has_sec = has_min & colon2 & sec_ok
    has_frac = has_sec & dot & frac_ok
    mi = torch.where(has_min, mi, 0)
    s = torch.where(has_sec, s, 0)
    frac_us = torch.where(has_frac, frac_us, 0)
    time_shape_ok = hour_ok & (
        (time_end == he)
        | (has_min & (time_end == mine))
        | (has_sec & (time_end == se))
        | (has_frac & (time_end == fe)))
    # the zone suffix after the time
    tzp = time_end
    tz_none = tzp > last
    tzc = cur.char_at(tzp)
    tz_z = ((tzc == ord("Z")) | (tzc == ord("z"))) & (tzp == last)
    tz_sign = torch.where(tzc == ord("+"), 1,
                          torch.where(tzc == ord("-"), -1, 0))
    ths = tzp + 1
    the = cur.digit_run_end(ths)
    thlen = the - ths
    th_raw = cur.parse_int(ths, the, 4)
    # hhmm (four digits), or h/hh and an optional :mm
    tz_hhmm = thlen == 4
    tzh = torch.where(tz_hhmm, _fdiv(th_raw, 100), th_raw)
    tcolon = cur.char_at(the) == ord(":")
    tms = the + 1
    tme = cur.digit_run_end(tms)
    tmlen = tme - tms
    tzm_c = cur.parse_int(tms, tme, 2)
    has_tzm = tcolon & (tmlen == 2)
    tzm = torch.where(tz_hhmm, torch.remainder(th_raw, 100),
                      torch.where(has_tzm, tzm_c, 0))
    tz_num_end = torch.where(has_tzm & ~tz_hhmm, tme, the)
    tz_num_ok = ((tz_sign != 0)
                 & ((tz_hhmm & ~tcolon) | ((thlen >= 1) & (thlen <= 2)))
                 & (tz_num_end > last))
    tz_off_ok = (tzh <= 18) & (tzm <= 59) & ((tzh * 60 + tzm) <= 18 * 60)
    tz_ok = tz_none | tz_z | (tz_num_ok & tz_off_ok)
    tz_offset_s = torch.where(tz_none | tz_z, 0,
                              tz_sign * (tzh * 3600 + tzm * 60))
    return dict(
        y=y, m=m, d=d, h=h, mi=mi, s=s, frac_us=frac_us,
        year_ok=year_ok, only_year=only_year,
        dash1=dash1, month_ok=month_ok, only_ym=only_ym, dash2=dash2,
        day_ok=day_ok, only_date=only_date, sep=sep,
        time_shape_ok=time_shape_ok, tz_ok=tz_ok,
        tz_offset_s=tz_offset_s, h_ok=(h <= 23), mi_ok=(mi <= 59),
        s_ok=(s <= 59))


def _civil_days(f):
    """(days, the month and day in effect, civil ok) of a parse: a year
    alone is its January 1st, a year and month its first day."""
    m_eff = torch.where(f["only_year"], 1, f["m"])
    d_eff = torch.where(f["only_year"] | f["only_ym"], 1, f["d"])
    m1, d1 = m_eff.clamp(min=1), d_eff.clamp(min=1)
    days = days_from_civil(f["y"], m1, d1)
    y2, m2, d2 = civil_from_days(days)
    civil_ok = (y2 == f["y"]) & (m2 == m1) & (d2 == d1) \
        & (m_eff >= 1) & (d_eff >= 1)
    return days, civil_ok


def _string_to_timestamp(ctx, c, src, dst, ansi):
    """Spark's stringToTimestamp subset (the grammar: ``_FieldCursor``)."""
    f = _parse_civil_string(c)
    days, civil_ok = _civil_days(f)
    date_part_ok = f["only_year"] | (
        f["dash1"] & f["month_ok"]
        & (f["only_ym"] | (f["dash2"] & f["day_ok"])))
    no_time = f["only_date"] | f["only_year"] | f["only_ym"]
    time_part_ok = no_time | (
        f["sep"] & f["time_shape_ok"] & f["tz_ok"]
        & f["h_ok"] & f["mi_ok"] & f["s_ok"])
    ok = f["year_ok"] & date_part_ok & time_part_ok & civil_ok
    has_time = ~no_time

    def t(name):
        return torch.where(has_time, f[name], 0)

    micros = (days * _US_PER_DAY + t("h") * 3_600_000_000
              + t("mi") * 60_000_000 + t("s") * 1_000_000
              + t("frac_us") - t("tz_offset_s") * 1_000_000)
    validity = _error_or_null(ctx, c, ok, ansi,
                              "invalid cast string->timestamp (ANSI)")
    return DeviceColumn(T.TIMESTAMP, validity, data=micros)


def _string_to_date_v2(ctx, c, src, dst, ansi):
    """Spark's stringToDate: [y]yyyy[-[m]m[-[d]d]], anything after the
    day accepted when ' ' or 'T' separates it (Spark ignores the tail)."""
    f = _parse_civil_string(c)
    days, civil_ok = _civil_days(f)
    tail_ok = f["only_date"] | f["sep"]
    ok = f["year_ok"] & civil_ok & (f["only_year"] | (
        f["dash1"] & f["month_ok"]
        & (f["only_ym"] | (f["dash2"] & f["day_ok"] & tail_ok))))
    validity = _error_or_null(ctx, c, ok, ansi,
                              "invalid cast string->date (ANSI)")
    return DeviceColumn(T.DATE, validity, data=days.to(torch.int32))


#: the reference's ``_CASTS``, every pair
_CASTS = {
    ("int", "int"): _int_to_int,
    ("int", "fp"): _int_to_fp,
    ("fp", "int"): _fp_to_int,
    ("fp", "fp"): _fp_to_fp,
    ("int", "bool"): _num_to_bool,
    ("fp", "bool"): _num_to_bool,
    ("bool", "int"): _bool_to_num,
    ("bool", "fp"): _bool_to_num,
    ("dec", "dec"): _dec_to_dec,
    ("int", "dec"): _int_to_dec,
    ("dec", "int"): _dec_to_int,
    ("dec", "fp"): _dec_to_fp,
    ("fp", "dec"): _fp_to_dec,
    ("int", "str"): _int_to_string,
    ("fp", "str"): _fp_to_string,
    ("str", "fp"): _string_to_fp,
    ("bool", "str"): _bool_to_string,
    ("dec", "str"): _dec_to_string,
    ("date", "str"): _date_to_string,
    ("ts", "str"): _ts_to_string,
    ("str", "int"): _string_to_int,
    ("str", "date"): _string_to_date_v2,
    ("str", "bool"): _string_to_bool,
    ("str", "ts"): _string_to_timestamp,
    ("date", "ts"): _date_to_ts,
    ("ts", "date"): _ts_to_date,
    ("ts", "int"): _ts_to_long,
    ("int", "ts"): _long_to_ts,
    ("null", "int"): _null_to_any,
    ("null", "fp"): _null_to_any,
    ("null", "str"): _null_to_any,
    ("null", "bool"): _null_to_any,
    ("null", "dec"): _null_to_any,
    ("null", "date"): _null_to_any,
    ("null", "ts"): _null_to_any,
}

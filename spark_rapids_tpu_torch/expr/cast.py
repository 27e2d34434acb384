"""Cast — port of ``spark_rapids_tpu/expr/cast.py``'s numeric, boolean,
decimal and date/timestamp casts, with its dispatch table (``_CASTS``):

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
  * DATE <-> TIMESTAMP, TIMESTAMP <-> LONG (seconds, floored), NULL -> any.

The casts to and from strings (the reference's ``_int_to_string``,
``_dec_to_string``, ``_date_to_string``, ``_fp_to_string``,
``_string_to_int``, ``_string_to_date``, ``_string_to_fp`` and the civil
parser) are not ported: ``cast_supported`` is the reference's table less
them, and the conversion raises ``NotOnGpu`` for them.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
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
    reference's table (``GpuCast.canCast``) less the string casts."""
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
    return DeviceColumn(dst, valid, data=torch.zeros(
        n, dtype=_tdt(dst), device=dev))


#: the string casts of the reference's ``_CASTS``, not ported (D3, F3)
STRING_CASTS = frozenset({
    ("int", "str"), ("fp", "str"), ("str", "fp"), ("bool", "str"),
    ("dec", "str"), ("date", "str"), ("ts", "str"), ("str", "int"),
    ("str", "date"), ("str", "bool"), ("null", "str")})

#: the reference's ``_CASTS`` less the string casts
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
    ("date", "ts"): _date_to_ts,
    ("ts", "date"): _ts_to_date,
    ("ts", "int"): _ts_to_long,
    ("int", "ts"): _long_to_ts,
    ("null", "int"): _null_to_any,
    ("null", "fp"): _null_to_any,
    ("null", "bool"): _null_to_any,
    ("null", "dec"): _null_to_any,
    ("null", "date"): _null_to_any,
    ("null", "ts"): _null_to_any,
}


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


def strings_to_double(c: DeviceColumn, ansi: bool) -> DeviceColumn:
    """A string column parsed to doubles on the host, row by row, as the
    reference's ``_string_to_fp`` host kernel parses: a string that does
    not parse is null, or under ANSI an error in the reference's words.
    The result lies on the column's device."""
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException

    valid = c.validity.cpu().numpy()
    lengths = c.lengths.cpu().numpy()
    chars = c.chars.cpu().numpy()
    n = len(valid)
    vals = [0.0] * n
    ok = [False] * n
    bad = False
    for i in range(n):
        if not valid[i]:
            continue
        f = spark_string_to_double(
            bytes(chars[i, :lengths[i]]).decode("utf-8", "replace"))
        if f is None:
            bad = True
        else:
            vals[i], ok[i] = f, True
    if bad and ansi:
        raise SparkArithmeticException(
            "invalid input syntax for type numeric (ANSI)")
    dev = c.validity.device
    return DeviceColumn(T.DOUBLE, torch.tensor(ok, dtype=torch.bool,
                                               device=dev),
                        data=torch.tensor(vals, dtype=torch.float64,
                                          device=dev))

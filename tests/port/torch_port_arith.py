"""A seeded table of numeric edge cases and the division, arithmetic,
math, cast and conditional expressions of slice 13 built in either
package, for the CPU tests against the reference
(``test_torch_arith_math_cast.py``) and the card test
(``test_torch_gpu.py``).  Imports numpy only, so the card's machine (no
jax) can use it.

The table holds negatives and zero divisors, NaN, +-inf, +-0.0,
subnormals, values at 2^31, 2^53, 2^62 and 2^63, decimals at 18 and 38
digits, HALF_UP ties of both signs, and shift amounts 0, 31, 32, 63, 64
and negative ones."""
import importlib
import types as _types
from decimal import Decimal

import numpy as np

N_ROWS = 256
_I32 = (0, 1, -1, 7, -7, 2 ** 31 - 1, -2 ** 31, 2 ** 30, -2 ** 30, 3, -3,
        100, 46341, -46341, 65536)
_I64 = (0, 1, -1, 2 ** 53, 2 ** 53 + 1, -2 ** 53, 2 ** 62, -2 ** 62,
        2 ** 63 - 1, -2 ** 63, 2 ** 31, -2 ** 31, 2 ** 32 + 5, 10 ** 18, 3,
        -3, 12345678901)
_DIV64 = (0, 1, -1, 3, -7, 2 ** 31, 2 ** 62, -2 ** 62, 2 ** 63 - 1, -2 ** 63,
          10)
_F64 = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 5e-324,
        2.2250738585072014e-308, -1e-310, 2.0 ** 53, 2.0 ** 53 + 2,
        2.0 ** 63, -2.0 ** 63, 2.0 ** 64, 2.0 ** 31, -2.0 ** 31 - 1, 1e300,
        -1e300, 0.285, 2.5, -2.5, 0.5, -0.5, 1.5, 0.125, -0.125, 1.0, -1.0,
        3.0, 1e-5, 123.456, -98.765, 0.1, 2.675, 1e18, 1e19, 4.35)
_DIV_F = (0.0, -0.0, float("nan"), float("inf"), 3.0, -7.5, 1e-300, 0.1,
          -1.0, 2.0, 5e-324, 1e300)
#: shift amounts: at and past the widths, negative
_SHIFTS = (0, 1, 31, 32, 33, 63, 64, 65, -1, -33, -64, 127)
#: DECIMAL(7,2) and DECIMAL(5,2) unscaled: 0.01 / 5.12 = 0.001953125 and
#: 0.03 / 5.12 = 0.005859375 are HALF_UP ties at the quotient's 8 places
_P = (1, -1, 3, -3, 0, 9_999_999, -9_999_999, 100, 12_345, 50)
_Q = (512, 512, -512, 512, 7, 1, -1, 0, 99_999, -300)
_D18 = (10 ** 18 - 1, -(10 ** 18 - 1), 0, 5, -5, 10 ** 17, 123_456_789)
_E10 = (0, 1, -1, 8, 300, -300, 99_999_999, 25)
_D38 = (10 ** 38 - 1, -(10 ** 38 - 1), 0, 2 ** 127 - 2 ** 100, -(2 ** 64),
        2 ** 64 + 3, 10 ** 30 + 5, -(10 ** 25) - 5)
_E20 = (0, 1, -1, 2 ** 63 - 1, 10 ** 19 + 7, -(10 ** 20 - 1), 3, 64)


def _with_edges(rng, draw, edges, n):
    out = draw(rng, n)
    k = min(len(edges), n)
    out[:k] = np.array(edges[:k], dtype=out.dtype) if out.dtype != object \
        else np.array(edges[:k], dtype=object)
    return out


def _limbs(vals):
    """Python ints -> (n, 2) int64 [hi, lo] limbs."""
    out = np.empty((len(vals), 2), np.int64)
    for i, v in enumerate(vals):
        m = int(v) & ((1 << 128) - 1)
        lo, hi = m & ((1 << 64) - 1), m >> 64
        out[i, 0] = hi - (1 << 64) if hi >= 1 << 63 else hi
        out[i, 1] = lo - (1 << 64) if lo >= 1 << 63 else lo
    return out


def _float32(x):
    """``x`` as float32, the doubles past its range as +-inf."""
    with np.errstate(over="ignore"):
        return x.astype(np.float32)


def arith_table(seed: int, n: int = N_ROWS):
    """(arrays, validity, python values of the 38-digit columns) of ``n``
    rows; about a twelfth of each column null, but for the edge rows."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, dt):
        return lambda r, k: r.integers(lo, hi, k, dtype=np.int64).astype(dt)

    def floats(r, k):
        return (r.standard_normal(k) * 10.0 ** r.integers(-8, 12, k))

    big = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, n)]
    d38 = [int(a) * (2 ** 64) + int(b) for a, b in
           zip(rng.integers(-2 ** 62, 2 ** 62, n),
               rng.integers(0, 2 ** 63, n))]
    d38 = [max(min(v, 10 ** 38 - 1), -(10 ** 38 - 1)) for v in d38]
    d38[:len(_D38)] = _D38
    e20 = [v % (10 ** 20) * (1 if v % 2 else -1) for v in big]
    e20[:len(_E20)] = _E20
    arrays = {
        "i": _with_edges(rng, ints(-2 ** 31, 2 ** 31, np.int32), _I32, n),
        "j": _with_edges(rng, ints(-40, 40, np.int32), (0, -1, 1, 7, -7, 3,
                                                        2 ** 31 - 1, -2 ** 31,
                                                        0, 2, -3, 5), n),
        "l": _with_edges(rng, ints(-2 ** 63, 2 ** 63 - 1, np.int64), _I64, n),
        "k": _with_edges(rng, ints(-1000, 1000, np.int64), _DIV64, n),
        "sh": _with_edges(rng, ints(-70, 140, np.int32), _SHIFTS, n),
        "x": _with_edges(rng, floats, _F64, n),
        "y": _with_edges(rng, floats, _DIV_F, n),
        "f": _float32(_with_edges(rng, floats, _F64, n)),
        "p": _with_edges(rng, ints(-9_999_999, 10_000_000, np.int64), _P, n),
        "q": _with_edges(rng, ints(-99_999, 100_000, np.int64), _Q, n),
        "d": _with_edges(rng, ints(-10 ** 18 + 1, 10 ** 18, np.int64), _D18,
                         n),
        "e": _with_edges(rng, ints(-10 ** 9, 10 ** 9, np.int64), _E10, n),
        "D": _limbs(d38),
        "E": _limbs(e20),
        "nf": _with_edges(rng, ints(-3, 24, np.int32), (0, 1, 20, 21, -1),
                          n),
        "b": rng.random(n) < 0.5,
        "s": np.array([("abc", "abd", "", "ab", "é", "zz", "a\x00")[v]
                       for v in rng.integers(0, 7, n)], object),
        "t": np.array([("abc", "ab", "", "zz", "abd", "é", "a")[v]
                       for v in rng.integers(0, 7, n)], object),
    }
    validity = {name: rng.random(n) > 1 / 12 for name in arrays}
    for name, edges in (("i", _I32), ("j", range(12)), ("l", _I64),
                        ("k", _DIV64), ("sh", _SHIFTS), ("x", _F64),
                        ("y", _DIV_F), ("f", _F64), ("p", _P), ("q", _Q),
                        ("d", _D18), ("e", _E10), ("D", _D38),
                        ("E", _E20), ("nf", range(5))):
        validity[name][:len(edges)] = True
    return arrays, validity


def arith_schema(T):
    f = T.StructField
    return T.StructType([
        f("i", T.INT), f("j", T.INT), f("l", T.LONG), f("k", T.LONG),
        f("sh", T.INT), f("x", T.DOUBLE), f("y", T.DOUBLE), f("f", T.FLOAT),
        f("p", T.DecimalType(7, 2)), f("q", T.DecimalType(5, 2)),
        f("d", T.DecimalType(18, 4)), f("e", T.DecimalType(10, 2)),
        f("D", T.DecimalType(38, 6)), f("E", T.DecimalType(20, 2)),
        f("nf", T.INT), f("b", T.BOOLEAN), f("s", T.STRING),
        f("t", T.STRING)])


def mods(session_mod):
    """The expression modules and types of the package whose session
    module is ``session_mod``."""
    pkg = session_mod.__name__.rsplit(".", 1)[0]

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    ns = _types.SimpleNamespace(
        A=m("expr.arithmetic"), M=m("expr.mathfuncs"),
        CO=m("expr.conditional"), P=m("expr.predicates"),
        C=m("expr.cast"), T=m("types"), lit=session_mod.lit)
    return ns


def _dec(s):
    return lambda X, c: X.lit(Decimal(s))


#: cases the device runs in both packages: name -> builder(X, col)
DEVICE_CASES = {
    "div_double": lambda X, c: X.A.Divide(c("x"), c("y")),
    "div_int": lambda X, c: X.A.Divide(c("i"), c("j")),
    "div_long": lambda X, c: X.A.Divide(c("l"), c("k")),
    "div_dec": lambda X, c: X.A.Divide(c("p"), c("q")),
    "intdiv_int": lambda X, c: X.A.IntegralDivide(c("i"), c("j")),
    "intdiv_long": lambda X, c: X.A.IntegralDivide(c("l"), c("k")),
    "rem_int": lambda X, c: X.A.Remainder(c("i"), c("j")),
    "rem_long": lambda X, c: X.A.Remainder(c("l"), c("k")),
    "rem_double": lambda X, c: X.A.Remainder(c("x"), c("y")),
    "rem_dec": lambda X, c: X.A.Remainder(c("p"), c("q")),
    "pmod_int": lambda X, c: X.A.Pmod(c("i"), c("j")),
    "pmod_long": lambda X, c: X.A.Pmod(c("l"), c("k")),
    "pmod_double": lambda X, c: X.A.Pmod(c("x"), c("y")),
    "pmod_dec": lambda X, c: X.A.Pmod(c("p"), c("q")),
    "neg_int": lambda X, c: X.A.UnaryMinus(c("i")),
    "neg_long": lambda X, c: X.A.UnaryMinus(c("l")),
    "neg_double": lambda X, c: X.A.UnaryMinus(c("x")),
    "neg_dec": lambda X, c: X.A.UnaryMinus(c("d")),
    "abs_int": lambda X, c: X.A.Abs(c("i")),
    "abs_long": lambda X, c: X.A.Abs(c("l")),
    "abs_double": lambda X, c: X.A.Abs(c("x")),
    "abs_dec": lambda X, c: X.A.Abs(c("d")),
    "pos_long": lambda X, c: X.A.UnaryPositive(c("l")),
    "and_int": lambda X, c: X.A.BitwiseAnd(c("i"), c("j")),
    "or_long": lambda X, c: X.A.BitwiseOr(c("l"), c("k")),
    "xor_mixed": lambda X, c: X.A.BitwiseXor(c("i"), c("l")),
    "not_long": lambda X, c: X.A.BitwiseNot(c("l")),
    "shl_int": lambda X, c: X.A.ShiftLeft(c("i"), c("sh")),
    "shr_int": lambda X, c: X.A.ShiftRight(c("i"), c("sh")),
    "ushr_int": lambda X, c: X.A.ShiftRightUnsigned(c("i"), c("sh")),
    "shl_long": lambda X, c: X.A.ShiftLeft(c("l"), c("sh")),
    "shr_long": lambda X, c: X.A.ShiftRight(c("l"), c("sh")),
    "ushr_long": lambda X, c: X.A.ShiftRightUnsigned(c("l"), c("sh")),
    "try_add_int": lambda X, c: X.A.TryAdd(c("i"), c("i")),
    "try_sub_long": lambda X, c: X.A.TrySubtract(c("l"), c("k")),
    "try_mul_long": lambda X, c: X.A.TryMultiply(c("l"), c("k")),
    "try_div_double": lambda X, c: X.A.TryDivide(c("x"), c("y")),
    "try_div_dec": lambda X, c: X.A.TryDivide(c("p"), c("q")),
    "try_add_dec": lambda X, c: X.A.TryAdd(c("d"), c("d")),
    "try_mul_dec": lambda X, c: X.A.TryMultiply(c("d"), c("q")),
    "cast_int_double": lambda X, c: X.C.Cast(c("i"), X.T.DOUBLE),
    "cast_long_double": lambda X, c: X.C.Cast(c("l"), X.T.DOUBLE),
    "cast_long_float": lambda X, c: X.C.Cast(c("l"), X.T.FLOAT),
    "cast_double_int": lambda X, c: X.C.Cast(c("x"), X.T.INT),
    "cast_double_long": lambda X, c: X.C.Cast(c("x"), X.T.LONG),
    "cast_double_short": lambda X, c: X.C.Cast(c("x"), X.T.SHORT),
    "cast_float_long": lambda X, c: X.C.Cast(c("f"), X.T.LONG),
    "cast_double_float": lambda X, c: X.C.Cast(c("x"), X.T.FLOAT),
    "cast_float_double": lambda X, c: X.C.Cast(c("f"), X.T.DOUBLE),
    "cast_long_bool": lambda X, c: X.C.Cast(c("l"), X.T.BOOLEAN),
    "cast_double_bool": lambda X, c: X.C.Cast(c("x"), X.T.BOOLEAN),
    "cast_bool_int": lambda X, c: X.C.Cast(c("b"), X.T.INT),
    "cast_bool_double": lambda X, c: X.C.Cast(c("b"), X.T.DOUBLE),
    "cast_dec_int": lambda X, c: X.C.Cast(c("d"), X.T.INT),
    "cast_dec_long": lambda X, c: X.C.Cast(c("d"), X.T.LONG),
    "cast_dec_double": lambda X, c: X.C.Cast(c("p"), X.T.DOUBLE),
    "cast_double_dec": lambda X, c: X.C.Cast(c("x"),
                                             X.T.DecimalType(10, 2)),
    "cast_null_long": lambda X, c: X.C.Cast(X.lit(None), X.T.LONG),
    "cast_dec128_long": lambda X, c: X.C.Cast(c("D"), X.T.LONG),
    "cast_dec128_double": lambda X, c: X.C.Cast(c("D"), X.T.DOUBLE),
    "eqns_int": lambda X, c: X.P.EqualNullSafe(c("i"), c("j")),
    "eqns_double": lambda X, c: X.P.EqualNullSafe(c("x"), c("y")),
    "eqns_str": lambda X, c: X.P.EqualNullSafe(c("s"), c("t")),
    "eqns_dec128": lambda X, c: X.P.EqualNullSafe(c("D"), c("D")),
    "isnan": lambda X, c: X.P.IsNaN(c("x")),
    "nanvl": lambda X, c: X.CO.NaNvl(c("x"), c("y")),
    "greatest_int": lambda X, c: X.CO.Greatest([c("i"), c("j"), c("nf")]),
    "greatest_double": lambda X, c: X.CO.Greatest([c("x"), c("y")]),
    "least_double": lambda X, c: X.CO.Least([c("x"), c("y")]),
    "least_long": lambda X, c: X.CO.Least([c("l"), c("k")]),
    "greatest_dec": lambda X, c: X.CO.Greatest([c("p"), c("q")]),
    "greatest_str": lambda X, c: X.CO.Greatest([c("s"), c("t")]),
    "least_str": lambda X, c: X.CO.Least([c("s"), c("t")]),
    "nvl2": lambda X, c: X.CO.Nvl2(c("i"), c("l"), c("k")),
    "nvl2_str": lambda X, c: X.CO.Nvl2(c("x"), c("s"), c("t")),
    "nullif_int": lambda X, c: X.CO.NullIf(c("i"), c("j")),
    "nullif_str": lambda X, c: X.CO.NullIf(c("s"), c("t")),
    "sqrt": lambda X, c: X.M.Sqrt(c("x")),
    "rint": lambda X, c: X.M.Rint(c("x")),
    "signum": lambda X, c: X.M.Signum(c("x")),
    "degrees": lambda X, c: X.M.ToDegrees(c("x")),
    "radians": lambda X, c: X.M.ToRadians(c("x")),
    "floor_double": lambda X, c: X.M.Floor(c("x")),
    "ceil_double": lambda X, c: X.M.Ceil(c("x")),
    "floor_dec": lambda X, c: X.M.Floor(c("d")),
    "ceil_dec": lambda X, c: X.M.Ceil(c("d")),
    "floor_int": lambda X, c: X.M.Floor(c("i")),
    "round_double": lambda X, c: X.M.Round(c("x"), X.lit(2)),
    "round_double_0": lambda X, c: X.M.Round(c("x"), X.lit(0)),
    "round_dec": lambda X, c: X.M.Round(c("d"), X.lit(2)),
    "round_long": lambda X, c: X.M.Round(c("l"), X.lit(1)),
    "bround_double": lambda X, c: X.M.BRound(c("x"), X.lit(1)),
    "width_bucket": lambda X, c: X.M.WidthBucket(
        c("x"), X.lit(-100.0), X.lit(100.0), X.lit(10)),
    "width_bucket_desc": lambda X, c: X.M.WidthBucket(
        c("y"), X.lit(5.0), X.lit(-5.0), X.lit(4)),
    "factorial": lambda X, c: X.M.Factorial(c("nf")),
    "bit_count_long": lambda X, c: X.M.BitwiseCount(c("l")),
    "bit_count_int": lambda X, c: X.M.BitwiseCount(c("i")),
    "bit_count_bool": lambda X, c: X.M.BitwiseCount(c("b")),
}

#: the transcendental functions (held within ``ULPS`` of the reference)
TRANSCENDENTAL_CASES = {
    "exp": lambda X, c: X.M.Exp(c("x")),
    "log": lambda X, c: X.M.Log(c("x")),
    "log10": lambda X, c: X.M.Log10(c("x")),
    "log2": lambda X, c: X.M.Log2(c("x")),
    "log1p": lambda X, c: X.M.Log1p(c("x")),
    "expm1": lambda X, c: X.M.Expm1(c("x")),
    "sin": lambda X, c: X.M.Sin(c("x")),
    "cos": lambda X, c: X.M.Cos(c("x")),
    "tan": lambda X, c: X.M.Tan(c("x")),
    "asin": lambda X, c: X.M.Asin(c("x")),
    "acos": lambda X, c: X.M.Acos(c("x")),
    "atan": lambda X, c: X.M.Atan(c("x")),
    "sinh": lambda X, c: X.M.Sinh(c("x")),
    "cosh": lambda X, c: X.M.Cosh(c("x")),
    "tanh": lambda X, c: X.M.Tanh(c("x")),
    "asinh": lambda X, c: X.M.Asinh(c("x")),
    "acosh": lambda X, c: X.M.Acosh(c("x")),
    "atanh": lambda X, c: X.M.Atanh(c("x")),
    "cbrt": lambda X, c: X.M.Cbrt(c("x")),
    "cot": lambda X, c: X.M.Cot(c("x")),
    "csc": lambda X, c: X.M.Csc(c("x")),
    "sec": lambda X, c: X.M.Sec(c("x")),
    "pow": lambda X, c: X.M.Pow(c("x"), c("y")),
    "atan2": lambda X, c: X.M.Atan2(c("x"), c("y")),
    "hypot": lambda X, c: X.M.Hypot(c("x"), c("y")),
    "logarithm": lambda X, c: X.M.Logarithm(c("y"), c("x")),
}
#: units in the last place the transcendental functions may differ by
ULPS = 4

#: cases the tagging keeps off the device in both packages (decimals above
#: 18 digits, a divide's numerator past 18 digits): CPU stages
HOST_CASES = {
    "div_dec128": lambda X, c: X.A.Divide(c("D"), c("E")),
    "div_dec18": lambda X, c: X.A.Divide(c("d"), c("e")),
    "div_dec128_lit": lambda X, c: X.A.Divide(c("D"), _dec("7.0")(X, c)),
    "rem_dec128": lambda X, c: X.A.Remainder(c("D"), c("E")),
    "neg_dec128": lambda X, c: X.A.UnaryMinus(c("D")),
    "abs_dec128": lambda X, c: X.A.Abs(c("D")),
    "floor_dec128": lambda X, c: X.M.Floor(c("D")),
    "ceil_dec128": lambda X, c: X.M.Ceil(c("D")),
    "round_dec128": lambda X, c: X.M.Round(c("D"), X.lit(2)),
    "try_div_dec128": lambda X, c: X.A.TryDivide(c("D"), c("E")),
    "try_add_dec128": lambda X, c: X.A.TryAdd(c("D"), c("E")),
    "try_mul_dec128": lambda X, c: X.A.TryMultiply(c("D"), c("E")),
    "cast_float_dec128": lambda X, c: X.C.Cast(c("f"),
                                               X.T.DecimalType(38, 2)),
}

#: ANSI cases: name -> builder(X, col); each raises on the table under
#: ANSI (the reference's oracle lets some pass: the test's
#: ``ANSI_ORACLE_SILENT``)
ANSI_CASES = {
    "div_zero_double": lambda X, c: X.A.Divide(c("x"), X.lit(0.0)),
    "intdiv_zero": lambda X, c: X.A.IntegralDivide(c("l"), X.lit(0)),
    "rem_zero": lambda X, c: X.A.Remainder(c("i"), X.lit(0)),
    "div_dec_zero": lambda X, c: X.A.Divide(c("p"), _dec("0.00")(X, c)),
    "div_dec128_zero": lambda X, c: X.A.Divide(c("D"),
                                               _dec("0.00")(X, c)),
    "cast_long_int": lambda X, c: X.C.Cast(c("l"), X.T.INT),
    "cast_double_int": lambda X, c: X.C.Cast(c("x"), X.T.INT),
    "neg_long_min": lambda X, c: X.A.UnaryMinus(c("l")),
    "abs_int_min": lambda X, c: X.A.Abs(c("i")),
    "add_overflow": lambda X, c: X.A.Add(c("l"), c("l")),
    "cast_double_dec": lambda X, c: X.C.Cast(c("x"),
                                             X.T.DecimalType(5, 2)),
    # in a CPU stage: a double to a decimal above 18 digits is tagged off
    "cast_float_dec128": lambda X, c: X.C.Cast(c("f"),
                                               X.T.DecimalType(38, 2)),
}


def select_cases(mod, df, cases):
    """``df`` with every case as a column named after it, in the package
    whose session module is ``mod``."""
    X = mods(mod)
    return df.select(*[b(X, mod.col).alias(n) for n, b in cases.items()])


def columns(rows, cases):
    return {n: [r[i] for r in rows] for i, n in enumerate(cases)}


def encode(v):
    """A collected value as JSON (a float by its hex, a Decimal by its
    string)."""
    if isinstance(v, float):
        return {"f": v.hex()}
    if isinstance(v, Decimal):
        return {"d": str(v)}
    return v


def decode(v):
    if isinstance(v, dict):
        return float.fromhex(v["f"]) if "f" in v else Decimal(v["d"])
    return v


def same(a, b, ulps: int = 0) -> bool:
    """Equal values; NaN equals NaN; doubles within ``ulps`` units in the
    last place of ``b`` when ``ulps`` is given."""
    import math

    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if a == b:
            return True
        return ulps > 0 and math.isfinite(b) and \
            abs(a - b) <= ulps * math.ulp(b)
    return a == b and type(a) is type(b)

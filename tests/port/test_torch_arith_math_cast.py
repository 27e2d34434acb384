"""Slice 13's expressions against the reference: division, the rest of
arithmetic, the bitwise operators and shifts, ``try_*``, the numeric and
boolean casts, ``<=>``, ``isnan``, the conditionals and every math
function, over the seeded edge-case table of ``torch_port_arith.py``
(negatives and zero divisors, NaN, +-inf, +-0.0, subnormals, values at
2^31, 2^53, 2^62 and 2^63, decimals at 18 and 38 digits, HALF_UP ties,
shift amounts at and past the width).  The port runs on the CPU; the
reference's device session runs in the child process (one call for the
module) and its CPU oracle in-process.

Against the reference's oracle (numpy, Python integers and ``decimal``:
IEEE doubles) every comparison is exact, but the transcendental
functions, which are held within ``ULPS`` (4) units in the last place
(torch and numpy each have their own ``exp``, ``log``, ``pow`` and
trigonometry).  Against the reference's device (XLA on the CPU) integers,
decimals and booleans are exact and doubles within a relative 1e-12, as
the earlier slices' tests hold them: XLA's CPU divides by a constant as a
multiply by its reciprocal and approximates ``sqrt`` and the
transcendental functions; it also flushes subnormals to zero, so the rows
with a subnormal input are held to the oracle only.  Where the
reference's device and its oracle disagree, the port takes one side and
``DEPARTURES`` names the other; each departure also has a test below that
shows both values on one input (ROADMAP.md Queue 3, R10-R19).  The ANSI
cases raise in all three."""
import json
import math
from decimal import ROUND_HALF_EVEN, ROUND_HALF_UP, Decimal, localcontext

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_arith import (ANSI_CASES, DEVICE_CASES, HOST_CASES, ULPS,
                              TRANSCENDENTAL_CASES, arith_schema,
                              arith_table, columns, decode, mods, same,
                              select_cases)
from torch_port_frames import ORACLE, frame
from torch_port_jaxref import run_jax

SEED = 17
ANSI = {"spark.sql.ansi.enabled": True}
GROUPS = {"device": DEVICE_CASES, "transcendental": TRANSCENDENTAL_CASES,
          "host": HOST_CASES}
ALL = {**DEVICE_CASES, **TRANSCENDENTAL_CASES, **HOST_CASES}

#: case -> (the side the port departs from, why): the port equals the
#: other side exactly, and the named side differs on some row
DEPARTURES = {
    # Java's % on doubles is the exact fmod; the reference's device
    # computes a - trunc(a / b) * b (R10)
    "rem_double": ("device", "R10"),
    "pmod_double": ("device", "R10"),
    # Spark's pmod keeps a negative divisor's sign; the reference's
    # oracle takes the remainder modulo |b| for decimals (R11)
    "pmod_dec": ("oracle", "R11"),
    # the device rounds the double times 10^s half to even (R12)
    "cast_double_dec": ("oracle", "R12"),
    # floor(x * 10^s + 0.5) / 10^s against the decimal string's HALF_UP
    # (R13)
    "round_double": ("oracle", "R13"),
    "round_double_0": ("oracle", "R13"),
    # numpy's floor of NaN or +-inf to int64 is -2^63; Java's (long) is 0
    # or saturates (R14)
    "floor_double": ("oracle", "R14"),
    "ceil_double": ("oracle", "R14"),
    # T.numeric admits 38-digit decimals: the reference's device runs these
    # on limb pairs as if they were int64 (R15)
    "neg_dec128": ("device", "R15"),
    "abs_dec128": ("device", "R15"),
    "floor_dec128": ("device", "R15"),
    # ... and the oracle's decimal context rounds to 28 digits first
    # (R16)
    "ceil_dec128": ("device oracle", "R15, R16"),
    # the reference's oracle takes an integral % through math.fmod in
    # doubles, wrong past 2^53 (R18)
    "rem_long": ("oracle", "R18"),
    "pmod_long": ("oracle", "R18"),
    # the reference's device clamps -2^63 to -2^63 + 1024 before its
    # conversion to a long (R19)
    "cast_double_int": ("device", "R19"),
    "cast_double_long": ("device", "R19"),
    "cast_double_short": ("device", "R19"),
    # a decimal above 18 digits to a double: the device rounds twice (its
    # limbs to a double, then / 10^scale), the oracle once (R21)
    "cast_dec128_double": ("oracle", "R21"),
}
#: ANSI cases the reference's oracle lets pass (it wraps), where Spark,
#: the port and the reference's device raise (R20)
ANSI_ORACLE_SILENT = {"cast_long_int", "cast_double_int", "neg_long_min",
                      "abs_int_min"}


#: cases the reference's device raises on (R15: ``T.numeric`` admits
#: 38-digit decimals, so its device runs these on limb pairs and fails
#: on the shapes)
DEVICE_RAISES = {"round_dec128"}
#: cases the reference's oracle raises on, on this table (R16): its round
#: of a double goes through ``Decimal(repr(x))``, which NaN and the
#: infinities stop; its round of a 38-digit decimal and its cast of 1e300
#: to a decimal pass the decimal module's 28-digit context
ORACLE_RAISES = {"round_double", "round_double_0", "round_dec128",
                 "cast_double_dec"}


def _frame(mod, types, session):
    arrays, validity = arith_table(SEED)
    return frame(mod, session, arrays, arith_schema(types), validity)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference device session's column of every case, each group
    one collect, and whether each ANSI case raised, in one child call."""
    out = run_jax(f"""
    import json, sys
    sys.path.insert(0, "tests/port")
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import test_torch_arith_math_cast as M
    import torch_port_arith as X
    get_device_manager(TpuConf({{}}))
    cols = {{}}
    raised = {{}}
    for cases in M.GROUPS.values():
        # one collect a group; a group with a case the reference's device
        # fails on (R15, R17) again one case at a time
        try:
            parts = [(cases, X.select_cases(
                RS, M._frame(RS, T, RS.TpuSession({{}})), cases).collect())]
        except Exception:
            parts = []
            for n, b in cases.items():
                try:
                    parts.append(({{n: b}}, X.select_cases(
                        RS, M._frame(RS, T, RS.TpuSession({{}})),
                        {{n: b}}).collect()))
                except Exception as ex:
                    raised[n] = type(ex).__name__
        for part, rows in parts:
            for name, col in X.columns(rows, part).items():
                cols[name] = [X.encode(v) for v in col]
    for name, build in X.ANSI_CASES.items():
        try:
            X.select_cases(RS, M._frame(RS, T, RS.TpuSession(M.ANSI)),
                           {{name: build}}).collect()
            raised[name] = False
        except Exception as ex:
            raised[name] = type(ex).__name__
    out["json"] = np.array([json.dumps({{"cols": cols, "raised": raised}})])
    """, tmp_path_factory.mktemp("arithref"))
    got = json.loads(str(out["json"][0]))
    return ({n: [decode(v) for v in c] for n, c in got["cols"].items()},
            got["raised"])


@pytest.fixture(scope="module")
def port_and_oracle():
    """The port's columns (one collect a group) and the reference
    oracle's (one a case; the name of its exception where it raises)."""
    port, oracle = {}, {}
    for cases in GROUPS.values():
        port.update(columns(select_cases(
            S, _frame(S, T, S.TpuSession({}, device="cpu")), cases)
            .collect(), cases))
        for name, build in cases.items():
            try:
                oracle[name] = columns(select_cases(
                    RS, _frame(RS, RT, RS.TpuSession(ORACLE)),
                    {name: build}).collect(), [name])[name]
            except Exception as ex:
                oracle[name] = type(ex).__name__
    return port, oracle


def _differs(a, b, ulps=0, rows=None):
    return [i for i, (x, y) in enumerate(zip(a, b))
            if (rows is None or rows[i]) and not same(x, y, ulps)]


def _near(a, b) -> bool:
    """Within a relative 1e-12, or a subnormal against the zero XLA's CPU
    flushes it to."""
    return (isinstance(a, float) and isinstance(b, float)
            and math.isfinite(a) and math.isfinite(b)
            and (abs(a - b) <= 1e-12 * max(abs(a), abs(b))
                 or (b == 0.0 and abs(a) <= 2.2250738585072014e-308)))


def _normal_rows():
    """Rows without a subnormal double or float input."""
    arrays, _ = arith_table(SEED)
    keep = np.ones(len(arrays["x"]), np.bool_)
    for name, tiny in (("x", 2.2250738585072014e-308),
                       ("y", 2.2250738585072014e-308), ("f", 1.1754944e-38)):
        v = np.abs(arrays[name].astype(np.float64))
        keep &= ~((v > 0) & (v < tiny))
    return keep


@pytest.mark.parametrize("name", list(ALL))
def test_case_equals_reference(name, reference, port_and_oracle):
    """The port's column equals the reference device's and its oracle's
    (the transcendental functions within ``ULPS``); a departure equals
    one side and differs from the other on some row."""
    got = port_and_oracle[0][name]
    sides = {"device": reference[0].get(name, reference[1].get(name)),
             "oracle": port_and_oracle[1][name]}
    ulps = ULPS if name in TRANSCENDENTAL_CASES else 0
    off = DEPARTURES.get(name, ("",))[0].split()
    for side, raises in (("device", DEVICE_RAISES), ("oracle",
                                                     ORACLE_RAISES)):
        # a side that raises on the table is not compared (R15, R16)
        assert isinstance(sides[side], str) == (name in raises), (
            name, side, sides[side] if isinstance(sides[side], str) else "")
        if name in raises:
            del sides[side]
    assert len(got) > 0
    normal = _normal_rows()
    for side, want in sides.items():
        if side == "device":
            bad = [i for i in _differs(got, want, ulps, normal)
                   if not _near(got[i], want[i])]
        else:
            bad = _differs(got, want, ulps)
        if side in off:
            assert bad, f"{name}: no longer departs from the {side}"
        else:
            assert not bad, (name, side, [(i, got[i], want[i])
                                          for i in bad[:5]])


def test_cases_cover_the_edges():
    """The table holds what the docstring says it holds."""
    arrays, validity = arith_table(SEED)
    x = arrays["x"][validity["x"]]
    assert np.isnan(x).any() and np.isinf(x).all() is not True
    assert {float("inf"), float("-inf"), 5e-324, 2.0 ** 63} <= set(x)
    assert np.signbit(x[x == 0]).any() and (~np.signbit(x[x == 0])).any()
    assert {2 ** 53, 2 ** 62, 2 ** 63 - 1, -2 ** 63} <= set(
        arrays["l"].tolist())
    assert {0, 31, 32, 63, 64, -1} <= set(arrays["sh"].tolist())
    assert 0 in arrays["k"] and 0 in arrays["j"] and 0 in arrays["e"]
    d38 = [(int(h) << 64) | (int(lo) & (2 ** 64 - 1))
           for h, lo in arrays["D"]]
    assert 10 ** 38 - 1 in d38 and -(10 ** 38 - 1) in [
        v - 2 ** 128 if v >= 2 ** 127 else v for v in d38]
    assert 10 ** 18 - 1 in arrays["d"]


@pytest.mark.parametrize("name", list(ANSI_CASES))
def test_ansi_case_raises_everywhere(name, reference):
    """Under ANSI each case raises on the port (``SparkArithmeticException``,
    on the device or in its CPU stage) and the reference's device; and on
    its oracle, but for the overflows it wraps (``ANSI_ORACLE_SILENT``,
    R20)."""
    from spark_rapids_tpu.expr.base import SparkArithmeticException as RE
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException

    build = {name: ANSI_CASES[name]}
    with pytest.raises(SparkArithmeticException):
        select_cases(S, _frame(S, T, S.TpuSession(ANSI, device="cpu")),
                     build).collect()
    oracle = RS.TpuSession(dict(ORACLE, **ANSI))
    if name in ANSI_ORACLE_SILENT:
        select_cases(RS, _frame(RS, RT, oracle), build).collect()
    else:
        with pytest.raises(RE):
            select_cases(RS, _frame(RS, RT, oracle), build).collect()
    assert reference[1][name], name


def test_try_ops_null_instead_of_raising_under_ansi():
    """try_divide by zero and a try_add that overflows are null under
    ANSI, on the device and in a CPU stage."""
    X = mods(S)
    df = _frame(S, T, S.TpuSession(ANSI, device="cpu"))
    c = S.col
    rows = df.select(X.A.TryDivide(c("x"), S.lit(0.0)).alias("a"),
                     X.A.TryAdd(c("l"), c("l")).alias("b"),
                     X.A.TryDivide(c("D"), S.lit(Decimal("0.00")))
                     .alias("c")).collect()
    assert all(r[0] is None and r[2] is None for r in rows)
    assert any(r[1] is None for r in rows) and any(
        r[1] is not None for r in rows)


def _one(mod, types, session, build, arrays, fields):
    sch = types.StructType([types.StructField(n, t) for n, t in fields])
    df = frame(mod, session, arrays, sch)
    return [r[0] for r in select_cases(mod, df, {"v": build}).collect()]


def test_r10_fmod_is_exact():
    """Java's 5.3 % 0.1 is the exact remainder 0.09999999999999953 (C
    fmod: the port, the reference's oracle); the reference's device
    a - trunc(a/b) * b gives 0.09999999999999964."""
    got = _one(S, T, S.TpuSession({}, device="cpu"),
               lambda X, c: X.A.Remainder(c("x"), c("y")),
               {"x": np.array([5.3]), "y": np.array([0.1])},
               [("x", T.DOUBLE), ("y", T.DOUBLE)])
    assert got == [math.fmod(5.3, 0.1)] == [0.09999999999999953]
    assert 5.3 - math.trunc(5.3 / 0.1) * 0.1 == 0.09999999999999964


def test_r11_decimal_pmod_keeps_the_divisors_sign():
    """pmod(-7.00, -3.00) is -1.00 in Spark and the port (as for
    integers); the reference's oracle gives 2.00 (its decimal pmod takes
    the remainder modulo |b|).  And a decimal remainder of operands of
    different scales rescales them: 1.5 % 0.20 is 0.10 (the reference's
    device takes 15 % 20 of the unscaled values)."""
    sess = S.TpuSession({}, device="cpu")
    got = _one(S, T, sess, lambda X, c: X.A.Pmod(c("a"), c("b")),
               {"a": np.array([-700]), "b": np.array([-300])},
               [("a", T.DecimalType(5, 2)), ("b", T.DecimalType(5, 2))])
    assert got == [Decimal("-1.00")]
    assert _one(S, T, sess, lambda X, c: X.A.Pmod(c("a"), c("b")),
                {"a": np.array([-7]), "b": np.array([-3])},
                [("a", T.INT), ("b", T.INT)]) == [-1]
    oracle = _one(RS, RT, RS.TpuSession(ORACLE),
                  lambda X, c: X.A.Pmod(c("a"), c("b")),
                  {"a": np.array([-700]), "b": np.array([-300])},
                  [("a", RT.DecimalType(5, 2)), ("b", RT.DecimalType(5, 2))])
    assert oracle == [Decimal("2.00")]
    rem = _one(S, T, sess, lambda X, c: X.A.Remainder(c("a"), c("b")),
               {"a": np.array([15]), "b": np.array([20])},
               [("a", T.DecimalType(3, 1)), ("b", T.DecimalType(3, 2))])
    assert rem == [Decimal("0.10")]


def test_r12_double_to_decimal_rounds_the_scaled_double():
    """CAST(0.125 AS DECIMAL(10,2)): the device (the port and the
    reference's) rounds 12.5 half to even, 0.12; Spark and the
    reference's oracle round 0.125 HALF_UP, 0.13."""
    build = lambda X, c: X.C.Cast(c("x"), X.T.DecimalType(10, 2))  # noqa
    got = _one(S, T, S.TpuSession({}, device="cpu"), build,
               {"x": np.array([0.125])}, [("x", T.DOUBLE)])
    oracle = _one(RS, RT, RS.TpuSession(ORACLE), build,
                  {"x": np.array([0.125])}, [("x", RT.DOUBLE)])
    assert got == [Decimal("0.12")] and oracle == [Decimal("0.13")]


def test_r13_round_of_a_double():
    """round(0.285, 2): the device's floor(28.499999999999996 + 0.5) / 100
    is 0.28; Spark's BigDecimal("0.285") HALF_UP, the reference's oracle,
    0.29."""
    build = lambda X, c: X.M.Round(c("x"), X.lit(2))  # noqa
    got = _one(S, T, S.TpuSession({}, device="cpu"), build,
               {"x": np.array([0.285])}, [("x", T.DOUBLE)])
    oracle = _one(RS, RT, RS.TpuSession(ORACLE), build,
                  {"x": np.array([0.285])}, [("x", RT.DOUBLE)])
    assert got == [0.28] and oracle == [0.29]


def test_r14_floor_of_nan_and_infinity():
    """floor(NaN) is 0 and floor(+-inf) saturates, as Java's (long) of
    Math.floor; numpy's conversion in the reference's oracle gives
    -2^63 for all three."""
    build = lambda X, c: X.M.Floor(c("x"))  # noqa
    x = np.array([float("nan"), float("inf"), float("-inf")])
    got = _one(S, T, S.TpuSession({}, device="cpu"), build, {"x": x},
               [("x", T.DOUBLE)])
    assert got == [0, 2 ** 63 - 1, -2 ** 63]


def test_bround_of_a_decimal_is_half_even_in_a_cpu_stage():
    """bround of a decimal is tagged off the device
    (``_check_bround``, the reference's words) and the CPU stage rounds
    HALF_EVEN (the reference's oracle computes it in doubles)."""
    vals = [12345, -12345, 12355, 12350, -12250, 7]
    q = frame(S, S.TpuSession({}, device="cpu"),
              {"v": np.array(vals)},
              T.StructType([T.StructField("v", T.DecimalType(9, 3))])) \
        .select(mods(S).M.BRound(S.col("v"), S.lit(1)).alias("r"))
    assert "bround over decimals" in q.explain()
    want = [Decimal(v).scaleb(-3).quantize(Decimal("0.1"), ROUND_HALF_EVEN)
            for v in vals]
    assert [r[0] for r in q.collect()] == want


def test_casts_outside_the_table_and_string_casts():
    """A cast outside the reference's table is tagged with its words (and
    the CPU engine, which has no such cast either, refuses it when
    planned); a string cast (in the reference's table, ported in slice
    17: ``test_torch_timestamps.py`` holds every one) runs and equals the
    reference oracle's rows."""
    from spark_rapids_tpu_torch.exec.base import NotOnGpu

    df = _frame(S, T, S.TpuSession({}, device="cpu"))
    X = mods(S)
    with pytest.raises(NotOnGpu, match="cast from boolean to date is not "
                       "supported on TPU"):
        df.select(X.C.Cast(S.col("b"), T.DATE).alias("v")).collect()
    got = df.select(X.C.Cast(S.col("i"), T.STRING).alias("v")).collect()
    RX = mods(RS)
    want = _frame(RS, RT, RS.TpuSession(ORACLE)).select(
        RX.C.Cast(RS.col("i"), RT.STRING).alias("v")).collect()
    assert got == want and any(r[0] is not None for r in got)


def test_operators_build_expressions():
    """``a / b``, ``a % b`` and ``-a`` build Divide, Remainder and
    UnaryMinus, as in the reference."""
    X = mods(S)
    a, b = S.col("a"), S.col("b")
    assert type(a / b) is X.A.Divide and type(a % b) is X.A.Remainder
    assert type(-a) is X.A.UnaryMinus


#: (op, left type, right type, seed): the CPU engine's decimal divide,
#: remainder and pmod on limbs against their Python-integer twin
LIMB_SHAPES = [
    ("Divide", (38, 6), (20, 2), 1), ("Divide", (30, 0), (10, 0), 2),
    ("Divide", (22, 2), (2, 1), 3), ("Divide", (38, 10), (3, 2), 4),
    ("Remainder", (38, 6), (20, 2), 5), ("Pmod", (38, 6), (20, 2), 6),
    ("Pmod", (30, 3), (12, 1), 7)]


def _dec_cols(vals, dt):
    from spark_rapids_tpu_torch.cpu import oracle as O

    v = np.array(vals, dtype=object)
    valid = np.ones(len(v), np.bool_)
    return O.CpuCol(dt, O._from_py_ints(v, valid, dt), valid)


@pytest.mark.parametrize("op,lt,rt,seed", LIMB_SHAPES)
def test_cpu_stage_decimal_divide_limbs_equal_python_twin(op, lt, rt, seed):
    """Random operands up to the types' precisions (the numerator below
    2^127 and the divisor below 2^62 after scaling, so the limb path takes
    them), zero divisors (null, or the ANSI error), HALF_UP ties of both
    signs and quotients at 38 digits: the limb path equals the twin."""
    from spark_rapids_tpu_torch.cpu import oracle as O
    from spark_rapids_tpu_torch.expr import arithmetic as A
    from spark_rapids_tpu_torch.expr.base import (BoundReference,
                                                  SparkArithmeticException)

    rng = np.random.default_rng(seed)
    ltp, rtp = T.DecimalType(*lt), T.DecimalType(*rt)
    e = getattr(A, op)(BoundReference(0, ltp), BoundReference(1, rtp))
    e = e.resolve(None)
    ka, kb = O._dec_operands(e)
    amax = min(10 ** lt[0], (2 ** 126) // 10 ** ka) - 1
    bmax = min(10 ** rt[0], (2 ** 61) // 10 ** kb) - 1
    a = [int(x) % amax * (1 if x % 2 else -1)
         for x in rng.integers(0, 2 ** 62, 400) * 2 ** 40 + rng.integers(
             0, 2 ** 40, 400)]
    b = [int(x) % bmax * (1 if x % 3 else -1) for x in
         rng.integers(0, 2 ** 62, 400)]
    # ties: a / b = k + 0.5 at the quotient's scale, of both signs
    shift = e.dataType.scale - lt[1] + rt[1] if op == "Divide" else 0
    if op == "Divide" and shift == 0:
        a[:4], b[:4] = [1, -1, 3, -5], [2, 2, -2, -2]
    b[4:6] = [0, 0]                                  # zero divisors
    a[6], b[6] = amax, 1                             # the largest quotient
    l, r = _dec_cols(a, ltp), _dec_cols(b, rtp)
    valid = O._zero_divisors(r, l.validity & r.validity, False)
    assert O._divmod_limbs(e, l, r, valid) is not None     # limbs taken
    got = O._dec_divmod(e, l, r, False)
    want = O._dec_divmod_py(e, l, r, valid, False)
    assert np.array_equal(got.validity, want.validity)
    assert np.array_equal(np.where(got.validity[:, None] if got.values.ndim
                                   == 2 else got.validity, got.values, 0),
                          np.where(want.validity[:, None] if want.values.ndim
                                   == 2 else want.validity, want.values, 0))
    assert not got.validity[4:6].any() and got.validity[6:].sum() > 300
    with pytest.raises(SparkArithmeticException, match="division by zero"):
        O._dec_divmod(e, l, r, True)


def test_cpu_stage_decimal_divide_past_128_bits_takes_python_integers():
    """A numerator past 2^127 after its scaling (38 digits times 10^7)
    goes through Python integers: exact, HALF_UP, and a quotient past
    38 digits null, or the ANSI error."""
    from spark_rapids_tpu_torch.cpu import oracle as O
    from spark_rapids_tpu_torch.expr import arithmetic as A
    from spark_rapids_tpu_torch.expr.base import (BoundReference,
                                                  SparkArithmeticException)

    ltp, rtp = T.DecimalType(38, 0), T.DecimalType(2, 1)
    e = A.Divide(BoundReference(0, ltp), BoundReference(1, rtp)).resolve(
        None)
    assert e.dataType == T.DecimalType(38, 6)
    a = [10 ** 38 - 1, 10 ** 30 + 1, -7, 10 ** 31 - 1]
    b = [10, 30, 20, 10]
    l, r = _dec_cols(a, ltp), _dec_cols(b, rtp)
    valid = np.ones(4, np.bool_)
    assert O._divmod_limbs(e, l, r, valid) is None
    got = O._dec_divmod(e, l, r, False)
    assert got.validity.tolist() == [False, True, True, True]
    vals = O._py_ints(got)
    with localcontext() as ctx:
        ctx.prec = 80
        want = [(Decimal(x) / (Decimal(y) / 10)).quantize(
            Decimal("0.000001"), ROUND_HALF_UP).scaleb(6)
            for x, y in zip(a, b)]
    assert list(vals[1:]) == [int(w) for w in want[1:]]
    assert vals[1] % 10 == 7 and vals[2] == -3_500_000   # up; -3.5 exact
    with pytest.raises(SparkArithmeticException, match="overflow"):
        O._dec_divmod(e, l, r, True)


def test_cpu_stage_python_divide_rows_a_second():
    """The Python-integer path's rate on 100,000 rows of 38-digit
    operands (printed; ``PERF.md`` cites it from this test's output)."""
    import time

    from spark_rapids_tpu_torch.cpu import oracle as O
    from spark_rapids_tpu_torch.expr import arithmetic as A
    from spark_rapids_tpu_torch.expr.base import BoundReference

    rng = np.random.default_rng(3)
    n = 100_000
    ltp, rtp = T.DecimalType(38, 0), T.DecimalType(2, 1)
    e = A.Divide(BoundReference(0, ltp), BoundReference(1, rtp)).resolve(
        None)
    # past 2^127 once scaled by 10^7, a quotient within 38 digits
    a = [int(x) * 10 ** 14 for x in rng.integers(2 * 10 ** 17, 5 * 10 ** 17,
                                                 n)]
    l = _dec_cols(a, ltp)
    r = _dec_cols([int(x) for x in rng.integers(10, 99, n)], rtp)
    assert O._divmod_limbs(e, l, r, l.validity) is None
    t0 = time.perf_counter()
    got = O._dec_divmod(e, l, r, False)
    rate = n / (time.perf_counter() - t0)
    print(f"CPU stage decimal divide, Python integers: {rate:.0f} rows/s")
    assert got.validity.all() and rate > 0


def test_device_half_up_step_near_2_62():
    """The device decimal divide's HALF_UP step (``div_half_up``) asks
    ``|rem| >= |den| - |rem|``, never doubling the remainder: exact
    against Python integers for divisors near +-2^62 and remainders at,
    just under and just over half of them, of every sign."""
    import torch

    from spark_rapids_tpu_torch.expr.arithmetic import div_half_up

    big = 2 ** 62 - 1
    nums, dens = [], []
    for den in (big, -big, big - 1, -(big - 1), 2 ** 61 + 1, 3, -3):
        half = abs(den) // 2
        for q in (0, 1, 2):
            for rem in (half - 1, half, half + 1, abs(den) - 1, 0):
                n = q * abs(den) + rem
                if n < 2 ** 63:
                    for sn in (1, -1):
                        nums.append(sn * n)
                        dens.append(den)
    got = div_half_up(torch.tensor(nums), torch.tensor(dens)).tolist()
    want = [(1 if (a < 0) == (b < 0) else -1)
            * ((2 * abs(a) + abs(b)) // (2 * abs(b)))
            for a, b in zip(nums, dens)]
    assert got == want and len(got) > 150

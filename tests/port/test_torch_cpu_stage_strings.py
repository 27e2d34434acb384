"""The port's CPU stage (``cpu/oracle.py``) with strings and limbs:
string columns through a stage — references, ``Alias``, comparisons, ``In``,
``If``/``CaseWhen``, ``Coalesce`` — and across both transitions (the
download under the stage, the upload above it at the width ladder's
width, their char matrices counted in ``bytes_d2h``/``bytes_h2d``),
against the JAX package's CPU oracle session; and the decimal ``+``,
``-``, ``*`` and casts on int64 limbs held against their Python-integer
twins (``_h_binarith_py``, ``_h_cast_py``), including 128 x 64-bit
products, results past 38 digits (null) and the ANSI error.  Every
comparison is exact."""
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DEFAULT_WIDTH_BUCKETS
from spark_rapids_tpu_torch.cpu import oracle as O
from spark_rapids_tpu_torch.expr.base import SparkArithmeticException
from torch_port_frames import ORACLE, frame, rows_key

N = 600
WORDS = np.array(["", "a", "ab", "abc", "b", "a\x00", "naïve", "x" * 40],
                 object)
NO_DEVICE_PROJECT = {"spark.rapids.sql.exec.Project": "false"}


def schema(mod):
    return mod.StructType([mod.StructField("k", mod.INT),
                           mod.StructField("s", mod.STRING),
                           mod.StructField("t", mod.STRING),
                           mod.StructField("v", mod.LONG)])


def base(mod, types, session):
    rng = np.random.default_rng(41)
    arr = {"k": rng.integers(0, 6, N).astype(np.int32),
           "s": WORDS[rng.integers(0, len(WORDS), N)],
           "t": WORDS[rng.integers(0, len(WORDS), N)],
           "v": rng.integers(-100, 100, N)}
    valid = {c: rng.random(N) > 0.15 for c in arr}
    return frame(mod, session, arr, schema(types), valid)


def projected(mod, types, session):
    from importlib import import_module

    CO = import_module(mod.__name__.rsplit(".", 1)[0] + ".expr.conditional")
    col, lit = mod.col, mod.lit
    s, t = col("s"), col("t")
    return base(mod, types, session).select(
        "k", "s", s.alias("s2"), s.eq(t).alias("eq"), (s < t).alias("lt"),
        (s <= lit("ab")).alias("le"), (s > t).alias("gt"),
        (s >= lit("b")).alias("ge"),
        s.isin("a", "abc", "naïve").alias("isin"),
        CO.If(s < t, s, t).alias("least"),
        CO.CaseWhen([(col("v") > lit(0), s), (col("v") < lit(-50), lit("neg"))],
                    t).alias("cw"),
        CO.Coalesce([s, t, lit("none")]).alias("co"))


def test_strings_through_a_cpu_stage_match_oracle():
    """The Project runs as a CPU stage (the reference's kill switch) with
    string columns in every role the engine takes, under a device
    aggregate grouped by a string the stage made."""
    s = S.TpuSession(NO_DEVICE_PROJECT, device="cpu")
    df = projected(S, T, s)
    plan = df.explain()
    assert "cannot run on TPU" in plan
    want = projected(RS, RT, RS.TpuSession(ORACLE)).collect()
    assert rows_key(df.collect()) == rows_key(want)
    agg = projected(S, T, s).group_by("cw").agg(S.count_(None, "n"),
                                                S.max_("k", "m"))
    ragg = projected(RS, RT, RS.TpuSession(ORACLE)).group_by("cw").agg(
        RS.count_(None, "n"), RS.max_("k", "m"))
    assert agg.explain().splitlines()[1].strip().startswith(
        "TpuRowToColumnar <- Project")
    assert rows_key(agg.collect()) == rows_key(ragg.collect())


def test_strings_cross_both_transitions_at_ladder_width():
    """The stage's upload pads each string to the ladder's width (40
    bytes -> 128), not the host matrix's, counting the char matrices in
    ``bytes_h2d``; under a device scan, the download under the stage
    carries them, counted in ``bytes_d2h``."""
    def q(mod, types, session):
        return base(mod, types, session).filter(
            mod.col("s") > mod.lit("a")).select("k", "s", "t").group_by(
            "s").agg(mod.count_(None, "n"))

    want = rows_key(q(RS, RT, RS.TpuSession(ORACLE)).collect())
    for scan_on_host in (True, False):
        conf = dict(NO_DEVICE_PROJECT,
                    **{"spark.rapids.sql.exec.Filter": "false"})
        if scan_on_host:
            conf["spark.rapids.sql.exec.LocalTableScan"] = "false"
        df = q(S, T, S.TpuSession(conf, device="cpu"))
        r2c = df._planned().children[0]
        snap = PC.snapshot()
        host = r2c.run_cpu_stage()
        down = PC.since(snap)["bytes_d2h"]
        snap = PC.snapshot()
        batches = list(r2c.upload(host))
        up = PC.since(snap)["bytes_h2d"]
        assert up == sum(t.numel() * t.element_size() for b in batches
                         for c in b.columns for t in c.tensors())
        assert {c.width for b in batches for c in b.columns[1:]} == {128}
        if scan_on_host:
            assert [h.width for h in host[1:]] == [40, 40]
            assert down == 0
        else:
            assert down >= sum(h.chars.nbytes for h in host[1:])
        assert rows_key(df.collect()) == want


# -- decimal arithmetic on limbs against the Python-integer twins -----------

def _dec_frame(rng, n, types_):
    """Columns of several decimal widths, nulls and edge values."""
    specs = {"a": (9, 2), "b": (18, 4), "c": (26, 4), "d": (38, 6),
             "e": (20, 0)}
    cols, sch = [], []
    for name, (p, sc) in specs.items():
        dt = T.DecimalType(p, sc)
        hi = 10 ** p
        vals = [int(x) for x in rng.integers(-(2 ** 62), 2 ** 62, n)]
        vals = [(v * (1 + abs(v) % 10 ** max(p - 18, 1))) % hi
                * (1 if v % 2 else -1) for v in vals]
        vals[:4] = [hi - 1, -(hi - 1), 0, 1]
        valid = rng.random(n) > 0.1
        col = O.CpuCol(dt, O._from_py_ints(np.array(vals, object), valid,
                                          dt), valid)
        cols.append(col)
        sch.append(T.StructField(name, dt))
    # "n": "d" negated, so d - n crosses 38 digits at the edges
    d = cols[3]
    neg = -O._py_ints(d)
    cols.append(O.CpuCol(d.dtype, O._from_py_ints(neg, d.validity, d.dtype),
                         d.validity))
    sch.append(T.StructField("n", d.dtype))
    return cols, T.StructType(sch)


OPS = {"add": lambda l, r: l + r, "sub": lambda l, r: l - r,
       "mul": lambda l, r: l * r}
PAIRS = [("a", "b"), ("b", "b"), ("c", "a"), ("a", "c"), ("c", "b"),
         ("d", "a"), ("d", "d"), ("d", "n"), ("e", "c"), ("c", "c"),
         ("e", "e")]


@pytest.mark.parametrize("op", sorted(OPS))
def test_limb_arithmetic_equals_its_python_twin(op):
    """Every pair of widths: the values and nulls of the limb path equal
    the Python integers'; products past 38 digits (or past 128 bits) are
    null in both; under ANSI both raise on the first overflow."""
    rng = np.random.default_rng(len(op))
    n = 400
    cols, sch = _dec_frame(rng, n, T)
    overflowed = 0
    for lname, rname in PAIRS:
        e = OPS[op](S.col(lname), S.col(rname)).resolve(sch)
        fast = O.eval_expr(e, cols, n)
        plain = O._h_binarith_py(e, cols, n, False)
        assert np.array_equal(fast.validity, plain.validity), (lname, rname)
        assert np.array_equal(np.where(
            fast.validity[:, None] if fast.values.ndim == 2
            else fast.validity, fast.values, 0), np.where(
            plain.validity[:, None] if plain.values.ndim == 2
            else plain.validity, plain.values, 0)), (lname, rname)
        lost = (cols[sch.field_names().index(lname)].validity
                & cols[sch.field_names().index(rname)].validity
                & ~fast.validity)
        overflowed += int(lost.sum())
        raised = []
        for fn in (O.eval_expr, O._h_binarith_py):
            try:
                fn(e, cols, n, True)
                raised.append(False)
            except SparkArithmeticException:
                raised.append(True)
        assert raised[0] == raised[1] == bool(lost.any())
    assert overflowed > 0      # the 38-digit bound was crossed


def test_limb_casts_equal_their_python_twin():
    """Casts to a decimal up (a multiply by 10^k) and down (HALF_UP), from
    integers and decimals, with overflow past the target precision."""
    rng = np.random.default_rng(5)
    n = 300
    cols, sch = _dec_frame(rng, n, T)
    from spark_rapids_tpu_torch.expr.cast import Cast

    for name in sch.field_names():
        for to in (T.DecimalType(38, 10), T.DecimalType(12, 1),
                   T.DecimalType(20, 0), T.DecimalType(18, 8)):
            e = Cast(S.col(name), to).resolve(sch)
            fast = O.eval_expr(e, cols, n)
            plain = O._h_cast_py(e, cols, n, False)
            assert np.array_equal(fast.validity, plain.validity)
            m = (fast.validity[:, None] if fast.values.ndim == 2
                 else fast.validity)
            assert np.array_equal(np.where(m, fast.values, 0),
                                  np.where(m, plain.values, 0))


def test_q1_charge_in_a_cpu_stage_equals_decimal():
    """Q1's two products (a decimal(26,4) result, then 128 x 64 bits into
    decimal(38,6)) through the session's CPU stage, exact against
    ``Decimal``."""
    rows = [(Decimal("104949.50"), Decimal("0.10"), Decimal("0.08")),
            (Decimal("901.00"), Decimal("0.00"), Decimal("0.00")),
            (Decimal("0.01"), Decimal("0.04"), Decimal("0.02"))]
    money = T.DecimalType(12, 2)
    sch = T.StructType([T.StructField(c, money) for c in "edt"])
    s = S.TpuSession({}, device="cpu")
    disc = S.col("e") * (S.lit(1) - S.col("d"))
    df = s.create_dataframe(rows, sch).select(
        disc.alias("dp"),
        ((S.col("e") * (S.lit(1) - S.col("d"))) * (S.lit(1) + S.col("t")))
        .alias("charge"))
    assert df.explain().startswith("Project [")   # a CPU root
    got = df.collect()
    assert got == [(e * (1 - d), e * (1 - d) * (1 + t)) for e, d, t in rows]

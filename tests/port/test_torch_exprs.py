"""Q6's expressions and operators on the port against the JAX package's CPU
oracle session, on data with nulls and at the decimal overflow edge:
comparisons with their coercions, And/Or/Not/IsNull, decimal and integer
Add/Subtract/Multiply with Spark's result typing and overflow -> null,
the stand-alone filter/project stage, multi-batch aggregation and ANSI
errors.  Exact equality throughout."""
import datetime
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as PS
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.base import SparkArithmeticException
from torch_port_jaxref import run_jax


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)

    def nulls(vals):
        return [v if rng.random() > 0.1 else None for v in vals]

    big = 10 ** 16
    return {
        "i": nulls([int(x) for x in rng.integers(-50, 50, n)]),
        "l": nulls([int(x) for x in rng.integers(-2 ** 62, 2 ** 62, n)]),
        "p": nulls([Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-10 ** 11, 10 ** 11, n)]),
        "q": nulls([Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-big, big, n)]),
        "d": nulls([int(x) for x in rng.integers(8000, 10000, n)]),
    }


def _schema(mod):
    return mod.StructType([
        mod.StructField("i", mod.INT), mod.StructField("l", mod.LONG),
        mod.StructField("p", mod.DecimalType(12, 2)),
        mod.StructField("q", mod.DecimalType(18, 2)),
        mod.StructField("d", mod.DATE)])


def _port(build, conf=None, data=None):
    s = PS.TpuSession(dict(conf or {}), device="cpu")
    return build(s.create_dataframe(data or _data(), _schema(T)),
                 PS).collect()


def _oracle(build, conf=None, data=None):
    s = RS.TpuSession(dict(conf or {}, **{"spark.rapids.sql.enabled":
                                          False}))
    return build(s.create_dataframe(data or _data(), _schema(RT)),
                 RS).collect()


def _both(build, conf=None, data=None):
    """Run ``build(df, session_module)`` on the port and on the oracle."""
    return _port(build, conf, data), _oracle(build, conf, data)


def _sums(df, m, *exprs):
    return df.select(*[e.alias(f"c{i}") for i, e in enumerate(exprs)]).agg(
        *[m.sum_(f"c{i}", f"s{i}") for i in range(len(exprs))],
        m.count_(None, "n"))


_CASES = {
    "decimal_mult_128": lambda m: [m.col("p") * m.col("q")],
    "decimal_mult_64": lambda m: [m.col("p") * m.col("p")],
    "decimal_add_sub": lambda m: [m.col("p") + m.col("q"),
                                  m.col("q") - m.col("p")],
    "int_decimal_mix": lambda m: [m.col("i") * m.col("p"),
                                  m.col("p") + m.col("i")],
    "long_wrap": lambda m: [m.col("l") + m.col("l"), m.col("l") * m.col("i"),
                            m.col("i") - m.col("l")],
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_arithmetic_sums_match_oracle(name):
    got, want = _both(lambda df, m: _sums(df, m, *_CASES[name](m)))
    assert got == want


_FILTERS = {
    "or_not": lambda m: (m.col("i") > m.lit(10)) | ~(m.col("p")
                                                     < m.lit(Decimal("3"))),
    "is_null": lambda m: m.col("q").is_null() | (
        m.col("d") <= m.lit(datetime.date(1994, 8, 22))),
    "and_3vl": lambda m: (m.col("i") >= m.lit(0)) & (m.col("q") > m.col("p")),
    "long_vs_int": lambda m: m.col("l") < m.col("i"),
    "dec_vs_int": lambda m: m.col("p") >= m.lit(7),
}


@pytest.mark.parametrize("name", sorted(_FILTERS))
def test_filters_match_oracle(name):
    def build(df, m):
        return df.filter(_FILTERS[name](m)).agg(
            m.sum_("p", "sp"), m.sum_("i", "si"), m.count_("q", "nq"))

    got, want = _both(build)
    assert got == want


def test_filter_project_stage_collects_rows():
    def build(df, m):
        return df.filter(m.col("i") > m.lit(20)).select(
            m.col("p"), (m.col("p") * m.col("i")).alias("pi"), m.col("d"))

    got, want = _both(build)
    assert got == want and len(got) > 10


def test_multi_batch_aggregate_matches_single():
    conf = {"spark.rapids.sql.reader.batchSizeRows": 37}
    for case in ("decimal_mult_128", "decimal_add_sub"):
        got, want = _both(lambda df, m: _sums(df, m, *_CASES[case](m)),
                          conf)
        assert got == want


def test_decimal_sum_overflow_is_null(tmp_path):
    """Spark nulls a decimal sum past its precision.  The JAX device path
    does; the JAX CPU oracle returns the out-of-range value (ROADMAP.md,
    Queue 3, R4), so the port is held against the device path here."""
    big = Decimal("9" * 16 + ".99")
    n = 200
    data = {"i": [1] * n, "l": [1] * n, "p": [Decimal(1)] * n,
            "q": [big] * n, "d": [1] * n}
    # decimal(18,2)^2 -> decimal(37,4), each product ~1e36 unscaled; 200 of
    # them pass the decimal(38,4) sum's 10^38 bound
    got = _port(lambda df, m: _sums(df, m, m.col("q") * m.col("q")),
                data=data)
    ref = run_jax(f"""
        from decimal import Decimal
        import spark_rapids_tpu.session as S
        from spark_rapids_tpu import types as T
        sch = T.StructType([T.StructField("q", T.DecimalType(18, 2))])
        df = S.TpuSession({{}}).create_dataframe(
            {{"q": [Decimal("{big}")] * {n}}}, sch)
        (s, c), = (df.select((S.col("q") * S.col("q")).alias("c0"))
                   .agg(S.sum_("c0", "s0"), S.count_(None, "n")).collect())
        out["sum"] = np.array(str(s))
        out["n"] = np.array(c)
    """, tmp_path)
    assert str(ref["sum"]) == "None" and int(ref["n"]) == n
    assert got == [(None, n)]


def test_ansi_overflow_raises():
    conf = {"spark.sql.ansi.enabled": True}
    data = dict(_data(20), l=[2 ** 62] * 20)

    def build(df, m):
        return df.select((m.col("l") + m.col("l")).alias("x"))

    with pytest.raises(SparkArithmeticException):
        _port(build, conf, data)
    with pytest.raises(Exception, match="overflow"):
        _oracle(build, conf, data)

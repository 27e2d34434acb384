"""``Coalesce`` and ``Nvl`` (``expr/conditional.py``) on the port against
the JAX package's CPU oracle session: over int, long, double and decimal
columns with nulls, with Spark's common-type casts (int and long widen to
long; decimals of different scales meet at the wider one), with a literal
fallback as bench qb uses it, and with every input null.  Exact equality
(doubles to 12 digits, as ``tests/asserts.py`` compares them)."""
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as PS
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, rows_key


def _data(n=300, seed=3):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.3):
        return [v if rng.random() > p else None for v in vals]

    return {
        "i": nulls([int(x) for x in rng.integers(-50, 50, n)]),
        "l": nulls([int(x) for x in rng.integers(-2 ** 40, 2 ** 40, n)]),
        "f": nulls([float(x) for x in rng.normal(0, 1e3, n)]),
        "g": nulls([float(x) for x in rng.normal(0, 1, n)]),
        "a": nulls([Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-10 ** 6, 10 ** 6, n)]),
        "b": nulls([Decimal(int(x)).scaleb(-3)
                    for x in rng.integers(-10 ** 6, 10 ** 6, n)]),
        "z": [None] * n,
    }


def _schema(mod):
    return mod.StructType([
        mod.StructField("i", mod.INT), mod.StructField("l", mod.LONG),
        mod.StructField("f", mod.DOUBLE), mod.StructField("g", mod.DOUBLE),
        mod.StructField("a", mod.DecimalType(7, 2)),
        mod.StructField("b", mod.DecimalType(9, 3)),
        mod.StructField("z", mod.INT)])


def _cases(mod, co, base, types):
    col = mod.col
    dec72 = types.DecimalType(7, 2)
    return {
        "int_long": co.Coalesce([col("i"), col("l")]),
        "long_int_lit": co.Coalesce([col("l"), col("i"),
                                     base.Literal(7, types.INT)]),
        "doubles": co.Coalesce([col("f"), col("g")]),
        "decimal_scales": co.Coalesce([col("a"), col("b")]),
        "decimal_literal": co.Coalesce([col("a"), base.Literal(
            Decimal("0.00"), dec72)]),
        "all_null": co.Coalesce([col("z"), col("z")]),
        "nvl": co.Nvl(col("i"), col("z")),
        "net": col("a") - co.Coalesce([col("b"), base.Literal(
            Decimal("0.000"), types.DecimalType(9, 3))]),
    }


def _run(pkg_session, types, conf, case):
    pkg = pkg_session.__name__.rsplit(".", 1)[0]
    co = __import__(pkg + ".expr.conditional", fromlist=["Coalesce"])
    base = __import__(pkg + ".expr.base", fromlist=["Literal"])
    kw = {} if pkg_session is RS else {"device": "cpu"}
    s = pkg_session.TpuSession(conf, **kw)
    df = s.create_dataframe(_data(), _schema(types))
    e = _cases(pkg_session, co, base, types)[case]
    out = df.select(pkg_session.col("i"), e.alias("c"))
    return out.collect(), out.schema.fields[1].dataType


CASES = ["int_long", "long_int_lit", "doubles", "decimal_scales",
         "decimal_literal", "all_null", "nvl", "net"]


@pytest.mark.parametrize("case", CASES)
def test_coalesce_matches_oracle(case):
    got, gt = _run(PS, T, {}, case)
    want, wt = _run(RS, RT, ORACLE, case)
    assert gt.simpleString == wt.simpleString
    assert rows_key(got, approx_float=True, ordered=True) == \
        rows_key(want, approx_float=True, ordered=True)


def test_coalesce_result_types():
    types = {c: _run(PS, T, {}, c)[1].simpleString for c in CASES}
    assert types["int_long"] == "bigint"
    assert types["decimal_scales"] == "decimal(9,3)"
    assert types["decimal_literal"] == "decimal(7,2)"
    assert types["net"] == "decimal(10,3)"

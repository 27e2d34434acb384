"""The aggregates beyond sum, count, min and max — ``avg``, ``var_pop``,
``var_samp``, ``stddev_pop``, ``stddev_samp``, ``count_if``,
``bool_and``, ``bool_or``, ``bit_and``, ``bit_or``, ``bit_xor``,
``first``, ``last`` and ``any_value`` — against the JAX package's CPU
oracle session: over int, long, double, decimal64 (a decimal(7,2), whose
``avg`` sums in int64; an integer's ``avg`` sums in double) and decimal inputs whose sum buffer is above 18
digits (a decimal(12,2), a decimal(22,2) buffer divided in 128 bits),
negative values included (``avg``'s HALF_UP); grouped with a null key and
with groups whose inputs are all null, global, over several batches, and
on an empty input.  The plan's aggregate line equals the reference
device session's (planned in the child process).  Doubles are compared at
12 significant digits (``torch_port_frames``), never exactly: the port
merges per-batch (n, mean, m2) triples where the reference takes two
passes over one batch, so a variance may differ in its last digits; every
other value is exact.  The count >= 2^31 difference (ROADMAP Queue 3):
the reference's ``_avg_div_dec128`` nulls such a group, the port divides
exactly, as Spark does."""
from decimal import Decimal

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax

N = 2000
WORDS = np.array(["x", "yy", "", "zebra", "a\x00"], object)


def schema(mod):
    return mod.StructType([
        mod.StructField("g", mod.INT), mod.StructField("i", mod.INT),
        mod.StructField("l", mod.LONG), mod.StructField("d", mod.DOUBLE),
        mod.StructField("m", mod.DecimalType(7, 2)),
        mod.StructField("big", mod.DecimalType(12, 2)),
        mod.StructField("b", mod.BOOLEAN), mod.StructField("s", mod.STRING)])


def data():
    rng = np.random.default_rng(29)
    g = rng.integers(0, 9, N).astype(np.int32)
    arr = {"g": g, "i": rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32),
           "l": rng.integers(-2 ** 40, 2 ** 40, N),
           "d": rng.normal(0, 1e3, N),
           "m": rng.integers(-10 ** 7 + 1, 10 ** 7, N),
           "big": rng.integers(-10 ** 12 + 1, 10 ** 12, N),
           "b": rng.random(N) > 0.3,
           "s": WORDS[rng.integers(0, len(WORDS), N)]}
    valid = {k: rng.random(N) > 0.1 for k in arr}
    for k in arr:
        if k != "g":
            valid[k] &= g != 8            # group 8: every input null
    return arr, valid


INPUTS = {
    "avg": "ilmdB", "var_pop": "ildmB", "var_samp": "ildmB",
    "stddev_pop": "ildmB", "stddev_samp": "ildmB", "count_if": "b",
    "bool_and": "b", "bool_or": "b", "bit_and": "il", "bit_or": "il",
    "bit_xor": "il", "first": "ildmBs", "last": "ildmBs",
    "any_value": "ildBs"}
COLS = {"B": "big"}


def aggs(mod, funcs):
    helper = {"avg": "avg_", "var_pop": "var_pop_",
              "var_samp": "variance_", "stddev_pop": "stddev_pop_",
              "stddev_samp": "stddev_", "count_if": "count_if_",
              "bool_and": "bool_and_", "bool_or": "bool_or_",
              "bit_and": "bit_and_", "bit_or": "bit_or_",
              "bit_xor": "bit_xor_", "any_value": "any_value_"}
    out = []
    for f in funcs:
        for c in INPUTS[f]:
            c = COLS.get(c, c)
            name = f"{f}_{c}"
            out.append(getattr(mod, helper[f])(c, name) if f in helper
                       else (f, c, name))
    return out


def query(mod, types, session, funcs, grouped=True, empty=False):
    arr, valid = data()
    df = frame(mod, session, arr, schema(types), valid)
    if empty:
        df = df.filter(mod.col("g") > mod.lit(100))
    gb = df.group_by("g") if grouped else df.group_by()
    return gb.agg(*aggs(mod, funcs))


FAMILIES = {"avg": ["avg"],
            "variance": ["var_pop", "var_samp", "stddev_pop",
                         "stddev_samp"],
            "bool_count": ["count_if", "bool_and", "bool_or"],
            "bits": ["bit_and", "bit_or", "bit_xor"],
            "pick": ["first", "last", "any_value"]}
BATCHES = {"one_batch": {}, "batches": {
    "spark.rapids.sql.reader.batchSizeRows": 300}}


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("batches", sorted(BATCHES))
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_aggregates_match_oracle(family, batches, grouped):
    funcs = FAMILIES[family]
    got = query(S, T, S.TpuSession(BATCHES[batches], device="cpu"), funcs,
                grouped).collect()
    want = query(RS, RT, RS.TpuSession(ORACLE), funcs, grouped).collect()
    assert rows_key(got, True) == rows_key(want, True)
    assert len(got) == (9 + 1 if grouped else 1)   # the null key's group


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_aggregates_over_an_empty_input(family, grouped):
    """A grouped empty input has no rows; a global one has one row: counts
    a valid 0, every other aggregate null.  (The reference's oracle fails
    on ``first``/``last`` over an empty global input, so that row is
    written out here.)"""
    funcs = FAMILIES[family]
    got = query(S, T, S.TpuSession({}, device="cpu"), funcs, grouped,
                empty=True).collect()
    if grouped:
        assert got == []
        return
    if family == "pick":
        assert got == [(None,) * len(aggs(S, funcs))]
    else:
        assert rows_key(got, True) == rows_key(query(
            RS, RT, RS.TpuSession(ORACLE), funcs, grouped,
            empty=True).collect(), True)


def test_avg_half_up_on_negative_and_decimal128_sums():
    """HALF_UP away from zero on exact halves, both signs, over the int64
    buffer (decimal(3,2) -> decimal(7,6)) and the 128-bit one
    (decimal(12,2) -> decimal(16,6)): 0.01 over 32 rows is 0.0003125;
    avg of an integer is a double."""
    rows = []
    for g, sign in ((1, 1), (2, -1)):
        for r in range(32):
            v = Decimal("0.01") * sign if r == 0 else Decimal("0.00")
            rows.append((g, v, v if r else v - sign * 9999999999, sign * r))

    def q(mod, types, s):
        sch = types.StructType([
            types.StructField("g", types.INT),
            types.StructField("a", types.DecimalType(3, 2)),
            types.StructField("b", types.DecimalType(12, 2)),
            types.StructField("i", types.INT)])
        return s.create_dataframe(rows, sch).group_by("g").agg(
            mod.avg_("a", "aa"), mod.avg_("b", "ab"), mod.avg_("i", "ai"))

    got = sorted(q(S, T, S.TpuSession({}, device="cpu")).collect())
    assert got == sorted(q(RS, RT, RS.TpuSession(ORACLE)).collect())
    assert [r[1] for r in got] == [Decimal("0.000313"), Decimal("-0.000313")]
    # -9999999998.99 / 32 = -312499999.9684375 -> away from zero
    assert got[0][2] == Decimal("-312499999.968438")
    assert got[1][2] == Decimal("312499999.968438")
    assert (got[0][3], got[1][3]) == (15.5, -15.5)


@pytest.mark.parametrize("value,count,want", [
    (2 ** 62, 2, 4.611686018427388e18),         # an int64 sum would wrap
    (2 ** 53 + 1, 3, 9007199254740992.0),       # each addend rounds first
    (2 ** 40 + 3, 5, 1099511627779.0),          # both sums exact
], ids=["2^62", "2^53+1", "2^40"])
def test_avg_of_a_long_sums_in_double(value, count, want):
    """``avg`` of an integer keeps a DOUBLE sum buffer and adds float64
    values, as the reference's buffer and Spark's ``Average``: a long
    sum past 2^63 does not wrap, and each value rounds to a double before
    it is added.  Exact against the reference's CPU oracle, grouped and
    global, and over batches of one row (the merge adds doubles too)."""
    rows = [(1, value)] * count

    def q(mod, types, s, grouped):
        sch = types.StructType([types.StructField("g", types.INT),
                                types.StructField("v", types.LONG)])
        df = s.create_dataframe(rows, sch)
        gb = df.group_by("g") if grouped else df.group_by()
        return gb.agg(mod.avg_("v", "a"))

    for conf in ({}, {"spark.rapids.sql.reader.batchSizeRows": 1}):
        for grouped in (True, False):
            got = q(S, T, S.TpuSession(conf, device="cpu"), grouped).collect()
            ref = q(RS, RT, RS.TpuSession(ORACLE), grouped).collect()
            assert got == ref
            assert got[0][-1] == want


def test_result_types_and_plan_equal_the_reference(tmp_path):
    """Every function's result type is the reference's; the aggregate's
    plan line is the reference device session's; the reference nulls a
    decimal avg whose count reaches 2^31 (``_avg_div_dec128``'s divisor
    contract), the port gives Spark's exact HALF_UP value."""
    import sys

    from torch_port_jaxref import REPO

    sys.path.insert(0, REPO)
    import chip_smoke as C
    from spark_rapids_tpu_torch.expr import decimal128 as D

    funcs = [f for fam in FAMILIES.values() for f in fam]
    q = query(S, T, S.TpuSession({}, device="cpu"), funcs)
    big = 2 ** 31 + 7
    sums = [10 ** 20 + 3, -(10 ** 20 + 3), big // 2, 5]
    out = run_jax(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import jax.numpy as jnp
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.column import DeviceColumn
    from spark_rapids_tpu.exec.aggregate import _avg_div_dec128
    from spark_rapids_tpu.expr import decimal128 as D
    from test_torch_agg_breadth import query, FAMILIES
    funcs = [f for fam in FAMILIES.values() for f in fam]
    q = query(RS, T, RS.TpuSession({{}}), funcs)
    out["plan"] = np.array(C.plan_shape(q))
    out["schema"] = np.array([q.schema.simpleString])
    limbs = [D.limbs_of(v) for v in {sums!r}]
    data = jnp.asarray(np.array(limbs, np.int64))
    col = DeviceColumn(T.DecimalType(22, 2), jnp.ones(4, bool), data=data)
    for name, n in (("small", 8), ("big", {big})):
        r = _avg_div_dec128(col, jnp.full(4, n, jnp.int64), 2,
                            T.DecimalType(38, 6), jnp.ones(4, bool))
        out[name + "_valid"] = np.asarray(r.validity)
        out[name + "_data"] = np.asarray(r.data)
    """, tmp_path)
    assert C.plan_shape(q) == list(out["plan"])
    assert q.schema.simpleString == str(out["schema"][0])
    hi = torch.tensor([D.limbs_of(v)[0] for v in sums])
    lo = torch.tensor([D.limbs_of(v)[1] for v in sums])
    for name, n in (("small", 8), ("big", big)):
        over, qh, ql = D.div128_by_count_half_up(
            hi, lo, torch.full((4,), n), 4)
        assert not over.any()
        got = [D.to_py(int(h), int(l)) for h, l in zip(qh, ql)]
        got = [v - (1 << 128) if v >= 1 << 127 else v for v in got]
        want = [C._avg_half_up(s, n, 4) for s in sums]
        assert got == want
        if name == "small":
            ref = [D.to_py(int(h), int(l)) for h, l in out["small_data"]]
            ref = [v - (1 << 128) if v >= 1 << 127 else v for v in ref]
            assert ref == want and out["small_valid"].all()
        else:
            # the difference: the reference's group is null
            assert not out["big_valid"].any()


def test_unported_aggregate_inputs_raise():
    """``avg`` of a decimal above 18 digits is tagged off the device by
    the reference's rule and runs in the port's CPU engine: the oracle's
    row, HALF_UP at the result scale.  The avg of a string parses it on
    the device: the oracle's row.  A ``collect_list`` of strings, which
    the reference's rule keeps off the device too (primitive elements
    only), still raises ``NotOnGpu``: its array of strings is a list
    column that the port's CPU engine does not hold (ROADMAP Queue 1 item
    5).  (The name is kept from when all three raised.)"""
    from spark_rapids_tpu_torch.exec.base import NotOnGpu

    rows = {"x": [Decimal("1.00"), Decimal("2.05"), None,
                  Decimal("-0.01")], "t": ["a", "1.5", None, "2.5"]}
    got, want = {}, {}
    for mod, types, sess, out in (
            (S, T, S.TpuSession({}, device="cpu"), got),
            (RS, RT, RS.TpuSession(ORACLE), want)):
        sch = types.StructType([
            types.StructField("x", types.DecimalType(20, 2)),
            types.StructField("t", types.STRING)])
        df = sess.create_dataframe(rows, sch)
        out["x"] = df.agg(mod.avg_("x", "a")).collect()
        out["t"] = df.filter(mod.col("t").is_null()
                             | mod.col("t").eq(mod.lit("1.5"))
                             | mod.col("t").eq(mod.lit("2.5"))).agg(
            mod.avg_("t", "a")).collect()
        if mod is S:
            lines = df.agg(mod.avg_("x", "a")).explain().splitlines()
            assert lines[0].startswith("HashAggregate(Final)")
            with pytest.raises(NotOnGpu, match="collect_list of string "
                               "elements.*HashAggregate in a CPU stage.*"
                               "Queue 1 item 5"):
                df.agg(S.collect_list_("t", "k")).explain()
    assert got == want
    assert got["x"] == [(Decimal("1.013333"),)]
    assert got["t"] == [(2.0,)]

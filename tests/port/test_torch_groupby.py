"""Grouped aggregation, sort and limit (``exec/aggregate.py``,
``exec/sort.py``, ``exec/limit.py``) against the JAX package's CPU oracle
session: ``sum``, ``count``, ``min`` and ``max`` over INT, LONG, DATE,
DOUBLE, decimal64 and decimal128, grouped by keys with nulls and by a
DOUBLE key with -0.0 and NaN, in one batch and in several (the two-phase
path); empty inputs; multi-key ORDER BY with DESC, NULLS LAST and ties;
limits past the row count and of 0.  A grouped decimal sum past its
precision is null, held against the reference's device session (child
process), whose CPU oracle does not null it (ROADMAP fault R4).  Every
comparison is exact except float sums, compared as ``tests/asserts.py``'s
``approximate_float`` compares them."""
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.transitions import TpuColumnarToRowExec
from spark_rapids_tpu_torch.expr.decimal128 import to_py
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax

N = 3000
NAMES = ["id", "k1", "kf", "i", "l", "d", "m", "big", "h", "f"]


def schema(mod):
    types = [mod.LONG, mod.INT, mod.DOUBLE, mod.INT, mod.LONG, mod.DATE,
             mod.DecimalType(7, 2), mod.DecimalType(12, 2),
             mod.DecimalType(30, 2), mod.DOUBLE]
    return mod.StructType([mod.StructField(n, t)
                           for n, t in zip(NAMES, types)])


def table(seed=11, n=N):
    rng = np.random.default_rng(seed)
    h = [int(v) * 10 ** 10 + int(w) for v, w in
         zip(rng.integers(-10 ** 17, 10 ** 17, n), rng.integers(0, 10, n))]
    arrays = {
        "id": np.arange(n),
        "k1": rng.integers(0, 6, n).astype(np.int32),
        "kf": rng.choice([0.0, -0.0, np.nan, 1.5, -2.0], n),
        "i": rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
        "l": rng.integers(-2 ** 40, 2 ** 40, n),
        "d": rng.integers(-1000, 20000, n).astype(np.int32),
        "m": rng.integers(-9_999_999, 10_000_000, n),
        "big": rng.integers(-10 ** 12 + 1, 10 ** 12, n),
        "h": np.array([[v >> 64, ((v & (2 ** 64 - 1)) ^ 2 ** 63) - 2 ** 63]
                       for v in h], np.int64),
        "f": rng.normal(size=n) * 1e3,
    }
    validity = {k: rng.random(n) > 0.1 for k in NAMES if k != "id"}
    return arrays, validity


def grouped(mod, types, session, keys, aggs_of):
    arrays, validity = table()
    df = frame(mod, session, arrays, schema(types), validity)
    g = df.group_by(*keys) if keys else df
    return g.agg(*aggs_of(mod))


def exact_aggs(mod):
    out = [mod.sum_("i", "s_i"), mod.sum_("l", "s_l"), mod.sum_("m", "s_m"),
           mod.sum_("big", "s_big"), mod.sum_("h", "s_h"),
           mod.count_("l", "c_l"), mod.count_(None, "c_star")]
    for c in ("i", "d", "m", "h", "f"):
        out += [mod.min_(c, "min_" + c), mod.max_(c, "max_" + c)]
    return out


def float_sums(mod):
    return [mod.sum_("f", "s_f"), mod.count_("f", "c_f")]


CONFS = {"one_batch": {},
         "five_batches": {"spark.rapids.sql.reader.batchSizeRows": 700}}


@pytest.mark.parametrize("keys", [("k1",), ("k1", "kf"), ()])
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_grouped_aggregates_match_oracle(keys, conf):
    port = S.TpuSession(CONFS[conf], device="cpu")
    ref = RS.TpuSession(ORACLE)
    df = grouped(S, T, port, keys, exact_aggs)
    got = df.collect()
    want = grouped(RS, RT, ref, keys, exact_aggs).collect()
    assert rows_key(got) == rows_key(want)
    assert rows_key(df.collect()) == rows_key(got)     # a second run agrees
    assert len(got) == (1 if not keys else len(want))
    assert df.schema.fields[len(keys) + 4].dataType == T.DecimalType(38, 2)
    line = df.explain().splitlines()[0]
    assert line.startswith("TpuHashAggregate(Complete) keys=["
                           + ", ".join(keys) + "]")
    fgot = grouped(S, T, port, keys, float_sums).collect()
    fwant = grouped(RS, RT, ref, keys, float_sums).collect()
    assert rows_key(fgot, approx_float=True) == rows_key(fwant,
                                                         approx_float=True)


def test_float_keys_group_zero_and_nan_alike():
    got = grouped(S, T, S.TpuSession({}, device="cpu"), ("kf",),
                  lambda mod: [mod.count_(None, "n")]).collect()
    # -0.0 groups with 0.0 and every NaN with every other
    keys = sorted((str(k) if k == k and k != 0 else "0 or NaN" if k == 0
                   else "NaN") for k, _ in got if k is not None)
    assert keys == ["-2.0", "0 or NaN", "1.5", "NaN"]


def test_empty_inputs():
    s = S.TpuSession({}, device="cpu")
    arrays, validity = table()
    df = frame(S, s, arrays, schema(T), validity)
    none = df.filter(S.col("id") < S.lit(0))
    assert none.group_by("k1").agg(S.sum_("l", "s")).collect() == []
    assert none.agg(S.sum_("l", "s"), S.count_(None, "n"),
                    S.min_("d", "m")).collect() == [(None, 0, None)]
    empty = frame(S, s, {k: v[:0] for k, v in arrays.items()}, schema(T))
    assert empty.group_by("k1", "kf").agg(S.max_("h", "x")).collect() == []


def sorted_query(mod, types, session):
    arrays, validity = table()
    df = frame(mod, session, arrays, schema(types), validity)
    SortSpec = mod.SortSpec
    return df.order_by((mod.col("k1"), SortSpec(False, False)),
                       (mod.col("kf"), SortSpec(True, False)),
                       (mod.col("m"), SortSpec(False, True)),
                       mod.col("id"))


@pytest.mark.parametrize("limit", [None, 37, 10 ** 6, 0])
@pytest.mark.parametrize("conf", sorted(CONFS))
def test_order_by_and_limit_match_oracle(limit, conf):
    q = sorted_query(S, T, S.TpuSession(CONFS[conf], device="cpu"))
    r = sorted_query(RS, RT, RS.TpuSession(ORACLE))
    if limit is not None:
        q, r = q.limit(limit), r.limit(limit)
    got = q.collect()
    assert rows_key(got, ordered=True) == rows_key(r.collect(), ordered=True)
    assert len(got) == (N if limit is None else min(limit, N))
    top = q.explain().splitlines()[0]
    assert top == (f"TpuTopN {limit}" if limit is not None else
                   "TpuSort [k1 DESC, kf ASC, m DESC, id ASC]")


def test_limit_without_sort():
    s = S.TpuSession(CONFS["five_batches"], device="cpu")
    arrays, validity = table()
    df = frame(S, s, arrays, schema(T), validity)
    for n in (5, 1500, 10 ** 6, 0):
        got = df.select("id").limit(n).collect()
        assert got == [(i,) for i in range(min(n, N))]
    assert df.limit(3).explain().splitlines()[0] == "TpuGlobalLimit 3"


def test_grouped_decimal_sum_overflow_is_null(tmp_path):
    """Groups of decimal(38,0) values: one group's sum passes 10^38 and is
    null; the others are exact.  Held against Python integers and the
    reference's device session."""
    big = 6 * 10 ** 37
    vals = [big, big, 5, -big, 7, big, -big, 1]
    keys = [1, 1, 1, 2, 2, 3, 3, 3]
    limbs = np.array([[v >> 64, ((v & (2 ** 64 - 1)) ^ 2 ** 63) - 2 ** 63]
                      for v in vals], np.int64)
    arrays = {"k": np.array(keys, np.int32), "v": limbs}

    def q(mod, types, session):
        sch = types.StructType([types.StructField("k", types.INT),
                                types.StructField("v",
                                                  types.DecimalType(38, 0))])
        return (frame(mod, session, arrays, sch).group_by("k")
                .agg(mod.sum_("v", "s")))

    df = q(S, T, S.TpuSession({}, device="cpu"))
    got = sorted(df.collect())
    # rows carry Decimals rounded to 28 digits, as the reference's do;
    # the limbs are exact
    keys_col, sums = TpuColumnarToRowExec(df._planned()).collect_host()
    exact = sorted((int(k), to_py(*s) if ok else None) for k, s, ok in
                   zip(keys_col.data, sums.data, sums.validity))
    assert exact == [(1, None), (2, 7 - big), (3, 1)]
    assert got == [(1, None), (2, Decimal(7 - big) + 0), (3, Decimal(1))]
    out = run_jax("""
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.columnar.column import HostColumn
        from spark_rapids_tpu.plan.nodes import LocalTableScan
        sch = T.StructType([T.StructField("k", T.INT),
                            T.StructField("v", T.DecimalType(38, 0))])
        host = [HostColumn.from_numpy(inp["k"], T.INT),
                HostColumn.from_numpy(inp["v"], T.DecimalType(38, 0))]
        df = RS.DataFrame(LocalTableScan(host, sch), RS.TpuSession({}))
        rows = sorted(df.group_by("k").agg(RS.sum_("v", "s")).collect())
        out["rows"] = np.array([f"{k}:{s}" for k, s in rows])
    """, tmp_path, arrays)
    assert list(out["rows"]) == [f"{k}:{s}" for k, s in got]

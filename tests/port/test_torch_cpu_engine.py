"""The CPU engine's aggregate, hash joins, sort, limit and window
(``cpu/oracle.py``) against the JAX package's CPU oracle.

Each query runs as a CPU stage of the port (its exec disabled by conf, or
kept off the device by the reference's own rule) on a small seeded table
with nulls, NaN, -0.0, strings and decimals above 18 digits.  Its plan is
held against the reference's explain (one child call plans every query of
the module), its rows against the reference's CPU oracle session:
integers, decimals and strings exactly, doubles to 12 significant digits
(``torch_port_frames.rows_key``).  A join that is not inner with a
residual condition is held to the reference's nested-loop route on the
conjoined condition and to a plain Python reference, because the
reference's hash-join oracle drops the condition there (ROADMAP R26);
its right and full outer nested-loop rows lack the unmatched right rows
(R5), so those two are held to the Python reference alone."""
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from torch_port_frames import ORACLE, rows_key
from torch_port_jaxref import REPO, run_jax

N = 160
STRINGS = ["", "a", "b", "ab", "ba", "abc", "zz", "été", "b a"]
OFF_AGG = {"spark.rapids.sql.exec.HashAggregate": "false"}
OFF_JOIN = {"spark.rapids.sql.exec.SortMergeJoin": "false",
            "spark.rapids.sql.exec.BroadcastHashJoin": "false"}
OFF_SORT = {"spark.rapids.sql.exec.Sort": "false",
            "spark.rapids.sql.exec.GlobalLimit": "false",
            "spark.rapids.sql.exec.LocalLimit": "false"}


def _pkg(mod, name):
    return __import__(mod.__name__.rsplit(".", 1)[0] + "." + name,
                      fromlist=["x"])


def _types(mod):
    return T if mod is S else RT


def schema(types):
    f = types.StructField
    return types.StructType([
        f("g", types.INT), f("s", types.STRING), f("i", types.INT),
        f("l", types.LONG), f("d", types.DOUBLE), f("x", types.DOUBLE),
        f("m", types.DecimalType(12, 2)), f("w", types.DecimalType(22, 2)),
        f("b", types.BOOLEAN), f("t", types.STRING)])


def data(n: int = N, seed: int = 16):
    """Columns with nulls; doubles with NaN, -0.0 and infinities; decimals
    above 18 digits past 2^64; strings that share prefixes."""
    rng = np.random.default_rng(seed)
    d = rng.normal(0, 100, n)
    d[rng.random(n) < 0.05] = np.nan
    d[rng.random(n) < 0.05] = -0.0
    d[:2] = [np.inf, -np.inf]
    w = [int(a) * 10 ** 6 + int(b) for a, b in zip(
        rng.integers(-10 ** 14, 10 ** 14, n), rng.integers(0, 10 ** 6, n))]
    cols = {
        "g": [int(v) for v in rng.integers(0, 5, n)],
        "s": [STRINGS[v] for v in rng.integers(0, len(STRINGS), n)],
        "i": [int(v) for v in rng.integers(-2 ** 31, 2 ** 31, n)],
        "l": [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, n)],
        "d": [float(v) for v in d],
        "x": [float(v) for v in rng.normal(5, 3, n)],
        "m": [Decimal(int(v)).scaleb(-2)
              for v in rng.integers(-10 ** 9, 10 ** 9, n)],
        "w": [Decimal(v).scaleb(-2) for v in w],
        "b": [bool(v) for v in rng.random(n) < 0.6],
        "t": [f"{v:.2f}" for v in rng.normal(0, 50, n)]}
    for k in cols:
        null = rng.random(n) < 0.12
        cols[k] = [None if z else v for v, z in zip(cols[k], null)]
    return cols


def table(mod, session, n: int = N, seed: int = 16):
    return session.create_dataframe(data(n, seed), schema(_types(mod)))


# -- the aggregate ------------------------------------------------------------

def _ae(mod, func, c, name, c2=None, args=()):
    PN = _pkg(mod, "plan.nodes")
    return PN.AggregateExpression(
        func, mod.col(c) if c else None, name,
        child2=mod.col(c2) if c2 else None, args=args)


#: every function of the reference's ``_AGG_FUNCS_SUPPORTED`` that a
#: two-phase CPU aggregate runs, on inputs of each kind
TWO_PHASE = [
    ("sum", "i"), ("sum", "l"), ("sum", "d"), ("sum", "m"), ("sum", "w"),
    ("count", "s"), ("count_star", None), ("min", "s"), ("max", "s"),
    ("min", "d"), ("max", "d"), ("min", "w"), ("max", "m"), ("avg", "i"),
    ("avg", "d"), ("avg", "m"), ("avg", "w"), ("avg", "t"), ("first", "i"),
    ("last", "s"), ("any_value", "l"), ("count_if", "b"),
    ("bool_and", "b"), ("bool_or", "b"), ("var_pop", "d"),
    ("var_samp", "m"), ("stddev_pop", "w"), ("stddev_samp", "t"),
    ("skewness", "x"), ("kurtosis", "m"), ("bit_and", "i"),
    ("bit_or", "l"), ("bit_xor", "i")]
TWO_INPUTS = ["covar_pop", "covar_samp", "corr", "regr_count", "regr_avgx",
              "regr_avgy", "regr_sxx", "regr_syy", "regr_sxy",
              "regr_slope", "regr_intercept", "regr_r2"]


def two_phase(mod, session, keys=("g",), funcs=None):
    aggs = [_ae(mod, f, c, f"a{k}") for k, (f, c) in
            enumerate(funcs or TWO_PHASE)]
    if funcs is None:
        aggs += [_ae(mod, f, "d" if k % 2 else "x", f"c{k}",
                     "x" if k % 2 else "m") for k, f in enumerate(TWO_INPUTS)]
    df = table(mod, session)
    return (df.group_by(*keys) if keys else df.group_by()).agg(*aggs)


def single_phase(mod, session, col="d"):
    """percentile, median and approx_percentile (single-phase: one
    COMPLETE aggregate over an exchange), with an HLL beside them."""
    aggs = [_ae(mod, "percentile", col, "p", args=(0.3,)),
            _ae(mod, "median", col, "md"),
            _ae(mod, "approx_percentile", col, "ap", args=(0.75, 10000))]
    if col != "w":
        aggs.append(_ae(mod, "approx_count_distinct", "l", "h"))
    return table(mod, session).group_by("g").agg(*aggs)


def wide_decimals(mod, session):
    """avg and the variance family over decimal(22,2), which the
    reference's rule keeps off the device."""
    return table(mod, session).group_by("s").agg(
        mod.avg_("w", "aw"), mod.var_pop_("w", "vw"),
        mod.stddev_("w", "sw"), mod.sum_("w", "tw"), mod.count_("w", "cw"))


def empty_global(mod, session):
    df = table(mod, session).filter(mod.col("i") > mod.lit(2 ** 31))
    return df.agg(mod.count_("i", "c"), mod.sum_("w", "s"),
                  mod.avg_("m", "a"), mod.max_("s", "mx"),
                  mod.var_pop_("d", "v"))


#: query id -> (builder, conf); each runs as CPU stages of the port
AGG_QUERIES = {
    "two_phase_grouped": (two_phase, OFF_AGG),
    "two_phase_global": (lambda m, s: two_phase(m, s, ()), OFF_AGG),
    "two_phase_string_key": (
        lambda m, s: two_phase(m, s, ("s", "b"), TWO_PHASE[:12]), OFF_AGG),
    "single_phase_doubles": (single_phase, OFF_AGG),
    "single_phase_decimal128": (lambda m, s: single_phase(m, s, "w"), {}),
    "wide_decimals": (wide_decimals, {}),
    "empty_global": (empty_global, OFF_AGG),
}


# -- joins --------------------------------------------------------------------

def sides(mod, session):
    """Two tables whose keys meet on ints (nulls), strings, decimals above
    18 digits and doubles (NaN, -0.0)."""
    left = table(mod, session, 70, 3).select(
        mod.col("g").alias("k"), mod.col("s").alias("ks"),
        mod.col("w").alias("kw"), mod.col("d").alias("kd"), "i", "m")
    right = table(mod, session, 60, 4).select(
        mod.col("g").alias("k2"), mod.col("s").alias("ks2"),
        mod.col("w").alias("kw2"), mod.col("d").alias("kd2"),
        mod.col("i").alias("j"), mod.col("m").alias("n"))
    return left, right


def _wide_keys(df, mod, right: bool):
    """Decimal keys of few distinct values (so that they meet), NaN and
    -0.0 keys from rounding the doubles."""
    sfx = "2" if right else ""
    types = _types(mod)
    return df.select(
        *[mod.col(c + sfx) for c in ("k", "ks")],
        (mod.col("k" + sfx).cast(types.DecimalType(22, 2))
         + _pkg(mod, "expr.base").Literal(
             Decimal("12345678901234567890.12"),
             types.DecimalType(22, 2))).alias("kw" + sfx),
        mod.col("kd" + sfx), *[mod.col(c) for c in (
            ("j", "n") if right else ("i", "m"))])


HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti"]
KEYS = {"int": ("k", "k2"), "string": ("ks", "ks2"),
        "decimal128": ("kw", "kw2"), "two": (("k", "ks"), ("k2", "ks2"))}


def hash_join(mod, session, how, key, cond=None, node="SortMergeJoin"):
    """A hash join built as the reference's tests build it, with
    ``cond`` (an expression of the joined columns) as its residual
    condition."""
    PN = _pkg(mod, "plan.nodes")
    types = _types(mod)
    l, r = sides(mod, session)
    l, r = _wide_keys(l, mod, False), _wide_keys(r, mod, True)
    lk, rk = KEYS[key]
    lk = [lk] if isinstance(lk, str) else list(lk)
    rk = [rk] if isinstance(rk, str) else list(rk)
    jt = {"inner": "INNER", "left": "LEFT_OUTER", "right": "RIGHT_OUTER",
          "full": "FULL_OUTER", "left_semi": "LEFT_SEMI",
          "left_anti": "LEFT_ANTI"}[how]
    right = (PN.BroadcastExchange(r.plan) if node == "BroadcastHashJoin"
             else r.plan)
    j = getattr(PN, node)(
        l.plan, right, [mod.col(c).resolve(l.schema) for c in lk],
        [mod.col(c).resolve(r.schema) for c in rk],
        getattr(PN.JoinType, jt))
    if cond is not None:
        both = types.StructType(list(l.schema.fields)
                                + list(r.schema.fields))
        j.condition = cond(mod).resolve(both)
    return mod.DataFrame(j, session)


def residual(mod):
    return mod.col("i") > mod.col("j")


def residual_bnlj(mod, session, how):
    """The same join as a nested-loop join on the conjoined condition."""
    l, r = sides(mod, session)
    l, r = _wide_keys(l, mod, False), _wide_keys(r, mod, True)
    return l.join(r, mod.col("k").eq(mod.col("k2")) & residual(mod), how)


JOIN_QUERIES = {
    **{f"{how}_{key}": (lambda m, s, how=how, key=key: hash_join(
        m, s, how, key), OFF_JOIN) for how in HOWS for key in KEYS},
    "inner_residual": (lambda m, s: hash_join(m, s, "inner", "int",
                                              residual), OFF_JOIN),
    **{f"{how}_residual": (lambda m, s, how=how: hash_join(
        m, s, how, "int", residual, "BroadcastHashJoin"), {})
       for how in HOWS if how != "inner"},
    "shuffled_hash_join": (lambda m, s: hash_join(
        m, s, "left", "string", None, "ShuffledHashJoin"),
        {"spark.rapids.sql.exec.ShuffledHashJoin": "false"}),
}


# -- sort, limit --------------------------------------------------------------

def sorted_rows(mod, session):
    SortSpec = _pkg(mod, "ops.sortkeys").SortSpec
    df = table(mod, session).select("g", "s", "d", "w", "i")
    return df.order_by(
        (mod.col("g"), SortSpec(True, False)),
        (mod.col("s"), SortSpec(False, True)),
        (mod.col("d"), SortSpec(False, False)),
        (mod.col("w"), SortSpec(True, True)))


SORT_QUERIES = {
    "sort": (sorted_rows, OFF_SORT),
    "sort_limit": (lambda m, s: sorted_rows(m, s).limit(17), OFF_SORT),
    "limit": (lambda m, s: table(m, s).select("g", "s").limit(9), OFF_SORT),
}


# -- windows ------------------------------------------------------------------

def window(mod, session, funcs, frame, order=("i",), part=("g",)):
    WF = _pkg(mod, "plan.nodes").WindowFunction
    df = table(mod, session).select("g", "s", "i", "d", "m", "w", "l")
    return df.window([WF(f, mod.col(c), f"x{k}")
                      for k, (f, c) in enumerate(funcs)],
                     partition_by=list(part),
                     order_by=[mod.col(c) for c in order], frame=frame)


WINDOW_QUERIES = {
    "rows_300": (lambda m, s: window(
        m, s, [("sum", "l"), ("count", "s"), ("min", "d"), ("max", "w"),
               ("sum", "w"), ("first_value", "s")], ("rows", 150, 149)),
        {}),
    "range_two_keys": (lambda m, s: window(
        m, s, [("sum", "l"), ("max", "d")], ("range", 40_000_000, 0),
        ("i", "s")), {}),
    "string_min_bounded": (lambda m, s: window(
        m, s, [("min", "s"), ("max", "s")], ("rows", 2, 3), ("d",)), {}),
    "decimal128_frames": (lambda m, s: window(
        m, s, [("min", "w"), ("max", "w"), ("sum", "w"), ("count", "w")],
        ("range", 10 ** 9, 10 ** 9), ("i",)), {}),
}

QUERIES = {**AGG_QUERIES, **JOIN_QUERIES, **SORT_QUERIES, **WINDOW_QUERIES}
#: the decimal avg and variance windows whose oracle reads the unscaled
#: value (R27): planned here, held to Python below
R27_QUERIES = {
    "decimal_avg_window": (lambda m, s: window(
        m, s, [("avg", "m"), ("var_pop", "m"), ("stddev_samp", "w"),
               ("avg", "w")], "running"), {}),
}


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain of every query of this module, planned in
    one child call."""
    names = sorted({**QUERIES, **R27_QUERIES})
    out = run_jax(f"""
    import sys
    sys.path.insert(0, {REPO + '/tests/port'!r})
    import spark_rapids_tpu.session as RS
    import test_torch_cpu_engine as M
    qs = dict(M.QUERIES, **M.R27_QUERIES)
    for i, name in enumerate({names!r}):
        build, conf = qs[name]
        out[f"p{{i}}"] = np.array(build(RS, RS.TpuSession(conf))
                                  .explain().splitlines())
    """, tmp_path_factory.mktemp("cpu_engine"))
    return {name: list(out[f"p{i}"]) for i, name in enumerate(names)}


def _ordered(name: str) -> bool:
    return name.startswith("sort")


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_cpu_stage_equals_the_oracle(name, reference_plans):
    """Each query's plan is the reference's, with its CPU stages; its
    rows are the reference oracle's (in order after a sort)."""
    build, conf = QUERIES[name]
    q = build(S, S.TpuSession(conf, device="cpu"))
    assert q.explain().splitlines() == reference_plans[name]
    got = q.collect()
    if name.endswith("_residual") and not name.startswith("inner"):
        want = python_join(name[:-len("_residual")])
    else:
        want = build(RS, RS.TpuSession(dict(conf, **ORACLE))).collect()
    assert rows_key(got, approx_float=True, ordered=_ordered(name)) == \
        rows_key(want, approx_float=True, ordered=_ordered(name))
    if not name.startswith("empty"):
        assert got, "a query of no rows shows nothing"


# -- the residual condition (R26) ------------------------------------------

def python_join(how):
    """Spark's rows of the join on k = k2 with residual i > j, by
    brute force over the rows."""
    l, r = sides(RS, RS.TpuSession(ORACLE))
    lrows = _wide_keys(l, RS, False).collect()
    rrows = _wide_keys(r, RS, True).collect()

    def ok(a, b):
        return (a[0] is not None and a[0] == b[0] and a[4] is not None
                and b[4] is not None and a[4] > b[4])
    out = []
    rmatched = set()
    for a in lrows:
        hits = [b for b in rrows if ok(a, b)]
        rmatched.update(id(b) for b in hits)
        if how == "left_semi":
            out += [a] if hits else []
        elif how == "left_anti":
            out += [] if hits else [a]
        else:
            out += [a + b for b in hits]
            if not hits and how in ("left", "full"):
                out.append(a + (None,) * len(rrows[0]))
    if how in ("right", "full"):
        out += [(None,) * len(lrows[0]) + b for b in rrows
                if id(b) not in rmatched]
    return out


@pytest.mark.parametrize("how", ["left_semi", "left_anti", "left", "inner"])
def test_residual_joins_equal_the_nested_loop_route(how):
    """A hash join with a residual condition gives the rows of the
    reference's nested-loop join on the conjoined condition (the route
    where the reference applies it) and of the Python reference."""
    got = hash_join(S, S.TpuSession({}, device="cpu"), how, "int",
                    residual).collect()
    want = residual_bnlj(RS, RS.TpuSession(ORACLE), how).collect()
    assert rows_key(got) == rows_key(want) == rows_key(python_join(how))


R26_LEFT = {"ok": [1, 1, 2, 3], "sk": [10, 11, 20, 30]}
R26_RIGHT = {"ok2": [1, 1, 2, 3, 3], "sk2": [10, 11, 20, 30, 31]}
#: Spark's rows of the example (ROADMAP R26)
R26_WANT = {
    "left_semi": [(1, 10), (1, 11), (3, 30)],
    "left_anti": [(2, 20)],
    "left": [(1, 10, 1, 11), (1, 11, 1, 10), (2, 20, None, None),
             (3, 30, 3, 31)],
    "right": [(1, 10, 1, 11), (1, 11, 1, 10), (3, 30, 3, 31),
              (None, None, 2, 20), (None, None, 3, 30)],
    "full": [(1, 10, 1, 11), (1, 11, 1, 10), (2, 20, None, None),
             (3, 30, 3, 31), (None, None, 2, 20), (None, None, 3, 30)],
}


def r26_join(mod, session, how):
    PN = _pkg(mod, "plan.nodes")
    types = _types(mod)

    def frame(cols):
        return session.create_dataframe(cols, types.StructType(
            [types.StructField(c, types.INT) for c in cols]))
    l, r = frame(R26_LEFT), frame(R26_RIGHT)
    jt = {"left_semi": "LEFT_SEMI", "left_anti": "LEFT_ANTI",
          "left": "LEFT_OUTER", "right": "RIGHT_OUTER",
          "full": "FULL_OUTER"}[how]
    j = PN.SortMergeJoin(l.plan, r.plan, [mod.col("ok").resolve(l.schema)],
                         [mod.col("ok2").resolve(r.schema)],
                         getattr(PN.JoinType, jt))
    j.condition = (~mod.col("sk").eq(mod.col("sk2"))).resolve(
        types.StructType(list(l.schema.fields) + list(r.schema.fields)))
    return mod.DataFrame(j, session)


@pytest.mark.parametrize("how", sorted(R26_WANT))
def test_r26_example_gives_sparks_rows(how):
    """The example of ROADMAP R26: the port gives Spark's rows; the
    reference's hash-join oracle drops the condition (semi keeps every
    left row, anti none, the outer joins every key pair)."""
    got = r26_join(S, S.TpuSession({}, device="cpu"), how).collect()
    assert sorted(got, key=repr) == sorted(R26_WANT[how], key=repr)
    ref = r26_join(RS, RS.TpuSession(ORACLE), how).collect()
    dropped = {"left_semi": 4, "left_anti": 0}.get(how, 7)
    assert len(ref) == dropped


# -- R27, and what the engine leaves out --------------------------------------

def test_decimal_avg_window_reads_the_scaled_value(reference_plans):
    """Window ``avg`` and the variance family over decimals: the port
    reads the scaled value, as Spark does, held to Python's; the
    reference's oracle reads the unscaled one (ROADMAP R27): its averages
    are 10^scale times the port's, its variances 10^(2 scale) times.  Both
    give the rows in input order."""
    build, conf = R27_QUERIES["decimal_avg_window"]
    q = build(S, S.TpuSession(conf, device="cpu"))
    assert q.explain().splitlines() == reference_plans["decimal_avg_window"]
    got = q.collect()
    rows = data()
    order = sorted(range(N), key=lambda r: (
        rows["g"][r] is not None, rows["g"][r] or 0,
        rows["i"][r] is not None, rows["i"][r] or 0, r))
    seen = {}
    for r in order:
        acc = seen.setdefault(rows["g"][r], {"m": [], "w": []})
        for c in "mw":
            if rows[c][r] is not None:
                acc[c].append(float(rows[c][r]))
        m, w = acc["m"], acc["w"]
        avg_m = sum(m) / len(m) if m else None
        var_m = sum((v - avg_m) ** 2 for v in m) / len(m) if m else None
        avg_w = sum(w) / len(w) if w else None
        sd_w = ((sum((v - avg_w) ** 2 for v in w) / (len(w) - 1)) ** 0.5
                if len(w) > 1 else None)
        for a, b in zip(got[r][7:], (avg_m, var_m, sd_w, avg_w)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a == pytest.approx(b, rel=1e-12, abs=1e-9)
    ref = build(RS, RS.TpuSession(dict(conf, **ORACLE))).collect()
    assert len(ref) == len(got)
    for x, mine in zip(ref, got):
        assert rows_key([x[:7]]) == rows_key([mine[:7]])
        for k, power in ((7, 2), (8, 4), (10, 2)):
            if mine[k] is not None:
                assert x[k] == pytest.approx(mine[k] * 10 ** power,
                                             rel=1e-9, abs=1e-6)


@pytest.mark.parametrize("what", ["collect_list_of_strings",
                                  "collect_list_disabled",
                                  "bloom_filter_disabled",
                                  "hll_two_phase", "hll_of_decimal128"])
def test_unrun_aggregates_raise(what):
    """What the engine leaves out raises ``NotOnGpu`` at plan time: a
    list column in a CPU stage (ROADMAP Queue 1 item 5), the two-phase
    HLL, whose partial buffer is one, and xxhash64 of a decimal above 18
    digits."""
    conf = {} if what in ("collect_list_of_strings",
                          "hll_of_decimal128") else OFF_AGG
    df = table(S, S.TpuSession(conf, device="cpu")).group_by("g")
    q = {"collect_list_of_strings": lambda: df.agg(
            S.collect_list_("s", "c")),
         "collect_list_disabled": lambda: df.agg(S.collect_list_("i", "c")),
         "bloom_filter_disabled": lambda: df.agg(
             S.bloom_filter_agg_("l", "bf")),
         "hll_two_phase": lambda: df.agg(
             S.approx_count_distinct_("l", "h")),
         "hll_of_decimal128": lambda: df.agg(
             S.approx_count_distinct_("w", "h"))}[what]()
    words = {"hll_two_phase": "two-phase approx_count_distinct",
             "hll_of_decimal128": "xxhash64 is not ported"}.get(
                 what, "Queue 1 item 5")
    with pytest.raises(NotOnGpu, match=words):
        q.explain()


def test_string_avg_parses_as_the_cast_does():
    """``avg`` of a string: invalid text is null outside ANSI (Spark's
    cast; both of the reference's paths raise, ROADMAP R25), an error in
    the reference's words under ANSI, on the device and in a CPU
    stage."""
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException

    vals = {"t": ["1.5", " 2.5 ", None, "x", "1e1", "3d"]}
    sch = T.StructType([T.StructField("t", T.STRING)])
    for conf in ({}, OFF_AGG):
        s = S.TpuSession(conf, device="cpu")
        df = s.create_dataframe(vals, sch)
        got = df.agg(S.avg_("t", "a"), S.var_pop_("t", "v")).collect()
        xs = [1.5, 2.5, 10.0, 3.0]
        mean = sum(xs) / 4
        assert got[0][0] == pytest.approx(mean, rel=1e-15)
        assert got[0][1] == pytest.approx(
            sum((x - mean) ** 2 for x in xs) / 4, rel=1e-12)
        s = S.TpuSession(dict(conf, **{"spark.sql.ansi.enabled": "true"}),
                         device="cpu")
        with pytest.raises(SparkArithmeticException,
                           match="invalid input syntax for type numeric"):
            s.create_dataframe(vals, sch).agg(S.avg_("t", "a")).collect()


def test_window_sum_of_an_int_is_a_long():
    """A window ``sum`` of an INT column adds into a long, as Spark's
    does; the reference's oracle adds numpy int32 values, which wrap at
    32 bits (ROADMAP R28)."""
    WFS = {S: __import__("spark_rapids_tpu_torch.plan.nodes",
                         fromlist=["x"]).WindowFunction,
           RS: __import__("spark_rapids_tpu.plan.nodes",
                          fromlist=["x"]).WindowFunction}
    got = {}
    for mod, sess in ((S, S.TpuSession(OFF_SORT, device="cpu")),
                      (RS, RS.TpuSession(ORACLE))):
        types = _types(mod)
        df = sess.create_dataframe(
            {"p": [1, 1], "o": [1, 2], "v": [2 ** 31 - 1, 1]},
            types.StructType([types.StructField(c, types.INT)
                              for c in "pov"]))
        got[mod] = df.window([WFS[mod]("sum", mod.col("v"), "x")],
                             partition_by=["p"], order_by=[mod.col("o")],
                             frame=("rows", 300, 0)).collect()
    assert [r[3] for r in got[S]] == [2 ** 31 - 1, 2 ** 31]
    assert [r[3] for r in got[RS]] == [2 ** 31 - 1, -2 ** 31]

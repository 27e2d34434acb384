"""Windows (``exec/window.py``) and the segmented scans under them
(``ops/segment.py::seg_scan_*``) against the JAX package.

The scans are held against the reference's ``seg_scan_sum``/``_min``/
``_max`` (child process) on int64 and float64 values with nulls, NaN and
-0.0.  Every ported window function (``row_number``, ``rank``,
``dense_rank``, ``percent_rank``, ``cume_dist``, ``ntile``; ``sum``,
``count``, ``min`` and ``max`` over long, double, decimal and date inputs)
in the ``running`` and ``unbounded`` frames is held against the
reference's CPU oracle session, over partition keys with nulls and
one-row partitions, or none at all, and order keys with nulls, ties, NaN
and -0.0, ascending and descending, on one batch and on several, and on
an empty input.  Integers, decimals and dates compare exactly, doubles to
12 significant digits.  The other functions and frames
(``test_torch_window_frames.py`` holds them all) run here once each; what
the reference tags off the device runs as a CPU stage with the oracle's
rows, or, where its oracle cannot run it either, raises ``NotOnGpu`` with
its words."""
import datetime
from decimal import Decimal

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.plan.nodes import WindowFunction as RWF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from spark_rapids_tpu_torch.ops import segment as SEG
from spark_rapids_tpu_torch.ops.sortkeys import SortSpec
from spark_rapids_tpu_torch.plan.nodes import WindowFunction as PWF
from torch_port_frames import ORACLE, rows_key
from torch_port_jaxref import run_jax


def _scan_inputs(seed=4, n=700):
    rng = np.random.default_rng(seed)
    starts = rng.random(n) < 0.08
    starts[0] = True
    starts[100:110] = True                     # one-row segments
    ints = rng.integers(-10 ** 12, 10 ** 12, n)
    ints[:5] = [2 ** 63 - 1, 2 ** 63 - 1, -2 ** 63, 5, -5]   # wraps
    floats = rng.normal(0, 1e6, n)
    floats[rng.random(n) < 0.05] = np.nan
    floats[rng.random(n) < 0.05] = -0.0
    floats[200:230] = np.nan                   # a segment of NaNs
    starts[200] = True
    return {"starts": starts, "ints": ints, "floats": floats,
            "valid": rng.random(n) > 0.15}


def test_segmented_scans_match_reference(tmp_path):
    inp = _scan_inputs()
    out = run_jax("""
        import jax
        import jax.numpy as jnp
        from spark_rapids_tpu.ops import segment as SEG

        def scans(v, va, st, f):
            return (SEG.seg_scan_sum(v, va, st)
                    + SEG.seg_scan_min(v, va, st, f)
                    + SEG.seg_scan_max(v, va, st, f))

        st = jnp.asarray(inp["starts"])
        va = jnp.asarray(inp["valid"])
        for kind in ("ints", "floats"):
            res = jax.jit(scans, static_argnums=3)(
                jnp.asarray(inp[kind]), va, st, kind == "floats")
            for name, r in zip(("sum", "cnt", "min", "min_seen", "max",
                                "max_seen"), res):
                out[f"{kind}_{name}"] = np.asarray(r)
    """, tmp_path, inp)
    st = torch.from_numpy(inp["starts"])
    va = torch.from_numpy(inp["valid"])
    for kind in ("ints", "floats"):
        v = torch.from_numpy(inp[kind])
        f = kind == "floats"
        s, c = SEG.seg_scan_sum(v, va, st)
        if f:
            np.testing.assert_allclose(s.numpy(), out[kind + "_sum"],
                                       rtol=1e-12, atol=1e-6)
        else:
            np.testing.assert_array_equal(s.numpy(), out[kind + "_sum"])
        np.testing.assert_array_equal(c.numpy(), out[kind + "_cnt"])
        for name, fn in (("min", SEG.seg_scan_min),
                         ("max", SEG.seg_scan_max)):
            m, seen = fn(v, va, st, f)
            np.testing.assert_array_equal(m.numpy(), out[f"{kind}_{name}"])
            np.testing.assert_array_equal(seen.numpy(),
                                          out[f"{kind}_{name}_seen"])


def test_segmented_scans_on_no_rows():
    e = torch.zeros(0, dtype=torch.int64)
    b = torch.zeros(0, dtype=torch.bool)
    for s in SEG.seg_scan_sum(e, b, b) + SEG.seg_scan_min(e, b, b, False) \
            + SEG.seg_scan_max(e.double(), b, b, True):
        assert s.shape == (0,)


# ---------------------------------------------------------------------------
# whole windows against the CPU oracle
# ---------------------------------------------------------------------------

_N = 320


def _data(seed=9):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.1):
        return [v if rng.random() > p else None for v in vals]

    p = [int(x) for x in rng.integers(0, 6, _N)]
    p[-8:] = [100 + i for i in range(8)]        # one-row partitions
    d = [float(x) for x in rng.choice([-1.5, -0.0, 0.0, 2.25, 7.0, np.nan],
                                      _N)]
    return {
        "p": nulls(p),
        "o": nulls([int(x) for x in rng.integers(0, 8, _N)]),
        "d": nulls(d),
        "v": nulls([int(x) for x in rng.integers(-10 ** 9, 10 ** 9, _N)]),
        "f": nulls([float(x) if rng.random() > 0.05 else float("nan")
                    for x in rng.normal(0, 100, _N)]),
        "m": nulls([Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-10 ** 6, 10 ** 6, _N)]),
        "t": nulls([datetime.date(1998, 1, 1)
                    + datetime.timedelta(days=int(x))
                    for x in rng.integers(0, 400, _N)]),
    }


def _schema(mod):
    return mod.StructType([
        mod.StructField("p", mod.INT), mod.StructField("o", mod.INT),
        mod.StructField("d", mod.DOUBLE), mod.StructField("v", mod.LONG),
        mod.StructField("f", mod.DOUBLE),
        mod.StructField("m", mod.DecimalType(7, 2)),
        mod.StructField("t", mod.DATE)])


RANKING = ["row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
           "ntile"]
AGGS = [(fn, c) for fn in ("sum", "count", "min", "max")
        for c in ("v", "f", "m")] + [("min", "t"), ("max", "t"),
                                     ("count", "t")]

ORDERS = {
    "o_asc": [("o", True, True)],
    "d_desc_nulls_last": [("d", False, False)],
    "o_desc_d_asc": [("o", False, True), ("d", True, False)],
}


def _functions(WF, col):
    fns = [WF(name, None, name) for name in RANKING[:-1]]
    fns.append(WF("ntile", None, "ntile", buckets=3))
    fns += [WF(fn, col(c), f"{fn}_{c}") for fn, c in AGGS]
    return fns


def _window(mod, WF, types, session, frame, partitioned, order,
            data=None):
    df = session.create_dataframe(data or _data(), _schema(types))
    ob = [(mod.col(c), mod.SortSpec(ascending=a, nulls_first=nf))
          for c, a, nf in ORDERS[order]]
    return df.window(_functions(WF, mod.col),
                     partition_by=["p"] if partitioned else [],
                     order_by=ob, frame=frame)


@pytest.mark.parametrize("frame", ["running", "unbounded"])
@pytest.mark.parametrize("partitioned", [True, False])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_window_functions_match_oracle(frame, partitioned, order):
    conf = {"spark.rapids.sql.reader.batchSizeRows": 100}
    df = _window(S, PWF, T, S.TpuSession(conf, device="cpu"), frame,
                 partitioned, order)
    got = df.collect()
    want = _window(RS, RWF, RT, RS.TpuSession(ORACLE), frame, partitioned,
                   order).collect()
    assert rows_key(got, approx_float=True, ordered=True) == \
        rows_key(want, approx_float=True, ordered=True)
    assert rows_key(df.collect(), approx_float=True, ordered=True) == \
        rows_key(got, approx_float=True, ordered=True)     # a second run
    assert df.explain().splitlines()[0] == (
        f"TpuWindow [{', '.join(f.func for f in _functions(PWF, S.col))}] "
        f"frame={frame}")
    types = [f.dataType.simpleString for f in df.schema.fields[7:]]
    assert types[:6] == ["int", "int", "int", "double", "double", "int"]
    assert types[6:9] == ["bigint", "double", "decimal(17,2)"]


def test_window_over_no_rows_matches_oracle():
    def run(mod, WF, types, session):
        df = session.create_dataframe(_data(), _schema(types))
        df = df.filter(mod.col("o") > mod.lit(100))
        return df.window([WF("rank", None, "rk"),
                          WF("sum", mod.col("v"), "s")],
                         partition_by=["p"],
                         order_by=[mod.col("o")]).collect()

    assert run(S, PWF, T, S.TpuSession({}, device="cpu")) == \
        run(RS, RWF, RT, RS.TpuSession(ORACLE)) == []


def test_rank_filter_keeps_ties():
    """rank() <= 2 keeps every tied row (bench qc's filter shape)."""
    data = {"p": [1, 1, 1, 1, 2, 2, None, None],
            "o": [5, 5, 5, 3, 1, None, 2, 2],
            "d": [0.0] * 8, "v": [0] * 8, "f": [0.0] * 8,
            "m": [Decimal(0)] * 8, "t": [datetime.date(2000, 1, 1)] * 8}

    def run(mod, WF, types, session):
        df = session.create_dataframe(data, _schema(types))
        r = df.window([WF("rank", None, "rk")], partition_by=["p"],
                      order_by=[(mod.col("o"), mod.SortSpec(
                          ascending=False, nulls_first=False))])
        return r.filter(mod.col("rk") <= mod.lit(2)).select(
            mod.col("p"), mod.col("o"), mod.col("rk")).collect()

    got = run(S, PWF, T, S.TpuSession({}, device="cpu"))
    assert sorted(got, key=repr) == sorted(
        run(RS, RWF, RT, RS.TpuSession(ORACLE)), key=repr)
    assert sorted(got, key=repr) == sorted(
        [(1, 5, 1), (1, 5, 1), (1, 5, 1), (2, 1, 1), (2, None, 2),
         (None, 2, 1), (None, 2, 1)], key=repr)


#: functions and frames that once raised ``NotOnGpu`` in the port; each
#: now equals the oracle
UNPORTED = {
    "lead": (lambda WF, c: WF("lead", c("v"), "x"), "running"),
    "lag": (lambda WF, c: WF("lag", c("v"), "x"), "running"),
    "first_value": (lambda WF, c: WF("first_value", c("v"), "x"),
                    "running"),
    "last_value": (lambda WF, c: WF("last_value", c("v"), "x"), "running"),
    "avg": (lambda WF, c: WF("avg", c("v"), "x"), "running"),
    "var_pop": (lambda WF, c: WF("var_pop", c("f"), "x"), "running"),
    "stddev_samp": (lambda WF, c: WF("stddev_samp", c("f"), "x"),
                    "running"),
    "range_running": (lambda WF, c: WF("sum", c("v"), "x"),
                      "range_running"),
    "rows_frame": (lambda WF, c: WF("sum", c("v"), "x"), ("rows", 1, 1)),
    "range_frame": (lambda WF, c: WF("max", c("v"), "x"), ("range", 1, 1)),
    "sum_decimal128_result": (lambda WF, c: WF("sum", c("m12"), "x"),
                              "running"),
}


def _unported(mod, WF, types, session, what):
    make, frame = UNPORTED[what]
    df = session.create_dataframe(_data(), _schema(types)).select(
        mod.col("p"), mod.col("o"), mod.col("v"), mod.col("f"),
        mod.col("m").cast(types.DecimalType(12, 2)).alias("m12"))
    return df.window([make(WF, mod.col)], partition_by=["p"],
                     order_by=[mod.col("o")], frame=frame)


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_window_functions_raise(what):
    """The functions and frames that once raised ``NotOnGpu`` now run and
    equal the oracle (the name is kept from then)."""
    got = _unported(S, PWF, T, S.TpuSession({}, device="cpu"),
                    what).collect()
    want = _unported(RS, RWF, RT, RS.TpuSession(ORACLE), what).collect()
    assert rows_key(got, approx_float=True, ordered=True) == \
        rows_key(want, approx_float=True, ordered=True)


#: windows the reference tags off the device, with its words: (function,
#: input, frame, order keys, words).  The port's CPU engine runs them (a
#: Window CPU stage) but for the three its oracle cannot run either
TAGGED_OFF = {
    "rows_wider_than_256": ("sum", "v", ("rows", 200, 56), ["o"],
                            "bounded window width 257 exceeds"),
    "range_over_two_keys": (
        "sum", "v", ("range", 1, 1), ["o", "f"],
        "RANGE window frames require exactly one ORDER BY key"),
    "range_over_a_string_key": (
        "count", "v", ("range", 1, 0), ["s"],
        "RANGE window frames over string order keys"),
    "avg_over_a_decimal": (
        "avg", "m", "running", ["o"],
        "window avg over decimals yields a decimal result"),
    "sum_of_a_string": ("sum", "s", "running", ["o"],
                        "sum over strings is not valid"),
    "string_max_bounded": ("max", "s", ("rows", 1, 1), ["o"],
                           "string min/max over bounded window frames"),
    "negative_offset": ("sum", "v", ("rows", -1, 1), ["o"],
                        "offsets must be non-negative"),
    "decimal128_input": ("max", "m22", "running", ["o"],
                         "max over decimals above 18 digits in a window"),
}
#: the shapes that still raise: the reference's oracle cannot bound a
#: RANGE frame over a string key (a TypeError) nor sum strings
STILL_RAISE = ("range_over_a_string_key", "sum_of_a_string")


def _tagged_off(mod, WF, types, session, what):
    func, c, frame, order, _ = TAGGED_OFF[what]
    rows = _data()
    rows["s"] = [None if v is None else str(v) for v in rows["o"]]
    sch = types.StructType(list(_schema(types).fields)
                           + [types.StructField("s", types.STRING)])
    df = session.create_dataframe(rows, sch).select(
        mod.col("p"), mod.col("o"), mod.col("v"), mod.col("f"),
        mod.col("m"), mod.col("m").cast(types.DecimalType(22, 2)).alias(
            "m22"), mod.col("s"))
    return df.window([WF(func, mod.col(c), "x")], partition_by=["p"],
                     order_by=[mod.col(k) for k in order], frame=frame)


@pytest.mark.parametrize("what", sorted(TAGGED_OFF))
def test_tagged_off_windows_raise(what):
    """The reference's ``_window_check`` tags these off the device, with
    its words.  The port's CPU engine runs them as a Window CPU stage,
    with the oracle's rows (a decimal ``avg`` the scaled value, where the
    oracle reads the unscaled one, ROADMAP R27; a negative ROWS offset
    the oracle's frame, ``("rows", -1, 1)`` the row after), but for the
    two it leaves out, which raise ``NotOnGpu`` with the rule's words.
    (The name is kept from when every case raised.)"""
    words = TAGGED_OFF[what][-1]
    w = _tagged_off(S, PWF, T, S.TpuSession({}, device="cpu"), what)
    if what in STILL_RAISE:
        with pytest.raises(NotOnGpu, match=words):
            w.collect()
        return
    assert words in w.explain()
    got = w.collect()
    want = _tagged_off(RS, RWF, RT, RS.TpuSession(ORACLE), what).collect()
    if what == "avg_over_a_decimal":
        want = [r[:-1] + (None if r[-1] is None else r[-1] / 100,)
                for r in want]
    assert rows_key(got, approx_float=True, ordered=True) == \
        rows_key(want, approx_float=True, ordered=True)


def test_window_sort_spec_default():
    """A plain order column sorts ASC NULLS FIRST (the reference's
    default ``SortSpec``)."""
    s = S.TpuSession({}, device="cpu")
    df = s.create_dataframe({"p": [1, 1, 1], "o": [2, None, 1]},
                            T.StructType([T.StructField("p", T.INT),
                                          T.StructField("o", T.INT)]))
    got = df.window([PWF("row_number", None, "rn")], partition_by=["p"],
                    order_by=["o"]).collect()
    assert got == [(1, 2, 3), (1, None, 1), (1, 1, 2)]
    assert SortSpec() == SortSpec(ascending=True, nulls_first=True)

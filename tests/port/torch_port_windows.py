"""Shared pieces of the window-frame and statistics tests, CPU
(``test_torch_window_frames.py``, ``test_torch_stats_aggs.py``) and card
(``test_torch_gpu.py``): their tables, functions and frames, built with
the session module and types of either package.  Imports no jax."""
import datetime
import math
from decimal import Decimal

import numpy as np

from torch_port_frames import frame

N = 120
WORDS = ["", "a", "a\x00", "b", "ab", "zz", "mango", "Mango", "ba"]


def data(seed=17, n=N):
    rng = np.random.default_rng(seed)

    def nulls(vals, p=0.12):
        return [v if rng.random() > p else None for v in vals]

    p = [int(x) for x in rng.integers(0, 4, n)]
    p[-5:] = [50 + i for i in range(5)]          # one-row partitions
    d = [float(x) for x in rng.choice(
        [-2.5, -0.0, 0.0, 1.0, 1.5, 4.0, 9.0, np.nan, np.inf], n)]
    f = [float(x) if rng.random() > 0.06 else float("nan")
         for x in rng.normal(0, 50, n)]
    f[7] = -0.0
    return {
        "p": nulls(p),
        "o": nulls([int(x) for x in rng.integers(0, 12, n)]),
        "d": nulls(d),
        "t": nulls([datetime.date(1999, 12, 20)
                    + datetime.timedelta(days=int(x))
                    for x in rng.integers(0, 30, n)]),
        "v": nulls([int(x) for x in rng.integers(-10 ** 9, 10 ** 9, n)],
                   0.3),
        "f": nulls(f, 0.3),
        "m": nulls([Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-10 ** 6, 10 ** 6, n)], 0.3),
        "w": nulls([Decimal(int(x)).scaleb(-2)
                    for x in rng.integers(-10 ** 11, 10 ** 11, n)], 0.3),
        "s": nulls([WORDS[int(x)] for x in rng.integers(0, len(WORDS), n)],
                   0.3),
    }


def schema(mod):
    return mod.StructType([
        mod.StructField("p", mod.INT), mod.StructField("o", mod.INT),
        mod.StructField("d", mod.DOUBLE), mod.StructField("t", mod.DATE),
        mod.StructField("v", mod.LONG), mod.StructField("f", mod.DOUBLE),
        mod.StructField("m", mod.DecimalType(7, 2)),
        mod.StructField("w", mod.DecimalType(12, 2)),
        mod.StructField("s", mod.STRING)])


NUMERIC = ["sum", "count", "avg", "min", "max", "var_pop", "var_samp",
           "stddev_pop", "stddev_samp"]
#: (function, input column) per group of the test; decimals take no avg or
#: variance, strings only count/min/max (the reference's tagging)
AGGS = ([(fn, c) for fn in NUMERIC for c in "vf"]
        + [(fn, "m") for fn in ("sum", "count", "min", "max")]
        + [("min", "t"), ("max", "t"), ("count", "t"), ("sum", "w"),
           ("count", "w"), ("count", "s")])
STRING_MINMAX = [("min", "s"), ("max", "s")]


def navigation(WF, col):
    """lead/lag (offsets 0-2, literal defaults) and first/last_value (with
    and without IGNORE NULLS) over every input type."""
    out = [WF("lead", col("v"), "lead_v"),
           WF("lag", col("f"), "lag_f", offset=2),
           WF("lead", col("s"), "lead_s", offset=2, default="none"),
           WF("lag", col("m"), "lag_m", default=Decimal("-1.00")),
           WF("lag", col("t"), "lag_t", offset=0),
           WF("lead", col("w"), "lead_w", offset=1)]
    for fn in ("first_value", "last_value"):
        for c in "vfmts":
            out.append(WF(fn, col(c), f"{fn}_{c}"))
            out.append(WF(fn, col(c), f"{fn}_{c}_nn", ignore_nulls=True))
    return out


def functions(WF, col, frame):
    fns = [WF(name, None, name) for name in
           ("row_number", "rank", "dense_rank", "percent_rank",
            "cume_dist")]
    fns.append(WF("ntile", None, "ntile", buckets=3))
    fns += navigation(WF, col)
    fns += [WF(fn, col(c), f"{fn}_{c}") for fn, c in AGGS]
    if not isinstance(frame, tuple):
        fns += [WF(fn, col(c), f"{fn}_{c}") for fn, c in STRING_MINMAX]
    return fns


ORDERS = {
    "o_asc": [("o", True, True)],
    "d_desc_nulls_last": [("d", False, False)],
    "t_asc_nulls_last": [("t", True, False)],
    "o_desc_d_asc": [("o", False, True), ("d", True, False)],
}

#: (frame, order) cases: the linear frames over every order, the bounded
#: ROWS frames at 0 and at the cap, the bounded RANGE frames over each
#: order-key type in both directions
CASES = (
    [(fr, o) for fr in ("running", "range_running", "unbounded")
     for o in ("o_asc", "d_desc_nulls_last", "o_desc_d_asc")]
    + [(("rows", 2, 0), "o_desc_d_asc"), (("rows", 0, 3), "o_asc"),
       (("rows", 1, 1), "d_desc_nulls_last"),
       (("rows", 255, 0), "t_asc_nulls_last"),
       (("rows", 0, 255), "o_asc"), (("rows", 100, 155), "o_asc")]
    + [(("range", 2, 1), "o_asc"), (("range", 0, 3), "o_asc"),
       (("range", 1.5, 0), "d_desc_nulls_last"),
       (("range", 3, 4), "d_desc_nulls_last"),
       (("range", 7, 0), "t_asc_nulls_last"),
       (("range", 2, 2), "t_asc_nulls_last")])


def _id(case):
    fr, o = case
    return (("_".join(str(x) for x in fr) if isinstance(fr, tuple) else fr)
            + "-" + o)


def window(mod, WF, types, session, frame, order, partitioned=True):
    df = session.create_dataframe(data(), schema(types))
    ob = [(mod.col(c), mod.SortSpec(ascending=a, nulls_first=nf))
          for c, a, nf in ORDERS[order]]
    return df.window(functions(WF, mod.col, frame),
                     partition_by=["p"] if partitioned else [],
                     order_by=ob, frame=frame)


def same_rows(a, b, rtol: float) -> bool:
    """Rows equal in order, doubles within ``rtol`` (NaN equal to NaN,
    -0.0 to 0.0), every other value exactly."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            if isinstance(x, float) and isinstance(y, float):
                if not (math.isclose(x, y, rel_tol=rtol)
                        or (math.isnan(x) and math.isnan(y))):
                    return False
            elif x != y:
                return False
    return True




# -- the statistics aggregates' table ----------------------------------------

STATS_N = 900
REGR = ["regr_count", "regr_avgx", "regr_avgy", "regr_sxx", "regr_syy",
        "regr_sxy", "regr_slope", "regr_intercept", "regr_r2"]


def stats_schema(mod):
    return mod.StructType([
        mod.StructField("g", mod.INT), mod.StructField("i", mod.INT),
        mod.StructField("l", mod.LONG), mod.StructField("d", mod.DOUBLE),
        mod.StructField("m", mod.DecimalType(9, 2)),
        mod.StructField("s", mod.STRING)])


def stats_data():
    rng = np.random.default_rng(41)
    g = rng.integers(0, 7, STATS_N).astype(np.int32)
    g[:3] = [20, 21, 22]                       # one-row groups
    arr = {"g": g, "i": rng.integers(-1000, 1000, STATS_N).astype(np.int32),
           "l": rng.integers(-2 ** 40, 2 ** 40, STATS_N),
           "d": rng.normal(3, 1e3, STATS_N),
           "m": rng.integers(-10 ** 8, 10 ** 8, STATS_N),
           "s": np.array(["x"] * STATS_N, object)}
    valid = {k: rng.random(STATS_N) > 0.1 for k in arr}
    for k in arr:
        if k != "g":
            valid[k] &= g != 6                 # group 6: every input null
    const = g == 5                             # group 5: x and y constant
    arr["i"][const] = 7
    arr["d"][const] = -2.0
    yconst = g == 4                            # group 4: y constant
    arr["l"][yconst] = 123456
    return arr, valid


def stats_aggs(mod):
    out = [mod.skewness_(c, f"skew_{c}") for c in "ildm"]
    out += [mod.kurtosis_(c, f"kurt_{c}") for c in "ildm"]
    for x, y in (("i", "d"), ("l", "m"), ("d", "i")):
        out += [mod.corr_(x, y, f"corr_{x}{y}"),
                mod.covar_pop_(x, y, f"cpop_{x}{y}"),
                mod.covar_samp_(x, y, f"csamp_{x}{y}")]
    for y, x in (("d", "i"), ("l", "m"), ("i", "d")):
        out += [getattr(mod, f + "_")(y, x, f"{f}_{y}{x}") for f in REGR]
    return out


def stats_query(mod, types, session, grouped=True, empty=False):
    arr, valid = stats_data()
    df = frame(mod, session, arr, stats_schema(types), valid)
    if empty:
        df = df.filter(mod.col("g") > mod.lit(100))
    gb = df.group_by("g") if grouped else df.group_by()
    return gb.agg(*stats_aggs(mod))

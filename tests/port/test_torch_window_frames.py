"""Every window function of the reference's ``_WINDOW_FUNCS_SUPPORTED``
in every frame (``running``, ``range_running``, ``unbounded``, bounded
ROWS with either bound at 0 and at the 256-row cap, bounded RANGE over an
integral, a floating and a DATE key, ascending and descending) over long,
double (NaN, -0.0), decimal, DATE and string inputs, against the JAX
package's CPU oracle session: partition keys with nulls, one-row
partitions or none at all, order keys with nulls and ties, one batch and
several, an empty input.  Integers, decimals, dates and strings compare
exactly, doubles to 12 significant digits (``torch_port_frames``): the
port adds in the scans' and tables' orders where the oracle adds row by
row.  A window ``sum`` whose decimal result is above 18 digits equals the
oracle; the reference's device raises there (ROADMAP R23).  Every case
the reference tags off the device runs as a CPU stage, or raises
``NotOnGpu`` with the reference's words where the port's CPU engine
leaves it out (``test_torch_window.py``).  The tables, functions and frames are
``torch_port_windows``'s, shared with the card test."""
import math
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.plan.nodes import WindowFunction as RWF
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.plan.nodes import WindowFunction as PWF
from torch_port_frames import ORACLE, rows_key
from torch_port_jaxref import run_jax
from torch_port_windows import CASES, WORDS, _id, data, functions, schema, \
    window

def check(frame, order, partitioned=True, conf=None):
    s = S.TpuSession(conf or {}, device="cpu")
    df = window(S, PWF, T, s, frame, order, partitioned)
    got = df.collect()
    want = window(RS, RWF, RT, RS.TpuSession(ORACLE), frame, order,
                  partitioned).collect()
    assert rows_key(got, approx_float=True, ordered=True) == \
        rows_key(want, approx_float=True, ordered=True)
    return df, got


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_window_frames_match_oracle(case):
    frame, order = case
    df, _ = check(frame, order)
    assert df.explain().splitlines()[0].endswith(f"frame={frame}")


@pytest.mark.parametrize("case", [("unbounded", "o_asc"),
                                  (("rows", 3, 2), "o_desc_d_asc"),
                                  (("range", 1, 1), "o_asc")], ids=_id)
def test_window_frames_without_partition_keys(case):
    check(*case, partitioned=False)


@pytest.mark.parametrize("case", [("range_running", "d_desc_nulls_last"),
                                  (("rows", 4, 4), "o_asc"),
                                  (("range", 5, 0), "t_asc_nulls_last")],
                         ids=_id)
def test_window_frames_over_several_batches(case):
    df, got = check(*case, conf={"spark.rapids.sql.reader.batchSizeRows":
                                 37})
    assert rows_key(df.collect(), True, True) == rows_key(got, True, True)


@pytest.mark.parametrize("frame", ["running", ("rows", 1, 1),
                                   ("range", 2, 0)], ids=str)
def test_window_frames_over_no_rows(frame):
    def run(mod, WF, types, session):
        df = session.create_dataframe(data(), schema(types))
        df = df.filter(mod.col("o") > mod.lit(100))
        return df.window(functions(WF, mod.col, frame), partition_by=["p"],
                         order_by=[mod.col("o")], frame=frame).collect()

    assert run(S, PWF, T, S.TpuSession({}, device="cpu")) == \
        run(RS, RWF, RT, RS.TpuSession(ORACLE)) == []


def _edge(mod, WF, types, session, values, order_vals, frame, funcs,
          ltype="DOUBLE", otype="DOUBLE", asc=True):
    sch = types.StructType([
        types.StructField("p", types.INT),
        types.StructField("o", getattr(types, otype)),
        types.StructField("x", getattr(types, ltype))])
    df = session.create_dataframe(
        {"p": [1] * len(values), "o": order_vals, "x": values}, sch)
    return df.window([WF(fn, mod.col("x"), f"{fn}_{i}", **kw)
                      for i, (fn, kw) in enumerate(funcs)],
                     partition_by=["p"],
                     order_by=[(mod.col("o"), mod.SortSpec(ascending=asc))],
                     frame=frame).collect()


EDGES = {
    # IGNORE NULLS over frames whose rows are all null: null
    "ignore_nulls_all_null": (
        [None, None, 1.5, None, None, None, 2.5], list(range(7)),
        ("rows", 1, 0), [("first_value", {"ignore_nulls": True}),
                         ("last_value", {"ignore_nulls": True}),
                         ("first_value", {}), ("last_value", {})],
        "DOUBLE", "LONG", True),
    # a max over a frame with a NaN is NaN, a min over NaNs alone NaN
    "nan_min_max": (
        [float("nan"), float("nan"), 3.0, float("nan"), -0.0, 0.0, None],
        list(range(7)), ("rows", 1, 1), [("min", {}), ("max", {}),
                                         ("sum", {}), ("avg", {})],
        "DOUBLE", "LONG", True),
    "nan_min_max_range": (
        [float("nan"), float("nan"), 3.0, float("nan"), -0.0, 0.0, None],
        [0, 0, 1, 5, 5, 6, 9], ("range", 0, 1),
        [("min", {}), ("max", {}), ("var_samp", {})], "DOUBLE", "LONG",
        False),
    # -0.0 and 0.0 are one peer group of a RANGE key, NaN keys another
    "zero_and_nan_keys": (
        [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0],
        [-0.0, 0.0, float("nan"), float("nan"), 1.0, None, -1.0, 0.5],
        ("range", 1, 0), [("sum", {}), ("count", {}),
                          ("first_value", {}), ("last_value", {})],
        "DOUBLE", "DOUBLE", True),
    "zero_and_nan_keys_desc": (
        [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0],
        [-0.0, 0.0, float("nan"), float("nan"), 1.0, None, -1.0, 0.5],
        ("range", 0, 1), [("sum", {}), ("max", {})], "DOUBLE", "DOUBLE",
        False),
    "zero_and_nan_keys_range_running": (
        [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0],
        [-0.0, 0.0, float("nan"), float("nan"), 1.0, None, -1.0, 0.5],
        "range_running", [("sum", {}), ("last_value", {})], "DOUBLE",
        "DOUBLE", True),
    # int64 bounds saturate at the type's extremes
    "int64_extremes": (
        [1, 2, 4, 8, 16, 32],
        [-2 ** 63, -2 ** 63 + 1, -5, 7, 2 ** 63 - 2, 2 ** 63 - 1],
        ("range", 2 ** 62, 2 ** 62), [("sum", {}), ("count", {}),
                                      ("min", {})], "LONG", "LONG", True),
    "int64_extremes_desc": (
        [1, 2, 4, 8, 16, 32],
        [-2 ** 63, -2 ** 63 + 1, -5, 7, 2 ** 63 - 2, 2 ** 63 - 1],
        ("range", 3, 2 ** 63 - 1), [("sum", {}), ("max", {})], "LONG",
        "LONG", False),
}


@pytest.mark.parametrize("what", sorted(EDGES))
def test_window_frame_edges_match_oracle(what):
    """The oracle's rules one case at a time: IGNORE NULLS over all-null
    frames, NaN in min/max, -0.0 and NaN peers of a RANGE key, saturating
    int64 bounds."""
    values, order_vals, frame, funcs, lt, ot, asc = EDGES[what]
    got = _edge(S, PWF, T, S.TpuSession({}, device="cpu"), values,
                order_vals, frame, funcs, lt, ot, asc)
    want = _edge(RS, RWF, RT, RS.TpuSession(ORACLE), values, order_vals,
                 frame, funcs, lt, ot, asc)
    assert rows_key(got, True, True) == rows_key(want, True, True)


def test_decimal128_window_sum_follows_the_oracle(tmp_path):
    """A running ``sum`` of a decimal(12,2) has a decimal(22,2) result:
    the port's 128-bit frame sums equal the oracle's exact ones, where the
    reference's device raises (it accumulates in int64 into a 128-bit
    column; ROADMAP R23)."""
    rows = {"p": [1, 1, 1, 2, 2], "o": [1, 2, 3, 1, 2],
            "m": [Decimal("9999999999.99"), Decimal("9999999999.99"),
                  Decimal("-1.00"), Decimal("5.00"), None]}

    def run(mod, WF, types, session, frame):
        sch = types.StructType([types.StructField("p", types.INT),
                                types.StructField("o", types.INT),
                                types.StructField("m",
                                                  types.DecimalType(12, 2))])
        return session.create_dataframe(rows, sch).window(
            [WF("sum", mod.col("m"), "s")], partition_by=["p"],
            order_by=["o"], frame=frame)

    for frame in ("running", "unbounded", ("rows", 0, 1), ("range", 1, 0)):
        got = run(S, PWF, T, S.TpuSession({}, device="cpu"), frame)
        assert got.schema.fields[-1].dataType.simpleString == "decimal(22,2)"
        assert got.collect() == run(RS, RWF, RT, RS.TpuSession(ORACLE),
                                    frame).collect()
    assert [r[-1] for r in run(S, PWF, T, S.TpuSession({}, device="cpu"),
                               "running").collect()] == [
        Decimal("9999999999.99"), Decimal("19999999999.98"),
        Decimal("19999999998.98"), Decimal("5.00"), Decimal("5.00")]
    out = run_jax(f"""
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.plan.nodes import WindowFunction as WF
        from decimal import Decimal
        rows = {rows!r}
        sch = T.StructType([T.StructField("p", T.INT),
                            T.StructField("o", T.INT),
                            T.StructField("m", T.DecimalType(12, 2))])
        df = RS.TpuSession({{}}).create_dataframe(rows, sch).window(
            [WF("sum", RS.col("m"), "s")], partition_by=["p"],
            order_by=["o"])
        try:
            df.collect()
            out["error"] = np.array([""])
        except Exception as e:
            out["error"] = np.array([type(e).__name__])
    """, tmp_path, {})
    assert str(out["error"][0]) == "IndexError"


def test_new_segmented_scans_match_numpy():
    """``seg_scan_moments``, the valid-index scans and the string arg scan
    against plain numpy loops (the reference keeps them inside its window
    exec; the window tests above hold them through its results)."""
    import torch

    from spark_rapids_tpu_torch.ops import segment as SEG
    from spark_rapids_tpu_torch.ops.sortkeys import string_key_words

    rng = np.random.default_rng(3)
    n = 300
    starts = rng.random(n) < 0.1
    starts[0] = True
    valid = rng.random(n) > 0.3
    x = rng.normal(5, 3, n)
    cnt, _, m2 = SEG.seg_scan_moments(torch.from_numpy(x),
                                      torch.from_numpy(valid),
                                      torch.from_numpy(starts))
    seg = np.cumsum(starts) - 1
    for i in range(n):
        xs = x[(seg == seg[i]) & valid & (np.arange(n) <= i)]
        assert cnt[i] == len(xs)
        assert math.isclose(float(m2[i]), float(((xs - xs.mean()) ** 2).sum())
                            if len(xs) else 0.0, rel_tol=1e-9, abs_tol=1e-9)
    prv = SEG.prev_valid_index(torch.from_numpy(valid)).numpy()
    nxt = SEG.next_valid_index(torch.from_numpy(valid)).numpy()
    idx = np.nonzero(valid)[0]
    for i in range(n):
        before, after = idx[idx <= i], idx[idx >= i]
        assert prv[i] == (before[-1] if len(before) else -1)
        assert nxt[i] == (after[0] if len(after) else n)
    words = rng.choice(WORDS, n)
    chars = np.zeros((n, 8), np.uint8)
    for i, w in enumerate(words):
        chars[i, :len(w)] = np.frombuffer(w.encode(), np.uint8)
    kw = string_key_words(torch.from_numpy(chars)) + [
        torch.tensor([len(w) for w in words], dtype=torch.int64)]
    for is_min in (True, False):
        arg, seen = SEG.seg_scan_arg_words(kw, torch.from_numpy(valid),
                                           torch.from_numpy(starts), is_min)
        for i in range(n):
            ws = [w for w, ok, s in zip(words[:i + 1], valid[:i + 1],
                                        seg[:i + 1]) if ok and s == seg[i]]
            assert bool(seen[i]) == bool(ws)
            if ws:
                assert words[int(arg[i])] == (min(ws) if is_min
                                              else max(ws))

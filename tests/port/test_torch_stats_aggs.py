"""``skewness``, ``kurtosis``, ``covar_pop``, ``covar_samp``, ``corr`` and
the nine ``regr_*`` aggregates against the JAX package's CPU oracle
session: over int, long, double and decimal inputs with nulls, grouped
(one-row groups, a group whose inputs are all null, a constant group, a
group whose y alone is constant) and global, on one batch and on several
(their buffers merged by the closed forms), and on an empty input.  The
result types equal the reference's.  Doubles compare to 12
significant digits (``torch_port_frames``), skewness and kurtosis to the
exact rational values within a relative 1e-12, everything else exactly:
the port merges per-batch buffers where the oracle takes two passes over
each group.  A zero-variance ``corr`` is NaN and a zero-y-variance
``regr_r2`` 1.0, as the oracle's; a non-numeric input raises
``NotOnGpu`` with the reference's words."""
import math
from fractions import Fraction

import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_windows import (STATS_N, stats_data, stats_query,
                                stats_schema)

BATCHES = {"one_batch": {},
           "batches": {"spark.rapids.sql.reader.batchSizeRows": 130}}


def exact_moments(grouped):
    """skewness and kurtosis of every group from exact rationals:
    {(key, column): (skewness, kurtosis)} as doubles."""
    arr, valid = stats_data()
    scale = {"m": 100}
    out = {}
    keys = [int(k) if ok else None for k, ok in zip(arr["g"], valid["g"])]
    for c in "ildm":
        groups = {}
        for k, v, ok in zip(keys if grouped else [None] * STATS_N, arr[c],
                            valid[c]):
            if ok:
                groups.setdefault(k, []).append(
                    Fraction(v.item()) / scale.get(c, 1))
        for k, xs in groups.items():
            n = len(xs)
            mean = sum(xs) / n
            m2, m3, m4 = (sum((x - mean) ** e for x in xs) for e in (2, 3, 4))
            out[(k, c)] = (None, None) if m2 == 0 else (
                math.sqrt(n) * float(m3 / m2) / math.sqrt(float(m2)),
                float(n * m4 / (m2 * m2)) - 3.0)
    return out


def split_moments(rows, names, grouped):
    """-> (rows without the skewness and kurtosis columns, those values
    by (key, column))."""
    mom = [i for i, nm in enumerate(names) if nm[:5] in ("skew_", "kurt_")]
    rest = [tuple(v for i, v in enumerate(r) if i not in mom) for r in rows]
    vals = {((r[0] if grouped else None), names[i][5:]): {} for r in rows
            for i in mom}
    for r in rows:
        for i in mom:
            vals[((r[0] if grouped else None), names[i][5:])][
                names[i][:4]] = r[i]
    return rest, vals


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("batches", sorted(BATCHES))
def test_stats_aggregates_match_oracle(batches, grouped):
    """The oracle's rows at 12 digits, but for skewness and kurtosis: there
    the oracle's two passes lose digits to m3's cancellation near zero
    (the global decimal skewness is 3.7e-13 off the exact value there, the
    port 4.4e-14), so both are held to the exact rationals, the port within
    a relative 1e-12 and the oracle within 1e-11."""
    q = stats_query(S, T, S.TpuSession(BATCHES[batches], device="cpu"),
                    grouped)
    names = [f.name for f in q.schema.fields]
    got, got_m = split_moments(q.collect(), names, grouped)
    want, want_m = split_moments(
        stats_query(RS, RT, RS.TpuSession(ORACLE), grouped).collect(), names,
        grouped)
    assert rows_key(got, True) == rows_key(want, True)
    exact = exact_moments(grouped)
    for key, vals in got_m.items():
        skew, kurt = exact.get(key, (None, None))
        for side, tol in ((vals, 1e-12), (want_m[key], 1e-11)):
            assert (side["skew"] is None) == (skew is None), key
            assert (side["kurt"] is None) == (skew is None), key
            if skew is not None:
                assert math.isclose(side["skew"], skew, rel_tol=tol), key
                assert math.isclose(side["kurt"], kurt, rel_tol=tol), key
    got = q.collect()
    assert len(got) == (11 if grouped else 1)      # a null key too
    if grouped:
        row = {r[0]: r for r in got}
        names = [f.name for f in stats_query(S, T, S.TpuSession(
            {}, device="cpu")).schema.fields]
        const = dict(zip(names, row[5]))
        assert const["skew_i"] is None and const["kurt_d"] is None
        assert const["corr_id"] != const["corr_id"]           # NaN
        assert dict(zip(names, row[4]))["regr_r2_lm"] == 1.0
        one = dict(zip(names, row[20]))
        assert one["csamp_id"] is None and one["regr_count_di"] in (0, 1)


@pytest.mark.parametrize("grouped", [True, False])
def test_stats_aggregates_over_an_empty_input(grouped):
    got = stats_query(S, T, S.TpuSession({}, device="cpu"), grouped,
                empty=True).collect()
    want = stats_query(RS, RT, RS.TpuSession(ORACLE), grouped,
                 empty=True).collect()
    assert rows_key(got, True) == rows_key(want, True)
    if not grouped:
        names = [f.name for f in stats_query(S, T, S.TpuSession(
            {}, device="cpu"), False).schema.fields]
        assert {k: v for k, v in zip(names, got[0]) if v is not None} == {
            f"regr_count_{yx}": 0 for yx in ("di", "lm", "id")}


def test_zero_variance_results():
    """x and y constant: ``corr`` NaN, ``regr_r2`` and the slope null
    (zero x variance), ``regr_syy`` 0; y alone constant: ``regr_r2``
    1.0; a single row: ``covar_samp`` null, ``covar_pop`` 0."""
    def run(mod, types, session):
        sch = types.StructType([types.StructField("x", types.DOUBLE),
                                types.StructField("y", types.DOUBLE),
                                types.StructField("k", types.INT)])
        df = session.create_dataframe(
            {"x": [1.0, 1.0, 1.0, 2.0, 3.0, 4.0, 9.0],
             "y": [5.0, 5.0, 5.0, 7.0, 7.0, 7.0, 1.0],
             "k": [1, 1, 1, 2, 2, 2, 3]}, sch)
        return sorted(df.group_by("k").agg(
            mod.corr_("x", "y", "c"), mod.regr_r2_("y", "x", "r2"),
            mod.regr_slope_("y", "x", "sl"), mod.regr_syy_("y", "x", "syy"),
            mod.covar_samp_("x", "y", "cs"), mod.covar_pop_("x", "y", "cp"),
            mod.skewness_("x", "sk")).collect())

    got = run(S, T, S.TpuSession({}, device="cpu"))
    assert rows_key(got, True) == rows_key(
        run(RS, RT, RS.TpuSession(ORACLE)), True)
    assert str(got[0][1]) == "nan" and got[0][2] is None \
        and got[0][3] is None and got[0][4] == 0.0
    assert got[1][2] == 1.0 and got[1][3] == 0.0
    assert got[2][5] is None and got[2][6] == 0.0


def test_result_types_equal_the_reference():
    """Every result type is the reference's (its plan's aggregate line is
    held in ``test_torch_q47_windows.py``'s stats query)."""
    got = stats_query(S, T, S.TpuSession({}, device="cpu")).schema
    want = stats_query(RS, RT, RS.TpuSession(ORACLE)).schema
    assert got.simpleString == want.simpleString


def test_non_numeric_inputs_raise():
    """The reference's ``_agg_extra_checks``: a string input to a moment
    or covariance aggregate is tagged off the device; the port's CPU
    engine does not run a moment of what is not a number either, so the
    plan raises with the reference's words."""
    s = S.TpuSession({}, device="cpu")
    arr, valid = stats_data()
    df = frame(S, s, arr, stats_schema(T), valid)
    with pytest.raises(NotOnGpu, match="skewness requires a numeric input"):
        df.agg(S.skewness_("s", "k")).explain()
    with pytest.raises(NotOnGpu, match="corr requires numeric inputs"):
        df.agg(S.corr_("d", "s", "c")).explain()
    with pytest.raises(NotOnGpu, match="regr_slope requires numeric inputs"):
        df.agg(S.regr_slope_("s", "d", "c")).explain()

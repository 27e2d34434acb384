"""bench's rung3 on the port (``device="cpu"``) against the JAX package, at
4,000 rows: the aggregate over the struct projection (a CPU stage between
the device filter and the device aggregate) and the sort of a union of 8
scans, whose count and sorted rows are checked in core (bench's 8 MiB
goal) and out of core (a 64 KiB goal).  Both plans, fallback reasons
included, are the reference's ``explain`` text (child process, planned
and never collected); rows equal the reference's CPU oracle and
``chip_smoke.py``'s numpy reference.  Also: a decimal sum that overflows
in one batch stays null through the merge (the reference's device
session and CPU oracle, recorded in the child process, give -6E+37 and
6.0E+37), and rung3's sums cannot overflow."""
import sys
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.plan.nodes import LocalTableScan
from torch_port_frames import ORACLE, rows_key
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

N = 4000


@pytest.fixture(scope="module")
def data():
    return C.make_rung3(N)


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    out = run_jax(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu.config import TpuConf
        from spark_rapids_tpu.memory.spill import get_spill_framework
        conf = C.rung3_conf({N})
        get_spill_framework(TpuConf(conf))
        agg, srt = C.rung3_frames(RS, RS.TpuSession(conf), C.make_rung3({N}))
        out["agg"] = np.array(agg.explain().splitlines())
        out["sort"] = np.array(C.rung3_count_query(srt).explain()
                               .splitlines())
    """, tmp_path_factory.mktemp("rung3"))
    return {k: list(v) for k, v in out.items()}


def test_plans_match_reference(data, reference_plans):
    agg, srt = C.rung3_frames(S, S.TpuSession(C.rung3_conf(N),
                                              device="cpu"), data)
    assert agg.explain().splitlines() == reference_plans["agg"]
    assert C.plan_shape(agg) == C.RUNG3_AGG_PLAN
    count_q = C.rung3_count_query(srt)
    assert count_q.explain().splitlines() == reference_plans["sort"]
    assert C.plan_shape(count_q) == C.RUNG3_SORT_PLAN


def test_aggregate_matches_oracle_and_numpy(data):
    """Two collects, exact; the CPU stage's rows are the reference's
    oracle's projection."""
    s = S.TpuSession(C.rung3_conf(N), device="cpu")
    agg, _ = C.rung3_frames(S, s, data)
    want = C.rung3_reference(data)
    assert C.rung3_rows(agg.collect_host()) == want
    got = agg.collect()
    oracle, _ = C.rung3_frames(RS, RS.TpuSession(dict(C.rung3_conf(N),
                                                      **ORACLE)), data)
    assert rows_key(got) == rows_key(oracle.collect())
    assert C.rung3_rows(agg.collect_host()) == want      # a second run
    r2c = agg._planned().children[0]
    stage = list(zip(*[h.to_pylist() for h in r2c.run_cpu_stage()]))
    ref_stage = RS.TpuSession(ORACLE)
    ref_agg, _ = C.rung3_frames(RS, ref_stage, data)
    proj = ref_agg.plan.children[0].children[0].children[0]   # Project
    assert proj.describe() == "Project [k, amt, s.a AS sa]"
    assert rows_key(stage) == rows_key(RS.DataFrame(proj,
                                                    ref_stage).collect())


@pytest.mark.parametrize("goal", [8 << 20, 64 << 10], ids=["in_core",
                                                           "out_of_core"])
def test_sort_count_and_rows(data, goal):
    """``count`` (twice) and the sorted rows; out of core with merge
    windows of 64 rows a run, so that there are many."""
    conf = dict(C.rung3_conf(N), **{"spark.rapids.sql.batchSizeBytes":
                                    goal})
    _, srt = C.rung3_frames(S, S.TpuSession(conf, device="cpu"), data)
    count_q = C.rung3_count_query(srt)
    count_q._planned().children[0].ooc_chunk_rows = 64
    srt._planned().ooc_chunk_rows = 64
    for _ in range(2):
        snap = PC.snapshot()
        assert count_q.collect() == [(N,)]
        windows = PC.since(snap)["ooc_sort_merge_windows"]
        assert (windows > 1) == (goal < 8 << 20)
    assert C.rung3_sort_check(srt.collect_host(), data) is None
    assert srt.count() == N
    _, oracle = C.rung3_frames(RS, RS.TpuSession(dict(conf, **ORACLE)),
                               data)
    assert oracle.count() == N


def _overflow_frame(mod, types, session):
    dt = types.DecimalType(38, 0)
    hc = __import__(mod.__name__.rsplit(".", 1)[0] + ".columnar.column",
                    fromlist=["HostColumn"]).HostColumn
    nodes = __import__(mod.__name__.rsplit(".", 1)[0] + ".plan.nodes",
                       fromlist=["LocalTableScan"])
    schema = types.StructType([types.StructField("v", dt)])
    col = hc.from_pylist([Decimal("6e37"), Decimal("6e37"),
                          Decimal("-6e37")], dt)
    return mod.DataFrame(nodes.LocalTableScan([col], schema),
                         session).agg(mod.sum_("v", "s"))


def test_decimal_sum_overflow_in_one_batch_is_null(tmp_path):
    """6e37 + 6e37 overflows decimal(38,0) in the first 2-row batch: the
    port's result is Spark's null (an error under ANSI), where the
    reference's device session drops the overflowed buffer and its CPU
    oracle does not null a sum past 38 digits."""
    conf = {"spark.rapids.sql.reader.batchSizeRows": 2}
    got = _overflow_frame(S, T, S.TpuSession(conf, device="cpu")).collect()
    assert got == [(None,)]
    ansi = S.TpuSession(dict(conf, **{"spark.sql.ansi.enabled": "true"}),
                        device="cpu")
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException

    with pytest.raises(SparkArithmeticException, match="sum overflow"):
        _overflow_frame(S, T, ansi).collect()
    out = run_jax(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {REPO + '/tests/port'!r})
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as RT
        import test_torch_rung3 as R
        for label, conf in (("device", {conf!r}),
                            ("oracle", dict({conf!r},
                                            **{{"spark.rapids.sql.enabled":
                                               False}}))):
            rows = R._overflow_frame(RS, RT, RS.TpuSession(conf)).collect()
            out[label] = np.array([str(rows[0][0])])
    """, tmp_path)
    assert Decimal(str(out["device"][0])) == Decimal("-6E+37")
    assert Decimal(str(out["oracle"][0])) == Decimal("6.0E+37")


def test_rung3_sums_cannot_overflow():
    """rung3's largest sum, 28,800,991 rows of |amt| < 10^12 (unscaled),
    is below 10^35; summed in batches of 2, values at 10^23 give an exact
    decimal(35,4) result and no overflow flag."""
    assert 28_800_991 * 10 ** 12 < 10 ** 35
    dt = T.DecimalType(25, 4)
    v = 10 ** 23
    col = HostColumn(dt, np.ones(6, np.bool_), data=np.array(
        [[v >> 64, (v & (2 ** 64 - 1)) - (2 ** 64 if (v >> 63) & 1 else 0)]]
        * 6, np.int64))
    df = S.DataFrame(LocalTableScan([col], T.StructType(
        [T.StructField("amt", dt)])), S.TpuSession(
        {"spark.rapids.sql.reader.batchSizeRows": 2}, device="cpu"))
    (sums,) = df.agg(S.sum_("amt", "s")).collect_host()
    assert sums.validity.all()
    assert C._dec_ints(sums) == [6 * v]

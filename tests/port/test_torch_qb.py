"""The slice as a whole, part one: bench qb (store_sales LEFT JOIN
store_returns on (ticket, item_sk), ``ext_sales - coalesce(return_amt,
0.00)`` summed by store) on the port (``device="cpu"``) against the JAX
package: its CPU oracle session, its device session with join-aggregate
fusion off (once, in the child process: rows and plans), and
``chip_smoke.py``'s integer numpy reference.  Read from snappy Parquet
(store_sales in three files, pruned to the query's four columns;
store_returns in three) and from memory; collected twice; under each
decision of the join: shuffled (the returns over
``spark.sql.autoBroadcastJoinThreshold`` at plan time and at run time),
broadcast by the adaptive join at run time (over the threshold on disk,
within it once built), and broadcast as planned (the default threshold).
Every comparison is exact."""
import os
import re
import sys

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame, rows_key, write_parquet_files
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

N_SALES = 24_000
N_FILES = 3
BASE = {"spark.rapids.sql.format.parquet.decode.device": True,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE"}
DECISIONS = {"shuffled": dict(BASE, **{
                 "spark.sql.autoBroadcastJoinThreshold": "8k"}),
             "broadcast": dict(BASE)}


@pytest.fixture(scope="module")
def qb_files(tmp_path_factory):
    pytest.importorskip("pyarrow")
    tmp = tmp_path_factory.mktemp("qb")
    ss = C.make_store_sales(N_SALES)
    sr = C.make_store_returns(ss, N_SALES // 10)
    table, _, _ = C.qa_schemas(T)
    _, rsch = C.qb_schemas(T)
    ss_paths = write_parquet_files(tmp, "store_sales", ss, table, N_FILES)
    sr_paths = write_parquet_files(tmp, "store_returns", sr, rsch, N_FILES)
    return ss, sr, ss_paths, sr_paths


def parquet_qb(mod, types, session, ss_paths, sr_paths):
    ssch, rsch = C.qb_schemas(types)
    return C.qb_query(session.read.schema(ssch).parquet(*ss_paths),
                      session.read.schema(rsch).parquet(*sr_paths), mod)


@pytest.mark.parametrize("decision", sorted(DECISIONS))
def test_qb_parquet_matches_oracle_and_numpy(qb_files, decision):
    ss, sr, ss_paths, sr_paths = qb_files
    conf = DECISIONS[decision]
    df = parquet_qb(S, T, S.TpuSession(conf, device="cpu"), ss_paths,
                    sr_paths)
    got = df.collect()
    want = C.qb_reference(ss, sr)
    assert len(want) == C.N_STORES
    assert sorted(got) == want
    oracle = parquet_qb(RS, RT, RS.TpuSession(dict(conf, **ORACLE)),
                        ss_paths, sr_paths)
    assert rows_key(got) == rows_key(oracle.collect())
    assert sorted(df.collect()) == want               # a second run agrees
    lines = df.explain().splitlines()
    if decision == "shuffled":
        shape = C.plan_shape(df)
        assert shape[0] == C.QB_PLAN[0]
        assert shape[1] == C.QB_PLAN[1].replace("10485760", "8192")
        assert shape[2:] == C.QB_PLAN[2:]
    else:
        assert lines[1] == ("  TpuBroadcastHashJoinExec LeftOuter "
                            "[ticket=ticket, item_sk=item_sk]")
    assert df.schema.fields[1].dataType == T.DecimalType(18, 2)


def test_qb_adaptive_broadcast_decision(tmp_path):
    """Few returns in three files: their size on disk is over the
    threshold, so the plan is the shuffled join, and their built bytes are
    within it, so the adaptive join broadcasts."""
    pytest.importorskip("pyarrow")
    ss = C.make_store_sales(N_SALES)
    sr = C.make_store_returns(ss, 60)
    _, rsch = C.qb_schemas(T)
    ss_paths = write_parquet_files(tmp_path, "store_sales", ss,
                                   C.qa_schemas(T)[0], N_FILES)
    sr_paths = write_parquet_files(tmp_path, "store_returns", sr, rsch,
                                   N_FILES)
    built = 60 * (9 + 5 + 9)          # validity and data of each column
    threshold = 2048
    assert built <= threshold < sum(os.path.getsize(p) for p in sr_paths)
    conf = dict(BASE, **{"spark.sql.autoBroadcastJoinThreshold":
                         str(threshold)})
    df = parquet_qb(S, T, S.TpuSession(conf, device="cpu"), ss_paths,
                    sr_paths)
    want = C.qb_reference(ss, sr)
    assert sorted(df.collect()) == want
    assert sorted(df.collect()) == want
    assert f"decided=broadcast({built}B)" in df.explain().splitlines()[1]
    oracle = parquet_qb(RS, RT, RS.TpuSession(dict(conf, **ORACLE)),
                        ss_paths, sr_paths)
    assert rows_key(df.collect()) == rows_key(oracle.collect())


@pytest.mark.parametrize("decision", sorted(DECISIONS))
def test_qb_in_memory_matches_numpy(qb_files, decision):
    ss, sr, _, _ = qb_files
    conf = {"spark.rapids.sql.reader.batchSizeRows": 5000}
    if decision == "shuffled":
        conf["spark.sql.autoBroadcastJoinThreshold"] = "8k"
    s = S.TpuSession(conf, device="cpu")
    table, _, _ = C.qa_schemas(T)
    _, rsch = C.qb_schemas(T)
    df = C.qb_query(frame(S, s, ss, table), frame(S, s, sr, rsch), S)
    want = C.qb_reference(ss, sr)
    assert sorted(df.collect()) == want
    assert sorted(df.collect()) == want
    assert (f"decided={decision}(" in df.explain()) == (
        decision == "shuffled")


def test_qb_host_syncs_per_file(qb_files):
    """One sync per probe batch (the pair total and the unmatched count
    together), one per partial aggregate (its group count), one for the
    single merge of the partial buffers and one for the collect."""
    ss, sr, ss_paths, sr_paths = qb_files
    df = parquet_qb(S, T, S.TpuSession(DECISIONS["shuffled"], device="cpu"),
                    ss_paths, sr_paths)
    snap = PC.snapshot()
    assert sorted(df.collect()) == C.qb_reference(ss, sr)
    assert PC.since(snap)["host_syncs"] == 2 * len(ss_paths) + 2


def test_qb_matches_reference_device_session(qb_files, tmp_path):
    ss, sr, ss_paths, sr_paths = qb_files
    out = run_jax(f"""
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        for label, conf in {DECISIONS!r}.items():
            s = RS.TpuSession(dict(conf, **{{
                "spark.rapids.tpu.joinAggFusion.enabled": False}}))
            ssch, rsch = C.qb_schemas(T)
            df = C.qb_query(s.read.schema(ssch).parquet(*{ss_paths!r}),
                            s.read.schema(rsch).parquet(*{sr_paths!r}), RS)
            rows = sorted(df.collect())
            out[label + "_rows"] = np.array([f"{{k}}|{{v}}"
                                             for k, v in rows])
            out[label + "_plan"] = np.array(df.explain().splitlines())
    """, tmp_path)
    for label, conf in DECISIONS.items():
        df = parquet_qb(S, T, S.TpuSession(conf, device="cpu"), ss_paths,
                        sr_paths)
        got = sorted(df.collect())
        assert [f"{k}|{v}" for k, v in got] == list(out[label + "_rows"])
        # after a Parquet collect the reference's explain shows the
        # adaptive join's decision or not, as its collect ran the planned
        # tree or another copy of it; where it shows one, it must be ours
        mine = df.explain().splitlines()
        ref = list(out[label + "_plan"])
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            if "decided=" not in b:
                a = re.sub(r" decided=\w+\(\d+B\)$", "", a)
            if not a.lstrip().startswith("TpuFileSourceScan"):
                assert a == b


def test_qb_qc_references_are_bench_copies():
    """``chip_smoke.py`` keeps its own copies of bench.py's store_returns
    generator and of its qb and qc references (in int64); the copies
    must agree with bench.py's."""
    import bench

    ss = C.make_store_sales(5000)
    sr = C.make_store_returns(ss, 500)
    for k, v in bench.make_store_returns(ss, 500).items():
        np.testing.assert_array_equal(sr[k], v)
    assert {k: int(v.scaleb(2)) for k, v in C.qb_reference(ss, sr)} == \
        bench.cpu_qb_vectorized(ss, sr)
    assert C.qc_reference(ss) == bench.cpu_qc_vectorized(ss)

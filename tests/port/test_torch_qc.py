"""The slice as a whole, part two: bench qc (a sum grouped by store and
date, ``rank()`` over each store's days by the sum, descending, and the
filter rank <= 5) on the port (``device="cpu"``) against the JAX package:
its CPU oracle session, its device session with window-chain and
join-aggregate fusion off (once, in the child process: rows and plan),
and ``chip_smoke.py``'s integer numpy reference.  Read from snappy Parquet
(store_sales in three files, pruned to the query's three columns) and from
memory, collected twice.  Every comparison is exact."""
import sys

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
CONF = {"spark.rapids.sql.format.parquet.decode.device": True,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE"}


@pytest.fixture(scope="module")
def qc_files(tmp_path_factory):
    pytest.importorskip("pyarrow")
    tmp = tmp_path_factory.mktemp("qc")
    ss = C.make_store_sales(N_SALES)
    table, _, _ = C.qa_schemas(T)
    return ss, write_parquet_files(tmp, "store_sales", ss, table, N_FILES)


def parquet_qc(mod, types, session, paths):
    _, rsch, _ = C.qa_schemas(types)
    return C.qc_query(session.read.schema(rsch).parquet(*paths), mod)


def test_qc_parquet_matches_oracle_and_numpy(qc_files):
    ss, paths = qc_files
    df = parquet_qc(S, T, S.TpuSession(CONF, device="cpu"), paths)
    got = df.collect()
    want = C.qc_reference(ss)
    assert len(want) >= 5 * C.N_STORES
    assert C.qc_rows(got) == want
    oracle = parquet_qc(RS, RT, RS.TpuSession(dict(CONF, **ORACLE)), paths)
    assert rows_key(got) == rows_key(oracle.collect())
    assert C.qc_rows(df.collect()) == want            # a second run agrees
    assert C.plan_shape(df) == C.QC_PLAN
    assert [f.dataType.simpleString for f in df.schema.fields] == [
        "int", "int", "decimal(17,2)", "int"]


def test_qc_in_memory_matches_numpy(qc_files):
    ss, _ = qc_files
    s = S.TpuSession({"spark.rapids.sql.reader.batchSizeRows": 5000},
                     device="cpu")
    table, _, _ = C.qa_schemas(T)
    df = C.qc_query(frame(S, s, ss, table), S)
    want = C.qc_reference(ss)
    assert C.qc_rows(df.collect()) == want
    assert C.qc_rows(df.collect()) == want
    assert C.plan_shape(df) == C.QC_PLAN


def test_qc_host_syncs_per_file(qc_files):
    """One sync per partial aggregate (its group count), one for the
    single merge of the partial buffers, one for the filter's compaction
    and one for the collect; the window syncs none."""
    ss, paths = qc_files
    df = parquet_qc(S, T, S.TpuSession(CONF, device="cpu"), paths)
    snap = PC.snapshot()
    assert C.qc_rows(df.collect()) == C.qc_reference(ss)
    assert PC.since(snap)["host_syncs"] == len(paths) + 3


def test_qc_matches_reference_device_session(qc_files, tmp_path):
    ss, paths = qc_files
    out = run_jax(f"""
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        s = RS.TpuSession(dict({CONF!r}, **{{
            "spark.rapids.tpu.windowChainFusion.enabled": False,
            "spark.rapids.tpu.joinAggFusion.enabled": False}}))
        _, rsch, _ = C.qa_schemas(T)
        df = C.qc_query(s.read.schema(rsch).parquet(*{paths!r}), RS)
        out["rows"] = np.array(sorted(f"{{a}}|{{b}}|{{c}}|{{d}}"
                                      for a, b, c, d in df.collect()))
        out["plan"] = np.array(df.explain().splitlines())
    """, tmp_path)
    df = parquet_qc(S, T, S.TpuSession(CONF, device="cpu"), paths)
    got = sorted(f"{a}|{b}|{c}|{d}" for a, b, c, d in df.collect())
    assert got == list(out["rows"])
    mine = df.explain().splitlines()
    ref = list(out["plan"])
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if not a.lstrip().startswith("TpuFileSourceScan"):
            assert a == b

"""The slice as a whole: bench qa (a broadcast join of store_sales with the
quarter-1 rows of date_dim, a sum grouped by year and store, TPC-DS q3's
ORDER BY d_year, sum DESC, store_sk and LIMIT 100) on the port
(``device="cpu"``) against the JAX package: its CPU oracle session, its
device session with join-aggregate fusion off (once, in the child
process: result and plan), and ``chip_smoke.py``'s integer numpy
reference.  Read from snappy Parquet (three store_sales files, pruned to
the query's three columns) and from memory; collected twice; and with
every date filtered out.  Every comparison is exact."""
import sys
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

N_SALES = 24_000
CONF = {"spark.rapids.sql.format.parquet.decode.device": True,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE"}


def write_tables(tmp_path, ss, dd, nfiles=3):
    """store_sales (its seven columns, DECIMAL(7,2) money) in ``nfiles``
    snappy files and date_dim in one, written by pyarrow."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    msch, _, _ = C.qa_schemas(T)
    bounds = np.linspace(0, len(ss["date_sk"]), nfiles + 1).astype(int)
    paths = []
    for i in range(nfiles):
        cols = {}
        for f in msch.fields:
            v = ss[f.name][bounds[i]:bounds[i + 1]]
            cols[f.name] = (pa.array(v) if not isinstance(f.dataType,
                                                          T.DecimalType)
                            else pa.array([Decimal(int(x)).scaleb(-2)
                                           for x in v], pa.decimal128(7, 2)))
        path = str(tmp_path / f"store_sales-{i}.parquet")
        pq.write_table(pa.table(cols), path, compression="snappy",
                       store_decimal_as_integer=True)
        paths.append(path)
    dd_path = str(tmp_path / "date_dim.parquet")
    pq.write_table(pa.table({k: pa.array(v) for k, v in dd.items()}),
                   dd_path, compression="snappy")
    return paths, dd_path


def parquet_qa(mod, types, session, paths, dd_path):
    _, rsch, dsch = C.qa_schemas(types)
    return C.qa_query(session.read.schema(rsch).parquet(*paths),
                      session.read.schema(dsch).parquet(dd_path), mod)


@pytest.fixture(scope="module")
def qa_files(tmp_path_factory):
    pytest.importorskip("pyarrow")
    tmp = tmp_path_factory.mktemp("qa")
    ss, dd = C.make_store_sales(N_SALES), C.make_date_dim()
    paths, dd_path = write_tables(tmp, ss, dd)
    return ss, dd, paths, dd_path


def test_qa_parquet_matches_oracle_and_numpy(qa_files):
    ss, dd, paths, dd_path = qa_files
    df = parquet_qa(S, T, S.TpuSession(CONF, device="cpu"), paths, dd_path)
    got = df.collect()
    want = C.qa_reference(ss, dd)
    assert len(want) == C.QA_LIMIT
    assert got == want
    oracle = parquet_qa(RS, RT, RS.TpuSession(ORACLE), paths, dd_path)
    assert rows_key(got, ordered=True) == rows_key(oracle.collect(),
                                                   ordered=True)
    assert df.collect() == got                 # a second run agrees
    C.check_qa_plan(df)
    assert df.schema.fields[2].dataType == T.DecimalType(17, 2)


def test_qa_host_syncs_per_file(qa_files):
    """One sync per probe batch (the join's size) and one per partial
    aggregate (its group count), one for the single merge of the partial
    buffers, one for the date_dim filter's compaction and one for the
    collect."""
    ss, dd, paths, dd_path = qa_files
    df = parquet_qa(S, T, S.TpuSession(CONF, device="cpu"), paths, dd_path)
    snap = PC.snapshot()
    assert df.collect() == C.qa_reference(ss, dd)
    assert PC.since(snap)["host_syncs"] == 2 * len(paths) + 3


def test_qa_in_memory_matches_numpy(qa_files):
    ss, dd, _, _ = qa_files
    s = S.TpuSession({"spark.rapids.sql.reader.batchSizeRows": 5000},
                     device="cpu")
    msch, _, dsch = C.qa_schemas(T)
    df = C.qa_query(frame(S, s, ss, msch), frame(S, s, dd, dsch), S)
    C.check_qa_plan(df)
    assert df.collect() == C.qa_reference(ss, dd)


def test_qa_with_every_date_filtered_out(qa_files):
    ss, dd, paths, _ = qa_files
    no_q1 = dict(dd, d_qoy=np.full_like(dd["d_qoy"], 2))
    s = S.TpuSession({}, device="cpu")
    msch, _, dsch = C.qa_schemas(T)
    got = C.qa_query(frame(S, s, ss, msch), frame(S, s, no_q1, dsch),
                     S).collect()
    r = RS.TpuSession(ORACLE)
    rmsch, _, rdsch = C.qa_schemas(RT)
    want = C.qa_query(frame(RS, r, ss, rmsch), frame(RS, r, no_q1, rdsch),
                      RS).collect()
    assert got == want == C.qa_reference(ss, no_q1) == []


def test_qa_matches_reference_device_session(qa_files, tmp_path):
    ss, dd, paths, dd_path = qa_files
    out = run_jax(f"""
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        s = RS.TpuSession(dict({CONF!r}, **{{
            "spark.rapids.tpu.joinAggFusion.enabled": False}}))
        _, rsch, dsch = C.qa_schemas(T)
        df = C.qa_query(s.read.schema(rsch).parquet(*{paths!r}),
                        s.read.schema(dsch).parquet({dd_path!r}), RS)
        out["rows"] = np.array([f"{{y}}|{{k}}|{{v}}"
                                for y, k, v in df.collect()])
        out["plan"] = np.array(df.explain().splitlines())
    """, tmp_path)
    got = parquet_qa(S, T, S.TpuSession(CONF, device="cpu"), paths,
                     dd_path)
    assert [f"{y}|{k}|{v}" for y, k, v in got.collect()] == list(out["rows"])
    mine = got.explain().splitlines()
    ref = list(out["plan"])
    scan = ("TpuFileSourceScan",)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        if not a.lstrip().startswith(scan):
            assert a == b


def test_generators_are_bench_copies():
    """``chip_smoke.py`` keeps its own copy of bench.py's generators, as
    the port copies what it needs; the copies must draw the same
    tables."""
    import bench

    for k, v in bench.make_store_sales(5000).items():
        np.testing.assert_array_equal(C.make_store_sales(5000)[k], v)
    for k, v in bench.make_date_dim().items():
        np.testing.assert_array_equal(C.make_date_dim()[k], v)

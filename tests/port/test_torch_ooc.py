"""The out-of-core path as a whole, on the port (``device="cpu"``) against
the JAX package: partition sizing (``exec/partition_sizing.py``) grows an
exchange past the pool and leaves a small one alone, as in
``tests/test_out_of_core.py``; bench's rung3_ooc query at 200,000 fact rows
under a 512 KiB pool, through the sized hash exchange, the spill-backed
queues, host blocks and spills; the sub-partitioned join, inner and left
outer, broadcast and shuffled, from memory; and bench qb from Parquet
under a capped pool.  Rows are held against the reference's CPU oracle
session and ``chip_smoke.py``'s numpy references, plans against the
reference's ``explain`` on one CPU device (child process, planned and
never collected).  Every comparison is exact."""
import sys
import textwrap

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.memory.spill import peek_spill_framework
from torch_port_frames import ORACLE, frame, rows_key, write_parquet_files
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

POOL = 512 << 10
N_OOC = 200_000


def reference_plans(tmp_path, code, confs, inputs=None):
    """The reference's explain lines for each conf in ``confs`` (label ->
    conf) of the DataFrame ``code`` builds as ``df`` from session ``s``,
    with the device manager built from that conf first, as bench does."""
    out = run_jax(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.config import TpuConf
        from spark_rapids_tpu.memory.device_manager import get_device_manager
        for label, conf in {confs!r}.items():
            get_device_manager(TpuConf(conf))
            s = RS.TpuSession(conf)
{_indent(code, 12)}
            out[label] = np.array(df.explain().splitlines())
    """, tmp_path, inputs)
    return {k: list(v) for k, v in out.items()}


def _indent(code, n):
    return textwrap.indent(textwrap.dedent(code).strip(), " " * n)


def _repartitioned(mod, s, n):
    rng = np.random.default_rng(1)
    fact = {"k": rng.integers(0, 1000, n).astype(np.int32),
            "v": rng.integers(-100, 100, n), "pad": rng.integers(0, 9, n)}
    df, _ = C.ooc_frames(mod, s, fact, {"k": fact["k"][:1],
                                         "g": fact["k"][:1]})
    return df.repartition(2, "k")


def test_partition_sizing_grows_counts_and_leaves_small_inputs_alone(
        tmp_path):
    """120,000 rows under the 512 KiB pool grow a 2-partition exchange (to
    the 16 of ``exchange.maxPartitions``, ``tests/test_out_of_core.py:67``);
    100 rows keep the plan, which one device collapses to one partition
    (``:102``).  Both plans are the reference's."""
    confs = {"big": {"spark.rapids.tpu.test.deviceMemoryBytes": POOL,
                     "spark.rapids.tpu.exchange.maxPartitions": 16},
             "small": {}}
    sizes = {"big": 120_000, "small": 100}
    want = reference_plans(tmp_path, """
        df = None
        import numpy as _np
        rng = _np.random.default_rng(1)
        n = {"big": 120_000, "small": 100}[label]
        fact = {"k": rng.integers(0, 1000, n).astype(_np.int32),
                "v": rng.integers(-100, 100, n),
                "pad": rng.integers(0, 9, n)}
        df, _ = C.ooc_frames(RS, s, fact, {"k": fact["k"][:1],
                                           "g": fact["k"][:1]})
        df = df.repartition(2, "k")
    """, confs)
    for label, conf in confs.items():
        snap = PC.snapshot()
        df = _repartitioned(S, S.TpuSession(conf, device="cpu"),
                            sizes[label])
        lines = df.explain().splitlines()
        assert lines == want[label]
        planned = PC.since(snap)["exchange_partitions_planned"]
        if label == "big":
            assert lines[0] == ("TpuShuffleExchange hashpartitioning(k, 16) "
                                "[sized 2->16 partitions (est 2760000B)]")
            assert planned == 1
        else:
            assert lines[0] == "TpuShuffleExchange SinglePartition"
            assert planned == 0
        # the CPU plan keeps the count it was planned with
        assert df.plan.partitioning.num_partitions == 2


@pytest.fixture(scope="module")
def ooc_data():
    return C.make_ooc(N_OOC)


def test_rung3_ooc_matches_oracle_and_reference_plan(tmp_path, ooc_data):
    """bench's rung3_ooc query: the fact exchange sized 16->71 partitions
    (4,600,000 estimated bytes over 64 KiB partitions), its slices past
    the 128 KiB queue budget framed to the host, batches spilled from the
    pool; rows equal to ``cpu_ooc`` and to the oracle on two collects."""
    fact, dim = ooc_data
    conf = C.ooc_conf(POOL, N_OOC)
    df = C.ooc_query(*C.ooc_frames(S, S.TpuSession(conf, device="cpu"),
                                   fact, dim), S)
    want_plan = reference_plans(tmp_path, """
        df = C.ooc_query(*C.ooc_frames(RS, s, C.make_ooc(200_000)[0],
                                       C.make_ooc(200_000)[1]), RS)
    """, {"ooc": conf})["ooc"]
    lines = df.explain().splitlines()
    assert lines == want_plan
    assert C.plan_shape(df) == C.ooc_plan(POOL, N_OOC)
    assert "hashpartitioning(k, 71) [sized 16->71 partitions (est " \
        "4600000B)]" in lines[3]
    want = C.ooc_reference(fact, dim)
    snap = PC.snapshot()
    got = df.collect()
    d = PC.since(snap)
    assert C.ooc_rows(got) == want
    assert d["exchange_host_blocks"] > 0 and d["exchange_spill_ns"] > 0
    fw = peek_spill_framework()
    assert fw.pool_bytes == POOL and fw.spill_to_host_count > 0
    oracle = C.ooc_query(*C.ooc_frames(
        RS, RS.TpuSession(dict(conf, **ORACLE)), fact, dim), RS)
    assert rows_key(got) == rows_key(oracle.collect())
    assert C.ooc_rows(df.collect()) == want            # a second run agrees


def _join_tables(seed, n_probe=3000, n_build=600):
    rng = np.random.default_rng(seed)
    probe = {"k": rng.integers(0, 400, n_probe).astype(np.int32),
             "v": rng.integers(-1000, 1000, n_probe)}
    build = {"k": rng.integers(0, 500, n_build).astype(np.int32),
             "w": rng.integers(0, 10 ** 6, n_build)}
    pvalid = {"k": rng.random(n_probe) > 0.05}
    bvalid = {"k": rng.random(n_build) > 0.05}
    return probe, pvalid, build, bvalid


def _joined(mod, types, session, how):
    probe, pvalid, build, bvalid = _join_tables(21)
    psch = types.StructType([types.StructField("k", types.INT),
                             types.StructField("v", types.LONG)])
    bsch = types.StructType([types.StructField("k", types.INT),
                             types.StructField("w", types.LONG)])
    left = frame(mod, session, probe, psch, pvalid)
    right = frame(mod, session, build, bsch, bvalid)
    return left.join(right, on="k", how=how)


SUB_CONFS = {
    "broadcast": {"spark.rapids.sql.batchSizeBytes": "4k",
                  "spark.rapids.sql.reader.batchSizeRows": 700},
    "shuffled": {"spark.rapids.sql.batchSizeBytes": "4k",
                 "spark.rapids.sql.reader.batchSizeRows": 700,
                 "spark.sql.autoBroadcastJoinThreshold": "-1",
                 "spark.sql.adaptive.enabled": False}}


@pytest.mark.parametrize("strategy", sorted(SUB_CONFS))
@pytest.mark.parametrize("how", ["inner", "left"])
def test_sub_partitioned_join_matches_oracle(tmp_path, strategy, how):
    """A build side of 8,400 bytes over a 4 KiB batch goal: both sides
    hash into 4 buckets (null keys included) and join bucket by bucket;
    rows equal the oracle's on two collects, and the plan is the
    reference's."""
    conf = SUB_CONFS[strategy]
    df = _joined(S, T, S.TpuSession(conf, device="cpu"), how)
    want = rows_key(_joined(RS, RT, RS.TpuSession(dict(conf, **ORACLE)),
                            how).collect())
    got = df.collect()
    assert rows_key(got) == want
    assert rows_key(df.collect()) == want
    root = df._planned()
    assert root.sub_partitions == 4
    probe, pvalid, build, bvalid = _join_tables(21)
    inputs = {"p_k": probe["k"], "p_v": probe["v"], "p_k_valid": pvalid["k"],
              "b_k": build["k"], "b_w": build["w"], "b_k_valid": bvalid["k"]}
    plan = reference_plans(tmp_path, f"""
        from spark_rapids_tpu.columnar.column import HostColumn
        from spark_rapids_tpu.plan.nodes import LocalTableScan

        def fr(names, types, p):
            host = [HostColumn.from_numpy(inp[p + nm], t,
                                          inp.get(p + nm + "_valid"))
                    for nm, t in zip(names, types)]
            return RS.DataFrame(LocalTableScan(host, T.StructType(
                [T.StructField(nm, t) for nm, t in zip(names, types)])), s)

        df = fr(["k", "v"], [T.INT, T.LONG], "p_").join(
            fr(["k", "w"], [T.INT, T.LONG], "b_"), on="k", how={how!r})
    """, {strategy: conf}, inputs)[strategy]
    assert df.explain().splitlines() == plan


def test_qb_out_of_core_from_parquet(tmp_path):
    """bench qb from snappy Parquet under a capped pool: the store_returns
    side (2,400 rows, 55,200 bytes built) is over the 16 KiB batch goal,
    so the left outer join sub-partitions both sides into 4 buckets; rows
    equal ``qb_reference`` and the oracle's, and the plan is the
    reference's (scans aside)."""
    pytest.importorskip("pyarrow")
    ss = C.make_store_sales(24_000)
    sr = C.make_store_returns(ss, 2_400)
    table, _, _ = C.qa_schemas(T)
    ssch, rsch = C.qb_schemas(T)
    ss_paths = write_parquet_files(tmp_path, "ss", ss, table, 3)
    sr_paths = write_parquet_files(tmp_path, "sr", sr, rsch, 3)
    conf = dict(C.ooc_qb_conf(128 << 10),
                **{"spark.rapids.sql.batchSizeBytes": "16k"})
    s = S.TpuSession(conf, device="cpu")
    df = C.qb_query(s.read.schema(ssch).parquet(*ss_paths),
                    s.read.schema(rsch).parquet(*sr_paths), S)
    want = C.qb_reference(ss, sr)
    assert sorted(df.collect()) == want
    assert df._planned().children[0].sub_partitions == 4
    assert sorted(df.collect()) == want
    rs = RS.TpuSession(dict(conf, **ORACLE))
    r_ssch, r_rsch = C.qb_schemas(RT)
    oracle = C.qb_query(rs.read.schema(r_ssch).parquet(*ss_paths),
                        rs.read.schema(r_rsch).parquet(*sr_paths), RS)
    assert rows_key(df.collect()) == rows_key(oracle.collect())
    plan = reference_plans(tmp_path, f"""
        ssch, rsch = C.qb_schemas(T)
        df = C.qb_query(s.read.schema(ssch).parquet(*{ss_paths!r}),
                        s.read.schema(rsch).parquet(*{sr_paths!r}), RS)
    """, {"qb": conf})["qb"]
    shape = C.plan_shape(df)
    assert shape == [ln if not ln.lstrip().startswith("TpuFileSourceScan")
                     else ln[:len(ln) - len(ln.lstrip())] + "<scan>"
                     for ln in plan]
    assert shape == C.ooc_qb_plan(16 << 10)

"""The equi-joins (``exec/join.py``) against the JAX package:
``_slots_to_probe_rows`` and the build-side search against the reference's
(child process); whole inner and left outer joins against the reference's
CPU oracle session, broadcast and shuffled, with null keys on both sides,
duplicate build keys, a two-column key, several probe batches, an empty
build side and an empty probe side, each collected twice; the adaptive
join's two run-time decisions and plans against the reference's device
session (child process); the adaptive shuffle reader's coalescing.
Every comparison is exact.  Every join type runs, a join on a condition
as a nested-loop join; a build side over the batch size sub-partitions."""
import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import join as J
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax


def test_slots_to_probe_rows_matches_reference(tmp_path):
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 4, 300)
    counts[:3] = 0                          # leading unmatched rows
    excl = np.cumsum(counts) - counts
    out_cap = int(counts.sum()) + 9         # slots past the pairs too
    out = run_jax(f"""
        import jax.numpy as jnp
        from spark_rapids_tpu.exec.join import _slots_to_probe_rows
        out["rows"] = np.asarray(_slots_to_probe_rows(
            jnp.asarray(inp["excl"]), jnp.asarray(inp["counts"]), {out_cap}))
    """, tmp_path, {"excl": excl, "counts": counts})
    got = J._slots_to_probe_rows(torch.from_numpy(excl),
                                 torch.from_numpy(counts), out_cap)
    np.testing.assert_array_equal(got.numpy(), out["rows"])


@pytest.mark.parametrize("nwords", [1, 2, 3])
def test_build_search_matches_reference(tmp_path, nwords):
    """The equal-key runs of one key word (``torch.searchsorted``) and of
    several (``_rank_search``), against the reference's
    ``_multiword_searchsorted`` left and right; the build tail past
    ``n_valid`` holds the largest word, as ``_prepare_build`` leaves it,
    and a query may hold it too."""
    rng = np.random.default_rng(6 + nwords)
    n, n_valid, nq = 200, 170, 500
    keys = np.stack([rng.integers(-5, 5, n_valid) for _ in range(nwords)])
    keys = keys[:, np.lexsort(keys[::-1])]
    words = np.full((nwords, n), np.iinfo(np.int64).max)
    words[:, :n_valid] = keys
    queries = np.stack([rng.integers(-6, 6, nq) for _ in range(nwords)])
    queries[:, :3] = np.iinfo(np.int64).max
    queries[-1, 3] = np.iinfo(np.int64).max
    out = run_jax(f"""
        import jax.numpy as jnp
        from spark_rapids_tpu.exec.join import _multiword_searchsorted
        w = [jnp.asarray(x) for x in inp["words"]]
        q = [jnp.asarray(x) for x in inp["queries"]]
        for side in ("left", "right"):
            out[side] = np.asarray(_multiword_searchsorted(
                w, jnp.int32({n_valid}), q, side))
    """, tmp_path, {"words": words, "queries": queries})
    w = [torch.from_numpy(x) for x in words]
    q = [torch.from_numpy(x) for x in queries]
    nv = torch.tensor(n_valid)
    lo, hi = J._equal_range(w, J._run_ends(w, nv), nv, q)
    np.testing.assert_array_equal(lo.numpy(), out["left"])
    np.testing.assert_array_equal(hi.numpy(), out["right"])


def tables(seed, n_probe=900, n_build=60):
    """A probe table and a build table whose keys repeat (duplicate build
    keys expand rows) and are null in places on both sides."""
    rng = np.random.default_rng(seed)
    probe = {"k": rng.integers(0, 40, n_probe).astype(np.int32),
             "k2": rng.integers(0, 3, n_probe),
             "v": rng.integers(-1000, 1000, n_probe)}
    build = {"k": rng.integers(0, 50, n_build).astype(np.int32),
             "k2": rng.integers(0, 3, n_build),
             "w": rng.integers(0, 10 ** 6, n_build)}
    pvalid = {"k": rng.random(n_probe) > 0.1, "k2": rng.random(n_probe) > 0.1}
    bvalid = {"k": rng.random(n_build) > 0.1, "k2": rng.random(n_build) > 0.1}
    return probe, pvalid, build, bvalid


def schemas(mod):
    p = mod.StructType([mod.StructField("k", mod.INT),
                        mod.StructField("k2", mod.LONG),
                        mod.StructField("v", mod.DecimalType(9, 2))])
    b = mod.StructType([mod.StructField("k", mod.INT),
                        mod.StructField("k2", mod.LONG),
                        mod.StructField("w", mod.LONG)])
    return p, b


def joined(mod, types, session, case, seed, how="inner"):
    probe, pvalid, build, bvalid = tables(seed)
    if case == "empty_probe":
        probe = {k: v[:0] for k, v in probe.items()}
        pvalid = {k: v[:0] for k, v in pvalid.items()}
    psch, bsch = schemas(types)
    left = frame(mod, session, probe, psch, pvalid)
    right = frame(mod, session, build, bsch, bvalid)
    on = ["k", "k2"] if case == "two_keys" else "k"
    if case == "empty_build":
        right = right.filter(mod.col("w") < mod.lit(0))
    return left.join(right, on=on, how=how)


CASES = ["one_key", "two_keys", "empty_build", "empty_probe"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("batch_rows", [None, 250])
def test_inner_join_matches_oracle(case, batch_rows):
    conf = ({} if batch_rows is None
            else {"spark.rapids.sql.reader.batchSizeRows": batch_rows})
    df = joined(S, T, S.TpuSession(conf, device="cpu"), case, 7)
    want = joined(RS, RT, RS.TpuSession(ORACLE), case, 7).collect()
    got = df.collect()
    assert rows_key(got) == rows_key(want)
    assert (len(got) == 0) == (case in ("empty_build", "empty_probe"))
    assert rows_key(df.collect()) == rows_key(got)     # a second run agrees
    lines = df.explain().splitlines()
    assert lines[0].startswith("TpuBroadcastHashJoinExec Inner [k=k")
    assert lines[2] == "  TpuBroadcastExchangeExec"


@pytest.mark.parametrize("how", ["right_outer", "right", "full", "semi",
                                 "anti", "cross"])
def test_unported_join_types_raise(how):
    """No join type is left unported: the right and full outer, semi and
    anti joins and the cross join (its keys dropped, every pair, as the
    reference plans it) equal the oracle (``test_torch_join_types.py``
    and ``test_torch_nested_loop_join.py`` hold them on every path)."""
    df = joined(S, T, S.TpuSession({}, device="cpu"), "one_key", 8)
    left, right = df.plan.children[0], df.plan.children[1].children[0]
    df2 = S.DataFrame(left, df.session).join(
        S.DataFrame(right, df.session), on="k", how=how)
    want = joined(RS, RT, RS.TpuSession(ORACLE), "one_key", 8, how)
    assert rows_key(df2.collect()) == rows_key(want.collect())
    if how == "cross":
        assert df2.explain().startswith("TpuCartesianProductExec")


def test_shuffled_and_oversized_joins_raise():
    """A build side over ``spark.rapids.sql.batchSizeBytes`` takes the
    sub-partitioned join, broadcast or shuffled: both sides hash into
    buckets at run time (2 here), with rows equal to the oracle's; a join
    on a condition no longer raises: it is a nested-loop join, equal to
    the oracle."""
    conf = {"spark.rapids.sql.batchSizeBytes": "1k"}
    want = rows_key(joined(RS, RT, RS.TpuSession(ORACLE), "one_key",
                           9).collect())
    df = joined(S, T, S.TpuSession(conf, device="cpu"), "one_key", 9)
    assert df.explain().startswith("TpuBroadcastHashJoinExec Inner [k=k]")
    assert rows_key(df.collect()) == want
    assert df._planned().sub_partitions == 2
    conf["spark.sql.autoBroadcastJoinThreshold"] = "-1"
    df = joined(S, T, S.TpuSession(conf, device="cpu"), "one_key", 9)
    assert "TpuAdaptiveJoin(threshold=-1)" in df.explain()
    assert rows_key(df.collect()) == want
    assert df._planned().shuffled.sub_partitions == 2
    def on_condition(mod, types, s):
        df = joined(mod, types, s, "one_key", 9)
        col, lit = mod.col, mod.lit
        left = df.select(col("v").alias("lv")).filter(col("lv") < lit(-8))
        right = df.select(col("w").alias("rw")).filter(
            col("rw") < lit(100_000))
        return left.join(right, on=col("lv") * lit(10_000) + col("rw")
                         > lit(0))

    df = on_condition(S, T, S.TpuSession({}, device="cpu"))
    assert df.explain().startswith("TpuBroadcastNestedLoopJoin Inner")
    assert rows_key(df.collect()) == rows_key(on_condition(
        RS, RT, RS.TpuSession(ORACLE)).collect())


STRATEGIES = {"broadcast": {},
              "shuffled": {"spark.sql.autoBroadcastJoinThreshold": "-1"}}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("batch_rows", [None, 250])
def test_left_outer_join_matches_oracle(case, strategy, batch_rows):
    """Every probe row without a match, a null key included, is kept once
    with null build columns; the rest expand as in the inner join."""
    conf = dict(STRATEGIES[strategy])
    if batch_rows is not None:
        conf["spark.rapids.sql.reader.batchSizeRows"] = batch_rows
    df = joined(S, T, S.TpuSession(conf, device="cpu"), case, 11, "left")
    want = joined(RS, RT, RS.TpuSession(ORACLE), case, 11, "left").collect()
    got = df.collect()
    assert rows_key(got) == rows_key(want)
    n_probe = 0 if case == "empty_probe" else 900
    assert len(got) >= n_probe
    assert rows_key(df.collect()) == rows_key(got)     # a second run agrees
    top = df.explain().splitlines()[0]
    if strategy == "shuffled":
        assert top.startswith("TpuAdaptiveJoin(threshold=-1)[TpuShuffled"
                              "SymmetricHashJoinExec LeftOuter [k=k")
        assert " decided=shuffled(" in top
    else:
        assert top.startswith("TpuBroadcastHashJoinExec LeftOuter [k=k")


_REF_FRAMES = """
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.column import HostColumn
    from spark_rapids_tpu.plan.nodes import LocalTableScan

    def frame(s, names, types, prefix):
        host = [HostColumn.from_numpy(inp[prefix + n], t,
                                      inp[prefix + n + "_valid"])
                for n, t in zip(names, types)]
        sch = T.StructType([T.StructField(n, t)
                            for n, t in zip(names, types)])
        return RS.DataFrame(LocalTableScan(host, sch), s)
"""


def _join_inputs(seed):
    probe, pvalid, build, bvalid = tables(seed)
    inp = {}
    for prefix, data, valid in (("p_", probe, pvalid), ("b_", build, bvalid)):
        for name, arr in data.items():
            inp[prefix + name] = arr
            inp[prefix + name + "_valid"] = valid.get(
                name, np.ones(len(arr), np.bool_))
    return inp


def test_adaptive_join_decisions_match_reference(tmp_path):
    """The adaptive join's decision string, plan and rows against the
    reference's device session: ``shuffled`` when broadcasting is off;
    ``broadcast`` when the build side's plan-time estimate (the whole
    table) is over the threshold and its run-time bytes (after a filter)
    are within it."""
    inp = _join_inputs(13)
    confs = {"shuffled": {"spark.sql.autoBroadcastJoinThreshold": "-1"},
             "broadcast": {"spark.sql.autoBroadcastJoinThreshold": "1000"}}
    out = run_jax(_REF_FRAMES + f"""
    for label, conf in {confs!r}.items():
        s = RS.TpuSession(conf)
        left = frame(s, ["k", "k2", "v"],
                     [T.INT, T.LONG, T.DecimalType(9, 2)], "p_")
        right = frame(s, ["k", "k2", "w"], [T.INT, T.LONG, T.LONG], "b_")
        right = right.filter(RS.col("w") < RS.lit(200000))
        df = left.join(right, on=["k", "k2"], how="left")
        rows = df.collect()
        out[label + "_rows"] = np.array(sorted(repr(r) for r in rows))
        out[label + "_plan"] = np.array(df.explain().splitlines())
    """, tmp_path, inp)
    probe, pvalid, build, bvalid = tables(13)
    psch, bsch = schemas(T)
    for label, conf in confs.items():
        s = S.TpuSession(conf, device="cpu")
        left = frame(S, s, probe, psch, pvalid)
        right = frame(S, s, build, bsch, bvalid).filter(
            S.col("w") < S.lit(200000))
        df = left.join(right, on=["k", "k2"], how="left")
        got = df.collect()
        assert sorted(repr(r) for r in got) == list(out[label + "_rows"])
        assert df.collect() == got
        mine = df.explain().splitlines()
        assert f"decided={label}(" in mine[0]
        assert mine == list(out[label + "_plan"])


def test_adaptive_reader_coalesces_small_partitions():
    """Adjacent partitions under ``small_bytes`` merge up to the target;
    a partition at or above it is emitted alone."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec.exchange import (
        TpuAdaptiveShuffleReaderExec, TpuShuffleExchangeExec)
    from spark_rapids_tpu_torch.plan.nodes import SinglePartitioning

    sch = T.StructType([T.StructField("x", T.LONG)])

    def batch(n, start):
        return ColumnarBatch([DeviceColumn(
            T.LONG, torch.ones(n, dtype=torch.bool),
            data=torch.arange(start, start + n))], n, sch)

    class Leaf:
        children = []
        output = sch
        device = torch.device("cpu")

        def execute_columnar(self):
            start = 0
            for n in (10, 20, 30, 500, 5, 5, 40):   # 9 bytes a row
                yield batch(n, start)
                start += n

    reader = TpuAdaptiveShuffleReaderExec(
        TpuShuffleExchangeExec(SinglePartitioning(), Leaf()),
        target_bytes=500, small_bytes=1000)
    snap = PC.snapshot()
    out = list(reader.execute_columnar())
    assert [b.num_rows for b in out] == [30, 30, 500, 50]
    assert reader.stats[3] == (500, 4500)
    assert reader.decision == "coalesced 7->4 partitions"
    assert PC.since(snap)["partitions_coalesced"] == 3
    got = torch.cat([b.columns[0].data for b in out])
    assert torch.equal(got, torch.arange(610))

"""The inner broadcast hash join (``exec/join.py``) against the JAX package:
``_slots_to_probe_rows`` and the build-side search against the reference's
(child process); whole joins against the reference's CPU oracle session,
with null keys on both sides, duplicate build keys, a two-column key,
several probe batches, an empty build side and an empty probe side, each
collected twice.  Every comparison is exact.  Join types, conditions and
sizes outside the port raise ``NotOnGpu`` in the plan rewrite."""
import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import join as J
from spark_rapids_tpu_torch.exec.base import NotOnGpu
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


@pytest.mark.parametrize("nwords", [1, 2])
def test_build_search_matches_reference(tmp_path, nwords):
    """The equal-key runs of one key word (``torch.searchsorted``) and two
    (``_merge_rank``), against the reference's ``_multiword_searchsorted``
    left and right; the build tail past ``n_valid`` holds the largest word,
    as ``_prepare_build`` leaves it."""
    rng = np.random.default_rng(6 + nwords)
    n, n_valid, nq = 200, 170, 500
    keys = np.stack([rng.integers(-5, 5, n_valid) for _ in range(nwords)])
    keys = keys[:, np.lexsort(keys[::-1])]
    words = np.full((nwords, n), np.iinfo(np.int64).max)
    words[:, :n_valid] = keys
    queries = np.stack([rng.integers(-6, 6, nq) for _ in range(nwords)])
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


def joined(mod, types, session, case, seed):
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
    return left.join(right, on=on)


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


@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti",
                                 "cross"])
def test_unported_join_types_raise(how):
    df = joined(S, T, S.TpuSession({}, device="cpu"), "one_key", 8)
    left, right = df.plan.children[0], df.plan.children[1].children[0]
    df2 = S.DataFrame(left, df.session).join(
        S.DataFrame(right, df.session), on="k", how=how)
    with pytest.raises(NotOnGpu):
        df2.collect()


def test_shuffled_and_oversized_joins_raise():
    for conf, what in (({"spark.sql.autoBroadcastJoinThreshold": "-1"},
                        "shuffled join"),
                       ({"spark.rapids.sql.batchSizeBytes": "1k"},
                        "sub-partitioned join")):
        df = joined(S, T, S.TpuSession(conf, device="cpu"), "one_key", 9)
        with pytest.raises(NotOnGpu, match=what):
            df.explain()
    s = S.TpuSession({}, device="cpu")
    df = joined(S, T, s, "one_key", 9)
    with pytest.raises(NotImplementedError):
        df.join(df, on=S.col("v") > S.lit(0))

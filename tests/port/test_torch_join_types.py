"""The join types beyond inner and left outer — left semi, left anti,
right outer and full outer — against the JAX package: rows against its CPU oracle
session, plans against its device session's ``explain`` (planned in the
child process, never collected; one batched call), the output schema
against the reference's.  Each type runs through the broadcast join, the
adaptive join deciding ``shuffled`` and ``broadcast``, the shuffled join
without adaptive execution and the sub-partitioned join, on an int key
and a string key with nulls on both sides and duplicate build keys, with
string payloads; and with an empty build or probe side.  A full outer
join under ``with_retry`` (a re-run after its coverage was ORed, and a
split probe batch) emits its build tail once.  Every comparison is
exact."""
import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax

HOWS = ["left_semi", "left_anti", "right", "full"]
STRATEGIES = {
    "broadcast": {},
    "adaptive_shuffled": {"spark.sql.autoBroadcastJoinThreshold": "-1"},
    "adaptive_broadcast": {"spark.sql.autoBroadcastJoinThreshold": 7000},
    "shuffled_no_aqe": {"spark.sql.autoBroadcastJoinThreshold": "-1",
                        "spark.sql.adaptive.enabled": False},
    "sub_partitioned": {"spark.rapids.sql.batchSizeBytes": "1k",
                        "spark.rapids.sql.reader.batchSizeRows": 300},
}
WORDS = np.array(["", "a", "ab", "b", "banana", "a\x00", "cherry pie",
                  "z" * 20], object)


def tables(seed, n_probe=700, n_build=300):
    rng = np.random.default_rng(seed)
    probe = {"k": rng.integers(0, 40, n_probe).astype(np.int32),
             "s": WORDS[rng.integers(0, len(WORDS), n_probe)],
             "p": WORDS[rng.integers(0, len(WORDS), n_probe)],
             "v": rng.integers(-1000, 1000, n_probe)}
    build = {"k": rng.integers(0, 50, n_build).astype(np.int32),
             "s": WORDS[rng.integers(1, len(WORDS), n_build)],
             "q": WORDS[rng.integers(0, len(WORDS), n_build)],
             "w": rng.integers(0, 10 ** 6, n_build)}
    pvalid = {c: rng.random(n_probe) > 0.1 for c in ("k", "s", "p")}
    bvalid = {c: rng.random(n_build) > 0.1 for c in ("k", "s", "q")}
    return probe, pvalid, build, bvalid


def schemas(mod):
    p = mod.StructType([mod.StructField("k", mod.INT),
                        mod.StructField("s", mod.STRING),
                        mod.StructField("p", mod.STRING),
                        mod.StructField("v", mod.DecimalType(9, 2))])
    b = mod.StructType([mod.StructField("k", mod.INT),
                        mod.StructField("s", mod.STRING),
                        mod.StructField("q", mod.STRING),
                        mod.StructField("w", mod.LONG)])
    return p, b


def joined(mod, types, session, how, key="k", case="", seed=3):
    probe, pvalid, build, bvalid = tables(seed)
    if case == "empty_probe":
        probe = {k: v[:0] for k, v in probe.items()}
        pvalid = {k: v[:0] for k, v in pvalid.items()}
    psch, bsch = schemas(types)
    left = frame(mod, session, probe, psch, pvalid)
    # the filter keeps a fifth of the build rows: the plan's estimate is
    # the whole table's, so an adaptive join can decide either way
    cut = 0 if case == "empty_build" else 200_000
    right = frame(mod, session, build, bsch, bvalid).filter(
        mod.col("w") < mod.lit(cut))
    return left.join(right, on=key, how=how)


def _oracle(how, key="k", case=""):
    return rows_key(joined(RS, RT, RS.TpuSession(ORACLE), how, key,
                           case).collect())


@pytest.mark.parametrize("key", ["k", "s"])
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("how", HOWS)
def test_join_type_matches_oracle(how, strategy, key):
    df = joined(S, T, S.TpuSession(STRATEGIES[strategy], device="cpu"),
                how, key)
    want = _oracle(how, key)
    assert rows_key(df.collect()) == want
    assert rows_key(df.collect()) == want        # a second run agrees
    top = df.explain().splitlines()[0]
    if strategy == "sub_partitioned":
        root = df._planned()
        assert (root.sub_partitions or 0) >= 2
    if strategy.startswith("adaptive"):
        decided = strategy.split("_")[1]
        assert f" decided={decided}(" in top


@pytest.mark.parametrize("case", ["empty_build", "empty_probe"])
@pytest.mark.parametrize("how", HOWS)
def test_join_type_with_an_empty_side(how, case):
    for conf in ({}, STRATEGIES["adaptive_shuffled"]):
        df = joined(S, T, S.TpuSession(conf, device="cpu"), how, "s", case)
        assert rows_key(df.collect()) == _oracle(how, "s", case)


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain of every (type, strategy, key) join,
    planned in one child call."""
    combos = [(h, s, k) for h in HOWS for s in sorted(STRATEGIES)
              for k in ("k", "s")]
    out = run_jax(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    from test_torch_join_types import joined, STRATEGIES
    for i, (how, strategy, key) in enumerate({combos!r}):
        conf = dict(STRATEGIES[strategy],
                    **{{"spark.rapids.tpu.joinAggFusion.enabled": False}})
        get_device_manager(TpuConf(conf))
        q = joined(RS, T, RS.TpuSession(conf), how, key)
        out[f"p{{i}}"] = np.array(C.plan_shape(q))
        out[f"s{{i}}"] = np.array([q.schema.simpleString])
    """, tmp_path_factory.mktemp("jt"))
    return {c: (list(out[f"p{i}"]), str(out[f"s{i}"][0]))
            for i, c in enumerate(combos)}


@pytest.mark.parametrize("how", HOWS)
def test_join_type_plans_and_schemas_equal_the_reference(how,
                                                         reference_plans):
    """Every strategy's plan (before a collect) and the output schema —
    the probe side's columns only for semi and anti — are the
    reference's."""
    import sys

    from torch_port_jaxref import REPO

    sys.path.insert(0, REPO)
    import chip_smoke as C

    for strategy in sorted(STRATEGIES):
        for key in ("k", "s"):
            df = joined(S, T, S.TpuSession(STRATEGIES[strategy],
                                           device="cpu"), how, key)
            plan, schema = reference_plans[(how, strategy, key)]
            assert C.plan_shape(df) == plan, (strategy, key)
            assert df.schema.simpleString == schema
    if how in ("left_semi", "left_anti"):
        assert df.schema.field_names() == ["k", "s", "p", "v"]


def test_full_outer_under_with_retry_emits_its_tail_once(monkeypatch):
    """A probe batch re-run after its coverage was ORed, and probe batches
    split in two: the full outer join's rows still equal the oracle's
    (the OR is idempotent, the tail comes once, after the last batch)."""
    from spark_rapids_tpu_torch.exec import join as J
    from spark_rapids_tpu_torch.memory import retry as R

    want = _oracle("full")
    real = J._BaseTpuJoinExec._probe_one
    calls = [0]

    def flaky(self, build, probe, covered=None):
        out = real(self, build, probe, covered)
        calls[0] += 1
        if calls[0] == 2:
            raise R.TpuRetryOOM("after the coverage was ORed")
        return out

    monkeypatch.setattr(J._BaseTpuJoinExec, "_probe_one", flaky)
    conf = {"spark.rapids.sql.reader.batchSizeRows": 200}
    df = joined(S, T, S.TpuSession(conf, device="cpu"), "full")
    assert rows_key(df.collect()) == want
    assert calls[0] >= 5                       # 4 probe batches, one re-run
    monkeypatch.setattr(J._BaseTpuJoinExec, "_probe_one", real)
    R.force_split_and_retry_oom(2)
    assert rows_key(df.collect()) == want

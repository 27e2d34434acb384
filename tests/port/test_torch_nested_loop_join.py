"""The nested-loop join, the cross join and the inner equi-join's residual
condition against the JAX package: rows against its CPU oracle session
(in this process, no compile), plans and output schemas against its
device session's ``explain`` (planned in the child process, never
collected; one batched call for the module).

The nested-loop join runs as the reference's ``test_bnlj_condition_join``
runs it, over inner, cross, left outer, left semi and left anti, with a
condition whose values are null on some pairs (an OR over nullable
columns of two types), and against an empty right side; its chunks are
cut to 500 pairs, so a left batch spans many.  Right and full outer ones
are a CPU stage with the reference's fallback reason; their rows are
Spark's (the rows without a match kept, the other side null), where the
reference's oracle keeps only the matched pairs (ROADMAP Queue 3, R5):
the test holds them to a brute force over the pairs, and the pairs to
the reference.  The residual condition runs on the broadcast join, the
shuffled join, the adaptive join deciding either way and the
sub-partitioned join (the reference's ``test_join_with_condition_inner``).
Every comparison is exact."""
import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.generate import (
    TpuBroadcastNestedLoopJoinExec)
from spark_rapids_tpu_torch.exec.join import TpuCartesianProductExec
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax

HOWS = ["inner", "cross", "left", "left_semi", "left_anti"]
CASES = ["rows", "empty_right"]
WORDS = np.array(["", "a", "bb", "ccc", "z" * 20], object)
ROUTES = {
    "broadcast": {},
    "shuffled": {},
    "adaptive_shuffled": {"spark.sql.autoBroadcastJoinThreshold": 100},
    "adaptive_broadcast": {},
    "sub_partitioned": {"spark.rapids.sql.batchSizeBytes": "1k",
                        "spark.rapids.sql.reader.batchSizeRows": 300},
}


def schemas(mod):
    return (mod.StructType([mod.StructField("a", mod.INT),
                            mod.StructField("x", mod.INT),
                            mod.StructField("s", mod.STRING)]),
            mod.StructType([mod.StructField("b", mod.INT),
                            mod.StructField("y", mod.LONG),
                            mod.StructField("t", mod.STRING)]))


def tables(n_left=120, n_right=80, seed=9):
    rng = np.random.default_rng(seed)
    left = {"a": rng.integers(0, 50, n_left).astype(np.int32),
            "x": rng.integers(-100, 100, n_left).astype(np.int32),
            "s": WORDS[rng.integers(0, len(WORDS), n_left)]}
    right = {"b": rng.integers(0, 50, n_right).astype(np.int32),
             "y": rng.integers(-100, 100, n_right),
             "t": WORDS[rng.integers(0, len(WORDS), n_right)]}
    lvalid = {"x": rng.random(n_left) > 0.2, "s": rng.random(n_left) > 0.1}
    rvalid = {"y": rng.random(n_right) > 0.2, "t": rng.random(n_right) > 0.1}
    # three right rows no left row matches: b = 0 and y null
    right["b"][:3] = 0
    rvalid["y"][:3] = False
    return left, lvalid, right, rvalid


def sides(mod, types, session, case="rows"):
    left, lvalid, right, rvalid = tables()
    lsch, rsch = schemas(types)
    l = frame(mod, session, left, lsch, lvalid)
    r = frame(mod, session, right, rsch, rvalid)
    if case == "empty_right":
        r = r.filter(mod.col("b") > mod.lit(1000))
    return l, r


def condition(mod):
    """Null on the pairs where ``a >= b`` and x or y is null."""
    col = mod.col
    return (col("a") < col("b")) | (col("x") > col("y"))


def bnlj(mod, types, session, how, case="rows"):
    l, r = sides(mod, types, session, case)
    return l.join(r, condition(mod), how)


def cross(mod, types, session, filtered):
    l, r = sides(mod, types, session)
    q = l.cross_join(r)
    return q.filter(condition(mod)) if filtered else q


def residual(mod, types, session, route):
    """An inner equi-join on a = b with the residual condition x > y,
    built by hand as the reference's test builds it."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    PN = __import__(pkg + ".plan.nodes", fromlist=["SortMergeJoin"])
    l, r = sides(mod, types, session)
    lk = [mod.col("a").resolve(l.schema)]
    rk = [mod.col("b").resolve(r.schema)]
    if route == "broadcast":
        node = PN.BroadcastHashJoin(l.plan, PN.BroadcastExchange(r.plan), lk,
                                    rk, PN.JoinType.INNER)
    elif route.startswith("adaptive"):
        node = PN.SortMergeJoin(
            PN.Exchange(PN.HashPartitioning(lk, 4), l.plan),
            PN.Exchange(PN.HashPartitioning(rk, 4), r.plan), lk, rk,
            PN.JoinType.INNER)
    else:
        node = PN.SortMergeJoin(l.plan, r.plan, lk, rk, PN.JoinType.INNER)
    joined = mod.DataFrame(node, session)
    node.condition = (mod.col("x") > mod.col("y")).resolve(joined.schema)
    return joined


def _oracle(q):
    return rows_key(q.collect())


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain and output schema of every query of this
    module, planned in one child call."""
    out = run_jax("""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import test_torch_nested_loop_join as M
    def plan(key, conf, build):
        conf = dict(conf, **{"spark.rapids.tpu.joinAggFusion.enabled": False})
        get_device_manager(TpuConf(conf))
        q = build(RS.TpuSession(conf))
        out["p" + key] = np.array(C.plan_shape(q))
        out["s" + key] = np.array([q.schema.simpleString])
    for how in M.HOWS + ["right", "full"]:
        for case in M.CASES:
            plan(f"bnlj-{how}-{case}", {},
                 lambda s: M.bnlj(RS, T, s, how, case))
    for f in (False, True):
        plan(f"cross-{f}", {}, lambda s: M.cross(RS, T, s, f))
    for route, conf in M.ROUTES.items():
        plan(f"residual-{route}", conf,
             lambda s: M.residual(RS, T, s, route))
    """, tmp_path_factory.mktemp("bnlj"))
    return {k[1:]: (list(out[k]), str(out["s" + k[1:]][0]))
            for k in out if k.startswith("p")}


def _same_plan(df, ref):
    import sys

    from torch_port_jaxref import REPO

    sys.path.insert(0, REPO)
    import chip_smoke as C

    plan, schema = ref
    assert C.plan_shape(df) == plan
    assert df.schema.simpleString == schema


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("how", HOWS)
def test_bnlj_condition_join(how, case, reference_plans, monkeypatch):
    """Each device type against the oracle, twice, in chunks of 500 pairs
    (the 120 x 80 pairs take 20), planned as the reference plans it."""
    monkeypatch.setattr(TpuBroadcastNestedLoopJoinExec, "MAX_PRODUCT", 500)
    df = bnlj(S, T, S.TpuSession({}, device="cpu"), how, case)
    _same_plan(df, reference_plans[f"bnlj-{how}-{case}"])
    want = _oracle(bnlj(RS, RT, RS.TpuSession(ORACLE), how, case))
    assert rows_key(df.collect()) == want
    assert rows_key(df.collect()) == want
    if case == "empty_right":
        n_left = len(tables()[0]["a"])
        assert len(want) == (n_left if how in ("left", "left_anti") else 0)


def _spark_outer_rows(how):
    """Right or full outer rows by brute force over the pairs, in SQL's
    three-valued logic: (matched pairs, unmatched left rows with a null
    right side, unmatched right rows with a null left side)."""
    left, lvalid, right, rvalid = tables()
    lrows = [(int(a), int(x) if vx else None, s if vs else None)
             for a, x, s, vx, vs in zip(left["a"], left["x"], left["s"],
                                        lvalid["x"], lvalid["s"])]
    rrows = [(int(b), int(y) if vy else None, t if vt else None)
             for b, y, t, vy, vt in zip(right["b"], right["y"], right["t"],
                                        rvalid["y"], rvalid["t"])]

    def match(lr, rr):
        return lr[0] < rr[0] or (lr[1] is not None and rr[1] is not None
                                 and lr[1] > rr[1])

    pairs = [lr + rr for lr in lrows for rr in rrows if match(lr, rr)]
    lost_l = [lr + (None,) * 3 for lr in lrows
              if not any(match(lr, rr) for rr in rrows)]
    lost_r = [(None,) * 3 + rr for rr in rrows
              if not any(match(lr, rr) for lr in lrows)]
    return pairs, (lost_l if how == "full" else []), lost_r


@pytest.mark.parametrize("how", ["right", "full"])
def test_right_and_full_outer_bnlj_are_a_cpu_stage(how, reference_plans):
    """The plan, with the reference's fallback reason, is the reference's;
    the rows are Spark's: the matched pairs, as the reference's oracle
    gives them, plus the rows without a match (the right side's, and a
    full join's left side's), which that oracle drops."""
    df = bnlj(S, T, S.TpuSession({}, device="cpu"), how)
    _same_plan(df, reference_plans[f"bnlj-{how}-rows"])
    assert "nested-loop join type" in df.explain().split(
        "Fallback reasons:")[1]
    pairs, lost_l, lost_r = _spark_outer_rows(how)
    assert lost_r                              # the data shows the case
    got = rows_key(df.collect())
    assert got == rows_key(pairs + lost_l + lost_r)
    # the reference's oracle keeps the matched pairs only
    assert rows_key(bnlj(RS, RT, RS.TpuSession(ORACLE), how).collect()) \
        == rows_key(pairs)


@pytest.mark.parametrize("filtered", [False, True])
def test_cross_join(filtered, reference_plans, monkeypatch):
    """``cross_join``, alone (every pair) and under a filter, in steps of
    500 pairs, against the oracle; the plan is the reference's (the
    cartesian product exec)."""
    monkeypatch.setattr(TpuCartesianProductExec, "MAX_PRODUCT", 500)
    df = cross(S, T, S.TpuSession({}, device="cpu"), filtered)
    _same_plan(df, reference_plans[f"cross-{filtered}"])
    want = _oracle(cross(RS, RT, RS.TpuSession(ORACLE), filtered))
    assert rows_key(df.collect()) == want
    if not filtered:
        assert len(want) == 120 * 80


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_join_with_condition_inner(route, reference_plans):
    """The residual condition on every route the inner join takes, after
    each route's own pairs, against the oracle, twice."""
    df = residual(S, T, S.TpuSession(ROUTES[route], device="cpu"), route)
    _same_plan(df, reference_plans[f"residual-{route}"])
    want = _oracle(residual(RS, RT, RS.TpuSession(ORACLE), route))
    assert rows_key(df.collect()) == want
    assert rows_key(df.collect()) == want
    root = df._planned()
    if route == "sub_partitioned":
        assert (root.sub_partitions or 0) >= 2
    if route.startswith("adaptive"):
        assert root.decision.startswith(route.split("_")[1] + "(")


def test_bnlj_condition_error_raises_under_ansi(monkeypatch):
    """Under ANSI an overflow in the condition raises, as the oracle's
    does, when a chunk's pairs reach it (the flags read in one sync a
    chunk); without ANSI the overflowed pairs wrap and the rows equal the
    oracle's."""
    from spark_rapids_tpu.expr.base import SparkArithmeticException as RErr
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException

    monkeypatch.setattr(TpuBroadcastNestedLoopJoinExec, "MAX_PRODUCT", 500)

    def q(mod, types, s):
        l, r = sides(mod, types, s)
        big = mod.lit(2 ** 31 - 40)
        return l.join(r, mod.col("a") + big > mod.col("b") + big, "inner")

    ansi = {"spark.sql.ansi.enabled": "true"}
    with pytest.raises(SparkArithmeticException):
        q(S, T, S.TpuSession(ansi, device="cpu")).collect()
    with pytest.raises(RErr):
        q(RS, RT, RS.TpuSession(dict(ansi, **ORACLE))).collect()
    assert rows_key(q(S, T, S.TpuSession({}, device="cpu")).collect()) \
        == rows_key(q(RS, RT, RS.TpuSession(ORACLE)).collect())

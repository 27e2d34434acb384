"""TPC-H Q21 (EXISTS and NOT EXISTS as a LeftSemi and a LeftAnti hash
join with a residual condition: two CPU stages of the port's engine) and
supp_revenue_avg (the average of a decimal(26,4) per supplier: a CPU
stage of the aggregate, the top-N on the device) on the port
(``device="cpu"``) at 15,000 lines from ``chip_smoke.py``'s generators.

From memory: the plans (the explain, and the device subtrees under the
CPU stages) against the reference device session's (planned in the child
process, one call for the module) and ``chip_smoke``'s plan functions;
the rows against ``chip_smoke``'s numpy references and the reference's
CPU oracle session, Q21's on its nested-loop form (the reference's hash
joins drop a semi or anti join's condition, ROADMAP R26).  From the
Parquet files phase 35 writes: the phase itself, K1 once a dictionary
chunk.  Every comparison is exact (integers, strings and decimals)."""
import sys

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

SCALE = 0.0025                     # 25 suppliers, 3,750 orders
SEED = 2                           # 3 suppliers of SAUDI ARABIA, a tie


def data():
    """(tables, values, q21) as ``run_tpch_phases`` draws them at
    ``SCALE`` (a smaller text pool)."""
    tables, values = C.make_tpch_parts(SCALE, SEED)
    pool = C.text_pool(SEED + 1, 1 << 18)
    _, orders, li9 = C.make_text_tables(SCALE, SEED + 3, pool)
    return tables, values, C.q21_tables(li9, orders, SEED + 300)


@pytest.fixture(scope="module")
def q21():
    return data()


def frames(mod, types, session, d):
    tables, values, q21 = d
    sch = C.tpch_all_schemas(types)
    src = {"supplier": tables["supplier"], "nation": tables["nation"],
           "lineitem21": q21["lineitem21"], "orders21": q21["orders21"],
           "lineitem9": q21["revenue"]}
    vals = dict(values, o_orderstatus=C.Q21_STATUS)
    out = {}
    for name, reads in {**C.Q21_READS, **C.REV_READS}.items():
        held = types.StructType([f for f in sch[name].fields
                                 if f.name in reads])
        out[name] = frame(mod, session, {
            f.name: (np.asarray(vals[f.name], object)[src[name][f.name]]
                     if f.name in vals else src[name][f.name])
            for f in held.fields}, held)
    return out


def build(name, mod, f):
    if name == "q21":
        return C.q21_query(f, mod)
    if name == "q21_bnlj":
        return C.q21_bnlj_query(f, mod)
    return C.revenue_query(f["lineitem9"], mod)


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain and the device subtrees under its CPU
    stages, for both queries, in one child call."""
    return run_jax("""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    import test_torch_q21 as M
    d = M.data()
    for name in ("q21", "revenue"):
        q = M.build(name, RS, M.frames(RS, T, RS.TpuSession({}), d))
        out[name] = np.array(C.plan_shape(q))
        out[name + "_stage"] = np.array(C.stage_plan_shape(q))
        out[name + "_schema"] = np.array([q.schema.simpleString])
    """, tmp_path_factory.mktemp("q21ref"))


def want(name, d):
    tables, _, q21 = d
    return (C.q21_reference(q21, tables) if name == "q21"
            else C.revenue_reference(q21["revenue"]))


MEMORY_STAGES = {"q21": lambda decided: C.q21_stage(
    {"orders": "planned", "supplier": decided}),
    "revenue": lambda decided: C.REVENUE_STAGE}
PLANS = {"q21": C.q21_plan(), "revenue": C.REVENUE_PLAN}


@pytest.mark.parametrize("name", ["q21", "revenue"])
def test_queries_from_memory(name, q21, reference_plans):
    """The plan and the device subtrees under its CPU stages are the
    reference's and ``chip_smoke``'s (the supplier join adaptive, then
    decided broadcast by a collect); the rows equal numpy's twice, and
    the reference oracle's: Q21's on its nested-loop form, whose rows
    its hash-join form does not give (R26)."""
    expected = want(name, q21)
    assert len(expected) >= 3
    q = build(name, S, frames(S, T, S.TpuSession({}, device="cpu"), q21))
    assert C.plan_shape(q) == list(reference_plans[name]) == PLANS[name]
    assert C.stage_plan_shape(q) == list(reference_plans[name + "_stage"]) \
        == MEMORY_STAGES[name]("adaptive")
    assert q.schema.simpleString == str(reference_plans[name + "_schema"][0])
    assert q.collect() == expected
    assert q.collect() == expected
    assert C.stage_plan_shape(q) == MEMORY_STAGES[name]("broadcast")
    oracle = RS.TpuSession(ORACLE)
    ref = build("q21_bnlj" if name == "q21" else name, RS,
                frames(RS, RT, oracle, q21)).collect()
    assert ref == expected
    if name == "q21":
        # the reference's hash-join form keeps every l1 line (R26)
        wrong = build(name, RS, frames(RS, RT, oracle, q21)).collect()
        assert wrong != expected
        assert build("q21_bnlj", S, frames(
            S, T, S.TpuSession({}, device="cpu"), q21)).collect() \
            == expected


def test_phase_35_from_parquet(q21, tmp_path, monkeypatch):
    """Phase 35 at test size (``chip_smoke.run_q21_phase``, the card's
    calls stubbed): Q21's tables written, K1 against its plain version on
    their index tables, both queries exact against numpy with their plans
    ``chip_smoke``'s (the orders join broadcast at planning, as their
    files are small) and K1 once a dictionary chunk, the CPU stages
    timed inside the profiled collect."""
    from spark_rapids_tpu_torch.pallas import decode

    tables, values, data = q21
    dev = torch.device("cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(C, "profile_collect",
                        lambda collect, want, label, key=None: collect())
    real = decode.unpack_runs

    def counting(*a, **k):
        decode.unpack_launches += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    sch = C.tpch_all_schemas(T)
    paths = {name: C.write_tpch_files(name, tables[name], values,
                                      C.tpch_schemas(T)[name], str(tmp_path),
                                      dev, 2)
             for name in ("supplier", "nation")}
    lines = {k: data["revenue"][k] for k in C.REV_READS["lineitem9"]}
    lines["l_orderkey"] = data["lineitem21"]["l_orderkey"]
    lines["l_partkey"] = lines["l_quantity"] = np.zeros(
        len(lines["l_orderkey"]), np.int64)
    paths["lineitem9"] = C.write_tpch_files(
        "lineitem9", lines, values, sch["lineitem9"], str(tmp_path), dev, 2)
    out = C.run_q21_phase(tables, data, paths, str(tmp_path), dev, "cpu")
    assert C.q21_modes(paths, data) == {"orders": "planned",
                                        "supplier": "broadcast"}
    assert out["k1_err"] == 0
    for label in ("Q21", "supp_revenue_avg"):
        assert out[label]["launches"] > 0
        assert out[label]["probe"]["engine"] > 0

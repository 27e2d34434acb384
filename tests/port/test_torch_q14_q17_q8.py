"""TPC-H Q14 (a decimal divide of two 128-bit sums in a CPU stage, a
``LIKE`` prefix in a CASE), Q17 (``0.2 * avg(l_quantity)`` grouped by part
and joined back with a residual condition, then ``sum / 7.0``) and Q8
(eight tables, ``year``, a share by year) on the port (``device="cpu"``)
at 2,000 partsupp rows from ``chip_smoke.py``'s generators: from memory
against the JAX package's CPU oracle session and ``chip_smoke``'s numpy
references, the plans (the explain, and the device subtree under each
CPU stage) against the reference device session's (planned in the child
process, one call for the module) and ``chip_smoke``'s plan functions;
and from the Parquet files ``chip_smoke.py`` writes (phases 30-31), with
K1 once a dictionary chunk.  Every comparison is exact (integers and
decimals)."""
import sys

import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402
import test_torch_q13_q22_q16_q9 as Q13  # noqa: E402

QUERIES = ["q14", "q17", "q8"]
#: a threshold under which the joins with large right sides are adaptive,
#: as at SF10 under 10 MiB
THRESHOLD = 2000


def data():
    """Phases 24-29's tables at the Q13 test's scale, with P_CONTAINER and
    region added as ``run_tpch_phases`` adds them."""
    d = Q13.data()
    C.add_arith_columns(d[0], d[1], Q13.SEED + 4)
    return d


@pytest.fixture(scope="module")
def tpch():
    return data()


def frames(mod, types, session, d):
    tables, values, _, _, _, customer, orders, li9 = d
    sch = C.tpch_all_schemas(types)
    src = dict(tables, customer=customer, orders=orders, lineitem9=li9)
    return {name: Q13.frame(mod, session, Q13._arrays(src[name], values,
                                                      sch[name].fields),
                            sch[name])
            for name in ("nation", "supplier", "part", "customer", "orders",
                         "lineitem9", "region")}


def build(name, mod, f):
    return C.arith_query(name, f, mod)


def session(mod):
    if mod is S:
        return S.TpuSession({}, device="cpu")
    return RS.TpuSession({})


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain of every query from memory, and the device
    subtrees under its CPU stages, in one child call."""
    return run_jax(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import test_torch_q14_q17_q8 as M
    get_device_manager(TpuConf({{}}))
    d = M.data()
    for name in {QUERIES!r}:
        q = M.build(name, RS, M.frames(RS, T, M.session(RS), d))
        out[name] = np.array(C.plan_shape(q))
        out[name + "_stage"] = np.array(C.stage_plan_shape(q))
        out[name + "_schema"] = np.array([q.schema.simpleString])
    """, tmp_path_factory.mktemp("q14ref"))


def collapse_two_phase(lines):
    """The reference's lines with each Final <- exchange <- Partial
    aggregate written as the one COMPLETE aggregate the port plans: under
    a CPU stage the reference's single-device passes (its
    ``_collapse_complete_agg`` among them) do not run, while the port,
    which has no Partial/Final pair, collapses every aggregate when it
    converts (ROADMAP.md Queue 3)."""
    out, i = [], 0
    # the explain's one line for a CPU stage's device subtree names its root
    lines = [str(ln).replace("<- TpuHashAggregate(Final)",
                             "<- TpuHashAggregate(Complete)")
             for ln in lines]
    while i < len(lines):
        ln = lines[i]
        pad = len(ln) - len(ln.lstrip())
        body = ln.lstrip()
        if (body.startswith("TpuHashAggregate(Final)") and i + 2 < len(lines)
                and lines[i + 1].lstrip().startswith("TpuShuffleExchange")
                and lines[i + 2].lstrip().startswith(
                    "TpuHashAggregate(Partial)")):
            out.append(" " * pad + body.replace("(Final)", "(Complete)"))
            j = i + 3
            while j < len(lines) and (len(lines[j]) - len(lines[j].lstrip())
                                      > pad + 4):
                out.append(lines[j][4:])
                j += 1
            i = j
            continue
        out.append(ln)
        i += 1
    return out if out == lines else collapse_two_phase(out)


def want(name, d):
    return C.arith_references(d[0], d[5], d[6], d[7])[name]


@pytest.mark.parametrize("name", QUERIES)
def test_queries_from_memory(name, tpch, reference_plans):
    """Rows equal numpy and the reference's oracle, twice; the plan and
    the device subtree under the CPU stage the reference's (its two-phase
    aggregates collapsed, ``collapse_two_phase``) and ``chip_smoke``'s;
    the final divide a CPU stage with the reference's words."""
    expected = want(name, tpch)
    assert expected
    q = build(name, S, frames(S, T, session(S), tpch))
    modes = C.arith_memory_modes()
    assert C.plan_shape(q) == collapse_two_phase(reference_plans[name]) \
        == C.ARITH_PLANS[name](modes)[0]
    assert C.stage_plan_shape(q) == collapse_two_phase(
        reference_plans[name + "_stage"]) == C.ARITH_PLANS[name](modes)[1]
    assert "decimal divide intermediate exceeds 18 digits" in q.explain()
    assert q.schema.simpleString == str(reference_plans[name + "_schema"][0])
    assert q.collect() == expected
    assert q.collect() == expected
    oracle = build(name, RS, frames(RS, RT, RS.TpuSession(Q13.ORACLE),
                                    tpch)).collect()
    assert oracle == expected


def test_queries_from_parquet(tpch, tmp_path, monkeypatch):
    """Phases 30-31's path at test size: part (P_CONTAINER among its
    columns), region and Q9's lineitem (L_SHIPDATE among its columns) as
    ``chip_smoke.py`` writes them, K1 against its plain version on part's
    p_container index table, then each query exact, its plans
    ``chip_smoke``'s (joins adaptive under a 2,000-byte threshold, decided
    as the build sides' rows predict), K1 once a dictionary chunk."""
    from spark_rapids_tpu_torch.pallas import decode

    tables, values, pool, green, complain, customer, orders, li9 = tpch
    dev = torch.device("cpu")
    monkeypatch.setattr(C, "SPARK_PAGE_VALUES", 64)
    monkeypatch.setattr(C.encode_mr_strings, "__defaults__", (8192,))
    paths = C.write_tpch_tables(tables, values,
                                C.lineitem_q15(100, Q13.SCALE, Q13.SEED),
                                str(tmp_path), dev, n_files=2)
    sch = C.tpch_all_schemas(T)
    for name, table in (("customer", customer), ("orders", orders),
                        ("lineitem9", li9)):
        paths[name] = C.write_tpch_files(name, table, values, sch[name],
                                         str(tmp_path), dev, 2)
    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    err, widths = C.check_container_k1(paths, dev, "cpu")
    assert err == 0 and widths
    modes = C.arith_join_modes(paths, C.arith_build_rows(
        tables, customer, orders, li9), THRESHOLD)
    assert {"planned", "broadcast", "shuffled"} <= set(modes.values())
    conf = dict(C.Q12_CONF, **{"spark.sql.autoBroadcastJoinThreshold":
                               THRESHOLD})
    for name in QUERIES:
        reads, scans = C.ARITH_READS[name]
        f = C.tpch_frames(paths, S.TpuSession(conf, device=dev), reads)
        q = build(name, S, f)
        calls[0] = 0
        assert q.collect() == want(name, tpch), name
        assert calls[0] == C.query_chunks(paths, reads, scans)
        plan, stage = C.ARITH_PLANS[name](modes, THRESHOLD)
        assert C.plan_shape(q) == plan, name
        assert C.stage_plan_shape(q) == stage, name

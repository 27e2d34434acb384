"""TPC-H Q11 (a scalar subquery as a nested-loop join against a one-row
broadcast side, or as a cross join and a filter), the nested-loop join's
other types on its rows, TPC-H Q15 (an equality nested-loop join against
the max) and ``q16_nolike`` (Q16 without its two LIKE predicates: a
count(distinct)) on the port (``device="cpu"``) at 2,000 partsupp rows
from ``chip_smoke.py``'s generators: from memory, against the JAX
package's CPU oracle session and ``chip_smoke``'s numpy references, the
plans against the reference device session's (planned in the child
process) and ``chip_smoke``'s plan functions; and from the Parquet files
``chip_smoke.py`` writes (phases 24-26), with K1 once a dictionary chunk.
Q11 runs at FRACTION 0.01, so that about a quarter of the parts pass
(the spec's 0.0001 / SF keeps none at this size).  The reference's oracle
keeps only the matched pairs of a full outer nested-loop join (ROADMAP
Queue 3, R5), so that type is held to numpy only.  Every comparison is
exact."""
import sys
from decimal import Decimal

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

SCALE = 0.0025                     # 2,000 partsupp rows, 25 suppliers
SEED = 5
FRACTION = Decimal("0.0100000000")
QUERIES = ["q11", "q11_cross", "q11_left", "q11_left_semi",
           "q11_left_anti", "q11_full", "q15", "q16", "q16_adaptive"]
#: q16_nolike's join adaptive (as the SF10 part files make it), deciding
#: shuffled over the filtered parts' 64 bytes a row
CONFS = {"q16_adaptive": {"spark.sql.autoBroadcastJoinThreshold": 1000}}


def data():
    tables, values = C.make_tpch_parts(SCALE, SEED)
    li = C.lineitem_q15(int(round(C.SF10_ROWS * SCALE / 10)), SCALE,
                        SEED + 1)
    return tables, values, li


@pytest.fixture(scope="module")
def tpch():
    return data()


def frames(mod, types, session, tables, values, li):
    sch = C.tpch_schemas(types)
    out = {"lineitem": frame(mod, session, li, sch["lineitem"])}
    for name in ("nation", "supplier", "part", "partsupp"):
        out[name] = frame(mod, session, {
            f.name: (np.asarray(values[f.name], object)[tables[name][f.name]]
                     if f.name in values else tables[name][f.name])
            for f in sch[name].fields}, sch[name])
    return out


def build(name, mod, f):
    if name.startswith("q11"):
        how = name[4:] or "inner"
        return C.q11_query(f["partsupp"], f["supplier"], f["nation"], mod,
                           FRACTION, how)
    if name == "q15":
        return C.q15_query(f["lineitem"], f["supplier"], mod)
    return C.q16_query(f["partsupp"], f["part"], mod)


def session(mod, name):
    conf = CONFS.get(name, {})
    if mod is S:
        return S.TpuSession(conf, device="cpu")
    return RS.TpuSession(dict(
        conf, **{"spark.rapids.tpu.joinAggFusion.enabled": False}))


def want(name, tables, values, li):
    if name.startswith("q11"):
        return C.q11_reference(tables, FRACTION, name[4:] or "inner")
    if name == "q15":
        return C.q15_reference(li, tables, values)
    return C.q16_reference(tables)


def check(name, rows, expected):
    if name.startswith("q11"):
        return C.q11_check(rows, expected) is None
    return rows == expected


def after_collect_plan(name):
    if name.startswith("q11"):
        return C.q11_plan(name[4:] or "inner", FRACTION)
    if name == "q15":
        return C.q15_plan()
    if name == "q16_adaptive":
        return C.q16_plan("shuffled", threshold=1000)
    return C.q16_plan("broadcast", broadcast_planned=True)


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain of every query from memory, before a
    collect, in one child call."""
    out = run_jax(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import test_torch_q11 as M
    get_device_manager(TpuConf({{}}))
    tables = M.data()
    for name in {QUERIES!r}:
        q = M.build(name, RS, M.frames(RS, T, M.session(RS, name), *tables))
        out[name] = np.array(C.plan_shape(q))
        out[name + "_schema"] = np.array([q.schema.simpleString])
    """, tmp_path_factory.mktemp("q11ref"))
    return out


@pytest.mark.parametrize("name", QUERIES)
def test_queries_from_memory(name, tpch, reference_plans):
    """Rows equal numpy and (but for the full outer join) the reference's
    oracle, twice; the plan before a collect the reference's, after it
    ``chip_smoke``'s plan of phases 24-26."""
    tables, values, li = tpch
    expected = want(name, tables, values, li)
    q = build(name, S, frames(S, T, session(S, name), tables, values, li))
    assert C.plan_shape(q) == list(reference_plans[name])
    assert q.schema.simpleString == str(reference_plans[name + "_schema"][0])
    assert check(name, q.collect(), expected)
    assert check(name, q.collect(), expected)
    assert C.plan_shape(q) == after_collect_plan(name)
    if name == "q16_adaptive":
        assert f"decided=shuffled({C.q16_build_bytes(tables)}B)" \
            in q.explain()
    if name != "q11_full":
        oracle = build(name, RS, frames(RS, RT, RS.TpuSession(ORACLE),
                                        tables, values, li)).collect()
        assert check(name, oracle, expected)
    if name == "q11_left_semi":
        n_anti = len(want("q11_left_anti", tables, values, li))
        assert len(expected) + n_anti == len(C.q11_values(tables)[0])


def test_queries_from_parquet(tpch, tmp_path, monkeypatch):
    """Phases 24-26's path at test size: the files as ``chip_smoke.py``
    writes them (2 a table, nation 1), K1 against its plain version on
    part's and nation's string index tables, then each query exact, its
    plan ``chip_smoke``'s, K1 once a dictionary chunk of each scan."""
    from spark_rapids_tpu_torch.pallas import decode

    tables, values, li = tpch
    dev = torch.device("cpu")
    paths = C.write_tpch_tables(tables, values, li, str(tmp_path), dev,
                                n_files=2)
    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    sch = C.tpch_schemas(T)
    err, widths = C.check_string_k1(
        [paths["part"][0], paths["nation"][0]],
        lambda p: sch["nation" if "nation" in p.split("/")[-1] else "part"],
        dev, "cpu", "part and nation")
    assert err == 0 and 5 in widths     # p_brand and n_name: 25 values
    reads = {"q11": C.Q11_READS, "q15": C.Q15_READS, "q16": C.Q16_READS}
    scans = {"q11": {t: 2 for t in C.Q11_READS},
             "q15": {"lineitem": 2, "supplier": 1},
             "q16": {t: 1 for t in C.Q16_READS}}
    for name in QUERIES[:-1]:
        base = name[:3]
        f = C.tpch_frames(paths, S.TpuSession(C.Q12_CONF, device=dev),
                          reads[base])
        q = build(name, S, f)
        calls[0] = 0
        assert check(name, q.collect(), want(name, tables, values, li))
        assert calls[0] == sum(n * C.tpch_chunks(paths, {t: reads[base][t]})
                               for t, n in scans[base].items())
        assert C.plan_shape(q) == after_collect_plan(name)

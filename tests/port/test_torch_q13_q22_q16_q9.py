"""TPC-H Q13 (``NOT LIKE`` through the regex DFA, a left outer join, a
count of counts), Q22 (``substr``, a string ``IN``, a scalar subquery as
a nested-loop join, ``NOT EXISTS`` as a left anti join), Q16 in full (a
prefix ``NOT LIKE``, the DFA on ``s_comment``, ``NOT IN`` as a left anti
join) and Q9 (``'%green%'`` as a substring search, ``year``, a six-table
join, a 128-bit grouped sum of a difference) on the port
(``device="cpu"``) at 2,000 partsupp rows from ``chip_smoke.py``'s
generators: from memory against the JAX package's CPU oracle session and
``chip_smoke``'s numpy references, the plans against the reference device
session's (planned in the child process, one call for the module) and
``chip_smoke``'s plan functions; and from the Parquet files
``chip_smoke.py`` writes (phases 27-29: strings as parquet-mr writes
them, dictionary pages then PLAIN pages), with K1 once a dictionary
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

SCALE = 0.0025                     # 2,000 partsupp rows, 375 customers
SEED = 7
POOL_BYTES = 1 << 18
QUERIES = ["q13", "q22", "q16", "q9"]
PLANS = {"q13": C.q13_plan, "q22": C.q22_plan, "q16": C.q16_full_plan,
         "q9": C.q9_plan}
READS = {"q13": C.Q13_READS, "q22": C.Q22_READS, "q16": C.Q16_FULL_READS,
         "q9": C.Q9_READS}
#: a threshold under which every join but the smallest sides' is
#: adaptive, as at SF10 under 10 MiB
THRESHOLD = 2000


def data():
    """(tables, values, pool, green, complain, customer, orders, li9) at
    ``SCALE``, as ``run_tpch_phases`` draws them (a smaller text pool)."""
    tables, values = C.make_tpch_parts(SCALE, SEED)
    pool = C.text_pool(SEED + 1, POOL_BYTES)
    green, complain = C.add_text_columns(tables, SCALE, SEED + 2, pool)
    customer, orders, li9 = C.make_text_tables(SCALE, SEED + 3, pool)
    return tables, values, pool, green, complain, customer, orders, li9


@pytest.fixture(scope="module")
def tpch():
    return data()


def _arrays(table, values, fields):
    out = {}
    for f in fields:
        v = table[f.name]
        if isinstance(v, C.TextColumn):
            out[f.name] = v.strings()
        elif f.name in values:
            out[f.name] = np.asarray(values[f.name], object)[v]
        else:
            out[f.name] = v
    return out


def frames(mod, types, session, tables, values, customer, orders, li9):
    sch = C.tpch_all_schemas(types)
    src = dict(tables, customer=customer, orders=orders, lineitem9=li9)
    out = {}
    for name in ("nation", "supplier", "part", "partsupp", "customer",
                 "orders", "lineitem9"):
        # the columns the generators drew (part's P_CONTAINER is added for
        # Q14, Q17 and Q8 only)
        held = types.StructType([f for f in sch[name].fields
                                 if f.name in src[name]])
        out[name] = frame(mod, session, _arrays(src[name], values,
                                                held.fields), held)
    return out


def build(name, mod, f):
    if name == "q13":
        return C.q13_query(f["customer"], f["orders"], mod)
    if name == "q22":
        return C.q22_query(f["customer"], f["orders"], mod)
    if name == "q16":
        return C.q16_full_query(f["partsupp"], f["part"], f["supplier"], mod)
    return C.q9_query(f["part"], f["supplier"], f["lineitem9"],
                      f["partsupp"], f["orders"], f["nation"], mod)


def session(mod):
    if mod is S:
        return S.TpuSession({}, device="cpu")
    return RS.TpuSession({"spark.rapids.tpu.joinAggFusion.enabled": False})


def want(name, d):
    tables, values, pool, green, complain, customer, orders, li9 = d
    if name == "q13":
        return C.q13_reference(customer, orders, pool)[0]
    if name == "q22":
        return C.q22_reference(customer, orders)[0]
    if name == "q16":
        return C.q16_full_reference(tables, complain)
    return C.q9_reference(tables, green, li9, orders)


def _frames_of(mod, types, sess, d):
    tables, values, _, _, _, customer, orders, li9 = d
    return frames(mod, types, sess, tables, values, customer, orders, li9)


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
    import test_torch_q13_q22_q16_q9 as M
    get_device_manager(TpuConf({{}}))
    d = M.data()
    for name in {QUERIES!r}:
        q = M.build(name, RS, M._frames_of(RS, T, M.session(RS), d))
        out[name] = np.array(C.plan_shape(q))
        out[name + "_schema"] = np.array([q.schema.simpleString])
    """, tmp_path_factory.mktemp("q13ref"))
    return out


@pytest.mark.parametrize("name", QUERIES)
def test_queries_from_memory(name, tpch, reference_plans):
    """Rows equal numpy and the reference's oracle, twice; the plan the
    reference's."""
    expected = want(name, tpch)
    assert expected
    q = build(name, S, _frames_of(S, T, session(S), tpch))
    assert C.plan_shape(q) == list(reference_plans[name])
    assert C.plan_shape(q) == PLANS[name](
        {k: "planned" for k in C.TEXT_JOINS})
    assert q.schema.simpleString == str(reference_plans[name + "_schema"][0])
    assert q.collect() == expected
    assert q.collect() == expected
    oracle = build(name, RS, _frames_of(RS, RT, RS.TpuSession(ORACLE),
                                        tpch)).collect()
    assert oracle == expected


def test_queries_from_parquet(tpch, tmp_path, monkeypatch):
    """Phases 27-29's path at test size: the files as ``chip_smoke.py``
    writes them (2 a table, nation 1; the high-cardinality strings as
    dictionary pages, then PLAIN pages: pages of 64 values and a
    dictionary limit of 8 KiB, so that o_comment's and p_name's chunks
    hold both), K1 against its plain version on
    the orders and customer string index tables, then each query exact,
    its plan ``chip_smoke``'s (joins adaptive under a 2,000-byte
    threshold, decided as at SF10), K1 once a dictionary chunk."""
    from spark_rapids_tpu_torch.pallas import decode

    tables, values, pool, green, complain, customer, orders, li9 = tpch
    dev = torch.device("cpu")
    monkeypatch.setattr(C, "SPARK_PAGE_VALUES", 64)
    monkeypatch.setattr(C.encode_mr_strings, "__defaults__", (8192,))
    paths = C.write_tpch_tables(tables, values,
                                C.lineitem_q15(100, SCALE, SEED),
                                str(tmp_path), dev, n_files=2)
    sch = C.tpch_all_schemas(T)
    for name, table in (("customer", customer), ("orders", orders),
                        ("lineitem9", li9)):
        paths[name] = C.write_tpch_files(name, table, values, sch[name],
                                         str(tmp_path), dev, 2)
    encodings = {name: {pg.encoding for nm, pg in C.main_path_pages(p)
                        if nm == name}
                 for p, name in ((paths["orders"][0], "o_comment"),
                                 (paths["part"][0], "p_name"))}
    for name, enc in encodings.items():
        assert len(enc) == 2, (name, enc)     # dictionary and PLAIN pages
    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    err, _ = C.check_string_k1(
        [paths["orders"][0], paths["customer"][0]],
        lambda p: sch["orders" if "orders" in p.split("/")[-1]
                      else "customer"], dev, "cpu", "orders and customer")
    assert err == 0
    modes = C.text_join_modes(paths, C.text_build_rows(
        tables, orders, green, complain,
        C.q13_reference(customer, orders, pool)[1]), THRESHOLD)
    assert set(modes.values()) == {"planned", "broadcast", "shuffled"}
    conf = dict(C.Q12_CONF, **{"spark.sql.autoBroadcastJoinThreshold":
                               THRESHOLD})
    for name in QUERIES:
        f = C.tpch_frames(paths, S.TpuSession(conf, device=dev), READS[name])
        q = build(name, S, f)
        calls[0] = 0
        assert q.collect() == want(name, tpch)
        assert calls[0] == C.query_chunks(
            paths, READS[name], C.Q22_SCANS if name == "q22" else None)
        assert C.plan_shape(q) == PLANS[name](modes, THRESHOLD)

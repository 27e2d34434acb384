"""The slice as a whole: TPC-H Q12 (a string IN and date filter on
lineitem, its join to orders, two CASE WHEN sums over o_orderpriority
grouped and ordered by l_shipmode) on the port (``device="cpu"``) at
about 20,000 lineitem rows from ``chip_smoke.py``'s generator, against
``chip_smoke.q12_reference`` (numpy) and the JAX package's CPU oracle
session: from memory, from the Parquet files ``chip_smoke.py`` writes
(dictionary-encoded strings, and the PLAIN-string orders file), and from
memory under phase 20's out-of-core conf with a small pool, where the
exchanges' host frames carry the strings.  The plans equal the
reference's, built in the child process, and ``chip_smoke.q12_plan``.
Every comparison is exact."""
import re
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

N_ORDERS = 5000
OOC_ORDERS = 50_000
SEED = 20261017
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def q12_tables():
    orders, lineitem = C.make_q12(N_ORDERS, SEED)
    want = C.q12_reference(orders, lineitem)
    assert [r[0] for r in want] == ["MAIL", "SHIP"]
    return orders, lineitem, want


def arrays(orders, lineitem):
    """The tables with their strings as ``str`` arrays."""
    return ({k: (C.q12_strings(v, C.Q12_PRIORITIES)
                 if k == "o_orderpriority" else v)
             for k, v in orders.items()},
            {k: (C.q12_strings(v, C.Q12_SHIPMODES) if k == "l_shipmode"
                 else v) for k, v in lineitem.items()})


def memory_q12(mod, types, session, orders, lineitem):
    oa, la = arrays(orders, lineitem)
    _, _, ors, lrs = C.q12_schemas(types)
    return C.q12_query(frame(mod, session, oa, ors),
                       frame(mod, session, la, lrs), mod)


def reference_plans(tmp_path, conf, files=None, n_orders=N_ORDERS):
    """The reference's explain of Q12 before a collect (planning compiles
    nothing; the device manager built from ``conf`` first, as bench does),
    from memory (``n_orders`` orders) or from ``files`` (orders,
    lineitem)."""
    out = run_jax(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    from torch_port_frames import frame
    get_device_manager(TpuConf({conf!r}))
    s = RS.TpuSession({conf!r})
    _, _, ors, lrs = C.q12_schemas(T)
    files = {files!r}
    if files:
        q = C.q12_query(s.read.schema(ors).parquet(*files[0]),
                        s.read.schema(lrs).parquet(*files[1]), RS)
    else:
        o, li = C.make_q12({n_orders}, {SEED})
        oa = dict(o, o_orderpriority=C.q12_strings(o["o_orderpriority"],
                                                   C.Q12_PRIORITIES))
        la = dict(li, l_shipmode=C.q12_strings(li["l_shipmode"],
                                               C.Q12_SHIPMODES))
        q = C.q12_query(frame(RS, s, oa, ors), frame(RS, s, la, lrs), RS)
    out["plan"] = np.array(C.plan_shape(q))
    """, tmp_path)
    return list(out["plan"])


def before_collect(lines):
    """``chip_smoke.q12_plan``'s lines as the explain shows them before the
    adaptive join has decided."""
    return [re.sub(r" decided=\w+\(<bytes>\)$", "", ln) for ln in lines]


# conf -> the plan the reference makes of Q12 at N_ORDERS orders
_MEMORY_CONFS = {
    "broadcast_planned": ({}, C.q12_plan(broadcast_planned=True)),
    "adaptive_broadcast": ({"spark.sql.autoBroadcastJoinThreshold":
                            100_000}, C.q12_plan(100_000, "broadcast")),
    "adaptive_shuffled": ({"spark.sql.autoBroadcastJoinThreshold": 1000},
                          C.q12_plan(1000, "shuffled")),
    "no_aqe": ({"spark.sql.autoBroadcastJoinThreshold": "-1",
                "spark.sql.adaptive.enabled": False}, None),
}


@pytest.mark.parametrize("case", list(_MEMORY_CONFS))
def test_q12_from_memory(q12_tables, tmp_path, case):
    orders, lineitem, want = q12_tables
    conf, plan = _MEMORY_CONFS[case]
    if "broadcast_planned" in case:
        # a join broadcast at planning: the reference fuses it with the
        # aggregate, a fusion the port does not port (its unfused plan)
        conf = dict(conf, **{"spark.rapids.tpu.joinAggFusion.enabled":
                             False})
    q = memory_q12(S, T, S.TpuSession(conf, device="cpu"), orders, lineitem)
    ref = reference_plans(tmp_path, conf)
    assert C.plan_shape(q) == ref
    if plan is not None:
        assert ref == before_collect(plan)
    assert q.collect() == want
    assert q.collect() == want                 # a second run agrees
    if plan is not None:
        assert C.plan_shape(q) == plan
    if case.startswith("adaptive"):
        # the adaptive join measured the filtered lines, 22 bytes each
        line = [ln for ln in q.explain().splitlines()
                if "decided=" in ln][0]
        assert line.endswith(f"({C.q12_build_bytes(lineitem)}B)")


def test_q12_oracle_from_memory(q12_tables):
    orders, lineitem, want = q12_tables
    oracle = memory_q12(RS, RT, RS.TpuSession(ORACLE), orders, lineitem)
    assert oracle.collect() == want


@pytest.fixture(scope="module")
def q12_files(q12_tables, tmp_path_factory):
    orders, lineitem, want = q12_tables
    return C.write_q12_files(orders, lineitem,
                             str(tmp_path_factory.mktemp("q12")), CPU,
                             n_files=3)


@pytest.mark.parametrize("reader", ["AUTO", "PERFILE", "COALESCING",
                                    "MULTITHREADED"])
def test_q12_from_parquet_under_each_reader_type(q12_tables, q12_files,
                                                 monkeypatch, reader):
    orders, lineitem, want = q12_tables
    o_paths, l_paths, _ = q12_files
    from spark_rapids_tpu_torch.pallas import decode

    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    _, _, ors, lrs = C.q12_schemas(T)
    s = S.TpuSession(dict(C.Q12_CONF, **{
        "spark.rapids.sql.format.parquet.reader.type": reader}),
        device="cpu")
    q = C.q12_query(s.read.schema(ors).parquet(*o_paths),
                    s.read.schema(lrs).parquet(*l_paths), S)
    assert q.collect() == want
    assert calls[0] == C.dict_chunks(o_paths, ors) + C.dict_chunks(
        l_paths, lrs) == 3 * 2 + 3 * 5
    assert C.plan_shape(q) == C.q12_plan(broadcast_planned=True)


def test_q12_from_parquet(q12_tables, q12_files, tmp_path, monkeypatch):
    orders, lineitem, want = q12_tables
    from spark_rapids_tpu_torch.pallas import decode

    o_paths, l_paths, plain = q12_files
    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    _, _, ors, lrs = C.q12_schemas(T)
    q = C.q12_query(S.TpuSession(C.Q12_CONF, device="cpu").read.schema(ors)
                    .parquet(*o_paths),
                    S.TpuSession(C.Q12_CONF, device="cpu").read.schema(lrs)
                    .parquet(*l_paths), S)
    assert q.collect() == want
    assert calls[0] == C.dict_chunks(o_paths, ors) + C.dict_chunks(
        l_paths, lrs) == 3 * 2 + 3 * 5
    planned = C.q12_plan(broadcast_planned=True)
    assert C.plan_shape(q) == planned
    # a join broadcast at planning is fused with the aggregate in the
    # reference, a fusion the port does not port: its unfused plan
    assert reference_plans(tmp_path, dict(C.Q12_CONF, **{
        "spark.rapids.tpu.joinAggFusion.enabled": False}),
        (o_paths, l_paths)) == planned
    _, _, rors, rlrs = C.q12_schemas(RT)
    r = RS.TpuSession(ORACLE)
    oracle = C.q12_query(r.read.schema(rors).parquet(*o_paths),
                         r.read.schema(rlrs).parquet(*l_paths), RS)
    assert oracle.collect() == want
    # the hot-table cache keeps the string columns and counts their bytes
    hot = S.TpuSession(dict(C.Q12_CONF, **{
        "spark.rapids.tpu.scan.hotTableCache.enabled": True}), device="cpu")
    scan = hot.read.schema(ors).parquet(*o_paths)
    first = scan.collect()
    calls[0] = 0
    assert scan.collect() == first and calls[0] == 0
    from spark_rapids_tpu_torch.io.hot_cache import get_hot_cache
    cached = get_hot_cache().stats()["bytes"]
    n = len(first)
    assert cached == n * (8 + 1) + n * (32 + 4 + 1)  # key; 15-byte strings
    assert hot.close() == []
    # the PLAIN-string orders file: the host length walk, exact
    got = S.TpuSession(C.Q12_CONF, device="cpu").read.schema(ors).parquet(
        plain).collect()
    n = len(got)
    assert got == list(zip(orders["o_orderkey"][:n].tolist(),
                           C.q12_strings(orders["o_orderpriority"][:n],
                                         C.Q12_PRIORITIES)))


def test_q12_out_of_core_frames_carry_strings(tmp_path):
    """Phase 20's conf at test size: 50,000 orders under a 512 KiB pool,
    so both exchanges are sized past their 16 planned partitions, and a
    64 KiB device budget for the queues, so their slices frame to the host
    as TKU2 blocks with the string columns in them."""
    from spark_rapids_tpu_torch import perfcounters as PC

    orders, lineitem = C.make_q12(OOC_ORDERS, SEED)
    want = C.q12_reference(orders, lineitem)
    conf = dict(C.ooc_conf(1 << 19, len(lineitem["l_orderkey"])), **{
        "spark.rapids.tpu.exchange.deviceResidentBytes": 1 << 16})
    s = S.TpuSession(conf, device="cpu")
    q = memory_q12(S, T, s, orders, lineitem)
    plan = C.plan_shape(q)
    ref = reference_plans(tmp_path, conf, n_orders=OOC_ORDERS)
    assert sum("sized" in ln for ln in plan) == 2
    # the lineitem exchange, over the filter, is sized from an upper bound
    # of its input rows: the port's is every scanned row (22 bytes each);
    # the reference sums the distinct capacity buckets of its scan's
    # batches (a set), which is smaller (ROADMAP Queue 3)
    n = len(lineitem["l_orderkey"])
    assert f"(est {22 * n}B)]" in plan[8]
    est = int(re.search(r"est (\d+)B", ref[8])[1])
    assert est < 22 * n and est % 22 == 0
    assert plan[:8] + plan[9:] == ref[:8] + ref[9:]
    snap = PC.snapshot()
    assert q.collect() == want
    d = PC.since(snap)
    assert d["exchange_host_blocks"] > 0
    assert q.collect() == want
    assert s.close() == []

"""TPC-H Q4 (an EXISTS planned as a left semi join) and its twins on the
same tables — the NOT EXISTS left anti join, and the quarter's orders
right and full outer joined to the late lines — on the port
(``device="cpu"``) at 5,000 orders from ``chip_smoke.py``'s generator,
against ``chip_smoke.q4_reference`` (numpy) and the JAX package's CPU
oracle session: from memory under an adaptive join that decides
``shuffled``, from the Parquet files ``chip_smoke.py`` writes (phase
19's), and from memory under phase 22's out-of-core conf with a small
pool, where the join sub-partitions.  The plans equal the reference's
(planned in the child process) and ``chip_smoke.q4_plan``.  Every
comparison is exact."""
import sys

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
SEED = 20261017
HOWS = ["left_semi", "left_anti", "right", "full"]
ADAPTIVE = {"spark.sql.autoBroadcastJoinThreshold": 1000}


@pytest.fixture(scope="module")
def q4_tables():
    orders, lineitem = C.make_q12(N_ORDERS, SEED)
    return orders, lineitem


def memory_q4(mod, types, session, orders, lineitem, how):
    oa = dict(orders, o_orderpriority=C.q12_strings(
        orders["o_orderpriority"], C.Q12_PRIORITIES))
    ors, lrs = C.q4_schemas(types)
    return C.q4_query(frame(mod, session, oa, ors),
                      frame(mod, session, lineitem, lrs), mod, how)


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain of Q4 and its twins from memory under
    ``ADAPTIVE``, before a collect, in one child call."""
    out = run_jax(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    from test_torch_q4 import memory_q4
    get_device_manager(TpuConf({ADAPTIVE!r}))
    s = RS.TpuSession({ADAPTIVE!r})
    o, li = C.make_q12({N_ORDERS}, {SEED})
    for how in {HOWS!r}:
        q = memory_q4(RS, T, s, o, li, how)
        out[how] = np.array(C.plan_shape(q))
        out[how + "_schema"] = np.array([q.schema.simpleString])
    """, tmp_path_factory.mktemp("q4ref"))
    return out


@pytest.mark.parametrize("how", HOWS)
def test_q4_from_memory(q4_tables, reference_plans, how):
    orders, lineitem = q4_tables
    want = C.q4_reference(orders, lineitem, how)
    q = memory_q4(S, T, S.TpuSession(ADAPTIVE, device="cpu"), orders,
                  lineitem, how)
    assert C.plan_shape(q) == list(reference_plans[how])
    assert q.schema.simpleString == str(reference_plans[how + "_schema"][0])
    assert q.collect() == want
    assert q.collect() == want                 # a second run agrees
    assert C.plan_shape(q) == C.q4_plan(how, 1000)
    line = [ln for ln in q.explain().splitlines() if "decided=" in ln][0]
    assert line.endswith(f"({C.q4_build_bytes(lineitem)}B)")
    if how == "left_anti":
        semi = dict(C.q4_reference(orders, lineitem))
        odate = orders["o_orderdate"]
        inq = (odate >= C.Q4_QUARTER[0]) & (odate < C.Q4_QUARTER[1])
        assert sum(semi.values()) + sum(c for _, c in want) == inq.sum()
    oracle = memory_q4(RS, RT, RS.TpuSession(ORACLE), orders, lineitem, how)
    assert oracle.collect() == want


def test_q4_from_parquet(q4_tables, tmp_path, monkeypatch):
    """Phase 21's path at test size: Q4 and its anti twin from the files,
    K1 once for each dictionary chunk of the columns read; the join
    broadcast at planning (the files are small)."""
    from spark_rapids_tpu_torch.pallas import decode

    orders, lineitem = q4_tables
    o_paths, l_paths, _ = C.write_q12_files(orders, lineitem, str(tmp_path),
                                            torch.device("cpu"), n_files=2)
    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    ors, lrs = C.q4_schemas(T)
    for how in ("left_semi", "left_anti"):
        calls[0] = 0
        q = C._q4_files_query(o_paths, l_paths, how, C.Q12_CONF, "cpu")
        assert q.collect() == C.q4_reference(orders, lineitem, how)
        assert calls[0] == C.dict_chunks(o_paths, ors) + C.dict_chunks(
            l_paths, lrs) == 2 * 3 + 2 * 3
        assert C.plan_shape(q) == C.q4_plan(how, broadcast_planned=True)


def test_q4_out_of_core_sub_partitions(q4_tables):
    """Phase 22's out-of-core conf at test size: a 1 MiB pool with a 64
    KiB batch goal (no broadcast, no adaptive execution), so the built
    late lines of 20,000 orders (several hundred KB) exceed the goal;
    exact twice, >= 2 buckets, nothing leaks."""
    orders, lineitem = C.make_q12(20_000, SEED)
    for how in ("left_semi", "left_anti"):
        want = C.q4_reference(orders, lineitem, how)
        n = len(lineitem["l_orderkey"])
        conf = dict(C.ooc_conf(1 << 20, n),
                    **{"spark.rapids.sql.batchSizeBytes": 1 << 16})
        s = S.TpuSession(conf, device="cpu")
        ors, lrs = C.q4_schemas(T)

        def fr(table, sch):
            from spark_rapids_tpu_torch.plan.nodes import LocalTableScan
            return S.DataFrame(LocalTableScan(C.q12_host_columns(
                table, sch, 0, len(table[sch.fields[0].name])), sch), s)

        q = C.q4_query(fr(orders, ors), fr(lineitem, lrs), S, how)
        assert q.collect() == want
        assert q.collect() == want
        join = q._planned().children[0].children[0]
        assert join.sub_partitions >= 2
        assert s.close() == []

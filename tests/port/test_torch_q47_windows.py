"""Phases 32-33's five queries (``chip_smoke.py``) on the port
(``device="cpu"``) at about 1/1,000 of SF10: a TPC-DS Q47-shaped query,
moving ROWS and RANGE frames and per-item statistics over bench's
store_sales (28,800 rows; 20 items, so that Q47's item-store months are
as dense as at SF10's 100,000 items over 28.8 M rows), order histories
and customer phones over TPC-H's orders and customer (15,000 and 1,500
rows).  From memory: rows against the JAX package's CPU oracle session
(doubles to 12 significant digits; the moving frames over 2,000 rows, the
oracle's bounded frames being O(rows x frame)) and against
``chip_smoke``'s numpy references and checks; plans against the
reference device session's (planned in the child process, one call for
the module) with its window-chain and join-aggregate fusions written
unfused (ROADMAP item D6) and ``chip_smoke``'s plan constants.  From the
Parquet files ``chip_smoke.py`` writes: phases 32-33's functions, K1 once
a dictionary chunk."""
import re
import sys

import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

SS_ROWS = 28_800
MOVING_ROWS = 2_000
N_ITEMS = 20
SCALE = 0.01                       # 1,500 customers, 15,000 orders
SEED = 11
QUERIES = ["q47", "moving", "stats", "orders_history", "customer_phones"]
PLANS = {"q47": C.Q47_PLAN, "moving": C.MOVING_PLAN, "stats": C.STATS_PLAN,
         "orders_history": C.HISTORY_PLAN,
         "customer_phones": C.PHONES_PLAN}


def store_sales(n):
    saved = C.N_ITEMS
    C.N_ITEMS = N_ITEMS
    try:
        return C.make_store_sales(n)
    finally:
        C.N_ITEMS = saved


def data():
    """(store_sales, date_dim, customer, orders) as phases 9 and 27 draw
    them (fewer items, a smaller text pool)."""
    customer, orders = C.make_customer_orders(
        SCALE, SEED, C.text_pool(SEED + 1, 1 << 16))
    chars, lens = customer["c_phone"]
    customer["c_phone"] = C.TextColumn(lens, chars)
    return store_sales(SS_ROWS), C.make_date_dim(), customer, orders


@pytest.fixture(scope="module")
def tables():
    return data()


def build(name, mod, types, session, d):
    ss, dd, customer, orders = d
    table, _, dsch = C.qa_schemas(types)
    if name == "q47":
        return C.q47_query(frame(mod, session, ss, table),
                           frame(mod, session, dd, dsch), mod)
    if name == "moving":
        few = {k: v[:MOVING_ROWS] for k, v in ss.items()}
        return C.moving_query(frame(mod, session, few, table), mod)
    if name == "stats":
        return C.stats_query(frame(mod, session, ss, table), mod)
    sch = C.tpch_all_schemas(types)
    if name == "orders_history":
        osch = types.StructType([f for f in sch["orders"].fields
                                 if f.name in C.HISTORY_READS["orders"]])
        return C.history_query(frame(mod, session, orders, osch), mod)
    cust = dict(customer, c_phone=customer["c_phone"].strings())
    return C.phones_query(frame(mod, session, cust, sch["customer"]), mod)


def session(mod):
    if mod is S:
        return S.TpuSession({}, device="cpu")
    return RS.TpuSession({})


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain of every query from memory, in one child
    call."""
    return run_jax(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import test_torch_q47_windows as M
    get_device_manager(TpuConf({{}}))
    d = M.data()
    for name in {QUERIES!r}:
        q = M.build(name, RS, T, M.session(RS), d)
        out[name] = np.array(C.plan_shape(q))
        out[name + "_schema"] = np.array([q.schema.simpleString])
    """, tmp_path_factory.mktemp("q47ref"))


def unfuse(lines):
    """The reference's fused operators written as the port runs them:
    ``TpuWindowChainFused[W -> FilterProject]`` as the stage over the
    window, ``TpuJoinAggFused[A <- J]`` as the aggregate over the join,
    each member one level under the one above it and the fused node's
    subtree under its last member."""
    out, stack = [], []        # (indent of the fused node, extra shift)
    for ln in (str(x) for x in lines):
        pad = len(ln) - len(ln.lstrip())
        while stack and pad <= stack[-1][0]:
            stack.pop()
        extra = sum(s for _, s in stack)
        m = re.fullmatch(r"(TpuWindowChainFused|TpuJoinAggFused)\[(.*)\]",
                         ln.strip())
        if not m:
            out.append(" " * (pad + extra) + ln.lstrip())
            continue
        window = m.group(1) == "TpuWindowChainFused"
        members = m.group(2).split(" -> " if window else " <- ")
        if window:
            members = members[::-1]
        members = ["TpuStageExec[FilterProject]" if x == "FilterProject"
                   else x for x in members]
        out += [" " * (pad + extra + 2 * i) + x
                for i, x in enumerate(members)]
        stack.append((pad, 2 * (len(members) - 1)))
    return out


def want(name, d):
    ss, dd, customer, orders = d
    if name == "q47":
        return C.q47_reference(ss, dd)
    if name == "moving":
        few = {k: v[:MOVING_ROWS] for k, v in ss.items()}
        return {**C.moving_rows_reference(few),
                **C.moving_range_reference(few)}
    if name == "stats":
        return C.stats_reference(ss)
    if name == "orders_history":
        return C.history_reference(orders)
    return C.phones_reference(customer)


def check(name, q, expected):
    """``chip_smoke``'s check of each query on the port's result."""
    if name == "q47":
        return C.q47_check(q.collect(), expected)
    cols = q.collect_host()
    names = q.schema.field_names()
    if name == "moving":
        return C._check_columns(cols, names, expected, C.MOVING_COLS)
    if name == "stats":
        return C.stats_check(cols, expected)
    if name == "orders_history":
        return C._check_columns(cols, names, expected, C.HISTORY_COLS)
    return C.phones_check(cols, names, expected)


@pytest.mark.parametrize("name", QUERIES)
def test_queries_from_memory(name, tables, reference_plans):
    """Rows equal numpy (``chip_smoke``'s checks), twice, and the
    reference's oracle; the plan the reference's (its fusions unfused)
    and ``chip_smoke``'s."""
    q = build(name, S, T, session(S), tables)
    assert C.plan_shape(q) == unfuse(reference_plans[name]) \
        == PLANS[name]
    assert q.schema.simpleString == str(reference_plans[name + "_schema"][0])
    expected = want(name, tables)
    assert check(name, q, expected) is None
    assert check(name, q, expected) is None
    got = q.collect()
    if name == "q47":
        assert len(got) == C.Q47_LIMIT
    oracle = build(name, RS, RT, RS.TpuSession(ORACLE), tables).collect()
    ordered = name != "stats"           # a window keeps its input's order
    assert rows_key(got, True, ordered) == rows_key(oracle, True, ordered)


def test_phases_from_parquet(tables, tmp_path, monkeypatch):
    """Phases 32-33's functions at test size on the files
    ``chip_smoke.py`` writes: K1 against its plain version on item_sk's
    index tables, every query exact against numpy, its plan
    ``chip_smoke``'s, K1 once a dictionary chunk (the card's
    synchronisations, the peak-memory reads and the profiled collect
    stubbed; the CPU path counts K1's launches through a wrapper)."""
    from spark_rapids_tpu_torch.pallas import decode

    ss, dd, customer, orders = tables
    dev = torch.device("cpu")
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    real = decode.unpack_runs

    def counting(*a, **k):
        decode.unpack_launches += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    monkeypatch.setattr(C, "profile_collect", lambda collect, w, label, key:
                        None if key(collect()) is None else 1 / 0)
    ss_paths, dd_path = C.write_qa_files(ss, dd, SS_ROWS, str(tmp_path),
                                         dev)
    tabs = C.window_tables(customer, orders)
    refs = C.tpch_references(tabs)
    w32 = C.run_store_windows(C.store_references(ss, dd), ss, ss_paths,
                              dd_path, dev, "cpu")
    assert w32["k1_err"] == 0
    assert {k: v["launches"] for k, v in w32.items() if k != "k1_err"} == {
        "q47": 36, "moving": 56, "stats": 24}
    sch = C.tpch_all_schemas(T)
    osch = T.StructType([f for f in sch["orders"].fields
                         if f.name in C.HISTORY_READS["orders"]])
    paths = {"customer": C.write_tpch_files(
        "customer", customer, {}, sch["customer"], str(tmp_path), dev, 2),
        "orders": C.write_tpch_files("orders", orders, {}, osch,
                                     str(tmp_path), dev, 2)}
    w33 = C.run_tpch_windows(refs, paths, tabs, dev, "cpu")
    assert w33["orders_history"]["launches"] == 6
    assert w33["customer_phones"]["launches"] == 8

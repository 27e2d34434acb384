"""The query lifecycle of the port (``lifecycle/``), as
``tests/test_lifecycle.py`` holds the JAX package's: every collect runs
under ``query_lifecycle`` with a query id and a trace id; a cancel and a
deadline unwind a query mid-exchange with the reference's exceptions; the
query's cleanup closes its spillables and drops its shuffle registrations
(releasing what it placed on distributed workers) however it ends; and
admission bounds concurrent queries.  The port runs on ``device="cpu"``."""
import sys
import threading
import time

import pytest
import torch

import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.lifecycle import (QueryCancelled,
                                              QueryDeadlineExceeded,
                                              QueryRejected, current,
                                              leak_report_all,
                                              query_lifecycle,
                                              reset_leaked_state)
from spark_rapids_tpu_torch.memory.spill import get_spill_framework
from spark_rapids_tpu_torch.shuffle.manager import get_shuffle_manager
from torch_port_jaxref import REPO

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

N = 20_000
# 16 hash partitions kept on one device, through the shuffle manager
MANAGER_CONF = dict(C.dist_conf(N), **{
    "spark.rapids.tpu.distributed.enabled": False,
    "spark.rapids.tpu.shuffle.singleDeviceCoalesce": False,
    "spark.rapids.tpu.exchange.spill.enabled": False})


def _query(conf):
    fact, dim = C.make_dist(N)
    s = S.TpuSession(conf, device="cpu")
    return C.ooc_query(*C.ooc_frames(S, s, fact, dim), S), \
        C.dist_reference(fact, dim)


def _unwind(conf, trip, exc_type, monkeypatch):
    """Collect with ``trip(ctx, map_id)`` called before each map output
    the shuffle manager writes; the collect must raise ``exc_type``,
    after which nothing of the query is left."""
    from spark_rapids_tpu_torch.shuffle import manager as M

    write = M.TpuShuffleManager.write_map_output
    seen = {}

    def traced(self, sid, map_id, slices):
        seen.setdefault("ctx", current())
        seen.setdefault("sids", set()).add(sid)
        trip(current(), map_id)
        return write(self, sid, map_id, slices)

    monkeypatch.setattr(M.TpuShuffleManager, "write_map_output", traced)
    q, _ = _query(conf)
    snap = PC.snapshot()
    with pytest.raises(exc_type):
        q.collect()
    assert current() is None
    assert seen["ctx"] is not None and seen["sids"]
    assert leak_report_all() == []
    assert not set(get_shuffle_manager().active_shuffles()) & seen["sids"]
    return PC.since(snap)


def test_collect_runs_under_the_lifecycle(monkeypatch):
    """Each collect gets its own query id and trace id, the query context
    is gone after it, and the rows are exact."""
    from spark_rapids_tpu_torch.shuffle import manager as M

    write = M.TpuShuffleManager.write_map_output
    ctxs = []

    def traced(self, sid, map_id, slices):
        ctxs.append(current())
        return write(self, sid, map_id, slices)

    monkeypatch.setattr(M.TpuShuffleManager, "write_map_output", traced)
    q, want = _query(MANAGER_CONF)
    ids = []
    for _ in range(2):
        snap = PC.snapshot()
        del ctxs[:]
        assert C.ooc_rows(q.collect()) == want
        assert PC.since(snap)["queries_admitted"] == 1
        assert ctxs and len({id(c) for c in ctxs}) == 1
        ids.append((ctxs[0].query_id, ctxs[0].trace_id))
    assert ids[0][0] != ids[1][0] and ids[0][1] != ids[1][1]
    assert current() is None
    assert leak_report_all() == []


def test_cancel_unwinds_mid_exchange(monkeypatch):
    """A cancel tripped after the second map output raises QueryCancelled
    at the next check, counted once."""
    def trip(ctx, map_id):
        if map_id == 2:
            ctx.cancel("test cancel")

    d = _unwind(MANAGER_CONF, trip, QueryCancelled, monkeypatch)
    assert d["queries_cancelled"] == 1


def test_deadline_unwinds_mid_exchange(monkeypatch):
    """A 150 ms deadline passes while map outputs are slowed to 20 ms
    each: the watchdog trips the token and the exchange raises
    QueryDeadlineExceeded."""
    conf = dict(MANAGER_CONF, **{"spark.rapids.tpu.query.timeoutMs": 150,
                                 "spark.rapids.tpu.query.watchdogPeriodMs":
                                     10})

    def slow(ctx, map_id):
        assert ctx.deadline_ns is not None
        time.sleep(0.02)

    d = _unwind(conf, slow, QueryDeadlineExceeded, monkeypatch)
    assert d["deadline_trips"] == 1 and d["queries_cancelled"] == 1


def test_cleanup_releases_what_an_unwind_left():
    """What a query registers and tracks and never releases — a shuffle
    registration, a spillable handle — is gone once its lifecycle exits
    on an error; what no query owns stays, in the leak report, until
    ``reset_leaked_state`` closes it."""
    conf = TpuConf({})
    fw = get_spill_framework(conf, "cpu")
    mgr = get_shuffle_manager(conf)
    schema = T.StructType([T.StructField("x", T.LONG)])
    batch = ColumnarBatch([DeviceColumn(T.LONG, torch.ones(4, dtype=bool),
                                        data=torch.arange(4))], 4, schema)
    outside = fw.track(batch)
    with pytest.raises(RuntimeError, match="mid-batch"):
        with query_lifecycle(conf) as ctx:
            sid = mgr.register_shuffle()
            h = fw.track(batch)
            assert h.owner_qid == ctx.query_id
            raise RuntimeError("mid-batch")
    assert sid not in mgr.active_shuffles()
    assert h.closed and not outside.closed
    assert leak_report_all() == [
        f"LEAK: DEVICE handle {outside.device_bytes}B"]
    reset_leaked_state()
    assert outside.closed and leak_report_all() == []


def test_admission_rejects_past_the_queue():
    """With one query admitted and no room to queue, a second collect is
    rejected before planning; once the first ends, it runs."""
    conf = dict(MANAGER_CONF, **{"spark.rapids.tpu.concurrentQueries": 1,
                                 "spark.rapids.tpu.admission.maxQueueDepth":
                                     0})
    holding, done = threading.Event(), threading.Event()

    def hold():
        with query_lifecycle(TpuConf(conf)):
            holding.set()
            done.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    try:
        assert holding.wait(10)
        q, want = _query(conf)
        snap = PC.snapshot()
        with pytest.raises(QueryRejected) as exc:
            q.collect()
        assert exc.value.queue_depth == 0
        assert PC.since(snap)["queries_rejected"] == 1
    finally:
        done.set()
        t.join(10)
    assert C.ooc_rows(q.collect()) == want

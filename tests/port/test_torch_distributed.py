"""The distributed tier of the port (``distributed/``), as
``tests/test_distributed.py`` holds the JAX package's: the TKD1 protocol,
the worker's partition store, the engine's lineage queue, coordinator
membership, heartbeat liveness and loss declaration, wire ids, the
flapping-worker quarantine, elastic membership and the remote-partition
leak report — and the acceptance case, bench's rung4_dist query with a
worker SIGKILLed mid-shuffle, exact against numpy's ``cpu_dist`` and the
reference's CPU oracle session, its plan the reference's.  TKD1 frames and
TKU2 blocks cross between the two packages both ways, byte for byte (the
reference's side runs in the child process of ``torch_port_jaxref.py``).
Workers are real processes (``python -m
spark_rapids_tpu_torch.distributed.worker``) or in-process servers; the
port runs on ``device="cpu"``."""
import os
import signal
import socket
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.distributed import protocol as P
from spark_rapids_tpu_torch.distributed.worker import (PartitionStore,
                                                       WorkerServer)
from spark_rapids_tpu_torch.lifecycle import leak_report_all
from torch_port_frames import ORACLE
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

N_DIST = 20_000

_DIST_CONF = dict(C.dist_conf(N_DIST), **{
    "spark.rapids.tpu.distributed.workerLostMs": 500,
    "spark.rapids.tpu.distributed.workerMemoryBytes": 64 << 10})


@pytest.fixture
def coordinator():
    """A fresh coordinator (and breaker) for the test, torn down after it
    with every worker process the test registered in ``.procs``."""
    from spark_rapids_tpu_torch import distributed as D
    from spark_rapids_tpu_torch.distributed import client as DC
    from spark_rapids_tpu_torch.resilience.breaker import reset_breaker

    reset_breaker()
    D.reset_coordinator()
    coord = D.get_coordinator(TpuConf(_DIST_CONF))
    coord.procs = []
    try:
        yield coord
    finally:
        DC.TEST_SHIP_HOOK = None
        C.stop_dist_workers(coord.procs)
        D.reset_coordinator()
        reset_breaker()


def _spawn(coord, wid, mem_bytes=None):
    from spark_rapids_tpu_torch.distributed import spawn_local_worker

    p = spawn_local_worker(coord, wid, mem_bytes=mem_bytes)
    coord.procs.append(p)
    return p


def _server(coord, wid):
    w = WorkerServer(("127.0.0.1", coord.port), wid, heartbeat_ms=100)
    w.start()
    return w


def _wait(pred, timeout_s=10.0, period=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return pred()


def _dist_query(mod, session, n=N_DIST):
    fact, dim = C.make_dist(n)
    return C.ooc_query(*C.ooc_frames(mod, session, fact, dim), mod)


# ---------------------------------------------------------------------------
# protocol, store, lineage queue
# ---------------------------------------------------------------------------

def test_protocol_roundtrip_and_crc_rejection():
    """A frame decodes to its header and blobs; over a socket, a flipped
    payload bit raises ProtocolCorruption; a reply answering another
    request raises ProtocolDesync (a transient ConnectionError)."""
    frame = P.encode_msg({"op": "put", "exch": 3, "pid": 1, "seq": 0},
                         [b"abc", b"defgh"])
    header, blobs = P.decode_payload(frame[12:])
    assert header["op"] == "put" and blobs == [b"abc", b"defgh"]
    a, b = socket.socketpair()
    try:
        bad = bytearray(frame)
        bad[-3] ^= 0x10
        a.sendall(bytes(bad))
        with pytest.raises(P.ProtocolCorruption, match="CRC"):
            P.recv_msg(b)
        a.sendall(frame)
        assert P.recv_msg(b) == (dict(header, blobs=[3, 5]),
                                 [b"abc", b"defgh"])
        P.send_msg(a, {"rid": -1})
        with pytest.raises(P.ProtocolDesync):
            P.request(b, {"op": "ping"})
    finally:
        a.close()
        b.close()


def test_partition_store_overflow_release_idempotent(tmp_path):
    st = PartitionStore(mem_bytes=1000, spill_dir=str(tmp_path))
    assert st.put(1, 0, 0, b"a" * 600) == "mem"
    assert st.put(1, 0, 1, b"b" * 600) == "disk"     # over the budget
    assert st.put(1, 0, 1, b"b" * 600) == "dup"      # idempotent re-drive
    st.put(1, 1, 0, b"c" * 100)
    assert st.stats()["spilled_blocks"] == 1
    seqs, blobs, n_total = st.fetch(1, 0)
    assert seqs == [0, 1] and n_total == 2
    assert blobs == [b"a" * 600, b"b" * 600]
    # a byte budget pages the partition out, at least one block a page
    s1, _, n1 = st.fetch(1, 0, max_bytes=100)
    assert s1 == [0] and n1 == 2
    s2, _, _ = st.fetch(1, 0, after_seq=s1[-1], max_bytes=100)
    assert s2 == [1]
    assert st.fetch(1, 0, after_seq=s2[-1], max_bytes=100)[0] == []
    assert st.release(1) == 3
    assert st.fetch(1, 0) == ([], [], 0)
    assert st.stats()["blocks"] == 0 and list(tmp_path.iterdir()) == []
    st.close()


def test_lineage_queue_host_overflow_spills_to_disk(tmp_path):
    """The engine's lineage queue bounds its host memory: blocks past
    ``host_budget`` go to files, ``peek_blobs`` reads them back unchanged
    without draining, and release and close remove them."""
    from spark_rapids_tpu_torch.shuffle.partition_queues import (
        SpillBackedPartitionQueues)

    schema = T.StructType([T.StructField("x", T.LONG)])
    q = SpillBackedPartitionQueues(2, schema, device_budget=0,
                                   host_budget=1000,
                                   spill_dir=str(tmp_path))
    blobs = [bytes([i]) * 600 for i in range(4)]
    for i, b in enumerate(blobs):
        q.append_framed(i % 2, b)
    assert len(list(tmp_path.iterdir())) == 3     # 600 B fit, 3 overflow
    assert q.peek_blobs(0) == [blobs[0], blobs[2]]
    assert q.peek_blobs(1) == [blobs[1], blobs[3]]
    q.release_partition(0)
    assert q.peek_blobs(0) == []
    q.close()
    assert list(tmp_path.iterdir()) == []


def test_frames_cross_packages_byte_for_byte(tmp_path):
    """TKD1: the port's and the reference's ``encode_msg`` write the same
    bytes, and each side's ``decode_payload`` reads the other's frame.
    TKU2: a rung4_dist slice framed by the port (``ici_host_frame``)
    equals the reference's frame of the same rows, byte for byte, under
    no codec and zlib, and each side decodes the other's (the port with
    ``deserialize_concat``, the reference with ``ici_host_unframe``)."""
    from spark_rapids_tpu_torch.exec.ici import ici_host_frame
    from spark_rapids_tpu_torch.shuffle.serializer import deserialize_concat

    header = {"op": "put", "exch": 7, "pid": 3, "seq": 2, "rid": 11,
              "trace": "18b-1f-3"}
    blobs = [b"\x00\x01", b"tku2" * 9]
    mine = P.encode_msg(header, blobs)
    fact, _ = C.make_dist(1000)
    schema = T.StructType([T.StructField("k", T.INT, False),
                           T.StructField("v", T.LONG, False)])
    batch = ColumnarBatch(
        [DeviceColumn(f.dataType, torch.ones(1000, dtype=torch.bool),
                      data=torch.from_numpy(fact[f.name]))
         for f in schema.fields], 1000, schema)
    port_tku2 = {c: ici_host_frame(batch, codec=c) for c in ("none", "zlib")}
    inp = {"frame": np.frombuffer(mine, np.uint8),
           "k": fact["k"], "v": fact["v"]}
    inp.update({"tku2_" + c: np.frombuffer(b, np.uint8)
                for c, b in port_tku2.items()})
    out = run_jax(f"""
        import json
        import jax.numpy as jnp
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.columnar.batch import ColumnarBatch
        from spark_rapids_tpu.columnar.column import DeviceColumn
        from spark_rapids_tpu.distributed import protocol as P
        from spark_rapids_tpu.exec.ici import ici_host_frame, ici_host_unframe
        frame = inp["frame"].tobytes()
        h, b = P.decode_payload(frame[12:])
        out["header"] = np.frombuffer(json.dumps(h, sort_keys=True).encode(),
                                      np.uint8)
        out["blob1"] = np.frombuffer(b[1], np.uint8)
        out["ref_frame"] = np.frombuffer(P.encode_msg({header!r},
                                                      {blobs!r}), np.uint8)
        sch = T.StructType([T.StructField("k", T.INT, False),
                            T.StructField("v", T.LONG, False)])
        n = len(inp["k"])
        bt = ColumnarBatch([DeviceColumn(f.dataType,
                                         jnp.ones(n, dtype=bool),
                                         data=jnp.asarray(inp[f.name]))
                            for f in sch.fields], n, sch)
        for c in ("none", "zlib"):
            out["ref_tku2_" + c] = np.frombuffer(ici_host_frame(bt, codec=c),
                                                 np.uint8)
            got = ici_host_unframe(inp["tku2_" + c].tobytes(), sch, codec=c)
            out["k_" + c] = np.asarray(got.columns[0].data)[:got.num_rows]
            out["v_" + c] = np.asarray(got.columns[1].data)[:got.num_rows]
    """, tmp_path, inp)
    import json

    assert json.loads(out["header"].tobytes()) == dict(header, blobs=[2, 36])
    assert out["blob1"].tobytes() == blobs[1]
    assert out["ref_frame"].tobytes() == mine
    assert P.decode_payload(out["ref_frame"].tobytes()[12:]) == (
        dict(header, blobs=[2, 36]), blobs)
    for c, blob in port_tku2.items():
        assert out["ref_tku2_" + c].tobytes() == blob
        np.testing.assert_array_equal(out["k_" + c], fact["k"])
        np.testing.assert_array_equal(out["v_" + c], fact["v"])
        got = deserialize_concat([out["ref_tku2_" + c].tobytes()], schema,
                                 codec=c, device="cpu")
        np.testing.assert_array_equal(got.columns[0].data.numpy(),
                                      fact["k"])
        np.testing.assert_array_equal(got.columns[1].data.numpy(),
                                      fact["v"])


# ---------------------------------------------------------------------------
# coordinator: errors, wire ids, membership, liveness
# ---------------------------------------------------------------------------

def test_remote_op_error_declares_loss_not_deterministic(coordinator):
    """A worker that answers but cannot serve is treated as a dead
    socket: the coordinator declares it lost and raises WorkerLost (the
    WORKER_LOST class), never a bare error that would classify
    DETERMINISTIC."""
    from spark_rapids_tpu_torch.distributed.protocol import WorkerLost
    from spark_rapids_tpu_torch.resilience.classify import (
        WORKER_LOST, classify_failure)

    w = _server(coordinator, "re0")
    try:
        assert coordinator.wait_for_workers(1)
        with pytest.raises(WorkerLost) as exc:
            coordinator._request("re0", {"op": "no-such-op"})
        assert classify_failure(exc.value) == WORKER_LOST
        assert coordinator.worker_state("re0") == "LOST"
    finally:
        w.stop(goodbye=False)


def test_wire_ids_never_reused_across_replacement(coordinator):
    """The same exchange id placed twice gets two wire ids, so a stale
    block of the first placement is never visible to the second."""
    w = _server(coordinator, "wi0")
    try:
        assert coordinator.wait_for_workers(1)
        coordinator.place(0, 1, est_bytes=64)
        first = coordinator._wire(0)
        coordinator.put_block(0, 0, 0, b"stale" * 10)
        coordinator.release_exchange(0)
        coordinator.place(0, 1, est_bytes=64)
        assert coordinator._wire(0) != first
        assert coordinator.fetch_blocks(0, 0) == ([], [], 0)
        coordinator.release_exchange(0)
    finally:
        w.stop(goodbye=True)


def test_membership_join_leave_and_dead_socket(coordinator):
    """A clean GOODBYE leaves as LEFT with no loss; a control socket
    closed without one is a loss (LOST, ``worker_lost``)."""
    snap = PC.snapshot()
    w0 = _server(coordinator, "m0")
    w1 = _server(coordinator, "m1")
    assert coordinator.wait_for_workers(2)
    assert PC.since(snap)["workers_joined"] == 2
    w0.stop(goodbye=True)
    assert _wait(lambda: coordinator.worker_state("m0") == "LEFT")
    assert PC.since(snap)["worker_lost"] == 0
    w1.stop(goodbye=False)
    assert _wait(lambda: coordinator.worker_state("m1") == "LOST")
    assert _wait(lambda: PC.since(snap)["worker_lost"] == 1)


def test_heartbeat_silence_declares_lost(coordinator):
    """A SIGSTOPped worker keeps its sockets open but stops heartbeating
    and answering: the monitor counts it late, its ping fails twice, and
    it is declared LOST; with no survivor its partition waits for a
    re-drive."""
    p = _spawn(coordinator, "hb0")
    assert coordinator.wait_for_workers(1, timeout_s=30)
    coordinator.place(11, 3, est_bytes=3000)
    coordinator.put_block(11, 0, 0, b"z" * 64)
    snap = PC.snapshot()
    os.kill(p.pid, signal.SIGSTOP)
    try:
        assert _wait(lambda: coordinator.worker_state("hb0") == "LOST",
                     timeout_s=15)
    finally:
        os.kill(p.pid, signal.SIGCONT)
    assert _wait(lambda: PC.since(snap)["worker_lost"] == 1)
    assert PC.since(snap)["worker_heartbeat_misses"] >= 1
    assert _wait(lambda: coordinator.redrive_backlog() >= 1)
    coordinator.release_exchange(11)


def test_flapping_worker_quarantined_until_ttl_probe(coordinator):
    """A lost worker rejoining under its id is QUARANTINED (heartbeats,
    never placed) until the breaker TTL admits a probe; a served probe
    closes the entry."""
    from spark_rapids_tpu_torch.distributed.coordinator import BREAKER_OP
    from spark_rapids_tpu_torch.resilience.breaker import get_breaker

    w = _server(coordinator, "flap")
    assert coordinator.wait_for_workers(1)
    w.stop(goodbye=False)
    assert _wait(lambda: coordinator.worker_state("flap") == "LOST")
    assert get_breaker().state_of((BREAKER_OP, "flap")) == "OPEN"
    w2 = _server(coordinator, "flap")
    try:
        assert _wait(
            lambda: coordinator.worker_state("flap") == "QUARANTINED")
        assert coordinator.placeable_workers() == []
        assert coordinator.live_worker_count() == 0
        ttl = coordinator.breaker_ttl_s
        base = time.monotonic()
        get_breaker()._now = lambda: base + ttl + 1.0
        assert [x.worker_id for x in coordinator.placeable_workers()] \
            == ["flap"]
        assert coordinator.worker_state("flap") == "ALIVE"
        coordinator.note_worker_ok("flap")
        assert get_breaker().state_of((BREAKER_OP, "flap")) == "CLOSED"
    finally:
        w2.stop(goodbye=True)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def test_rung4_dist_survives_sigkill_mid_shuffle(coordinator, tmp_path):
    """The acceptance case: bench's rung4_dist query at 20,000 rows over
    two worker processes with 4,096-byte stores (bench's rule floors them
    there), about 40 times smaller than the shuffle, ``bench0`` SIGKILLed
    at the 5th shipped block.  Rows equal numpy's ``cpu_dist`` and the
    reference's CPU oracle session; the plan keeps both hash exchanges,
    as the reference's does (its explain, planned in the child process);
    a worker is lost, partitions are replayed, blocks were shipped, the
    survivor served the read, and nothing leaks."""
    from spark_rapids_tpu_torch.distributed import client as DC

    mem = C.dist_worker_mem(N_DIST)
    procs = {w: _spawn(coordinator, w, mem_bytes=mem)
             for w in C.DIST_WORKERS}
    assert coordinator.wait_for_workers(2, timeout_s=30)
    fact, dim = C.make_dist(N_DIST)
    want = C.dist_reference(fact, dim)
    oracle = C.ooc_rows(_dist_query(RS, RS.TpuSession(ORACLE)).collect())
    assert oracle == want
    ref_plan = run_jax(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu.config import TpuConf
        from spark_rapids_tpu.memory.device_manager import get_device_manager
        conf = C.dist_conf({N_DIST})
        get_device_manager(TpuConf(conf))
        fact, dim = C.make_dist({N_DIST})
        df = C.ooc_query(*C.ooc_frames(RS, RS.TpuSession(conf), fact, dim),
                         RS)
        out["plan"] = np.array(df.explain().splitlines())
    """, tmp_path)["plan"].tolist()
    q = _dist_query(S, S.TpuSession(_DIST_CONF, device="cpu"))
    assert q.explain().splitlines() == ref_plan
    assert C.plan_shape(q) == C.DIST_PLAN
    shipped = {"n": 0}

    def hook(exch, pid, seq):
        shipped["n"] += 1
        if shipped["n"] == C.DIST_KILL_AT:
            procs["bench0"].kill()

    snap = PC.snapshot()
    DC.TEST_SHIP_HOOK = hook
    try:
        rows = q.collect()
    finally:
        DC.TEST_SHIP_HOOK = None
    d = PC.since(snap)
    assert C.ooc_rows(rows) == want
    assert d["worker_lost"] == 1
    assert d["partitions_replayed"] >= 1
    assert d["dist_blocks_shipped"] > 0
    assert d["dist_block_bytes"] >= 40 * mem, d["dist_block_bytes"]
    assert coordinator.worker_state("bench0") == "LOST"
    assert coordinator.worker_state("bench1") == "ALIVE"
    assert leak_report_all() == []
    # a second, healthy collect on the survivor: exact, no hedge won
    snap = PC.snapshot()
    assert C.ooc_rows(q.collect()) == want
    d = PC.since(snap)
    assert d["hedges_won"] == 0 and d["worker_lost"] == 0
    assert d["dist_blocks_shipped"] > 0
    # both stores spilled; stopping the workers leaves no spill directory
    spill = [os.path.join(tempfile.gettempdir(), f"srt_dist_worker_{p.pid}")
             for p in procs.values()]
    assert os.path.isdir(spill[1])
    C.stop_dist_workers(procs.values())
    assert not any(os.path.exists(x) for x in spill)


def test_elastic_membership_between_queries(coordinator):
    """With a worker the exchange ships its blocks; with none placeable it
    runs in process (zero workers is a state, not an error); a fresh
    worker brings the distributed path back.  All three answer the
    same.  Each spawned store is ``workerMemoryBytes`` in size."""
    fact, dim = C.make_dist(N_DIST)
    want = C.dist_reference(fact, dim)

    def run():
        snap = PC.snapshot()
        q = _dist_query(S, S.TpuSession(_DIST_CONF, device="cpu"))
        assert C.ooc_rows(q.collect()) == want
        return PC.since(snap)["dist_blocks_shipped"]

    p = _spawn(coordinator, "e0")
    assert coordinator.wait_for_workers(1, timeout_s=30)
    assert coordinator._workers["e0"].mem_bytes == 64 << 10
    assert run() > 0
    p.kill()
    assert _wait(lambda: coordinator.worker_state("e0") == "LOST",
                 timeout_s=15)
    assert run() == 0
    _spawn(coordinator, "e1")
    assert coordinator.wait_for_workers(1, timeout_s=30)
    assert run() > 0


def test_remote_partition_leak_reported_and_released(coordinator):
    """An exchange placed and never released shows in
    ``leak_report_all``; unregistering its shuffle releases the remote
    blocks."""
    from spark_rapids_tpu_torch.shuffle.manager import get_shuffle_manager

    w = _server(coordinator, "lk0")
    try:
        assert coordinator.wait_for_workers(1)
        mgr = get_shuffle_manager(TpuConf(_DIST_CONF))
        sid = mgr.register_shuffle()
        coordinator.place(sid, 2, est_bytes=128)
        coordinator.put_block(sid, 0, 0, b"x" * 64)
        leaks = leak_report_all()
        assert any("distributed exchange" in ln for ln in leaks), leaks
        assert any(f"shuffle {sid} still registered" in ln
                   for ln in leaks), leaks
        assert w.store.stats()["blocks"] == 1
        mgr.unregister_shuffle(sid)
        assert leak_report_all() == []
        assert _wait(lambda: w.store.stats()["blocks"] == 0)
    finally:
        w.stop(goodbye=True)


def test_trace_ids_reach_the_workers(coordinator):
    """With ``traceEnabled`` every data-plane frame carries the query's
    trace id, the worker records its puts, fetches and release as spans of
    that trace, and its heartbeats bring them to the coordinator
    (``collect_trace``); with it off a query leaves no span."""
    from spark_rapids_tpu_torch.distributed import client as DC
    from spark_rapids_tpu_torch.lifecycle import current

    w = _server(coordinator, "tr0")
    try:
        assert coordinator.wait_for_workers(1)
        traces = []
        DC.TEST_SHIP_HOOK = lambda e, p, s: traces.append(current().trace_id)
        for on in (True, False):
            coordinator.trace_enabled = on
            q = _dist_query(S, S.TpuSession(_DIST_CONF, device="cpu"))
            q.collect()
        DC.TEST_SHIP_HOOK = None
        on_id, off_id = traces[0], traces[-1]
        assert on_id != off_id

        def kinds(trace_id):
            return {e["kind"] for v in coordinator.collect_trace(trace_id)
                    for e in v["ring"]}

        assert _wait(lambda: {"put", "fetch", "release"} <= kinds(on_id))
        assert kinds(off_id) == set()
        view, = coordinator.collect_trace()
        assert view["worker_id"] == "tr0" and view["pid"] == os.getpid()
        assert view["counters"]["store_puts"] > 0
    finally:
        w.stop(goodbye=True)


def test_slow_fetch_is_hedged_from_the_lineage_copy(coordinator):
    """A worker whose first page fetch of a query stalls past its soft
    deadline (the 50 ms floor): the page is served from the engine's
    retained copy and the straggler's answer dropped (``fetch_hedges``,
    ``hedges_won``), the rows exact; with hedging off the same stall costs
    time, not rows."""
    w = _server(coordinator, "slow0")
    handle = w._handle
    stalls = {"left": 0}

    def stalled(h, blobs):
        if h.get("op") == "fetch" and h.get("max_bytes") != 1 \
                and stalls["left"] > 0:
            stalls["left"] -= 1
            time.sleep(0.3)
        return handle(h, blobs)

    w._handle = stalled
    try:
        assert coordinator.wait_for_workers(1)
        fact, dim = C.make_dist(N_DIST)
        want = C.dist_reference(fact, dim)
        for hedge in (True, False):
            coordinator.hedge_enabled = hedge
            stalls["left"] = 1
            q = _dist_query(S, S.TpuSession(_DIST_CONF, device="cpu"))
            snap = PC.snapshot()
            assert C.ooc_rows(q.collect()) == want
            d = PC.since(snap)
            assert (d["hedges_won"] >= 1) == hedge
            assert d["hedges_won"] == d["fetch_hedges"]
            assert d["worker_lost"] == 0
    finally:
        w.stop(goodbye=True)

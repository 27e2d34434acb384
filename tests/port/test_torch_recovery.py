"""Crash-consistent driver recovery of the port, as
``tests/test_recovery.py`` and ``tests/test_stress_harness.py::
test_driver_kill_twin`` hold the JAX package's, on ``device="cpu"``, with
bench's rung5_recovery query at 20,000 rows (``chip_smoke.run_rung5``'s
data and conf): a query killed right after a stage commit resumes by
serving the committed stages, not re-executing them; one killed before any
commit re-executes cleanly; a failed commit never fails the query; with
recovery off no call reaches the journal module; a re-attaching worker
clears its stale breaker entry and raises the wire-id counter; a worker
that outlived its coordinator re-attaches with its inventory, and its
blocks can be adopted and released; and the driver-kill twin (two real
worker processes, two ``chip_smoke.py --driver-incarnation --device cpu``
processes, the first SIGKILLed at its first stage commit).  Rows equal
numpy and the reference's CPU oracle session; the plan and the number of
``ckpt`` records equal the reference's (its side in the child process of
``torch_port_jaxref.py``)."""
import cProfile
import os
import socket
import sys
import time

import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.exec import exchange as EX
from spark_rapids_tpu_torch.lifecycle import journal as JM
from spark_rapids_tpu_torch.lifecycle import leak_report_all
from torch_port_frames import ORACLE
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

N_REC = 20_000


class _Crash(BaseException):
    """A driver's death inside the process (nothing swallows it)."""


@pytest.fixture
def rec_root(tmp_path):
    root = str(tmp_path / "recovery")
    try:
        yield root
    finally:
        JM.TEST_RECORD_HOOK = None
        JM.reset_journal(purge=True)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's plan and ``ckpt`` record count for the
    checkpointing conf, and its CPU oracle's rows."""
    tmp = tmp_path_factory.mktemp("rung5_ref")
    out = run_jax(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu.config import TpuConf
        from spark_rapids_tpu.lifecycle import journal as JM
        from spark_rapids_tpu.memory.device_manager import get_device_manager
        conf = C.rec_conf({str(tmp / "rec")!r}, True, checkpointing=True)
        get_device_manager(TpuConf(conf))
        fact, dim = C.make_dist({N_REC}, C.REC_SEED)
        df = C.ooc_query(*C.ooc_frames(RS, RS.TpuSession(conf), fact, dim),
                         RS)
        kinds = []
        JM.TEST_RECORD_HOOK = lambda kind, n: kinds.append(kind)
        rows = df.collect()
        JM.TEST_RECORD_HOOK = None
        JM.reset_journal(purge=True)
        out["plan"] = np.array(df.explain().splitlines())
        out["kinds"] = np.array(kinds)
        out["rows"] = np.array(sorted(rows), dtype=np.int64)
    """, tmp)
    fact, dim = C.make_dist(N_REC, C.REC_SEED)
    oracle = C.ooc_rows(C.ooc_query(*C.ooc_frames(
        RS, RS.TpuSession(ORACLE), fact, dim), RS).collect())
    return {"plan": out["plan"].tolist(), "kinds": out["kinds"].tolist(),
            "rows": C.ooc_rows(out["rows"].tolist()), "oracle": oracle}


def _query(root, rec_on=True, checkpointing=True):
    fact, dim = C.make_dist(N_REC, C.REC_SEED)
    conf = C.rec_conf(root, rec_on, checkpointing)
    return C.ooc_query(*C.ooc_frames(S, S.TpuSession(conf, device="cpu"),
                                     fact, dim), S)


def _want():
    return C.dist_reference(*C.make_dist(N_REC, C.REC_SEED))


def _crash_at(root, kind: str, n_at: int):
    """Collect with the journal's hook raising _Crash at the ``n_at``-th
    record of ``kind``, and no end record (a killed process writes
    none)."""
    state = {"n": 0}

    def hook(k, _n):
        if k == kind:
            state["n"] += 1
            if state["n"] == n_at:
                raise _Crash()

    orig_end = JM.journal_end
    JM.TEST_RECORD_HOOK = hook
    JM.journal_end = lambda *a, **k: None
    try:
        with pytest.raises(_Crash):
            _query(root).collect()
    finally:
        JM.TEST_RECORD_HOOK = None
        JM.journal_end = orig_end


def test_rung5_plan_records_and_rows_match_reference(reference, rec_root):
    """The checkpointing conf plans the reference's plan (two 8-partition
    hash exchanges), a journaled collect writes the reference's records
    (one ``ckpt`` per exchange), and the rows equal numpy, the
    reference's device session and its CPU oracle."""
    want = _want()
    assert reference["oracle"] == reference["rows"] == want
    q = _query(rec_root)
    assert q.explain().splitlines() == reference["plan"]
    assert C.plan_shape(q) == C.REC_PLAN
    kinds = []
    JM.TEST_RECORD_HOOK = lambda kind, n: kinds.append(kind)
    assert C.ooc_rows(q.collect()) == want
    assert kinds == reference["kinds"] == ["admit", "plan", "ckpt", "ckpt",
                                           "end"]
    assert leak_report_all() == []
    assert not os.listdir(os.path.join(rec_root, "checkpoints"))


@pytest.mark.parametrize("kill_at", [1, 2])
def test_crash_after_commit_resumes_without_reexecution(kill_at, reference,
                                                        rec_root,
                                                        monkeypatch):
    """Killed right after its ``kill_at``-th stage commit (bench kills at
    the first, the reference's test at the second), the restarted driver
    classifies the query resumable and serves exactly the committed stages
    from their checkpoints; the others execute.  Nothing leaks and no
    checkpoint is left behind."""
    _crash_at(rec_root, "ckpt", kill_at)
    left = [ln for ln in leak_report_all() if "recovery" not in ln]
    assert left == [], "the in-process kill left state behind"
    JM.reset_journal()                     # the restart
    executed = {"n": 0}
    orig = EX.TpuShuffleExchangeExec._execute_spill_backed

    def counting(self, ckpt=None):
        executed["n"] += 1
        return orig(self, ckpt)

    monkeypatch.setattr(EX.TpuShuffleExchangeExec, "_execute_spill_backed",
                        counting)
    before = PC.snapshot()
    rows = _query(rec_root).collect()
    d = PC.since(before)
    assert C.ooc_rows(rows) == reference["oracle"] == _want()
    assert "resumable" in JM.recovery_report().values()
    assert d["stages_recovered"] == kill_at
    assert d["queries_resumed"] == 1
    assert executed["n"] == 2 - kill_at
    assert JM.peek_journal().leak_lines() == []
    assert leak_report_all() == []


def test_crash_before_any_commit_reexecutes_cleanly(rec_root):
    _crash_at(rec_root, "plan", 1)
    JM.reset_journal()
    before = PC.snapshot()
    rows = _query(rec_root).collect()
    assert C.ooc_rows(rows) == _want()
    assert list(JM.recovery_report().values()) == ["abandoned"]
    assert PC.since(before)["stages_recovered"] == 0
    assert JM.peek_journal().leak_lines() == []


def test_failed_commit_never_fails_the_query(rec_root, monkeypatch):
    """A checkpoint that cannot be written leaves the stage
    uncheckpointed: the query's rows are exact, no ckpt record is
    journaled, and a restart has nothing to adopt."""
    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(JM, "_write_local_checkpoint", broken)
    kinds = []
    JM.TEST_RECORD_HOOK = lambda kind, n: kinds.append(kind)
    assert C.ooc_rows(_query(rec_root).collect()) == _want()
    assert kinds == ["admit", "plan", "end"]
    JM.reset_journal()
    assert C.ooc_rows(_query(rec_root).collect()) == _want()
    assert JM.peek_journal().recovery.pending == {}


def test_recovery_off_makes_zero_journal_calls():
    q = _query("unused", rec_on=False)
    prof = cProfile.Profile()
    prof.enable()
    rows = q.collect()
    prof.disable()
    assert C.ooc_rows(rows) == _want()
    jfile = os.path.join("lifecycle", "journal.py")
    offenders = sorted({
        f"{e.code.co_filename}:{e.code.co_name}"
        for e in prof.getstats()
        if hasattr(e.code, "co_filename")
        and e.code.co_filename.endswith(jfile)})
    assert not offenders, offenders
    assert JM.peek_journal() is None


# ---------------------------------------------------------------------------
# re-attach: the breaker, the wire-id floor, the inventory
# ---------------------------------------------------------------------------

_COORD_CONF = {"spark.rapids.tpu.distributed.enabled": True,
               "spark.rapids.tpu.distributed.heartbeatMs": 100,
               "spark.rapids.tpu.distributed.workerLostMs": 500,
               "spark.rapids.tpu.distributed.opTimeoutMs": 1000}


def test_reattach_clears_stale_breaker_entry():
    """A re-HELLO with a held inventory clears the dead incarnation's
    breaker entry and lifts the wire-id counter past every held id; a
    plain rejoin is still quarantined."""
    from spark_rapids_tpu_torch import distributed as D
    from spark_rapids_tpu_torch.distributed.coordinator import (
        ALIVE, BREAKER_OP, QUARANTINED)
    from spark_rapids_tpu_torch.resilience.breaker import (get_breaker,
                                                           reset_breaker)

    reset_breaker()
    D.reset_coordinator()
    coord = D.get_coordinator(TpuConf(_COORD_CONF))
    socks = []

    def hello(wid, held):
        a, b = socket.socketpair()
        socks.extend((a, b))
        coord._admit(wid, "127.0.0.1", {"data_port": 1, "pid": 0,
                                        "mem_bytes": 1 << 20,
                                        "held": held}, a)

    try:
        for wid in ("w_stale", "w_flappy"):
            get_breaker().record_failure((BREAKER_OP, wid), 1,
                                         reason="worker lost: crash")
        hello("w_flappy", [])
        assert coord.worker_state("w_flappy") == QUARANTINED
        hello("w_stale", [[9, 0, 3, 2]])
        assert coord.worker_state("w_stale") == ALIVE
        assert get_breaker().consult((BREAKER_OP, "w_stale"), 3600) is None
        assert coord.worker_inventory()["w_stale"] == [(9, 0, 3, 2)]
        assert next(coord._wire_ids) > 9
    finally:
        for s in socks:
            s.close()
        D.reset_coordinator()
        reset_breaker()


def _wait(pred, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def test_worker_reattaches_to_the_next_coordinator(rec_root):
    """A worker that outlived its coordinator re-dials the endpoint the
    next one publishes under the recovery dir, with the inventory of its
    blocks; the new coordinator mints wire ids above them, adopts the
    exchange under its old wire id and serves its blocks, and releases
    the orphans; the worker's store is then empty."""
    from spark_rapids_tpu_torch import distributed as D
    from spark_rapids_tpu_torch.distributed.worker import WorkerServer
    from spark_rapids_tpu_torch.resilience.breaker import reset_breaker

    conf = TpuConf(dict(_COORD_CONF, **{
        "spark.rapids.tpu.recovery.enabled": True,
        "spark.rapids.tpu.recovery.dir": rec_root}))
    reset_breaker()
    D.reset_coordinator()
    endpoint = os.path.join(rec_root, JM.ENDPOINT_NAME)
    first = D.get_coordinator(conf)
    assert JM.read_endpoint(rec_root) == ("127.0.0.1", first.port)
    w = WorkerServer(None, "w0", heartbeat_ms=50, op_timeout_ms=1000,
                     reattach_ms=20_000, endpoint_file=endpoint)
    w.start()
    try:
        assert first.wait_for_workers(1, timeout_s=10)
        for exch in (1, 2):
            first.place(exch, 2)
            for seq in range(3):
                first.put_block(exch, 1, seq, b"blk%d%d" % (exch, seq))
        old = {first.wire_of(1), first.wire_of(2)}
        D.reset_coordinator()              # the driver dies
        second = D.get_coordinator(conf)
        assert second.port != first.port
        assert _wait(lambda: second.worker_inventory().get("w0"))
        held = second.worker_inventory()["w0"]
        assert {h[0] for h in held} == old
        assert all(h[1:] == (1, 3, 2) for h in held)
        keep, drop = first.wire_of(1), first.wire_of(2)
        assert next(second._wire_ids) > max(keep, drop)
        second.adopt_exchange(keep, {1: "w0"}, {1: 3})
        seqs, blobs, n = second.fetch_blocks(keep, 1)
        assert (seqs, n) == ([0, 1, 2], 3)
        assert blobs == [b"blk1%d" % s for s in range(3)]
        # the lease kept, the orphan released
        assert second.release_orphan_holdings({keep}) == 1
        assert second.worker_stats("w0")["blocks"] == 3
        second.release_exchange(keep)
        assert second.worker_stats("w0")["blocks"] == 0
        assert second.leak_report() == []
    finally:
        w.stop()
        D.reset_coordinator()
        reset_breaker()


# ---------------------------------------------------------------------------
# the driver-kill twin: real processes, a real SIGKILL
# ---------------------------------------------------------------------------

def test_driver_kill_twin():
    """Two worker processes outlive driver incarnation 1, SIGKILLed right
    after its first stage commit (a lease on their blocks); incarnation 2
    re-attaches them, classifies the crashed query resumable, serves the
    committed stage from the workers, leaves no block on them and leaks
    nothing (``chip_smoke.run_driver_kill`` pins all of it); its rows
    equal the reference's CPU oracle."""
    n = N_REC
    (res,) = C.run_driver_kill([("ckpt:1", n, C.DK_WORKER_MEM)], "cpu",
                               "cpu", "driver kill twin")
    r = res["result"]
    fact, dim = C.make_driver_kill(n)
    oracle = C.ooc_rows(C.ooc_query(*C.ooc_frames(
        RS, RS.TpuSession(ORACLE), fact, dim), RS).collect())
    assert {g: sv for g, sv in r["rows"] if sv} == oracle \
        == C.dist_reference(fact, dim, C.DK_GROUPS)
    assert r["counters"]["stages_recovered"] >= 1
    assert r["counters"]["queries_resumed"] >= 1
    assert "resumable" in r["recovery"].values()
    assert r["stranded_blocks"] == 0 and r["leaks"] == []
    assert r["unpack_launches"] == 0


def test_driver_incarnation_needs_the_card_it_is_given(tmp_path):
    """``chip_smoke.py --driver-incarnation --device cuda`` exits 2 on a
    machine without a card, before it builds a coordinator."""
    import subprocess

    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--driver-incarnation", "--device", "cuda", "--recovery-dir",
         str(tmp_path), "--result-out", str(tmp_path / "r.json")],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 2, proc.stderr
    assert "no CUDA device" in proc.stderr
    assert not os.path.exists(tmp_path / "r.json")
    assert not os.listdir(tmp_path)

"""The durable query journal of the port (``lifecycle/journal.py``) against
the JAX package's: TKJ1 frames byte for byte, the trusted prefix of a
damaged WAL (a torn tail, a flipped bit, a record of a newer schema
version), and a WAL with local checkpoints written by either package
replayed and loaded by the other with the same classification.  The
reference's side runs in the child process of ``torch_port_jaxref.py``
(it compiles nothing).  Then the reference's ``tests/test_recovery.py``
journal cases on the port alone: damage degrades to re-execution, the
classification and the carry-forward across two restarts, lease expiry,
a damaged checkpoint and an orphaned checkpoint dir."""
import json
import os
import shutil
import textwrap
import time

import numpy as np
import pytest

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.lifecycle import journal as JM
from torch_port_jaxref import run_jax

RECS = [
    {"kind": "admit", "q": "qa", "trace": "t-1", "conf_fp": "c" * 40,
     "conf": {"spark.sql.shuffle.partitions": "8"}, "v": 1, "ts": 1.25},
    {"kind": "plan", "q": "qa", "plan_fp": "p" * 40, "v": 1, "ts": 1.5},
    {"kind": "ckpt", "ckind": "local", "q": "qa", "fp": "f" * 40,
     "parts": {"0": 3, "1": 0}, "expires": 9.75, "v": 1, "ts": 2.0},
    {"kind": "ckpt", "ckind": "lease", "q": "qa", "fp": "e" * 40,
     "wire": 7, "placement": {"0": "w0", "1": "w1"},
     "counts": {"0": 2, "1": 5}, "expires": 9.75, "v": 1, "ts": 2.5},
    {"kind": "served", "fp": "f" * 40, "q": "qb", "v": 1, "ts": 3.0},
    {"kind": "end", "q": "qa", "status": "ok", "v": 1, "ts": 3.5},
]


@pytest.fixture
def rec_root(tmp_path):
    root = str(tmp_path / "recovery")
    try:
        yield root
    finally:
        JM.TEST_RECORD_HOOK = None
        JM.reset_journal(purge=True)


def _delta(before, key):
    return PC.snapshot()[key] - before[key]


def _ref(tmp_path, *parts, inputs=None) -> dict:
    """Run reference journal code (``parts``, each dedented on its own) in
    the child; ``res`` (a JSON-able dict) comes back."""
    code = "".join(textwrap.dedent(p) for p in (
        """
        import json, os, shutil
        from spark_rapids_tpu.config import TpuConf
        from spark_rapids_tpu.lifecycle import journal as JM
        res = {}
        """,) + parts + ("""
        out["res"] = np.array(json.dumps(res))
        """,))
    out = run_jax(code, tmp_path, inputs)
    return json.loads(str(out["res"]))


# ---------------------------------------------------------------------------
# TKJ1 framing against the reference
# ---------------------------------------------------------------------------

def test_tkj1_frames_byte_equal_to_reference(tmp_path):
    """The same records frame to the same bytes in both packages, and each
    package parses the other's frames back to the records."""
    port = b"".join(JM.frame_record(r) for r in RECS)
    res = _ref(tmp_path, f"""
        recs = {RECS!r}
        data = b"".join(JM.frame_record(r) for r in recs)
        res["frames"] = data.hex()
        res["parsed"], res["damaged"] = JM.parse_frames(
            bytes.fromhex({port.hex()!r}))
    """)
    assert bytes.fromhex(res["frames"]) == port
    assert res == {"frames": port.hex(), "parsed": RECS, "damaged": False}
    assert JM.parse_frames(bytes.fromhex(res["frames"])) == (RECS, False)


def _damaged(kind: str) -> bytes:
    data = bytearray(b"".join(JM.frame_record(r) for r in RECS))
    if kind == "truncated":
        return bytes(data[:-3])
    if kind == "bitflip":
        # rot inside the third record's payload
        off = sum(len(JM.frame_record(r)) for r in RECS[:2]) + 20
        data[off] ^= 0x10
        return bytes(data)
    if kind == "bad_magic":
        off = sum(len(JM.frame_record(r)) for r in RECS[:4])
        data[off] ^= 0xFF
        return bytes(data)
    newer = dict(RECS[3], v=JM.SCHEMA_VERSION + 1)
    return b"".join(JM.frame_record(r) for r in RECS[:3] + [newer]
                    + RECS[4:])


@pytest.mark.parametrize("kind", ["truncated", "bitflip", "bad_magic",
                                  "newer_version"])
def test_damaged_wal_same_trusted_prefix_as_reference(kind, tmp_path):
    data = _damaged(kind)
    recs, damaged = JM.parse_frames(data)
    res = _ref(tmp_path, """
        res["recs"], res["damaged"] = JM.parse_frames(
            inp["data"].tobytes())
    """, inputs={"data": np.frombuffer(data, np.uint8)})
    want = {"truncated": 5, "bitflip": 2, "bad_magic": 4,
            "newer_version": 3}[kind]
    assert damaged and res["damaged"]
    assert recs == res["recs"] == RECS[:want]


# ---------------------------------------------------------------------------
# WALs and local checkpoints cross between the packages
# ---------------------------------------------------------------------------

# the same journal, in either package: a completed query, one with a
# committed local stage and one without, and a lease record
_WRITE = """
j = JM.QueryJournal({root!r})
j.admit("q_done", "t1", TpuConf({{"spark.sql.shuffle.partitions": 8}}))
j.end("q_done", "ok")
j.admit("q_resume", "t2", TpuConf({{}}))
assert j.commit_local_stage("b" * 40, "q_resume",
                            {{0: [b"x", b"zz"], 1: [], 2: [b"yy"]}})
j.admit("q_lease", "t3", TpuConf({{}}))
j.commit_lease("d" * 40, "q_lease", 9, {{0: "w0"}}, {{0: 3}})
j.admit("q_lost", "t4", TpuConf({{}}))
j.close()
"""

_REPLAY = """
j = JM.QueryJournal({root!r})
st = j.recovery
hit = j.lookup_stage("b" * 40)
replay = {{"classification": st.classification,
           "pending": sorted(st.pending),
           "lease": {{k: st.pending["d" * 40][k]
                     for k in ("ckind", "wire", "placement", "counts")}},
           "local": {{str(p): [b.hex() for b in bl]
                     for p, bl in hit[1].items()}}}}
j.close(purge=True)
"""


def _port(code: str, root: str) -> dict:
    scope = {"JM": JM, "TpuConf": TpuConf}
    exec(code.format(root=root), scope)
    return scope.get("replay")


_WANT = {"classification": {"q_done": "completed", "q_resume": "resumable",
                            "q_lease": "resumable", "q_lost": "abandoned"},
         "pending": ["b" * 40, "d" * 40],
         "lease": {"ckind": "lease", "wire": 9, "placement": {"0": "w0"},
                   "counts": {"0": 3}},
         "local": {"0": [b"x".hex(), b"zz".hex()], "1": [],
                   "2": [b"yy".hex()]}}


def test_port_wal_and_checkpoint_replay_in_reference(tmp_path, rec_root):
    """A WAL and a local checkpoint the port wrote replay in the reference
    (and in the port, on a copy) to the same classification, the same
    pending stages and the same checkpoint blocks; the admit records of
    both packages agree but for the clock."""
    _port(_WRITE, rec_root)
    copy = str(tmp_path / "copy")
    shutil.copytree(rec_root, copy)
    res = _ref(tmp_path, _WRITE.format(root=str(tmp_path / "ref")), f"""
        res["ref_admit"] = JM.parse_frames(open(os.path.join(
            {str(tmp_path / "ref")!r}, "journal.wal"), "rb").read())[0][0]
    """, _REPLAY.format(root=rec_root), """
        res["replay"] = replay
    """)
    assert res["replay"] == _WANT
    assert _port(_REPLAY, copy) == _WANT
    # the admit records agree but for the clock (the conf fingerprint is
    # the same digest of the same settings)
    ours = str(tmp_path / "ours")
    _port(_WRITE, ours)
    with open(os.path.join(ours, "journal.wal"), "rb") as f:
        port_admit = JM.parse_frames(f.read())[0][0]
    assert {k: v for k, v in port_admit.items() if k != "ts"} \
        == {k: v for k, v in res["ref_admit"].items() if k != "ts"}
    JM.QueryJournal(ours).close(purge=True)


def test_reference_wal_and_checkpoint_replay_in_port(tmp_path, rec_root):
    """The reverse: the reference writes, the port replays."""
    copy = str(tmp_path / "copy")
    res = _ref(tmp_path, _WRITE.format(root=rec_root), f"""
        shutil.copytree({rec_root!r}, {copy!r})
    """, _REPLAY.format(root=copy), """
        res["replay"] = replay
    """)
    assert res["replay"] == _WANT
    assert _port(_REPLAY, rec_root) == _WANT


# ---------------------------------------------------------------------------
# the reference's journal cases, on the port
# ---------------------------------------------------------------------------

def _seed_journal(root, with_ckpt=True):
    j = JM.QueryJournal(root)
    j.admit("qa", "trace-a", TpuConf({}))
    if with_ckpt:
        assert j.commit_local_stage("a" * 16, "qa", {0: [b"payload-0"]})
    j.close()
    return os.path.join(root, "journal.wal")


@pytest.mark.parametrize("damage", ["truncated", "bitflip", "newer"])
def test_damaged_wal_degrades_to_reexecution(damage, rec_root):
    """A torn checkpoint record, a rotted end record or a record of a
    newer version: qa is abandoned (re-executes), nothing is pending, the
    discards are counted; no crash and nothing served."""
    if damage == "truncated":
        wal = _seed_journal(rec_root)
        with open(wal, "r+b") as f:
            f.truncate(os.path.getsize(wal) - 5)
    else:
        wal = _seed_journal(rec_root, with_ckpt=False)
        if damage == "bitflip":
            j = JM.QueryJournal(rec_root)
            j.admit("qa", "trace-a", TpuConf({}))
            j.end("qa", "ok")
            j.close()
            with open(wal, "r+b") as f:
                f.seek(os.path.getsize(wal) - 2)
                b = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([b[0] ^ 0xFF]))
        else:
            with open(wal, "ab") as f:
                f.write(JM.frame_record({"kind": "end", "q": "qa",
                                         "status": "ok",
                                         "v": JM.SCHEMA_VERSION + 1}))
    before = PC.snapshot()
    j2 = JM.QueryJournal(rec_root)
    assert j2.recovery.classification["qa"] == "abandoned"
    assert not j2.recovery.pending
    assert _delta(before, "journal_recovery_discards") >= 1
    if damage == "truncated":
        assert not os.listdir(os.path.join(rec_root, "checkpoints"))
    assert j2.leak_lines() == []
    j2.close(purge=True)


def test_classification_and_carry_forward(rec_root):
    j = JM.QueryJournal(rec_root)
    j.admit("q_done", "t1", TpuConf({}))
    j.end("q_done", "ok")
    j.admit("q_resume", "t2", TpuConf({}))
    assert j.commit_local_stage("b" * 16, "q_resume",
                                {0: [b"x"], 1: [b"yy"]})
    j.admit("q_lost", "t3", TpuConf({}))
    j.close()

    j2 = JM.QueryJournal(rec_root)
    assert j2.recovery.classification == {
        "q_done": "completed", "q_resume": "resumable",
        "q_lost": "abandoned"}
    assert j2.lookup_stage("b" * 16) == ("local", {0: [b"x"], 1: [b"yy"]})
    j2.close()
    # carried forward: a restart before the serve still finds it
    j3 = JM.QueryJournal(rec_root)
    assert j3.recovery.classification == {"q_resume": "resumable"}
    before = PC.snapshot()
    j3.mark_recovered("b" * 16, "q_new", n_parts=2)
    assert _delta(before, "stages_recovered") == 1
    assert _delta(before, "queries_resumed") == 1
    assert not j3.recovery.pending
    assert not os.listdir(os.path.join(rec_root, "checkpoints"))
    j3.close()
    # the served record supersedes it at the next restart
    j4 = JM.QueryJournal(rec_root)
    assert j4.lookup_stage("b" * 16) is None
    assert not j4.recovery.pending
    j4.close(purge=True)


def test_lease_expiry_retires_checkpoint(rec_root):
    j = JM.QueryJournal(rec_root, lease_ttl_ms=1)
    j.admit("qa", "t", TpuConf({}))
    j.commit_lease("c" * 16, "qa", wire=7, placement={0: "w0"},
                   counts={0: 3})
    assert j.commit_local_stage("e" * 16, "qa", {0: [b"z"]})
    j.close()
    time.sleep(0.05)
    before = PC.snapshot()
    j2 = JM.QueryJournal(rec_root)
    assert j2.recovery.expired == 2
    assert not j2.recovery.pending
    assert j2.recovery.classification["qa"] == "abandoned"
    assert _delta(before, "recovery_leases_expired") == 2
    assert not os.listdir(os.path.join(rec_root, "checkpoints"))
    j2.close(purge=True)


def test_retire_expired_drops_pending_checkpoints(rec_root):
    """Checkpoints adoptable at the replay are retired once their lease
    passes: the local dir is removed, the expiry counted, and a restart
    has nothing to adopt."""
    j = JM.QueryJournal(rec_root, lease_ttl_ms=300)
    j.admit("qa", "t", TpuConf({}))
    j.commit_lease("c" * 16, "qa", wire=7, placement={0: "w0"},
                   counts={0: 3})
    assert j.commit_local_stage("e" * 16, "qa", {0: [b"z"]})
    j.close()
    j2 = JM.QueryJournal(rec_root)
    assert sorted(j2.recovery.pending) == ["c" * 16, "e" * 16]
    assert j2.retire_expired() == 0
    time.sleep(0.35)
    before = PC.snapshot()
    assert j2.retire_expired() == 2
    assert _delta(before, "recovery_leases_expired") == 2
    assert not j2.recovery.pending
    assert not os.listdir(os.path.join(rec_root, "checkpoints"))
    j2.close()
    j3 = JM.QueryJournal(rec_root)
    assert not j3.recovery.pending
    j3.close(purge=True)


def test_damaged_checkpoint_and_orphan_dir_are_discarded(rec_root):
    """A part file whose bytes no longer match the manifest's CRC, and a
    checkpoint dir no journal record names: both are removed at replay
    and counted as discards; the query re-executes."""
    j = JM.QueryJournal(rec_root)
    j.admit("qa", "t", TpuConf({}))
    assert j.commit_local_stage("a" * 16, "qa", {0: [b"payload-0"]})
    j.close()
    part = os.path.join(rec_root, "checkpoints", "a" * 16, "part_0.bin")
    with open(part, "r+b") as f:
        f.seek(6)
        f.write(b"X")
    os.makedirs(os.path.join(rec_root, "checkpoints", "f" * 16))
    before = PC.snapshot()
    j2 = JM.QueryJournal(rec_root)
    assert j2.recovery.classification == {"qa": "abandoned"}
    assert _delta(before, "journal_recovery_discards") == 2
    assert not os.listdir(os.path.join(rec_root, "checkpoints"))
    j2.close(purge=True)
    assert sorted(os.listdir(rec_root)) == []


def test_record_hook_and_leak_lines(rec_root):
    """Every append counts and reaches the hook with its kind; an
    admitted query that never ended is a leak line until its end."""
    seen = []
    JM.TEST_RECORD_HOOK = lambda kind, n: seen.append((kind, n))
    before = PC.snapshot()
    j = JM.get_journal(TpuConf({"spark.rapids.tpu.recovery.dir":
                                rec_root}))
    j.admit("qa", "t", TpuConf({}))
    assert j.leak_lines() == [
        "LEAK: recovery journal query qa admitted but never ended"]
    j.end("qa", "ok")
    assert seen == [("admit", 1), ("end", 2)]
    assert _delta(before, "journal_records_written") == 2
    assert j.leak_lines() == []
    assert JM.peek_journal() is j

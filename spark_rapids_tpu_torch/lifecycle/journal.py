"""Durable query journal and stage checkpoints — crash-consistent driver
recovery (port of ``spark_rapids_tpu/lifecycle/journal.py``, stdlib only;
the reference's contract is its ``docs/recovery.md``).

* **query journal** — a write-ahead log of CRC-framed records: ``TKJ1``
  magic, the payload's CRC32 and length, then the payload (compact JSON),
  each record one ``os.write`` on an append-only descriptor, so the file
  is always prefix-consistent.  Records: admission (trace id and conf),
  plan identity (``compilecache/keys.py`` fingerprints), stage checkpoint
  commits, stage serves and query end.  The bytes are the reference's, so
  either package replays the other's journal.
* **stage checkpoints** — an exchange's materialized output made durable
  at its stage boundary.  Local: the partition queues' framed blocks land
  as length-prefixed part files under a temporary directory with a
  manifest of per-part CRCs, and the directory is renamed into place.
  Distributed: the worker-held partitions are the checkpoint, and the
  journal records a LEASE (wire exchange id, placement, per-partition
  block counts, expiry) that pins them past the driver's death.
* **recovery replay** — the next :class:`QueryJournal` opened on the same
  ``spark.rapids.tpu.recovery.dir`` rotates the dead incarnation's WAL,
  replays it (a torn tail, a flipped bit or a newer schema version ends
  the trusted prefix: ``journal_recovery_discards``), classifies every
  journaled query as completed, resumable or abandoned, retires
  checkpoints past ``recovery.leaseTtlMs`` (``recovery_leases_expired``)
  and carries the adoptable ones forward into the new WAL.  An exchange
  whose plan-stage fingerprint matches one serves the committed output
  instead of executing its child (``stages_recovered``,
  ``queries_resumed``).

With ``spark.rapids.tpu.recovery.enabled`` off no call reaches this
module.  The reference's diagnostics events (``_diag``) and its telemetry
post-mortem of a crashed incarnation (``startup_postmortem``) have no
counterpart in the port: both are no-ops here.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Set, Tuple

from spark_rapids_tpu_torch import perfcounters as PC

MAGIC = b"TKJ1"
SCHEMA_VERSION = 1

WAL_NAME = "journal.wal"
REPLAY_NAME = "journal.replay"
ENDPOINT_NAME = "coordinator.endpoint"
CHECKPOINT_DIR = "checkpoints"

LOCAL = "local"
LEASE = "lease"

COMPLETED = "completed"
RESUMABLE = "resumable"
ABANDONED = "abandoned"

# a test and harness hook: called as hook(kind, n_records_this_incarnation)
# after every WAL append, so a kill lands exactly at a record boundary
TEST_RECORD_HOOK: Optional[Callable[[str, int], None]] = None

_lock = threading.Lock()
_journal: "Optional[QueryJournal]" = None
# every recovery root a journal of this process touched (the purge sweeps
# them)
_ACTIVE_ROOTS: Set[str] = set()


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

def frame_record(rec: Dict) -> bytes:
    """One journal frame: ``MAGIC + u32 crc32(payload) + u32 len +
    payload`` (payload: compact JSON with sorted keys)."""
    payload = json.dumps(rec, sort_keys=True,
                         separators=(",", ":")).encode("utf-8")
    return (MAGIC + struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF)
            + struct.pack("<I", len(payload)) + payload)


def parse_frames(data: bytes) -> Tuple[List[Dict], bool]:
    """Replay one journal file's bytes: (records, damaged).  Parsing stops
    at the first bad magic, CRC mismatch, torn tail or record of a newer
    schema version; what came before is the trusted prefix."""
    out: List[Dict] = []
    off = 0
    n = len(data)
    while off < n:
        if n - off < 12 or data[off:off + 4] != MAGIC:
            return out, True
        crc, ln = struct.unpack_from("<II", data, off + 4)
        if n - off - 12 < ln:
            return out, True          # torn tail record
        payload = data[off + 12:off + 12 + ln]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            return out, True          # bit rot
        try:
            rec = json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return out, True
        if not isinstance(rec, dict) \
                or int(rec.get("v", 0)) > SCHEMA_VERSION:
            # written by a newer engine: nothing from here on is
            # interpretable, so degrade to full re-execution
            return out, True
        out.append(rec)
        off += 12 + ln
    return out, False


def _read_journal_file(path: str) -> Tuple[List[Dict], bool]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], True
    if not data:
        return [], False
    return parse_frames(data)


# ---------------------------------------------------------------------------
# roots and the endpoint file
# ---------------------------------------------------------------------------

def resolve_root(conf) -> str:
    from spark_rapids_tpu_torch.config import RECOVERY_DIR

    root = conf.get(RECOVERY_DIR)
    if not root:
        root = os.path.join(tempfile.gettempdir(), "srt_recovery")
    return root


def write_endpoint(root: str, host: str, port: int) -> str:
    """Publish the coordinator's control endpoint under the recovery root
    (tmp file, then rename), so workers that outlived a dead driver
    re-attach to its successor."""
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, ENDPOINT_NAME)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(f"{host}:{port}\n")
    os.replace(tmp, path)
    return path


def read_endpoint(root: str) -> Optional[Tuple[str, int]]:
    try:
        with open(os.path.join(root, ENDPOINT_NAME)) as f:
            host, port = f.read().strip().rsplit(":", 1)
        return host, int(port)
    except (OSError, ValueError):
        return None


def plan_tree_fp(node) -> tuple:
    """Plan-identity parts of one exec subtree: (class, describe) per node
    in preorder, so two child plans that share an exchange's output schema
    and partitioning key apart."""
    from spark_rapids_tpu_torch.lifecycle.context import QueryCancelled

    parts = []

    def walk(n):
        try:
            d = n.describe()
        except QueryCancelled:
            raise
        except Exception:
            d = ""
        parts.append((type(n).__name__, d))
        for c in getattr(n, "children", []) or []:
            walk(c)

    walk(node)
    return tuple(parts)


# ---------------------------------------------------------------------------
# local checkpoint store
# ---------------------------------------------------------------------------

def _ckpt_root(root: str) -> str:
    return os.path.join(root, CHECKPOINT_DIR)


def _ckpt_dir(root: str, fp: str) -> str:
    return os.path.join(_ckpt_root(root), fp)


def _write_local_checkpoint(root: str, fp: str, qid: str,
                            parts: Dict[int, List[bytes]],
                            fsync: bool) -> Dict:
    """Write one stage's partitions as length-prefixed blocks and a
    manifest under a temporary directory, then rename it into place.
    Returns the manifest; raises on an I/O failure."""
    base = _ckpt_root(root)
    os.makedirs(base, exist_ok=True)
    tmp = os.path.join(base, f".tmp.{fp}.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    manifest: Dict = {"v": SCHEMA_VERSION, "fp": fp, "q": qid,
                      "ts": time.time(), "parts": {}}
    try:
        for pid, blobs in parts.items():
            path = os.path.join(tmp, f"part_{pid}.bin")
            buf = b"".join(struct.pack("<I", len(b)) + b for b in blobs)
            with open(path, "wb") as f:
                f.write(buf)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            manifest["parts"][str(pid)] = {
                "n": len(blobs), "bytes": len(buf),
                "crc": zlib.crc32(buf) & 0xFFFFFFFF}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f, sort_keys=True)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        final = _ckpt_dir(root, fp)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        if fsync:
            dfd = os.open(base, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return manifest


def load_local_stage(root: str, fp: str
                     ) -> Optional[Dict[int, List[bytes]]]:
    """One committed local checkpoint read back, every part file checked
    against the manifest's size and CRC; None on any damage."""
    d = _ckpt_dir(root, fp)
    try:
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if int(manifest.get("v", 0)) > SCHEMA_VERSION \
            or manifest.get("fp") != fp:
        return None
    out: Dict[int, List[bytes]] = {}
    for pid_s, meta in (manifest.get("parts") or {}).items():
        try:
            with open(os.path.join(d, f"part_{pid_s}.bin"), "rb") as f:
                buf = f.read()
        except OSError:
            return None
        if len(buf) != int(meta.get("bytes", -1)) \
                or (zlib.crc32(buf) & 0xFFFFFFFF) != int(meta.get("crc", -1)):
            return None
        blobs: List[bytes] = []
        off = 0
        while off < len(buf):
            if len(buf) - off < 4:
                return None
            (ln,) = struct.unpack_from("<I", buf, off)
            off += 4
            if len(buf) - off < ln:
                return None
            blobs.append(buf[off:off + ln])
            off += ln
        if len(blobs) != int(meta.get("n", -1)):
            return None
        out[int(pid_s)] = blobs
    return out


# ---------------------------------------------------------------------------
# recovery state (what a replay produced)
# ---------------------------------------------------------------------------

class RecoveryState:
    """The dead incarnation's query classification and its still-adoptable
    stage checkpoints."""

    def __init__(self):
        self.classification: Dict[str, str] = {}
        # fp -> the adoptable ckpt record ({"ckind": local|lease, ...})
        self.pending: Dict[str, Dict] = {}
        self.replayed_records = 0
        self.discards = 0
        self.expired = 0
        # queries of THIS incarnation that adopted at least one stage
        self._resumed_qids: Set[str] = set()


def _build_recovery(root: str, records: List[Dict],
                    damaged_files: int) -> RecoveryState:
    st = RecoveryState()
    st.replayed_records = len(records)
    st.discards += damaged_files
    queries: Dict[str, Dict] = {}
    ckpts: Dict[str, Dict] = {}
    served: Set[str] = set()
    for r in records:
        kind = r.get("kind")
        q = str(r.get("q", ""))
        if kind == "admit":
            queries.setdefault(q, {"ended": None, "ckpts": set()})
        elif kind == "end":
            queries.setdefault(q, {"ended": None, "ckpts": set()})
            queries[q]["ended"] = str(r.get("status", "ok"))
        elif kind == "ckpt":
            fp = str(r.get("fp", ""))
            if fp:
                ckpts[fp] = r
                queries.setdefault(
                    q, {"ended": None, "ckpts": set()})["ckpts"].add(fp)
        elif kind == "served":
            served.add(str(r.get("fp", "")))
    now = time.time()
    for fp, rec in ckpts.items():
        owner = queries.get(str(rec.get("q", "")))
        if fp in served or (owner is not None
                            and owner["ended"] is not None):
            continue            # superseded: the query finished cleanly
        expires = float(rec.get("expires", 0.0) or 0.0)
        if expires and now > expires:
            st.expired += 1
            PC.bump("recovery_leases_expired")
            if rec.get("ckind") == LOCAL:
                shutil.rmtree(_ckpt_dir(root, fp), ignore_errors=True)
            continue
        if rec.get("ckind") == LOCAL \
                and load_local_stage(root, fp) is None:
            # validated now: a damaged checkpoint degrades here, not
            # mid-query
            st.discards += 1
            PC.bump("journal_recovery_discards")
            shutil.rmtree(_ckpt_dir(root, fp), ignore_errors=True)
            continue
        st.pending[fp] = rec
    for q, info in queries.items():
        if not q:
            continue
        if info["ended"] is not None:
            st.classification[q] = COMPLETED
        elif any(fp in st.pending for fp in info["ckpts"]):
            st.classification[q] = RESUMABLE
        else:
            st.classification[q] = ABANDONED
    if damaged_files:
        PC.bump("journal_recovery_discards", damaged_files)
    # orphan sweep: checkpoint dirs without an adoptable record (a crash
    # between the rename and the journal append) are unreachable
    base = _ckpt_root(root)
    try:
        names = os.listdir(base)
    except OSError:
        names = []
    for name in names:
        if name in st.pending:
            continue
        if not name.startswith(".tmp."):
            st.discards += 1
            PC.bump("journal_recovery_discards")
        shutil.rmtree(os.path.join(base, name), ignore_errors=True)
    return st


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------

class QueryJournal:
    """One incarnation's WAL over one recovery root.  Construction is
    recovery: a prior WAL rotates to ``journal.replay`` and replays into a
    :class:`RecoveryState`, the adoptable checkpoints are carried forward
    into the new WAL, and the replay file is deleted."""

    def __init__(self, root: str, fsync: bool = False,
                 lease_ttl_ms: int = 120_000):
        self.root = root
        self.fsync = bool(fsync)
        self.lease_ttl_s = max(float(lease_ttl_ms), 0.0) / 1000.0
        self._lock = threading.Lock()
        self._n_records = 0
        # this incarnation's bookkeeping for end-of-query cleanup and the
        # leak report: qid -> [(ckind, fp)], and the un-ended admissions
        self._committed: Dict[str, List[Tuple[str, str]]] = {}
        self._active_qids: Set[str] = set()
        os.makedirs(root, exist_ok=True)
        with _lock:
            _ACTIVE_ROOTS.add(root)

        wal = os.path.join(root, WAL_NAME)
        replay = os.path.join(root, REPLAY_NAME)
        records: List[Dict] = []
        damaged = 0
        # a leftover journal.replay means the previous recovery died
        # mid-rotation: it is older than the wal, so it folds first
        for path in (replay, wal):
            if os.path.exists(path):
                recs, bad = _read_journal_file(path)
                records.extend(recs)
                damaged += 1 if bad else 0
        if os.path.exists(wal):
            os.replace(wal, replay)
        self.recovery = _build_recovery(root, records, damaged)
        self._fd = os.open(wal, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        # carried forward, so a crash of THIS incarnation before serving
        # them keeps them adoptable
        for rec in self.recovery.pending.values():
            self._append(dict(rec))
        try:
            os.unlink(replay)
        except OSError:
            pass

    # -- append ----------------------------------------------------------
    def _append(self, rec: Dict) -> None:
        rec.setdefault("v", SCHEMA_VERSION)
        rec.setdefault("ts", time.time())
        frame = frame_record(rec)
        with self._lock:
            if self._fd is None:
                return
            os.write(self._fd, frame)
            if self.fsync:
                os.fsync(self._fd)
            self._n_records += 1
            n = self._n_records
        PC.bump("journal_records_written")
        hook = TEST_RECORD_HOOK
        if hook is not None:
            hook(str(rec.get("kind", "")), n)

    # -- query lifecycle records -----------------------------------------
    def admit(self, qid: str, trace_id: str, conf) -> None:
        from spark_rapids_tpu_torch.compilecache.keys import conf_fp

        settings = dict(getattr(conf, "settings", {}) or {})
        self._active_qids.add(qid)
        self._append({
            "kind": "admit", "q": qid, "trace": trace_id,
            "conf_fp": conf_fp(conf),
            "conf": {str(k): str(v) for k, v in settings.items()}})

    def plan(self, qid: str, root_exec) -> None:
        from spark_rapids_tpu_torch.compilecache.keys import fingerprint

        self._append({"kind": "plan", "q": qid,
                      "plan_fp": fingerprint(plan_tree_fp(root_exec))})

    def end(self, qid: str, status: str) -> None:
        self._append({"kind": "end", "q": qid, "status": status})
        self._active_qids.discard(qid)
        # the query finished: a restart would classify it completed and
        # never adopt its checkpoints, so they are garbage
        for ckind, fp in self._committed.pop(qid, []):
            if ckind == LOCAL:
                shutil.rmtree(_ckpt_dir(self.root, fp),
                              ignore_errors=True)
        try:
            self._reconcile_worker_holdings()
        except Exception:
            # a failed orphan sweep must never fail the query's teardown
            pass

    def _reconcile_worker_holdings(self) -> None:
        """Release worker-held partitions a dead incarnation shipped but
        never lease-committed (or whose lease was retired).  Runs at query
        end, when re-attached workers have certainly enumerated their
        holdings; still-pending leases stay pinned."""
        from spark_rapids_tpu_torch.distributed import peek_coordinator

        coord = peek_coordinator()
        if coord is None:
            return
        keep = {int(rec.get("wire", -1))
                for rec in self.recovery.pending.values()
                if rec.get("ckind") == LEASE}
        coord.release_orphan_holdings(keep)

    # -- stage checkpoints -----------------------------------------------
    def commit_local_stage(self, fp: str, qid: str,
                           parts: Dict[int, List[bytes]]) -> bool:
        """Commit one local stage: part files and manifest under a
        temporary directory, renamed into place, and only then the
        journal record — a crash anywhere leaves either an adoptable
        checkpoint or an orphan the next replay purges."""
        try:
            _write_local_checkpoint(self.root, fp, qid, parts, self.fsync)
        except OSError:
            return False
        self._committed.setdefault(qid, []).append((LOCAL, fp))
        self._append({"kind": "ckpt", "ckind": LOCAL, "q": qid,
                      "fp": fp,
                      "parts": {str(p): len(b) for p, b in parts.items()},
                      "expires": time.time() + self.lease_ttl_s})
        return True

    def commit_lease(self, fp: str, qid: str, wire: int,
                     placement: Dict[int, str],
                     counts: Dict[int, int]) -> None:
        """Commit one distributed stage: the worker-held partitions are
        the checkpoint, and this lease pins them past the driver's death
        until it expires."""
        self._committed.setdefault(qid, []).append((LEASE, fp))
        self._append({"kind": "ckpt", "ckind": LEASE, "q": qid,
                      "fp": fp, "wire": int(wire),
                      "placement": {str(p): w
                                    for p, w in placement.items()},
                      "counts": {str(p): int(n)
                                 for p, n in counts.items()},
                      "expires": time.time() + self.lease_ttl_s})

    # -- recovery lookup and serve ---------------------------------------
    def lookup_stage(self, fp: str):
        """An adoptable prior-incarnation checkpoint for this plan-stage
        fingerprint, or None: ``("local", {pid: [blobs]})`` or ``("lease",
        wire, {pid: wid}, {pid: n_blocks})``.  A lease adopts only when
        the re-attached workers' inventory covers every recorded block
        count; adoption registers the placement under the original wire
        id."""
        rec = self.recovery.pending.get(fp)
        if rec is None:
            return None
        if rec.get("ckind") == LOCAL:
            parts = load_local_stage(self.root, fp)
            if parts is None:
                self.discard_stage(fp, "checkpoint damaged")
                return None
            return (LOCAL, parts)
        from spark_rapids_tpu_torch.distributed import peek_coordinator

        coord = peek_coordinator()
        if coord is None:
            return None
        wire = int(rec.get("wire", -1))
        counts = {int(p): int(n)
                  for p, n in (rec.get("counts") or {}).items()}
        inv = coord.worker_inventory()
        placement: Dict[int, str] = {}
        for pid, need in counts.items():
            owner = None
            for wid, held in inv.items():
                for exch, hpid, n, _mx in held:
                    if exch == wire and hpid == pid and n >= need:
                        owner = wid
                        break
                if owner is not None:
                    break
            if owner is None:
                # not covered (yet): workers may still be re-attaching,
                # and the lease stays pending
                return None
            placement[pid] = owner
        coord.adopt_exchange(wire, placement, counts)
        return (LEASE, wire, placement, counts)

    def mark_recovered(self, fp: str, qid: str, n_parts: int) -> None:
        """One stage was served from its checkpoint instead of
        re-executing."""
        rec = self.recovery.pending.pop(fp, None)
        self._append({"kind": "served", "fp": fp, "q": qid})
        if rec is not None and rec.get("ckind") == LOCAL:
            shutil.rmtree(_ckpt_dir(self.root, fp), ignore_errors=True)
        PC.bump("stages_recovered")
        if qid not in self.recovery._resumed_qids:
            self.recovery._resumed_qids.add(qid)
            PC.bump("queries_resumed")

    def discard_stage(self, fp: str, reason: str) -> None:
        rec = self.recovery.pending.pop(fp, None)
        if rec is not None:
            self._append({"kind": "served", "fp": fp, "q": "-"})
            if rec.get("ckind") == LOCAL:
                shutil.rmtree(_ckpt_dir(self.root, fp),
                              ignore_errors=True)
        PC.bump("journal_recovery_discards")

    def retire_expired(self) -> int:
        """Drop pending checkpoints past their expiry (replay already
        retires what expired before the rotation); returns how many."""
        now = time.time()
        victims = [fp for fp, rec in self.recovery.pending.items()
                   if float(rec.get("expires", 0) or 0)
                   and now > float(rec.get("expires", 0))]
        for fp in victims:
            rec = self.recovery.pending.pop(fp)
            self._append({"kind": "served", "fp": fp, "q": "-"})
            if rec.get("ckind") == LOCAL:
                shutil.rmtree(_ckpt_dir(self.root, fp),
                              ignore_errors=True)
            PC.bump("recovery_leases_expired")
        return len(victims)

    def startup_postmortem(self) -> Optional[Dict]:
        """The reference bundles a crashed incarnation's classification
        into a telemetry flight-recorder dump; the port has no telemetry
        hub, so there is nothing to dump."""
        return None

    # -- hygiene ----------------------------------------------------------
    def leak_lines(self) -> List[str]:
        out = []
        for qid in sorted(self._active_qids):
            out.append(f"LEAK: recovery journal query {qid} admitted "
                       f"but never ended")
        for fp in sorted(self.recovery.pending):
            out.append(f"LEAK: recovery checkpoint {fp} still pending "
                       f"(never served nor retired)")
        try:
            names = sorted(os.listdir(_ckpt_root(self.root)))
        except OSError:
            names = []
        live = {fp for lst in self._committed.values() for _, fp in lst}
        live |= set(self.recovery.pending)
        for name in names:
            if name not in live:
                out.append(f"LEAK: recovery checkpoint dir {name} "
                           f"left on disk")
        return out

    def close(self, purge: bool = False) -> None:
        with self._lock:
            fd, self._fd = self._fd, None
        if fd is not None:
            try:
                os.close(fd)
            except OSError:
                pass
        if purge:
            _purge_root(self.root)


def _purge_root(root: str) -> None:
    for name in (WAL_NAME, REPLAY_NAME, ENDPOINT_NAME):
        try:
            os.unlink(os.path.join(root, name))
        except OSError:
            pass
    shutil.rmtree(_ckpt_root(root), ignore_errors=True)
    with _lock:
        _ACTIVE_ROOTS.discard(root)


# ---------------------------------------------------------------------------
# the process's journal and the lifecycle hooks
# ---------------------------------------------------------------------------

def get_journal(conf) -> QueryJournal:
    """The process's journal, opened (that is, recovered) on first use.  A
    conf naming a different root replaces it (tests; a driver has one root
    for its lifetime)."""
    global _journal
    from spark_rapids_tpu_torch.config import (RECOVERY_FSYNC,
                                               RECOVERY_LEASE_TTL_MS)

    root = resolve_root(conf)
    with _lock:
        if _journal is not None and _journal.root == root:
            return _journal
        old, _journal = _journal, None
    if old is not None:
        old.close()
    j = QueryJournal(root, fsync=bool(conf.get(RECOVERY_FSYNC)),
                     lease_ttl_ms=int(conf.get(RECOVERY_LEASE_TTL_MS)))
    j.startup_postmortem()
    with _lock:
        _journal = j
    return j


def peek_journal() -> Optional[QueryJournal]:
    return _journal


def reset_journal(purge: bool = False) -> None:
    """Close the process's journal (a driver "restart" in one process).
    With ``purge`` every recovery root this process touched is swept: the
    WAL, the endpoint file and the checkpoints."""
    global _journal
    with _lock:
        j, _journal = _journal, None
    if j is not None:
        j.close(purge=purge)
    if purge:
        with _lock:
            roots = list(_ACTIVE_ROOTS)
        for root in roots:
            _purge_root(root)


def journal_admit(ctx, conf) -> None:
    """``query_lifecycle.__enter__``'s hook (its caller checks that
    recovery is on)."""
    get_journal(conf).admit(ctx.query_id, getattr(ctx, "trace_id", "")
                            or "", conf)


def journal_plan(ctx, root_exec, conf) -> None:
    j = peek_journal()
    if j is None:
        j = get_journal(conf)
    j.plan(ctx.query_id, root_exec)


def journal_end(ctx, status: str) -> None:
    j = peek_journal()
    if j is not None:
        j.end(ctx.query_id, status)


def recovery_report() -> Dict[str, str]:
    """The dead incarnation's query classification (completed, resumable
    or abandoned), one class per journaled query."""
    j = peek_journal()
    return dict(j.recovery.classification) if j is not None else {}


def journal_leak_report() -> List[str]:
    """``leak_report_all``'s hook: never-ended journaled queries, pending
    checkpoints, checkpoint dirs left on disk.  Empty unless this process
    opened a journal."""
    j = _journal
    return j.leak_lines() if j is not None else []

"""TKD1, the wire protocol of the distributed tier — CRC-framed control
messages (a copy of ``spark_rapids_tpu/distributed/protocol.py``; the
bytes on the wire are the reference's).

Frame layout (little-endian):

    TKD1 | u32 payload_len | u32 crc32(payload) | payload
    payload = u32 header_len | header_json | blob_0 | blob_1 | ...

with the header carrying ``blobs`` (the list of blob sizes) when binary
payloads follow.  One frame is one message; a socket carries a sequence
of frames.  The data-plane blobs are TKU2 blocks
(``shuffle/serializer.py``), so a flipped bit anywhere between producer
and consumer surfaces as a corruption error, never as wrong rows.
Failures:

* :class:`ProtocolCorruption` — CRC, magic or length mismatch;
  deterministic.
* ``ConnectionError``, ``BrokenPipeError``, ``socket.timeout`` — from the
  socket layer; transient.
* :class:`WorkerLost` — the block layer exhausted its transient budget
  against one worker, or the coordinator declared it dead: the exchange
  re-places the worker's partitions and re-drives the retained blocks.

A data-plane header may carry ``trace`` (the query's trace id) and
``span``; ``redrive: 1`` on a put marks a lineage replay.  The module is
stdlib only, so a worker process imports it without torch.
"""
from __future__ import annotations

import itertools
import json
import socket
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

MAGIC = b"TKD1"
_HDR = struct.Struct("<4sII")
_U32 = struct.Struct("<I")

# one control frame is small; a data frame carries TKU2 blobs that are
# themselves bounded by the exchange batch-size goal — this cap only
# guards against a corrupted length word allocating gigabytes
MAX_FRAME_BYTES = 1 << 30

# process-unique request correlation ids (``rid``): uniqueness is all
# the desync check needs, and a global counter avoids per-socket state
# (socket.socket carries __slots__; GIL makes next() atomic)
_RID = itertools.count(1)


class ProtocolCorruption(RuntimeError):
    """Bad magic / length / CRC on a control frame — deterministic (the
    same bytes re-derive the same corruption)."""


class ProtocolDesync(ConnectionError):
    """The reply frame read off the socket answers a DIFFERENT request
    than the one just sent (its echoed ``rid`` mismatches).  A network
    that duplicates or reorders frames leaves a stale reply in the
    stream, and every frame after it would be off by one, so the only
    safe move is to abandon the connection.  A ``ConnectionError``:
    transient, and the caller's retry dials a fresh connection."""


class RemoteOpError(RuntimeError):
    """The worker ANSWERED but reported the operation failed (e.g.
    ENOSPC writing a spill file).  The transport is fine but that
    worker cannot serve — the coordinator treats it like a dead socket:
    declare the loss and re-place, never indict the query's operator."""


class WorkerLost(ConnectionError):
    """A worker is gone for good as far as this operation is concerned:
    transient retries against it were exhausted, or the coordinator
    declared it LOST.  Classified as the WORKER_LOST failure class —
    the distributed layer answers with re-placement + re-drive from the
    producer-side spilled partition queues, not with backoff."""

    def __init__(self, worker_id: str, detail: str = ""):
        super().__init__(
            f"worker {worker_id} lost" + (f": {detail}" if detail else ""))
        self.worker_id = worker_id


class WorkerDegraded(WorkerLost):
    """A worker is *slow*, not dead (gray failure): its ops
    keep blowing the soft deadline or its latency EWMA sits past
    slowFactor x the fleet median, and an op against it exhausted the
    transient budget.  Classified as the WORKER_DEGRADED class — never
    DETERMINISTIC, never the quarantine breaker: the caller re-drives
    the affected partitions onto the healthy survivors the coordinator
    already speculated them to, and the worker stays a member
    (DEGRADED, promotable back on sustained recovery)."""

    def __init__(self, worker_id: str, detail: str = ""):
        ConnectionError.__init__(
            self,
            f"worker {worker_id} degraded"
            + (f": {detail}" if detail else ""))
        self.worker_id = worker_id


def encode_msg(header: Dict, blobs: Sequence[bytes] = ()) -> bytes:
    """One wire frame for ``header`` (+ optional binary payloads)."""
    if blobs:
        header = dict(header)
        header["blobs"] = [len(b) for b in blobs]
    hj = json.dumps(header, separators=(",", ":")).encode("utf-8")
    payload = b"".join([_U32.pack(len(hj)), hj, *blobs])
    return _HDR.pack(MAGIC, len(payload), zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> Tuple[Dict, List[bytes]]:
    if len(payload) < 4:
        raise ProtocolCorruption("truncated payload")
    (hlen,) = _U32.unpack_from(payload, 0)
    if 4 + hlen > len(payload):
        raise ProtocolCorruption("header length past payload end")
    try:
        header = json.loads(payload[4:4 + hlen].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolCorruption(f"undecodable header: {e}") from e
    blobs: List[bytes] = []
    off = 4 + hlen
    for size in header.get("blobs", []):
        if off + size > len(payload):
            raise ProtocolCorruption("blob length past payload end")
        blobs.append(payload[off:off + size])
        off += size
    return header, blobs


def recv_exactly(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes or raise ConnectionError on EOF (a peer
    vanishing mid-frame is a connection failure, not corruption)."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise ConnectionError(
                f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock: socket.socket, header: Dict,
             blobs: Sequence[bytes] = ()) -> None:
    sock.sendall(encode_msg(header, blobs))


def recv_msg(sock: socket.socket) -> Tuple[Dict, List[bytes]]:
    """One frame off the socket (honors the socket's timeout)."""
    raw = recv_exactly(sock, _HDR.size)
    magic, plen, crc = _HDR.unpack(raw)
    if magic != MAGIC:
        raise ProtocolCorruption(f"bad magic {magic!r}")
    if plen > MAX_FRAME_BYTES:
        raise ProtocolCorruption(f"frame length {plen} exceeds cap")
    payload = recv_exactly(sock, plen)
    if zlib.crc32(payload) != crc:
        raise ProtocolCorruption("control-frame CRC mismatch")
    return decode_payload(payload)


def request(sock: socket.socket, header: Dict,
            blobs: Sequence[bytes] = ()) -> Tuple[Dict, List[bytes]]:
    """Send one message and read one reply; a reply carrying ``error``
    raises :class:`RemoteOpError` (the remote failed the op, the
    transport itself is fine).

    Every request carries a process-unique correlation id (``rid``)
    that the worker echoes into its reply; a mismatch means the stream
    holds a duplicated or reordered frame and raises
    :class:`ProtocolDesync` BEFORE the error field is consulted (a
    stale error reply must not be attributed to this op)."""
    rid = next(_RID)
    header = dict(header)
    header["rid"] = rid
    send_msg(sock, header, blobs)
    rep, rblobs = recv_msg(sock)
    got = rep.get("rid")
    if got != rid:
        raise ProtocolDesync(
            f"reply rid {got!r} answers a different request than "
            f"{rid} — duplicated/reordered frame in the stream")
    if rep.get("error"):
        raise RemoteOpError(f"remote error: {rep['error']}")
    return rep, rblobs


def connect(host: str, port: int, timeout_s: float) -> socket.socket:
    s = socket.create_connection((host, port), timeout=timeout_s)
    s.settimeout(timeout_s)
    try:
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    return s


def parse_endpoint(ep: str) -> Tuple[str, int]:
    host, _, port = ep.rpartition(":")
    return (host or "127.0.0.1"), int(port)

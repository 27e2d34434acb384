"""Spill framework — spillable batches with device -> pinned host -> disk
tiers (port of ``spark_rapids_tpu/memory/spill.py``).

Batches an operator is not computing on are registered as spillable
handles.  The framework keeps the bytes of the handles on the device
within the pool (``memory/device_manager.py``); admitting a handle past it
first moves the least recently used handles to the host, and the host tier
past ``spark.rapids.memory.host.spillStorageSize`` moves on to ``.npz``
files under ``spark.rapids.memory.spillDir``.  A handle comes back up on
``get_batch``.

The pool is a budget over tracked bytes, as in the reference; torch's
caching allocator is not capped.  A CUDA batch goes down into pinned host
memory with non-blocking copies and one stream synchronisation before any
byte of it is read; the disk tier carries a CRC32 of the host columns,
checked when the file is read back (``SpillCorruption``).  Each handle
records the query that tracked it, so the query lifecycle closes what a
query left behind (``close_owned_by``) and ``leak_report`` lists what is
still open.  A handle tracked ``persistent`` (the hot-table cache's,
``io/hot_cache.py``) outlives its query: the query-end cleanup and the leak
report leave it out, it spills down the tiers under pressure like any
other, and a framework built anew for the next collect takes it over.  The
reference's query accounting is not ported.
"""
from __future__ import annotations

import os
import tempfile
import threading
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import rebuild_column
from spark_rapids_tpu_torch.config import (HOST_SPILL_STORAGE_SIZE, SPILL_DIR,
                                           TpuConf)

STATE_DEVICE = "DEVICE"
STATE_HOST = "HOST"
STATE_DISK = "DISK"


def buffer_names(dt: T.DataType, prefix: str = "") -> List[str]:
    """Names of a column's buffers in ``DeviceColumn.tensors`` order:
    ``validity`` and ``data`` (a string's ``chars`` and ``lengths``, an
    array's ``data``, ``lengths`` and ``elem_valid``), and for a struct
    the validity and then each child's buffers under ``<field index>.``."""
    if isinstance(dt, T.StructType):
        return [prefix + "validity"] + [
            n for j, f in enumerate(dt.fields)
            for n in buffer_names(f.dataType, f"{prefix}{j}.")]
    if isinstance(dt, T.StringType):
        return [prefix + "validity", prefix + "chars", prefix + "lengths"]
    if isinstance(dt, T.ArrayType):
        return [prefix + n for n in ("validity", "data", "lengths",
                                     "elem_valid")]
    return [prefix + "validity", prefix + "data"]


class SpillCorruption(RuntimeError):
    """A disk-tier unspill read back bytes whose CRC32 does not match what
    was written (bit rot, a torn write, a corrupted spill dir)."""


def _crc_host_cols(host_cols: List[Dict[str, np.ndarray]]) -> int:
    """CRC32 of a host-tier column set, independent of dict ordering."""
    crc = 0
    for i, entry in enumerate(host_cols):
        for k in sorted(entry):
            crc = zlib.crc32(f"{i}:{k}".encode(), crc)
            crc = zlib.crc32(np.ascontiguousarray(entry[k]).tobytes(), crc)
    return crc


def copy_to_host(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Device tensors -> host tensors as one host sync: into pinned memory
    with non-blocking copies from a CUDA device, then one synchronisation
    of the stream, so no byte is read before it has landed."""
    if not tensors:
        return []
    cuda = tensors[0].device.type == "cuda"
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        h.copy_(t, non_blocking=cuda)
        out.append(h)
    if cuda:
        torch.cuda.current_stream(tensors[0].device).synchronize()
    PC.bump("host_syncs")
    PC.bump("bytes_d2h", sum(h.numel() * h.element_size() for h in out))
    return out


class SpillableColumnarBatch:
    """A batch handle that can move between the card, host RAM and disk
    (reference: SpillableColumnarBatch)."""

    def __init__(self, batch: ColumnarBatch, framework: "SpillFramework",
                 persistent: bool = False):
        self._framework = framework
        self._batch: Optional[ColumnarBatch] = batch
        self._host: Optional[List[Dict[str, torch.Tensor]]] = None
        self._disk_path: Optional[str] = None
        self._disk_crc: Optional[int] = None
        self.schema = batch.schema
        self.num_rows = batch.num_rows
        self.dtypes = [c.dtype for c in batch.columns]
        self.device = batch.device if batch.columns else None
        self.device_bytes = batch.nbytes()
        self.state = STATE_DEVICE
        self.pinned = 0          # > 0 while an operator computes on it
        self.lru_tick = 0
        self.closed = False
        # a persistent handle intentionally outlives the query that
        # tracked it (a cached table)
        self.persistent = persistent
        from spark_rapids_tpu_torch.lifecycle.context import current

        ctx = current()
        self.owner_qid = ctx.query_id if ctx is not None else None
        framework._register(self)

    # -- public API ------------------------------------------------------
    def get_batch(self) -> ColumnarBatch:
        """The batch on the device (brought back up if spilled); touches
        the LRU clock."""
        with self._framework._lock:
            self._framework._touch_locked(self)
            if self.state == STATE_DEVICE:
                return self._batch
        self._framework.ensure_room(self.device_bytes, exclude=self)
        with self._framework._lock:
            if self.state == STATE_DISK:
                self._disk_to_host_locked()
            if self.state == STATE_HOST:
                self._host_to_device_locked()
            return self._batch

    def get_rows(self, start: int, length: int) -> ColumnarBatch:
        """Rows ``[start, start + length)`` on the device without bringing
        the whole batch back: views of a device-resident batch, or an
        upload of just those rows from the host tier (a batch on disk
        comes up to the host first).  Touches the LRU clock."""
        with self._framework._lock:
            self._framework._touch_locked(self)
            if self.state == STATE_DISK:
                self._disk_to_host_locked()
            if self.state == STATE_DEVICE:
                return self._batch.slice_rows(start, length)
            return self._upload_rows(start, start + length)

    def pin(self) -> "SpillableColumnarBatch":
        with self._framework._lock:
            self.pinned += 1
        return self

    def unpin(self) -> None:
        with self._framework._lock:
            self.pinned = max(0, self.pinned - 1)

    def close(self) -> None:
        with self._framework._lock:
            if self.closed:
                return
            self.closed = True
            self._framework._unregister_locked(self)
            self._batch = None
            self._host = None
            if self._disk_path and os.path.exists(self._disk_path):
                try:
                    os.unlink(self._disk_path)
                except OSError:
                    pass

    def host_bytes(self) -> int:
        if self._host is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for e in self._host for t in e.values())

    # -- tier moves (framework lock held) --------------------------------
    def _device_to_host_locked(self) -> int:
        assert self.state == STATE_DEVICE
        host = iter(copy_to_host([t for c in self._batch.columns
                                  for t in c.tensors()]))
        self._host = [{k: next(host) for k in buffer_names(dt)}
                      for dt in self.dtypes]
        self._batch = None
        self.state = STATE_HOST
        return self.device_bytes

    def _host_to_device_locked(self) -> None:
        assert self.state == STATE_HOST
        self._batch = self._upload_rows(0, self.num_rows)
        self._host = None
        self.state = STATE_DEVICE
        fw = self._framework
        fw._device_used += self.device_bytes
        fw._device_used_peak = max(fw._device_used_peak, fw._device_used)

    def _upload_rows(self, start: int, end: int) -> ColumnarBatch:
        """Host rows ``[start, end)`` uploaded (non-blocking from pinned
        memory), counted in ``bytes_h2d``."""
        cols = []
        for dt, entry in zip(self.dtypes, self._host):
            up = []
            for k in buffer_names(dt):
                t = entry[k][start:end]
                PC.count_h2d(t.numel() * t.element_size())
                up.append(t.to(self.device, non_blocking=t.is_pinned()))
            cols.append(rebuild_column(dt, iter(up)))
        return ColumnarBatch(cols, end - start, self.schema)

    def _host_to_disk_locked(self) -> int:
        assert self.state == STATE_HOST
        nbytes = self.host_bytes()
        host_np = [{k: t.numpy() for k, t in e.items()} for e in self._host]
        arrays = {f"c{i}_{k}": v for i, e in enumerate(host_np)
                  for k, v in e.items()}
        # remember what the bytes looked like going down; the unspill
        # checks them before trusting them
        self._disk_crc = _crc_host_cols(host_np)
        fd, path = tempfile.mkstemp(suffix=".spill.npz",
                                    dir=self._framework.spill_dir)
        os.close(fd)
        np.savez(path, **arrays)
        self._disk_path = path
        self._host = None
        self.state = STATE_DISK
        return nbytes

    def _disk_to_host_locked(self) -> None:
        assert self.state == STATE_DISK
        try:
            with np.load(self._disk_path) as loaded:
                host_np = [{k: loaded[f"c{i}_{k}"]
                            for k in buffer_names(dt)}
                           for i, dt in enumerate(self.dtypes)]
        except Exception as e:
            # the zip container itself rejected the bytes (a flipped byte
            # in a compressed member): the same corruption
            raise SpillCorruption(
                f"disk unspill of {self._disk_path} failed to decode: "
                f"{type(e).__name__}: {e}") from e
        got = _crc_host_cols(host_np)
        if got != self._disk_crc:
            raise SpillCorruption(
                f"disk unspill CRC mismatch for {self._disk_path}: "
                f"wrote {self._disk_crc:#010x}, read {got:#010x}")
        self._host = [{k: torch.from_numpy(v) for k, v in e.items()}
                      for e in host_np]
        try:
            os.unlink(self._disk_path)
        except OSError:
            pass
        self._disk_path = None
        self._disk_crc = None
        self.state = STATE_HOST


class SpillFramework:
    """Tracks spillable handles and keeps their device bytes within the
    pool."""

    def __init__(self, pool_bytes: int, host_limit: int,
                 spill_dir: Optional[str]):
        self.pool_bytes = pool_bytes
        self.host_limit = host_limit
        self.spill_dir = spill_dir
        if self.spill_dir:
            os.makedirs(self.spill_dir, exist_ok=True)
        self._lock = threading.RLock()
        self._handles: List[SpillableColumnarBatch] = []
        self._device_used = 0
        self._device_used_peak = 0
        self._tick = 0
        self.spill_to_host_count = 0
        self.spill_to_disk_count = 0
        self.spill_to_host_bytes = 0
        self.spill_to_disk_bytes = 0

    # -- registration ----------------------------------------------------
    def _register(self, h: SpillableColumnarBatch) -> None:
        # make room BEFORE admitting the new batch: residency then stays
        # within the pool while the budget can be met (a batch larger
        # than the whole pool still admits; the caller's retry owns that)
        self.ensure_room(h.device_bytes, exclude=h)
        with self._lock:
            self._touch_locked(h)
            self._handles.append(h)
            self._device_used += h.device_bytes
            self._device_used_peak = max(self._device_used_peak,
                                         self._device_used)

    def _unregister_locked(self, h: SpillableColumnarBatch) -> None:
        if h.state == STATE_DEVICE:
            self._device_used -= h.device_bytes
        if h in self._handles:
            self._handles.remove(h)

    def leak_report(self, include_persistent: bool = False) -> List[str]:
        """One line per live (unclosed) handle; empty once every handle
        a query tracked was released.  Persistent handles are left out
        unless ``include_persistent``."""
        with self._lock:
            return [f"LEAK: {h.state} handle {h.device_bytes}B"
                    + (" persistent" if h.persistent else "")
                    + (f" owner={h.owner_qid}" if h.owner_qid else "")
                    for h in self._handles
                    if include_persistent or not h.persistent]

    def close_owned_by(self, query_id: str) -> int:
        """Query-end cleanup: close every non-persistent handle the query
        tracked and never closed (a mid-batch unwind leaves these);
        returns how many were closed."""
        with self._lock:
            victims = [h for h in self._handles
                       if h.owner_qid == query_id and not h.persistent]
        for h in victims:
            h.close()
        return len(victims)

    def close_all(self, include_persistent: bool = True) -> int:
        """Close every live handle (leak recovery), the persistent ones
        only with ``include_persistent``."""
        with self._lock:
            victims = [h for h in self._handles
                       if include_persistent or not h.persistent]
        for h in victims:
            h.close()
        return len(victims)

    def adopt(self, handles: List[SpillableColumnarBatch]) -> None:
        """Take over live persistent handles from the framework this one
        replaces: they move here with their tier and keep counting
        against this pool."""
        for h in handles:
            old = h._framework
            with old._lock:
                if h.closed:
                    continue
                old._unregister_locked(h)
            h._framework = self
            if h.state == STATE_DEVICE:
                self.ensure_room(h.device_bytes, exclude=h)
            with self._lock:
                self._touch_locked(h)
                self._handles.append(h)
                if h.state == STATE_DEVICE:
                    self._device_used += h.device_bytes
                    self._device_used_peak = max(self._device_used_peak,
                                                 self._device_used)

    def _touch_locked(self, h: SpillableColumnarBatch) -> None:
        self._tick += 1
        h.lru_tick = self._tick

    def track(self, batch: ColumnarBatch,
              persistent: bool = False) -> SpillableColumnarBatch:
        return SpillableColumnarBatch(batch, self, persistent=persistent)

    # -- pressure --------------------------------------------------------
    @property
    def device_used(self) -> int:
        return self._device_used

    @property
    def device_used_peak(self) -> int:
        """High-water mark of tracked device bytes (above the pool only
        when one batch is larger than the whole pool)."""
        return self._device_used_peak

    def _spill_to_host_locked(self, h: SpillableColumnarBatch) -> int:
        freed = h._device_to_host_locked()
        self._device_used -= freed
        self.spill_to_host_count += 1
        self.spill_to_host_bytes += freed
        return freed

    def ensure_room(self, nbytes: int,
                    exclude: Optional[SpillableColumnarBatch] = None) -> bool:
        """Spill the least recently used unpinned device handles until
        ``nbytes`` more fit in the pool; False when they cannot."""
        while True:
            with self._lock:
                if self._device_used + nbytes <= self.pool_bytes:
                    return True
                victims = [h for h in self._handles
                           if h.state == STATE_DEVICE and h.pinned == 0
                           and h is not exclude]
                if not victims:
                    return False
                self._spill_to_host_locked(
                    min(victims, key=lambda h: h.lru_tick))
                self._host_pressure_locked()

    def _host_pressure_locked(self) -> None:
        host_used = sum(h.host_bytes() for h in self._handles
                        if h.state == STATE_HOST)
        if host_used <= self.host_limit:
            return
        if self.spill_dir is None:
            self.spill_dir = tempfile.mkdtemp(prefix="srt_spill_")
        for h in sorted((h for h in self._handles if h.state == STATE_HOST),
                        key=lambda h: h.lru_tick):
            if host_used <= self.host_limit:
                break
            n = h._host_to_disk_locked()
            host_used -= n
            self.spill_to_disk_count += 1
            self.spill_to_disk_bytes += n

    def spill_device_pressure(self) -> int:
        """Spill every unpinned device handle (the retry's roll back)."""
        spilled = 0
        with self._lock:
            for h in sorted((h for h in self._handles
                             if h.state == STATE_DEVICE and h.pinned == 0),
                            key=lambda h: h.lru_tick):
                spilled += self._spill_to_host_locked(h)
            self._host_pressure_locked()
        return spilled

    def metrics(self) -> Dict[str, int]:
        return {
            "spillToHostCount": self.spill_to_host_count,
            "spillToDiskCount": self.spill_to_disk_count,
            "spillToHostBytes": self.spill_to_host_bytes,
            "spillToDiskBytes": self.spill_to_disk_bytes,
            "deviceUsedBytes": self._device_used,
            "deviceUsedPeakBytes": self._device_used_peak,
        }


_lock = threading.Lock()
_framework: Optional[SpillFramework] = None


def get_spill_framework(tpu_conf: Optional[TpuConf] = None,
                        device=None) -> SpillFramework:
    """The process's framework; given a conf, a new one whose pool comes
    from a device manager built from that conf (and ``device``)."""
    global _framework
    with _lock:
        if _framework is None or tpu_conf is not None:
            from spark_rapids_tpu_torch.memory.device_manager import (
                get_device_manager)

            c = tpu_conf or TpuConf()
            dm = get_device_manager(tpu_conf, device)
            old = _framework
            _framework = SpillFramework(
                pool_bytes=dm.pool_bytes,
                host_limit=c.get(HOST_SPILL_STORAGE_SIZE),
                spill_dir=c.get(SPILL_DIR))
            if old is not None:
                # persistent handles outlive the framework they were
                # tracked in (a cached table across collects)
                with old._lock:
                    keep = [h for h in old._handles if h.persistent]
                _framework.adopt(keep)
        return _framework


def peek_spill_framework() -> Optional[SpillFramework]:
    """The framework if one exists; never creates one."""
    return _framework


def reset_spill_framework() -> None:
    global _framework
    with _lock:
        _framework = None

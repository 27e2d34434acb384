"""TpuShuffleManager — the shuffle manager (port of
``spark_rapids_tpu/shuffle/manager.py``).

An exchange registers each shuffle here.  In MULTITHREADED mode each input
batch is a map task whose partition slices are serialized as TKU2 blocks on
a writer pool into a host block store (memory up to
``spark.rapids.shuffle.hostStoreSize``, then files in the spill dir), and a
reduce partition is assembled from its blocks with one concat.  CACHE_ONLY
keeps the slices on the device.  The manager records which query
registered each shuffle, so the query lifecycle drops what a query left
behind (``unregister_owned``); unregistering a shuffle also releases what a
distributed exchange placed on remote workers under its id.  Shuffle ids
are process-unique: the distributed tier keys state in other processes by
them.
"""
from __future__ import annotations

import concurrent.futures as cf
import itertools
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import (SHUFFLE_COMPRESSION_CODEC,
                                           SHUFFLE_MODE,
                                           SHUFFLE_MT_WRITER_THREADS,
                                           SPILL_DIR, TpuConf, conf)
from spark_rapids_tpu_torch.device import DeviceLike
from spark_rapids_tpu_torch.shuffle.serializer import (deserialize_concat,
                                                       serialize_batch)

SHUFFLE_HOST_STORE_LIMIT = conf(
    "spark.rapids.shuffle.hostStoreSize").doc(
    "Host memory for shuffle blocks before they overflow to disk files; "
    "also the host memory of a distributed exchange's lineage queues."
).bytes_conf(1 << 31)


class _BlockStore:
    """Host block store with disk overflow, keyed (shuffle, map, pid)."""

    def __init__(self, limit: int, spill_dir: Optional[str]):
        self._blocks: Dict[Tuple[int, int, int], bytes] = {}
        self._files: Dict[Tuple[int, int, int], str] = {}
        self._bytes = 0
        self.limit = limit
        self.spill_dir = spill_dir
        self._lock = threading.Lock()

    def put(self, key: Tuple[int, int, int], blob: bytes) -> None:
        with self._lock:
            if self._bytes + len(blob) > self.limit:
                if self.spill_dir is None:
                    self.spill_dir = tempfile.mkdtemp(prefix="srt_shuffle_")
                os.makedirs(self.spill_dir, exist_ok=True)
                path = os.path.join(
                    self.spill_dir,
                    f"shuffle_{key[0]}_{key[1]}_{key[2]}.blk")
                with open(path, "wb") as f:
                    f.write(blob)
                self._files[key] = path
            else:
                self._blocks[key] = blob
                self._bytes += len(blob)

    def get(self, key: Tuple[int, int, int]) -> Optional[bytes]:
        with self._lock:
            if key in self._blocks:
                return self._blocks[key]
            path = self._files.get(key)
        if path is not None:
            with open(path, "rb") as f:
                return f.read()
        return None

    def keys_for_partition(self, shuffle_id: int,
                           pid: int) -> List[Tuple[int, int, int]]:
        with self._lock:
            ks = [k for k in itertools.chain(self._blocks, self._files)
                  if k[0] == shuffle_id and k[2] == pid]
        return sorted(ks)

    def remove_shuffle(self, shuffle_id: int) -> None:
        with self._lock:
            for k in [k for k in self._blocks if k[0] == shuffle_id]:
                self._bytes -= len(self._blocks.pop(k))
            for k in [k for k in self._files if k[0] == shuffle_id]:
                try:
                    os.unlink(self._files.pop(k))
                except OSError:
                    pass


class TpuShuffleManager:
    def __init__(self, tpu_conf: TpuConf):
        self.mode = tpu_conf.get(SHUFFLE_MODE).upper()
        self.codec = tpu_conf.get(SHUFFLE_COMPRESSION_CODEC)
        self.writer_threads = tpu_conf.get(SHUFFLE_MT_WRITER_THREADS)
        self.store = _BlockStore(tpu_conf.get(SHUFFLE_HOST_STORE_LIMIT),
                                 tpu_conf.get(SPILL_DIR))
        self._device_store: Dict[Tuple[int, int, int], ColumnarBatch] = {}
        # process-unique ids, shared by every manager generation: a new
        # manager must never hand out an id a query in flight (or a remote
        # worker store) still holds
        self._next_shuffle = _shuffle_ids
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        # live shuffle ids and the query that registered each
        self._owners: Dict[int, Optional[str]] = {}
        self.bytes_written = 0
        self.blocks_written = 0

    def _get_pool(self) -> cf.ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(
                    max_workers=self.writer_threads,
                    thread_name_prefix="shuffle-writer")
            return self._pool

    def register_shuffle(self) -> int:
        from spark_rapids_tpu_torch.lifecycle.context import current

        sid = next(self._next_shuffle)
        ctx = current()
        with self._lock:
            self._owners[sid] = ctx.query_id if ctx is not None else None
        return sid

    def active_shuffles(self) -> List[int]:
        with self._lock:
            return sorted(self._owners)

    def unregister_owned(self, query_id: str) -> int:
        """Query-end cleanup: drop every registration the query left
        behind; returns how many were dropped."""
        with self._lock:
            victims = [sid for sid, q in self._owners.items()
                       if q == query_id]
        for sid in victims:
            self.unregister_shuffle(sid)
        return len(victims)

    # -- write side ------------------------------------------------------
    def write_map_output(self, shuffle_id: int, map_id: int,
                         slices: List[Optional[ColumnarBatch]]) -> None:
        """Write one map task's partition slices (pid = index)."""
        from spark_rapids_tpu_torch.lifecycle.context import current_token

        token = current_token()   # captured here: pool threads have no
        if token is not None:     # query contextvar of their own
            token.check()
        if self.mode == "CACHE_ONLY":
            for pid, b in enumerate(slices):
                if b is not None and b.num_rows > 0:
                    self._device_store[(shuffle_id, map_id, pid)] = b
            return
        pool = self._get_pool()

        def job(pid: int, batch: ColumnarBatch) -> int:
            if token is not None:
                token.check()
            blob = serialize_batch(batch, codec=self.codec)
            self.store.put((shuffle_id, map_id, pid), blob)
            return len(blob)

        futures = [pool.submit(job, pid, b) for pid, b in enumerate(slices)
                   if b is not None and b.num_rows > 0]
        try:
            for f in futures:
                n = f.result()
                with self._lock:
                    self.bytes_written += n
                    self.blocks_written += 1
        except BaseException:
            for f in futures:
                f.cancel()
            # a straggler's put landing after the query's cleanup
            # unregistered this shuffle would leak its block
            cf.wait(futures)
            raise

    # -- read side -------------------------------------------------------
    def read_partition(self, shuffle_id: int, pid: int,
                       schema: T.StructType,
                       device: DeviceLike = None) -> Optional[ColumnarBatch]:
        """Assemble one reduce partition from all map outputs (decoded
        onto ``device``)."""
        from spark_rapids_tpu_torch.lifecycle.context import check_cancel

        check_cancel()
        if self.mode == "CACHE_ONLY":
            batches = [b for k, b in sorted(self._device_store.items())
                       if k[0] == shuffle_id and k[2] == pid]
            if not batches:
                return None
            return (batches[0] if len(batches) == 1
                    else ColumnarBatch.concat(batches))
        blocks = [self.store.get(k)
                  for k in self.store.keys_for_partition(shuffle_id, pid)]
        blocks = [b for b in blocks if b is not None]
        if not blocks:
            return None
        return deserialize_concat(blocks, schema, codec=self.codec,
                                  device=device)

    def unregister_shuffle(self, shuffle_id: int) -> None:
        self.store.remove_shuffle(shuffle_id)
        for k in [k for k in self._device_store if k[0] == shuffle_id]:
            del self._device_store[k]
        # a distributed exchange registered under this id placed
        # partitions on remote workers: release those too (peek only —
        # cleanup never builds a coordinator)
        from spark_rapids_tpu_torch.distributed import peek_coordinator

        coord = peek_coordinator()
        if coord is not None:
            coord.release_exchange(shuffle_id)
        with self._lock:
            self._owners.pop(shuffle_id, None)


_lock = threading.Lock()
_manager: Optional[TpuShuffleManager] = None
_manager_key = None
_shuffle_ids = itertools.count()


def get_shuffle_manager(tpu_conf: Optional[TpuConf] = None
                        ) -> TpuShuffleManager:
    """The process's manager, rebuilt when the shuffle confs change."""
    global _manager, _manager_key
    with _lock:
        if tpu_conf is None:
            if _manager is None:
                _manager = TpuShuffleManager(TpuConf())
            return _manager
        key = (tpu_conf.get(SHUFFLE_MODE),
               tpu_conf.get(SHUFFLE_COMPRESSION_CODEC),
               tpu_conf.get(SHUFFLE_MT_WRITER_THREADS))
        if _manager is None or key != _manager_key:
            _manager = TpuShuffleManager(tpu_conf)
            _manager_key = key
        return _manager


def peek_shuffle_manager() -> Optional[TpuShuffleManager]:
    """The manager if it exists; never creates one."""
    return _manager


def reset_shuffle_manager() -> None:
    global _manager, _manager_key
    with _lock:
        _manager = None
        _manager_key = None

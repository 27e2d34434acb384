"""Device-resident hot-table cache — a repeated scan skips the read, the
decode and the transfer (port of ``spark_rapids_tpu/io/hot_cache.py``).

Dashboards re-scan the same slowly-changing tables; once their decoded
columns sit in device memory, the repeat should pay no transfer.  A file
scan that runs to its end registers its device batches here, keyed by a
``compilecache/keys.py`` fingerprint over everything that could change
the batches: the file set with each file's size and ``mtime_ns`` (a
rewritten file misses), the column set and the reader chunking.  A scan with the same key yields the
cached batches (``hot_cache_hits``) with no file read, no decode kernel
launch and no ``bytes_h2d``.

Every cached batch is a persistent spillable (``memory/spill.py``): it
outlives its query, device pressure moves it down the tiers like any
other handle, and the leak report leaves it out.  The cache holds at most
``spark.rapids.tpu.scan.hotTableCache.maxBytes`` device bytes, closing the
least recently used entries past it (``hot_cache_evictions``); a scan
larger than the bound on its own is not cached.  ``TpuSession.close()``
and ``clear_hot_cache`` drop everything.  The reference keeps nested
(array) columns out, since its host tier cannot carry them; the port's
spill tiers carry every column kind it has.  The reference also records
each batch's source file (for ``input_file_name``, which the port does
not run) and lets its overload governor evict to a byte target (the port
has no governor); neither is ported.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import List, Optional

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class _Entry:
    __slots__ = ("handles", "nbytes")

    def __init__(self, handles, nbytes: int):
        self.handles = handles          # List[SpillableColumnarBatch]
        self.nbytes = nbytes


def _close_all(entries) -> None:
    for e in entries:
        for h in e.handles:
            h.close()


class HotTableCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0

    # -- keying ----------------------------------------------------------
    @staticmethod
    def scan_key(fmt: str, paths, columns, max_rows: int) -> Optional[str]:
        """Fingerprint of everything that could change a scan's output;
        None when a file vanished while keying.  The reference's key also
        holds the pushed filters and the scan options; the port pushes no
        filter into a scan and takes no reader option."""
        from spark_rapids_tpu_torch.compilecache.keys import fingerprint

        stats = []
        for p in paths:
            try:
                st = os.stat(p)
            except OSError:
                return None
            stats.append((p, st.st_size, st.st_mtime_ns))
        return fingerprint("hot_table_scan", fmt, tuple(stats),
                           tuple(columns), int(max_rows))

    # -- lookup and insert -----------------------------------------------
    def get(self, key: str) -> Optional[List[ColumnarBatch]]:
        """The cached batches, touched in the LRU order; None on a miss.  A
        spilled batch comes back up (that upload is counted as usual); an
        entry closed by a concurrent eviction is a miss."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._entries.move_to_end(key)
            handles = list(e.handles)
        out = []
        for h in handles:
            if h.closed:
                return None
            b = h.get_batch()
            if b is None:
                return None
            out.append(b)
        return out

    def put(self, key: str, batches: List[ColumnarBatch],
            max_bytes: int) -> bool:
        """Register a completed scan's batches; False when they are over
        ``max_bytes`` on their own (not cached)."""
        from spark_rapids_tpu_torch.memory.spill import get_spill_framework

        total = sum(b.nbytes() for b in batches)
        if not batches or total > max_bytes:
            return False
        fw = get_spill_framework()
        handles = [fw.track(b, persistent=True) for b in batches]
        with self._lock:
            old = self._entries.pop(key, None)
            victims = [old] if old is not None else []
            if old is not None:
                self._bytes -= old.nbytes
            while self._bytes + total > max_bytes and self._entries:
                _k, v = self._entries.popitem(last=False)
                self._bytes -= v.nbytes
                victims.append(v)
                PC.bump("hot_cache_evictions")
            self._entries[key] = _Entry(handles, total)
            self._bytes += total
        _close_all(victims)
        return True

    # -- maintenance -----------------------------------------------------
    def clear(self) -> int:
        """Drop every entry; returns how many handles were closed."""
        with self._lock:
            victims = list(self._entries.values())
            self._entries.clear()
            self._bytes = 0
        _close_all(victims)
        return sum(len(v.handles) for v in victims)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes}


_lock = threading.Lock()
_cache: Optional[HotTableCache] = None


def get_hot_cache() -> HotTableCache:
    global _cache
    with _lock:
        if _cache is None:
            _cache = HotTableCache()
        return _cache


def peek_hot_cache() -> Optional[HotTableCache]:
    return _cache


def clear_hot_cache() -> int:
    """Drop every cached table (session shutdown, tests)."""
    c = _cache
    return c.clear() if c is not None else 0

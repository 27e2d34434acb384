"""File scan exec — port of ``TpuFileSourceScanExec``
(``spark_rapids_tpu/io/scan.py``) for Parquet with device decode: one
device batch per file, decoded on the device (``io/parquet_device.py``),
string columns padded to the width ladder (``DEFAULT_WIDTH_BUCKETS``).

The reader type (``spark.rapids.sql.format.parquet.reader.type``) resolves
as the reference's ``_mode`` does: AUTO is MULTITHREADED for more than one
file and COALESCING for one.  With device decode on, the reference decodes
every file on the device, in order, in every mode; only host-decoded files
go to its thread pool, its batch stitch or its prefetch ring.  The port
reads the same way in every mode.  Host decode (``decode.device=false``)
needs pyarrow in the reference and raises here.

The reference's ``_try_device_decode`` catches any decoder failure and
re-reads the file with pyarrow on the host.  The port has no such path: an
unsupported feature or a failed kernel raises, naming the file.

With ``spark.rapids.tpu.scan.hotTableCache.enabled`` a scan first looks up
the hot-table cache (``io/hot_cache.py``): a hit yields the cached device
batches, with no file read, no decode and no upload.  A miss scans as
usual and publishes its batches only when it runs to its end, so a
generator abandoned under a ``limit``, or one that raised, publishes
nothing.
"""
from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import (MAX_READER_BATCH_SIZE_ROWS,
                                           PARQUET_COMPRESSED_TRANSFER,
                                           PARQUET_DEVICE_DECODE,
                                           PARQUET_READER_TYPE,
                                           SCAN_HOT_CACHE,
                                           SCAN_HOT_CACHE_MAX_BYTES, TpuConf)
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.plan.nodes import FileSourceScan

READER_TYPES = ("AUTO", "PERFILE", "COALESCING", "MULTITHREADED")


class TpuFileSourceScanExec(TpuExec):
    def __init__(self, plan: FileSourceScan, conf: TpuConf, device):
        super().__init__([])
        if plan.fmt != "parquet":
            raise NotOnGpu(f"{plan.fmt} scans are not ported yet")
        self.plan = plan
        self.conf = conf
        self.device = device
        self.reader_type = str(conf.get(PARQUET_READER_TYPE)).upper()
        if self.reader_type not in READER_TYPES:
            raise NotOnGpu(f"parquet reader type {self.reader_type}")
        if not conf.get(PARQUET_DEVICE_DECODE):
            raise NotOnGpu(
                "host Parquet decode is not ported (the reference decodes "
                "on the host with pyarrow, which the port does not depend "
                f"on); set {PARQUET_DEVICE_DECODE.key}=true")

    @property
    def output(self):
        return self.plan.output

    def describe(self):
        return (f"TpuFileSourceScan {self.plan.fmt} "
                f"{len(self.plan.paths)} files mode={self._mode()}")

    def _mode(self) -> str:
        if self.reader_type != "AUTO":
            return self.reader_type
        return "MULTITHREADED" if len(self.plan.paths) > 1 else "COALESCING"

    def _hot_cache_key(self):
        """The scan's cache key; the chunking is the reader's row cap."""
        from spark_rapids_tpu_torch.io.hot_cache import HotTableCache

        return HotTableCache.scan_key(
            self.plan.fmt, self.plan.paths,
            [f.name for f in self.plan.output.fields],
            int(self.conf.get(MAX_READER_BATCH_SIZE_ROWS)))

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        cache = key = collected = None
        if self.conf.get(SCAN_HOT_CACHE):
            from spark_rapids_tpu_torch.io.hot_cache import get_hot_cache

            key = self._hot_cache_key()
            if key is not None:
                cache = get_hot_cache()
                hit = cache.get(key)
                if hit is not None:
                    PC.bump("hot_cache_hits")
                    yield from hit
                    return
                PC.bump("hot_cache_misses")
                collected = []
        for b in self._scan():
            if collected is not None:
                collected.append(b)
            yield b
        # reached only when the scan ran to its end: an abandoned
        # generator or a raised fault publishes nothing
        if collected is not None:
            cache.put(key, collected,
                      int(self.conf.get(SCAN_HOT_CACHE_MAX_BYTES)))

    def _scan(self) -> Iterator[ColumnarBatch]:
        """One device batch per file, decoded on the device."""
        from spark_rapids_tpu_torch.io.parquet_device import (
            read_parquet_device)

        compressed = bool(self.conf.get(PARQUET_COMPRESSED_TRANSFER))
        for path in self.plan.paths:
            yield read_parquet_device(path, self.plan.output, self.device,
                                      compressed)

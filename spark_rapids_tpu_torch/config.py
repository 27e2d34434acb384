"""TpuConf — the typed configuration registry (the confs the port reads).

Port of ``spark_rapids_tpu/config.py``: the same ``ConfEntry`` builder DSL
and the same keys and defaults, cut to the confs that TPC-H Q6, bench
qa, qb and qc over Parquet, and the out-of-core path of bench's rung3_ooc
(sized exchanges, spill-backed partition queues, the spill framework and
the sub-partitioned join) read.  Unlike the reference there is no
process-wide ambient conf: the session hands its ``TpuConf`` to every exec
that needs one.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

_REGISTRY: "Dict[str, ConfEntry]" = {}


class ConfEntry:
    def __init__(self, key: str, doc: str, conv: Callable[[str], Any],
                 default: Any, typ: str):
        self.key = key
        self.doc = doc
        self.conv = conv
        self.default = default
        self.typ = typ

    def get(self, settings: Dict[str, str]) -> Any:
        raw = settings.get(self.key)
        if raw is None:
            raw = os.environ.get("SRT_" + self.key.replace(".", "_").upper())
        if raw is None:
            return self.default
        return self.conv(raw) if isinstance(raw, str) else raw


class _Builder:
    def __init__(self, key: str):
        self.key = key
        self._doc = ""

    def doc(self, d: str) -> "_Builder":
        self._doc = d
        return self

    def _register(self, conv, default, typ):
        e = ConfEntry(self.key, self._doc, conv, default, typ)
        _REGISTRY[self.key] = e
        return e

    def boolean_conf(self, default: bool) -> ConfEntry:
        return self._register(
            lambda s: s.strip().lower() in ("true", "1", "yes"), default,
            "boolean")

    def integer_conf(self, default: int) -> ConfEntry:
        return self._register(int, default, "integer")

    def double_conf(self, default: float) -> ConfEntry:
        return self._register(float, default, "double")

    def string_conf(self, default: Optional[str]) -> ConfEntry:
        return self._register(lambda s: s, default, "string")

    def bytes_conf(self, default: int) -> ConfEntry:
        return self._register(_parse_bytes, default, "bytes")



def conf(key: str) -> _Builder:
    return _Builder(key)


_UNITS = {"b": 1, "k": 1 << 10, "kb": 1 << 10, "m": 1 << 20, "mb": 1 << 20,
          "g": 1 << 30, "gb": 1 << 30, "t": 1 << 40, "tb": 1 << 40}


def _parse_bytes(s: str) -> int:
    s = s.strip().lower()
    for suffix in sorted(_UNITS, key=len, reverse=True):
        if s.endswith(suffix):
            num = s[: -len(suffix)].strip()
            if num:
                return int(float(num) * _UNITS[suffix])
    return int(s)


SQL_ENABLED = conf("spark.rapids.sql.enabled").doc(
    "Master enable for plan rewriting onto the device.  The port has no "
    "CPU oracle yet, so false raises at collect().").boolean_conf(True)

ANSI_ENABLED = conf("spark.sql.ansi.enabled").doc(
    "Spark ANSI mode: overflow/invalid-cast raise instead of null/wrap."
).boolean_conf(False)

BATCH_SIZE_BYTES = conf("spark.rapids.sql.batchSizeBytes").doc(
    "Target columnar batch size: the coalescing goal over an exchange, the "
    "drain chunk of the spill-backed exchange queues, and the build-side "
    "size past which a join sub-partitions both sides into hash buckets "
    "at run time.").bytes_conf(1 << 30)

AUTO_BROADCAST_JOIN_THRESHOLD = conf(
    "spark.sql.autoBroadcastJoinThreshold").doc(
    "Estimated build-side size below which joins broadcast instead of "
    "shuffling (file scans: sizes on disk; local tables: their host "
    "columns).  -1 disables broadcasting.").bytes_conf(10 << 20)

ADAPTIVE_ENABLED = conf("spark.sql.adaptive.enabled").doc(
    "AQE analog: shuffled equi-joins re-plan themselves at execution time "
    "— the build side materializes first and, when its measured bytes sit "
    "under spark.sql.autoBroadcastJoinThreshold, the join runs broadcast "
    "with both planned exchanges elided (runtime stats beat static "
    "planning).").boolean_conf(True)

EXCHANGE_COALESCE_SMALL_BYTES = conf(
    "spark.rapids.tpu.exchange.coalesceSmallPartitionBytes").doc(
    "AQE shuffle-read coalescing threshold: adjacent reduce partitions "
    "below this byte size merge into one read window in "
    "TpuAdaptiveShuffleReaderExec (counted by partitions_coalesced); "
    "partitions at or above it emit alone.  The batch-size goal still "
    "caps each window.").bytes_conf(4 << 20)

MAX_READER_BATCH_SIZE_ROWS = conf(
    "spark.rapids.sql.reader.batchSizeRows").doc(
    "Soft cap on rows per batch produced by readers (the in-memory scan "
    "splits its rows into batches of this size).").integer_conf(2147483647)

PARQUET_READER_TYPE = conf("spark.rapids.sql.format.parquet.reader.type").doc(
    "PERFILE, COALESCING, MULTITHREADED, or AUTO (MULTITHREADED for more "
    "than one file, else COALESCING).  With decode.device on, every mode "
    "decodes each file on the device, in order, as the reference does."
).string_conf("AUTO")

PARQUET_DEVICE_DECODE = conf(
    "spark.rapids.sql.format.parquet.decode.device").doc(
    "Decode Parquet pages on the device (bit-unpack + run expansion + "
    "dictionary gather; the host parses only footers and run headers).  "
    "The port has no host decode: false raises (the reference decodes on "
    "the host with pyarrow, which the port does not depend on)."
).boolean_conf(False)

PARQUET_COMPRESSED_TRANSFER = conf(
    "spark.rapids.sql.format.parquet.transfer.compressed").doc(
    "With decode.device on, ship eligible column chunks to the device as "
    "raw compressed page bytes and decompress them there; pages whose "
    "compressed form is not smaller fall back per chunk to the decoded "
    "transfer (`chunk_decode_fallbacks`).").boolean_conf(True)


# --- memory: pool, spill ---------------------------------------------------

HBM_POOL_FRACTION = conf("spark.rapids.memory.gpu.allocFraction").doc(
    "Fraction of the card's memory the spill framework's pool may track "
    "for batches.").double_conf(0.9)

HBM_RESERVE = conf("spark.rapids.memory.gpu.reserve").doc(
    "Device bytes kept out of the pool for torch's temporaries and "
    "workspaces.").bytes_conf(640 << 20)

HOST_SPILL_STORAGE_SIZE = conf(
    "spark.rapids.memory.host.spillStorageSize").doc(
    "Host memory for spilled device batches before disk.").bytes_conf(1 << 31)

SPILL_DIR = conf("spark.rapids.memory.spillDir").doc(
    "Directory for disk spill (reference: RapidsDiskStore).").string_conf(None)

TEST_DEVICE_MEMORY = conf("spark.rapids.tpu.test.deviceMemoryBytes").doc(
    "Test override for the device memory the pool is computed from; set, "
    "it IS the pool.").bytes_conf(0)

# --- exchange: partition sizing, spill-backed queues ------------------------

SHUFFLE_PARTITIONS = conf("spark.sql.shuffle.partitions").doc(
    "Number of shuffle partitions a join's or a group-by's hash exchange "
    "is planned with.").integer_conf(16)

SHUFFLE_MODE = conf("spark.rapids.shuffle.mode").doc(
    "MULTITHREADED, ICI or CACHE_ONLY.  The port runs a multi-partition "
    "exchange through the spill-backed partition queues; CACHE_ONLY (the "
    "reference's shuffle-manager path) raises.").string_conf("MULTITHREADED")

SHUFFLE_COMPRESSION_CODEC = conf(
    "spark.rapids.shuffle.compression.codec").doc(
    "Codec for serialized shuffle batches: none, lz4, zstd (lz4 and zstd "
    "go to zstandard where it imports, else to zlib level 1).").string_conf(
    "lz4")

SINGLE_DEVICE_SHUFFLE_COALESCE = conf(
    "spark.rapids.tpu.shuffle.singleDeviceCoalesce").doc(
    "On one device, collapse hash and round-robin exchanges that partition "
    "sizing left alone to ONE partition (aggregation and join results do "
    "not depend on the partition count).").boolean_conf(True)

EXCHANGE_SIZED_PARTITIONS = conf(
    "spark.rapids.tpu.exchange.sizedPartitions.enabled").doc(
    "Size-aware exchange partitioning: at plan time, estimate each hash or "
    "round-robin exchange's input bytes from static row counts and GROW "
    "its partition count so one partition fits "
    "exchange.targetPartitionFraction of the pool; sized exchanges are "
    "exempt from the single-device collapse.").boolean_conf(True)

EXCHANGE_TARGET_PARTITION_FRACTION = conf(
    "spark.rapids.tpu.exchange.targetPartitionFraction").doc(
    "Fraction of the pool one exchange partition should fit "
    "(partitions = ceil(estimated bytes / (pool * fraction)))."
).double_conf(0.125)

EXCHANGE_MAX_PARTITIONS = conf(
    "spark.rapids.tpu.exchange.maxPartitions").doc(
    "Upper bound on the partition count sizedPartitions may choose."
).integer_conf(256)

EXCHANGE_SPILL_ENABLED = conf(
    "spark.rapids.tpu.exchange.spill.enabled").doc(
    "Stream exchange partitions through spill-backed partition queues: "
    "slices stay on the device as tracked handles up to "
    "exchange.deviceResidentBytes, then cross to the host as CRC-framed "
    "serializer blocks.  false (the reference's shuffle-manager path) "
    "raises in the port.").boolean_conf(True)

EXCHANGE_DEVICE_RESIDENT_BYTES = conf(
    "spark.rapids.tpu.exchange.deviceResidentBytes").doc(
    "Device bytes the exchange queues may keep resident before further "
    "slices serialize to host blocks.  0 derives it from the pool: "
    "pool * exchange.targetPartitionFraction * 2.").bytes_conf(0)

ICI_HOST_BOUNDARY_CODEC = conf(
    "spark.rapids.tpu.ici.hostBoundaryCodec").doc(
    "Codec for the CRC-framed blocks crossing the exchange's host "
    "boundary.  Unset defers to spark.rapids.shuffle.compression.codec."
).string_conf(None)


class TpuConf:
    """Immutable snapshot view over a settings dict (RapidsConf analog)."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self.settings: Dict[str, Any] = dict(settings or {})

    def get(self, entry: ConfEntry):
        return entry.get(self.settings)

    @property
    def sql_enabled(self):
        return self.get(SQL_ENABLED)

    @property
    def ansi_enabled(self):
        return self.get(ANSI_ENABLED)

    def is_op_enabled(self, op_name: str, kind: str = "expression") -> bool:
        """The per-operator switch ``spark.rapids.sql.<kind>.<OpName>``
        (reference: ``RapidsConf.isOperatorEnabled``)."""
        raw = self.settings.get(f"spark.rapids.sql.{kind}.{op_name}")
        if raw is None:
            return True
        return str(raw).strip().lower() in ("true", "1", "yes")

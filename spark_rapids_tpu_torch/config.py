"""TpuConf — the typed configuration registry (the confs the port reads).

Port of ``spark_rapids_tpu/config.py``: the same ``ConfEntry`` builder DSL
and the same keys and defaults, cut to the confs that TPC-H Q6, bench
qa, qb and qc over Parquet, the out-of-core path of bench's rung3_ooc
(sized exchanges, spill-backed partition queues, the spill framework and
the sub-partitioned join), bench's rung4_dist (the query lifecycle,
the shuffle manager, the circuit breaker and the distributed tier), and
bench's rung5_recovery and q6_parquet_hot (the query journal and the
hot-table cache), and the string columns of TPC-H Q12 read.
Unlike the reference there is no process-wide ambient conf: the session
hands its ``TpuConf`` to every exec that needs one.
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
    "MULTITHREADED, ICI or CACHE_ONLY.  CACHE_ONLY runs a multi-partition "
    "exchange through the shuffle manager with its slices kept on the "
    "device; the other modes go through the spill-backed partition "
    "queues.").string_conf("MULTITHREADED")

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
    "serializer blocks.  false runs the exchange through the shuffle "
    "manager (shuffle/manager.py).").boolean_conf(True)

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


SHUFFLE_MT_WRITER_THREADS = conf(
    "spark.rapids.shuffle.multiThreaded.writer.threads").doc(
    "Threads of the shuffle manager's writer pool (MULTITHREADED mode "
    "serializes each map output's slices on it).").integer_conf(20)

# --- query lifecycle: admission, deadlines, cancellation --------------------

CONCURRENT_QUERIES = conf("spark.rapids.tpu.concurrentQueries").doc(
    "How many queries may be admitted (planning + executing) at once; "
    "further collects wait in a FIFO admission queue "
    "(lifecycle/admission.py).  0 disables admission control."
).integer_conf(4)

ADMISSION_MAX_QUEUE = conf("spark.rapids.tpu.admission.maxQueueDepth").doc(
    "Bound on queries waiting for admission; a collect arriving at a "
    "full queue fast-rejects with QueryRejected.").integer_conf(16)

ADMISSION_QUEUE_TIMEOUT_MS = conf(
    "spark.rapids.tpu.admission.queueTimeoutMs").doc(
    "Max time a query waits in the admission queue before rejecting "
    "with QueryRejected.  0 waits indefinitely (still cancellable and "
    "deadline-trippable).").integer_conf(0)

QUERY_TIMEOUT_MS = conf("spark.rapids.tpu.query.timeoutMs").doc(
    "Per-query deadline armed at collect: the watchdog thread trips the "
    "query's CancelToken once it passes, and the exchange's blocking "
    "sites raise QueryDeadlineExceeded cooperatively.  0 disables."
).integer_conf(0)

QUERY_WATCHDOG_PERIOD_MS = conf(
    "spark.rapids.tpu.query.watchdogPeriodMs").doc(
    "Scan period of the deadline watchdog thread.").double_conf(50.0)

# --- resilience: the circuit breaker ----------------------------------------

RESILIENCE_ENABLED = conf("spark.rapids.tpu.resilience.enabled").doc(
    "Let the circuit breaker hold plan nodes that failed "
    "deterministically off the device (resilience/breaker.py "
    "consult_plan).").boolean_conf(True)

RESILIENCE_BREAKER_TTL_SEC = conf(
    "spark.rapids.tpu.resilience.breakerTtlSec").doc(
    "How long an open breaker entry holds its key before a half-open "
    "probe re-admits it; the distributed coordinator quarantines a "
    "rejoining lost worker for this long.").double_conf(300.0)

# --- distributed: the coordinator and its worker processes ------------------

DISTRIBUTED_ENABLED = conf("spark.rapids.tpu.distributed.enabled").doc(
    "Route multi-partition exchanges through the worker tier "
    "(distributed/): a coordinator places reduce partitions over worker "
    "processes, blocks ship as CRC-framed TKU2 blocks, and the engine's "
    "partition queues retain every shipped block until its partition is "
    "read, so a worker lost mid-shuffle is recovered by re-placing its "
    "partitions and re-driving the retained blocks.  With no coordinator "
    "or no placeable worker, exchanges run in process."
).boolean_conf(False)

DISTRIBUTED_HEARTBEAT_MS = conf(
    "spark.rapids.tpu.distributed.heartbeatMs").doc(
    "Worker heartbeat period; the coordinator's monitor scans at the "
    "same period and counts a worker late (worker_heartbeat_misses) past "
    "two periods of silence.").integer_conf(200)

DISTRIBUTED_WORKER_LOST_MS = conf(
    "spark.rapids.tpu.distributed.workerLostMs").doc(
    "Heartbeat silence after which a worker whose data port also fails a "
    "ping is declared LOST: its partitions re-place onto survivors and "
    "its breaker entry opens.").integer_conf(1200)

DISTRIBUTED_OP_TIMEOUT_MS = conf(
    "spark.rapids.tpu.distributed.opTimeoutMs").doc(
    "Socket timeout of one data-plane operation (put, fetch, release) "
    "against a worker.").integer_conf(4000)

DISTRIBUTED_PUT_RETRIES = conf(
    "spark.rapids.tpu.distributed.putRetries").doc(
    "Transient retries (reconnect and resend) of one data-plane "
    "operation before the worker is declared lost.").integer_conf(2)

DISTRIBUTED_REDRIVE_MAX = conf(
    "spark.rapids.tpu.distributed.redriveMaxAttempts").doc(
    "How many times one reduce partition may be re-placed and re-driven "
    "before WorkerLost escapes the exchange.").integer_conf(4)

DISTRIBUTED_WORKER_MEM = conf(
    "spark.rapids.tpu.distributed.workerMemoryBytes").doc(
    "Default block-store memory of a spawned worker; blocks past it go to "
    "the worker's spill directory.").bytes_conf(64 << 20)

DISTRIBUTED_LOSS_BREAKER_THRESHOLD = conf(
    "spark.rapids.tpu.distributed.lossBreakerThreshold").doc(
    "Loss declarations that open a worker's breaker entry: a lost worker "
    "that rejoins is QUARANTINED (heartbeats, gets no placements) until "
    "the breaker TTL admits a probe.").integer_conf(1)

DISTRIBUTED_TRACE_ENABLED = conf(
    "spark.rapids.tpu.distributed.traceEnabled").doc(
    "Stamp the query's trace id on every data-plane frame, so workers "
    "record each put, fetch and release in their span ring attributed "
    "to the query.").boolean_conf(True)

DISTRIBUTED_TELEMETRY_RING = conf(
    "spark.rapids.tpu.distributed.telemetryRingSize").doc(
    "Capacity of a worker's span ring and of the coordinator's mirror of "
    "it.  0 disables span recording (counters still travel on the "
    "heartbeats).").integer_conf(512)

DISTRIBUTED_HEDGE_ENABLED = conf(
    "spark.rapids.tpu.distributed.hedgeEnabled").doc(
    "Hedged fetches: a page fetch that passes its worker's soft deadline "
    "is served from the engine's retained copy of the partition, first "
    "answer wins (fetch_hedges, hedges_won).").boolean_conf(True)

DISTRIBUTED_SOFT_DEADLINE_FACTOR = conf(
    "spark.rapids.tpu.distributed.softDeadlineFactor").doc(
    "Multiplier over a worker's p95-biased latency EWMA that sets its "
    "soft deadline.").double_conf(3.0)

DISTRIBUTED_SOFT_DEADLINE_MIN_MS = conf(
    "spark.rapids.tpu.distributed.softDeadlineMinMs").doc(
    "Floor of the per-worker soft deadline.").integer_conf(50)

DISTRIBUTED_SLOW_FACTOR = conf(
    "spark.rapids.tpu.distributed.slowFactor").doc(
    "A worker whose latency EWMA stays past slowFactor x the fleet median "
    "(or that misses degradeAfterMisses soft deadlines in a row) is "
    "DEGRADED: demoted in placement, its partitions re-driven onto "
    "healthy workers, not declared lost.").double_conf(4.0)

DISTRIBUTED_DEGRADE_AFTER_MISSES = conf(
    "spark.rapids.tpu.distributed.degradeAfterMisses").doc(
    "Consecutive soft-deadline misses before a worker is DEGRADED."
).integer_conf(3)

DISTRIBUTED_PROMOTE_AFTER_OKS = conf(
    "spark.rapids.tpu.distributed.promoteAfterOks").doc(
    "Consecutive in-deadline observations a DEGRADED worker needs, its "
    "EWMA back under slowFactor x the fleet median, to be ALIVE again."
).integer_conf(3)

# --- crash-consistent driver recovery (lifecycle/journal.py) ---------------

RECOVERY_ENABLED = conf("spark.rapids.tpu.recovery.enabled").doc(
    "Crash-consistent driver recovery: every collect appends admission, "
    "plan, stage-checkpoint and end records to a durable CRC-framed "
    "query journal (lifecycle/journal.py); materialized exchange outputs "
    "commit at stage boundaries (local: atomic tmp+rename checkpoint "
    "files keyed by the plan-stage fingerprint; distributed: worker-held "
    "partitions pinned by a journaled lease); a restarted driver replays "
    "the journal, classifies prior queries as completed / resumable / "
    "abandoned and serves committed stages instead of re-executing them "
    "(stages_recovered).  Off, the journal module is never called."
).boolean_conf(False)

RECOVERY_DIR = conf("spark.rapids.tpu.recovery.dir").doc(
    "Root directory of the query journal, the stage checkpoints and the "
    "coordinator endpoint file workers re-attach through.  Must be stable "
    "across driver restarts.  Unset: <tmpdir>/srt_recovery."
).string_conf(None)

RECOVERY_FSYNC = conf("spark.rapids.tpu.recovery.fsyncOnAppend").doc(
    "fsync the journal after every appended record (and the checkpoint "
    "files before their rename).  Off: single-write appends already keep "
    "the journal prefix-consistent across a process crash; fsync also "
    "covers a machine crash.").boolean_conf(False)

RECOVERY_LEASE_TTL_MS = conf("spark.rapids.tpu.recovery.leaseTtlMs").doc(
    "How long a journaled stage checkpoint (a lease on worker-held "
    "partitions, or a local checkpoint directory) stays adoptable after "
    "the committing driver's death; a reborn driver retires older ones "
    "(recovery_leases_expired) and re-executes.").integer_conf(120_000)

# --- hot-table cache (io/hot_cache.py) -------------------------------------

SCAN_HOT_CACHE = conf("spark.rapids.tpu.scan.hotTableCache.enabled").doc(
    "Device-resident hot-table cache: a completed file scan registers its "
    "device batches (keyed by the files' sizes and mtimes, the columns, "
    "the pushed filters, the options and the chunking) so a repeated scan "
    "of the same table skips the read, the decode and the transfer "
    "(hot_cache_hits / hot_cache_misses).  Entries are persistent "
    "spillables; TpuSession.close() drops them.").boolean_conf(False)

SCAN_HOT_CACHE_MAX_BYTES = conf(
    "spark.rapids.tpu.scan.hotTableCache.maxBytes").doc(
    "Device-bytes bound of the hot-table cache; inserting past it evicts "
    "the least recently used entries (hot_cache_evictions).  A single scan "
    "larger than the bound is not cached.").bytes_conf(1 << 30)


# --- string columns (columnar/column.py) ------------------------------------

STRING_WIDTH_BUCKETS = conf("spark.rapids.tpu.string.widthBuckets").doc(
    "Char-width buckets for the padded string layout.  Registered as the "
    "reference registers it; like the reference, every layer uses the "
    "default ladder (columnar/column.py DEFAULT_WIDTH_BUCKETS).").string_conf(
    "8,32,128,512,2048")


ENABLE_CAST_STRING_TO_TIMESTAMP = conf(
    "spark.rapids.sql.castStringToTimestamp.enabled").doc(
    "String->timestamp cast compat switch (device civil parser; named "
    "timezones parse as null).").boolean_conf(True)


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

"""TpuConf — the typed configuration registry (the confs the port reads).

Port of ``spark_rapids_tpu/config.py``: the same ``ConfEntry`` builder DSL
and the same keys and defaults, cut to the confs that TPC-H Q6 and bench
qa, qb and qc over Parquet read.  Unlike the reference there is no
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
    "Target columnar batch size.  A broadcast join whose estimated build "
    "side is larger, or a shuffled join whose built side is, needs the "
    "reference's sub-partitioned join, which the port does not run yet: "
    "such a join raises.").bytes_conf(1 << 30)

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
    "PERFILE, COALESCING, MULTITHREADED, or AUTO.  The port reads PERFILE "
    "only; the others raise until a later slice ports them."
).string_conf("AUTO")

PARQUET_DEVICE_DECODE = conf(
    "spark.rapids.sql.format.parquet.decode.device").doc(
    "Decode Parquet pages on the device (bit-unpack + run expansion + "
    "dictionary gather; the host parses only footers and run headers).  "
    "The port has no host decode: false raises.").boolean_conf(False)

PARQUET_COMPRESSED_TRANSFER = conf(
    "spark.rapids.sql.format.parquet.transfer.compressed").doc(
    "With decode.device on, ship eligible column chunks to the device as "
    "raw compressed page bytes and decompress them there; pages whose "
    "compressed form is not smaller fall back per chunk to the decoded "
    "transfer (`chunk_decode_fallbacks`).").boolean_conf(True)


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

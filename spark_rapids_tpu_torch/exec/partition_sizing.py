"""Size-aware exchange partitioning — port of
``spark_rapids_tpu/exec/partition_sizing.py``, the planner half of
out-of-core execution.

Before a batch runs, an exchange's input bytes are estimated from the
plan's static row counts (``aot_output_rows``: the local scan and the
narrow operators above it; an upper bound through a filter,
``aot_output_caps``) times the width of a row, and its partition count
grows so one partition fits ``targetPartitionFraction`` of the pool:

    partitions = clamp(ceil(estimated_bytes / (pool * fraction)),
                       planned, exchange.maxPartitions)

It only ever grows the planned count.  A sized exchange is marked
``_ooc_sized``, so the single-device collapse leaves it alone: on one card
its partitions are the out-of-core schedule, not parallelism.  A file scan
gives no row count, as in the reference, so its exchanges are not sized.
The reference's calibration store (measured row counts) is not ported.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import (EXCHANGE_MAX_PARTITIONS,
                                           EXCHANGE_SIZED_PARTITIONS,
                                           EXCHANGE_TARGET_PARTITION_FRACTION)
from spark_rapids_tpu_torch.memory.device_manager import get_device_manager


def row_width_bytes(schema: T.StructType) -> int:
    """Device bytes of one row: the storage width plus one validity byte
    per field; variable-width fields count the reference's floor."""
    total = 0
    for f in schema.fields:
        dt = f.dataType
        total += 1  # validity
        if isinstance(dt, T.StringType):
            total += 8 + 4          # min chars bucket + lengths(int32)
        elif isinstance(dt, T.ArrayType):
            try:
                total += 8 * np.dtype(
                    T.storage_dtype(dt.elementType)).itemsize + 4
            except TypeError:
                total += 68
        elif isinstance(dt, (T.MapType, T.StructType)):
            total += 16
        elif isinstance(dt, T.DecimalType) and dt.is_128:
            total += 16
        else:
            try:
                total += np.dtype(T.storage_dtype(dt)).itemsize
            except TypeError:
                total += 8
    return max(total, 1)


def _static_rows(child) -> Optional[int]:
    """Plan-static row count: exact where ``aot_output_rows`` is known."""
    fn = getattr(child, "aot_output_rows", None)
    rows = fn() if fn is not None else None
    return int(sum(rows)) if rows else None


def _static_caps(child) -> Optional[int]:
    """Upper bound of the rows (through filters)."""
    fn = getattr(child, "aot_output_caps", None)
    caps = fn() if fn is not None else None
    return int(sum(caps)) if caps else None


def estimate_input_bytes(child, conf) -> Optional[int]:
    """Estimated bytes the exchange will move: exact static rows, else the
    upper bound; None when neither is known."""
    rows = _static_rows(child)
    if rows is None:
        rows = _static_caps(child)
    if rows is None:
        return None
    return rows * row_width_bytes(child.output)


def target_partition_bytes(conf) -> int:
    """The per-partition budget: pool * fraction."""
    pool = get_device_manager().pool_bytes
    frac = conf.get(EXCHANGE_TARGET_PARTITION_FRACTION)
    return max(int(pool * frac), 1 << 16)


def choose_partition_count(exchange, conf) -> Optional[int]:
    """The sized partition count for one exchange, or None when the
    planned count stands (no estimate, or it fits already)."""
    est = estimate_input_bytes(exchange.children[0], conf)
    if est is None:
        return None
    target = target_partition_bytes(conf)
    want = max(int(math.ceil(est / float(target))), 1)
    want = min(want, conf.get(EXCHANGE_MAX_PARTITIONS))
    if want <= exchange.num_partitions:
        return None
    exchange._ooc_est_bytes = est
    return want


def size_exchange_partitions(node, conf):
    """Plan rewrite: grow hash and round-robin exchange partition counts so
    each partition fits the pool-fraction target.  Mutates in place."""
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.plan.nodes import (HashPartitioning,
                                                   RoundRobinPartitioning)

    if not conf.get(EXCHANGE_SIZED_PARTITIONS):
        return node
    node.children = [size_exchange_partitions(c, conf)
                     for c in node.children]
    if not (isinstance(node, TpuShuffleExchangeExec)
            and isinstance(node.partitioning,
                           (HashPartitioning, RoundRobinPartitioning))):
        return node
    want = choose_partition_count(node, conf)
    if want is None:
        return node
    prev = node.num_partitions
    node.partitioning.num_partitions = want
    node._ooc_sized = True
    node.sized_decision = (f"sized {prev}->{want} partitions "
                           f"(est {node._ooc_est_bytes}B)")
    PC.bump("exchange_partitions_planned")
    return node

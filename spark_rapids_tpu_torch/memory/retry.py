"""Cooperative OOM retry — port of ``spark_rapids_tpu/memory/retry.py``.

Per-batch work runs inside a retry block (reference: RmmRapidsRetryIterator
``withRetry`` / ``withRetryNoSplit``).  A ``TpuRetryOOM`` rolls back,
spills and runs the block again; a ``TpuSplitAndRetryOOM`` splits the input
in half by rows and runs each half.  On the card a failed allocation is a
``torch.cuda.OutOfMemoryError``: the block spills every unpinned handle,
hands the caching allocator's free blocks back to CUDA
(``torch.cuda.empty_cache``) once the failed attempt's tensors are
unreachable, and splits the input where it can, else runs it again.  The
injection hooks are the reference's test API.  The reference's governor
preemption and cancellation checks are not ported.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterator, List, TypeVar, Union

import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.memory.spill import (SpillableColumnarBatch,
                                                 get_spill_framework)

X = TypeVar("X")


class TpuRetryOOM(RuntimeError):
    """Roll back and retry the block (after the framework spills)."""


class TpuSplitAndRetryOOM(RuntimeError):
    """Roll back, split the input in half by rows, retry each half."""


class _InjectState(threading.local):
    def __init__(self):
        self.retry_count = 0
        self.split_count = 0


_inject = _InjectState()


def force_retry_oom(count: int = 1) -> None:
    """Test hook (reference: RmmSpark.forceRetryOOM)."""
    _inject.retry_count = count


def force_split_and_retry_oom(count: int = 1) -> None:
    """Test hook (reference: RmmSpark.forceSplitAndRetryOOM)."""
    _inject.split_count = count


def _check_injection() -> None:
    if _inject.retry_count > 0:
        _inject.retry_count -= 1
        raise TpuRetryOOM("injected")
    if _inject.split_count > 0:
        _inject.split_count -= 1
        raise TpuSplitAndRetryOOM("injected")


def _is_device_oom(exc: BaseException) -> bool:
    """A device OOM anywhere in the cause/context chain (a layer may wrap
    it with ``raise X from e``): ``resilience/classify.py``'s one
    predicate."""
    from spark_rapids_tpu_torch.resilience.classify import is_device_oom

    return is_device_oom(exc)


def _release_device_memory(fw) -> None:
    """Spill every unpinned handle, then return the caching allocator's
    free blocks to CUDA, so the next attempt can allocate."""
    fw.spill_device_pressure()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def split_in_half_by_rows(
        spillable: SpillableColumnarBatch) -> List[SpillableColumnarBatch]:
    """Reference analog: splitSpillableInHalfByRows."""
    batch = spillable.get_batch()
    n = batch.num_rows
    if n < 2:
        raise TpuSplitAndRetryOOM(
            f"cannot split batch of {n} rows any further")
    half = n // 2
    fw = get_spill_framework()
    first = fw.track(batch.slice_rows(0, half))
    second = fw.track(batch.slice_rows(half, n - half))
    spillable.close()
    return [first, second]


def with_retry(
        inputs: Union[SpillableColumnarBatch, List[SpillableColumnarBatch]],
        fn: Callable[[ColumnarBatch], X],
        max_attempts: int = 8,
        min_split_rows: int = 8) -> Iterator[X]:
    """Run ``fn`` over each input batch with OOM retry and split-and-retry;
    one result per (possibly split) input.  ``fn`` must be re-runnable."""
    queue: List[SpillableColumnarBatch] = (
        [inputs] if isinstance(inputs, SpillableColumnarBatch) else
        list(inputs))
    fw = get_spill_framework()
    split_rows = max(min_split_rows, 2)
    try:
        while queue:
            item = queue.pop(0)
            attempts = 0
            while True:
                attempts += 1
                device_oom = False
                try:
                    _check_injection()
                    item.pin()
                    try:
                        result = fn(item.get_batch())
                    finally:
                        item.unpin()
                    item.close()
                    yield result
                    break
                except TpuRetryOOM:
                    if attempts >= max_attempts:
                        item.close()
                        raise
                    fw.spill_device_pressure()
                    continue
                except TpuSplitAndRetryOOM:
                    if item.num_rows < split_rows:
                        item.close()
                        raise
                    PC.bump("oom_retry_splits")
                    queue = split_in_half_by_rows(item) + queue
                    break
                except Exception as e:
                    if not _is_device_oom(e):
                        item.close()
                        raise
                    if attempts >= max_attempts and \
                            item.num_rows < split_rows:
                        item.close()
                        raise
                    device_oom = True
                if device_oom:
                    # outside the handler: the failed attempt's frames,
                    # and the tensors they hold, are gone by now
                    _release_device_memory(fw)
                    if item.num_rows >= split_rows:
                        PC.bump("oom_retry_splits")
                        queue = split_in_half_by_rows(item) + queue
                        break
    finally:
        # an abandoned generator, or any raise above, must not leak the
        # still-queued handles; the item in flight is closed before its
        # yield
        for q in queue:
            q.close()


def with_retry_no_split(fn: Callable[[], X], max_attempts: int = 8) -> X:
    """Reference analog: withRetryNoSplit — retry a block (spilling between
    attempts) without an input to split."""
    fw = get_spill_framework()
    attempts = 0
    while True:
        attempts += 1
        try:
            _check_injection()
            return fn()
        except TpuRetryOOM:
            if attempts >= max_attempts:
                raise
            fw.spill_device_pressure()
            continue
        except TpuSplitAndRetryOOM:
            raise
        except Exception as e:
            if not _is_device_oom(e) or attempts >= max_attempts:
                raise
        _release_device_memory(fw)

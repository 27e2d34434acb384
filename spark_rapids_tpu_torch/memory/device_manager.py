"""TpuDeviceManager — the pool the spill framework enforces (port of
``spark_rapids_tpu/memory/device_manager.py``).

The pool is a budget over the bytes of tracked batches, as in the
reference: ``allocFraction`` of the card's memory minus a reserve for
torch's temporaries.  It caps nothing in torch's caching allocator.  The
card's size comes from ``torch.cuda.mem_get_info`` where the reference asks
``jax.local_devices()[0].memory_stats()``; on the CPU, and whenever
``spark.rapids.tpu.test.deviceMemoryBytes`` is set, the override or a 16 GiB
default stands in for it (the override then IS the pool).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from spark_rapids_tpu_torch.config import (HBM_POOL_FRACTION, HBM_RESERVE,
                                           TEST_DEVICE_MEMORY, TpuConf)


def _physical_device_bytes(device) -> Optional[int]:
    if device is None or torch.device(device).type != "cuda":
        return None
    _free, total = torch.cuda.mem_get_info(torch.device(device))
    return int(total)


class TpuDeviceManager:
    """Computes and holds the pool budget."""

    def __init__(self, tpu_conf: Optional[TpuConf] = None, device=None):
        c = tpu_conf or TpuConf()
        override = c.get(TEST_DEVICE_MEMORY)
        physical = override or _physical_device_bytes(device) or (16 << 30)
        reserve = c.get(HBM_RESERVE)
        frac = c.get(HBM_POOL_FRACTION)
        self.physical_bytes = physical
        self.pool_bytes = override if override else max(
            int(physical * frac) - reserve, 64 << 20)
        self.reserve_bytes = reserve

    def describe(self) -> str:
        return (f"TpuDeviceManager pool={self.pool_bytes >> 20}MiB "
                f"physical={self.physical_bytes >> 20}MiB "
                f"reserve={self.reserve_bytes >> 20}MiB")


_lock = threading.Lock()
_manager: Optional[TpuDeviceManager] = None


def get_device_manager(tpu_conf: Optional[TpuConf] = None,
                       device=None) -> TpuDeviceManager:
    """The process's manager; given a conf, a new one built from it."""
    global _manager
    with _lock:
        if _manager is None or tpu_conf is not None:
            _manager = TpuDeviceManager(tpu_conf, device)
        return _manager


def reset_device_manager() -> None:
    global _manager
    with _lock:
        _manager = None

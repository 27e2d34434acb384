"""Device choice for the port's entry points.

Entry points run on ``cuda`` unless the caller names another device, as the
CPU tests do with ``device="cpu"``.  Without a device argument and without a
GPU they raise: the port never drops quietly to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)

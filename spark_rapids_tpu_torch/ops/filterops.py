"""Stream compaction and row gathers — port of
``spark_rapids_tpu/ops/filterops.py`` for flat, string and struct columns
(a string's chars and lengths and a struct's children move with it).

The reference compacts with a cumsum and a scatter into a padded batch and
hands the kept count back on the device.  A port batch holds exactly its
rows, so compaction gathers the kept row indices (``torch.nonzero``), and
their count is a host sync.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


def compact_columns(mask: torch.Tensor, cols: List[DeviceColumn]
                    ) -> Tuple[List[DeviceColumn], int]:
    """Keep the rows where ``mask`` holds, in order; the row count costs
    one host sync."""
    idx = torch.nonzero(mask).squeeze(1)
    PC.bump("host_syncs")
    return gather_columns(idx, cols), int(idx.shape[0])


def gather_columns(indices: torch.Tensor, cols: List[DeviceColumn]
                   ) -> List[DeviceColumn]:
    """Row gather: ``out[i] = col[indices[i]]``, indices in ``[0, rows)``.
    (The reference's ``valid_out``, which nulls the rows an outer join
    pads, waits for the outer joins.)"""
    return [c.gather(indices) for c in cols]

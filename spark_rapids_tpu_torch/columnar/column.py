"""Device/host column vectors — port of ``spark_rapids_tpu/columnar/column.py``.

Flat columns only in this slice (int, long, date, bool, double, decimal64
and the decimal128 limbs), with the reference's value semantics so results
compare bit for bit:

* validity is a bool vector (True = valid);
* decimals of 18 digits or fewer are unscaled int64; above 18 digits a
  ``(n, 2)`` int64 ``[hi, lo]`` limb pair (see ``expr/decimal128.py``);
* DATE is int32 days since the epoch.

The reference pads every column to a power-of-two row capacity to bound XLA
recompiles; PyTorch takes sizes at run time, so a port column holds exactly
``num_rows`` rows and ``capacity == num_rows``.
"""
from __future__ import annotations

import dataclasses
import datetime as _dt
from decimal import Decimal
from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.perfcounters import sync_get, to_device

_EPOCH = _dt.date(1970, 1, 1)


def torch_dtype(np_dtype) -> torch.dtype:
    """torch dtype for a numpy storage dtype."""
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def column_torch_dtype(dt: T.DataType) -> torch.dtype:
    return torch_dtype(T.storage_dtype(dt))


@dataclasses.dataclass
class DeviceColumn:
    """One flat column on a torch device.

    data: (n,) tensor of the storage dtype, or (n, 2) int64 [hi, lo] limbs
    for decimal(p>18).  validity: (n,) bool, True = valid.
    """

    dtype: T.DataType
    validity: torch.Tensor
    data: Optional[torch.Tensor] = None

    @property
    def is_dec128(self) -> bool:
        return isinstance(self.dtype, T.DecimalType) and self.dtype.is_128

    @property
    def capacity(self) -> int:
        return int(self.validity.shape[0])

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def nbytes(self) -> int:
        """Bytes of the validity (one a row) and the data."""
        return int(self.validity.numel()
                   + self.data.numel() * self.data.element_size())

    @staticmethod
    def from_host(h: "HostColumn", device) -> "DeviceColumn":
        return DeviceColumn(h.dtype, to_device(h.validity, device),
                            data=to_device(h.data, device))

    def to_host(self, num_rows: int) -> "HostColumn":
        validity, data = sync_get(self.validity[:num_rows],
                                  self.data[:num_rows])
        return HostColumn(self.dtype, validity, data=data)


@dataclasses.dataclass
class HostColumn:
    """Host-side flat column (numpy), the interchange point with Python."""

    dtype: T.DataType
    validity: np.ndarray
    data: Optional[np.ndarray] = None

    @property
    def num_rows(self) -> int:
        return int(self.validity.shape[0])

    def slice_rows(self, start: int, end: int) -> "HostColumn":
        return HostColumn(self.dtype, self.validity[start:end],
                          data=self.data[start:end])

    @staticmethod
    def from_numpy(arr: np.ndarray, dtype: T.DataType,
                   validity: Optional[np.ndarray] = None) -> "HostColumn":
        v = validity if validity is not None else np.ones(len(arr), np.bool_)
        return HostColumn(dtype, v, data=np.ascontiguousarray(arr))

    @staticmethod
    def from_pylist(values: List, dtype: T.DataType) -> "HostColumn":
        from spark_rapids_tpu_torch.expr.decimal128 import limbs_of

        n = len(values)
        validity = np.array([v is not None for v in values], dtype=np.bool_)
        if isinstance(dtype, T.DecimalType) and dtype.is_128:
            data = np.zeros((n, 2), dtype=np.int64)
            for i, v in enumerate(values):
                if v is not None:
                    d = Decimal(str(v)).scaleb(dtype.scale)
                    data[i] = limbs_of(int(d.to_integral_value()))
            return HostColumn(dtype, validity, data=data)
        data = np.zeros(n, dtype=T.storage_dtype(dtype))
        for i, v in enumerate(values):
            if v is None:
                continue
            if isinstance(dtype, T.DecimalType):
                d = Decimal(str(v)).scaleb(dtype.scale)
                data[i] = int(d.to_integral_value())
            elif isinstance(dtype, T.BooleanType):
                data[i] = bool(v)
            elif isinstance(dtype, T.DateType):
                data[i] = (v - _EPOCH).days if isinstance(v, _dt.date) else v
            else:
                data[i] = v
        return HostColumn(dtype, validity, data=data)

    def to_pylist(self) -> List:
        from spark_rapids_tpu_torch.expr.decimal128 import to_py

        out: List = []
        for i in range(self.num_rows):
            if not self.validity[i]:
                out.append(None)
            elif isinstance(self.dtype, T.DecimalType):
                v = (to_py(int(self.data[i, 0]), int(self.data[i, 1]))
                     if self.dtype.is_128 else int(self.data[i]))
                out.append(Decimal(v).scaleb(-self.dtype.scale))
            elif isinstance(self.dtype, T.BooleanType):
                out.append(bool(self.data[i]))
            elif isinstance(self.dtype, (T.FloatType, T.DoubleType)):
                out.append(float(self.data[i]))
            elif isinstance(self.dtype, T.DateType):
                out.append(_EPOCH + _dt.timedelta(days=int(self.data[i])))
            else:
                out.append(int(self.data[i]))
        return out

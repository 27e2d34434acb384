"""Carry the JAX package's column arrays into the port.

``batch_from_numpy`` builds a port ``ColumnarBatch`` from numpy column
arrays as the reference holds them (data, validity, and the ``[hi, lo]``
limbs of decimal128), so a test can feed both engines identical batches.
The data plays the part that weights play in a model port.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn


def batch_from_numpy(columns: Sequence, schema: T.StructType,
                     device) -> ColumnarBatch:
    """``columns``: one entry per schema field, each a ``(data, validity)``
    pair of numpy arrays or an object with ``.data`` and ``.validity``
    (the reference's ``HostColumn``).  ``data`` is ``(n,)`` of the field's
    storage dtype, or ``(n, 2)`` int64 limbs for decimal(p>18); a string
    field's entry is a ``(values, validity)`` pair of ``str`` or ``bytes``
    values, or a reference ``HostColumn`` (``.chars``, ``.lengths``).  A
    reference column padded past ``n`` rows is cut to the batch's rows,
    which is the shortest validity given."""
    if len(columns) != len(schema.fields):
        raise ValueError(f"{len(columns)} columns for "
                         f"{len(schema.fields)} schema fields")
    pairs = [(c.data, c.validity) if hasattr(c, "validity") else tuple(c)
             for c in columns]
    n = min((len(v) for _, v in pairs), default=0)
    cols = []
    for c, (data, validity), f in zip(columns, pairs, schema.fields):
        validity = np.asarray(validity, np.bool_)[:n]
        if isinstance(f.dataType, T.StringType):
            host = (HostColumn(T.STRING, validity,
                               chars=np.asarray(c.chars)[:n],
                               lengths=np.asarray(c.lengths)[:n])
                    if hasattr(c, "chars") else
                    HostColumn.strings(list(data)[:n], validity))
            cols.append(DeviceColumn.from_host(host, device))
            continue
        data = np.asarray(data)[:n]
        want = ((n, 2) if isinstance(f.dataType, T.DecimalType)
                and f.dataType.is_128 else (n,))
        if data.shape != want:
            raise ValueError(f"column {f.name}: shape {data.shape}, "
                             f"expected {want}")
        cols.append(DeviceColumn.from_host(HostColumn(
            f.dataType, validity,
            data=data.astype(T.storage_dtype(f.dataType), copy=False)),
            device))
    return ColumnarBatch(cols, n, schema)

"""The host boundary of an exchange — port of ``ici_host_frame`` from
``spark_rapids_tpu/exec/ici.py``.

A batch that crosses to the host (an out-of-core exchange's over-budget
slice, a distributed exchange's shipped slice) becomes one CRC32-checked
TKU2 block (``shuffle/serializer.py``), so a flipped bit anywhere between
write and read raises ``ShuffleCorruption`` instead of giving wrong rows.
A reader checks and decodes blocks with
``shuffle/serializer.py::deserialize_concat``, so the reference's
one-block ``ici_host_unframe`` is not ported, nor are its collectives
(the mesh all-to-all), which need a second card.
"""
from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


def ici_host_frame(batch: ColumnarBatch,
                   codec: Optional[str] = None) -> bytes:
    """One batch as one TKU2 block on the host."""
    from spark_rapids_tpu_torch.shuffle.serializer import serialize_batch

    return serialize_batch(batch, codec=codec)


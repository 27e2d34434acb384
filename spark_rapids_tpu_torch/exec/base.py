"""TpuExec — base of the port's device operators (port of
``spark_rapids_tpu/exec/base.py`` without its metrics, tracing and service
hooks).  An operator yields an iterator of device ``ColumnarBatch``es; its
work is eager torch code on the batch's device.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch


class NotOnGpu(NotImplementedError):
    """A plan node, expression or option that this slice of the port does
    not run on the device.  The port has no CPU fallback: it raises."""

    def __init__(self, what: str):
        super().__init__(f"not on GPU: {what}")


class TpuExec:
    def __init__(self, children: Sequence["TpuExec"]):
        self.children: List[TpuExec] = list(children)

    @property
    def output(self) -> T.StructType:
        raise NotImplementedError

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def describe(self) -> str:
        return self.node_name

    def pretty(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self.children:
            s += "\n" + c.pretty(indent + 1)
        return s

    def execute_columnar(self) -> Iterator[ColumnarBatch]:
        raise NotImplementedError

    def aot_output_rows(self) -> Optional[List[int]]:
        """Per-batch row counts this operator will emit, where the plan
        alone gives them (the local scan and the narrow operators above
        it); None where they depend on the data.  Partition sizing reads
        them."""
        return None

    def aot_output_caps(self) -> Optional[List[int]]:
        """Upper bounds of the per-batch row counts (a filter passes its
        input's through)."""
        return self.aot_output_rows()

    def aot_input_rows(self) -> Optional[List[int]]:
        return self.children[0].aot_output_rows() if self.children else None

    def aot_input_caps(self) -> Optional[List[int]]:
        return self.children[0].aot_output_caps() if self.children else None

    def _device(self):
        """The device of the leftmost leaf: the scan this exec reads."""
        node = self
        while node.children:
            node = node.children[0]
        return node.device

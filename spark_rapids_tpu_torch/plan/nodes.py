"""CPU physical plan nodes — port of the Q6 subset of
``spark_rapids_tpu/plan/nodes.py``.

The session builds this Catalyst-shaped plan; ``overrides/overrides.py``
rewrites it into device execs.  The node names and ``describe`` strings
are the reference's, so explain output reads the same.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.base import Expression


class SparkPlan:
    """Base physical plan node (CPU side)."""

    def __init__(self, children: Sequence["SparkPlan"]):
        self.children: List[SparkPlan] = list(children)

    @property
    def output(self) -> T.StructType:
        raise NotImplementedError

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def pretty(self, indent: int = 0) -> str:
        s = "  " * indent + self.describe()
        for c in self.children:
            s += "\n" + c.pretty(indent + 1)
        return s

    def describe(self) -> str:
        return self.node_name


class LocalTableScan(SparkPlan):
    def __init__(self, host_columns, schema: T.StructType):
        super().__init__([])
        self.host_columns = host_columns  # List[HostColumn]
        self._schema = schema

    @property
    def output(self):
        return self._schema

    def describe(self):
        return f"LocalTableScan {self._schema.simpleString}"


class FileSourceScan(SparkPlan):
    def __init__(self, fmt: str, paths: List[str], schema: T.StructType):
        super().__init__([])
        self.fmt = fmt
        self.paths = list(paths)
        self._schema = schema

    @property
    def output(self):
        return self._schema

    def describe(self):
        return f"FileSourceScan {self.fmt} {len(self.paths)} files"


class Project(SparkPlan):
    def __init__(self, exprs: List[Expression], child: SparkPlan):
        super().__init__([child])
        self.exprs = exprs

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return T.StructType([
            T.StructField(e.name, e.dataType, e.nullable)
            for e in self.exprs])

    def describe(self):
        return ("Project ["
                + ", ".join(e.sql_string() for e in self.exprs) + "]")


class Filter(SparkPlan):
    def __init__(self, condition: Expression, child: SparkPlan):
        super().__init__([child])
        self.condition = condition

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def describe(self):
        return f"Filter {self.condition.sql_string()}"


class AggregateMode(enum.Enum):
    PARTIAL = "Partial"
    FINAL = "Final"
    COMPLETE = "Complete"


#: aggregate functions this slice ports
PORTED_AGG_FUNCS = frozenset({"sum", "count", "count_star"})


@dataclasses.dataclass
class AggregateExpression:
    """One aggregate: func name + input expr (resolved) + result name."""

    func: str
    child: Optional[Expression]  # None for count(*)
    result_name: str
    result_type: Optional[T.DataType] = None

    def resolve(self, schema: T.StructType) -> "AggregateExpression":
        if self.func not in PORTED_AGG_FUNCS:
            raise NotImplementedError(
                f"aggregate {self.func} is not ported yet")
        if self.child is not None:
            self.child = self.child.resolve(schema)
        self.result_type = self._compute_type()
        return self

    def _compute_type(self) -> T.DataType:
        if self.func in ("count", "count_star"):
            return T.LONG
        ct = self.child.dataType
        if isinstance(ct, T.DecimalType):
            return T.DecimalType(min(ct.precision + 10, 38), ct.scale)
        if ct.is_integral:
            return T.LONG
        return T.DOUBLE

    def describe(self):
        inner = self.child.sql_string() if self.child is not None else "*"
        return f"{self.func}({inner}) AS {self.result_name}"


class HashAggregate(SparkPlan):
    def __init__(self, grouping: List[Expression],
                 aggregates: List[AggregateExpression],
                 mode: AggregateMode, child: SparkPlan):
        super().__init__([child])
        self.grouping = grouping
        self.aggregates = aggregates
        self.mode = mode

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        fields = [T.StructField(g.name, g.dataType, g.nullable)
                  for g in self.grouping]
        fields += [T.StructField(a.result_name, a.result_type)
                   for a in self.aggregates]
        return T.StructType(fields)

    def describe(self):
        g = ", ".join(e.sql_string() for e in self.grouping)
        a = ", ".join(a.describe() for a in self.aggregates)
        return f"HashAggregate({self.mode.value}) keys=[{g}] aggs=[{a}]"


class SinglePartitioning:
    num_partitions = 1

    def describe(self):
        return "SinglePartition"


class Exchange(SparkPlan):
    """ShuffleExchangeExec analog."""

    def __init__(self, partitioning, child: SparkPlan):
        super().__init__([child])
        self.partitioning = partitioning

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def describe(self):
        return f"Exchange {self.partitioning.describe()}"

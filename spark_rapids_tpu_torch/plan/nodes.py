"""CPU physical plan nodes — port of the subset of
``spark_rapids_tpu/plan/nodes.py`` that the ported queries plan: scans,
project, filter, union, aggregates, broadcast and shuffled joins over
hash exchanges, the nested-loop join, repartitioning, windows, sorts and
limits.  Aggregate
result types are the reference's ``_compute_type`` for the ported
functions.

The session builds this Catalyst-shaped plan; ``overrides/overrides.py``
rewrites it into device execs.  The node names and ``describe`` strings
are the reference's, so explain output reads the same.
"""
from __future__ import annotations

import dataclasses
import enum
import os
from typing import List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.base import Expression
from spark_rapids_tpu_torch.ops.sortkeys import SortSpec


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

    def with_new_children(self, children: Sequence["SparkPlan"]
                          ) -> "SparkPlan":
        import copy

        n = copy.copy(self)
        n.children = list(children)
        return n


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
        return f"Filter ({self.condition.sql_string()})"


class Union(SparkPlan):
    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"Union ({len(self.children)} children)"


class AggregateMode(enum.Enum):
    PARTIAL = "Partial"
    FINAL = "Final"
    COMPLETE = "Complete"


#: the central-moment aggregates, sharing the (n, mean, m2) buffer
VARIANCE_FUNCS = frozenset(
    {"var_pop", "var_samp", "stddev_pop", "stddev_samp"})

#: the higher central moments (Spark Skewness/Kurtosis), whose buffers
#: add m3 (and m4) to the variance family's
HIGHER_MOMENT_FUNCS = frozenset({"skewness", "kurtosis"})

#: the two-input covariance family (Spark Covariance/Corr)
COVARIANCE_FUNCS = frozenset({"covar_pop", "covar_samp", "corr"})

#: the linear-regression family (Spark RegrCount, RegrSlope, ...) over the
#: covariance buffers: ``regr_f(y, x)`` counts a row only where both
#: inputs are non-null
REGR_FUNCS = frozenset(
    {"regr_count", "regr_avgx", "regr_avgy", "regr_sxx", "regr_syy",
     "regr_sxy", "regr_slope", "regr_intercept", "regr_r2"})

#: the bitwise aggregates (Spark BitAndAgg/BitOrAgg/BitXorAgg)
BIT_AGG_FUNCS = frozenset({"bit_and", "bit_or", "bit_xor"})

#: the buffer columns' suffixes of each moment-family aggregate, every one
#: a DOUBLE (the reference's ``MOMENT_BUFFERS``)
MOMENT_BUFFERS = {
    "var_pop": ("_n", "_avg", "_m2"),
    "var_samp": ("_n", "_avg", "_m2"),
    "stddev_pop": ("_n", "_avg", "_m2"),
    "stddev_samp": ("_n", "_avg", "_m2"),
    "skewness": ("_n", "_avg", "_m2", "_m3"),
    "kurtosis": ("_n", "_avg", "_m2", "_m3", "_m4"),
    "covar_pop": ("_n", "_xavg", "_yavg", "_ck"),
    "covar_samp": ("_n", "_xavg", "_yavg", "_ck"),
    "corr": ("_n", "_xavg", "_yavg", "_ck", "_xm2", "_ym2"),
    **{f: ("_n", "_xavg", "_yavg", "_ck", "_xm2", "_ym2")
       for f in REGR_FUNCS},
}

#: the single-phase aggregates, whose state is the whole group: planned
#: as one COMPLETE aggregate over a hash exchange on the keys (a single
#: partition without keys), as ``collect_list`` is
SINGLE_PHASE_FUNCS = frozenset(
    {"collect_list", "collect_set", "percentile", "approx_percentile",
     "median", "bloom_filter_agg"})

#: the register-count exponent of ``approx_count_distinct`` at Spark's
#: default relativeSD of 0.05 (p = ceil(2 log2(1.106 / rsd))): 512
#: registers
HLL_DEFAULT_P = 9

#: aggregate functions the port runs
PORTED_AGG_FUNCS = frozenset(
    {"sum", "count", "count_star", "min", "max", "avg", "count_if",
     "bool_and", "bool_or", "first", "last", "any_value",
     "approx_count_distinct"}
    | VARIANCE_FUNCS | HIGHER_MOMENT_FUNCS | COVARIANCE_FUNCS | REGR_FUNCS
    | BIT_AGG_FUNCS | SINGLE_PHASE_FUNCS)


@dataclasses.dataclass
class AggregateExpression:
    """One aggregate: func name + input expr (resolved) + result name;
    ``child2`` is the second input of the covariance and regression
    families (``regr_f(y, x)``: ``child`` is y, ``child2`` x), ``args``
    the literal extras: ``percentile``'s percentage,
    ``approx_percentile``'s percentage and accuracy,
    ``bloom_filter_agg``'s ``(num_items, num_bits)``."""

    func: str
    child: Optional[Expression]  # None for count(*)
    result_name: str
    result_type: Optional[T.DataType] = None
    child2: Optional[Expression] = None
    args: tuple = ()

    def resolve(self, schema: T.StructType) -> "AggregateExpression":
        if self.func not in PORTED_AGG_FUNCS:
            from spark_rapids_tpu_torch.exec.base import NotOnGpu

            raise NotOnGpu(f"aggregate {self.func} is not ported yet")
        if self.child is not None:
            self.child = self.child.resolve(schema)
        if self.child2 is not None:
            self.child2 = self.child2.resolve(schema)
        self.result_type = self._compute_type()
        return self

    def _compute_type(self) -> T.DataType:
        if self.func in ("count", "count_star", "count_if",
                         "approx_count_distinct"):
            return T.LONG
        if self.func == "bloom_filter_agg":
            return T.ArrayType(T.LONG, containsNull=False)
        ct = self.child.dataType
        if self.func == "sum":
            if isinstance(ct, T.DecimalType):
                return T.DecimalType(min(ct.precision + 10, 38), ct.scale)
            if ct.is_integral:
                return T.LONG
            return T.DOUBLE
        if self.func == "avg":
            if isinstance(ct, T.DecimalType):
                return T.DecimalType(min(ct.precision + 4, 38),
                                     min(ct.scale + 4, 38))
            return T.DOUBLE
        if self.func in VARIANCE_FUNCS or self.func in HIGHER_MOMENT_FUNCS \
                or self.func in COVARIANCE_FUNCS:
            return T.DOUBLE
        if self.func == "regr_count":
            return T.LONG
        if self.func in REGR_FUNCS:
            return T.DOUBLE
        if self.func in ("percentile", "median"):
            return T.DOUBLE
        if self.func in ("collect_list", "collect_set"):
            return T.ArrayType(ct)
        # min/max, bool_and/bool_or, bit_*, first/last/any_value,
        # approx_percentile
        return ct

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
    def result_schema(self) -> T.StructType:
        """The keys, then each aggregate's result."""
        fields = [T.StructField(g.name, g.dataType, g.nullable)
                  for g in self.grouping]
        fields += [T.StructField(a.result_name, a.result_type)
                   for a in self.aggregates]
        return T.StructType(fields)

    @property
    def output(self):
        """The result schema; a PARTIAL aggregate's buffers instead (the
        reference's ``partial_buffer_schema`` with the port's flags,
        ``exec/aggregate.py::buffer_fields``), which only a CPU stage's
        Partial emits: on the card the pair collapses into one COMPLETE
        aggregate.  ``approx_count_distinct`` keeps its result's field
        there, so that its exchange stays on the card (ROADMAP,
        "Differences that bind the port")."""
        out = self.result_schema
        if self.mode != AggregateMode.PARTIAL:
            return out
        # exec/aggregate.py imports this module: imported at call time
        from spark_rapids_tpu_torch.exec.aggregate import buffer_fields

        k = len(self.grouping)
        fields = list(out.fields[:k])
        for a, f in zip(self.aggregates, out.fields[k:]):
            fields += ([f] if a.func == "approx_count_distinct"
                       else buffer_fields(a, f))
        return T.StructType(fields)

    def describe(self):
        g = ", ".join(e.sql_string() for e in self.grouping)
        a = ", ".join(a.describe() for a in self.aggregates)
        return f"HashAggregate({self.mode.value}) keys=[{g}] aggs=[{a}]"


class JoinType(enum.Enum):
    INNER = "Inner"
    LEFT_OUTER = "LeftOuter"
    RIGHT_OUTER = "RightOuter"
    FULL_OUTER = "FullOuter"
    LEFT_SEMI = "LeftSemi"
    LEFT_ANTI = "LeftAnti"
    CROSS = "Cross"


class _BaseJoin(SparkPlan):
    def __init__(self, left: SparkPlan, right: SparkPlan,
                 left_keys: List[Expression], right_keys: List[Expression],
                 join_type: JoinType,
                 condition: Optional[Expression] = None):
        super().__init__([left, right])
        self.left_keys = left_keys
        self.right_keys = right_keys
        self.join_type = join_type
        self.condition = condition

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def output(self):
        lf = list(self.left.output.fields)
        rf = list(self.right.output.fields)
        if self.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            return T.StructType(lf)
        if self.join_type in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER):
            rf = [T.StructField(f.name, f.dataType, True) for f in rf]
        if self.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            lf = [T.StructField(f.name, f.dataType, True) for f in lf]
        return T.StructType(lf + rf)

    def describe(self):
        keys = ", ".join(
            f"{l.sql_string()}={r.sql_string()}"
            for l, r in zip(self.left_keys, self.right_keys))
        return f"{self.node_name} {self.join_type.value} [{keys}]"


class SortMergeJoin(_BaseJoin):
    """The shuffled join the session plans, over an exchange on each side,
    when the right side is too big to broadcast."""


class ShuffledHashJoin(_BaseJoin):
    """Converted as the sort-merge join is, as in the reference; the
    session never plans one, a plan built by hand may hold one."""


class BroadcastHashJoin(_BaseJoin):
    pass


class BroadcastNestedLoopJoin(_BaseJoin):
    """Join without equi-keys: every pair is checked against the condition
    (which resolves against the left side's columns, then the right
    side's).  Reference analog: GpuBroadcastNestedLoopJoinExec."""

    def __init__(self, left, right, join_type: JoinType,
                 condition: Optional[Expression]):
        super().__init__(left, right, [], [], join_type, condition)

    def describe(self):
        c = self.condition.sql_string() if self.condition is not None else ""
        return f"BroadcastNestedLoopJoin {self.join_type.value} [{c}]"


class BroadcastExchange(SparkPlan):
    def __init__(self, child: SparkPlan):
        super().__init__([child])

    @property
    def output(self):
        return self.children[0].output


@dataclasses.dataclass
class WindowFunction:
    """One window function over (partition, order, frame).  ``buckets`` is
    ntile's; ``offset`` and ``default`` (a literal) are lead/lag's,
    ``ignore_nulls`` first_value/last_value's.  Result types as the
    reference's: lead, lag, first_value, last_value, min and max the
    input's; avg and the variance family DOUBLE."""

    func: str                      # row_number, rank, dense_rank, sum, ...
    child: Optional[Expression]
    result_name: str
    result_type: Optional[T.DataType] = None
    offset: int = 1                # lead/lag
    default: Optional[object] = None   # lead/lag literal default
    buckets: int = 2               # ntile
    ignore_nulls: bool = False     # first_value/last_value

    def resolve(self, schema):
        if self.child is not None:
            self.child = self.child.resolve(schema)
        if self.func in ("row_number", "rank", "dense_rank", "ntile"):
            self.result_type = T.INT
        elif self.func in ("percent_rank", "cume_dist"):
            self.result_type = T.DOUBLE
        elif self.func == "count":
            self.result_type = T.LONG
        elif self.func == "sum":
            ct = self.child.dataType
            if isinstance(ct, T.DecimalType):
                self.result_type = T.DecimalType(min(ct.precision + 10, 38),
                                                 ct.scale)
            elif ct.is_integral:
                self.result_type = T.LONG
            else:
                self.result_type = T.DOUBLE
        elif self.func in ("avg", "var_pop", "var_samp",
                           "stddev_pop", "stddev_samp"):
            self.result_type = T.DOUBLE
        else:
            self.result_type = self.child.dataType
        return self


def normalize_frame(frame):
    """Canonical window-frame forms, as the reference names them:

      "running"        ROWS  UNBOUNDED PRECEDING .. CURRENT ROW
      "range_running"  RANGE UNBOUNDED PRECEDING .. CURRENT ROW
      "unbounded"      the whole partition
      ("rows", a, b)   ROWS  BETWEEN a PRECEDING AND b FOLLOWING
      ("range", a, b)  RANGE BETWEEN a PRECEDING AND b FOLLOWING

    A bare (a, b) tuple is shorthand for ("rows", a, b).  A RANGE frame
    with bounds takes one integral, floating or DATE order key."""
    if isinstance(frame, tuple):
        if len(frame) == 2:
            return ("rows", frame[0], frame[1])
        if len(frame) == 3 and frame[0] in ("rows", "range"):
            return frame
        raise ValueError(f"bad window frame {frame!r}")
    if frame not in ("running", "range_running", "unbounded"):
        raise ValueError(f"bad window frame {frame!r}")
    return frame


class Window(SparkPlan):
    def __init__(self, functions: List[WindowFunction],
                 partition_by: List[Expression],
                 order_by: List[Tuple[Expression, SortSpec]],
                 child: SparkPlan,
                 frame="running"):
        super().__init__([child])
        self.functions = functions
        self.partition_by = partition_by
        self.order_by = order_by
        self.frame = normalize_frame(frame)

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        fields = list(self.child.output.fields)
        fields += [T.StructField(f.result_name, f.result_type)
                   for f in self.functions]
        return T.StructType(fields)

    def describe(self):
        fns = ", ".join(f.func for f in self.functions)
        return f"Window [{fns}] frame={self.frame}"


class Sort(SparkPlan):
    def __init__(self, orders: List[Tuple[Expression, SortSpec]],
                 is_global: bool, child: SparkPlan):
        super().__init__([child])
        self.orders = orders
        self.is_global = is_global

    @property
    def child(self):
        return self.children[0]

    @property
    def output(self):
        return self.child.output

    def describe(self):
        o = ", ".join(
            f"{e.sql_string()} {'ASC' if s.ascending else 'DESC'}"
            for e, s in self.orders)
        return f"Sort [{o}] global={self.is_global}"


class LocalLimit(SparkPlan):
    def __init__(self, n: int, child: SparkPlan):
        super().__init__([child])
        self.n = n

    @property
    def output(self):
        return self.children[0].output

    def describe(self):
        return f"LocalLimit {self.n}"


class GlobalLimit(LocalLimit):
    def describe(self):
        return f"GlobalLimit {self.n}"


class SinglePartitioning:
    num_partitions = 1

    def describe(self):
        return "SinglePartition"


@dataclasses.dataclass
class HashPartitioning:
    keys: List[Expression]
    num_partitions: int

    def describe(self):
        k = ", ".join(e.sql_string() for e in self.keys)
        return f"hashpartitioning({k}, {self.num_partitions})"


@dataclasses.dataclass
class RangePartitioning:
    orders: List[Tuple[Expression, SortSpec]]
    num_partitions: int

    def describe(self):
        return f"rangepartitioning({self.num_partitions})"


@dataclasses.dataclass
class RoundRobinPartitioning:
    num_partitions: int

    def describe(self):
        return f"roundrobin({self.num_partitions})"


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


def estimated_plan_bytes(plan: SparkPlan) -> Optional[int]:
    """Size estimate for the broadcast decisions; None = unknown.  A local
    table counts its host bytes; a file scan counts its files' sizes on
    disk, which is the compressed, encoded size of every column, not the
    decoded batch (Spark's own estimate for files); a narrow node takes its
    child's estimate (filters and limits only shrink)."""
    if isinstance(plan, LocalTableScan):
        # a string counts its bytes and 4-byte lengths, as the reference's
        return sum((int(h.lengths.sum()) + 4 * h.num_rows if h.is_string
                    else h.data.nbytes) + h.num_rows
                   for h in plan.host_columns)
    if isinstance(plan, FileSourceScan):
        try:
            return sum(os.path.getsize(p) for p in plan.paths)
        except OSError:
            return None
    if isinstance(plan, (Project, Filter, LocalLimit, BroadcastExchange)):
        return estimated_plan_bytes(plan.children[0])
    return None

"""TpuSession / DataFrame — the port's user entry point (port of the part
of ``spark_rapids_tpu/session.py`` that Q6 and bench qa, qb and qc use).

The API is call-compatible with the reference: ``TpuSession(conf)``,
``create_dataframe``, ``read.schema(...).parquet(...)``, ``filter``,
``select``, ``agg``, ``group_by(...).agg``, ``join`` (on column names
or on a condition), ``cross_join``, ``union``,
``window``, ``order_by``, ``limit``, ``explain``, ``collect`` and
``count``, with ``col``,
``lit``, ``sum_``, ``count_``, ``count_distinct_``, ``sum_distinct_``,
``min_``, ``max_``, ``avg_``, ``stddev_``,
``stddev_pop_``, ``variance_``, ``var_pop_``, ``count_if_``,
``bool_and_``, ``bool_or_``, ``bit_and_``, ``bit_or_``, ``bit_xor_``,
``any_value_``, ``skewness_``, ``kurtosis_``, ``corr_``, ``covar_pop_``,
``covar_samp_``, the nine ``regr_*_``, ``collect_list_``,
``collect_set_``, ``median_``, ``percentile_``, ``approx_percentile_``,
``approx_count_distinct_``, ``bloom_filter_agg_``, ``hash_``,
``xxhash64_`` and ``SortSpec``, and ``repartition``.  ``window`` takes every frame form of
``plan/nodes.py::normalize_frame``.  A session runs on ``cuda`` unless it
is given another device (``TpuSession(conf, device="cpu")``); without a
GPU and without a device argument it raises.  Aggregates are planned two-phase around a hash
exchange on the keys, or as one aggregate after it when a single-phase
function (collect, percentile, bloom filter) is among them; a join broadcasts its right side under
``spark.sql.autoBroadcastJoinThreshold`` and is otherwise planned as a
shuffled join over a hash exchange of ``spark.sql.shuffle.partitions`` on
each side, exactly as in the reference.  The plan rewrite
(``overrides/overrides.py``) collapses the aggregates for one device, sizes
the exchanges whose input is known to be large, collapses the others to
one partition, and makes the shuffled join adaptive.  The plan is made
with the pool of a device manager built from the session's conf, and each
``collect`` builds the spill framework and device manager anew from it
(``memory/``); every collect runs under the query lifecycle
(``lifecycle/``), journaled when ``spark.rapids.tpu.recovery.enabled``
is on (``lifecycle/journal.py``); ``close`` drops the hot-table cache and
releases what the process still holds.  As in the reference, a DataFrame
keeps its rewritten plan per conf, so a second ``collect`` runs the same
exec tree and ``explain`` after a collect shows the adaptive join's
decision.  A plan node that the reference's rules keep off the device
runs as a CPU stage (``cpu/oracle.py``); ``explain`` then ends with the
reference's ``Fallback reasons``, and a plan whose root is such a stage is
collected on the host.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.config import (AUTO_BROADCAST_JOIN_THRESHOLD,
                                           SHUFFLE_PARTITIONS, TpuConf)
from spark_rapids_tpu_torch.device import DeviceLike, resolve_device
from spark_rapids_tpu_torch.expr.base import AttributeReference, Expression
from spark_rapids_tpu_torch.expr.base import col as _col
from spark_rapids_tpu_torch.expr.base import lit as _lit
from spark_rapids_tpu_torch.ops.sortkeys import SortSpec
from spark_rapids_tpu_torch.plan import nodes as PN

ColumnLike = Union[str, Expression]


def _to_expr(c: ColumnLike) -> Expression:
    if isinstance(c, Expression):
        return c
    return _col(c)


class TpuSession:
    def __init__(self, conf: Optional[Dict[str, str]] = None,
                 device: DeviceLike = None):
        self.conf = TpuConf(conf or {})
        self.device = resolve_device(device)

    def create_dataframe(self, data, schema: T.StructType) -> "DataFrame":
        if isinstance(data, dict):
            cols = [HostColumn.from_pylist(data[f.name], f.dataType)
                    for f in schema.fields]
        else:  # rows
            cols = [HostColumn.from_pylist([r[i] for r in data], f.dataType)
                    for i, f in enumerate(schema.fields)]
        return DataFrame(PN.LocalTableScan(cols, schema), self)

    @property
    def read(self) -> "DataFrameReader":
        return DataFrameReader(self)

    @property
    def shuffle_partitions(self) -> int:
        return self.conf.get(SHUFFLE_PARTITIONS)

    def close(self, check_leaks: bool = True,
              drop_hot_cache: bool = True) -> List[str]:
        """Session shutdown: report, then release, what the process's
        singletons still hold (unclosed spillables, live shuffle
        registrations, remote placements, the recovery journal).  Returns
        the leak report, empty for a well-behaved session.  The hot-table
        cache is a process singleton too: it is dropped first, unless
        ``drop_hot_cache`` is false (one of several live sessions
        closing keeps the others' warm tables)."""
        from spark_rapids_tpu_torch.io.hot_cache import clear_hot_cache
        from spark_rapids_tpu_torch.lifecycle import (leak_report_all,
                                                      reset_leaked_state)

        if drop_hot_cache:
            clear_hot_cache()
        leaks = leak_report_all() if check_leaks else []
        reset_leaked_state()
        return leaks


class DataFrameReader:
    def __init__(self, session: TpuSession):
        self.session = session
        self._schema: Optional[T.StructType] = None

    def schema(self, s: T.StructType) -> "DataFrameReader":
        self._schema = s
        return self

    def parquet(self, *paths: str) -> "DataFrame":
        if self._schema is None:
            raise NotImplementedError(
                "schema inference is not ported yet: call .schema(...) "
                "before .parquet(...)")
        return DataFrame(
            PN.FileSourceScan("parquet", list(paths), self._schema),
            self.session)


_JOIN_TYPES = {"inner": PN.JoinType.INNER,
               "left": PN.JoinType.LEFT_OUTER,
               "left_outer": PN.JoinType.LEFT_OUTER,
               "right": PN.JoinType.RIGHT_OUTER,
               "right_outer": PN.JoinType.RIGHT_OUTER,
               "outer": PN.JoinType.FULL_OUTER,
               "full": PN.JoinType.FULL_OUTER,
               "full_outer": PN.JoinType.FULL_OUTER,
               "left_semi": PN.JoinType.LEFT_SEMI,
               "semi": PN.JoinType.LEFT_SEMI,
               "left_anti": PN.JoinType.LEFT_ANTI,
               "anti": PN.JoinType.LEFT_ANTI,
               "cross": PN.JoinType.CROSS}


class DataFrame:
    def __init__(self, plan: PN.SparkPlan, session: TpuSession):
        self.plan = plan
        self.session = session

    @property
    def schema(self) -> T.StructType:
        return self.plan.output

    def select(self, *cols: ColumnLike) -> "DataFrame":
        exprs = [_to_expr(c).resolve(self.schema) for c in cols]
        return DataFrame(PN.Project(exprs, self.plan), self.session)

    def filter(self, cond: Expression) -> "DataFrame":
        return DataFrame(PN.Filter(cond.resolve(self.schema), self.plan),
                         self.session)

    def group_by(self, *cols: ColumnLike) -> "GroupedData":
        return GroupedData(self, [_to_expr(c).resolve(self.schema)
                                  for c in cols])

    groupBy = group_by

    def agg(self, *aggs) -> "DataFrame":
        """Global aggregate: ``aggs`` are ``(func, column, name)`` tuples
        (``sum_``, ``count_``, ``avg_``, ...; ``("first", column,
        name)`` and ``("last", ...)`` too) or ``AggregateExpression``s."""
        return GroupedData(self, []).agg(*aggs)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position."""
        return DataFrame(PN.Union([self.plan, other.plan]), self.session)

    def repartition(self, num_partitions: int,
                    *cols: ColumnLike) -> "DataFrame":
        """Dataset.repartition: a hash exchange on ``cols`` (round-robin
        when none are given)."""
        if cols:
            part = PN.HashPartitioning(
                [_to_expr(c).resolve(self.schema) for c in cols],
                num_partitions)
        else:
            part = PN.RoundRobinPartitioning(num_partitions)
        return DataFrame(PN.Exchange(part, self.plan), self.session)

    def cross_join(self, other: "DataFrame") -> "DataFrame":
        """Every pair of rows (a CROSS join)."""
        return self.join(other, None, "cross")

    def join(self, other: "DataFrame", on, how: str = "inner"
             ) -> "DataFrame":
        """Equi-join on the column names ``on``; ``how`` is inner, left
        (left_outer), right (right_outer), full (outer, full_outer),
        left_semi (semi), left_anti (anti) or cross.  A semi or anti join
        outputs the left side's columns only.  The right side is
        broadcast when its estimated size is within
        ``spark.sql.autoBroadcastJoinThreshold``; else the join is planned
        as a shuffled join over a hash exchange of
        ``spark.sql.shuffle.partitions`` on each side.  A cross join is
        planned without exchanges.  ``on`` may instead be a condition (an
        ``Expression`` over the left side's columns, then the right
        side's): a nested-loop join against the broadcast right side."""
        jt = _JOIN_TYPES[how.lower()]
        if isinstance(on, Expression):
            combined = T.StructType(list(self.schema.fields)
                                    + list(other.schema.fields))
            node = PN.BroadcastNestedLoopJoin(
                self.plan, PN.BroadcastExchange(other.plan), jt,
                on.resolve(combined))
            return DataFrame(node, self.session)
        if isinstance(on, str):
            on = [on]
        lkeys = [_col(k).resolve(self.schema) for k in on] if on else []
        rkeys = [_col(k).resolve(other.schema) for k in on] if on else []
        if jt == PN.JoinType.CROSS:
            return DataFrame(PN.SortMergeJoin(self.plan, other.plan, [], [],
                                              jt), self.session)
        if _is_broadcastable(other.plan, self.session.conf):
            node = PN.BroadcastHashJoin(
                self.plan, PN.BroadcastExchange(other.plan), lkeys, rkeys, jt)
            return DataFrame(node, self.session)
        np_ = self.session.shuffle_partitions
        lex = PN.Exchange(PN.HashPartitioning(lkeys, np_), self.plan)
        rex = PN.Exchange(PN.HashPartitioning(rkeys, np_), other.plan)
        return DataFrame(PN.SortMergeJoin(lex, rex, lkeys, rkeys, jt),
                         self.session)

    def window(self, functions: List[PN.WindowFunction],
               partition_by: Sequence[ColumnLike],
               order_by: Sequence, frame="running") -> "DataFrame":
        """Window functions over ``partition_by`` ordered by ``order_by``
        (columns, or ``(expression, SortSpec)`` pairs; a plain column
        sorts ASC NULLS FIRST) in ``frame``; the functions' results are
        appended to the columns."""
        pb = [_to_expr(c).resolve(self.schema) for c in partition_by]
        ob = []
        for c in order_by:
            if isinstance(c, tuple):
                e, spec = c
            else:
                e, spec = _to_expr(c), SortSpec()
            ob.append((_to_expr(e).resolve(self.schema), spec))
        fns = [f.resolve(self.schema) for f in functions]
        return DataFrame(PN.Window(fns, pb, ob, self.plan, frame),
                         self.session)

    def order_by(self, *cols, ascending=None) -> "DataFrame":
        """Global sort.  Each term is a column, or an ``(expression,
        SortSpec)`` pair; a plain column sorts ASC NULLS FIRST, or as
        ``ascending`` says (DESC then puts nulls last)."""
        orders = []
        for i, c in enumerate(cols):
            if isinstance(c, tuple):
                e, spec = c
            else:
                asc = (ascending[i] if isinstance(ascending, (list, tuple))
                       else (ascending if ascending is not None else True))
                e = _to_expr(c)
                spec = SortSpec(ascending=asc, nulls_first=asc)
            orders.append((_to_expr(e).resolve(self.schema), spec))
        return DataFrame(PN.Sort(orders, True, self.plan), self.session)

    orderBy = order_by
    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(PN.GlobalLimit(n, self.plan), self.session)

    def _planned(self):
        """The rewritten exec tree, kept per conf as the reference keeps
        it, so repeated collects run the same tree.  Partition sizing reads
        the pool of a device manager built from the session's conf."""
        return self._planned_with_meta()[0]

    def _planned_with_meta(self):
        from spark_rapids_tpu_torch.memory.device_manager import (
            get_device_manager)
        from spark_rapids_tpu_torch.overrides.overrides import TpuOverrides

        conf = self.session.conf
        key = tuple(sorted((k, str(v)) for k, v in conf.settings.items()))
        cached = getattr(self, "_plan_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        get_device_manager(conf, self.session.device)
        planned = TpuOverrides.apply(self.plan, conf, self.session.device)
        self._plan_cache = (key, planned)
        return planned

    def collect_host(self) -> List[HostColumn]:
        """The result as host columns (one per output column).  The query
        runs under the query lifecycle, as the reference's collect does:
        admission before planning, a query id and trace id, an optional
        deadline, and cleanup of what the query still holds however it
        ends.  The spill framework (and its device manager) is built anew
        from the session's conf first, so its counters are this
        collect's."""
        from spark_rapids_tpu_torch.cpu.oracle import execute_cpu_plan
        from spark_rapids_tpu_torch.exec.base import TpuExec
        from spark_rapids_tpu_torch.exec.transitions import (
            TpuColumnarToRowExec)
        from spark_rapids_tpu_torch.lifecycle import query_lifecycle
        from spark_rapids_tpu_torch.memory.spill import get_spill_framework

        conf = self.session.conf
        with query_lifecycle(conf) as qctx:
            root = self._planned()
            if qctx is not None:
                # journal the planned tree's identity (recovery off: one
                # conf read and no journal call)
                from spark_rapids_tpu_torch.config import RECOVERY_ENABLED

                if bool(conf.get(RECOVERY_ENABLED)):
                    from spark_rapids_tpu_torch.lifecycle import (
                        journal as _jn)

                    try:
                        _jn.journal_plan(qctx, root, conf)
                    except Exception:
                        # the plan record is advisory: losing it never
                        # fails the query
                        pass
            get_spill_framework(conf, self.session.device)
            if isinstance(root, TpuExec):
                return TpuColumnarToRowExec(root).collect_host()
            cols, _ = execute_cpu_plan(root, conf.ansi_enabled)
            return [c.to_host() for c in cols]

    def collect(self) -> List[tuple]:
        return list(zip(*[c.to_pylist() for c in self.collect_host()]))

    def count(self) -> int:
        """``count(*)`` over the plan as it stands (a sort under it
        stays, as in the reference)."""
        rows = self.agg(("count_star", None, "count")).collect()
        return int(rows[0][0]) if rows else 0

    def explain(self) -> str:
        """The rewritten plan, one operator per line, then the reference's
        ``Fallback reasons`` for the nodes kept off the device."""
        root, meta = self._planned_with_meta()
        s = root.pretty()
        fb = meta.explain(only_fallback=True)
        if fb:
            s += "\nFallback reasons:\n" + fb
        return s


class GroupedData:
    def __init__(self, df: DataFrame, keys: List[Expression]):
        self.df = df
        self.keys = keys

    def agg(self, *aggs) -> DataFrame:
        """``aggs``: ``(func, column-or-None, result_name)`` tuples or
        ``AggregateExpression``s.  Planned as the reference plans it:
        Partial, an exchange (hash on the keys over
        ``spark.sql.shuffle.partitions``, or a single partition without
        keys), Final; with a single-phase function among them
        (``PN.SINGLE_PHASE_FUNCS``) the exchange, then one Complete
        aggregate.  ``count_distinct_`` and ``sum_distinct_`` take
        Spark's single-distinct-column rewrite, as the reference's: an
        aggregate without functions on (keys, the column) drops the
        duplicates, then the plain aggregate runs over its rows."""
        specs = list(aggs)
        distinct = [a for a in specs if isinstance(a, tuple)
                    and a[0] in ("count_distinct", "sum_distinct")]
        if distinct:
            if len(distinct) != len(specs):
                raise NotImplementedError(
                    "mixing distinct and non-distinct aggregates is not "
                    "supported yet")
            if len({str(a[1]) for a in distinct}) != 1:
                raise NotImplementedError(
                    "distinct aggregates over multiple columns are not "
                    "supported yet")
            dcol = _to_expr(distinct[0][1]).resolve(self.df.schema)
            dedup = GroupedData(self.df, self.keys + [dcol]).agg()
            outer = [(a[0].replace("_distinct", ""), dcol.name, a[2])
                     for a in distinct]
            return dedup.group_by(*[k.name for k in self.keys]).agg(*outer)
        schema = self.df.schema
        aexprs: List[PN.AggregateExpression] = []
        for a in aggs:
            if isinstance(a, PN.AggregateExpression):
                aexprs.append(a.resolve(schema))
                continue
            func, child, name = a
            ce = _to_expr(child) if child is not None else None
            aexprs.append(PN.AggregateExpression(func, ce, name)
                          .resolve(schema))
        if any(a.func in PN.SINGLE_PHASE_FUNCS for a in aexprs):
            # single phase: an exchange co-locates each key's rows, then
            # ONE COMPLETE aggregate runs every function over them
            part = (PN.HashPartitioning(self.keys,
                                        self.df.session.shuffle_partitions)
                    if self.keys else PN.SinglePartitioning())
            return DataFrame(PN.HashAggregate(
                self.keys, aexprs, PN.AggregateMode.COMPLETE,
                PN.Exchange(part, self.df.plan)), self.df.session)
        partial = PN.HashAggregate(self.keys, aexprs,
                                   PN.AggregateMode.PARTIAL, self.df.plan)
        if self.keys:
            # re-key the exchange and the final aggregate on the partial
            # output
            pschema = partial.output
            fkeys = [AttributeReference(g.name).resolve(pschema)
                     for g in self.keys]
            ex = PN.Exchange(PN.HashPartitioning(
                fkeys, self.df.session.shuffle_partitions), partial)
        else:
            fkeys = []
            ex = PN.Exchange(PN.SinglePartitioning(), partial)
        final_aggs = [PN.AggregateExpression(a.func, a.child, a.result_name,
                                             a.result_type, child2=a.child2,
                                             args=a.args)
                      for a in aexprs]
        final = PN.HashAggregate(fkeys, final_aggs, PN.AggregateMode.FINAL,
                                 ex)
        return DataFrame(final, self.df.session)


def _is_broadcastable(plan: PN.SparkPlan, conf: TpuConf) -> bool:
    """``spark.sql.autoBroadcastJoinThreshold`` against the estimate."""
    threshold = conf.get(AUTO_BROADCAST_JOIN_THRESHOLD)
    if threshold < 0:
        return False
    est = PN.estimated_plan_bytes(plan)
    return est is not None and est <= threshold


def sum_(c: ColumnLike, name: str = "sum") -> Tuple[str, ColumnLike, str]:
    return ("sum", c, name)


def count_(c: Optional[ColumnLike] = None, name: str = "count"):
    return ("count", c, name) if c is not None else ("count_star", None, name)


def count_distinct_(c: ColumnLike, name: str = "count_distinct"):
    return ("count_distinct", c, name)


def sum_distinct_(c: ColumnLike, name: str = "sum_distinct"):
    return ("sum_distinct", c, name)


def min_(c: ColumnLike, name: str = "min"):
    return ("min", c, name)


def max_(c: ColumnLike, name: str = "max"):
    return ("max", c, name)


def avg_(c: ColumnLike, name: str = "avg"):
    return ("avg", c, name)


def rlike_(c: ColumnLike, pattern: str):
    from spark_rapids_tpu_torch.expr.strings import RLike

    return RLike(_to_expr(c), _lit(pattern))


def hash_(*cols: ColumnLike):
    """Spark's ``hash(cols)``: murmur3, seed 42, an int."""
    from spark_rapids_tpu_torch.expr.hashexprs import Murmur3Hash

    return Murmur3Hash([_to_expr(c) for c in cols])


def xxhash64_(*cols: ColumnLike):
    """Spark's ``xxhash64(cols)``: seed 42, a long."""
    from spark_rapids_tpu_torch.expr.hashexprs import XxHash64

    return XxHash64([_to_expr(c) for c in cols])


def collect_list_(c: ColumnLike, name: str = "collect_list"):
    return ("collect_list", c, name)


def collect_set_(c: ColumnLike, name: str = "collect_set"):
    return ("collect_set", c, name)


def median_(c: ColumnLike, name: str = "median"):
    return PN.AggregateExpression("median", _to_expr(c), name)


def percentile_(c: ColumnLike, percentage: float, name: str = "percentile"):
    return PN.AggregateExpression("percentile", _to_expr(c), name,
                                  args=(float(percentage),))


def approx_percentile_(c: ColumnLike, percentage: float,
                       accuracy: int = 10000,
                       name: str = "approx_percentile"):
    return PN.AggregateExpression("approx_percentile", _to_expr(c), name,
                                  args=(float(percentage), int(accuracy)))


def approx_count_distinct_(c: ColumnLike,
                           name: str = "approx_count_distinct"):
    return ("approx_count_distinct", c, name)


def bloom_filter_agg_(c: ColumnLike, name: str = "bloom_filter_agg",
                      num_items: int = 4096, num_bits: int = 65536):
    return PN.AggregateExpression("bloom_filter_agg", _to_expr(c), name,
                                  args=(int(num_items), int(num_bits)))


def stddev_(c: ColumnLike, name: str = "stddev"):
    return ("stddev_samp", c, name)


def stddev_pop_(c: ColumnLike, name: str = "stddev_pop"):
    return ("stddev_pop", c, name)


def variance_(c: ColumnLike, name: str = "variance"):
    return ("var_samp", c, name)


def var_pop_(c: ColumnLike, name: str = "var_pop"):
    return ("var_pop", c, name)


def count_if_(c: ColumnLike, name: str = "count_if"):
    return ("count_if", c, name)


def bool_and_(c: ColumnLike, name: str = "bool_and"):
    return PN.AggregateExpression("bool_and", _to_expr(c), name)


def bool_or_(c: ColumnLike, name: str = "bool_or"):
    return PN.AggregateExpression("bool_or", _to_expr(c), name)


def bit_and_(c: ColumnLike, name: str = "bit_and"):
    return PN.AggregateExpression("bit_and", _to_expr(c), name)


def bit_or_(c: ColumnLike, name: str = "bit_or"):
    return PN.AggregateExpression("bit_or", _to_expr(c), name)


def bit_xor_(c: ColumnLike, name: str = "bit_xor"):
    return PN.AggregateExpression("bit_xor", _to_expr(c), name)


def any_value_(c: ColumnLike, name: str = "any_value"):
    return PN.AggregateExpression("any_value", _to_expr(c), name)


def skewness_(c: ColumnLike, name: str = "skewness"):
    return ("skewness", c, name)


def kurtosis_(c: ColumnLike, name: str = "kurtosis"):
    return ("kurtosis", c, name)


def _regr(func):
    def helper(y: ColumnLike, x: ColumnLike, name: str = None):
        return PN.AggregateExpression(func, _to_expr(y), name or func,
                                      child2=_to_expr(x))
    helper.__name__ = func + "_"
    return helper


regr_count_ = _regr("regr_count")
regr_avgx_ = _regr("regr_avgx")
regr_avgy_ = _regr("regr_avgy")
regr_sxx_ = _regr("regr_sxx")
regr_syy_ = _regr("regr_syy")
regr_sxy_ = _regr("regr_sxy")
regr_slope_ = _regr("regr_slope")
regr_intercept_ = _regr("regr_intercept")
regr_r2_ = _regr("regr_r2")


def corr_(x: ColumnLike, y: ColumnLike, name: str = "corr"):
    return PN.AggregateExpression("corr", _to_expr(x), name,
                                  child2=_to_expr(y))


def covar_pop_(x: ColumnLike, y: ColumnLike, name: str = "covar_pop"):
    return PN.AggregateExpression("covar_pop", _to_expr(x), name,
                                  child2=_to_expr(y))


def covar_samp_(x: ColumnLike, y: ColumnLike, name: str = "covar_samp"):
    return PN.AggregateExpression("covar_samp", _to_expr(x), name,
                                  child2=_to_expr(y))


# pyspark.sql.functions flavoured re-exports
col = _col
lit = _lit

"""Plan rewrite onto the device — the port's
``spark_rapids_tpu/overrides/overrides.py`` for the nodes of TPC-H Q6,
bench qa, qb, qc and rung3, and the exchanges of the out-of-core path.

``TpuOverrides.apply`` wraps the plan in metas and tags them by the
reference's own rules (``overrides/meta.py``), then converts it bottom up
as the reference's ``_convert`` does: a node with no reason becomes its
exec, a CPU child under it becomes a ``TpuRowToColumnarExec``; a node
with a reason stays a CPU plan node for the port's CPU engine
(``cpu/oracle.py``), a device child under it becomes a
``TpuMaterializedScan``.  The conversion keeps two reasons apart: a
reason of the reference's makes a CPU stage, and what the reference runs
on the device but the port has not ported yet (``check_expression``,
``_check_join``, ``_window_check``, a CPU stage the CPU engine cannot
run) raises ``NotOnGpu``, so a missing port never turns into a CPU stage.
A cross join (a ``SortMergeJoin`` without keys) becomes the cartesian
product exec, a ``BroadcastNestedLoopJoin`` the nested-loop exec.
A two-phase aggregate (Final <- Exchange(hash or single partition) <-
Partial) collapses into one COMPLETE aggregate as the reference's
single-device ``_collapse_complete_agg`` does; a single-phase Complete
aggregate stays over its exchange.  A two-phase ``approx_count_distinct``
collapses too: the reference's Partial emits an array<int> register
buffer that its Exchange's type signature refuses, so its exchange is a
CPU stage, while the port's Partial never materializes (ROADMAP,
"Differences that bind the port").  A shuffled join over
two exchanges becomes the adaptive join when adaptive execution is on.
On a device root the steps of the reference's
``TpuTransitionOverrides.apply`` that the port has follow, in its order:
``size_exchange_partitions`` (grow an exchange whose static input
estimate is over the per-partition budget), ``_coalesce_single_device_
shuffle`` (collapse the other hash and round-robin exchanges to one
partition), ``_insert_coalesce`` (an adaptive shuffle reader over each
exchange, or a ``TpuCoalesceBatchesExec`` with adaptive execution off),
``_rewrite_topn`` (a limit over a sort becomes a top-N) and
``fuse_stages``.  The reference's join-aggregate and window-chain fusions
are not ported: their operators run one after the other.
"""
from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import (ADAPTIVE_ENABLED,
                                           AUTO_BROADCAST_JOIN_THRESHOLD,
                                           BATCH_SIZE_BYTES,
                                           DISTRIBUTED_ENABLED,
                                           EXCHANGE_COALESCE_SMALL_BYTES,
                                           MAX_READER_BATCH_SIZE_ROWS,
                                           SINGLE_DEVICE_SHUFFLE_COALESCE,
                                           TpuConf)
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.exec.basic import (TpuFilterExec,
                                               TpuLocalTableScanExec,
                                               TpuProjectExec, TpuUnionExec,
                                               fuse_stages)
from spark_rapids_tpu_torch.exec.coalesce import (CoalesceGoal,
                                                  TpuCoalesceBatchesExec)
from spark_rapids_tpu_torch.exec.exchange import (
    TpuAdaptiveShuffleReaderExec, TpuBroadcastExchangeExec,
    TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.exec.generate import (
    TpuBroadcastNestedLoopJoinExec)
from spark_rapids_tpu_torch.exec.join import (
    TpuAdaptiveJoinExec, TpuBroadcastHashJoinExec, TpuCartesianProductExec,
    TpuShuffledSymmetricHashJoinExec)
from spark_rapids_tpu_torch.exec.limit import (TpuGlobalLimitExec,
                                               TpuLocalLimitExec)
from spark_rapids_tpu_torch.exec.partition_sizing import (
    size_exchange_partitions)
from spark_rapids_tpu_torch.exec.sort import TpuSortExec, TpuTopNExec
from spark_rapids_tpu_torch.exec.transitions import TpuRowToColumnarExec
from spark_rapids_tpu_torch.exec.window import TpuWindowExec
from spark_rapids_tpu_torch.expr.base import Expression
from spark_rapids_tpu_torch.expr.cast import Cast, cast_supported
from spark_rapids_tpu_torch.io.scan import TpuFileSourceScanExec
from spark_rapids_tpu_torch.overrides.meta import (PORTED_EXPRS,
                                                   SparkPlanMeta, wrap_plan)
from spark_rapids_tpu_torch.overrides.transitions import TpuMaterializedScan
from spark_rapids_tpu_torch.plan import nodes as PN

_FLAT_TYPES = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
               T.LongType, T.FloatType, T.DoubleType, T.DateType,
               T.TimestampType, T.DecimalType, T.NullType, T.StringType)


def _ported_type(dt: T.DataType) -> bool:
    """A type the port's device columns hold: flat, string, a struct of
    them, or an array of flat elements other than decimal128."""
    if isinstance(dt, T.StructType):
        return all(_ported_type(f.dataType) for f in dt.fields)
    if isinstance(dt, T.ArrayType):
        et = dt.elementType
        return isinstance(et, _FLAT_TYPES) and not isinstance(
            et, (T.StringType, T.NullType)) and not (
                isinstance(et, T.DecimalType) and et.is_128)
    return isinstance(dt, _FLAT_TYPES)


def check_expression(e: Expression) -> None:
    """Raise ``NotOnGpu`` unless every node of ``e`` is one the port runs
    on the device (the gaps of the port; the reference's own reasons are
    tagged in ``overrides/meta.py`` first)."""
    for c in e.children:
        check_expression(c)
    if not _ported_type(e.dataType):
        raise NotOnGpu(f"type {e.dataType.simpleString} in {e.sql_string()}")
    if type(e) not in PORTED_EXPRS:
        raise NotOnGpu(f"expression {e.pretty_name}")
    if isinstance(e, Cast) and not cast_supported(e.child.dataType, e.to):
        raise NotOnGpu(f"cast {e.child.dataType} -> {e.to}")


def _collapse_complete_agg(meta: SparkPlanMeta) -> Optional[SparkPlanMeta]:
    """Final <- Exchange(hash or single partition) <- Partial, all three
    on the device: the Partial's meta, whose keys and aggregates one
    COMPLETE aggregate takes over (the exchange only co-locates keys
    across devices); else None."""
    node = meta.plan
    if node.mode != PN.AggregateMode.FINAL:
        return None
    ex_meta = meta.child_metas[0]
    ex = ex_meta.plan
    if not (isinstance(ex, PN.Exchange) and isinstance(
            ex.partitioning, (PN.SinglePartitioning, PN.HashPartitioning))):
        return None
    partial_meta = ex_meta.child_metas[0]
    partial = partial_meta.plan
    if not (isinstance(partial, PN.HashAggregate)
            and partial.mode == PN.AggregateMode.PARTIAL
            and ex_meta.can_this_run and partial_meta.can_this_run):
        return None
    return partial_meta


def _check_join(node: PN.SparkPlan) -> None:
    """Every join the tagging leaves on the device is ported (the inner,
    outer, semi and anti equi-joins, broadcast or shuffled, an inner one
    with a residual condition; the cross join; the nested-loop join's
    types): its keys and condition must be in the subset."""
    for e in list(node.left_keys) + list(node.right_keys) + (
            [node.condition] if node.condition is not None else []):
        check_expression(e)


def _exchange_check(node: PN.Exchange) -> None:
    """Partition keys must be in the subset (a hash key above 18 digits,
    whose murmur3 takes a BigInteger's bytes, is tagged off the device in
    ``overrides/meta.py`` first, as in the reference)."""
    p = node.partitioning
    keys = (p.keys if isinstance(p, PN.HashPartitioning)
            else [e for e, _ in p.orders]
            if isinstance(p, PN.RangePartitioning) else [])
    for k in keys:
        check_expression(k)


def _window_check(node: PN.Window) -> None:
    """Every window the tagging leaves on the device runs: each function
    of the reference's set in each frame (the reference's rules, words
    and 256-row cap are ``overrides/meta.py::_window_check``), so only the
    keys and inputs must be in the ported expression subset."""
    for e in list(node.partition_by) + [e for e, _ in node.order_by]:
        check_expression(e)
    for f in node.functions:
        if f.child is not None:
            check_expression(f.child)


def _coalesce_single_device_shuffle(node: TpuExec, conf: TpuConf
                                    ) -> TpuExec:
    """On one device, hash and round-robin exchanges that partition sizing
    left alone collapse to one partition: their partitions are parallelism
    that one card does not have, and joins and aggregates do not depend on
    the count.  A sized exchange keeps its partitions, which are the
    out-of-core schedule, and so does every exchange when
    ``spark.rapids.tpu.distributed.enabled`` is on: reduce partitions are
    the unit of placement on the workers, and one partition would put the
    whole exchange on one worker.  (The port runs on one device.)"""
    node.children = [_coalesce_single_device_shuffle(c, conf)
                     for c in node.children]
    if conf.get(SINGLE_DEVICE_SHUFFLE_COALESCE) \
            and not conf.get(DISTRIBUTED_ENABLED) \
            and isinstance(node, TpuShuffleExchangeExec) \
            and isinstance(node.partitioning, (PN.HashPartitioning,
                                               PN.RoundRobinPartitioning)) \
            and not getattr(node, "_ooc_sized", False):
        node.partitioning = PN.SinglePartitioning()
    return node


def _insert_coalesce(node: TpuExec, conf: TpuConf) -> TpuExec:
    """Over each exchange: an adaptive shuffle reader when
    ``spark.sql.adaptive.enabled`` is on, else a ``TpuCoalesceBatchesExec``
    to the batch-size goal, as the reference puts them."""
    node.children = [_insert_coalesce(c, conf) for c in node.children]
    goal_bytes = conf.get(BATCH_SIZE_BYTES)
    adaptive = conf.get(ADAPTIVE_ENABLED)
    node.children = [
        c if not isinstance(c, TpuShuffleExchangeExec)
        else TpuAdaptiveShuffleReaderExec(
            c, goal_bytes,
            small_bytes=conf.get(EXCHANGE_COALESCE_SMALL_BYTES))
        if adaptive else TpuCoalesceBatchesExec(CoalesceGoal(goal_bytes), c)
        for c in node.children]
    return node


def _rewrite_topn(node: TpuExec) -> TpuExec:
    """Limit(Sort) -> TopN."""
    node.children = [_rewrite_topn(c) for c in node.children]
    if isinstance(node, TpuLocalLimitExec):
        child = node.children[0]
        if isinstance(child, TpuSortExec):
            return TpuTopNExec(node.n, child.orders, child.children[0],
                               child.ansi)
    return node


def _rebuild_cpu_plan(meta: SparkPlanMeta, converted) -> PN.SparkPlan:
    """A node the reference keeps on the host: a CPU plan node over its
    converted children, device children through ``TpuMaterializedScan``.
    Raises ``NotOnGpu`` when the port's CPU engine does not run it."""
    from spark_rapids_tpu_torch.cpu.oracle import check_cpu_plan

    check_cpu_plan(meta.plan, "; ".join(meta.cannot_run_reasons))
    return meta.plan.with_new_children(
        [TpuMaterializedScan(c) if isinstance(c, TpuExec) else c
         for c in converted])


class TpuOverrides:
    @staticmethod
    def apply(plan: PN.SparkPlan, conf: TpuConf, device):
        """(root, meta): root is a device exec (possibly over CPU stages)
        or a CPU plan (possibly over device subtrees); meta is the tagged
        tree whose ``explain`` gives the fallback reasons."""
        if not conf.sql_enabled:
            raise NotOnGpu("spark.rapids.sql.enabled=false needs the "
                           "whole-query CPU oracle, which is not ported yet")
        meta = wrap_plan(plan, conf)
        meta.tag_for_tpu()
        root = TpuOverrides._convert(meta, conf, device)
        if isinstance(root, TpuExec):
            root = size_exchange_partitions(root, conf)
            root = _coalesce_single_device_shuffle(root, conf)
            root = _insert_coalesce(root, conf)
            root = fuse_stages(_rewrite_topn(root))
        return root, meta

    @staticmethod
    def _convert(meta: SparkPlanMeta, conf: TpuConf, device):
        """Bottom up: a device exec where ``meta`` has no reason (its CPU
        children through ``TpuRowToColumnarExec``), else a CPU plan."""
        node = meta.plan
        if isinstance(node, PN.HashAggregate) and meta.can_this_run:
            return _convert_aggregate(meta, conf, device)
        converted = [TpuOverrides._convert(m, conf, device)
                     for m in meta.child_metas]
        if not meta.can_this_run:
            return _rebuild_cpu_plan(meta, converted)
        ansi = bool(conf.ansi_enabled)
        return _convert_node(node, [_on_device(c, device, ansi)
                                    for c in converted],
                             conf, device, ansi)


def _on_device(child, device, ansi: bool) -> TpuExec:
    """A converted child as a device exec: a CPU plan under a device
    parent goes through ``TpuRowToColumnarExec``."""
    return child if isinstance(child, TpuExec) \
        else TpuRowToColumnarExec(child, device, ansi)


def _convert_aggregate(meta: SparkPlanMeta, conf: TpuConf, device
                       ) -> TpuExec:
    """An aggregate on the device as one COMPLETE aggregate: a Final one
    collapsed over the Partial's converted child, or a single-phase
    Complete one (the session's plan for collect, percentile and bloom
    filter aggregates) over its converted exchange, as the reference's
    transitions leave it."""
    node = meta.plan
    agg_meta = (meta if node.mode == PN.AggregateMode.COMPLETE
                else _collapse_complete_agg(meta))
    if agg_meta is None:
        raise NotOnGpu(f"aggregate {node.describe()} (only a two-phase "
                       "aggregate on one device, or a single-phase one, is "
                       "ported)")
    agg = agg_meta.plan
    ansi = bool(conf.ansi_enabled)
    child = _on_device(TpuOverrides._convert(agg_meta.child_metas[0],
                                             conf, device), device, ansi)
    for g in agg.grouping:
        check_expression(g)
    for a in agg.aggregates:
        if a.child2 is not None:
            check_expression(a.child2)
        if a.child is not None:
            check_expression(a.child)
    return TpuHashAggregateExec(
        agg.grouping, agg.aggregates, PN.AggregateMode.COMPLETE,
        child, agg.child.output, node.output, ansi)


def _convert_node(node: PN.SparkPlan, children, conf: TpuConf, device,
                  ansi: bool) -> TpuExec:
    """The exec of one node the tagging left on the device, over its
    converted ``children``; ``NotOnGpu`` for what the port lacks."""
    if isinstance(node, (PN.LocalTableScan, PN.FileSourceScan)):
        for f in node.output.fields:
            if not _ported_type(f.dataType):
                raise NotOnGpu(f"type {f.dataType.simpleString} of column "
                               f"{f.name} in {node.node_name}")
    if isinstance(node, PN.LocalTableScan):
        rows_cap = conf.get(MAX_READER_BATCH_SIZE_ROWS)
        return TpuLocalTableScanExec(
            node.host_columns, node.output, device,
            target_batch_rows=rows_cap if rows_cap < 2147483647 else None)
    if isinstance(node, PN.FileSourceScan):
        return TpuFileSourceScanExec(node, conf, device)
    if isinstance(node, PN.Filter):
        check_expression(node.condition)
        return TpuFilterExec(node.condition, children[0], ansi)
    if isinstance(node, PN.Project):
        for e in node.exprs:
            check_expression(e)
        return TpuProjectExec(node.exprs, children[0], ansi)
    if isinstance(node, PN.Union):
        return TpuUnionExec(children)
    if isinstance(node, PN.BroadcastNestedLoopJoin):
        _check_join(node)
        return TpuBroadcastNestedLoopJoinExec(
            children[0], children[1], node.join_type, node.condition,
            node.output, ansi)
    if isinstance(node, (PN.SortMergeJoin, PN.ShuffledHashJoin)):
        _check_join(node)
        if node.join_type == PN.JoinType.CROSS:
            return TpuCartesianProductExec(children[0], children[1],
                                           node.output, node.condition, ansi)
        shuffled = TpuShuffledSymmetricHashJoinExec(
            children[0], children[1], node.left_keys, node.right_keys,
            node.join_type, node.condition, node.output, ansi,
            sub_partition_bytes=conf.get(BATCH_SIZE_BYTES))
        if conf.get(ADAPTIVE_ENABLED) and all(
                isinstance(c, TpuShuffleExchangeExec)
                for c in shuffled.children):
            return TpuAdaptiveJoinExec(
                shuffled, conf.get(AUTO_BROADCAST_JOIN_THRESHOLD))
        return shuffled
    if isinstance(node, PN._BaseJoin):
        _check_join(node)
        return TpuBroadcastHashJoinExec(
            children[0], children[1], node.left_keys, node.right_keys,
            node.join_type, node.condition, node.output, ansi,
            sub_partition_bytes=conf.get(BATCH_SIZE_BYTES))
    if isinstance(node, PN.BroadcastExchange):
        return TpuBroadcastExchangeExec(children[0])
    if isinstance(node, PN.Exchange):
        _exchange_check(node)
        return TpuShuffleExchangeExec(node.partitioning, children[0], ansi,
                                      conf=conf)
    if isinstance(node, PN.Window):
        _window_check(node)
        return TpuWindowExec(node.functions, node.partition_by,
                             node.order_by, children[0], node.output,
                             node.frame, ansi)
    if isinstance(node, PN.Sort):
        for e, _ in node.orders:
            check_expression(e)
        return TpuSortExec(node.orders, node.is_global, children[0], ansi,
                           ooc_bytes=conf.get(BATCH_SIZE_BYTES))
    if isinstance(node, PN.GlobalLimit):
        return TpuGlobalLimitExec(node.n, children[0])
    if isinstance(node, PN.LocalLimit):
        return TpuLocalLimitExec(node.n, children[0])
    raise NotOnGpu(f"plan node {node.node_name}")

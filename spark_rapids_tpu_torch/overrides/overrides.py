"""Plan rewrite onto the device — the port's merge of
``spark_rapids_tpu/overrides/overrides.py``, ``overrides/meta.py`` and
``overrides/transitions.py`` for the nodes of TPC-H Q6, bench qa, qb and
qc, and the exchanges of the out-of-core path.

``TpuOverrides.apply`` checks every expression against the ported subset
(the reference's tagging, including ``_check_decimal_mult``,
``_window_check`` and ``_exchange_check``), converts each CPU plan node
into its exec, collapses a two-phase aggregate (Final <- Exchange(hash or
single partition) <- Partial) into one COMPLETE aggregate as the
reference's single-device ``_collapse_complete_agg`` does, and wraps a
shuffled join over two exchanges in the adaptive join when adaptive
execution is on.  Then it runs the steps of the reference's
``TpuTransitionOverrides.apply`` that the port has, in its order:
``size_exchange_partitions`` (grow an exchange whose static input
estimate is over the per-partition budget), ``_coalesce_single_device_
shuffle`` (collapse the other hash and round-robin exchanges to one
partition), ``_insert_coalesce`` (an adaptive shuffle reader over each
exchange, or a ``TpuCoalesceBatchesExec`` with adaptive execution off),
``_rewrite_topn`` (a limit over a sort becomes a top-N) and
``fuse_stages``.  The reference's
join-aggregate and window-chain fusions are not ported: their operators
run one after the other.  Anything outside the subset raises
``NotOnGpu``: the port has no CPU fallback yet.
"""
from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import (ADAPTIVE_ENABLED,
                                           AUTO_BROADCAST_JOIN_THRESHOLD,
                                           BATCH_SIZE_BYTES,
                                           EXCHANGE_COALESCE_SMALL_BYTES,
                                           MAX_READER_BATCH_SIZE_ROWS,
                                           SINGLE_DEVICE_SHUFFLE_COALESCE,
                                           TpuConf)
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.exec.basic import (TpuFilterExec,
                                               TpuLocalTableScanExec,
                                               TpuProjectExec, fuse_stages)
from spark_rapids_tpu_torch.exec.coalesce import (CoalesceGoal,
                                                  TpuCoalesceBatchesExec)
from spark_rapids_tpu_torch.exec.exchange import (
    TpuAdaptiveShuffleReaderExec, TpuBroadcastExchangeExec,
    TpuShuffleExchangeExec)
from spark_rapids_tpu_torch.exec.join import (
    TpuAdaptiveJoinExec, TpuBroadcastHashJoinExec,
    TpuShuffledSymmetricHashJoinExec)
from spark_rapids_tpu_torch.exec.limit import (TpuGlobalLimitExec,
                                               TpuLocalLimitExec)
from spark_rapids_tpu_torch.exec.partition_sizing import (
    size_exchange_partitions)
from spark_rapids_tpu_torch.exec.sort import TpuSortExec, TpuTopNExec
from spark_rapids_tpu_torch.exec.window import TpuWindowExec
from spark_rapids_tpu_torch.expr import arithmetic as A
from spark_rapids_tpu_torch.expr import conditional as CO
from spark_rapids_tpu_torch.expr import predicates as P
from spark_rapids_tpu_torch.expr.base import (Alias, BoundReference,
                                              Expression, Literal)
from spark_rapids_tpu_torch.expr.cast import _INTEGRAL, Cast
from spark_rapids_tpu_torch.io.scan import TpuFileSourceScanExec
from spark_rapids_tpu_torch.plan import nodes as PN

_FLAT_TYPES = (T.BooleanType, T.ByteType, T.ShortType, T.IntegerType,
               T.LongType, T.FloatType, T.DoubleType, T.DateType,
               T.DecimalType, T.NullType)

_PLAIN_EXPRS = (BoundReference, Literal, Alias, P.EqualTo, P.LessThan,
                P.LessThanOrEqual, P.GreaterThan, P.GreaterThanOrEqual,
                P.And, P.Or, P.Not, P.IsNull, P.IsNotNull,
                CO.Coalesce)     # Nvl too

#: window functions the port runs; the ranking ones ignore the frame
_WINDOW_RANK_FUNCS = {"row_number", "rank", "dense_rank", "percent_rank",
                      "cume_dist", "ntile"}
_WINDOW_AGG_FUNCS = {"sum", "count", "min", "max"}
_WINDOW_FRAMES = ("running", "unbounded")


def _check_decimal_mult(e: A.Multiply):
    """128x128 multiply needs 256-bit intermediates; operands above 18
    digits are not on the device (the reference falls back to the CPU)."""
    for side in (e.left, e.right):
        dt = side.dataType
        if isinstance(dt, T.DecimalType) and dt.precision > 18:
            raise NotOnGpu("decimal multiply with an operand above 18 "
                           "digits (needs 256-bit intermediates)")


def _check_decimal_addsub(e: A.Add):
    lt, rt = e.left.dataType, e.right.dataType
    if isinstance(lt, T.DecimalType) and isinstance(rt, T.DecimalType):
        s = max(lt.scale, rt.scale)
        p = max(lt.precision - lt.scale, rt.precision - rt.scale) + s + 1
        if p > 38:
            raise NotOnGpu("decimal add/subtract result exceeds 38 digits")


def _check_cast(e: Cast):
    src, dst = e.child.dataType, e.to
    ok = (src == dst
          or (isinstance(src, _INTEGRAL)
              and isinstance(dst, _INTEGRAL + (T.DecimalType,)))
          or (isinstance(src, T.DecimalType)
              and isinstance(dst, T.DecimalType)))
    if not ok:
        raise NotOnGpu(f"cast {src} -> {dst}")


def check_expression(e: Expression) -> None:
    """Raise ``NotOnGpu`` unless every node of ``e`` is in the subset."""
    for c in e.children:
        check_expression(c)
    if not isinstance(e.dataType, _FLAT_TYPES):
        raise NotOnGpu(f"type {e.dataType.simpleString} in {e.sql_string()}")
    if isinstance(e, A.Multiply):
        _check_decimal_mult(e)
    elif isinstance(e, A.Add):                  # Subtract too
        _check_decimal_addsub(e)
    elif isinstance(e, Cast):
        _check_cast(e)
    elif not isinstance(e, _PLAIN_EXPRS):
        raise NotOnGpu(f"expression {e.pretty_name}")


def _collapse_complete_agg(node: PN.HashAggregate
                           ) -> Optional[PN.HashAggregate]:
    """Final <- Exchange(hash or single partition) <- Partial: the Partial,
    whose keys and aggregates one COMPLETE aggregate takes over (the
    exchange only co-locates keys across devices); else None."""
    if node.mode != PN.AggregateMode.FINAL:
        return None
    ex = node.child
    if not (isinstance(ex, PN.Exchange) and isinstance(
            ex.partitioning, (PN.SinglePartitioning, PN.HashPartitioning))):
        return None
    partial = ex.child
    if not (isinstance(partial, PN.HashAggregate)
            and partial.mode == PN.AggregateMode.PARTIAL):
        return None
    return partial


def _check_join(node: PN.SparkPlan) -> None:
    """The inner and left outer equi-joins without a condition are
    ported, broadcast or shuffled (a build side over batchSizeBytes
    sub-partitions at run time)."""
    if node.join_type not in (PN.JoinType.INNER, PN.JoinType.LEFT_OUTER):
        raise NotOnGpu(f"join type {node.join_type.value}")
    if node.condition is not None:
        raise NotOnGpu("join with a residual condition")
    if not node.left_keys:
        raise NotOnGpu("join without equi-join keys")
    for k in list(node.left_keys) + list(node.right_keys):
        check_expression(k)


def _exchange_check(node: PN.Exchange) -> None:
    """Partition keys must be in the subset; murmur3 of a decimal above 18
    digits (a BigInteger's bytes) is not ported, as in the reference."""
    p = node.partitioning
    keys = (p.keys if isinstance(p, PN.HashPartitioning)
            else [e for e, _ in p.orders]
            if isinstance(p, PN.RangePartitioning) else [])
    for k in keys:
        check_expression(k)
        dt = k.dataType
        if isinstance(p, PN.HashPartitioning) and isinstance(
                dt, T.DecimalType) and dt.is_128:
            raise NotOnGpu("hash partitioning on decimals above 18 digits "
                           "(murmur3 big-integer path missing)")


def _window_check(node: PN.Window) -> None:
    """The reference's ``_window_check``, narrowed to the ported subset:
    the ranking functions, and sum/count/min/max over the running and
    unbounded frames on inputs of at most 18 digits."""
    for e in list(node.partition_by) + [e for e, _ in node.order_by]:
        check_expression(e)
    for f in node.functions:
        if f.func in _WINDOW_RANK_FUNCS:
            continue
        if f.func not in _WINDOW_AGG_FUNCS:
            raise NotOnGpu(f"window function {f.func}")
        if node.frame not in _WINDOW_FRAMES:
            raise NotOnGpu(f"window frame {node.frame!r}")
        check_expression(f.child)
        ct = f.child.dataType
        if isinstance(ct, T.DecimalType) and ct.is_128 \
                and f.func != "count":
            raise NotOnGpu(f"{f.func} over decimals above 18 digits in a "
                           "window")
        rt = f.result_type
        if isinstance(rt, T.DecimalType) and rt.is_128:
            raise NotOnGpu(f"window {f.func} with a {rt.simpleString} "
                           "result (needs 128-bit running sums)")


def _coalesce_single_device_shuffle(node: TpuExec, conf: TpuConf
                                    ) -> TpuExec:
    """On one device, hash and round-robin exchanges that partition sizing
    left alone collapse to one partition: their partitions are parallelism
    that one card does not have, and joins and aggregates do not depend on
    the count.  A sized exchange keeps its partitions, which are the
    out-of-core schedule.  (The port runs on one device.)"""
    node.children = [_coalesce_single_device_shuffle(c, conf)
                     for c in node.children]
    if conf.get(SINGLE_DEVICE_SHUFFLE_COALESCE) \
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


class TpuOverrides:
    @staticmethod
    def apply(plan: PN.SparkPlan, conf: TpuConf, device) -> TpuExec:
        if not conf.sql_enabled:
            raise NotOnGpu("spark.rapids.sql.enabled=false needs the CPU "
                           "oracle, which is not ported yet")
        root = TpuOverrides._convert(plan, conf, device)
        root = size_exchange_partitions(root, conf)
        root = _coalesce_single_device_shuffle(root, conf)
        root = _insert_coalesce(root, conf)
        return fuse_stages(_rewrite_topn(root))

    @staticmethod
    def _convert(node: PN.SparkPlan, conf: TpuConf, device) -> TpuExec:
        ansi = bool(conf.ansi_enabled)

        def conv(child):
            return TpuOverrides._convert(child, conf, device)

        if isinstance(node, PN.LocalTableScan):
            rows_cap = conf.get(MAX_READER_BATCH_SIZE_ROWS)
            return TpuLocalTableScanExec(
                node.host_columns, node.output, device,
                target_batch_rows=rows_cap if rows_cap < 2147483647
                else None)
        if isinstance(node, PN.FileSourceScan):
            return TpuFileSourceScanExec(node, conf, device)
        if isinstance(node, PN.Filter):
            check_expression(node.condition)
            return TpuFilterExec(node.condition, conv(node.child), ansi)
        if isinstance(node, PN.Project):
            for e in node.exprs:
                check_expression(e)
            return TpuProjectExec(node.exprs, conv(node.child), ansi)
        if isinstance(node, PN.HashAggregate):
            partial = _collapse_complete_agg(node)
            if partial is None:
                raise NotOnGpu(f"aggregate {node.describe()} (only a "
                               "two-phase aggregate on one device is "
                               "ported)")
            for g in partial.grouping:
                check_expression(g)
            for a in partial.aggregates:
                if a.child is not None:
                    check_expression(a.child)
            return TpuHashAggregateExec(
                partial.grouping, partial.aggregates,
                PN.AggregateMode.COMPLETE, conv(partial.child),
                partial.child.output, node.output, ansi)
        if isinstance(node, PN.SortMergeJoin):
            _check_join(node)
            shuffled = TpuShuffledSymmetricHashJoinExec(
                conv(node.left), conv(node.right), node.left_keys,
                node.right_keys, node.join_type, node.condition,
                node.output, ansi,
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
                conv(node.left), conv(node.right), node.left_keys,
                node.right_keys, node.join_type, node.condition,
                node.output, ansi,
                sub_partition_bytes=conf.get(BATCH_SIZE_BYTES))
        if isinstance(node, PN.BroadcastExchange):
            return TpuBroadcastExchangeExec(conv(node.children[0]))
        if isinstance(node, PN.Exchange):
            _exchange_check(node)
            return TpuShuffleExchangeExec(node.partitioning,
                                          conv(node.child), ansi, conf=conf)
        if isinstance(node, PN.Window):
            _window_check(node)
            return TpuWindowExec(node.functions, node.partition_by,
                                 node.order_by, conv(node.child),
                                 node.output, node.frame, ansi)
        if isinstance(node, PN.Sort):
            for e, _ in node.orders:
                check_expression(e)
            return TpuSortExec(node.orders, node.is_global, conv(node.child),
                               ansi)
        if isinstance(node, PN.GlobalLimit):
            return TpuGlobalLimitExec(node.n, conv(node.children[0]))
        if isinstance(node, PN.LocalLimit):
            return TpuLocalLimitExec(node.n, conv(node.children[0]))
        raise NotOnGpu(f"plan node {node.node_name}")

"""Plan rewrite onto the device — the port's merge of
``spark_rapids_tpu/overrides/overrides.py``, ``overrides/meta.py`` and
``overrides/transitions.py`` for the nodes of TPC-H Q6 and bench qa.

``TpuOverrides.apply`` checks every expression against the ported subset
(the reference's tagging, including ``_check_decimal_mult``), converts
each CPU plan node into its exec, collapses a two-phase aggregate (Final
<- Exchange(hash or single partition) <- Partial) into one COMPLETE
aggregate as the reference's single-device ``_collapse_complete_agg``
does, turns a limit over a sort into a top-N (``_rewrite_topn``) and runs
``fuse_stages``.  Anything outside the subset raises ``NotOnGpu``: the
port has no CPU fallback yet.
"""
from __future__ import annotations

from typing import Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import (BATCH_SIZE_BYTES,
                                           MAX_READER_BATCH_SIZE_ROWS,
                                           TpuConf)
from spark_rapids_tpu_torch.exec.aggregate import TpuHashAggregateExec
from spark_rapids_tpu_torch.exec.base import NotOnGpu, TpuExec
from spark_rapids_tpu_torch.exec.basic import (TpuFilterExec,
                                               TpuLocalTableScanExec,
                                               TpuProjectExec, fuse_stages)
from spark_rapids_tpu_torch.exec.exchange import TpuBroadcastExchangeExec
from spark_rapids_tpu_torch.exec.join import TpuBroadcastHashJoinExec
from spark_rapids_tpu_torch.exec.limit import (TpuGlobalLimitExec,
                                               TpuLocalLimitExec)
from spark_rapids_tpu_torch.exec.sort import TpuSortExec, TpuTopNExec
from spark_rapids_tpu_torch.expr import arithmetic as A
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
                P.And, P.Or, P.Not, P.IsNull, P.IsNotNull)


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


def _check_join(node: PN.SparkPlan, conf: TpuConf) -> None:
    """The inner broadcast equi-join without a condition is ported."""
    if isinstance(node, PN.SortMergeJoin):
        raise NotOnGpu("shuffled join (the build side is over "
                       "spark.sql.autoBroadcastJoinThreshold)")
    if node.join_type != PN.JoinType.INNER:
        raise NotOnGpu(f"join type {node.join_type.value}")
    if node.condition is not None:
        raise NotOnGpu("join with a residual condition")
    if not node.left_keys:
        raise NotOnGpu("join without equi-join keys")
    # the reference decides on the built batch's bytes at run time; this
    # plan-time estimate is the on-disk (compressed) size for a file scan,
    # so a build side that decodes past batchSizeBytes still runs here, as
    # one batch in device memory
    est = PN.estimated_plan_bytes(node.right)
    if est is not None and est > conf.get(BATCH_SIZE_BYTES):
        raise NotOnGpu(f"broadcast build side of {est} bytes needs the "
                       "sub-partitioned join")
    for k in list(node.left_keys) + list(node.right_keys):
        check_expression(k)


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
        if isinstance(node, PN._BaseJoin):
            _check_join(node, conf)
            return TpuBroadcastHashJoinExec(
                conv(node.left), conv(node.right), node.left_keys,
                node.right_keys, node.join_type, node.condition,
                node.output, ansi)
        if isinstance(node, PN.BroadcastExchange):
            return TpuBroadcastExchangeExec(conv(node.children[0]))
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

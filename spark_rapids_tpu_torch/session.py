"""TpuSession / DataFrame — the port's user entry point (port of the Q6
part of ``spark_rapids_tpu/session.py``).

The API is call-compatible with the reference: ``TpuSession(conf)``,
``create_dataframe``, ``read.schema(...).parquet(...)``, ``filter``,
``select``, ``agg``, ``explain`` and ``collect``, with ``col``, ``lit`` and
``sum_``.  A session runs on ``cuda`` unless it is given another device
(``TpuSession(conf, device="cpu")``); without a GPU and without a device
argument it raises.  Aggregates are planned two-phase around a
single-partition exchange exactly as in the reference; the plan rewrite
(``overrides/overrides.py``) collapses them for one device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.device import DeviceLike, resolve_device
from spark_rapids_tpu_torch.expr.base import Expression
from spark_rapids_tpu_torch.expr.base import col as _col
from spark_rapids_tpu_torch.expr.base import lit as _lit
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

    def agg(self, *aggs) -> "DataFrame":
        """Global aggregate: ``aggs`` are ``(func, column, name)`` tuples
        (``sum_``, ``count_``) or ``AggregateExpression``s."""
        schema = self.schema
        aexprs = []
        for a in aggs:
            if isinstance(a, PN.AggregateExpression):
                aexprs.append(a.resolve(schema))
                continue
            func, child, name = a
            ce = _to_expr(child) if child is not None else None
            aexprs.append(PN.AggregateExpression(func, ce, name)
                          .resolve(schema))
        partial = PN.HashAggregate([], aexprs, PN.AggregateMode.PARTIAL,
                                   self.plan)
        ex = PN.Exchange(PN.SinglePartitioning(), partial)
        final_aggs = [PN.AggregateExpression(a.func, a.child, a.result_name,
                                             a.result_type)
                      for a in aexprs]
        final = PN.HashAggregate([], final_aggs, PN.AggregateMode.FINAL, ex)
        return DataFrame(final, self.session)

    def _planned(self):
        from spark_rapids_tpu_torch.overrides.overrides import TpuOverrides

        return TpuOverrides.apply(self.plan, self.session.conf,
                                  self.session.device)

    def collect(self) -> List[tuple]:
        from spark_rapids_tpu_torch.exec.transitions import (
            TpuColumnarToRowExec)

        return TpuColumnarToRowExec(self._planned()).collect_rows()

    def explain(self) -> str:
        """The rewritten device plan, one operator per line."""
        return self._planned().pretty()


def sum_(c: ColumnLike, name: str = "sum") -> Tuple[str, ColumnLike, str]:
    return ("sum", c, name)


def count_(c: Optional[ColumnLike] = None, name: str = "count"):
    return ("count", c, name) if c is not None else ("count_star", None, name)


# pyspark.sql.functions flavoured re-exports
col = _col
lit = _lit

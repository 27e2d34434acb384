"""The whole slice: TPC-H Q6 on the port (``device="cpu"``) against the JAX
package — its CPU oracle session, its device session (run once, in a child
process), numpy, and ``__graft_entry__.entry``'s ``q6_step`` — over ~20k
rows in 2 snappy Parquet files, and on empty, all-filtered and
null-bearing inputs.  Every comparison is exact."""
import datetime
import os
from decimal import Decimal

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.session import TpuSession as RefSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.columnar.convert import batch_from_numpy
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from spark_rapids_tpu_torch.expr.decimal128 import to_py
from spark_rapids_tpu_torch.plan.nodes import LocalTableScan
from spark_rapids_tpu_torch.session import DataFrame, TpuSession, count_
from torch_port_jaxref import run_jax

NAMES = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
PLAN_LINE = ("TpuHashAggregate(Complete) keys=[] aggs=[sum(revenue) AS "
             "revenue] fused=[FilterProject]")
CONF = {"spark.rapids.sql.format.parquet.decode.device": True,
        "spark.rapids.sql.format.parquet.reader.type": "PERFILE"}


def q6(df, mod, *extra_aggs):
    """The Q6 query built from either package's col/lit/sum_."""
    col, lit, sum_ = mod.col, mod.lit, mod.sum_
    return (df.filter((col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                      & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                      & (col("l_discount") >= lit(Decimal("0.05")))
                      & (col("l_discount") <= lit(Decimal("0.07")))
                      & (col("l_quantity") < lit(Decimal(24))))
            .select((col("l_extendedprice") * col("l_discount"))
                    .alias("revenue"))
            .agg(sum_("revenue", "revenue"), *extra_aggs))


def schema(mod):
    money = mod.DecimalType(12, 2)
    return mod.StructType([mod.StructField(n, mod.DATE if n == "l_shipdate"
                                           else money) for n in NAMES])


def lineitem(n, seed, discount_hi=11, null_share=0.0):
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n) * 100
    pk = rng.integers(1, 4001, n)
    li = {"l_quantity": quantity,
          "l_extendedprice": quantity // 100 * (
              90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)),
          "l_discount": rng.integers(0, discount_hi, n),
          "l_shipdate": (rng.integers(8035, 10441, n)
                         + rng.integers(1, 122, n)).astype(np.int32)}
    valid = {k: rng.random(n) >= null_share for k in NAMES}
    return li, valid


def numpy_q6(li, valid):
    f = ((li["l_shipdate"] >= 8766) & (li["l_shipdate"] < 9131)
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 2400))
    for v in valid.values():
        f &= v
    if not f.any():
        return None
    return Decimal(int(np.sum(li["l_extendedprice"][f]
                              * li["l_discount"][f]))).scaleb(-4)


def write_files(tmp_path, li, valid, nfiles=2):
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = len(li["l_quantity"])
    bounds = np.linspace(0, n, nfiles + 1).astype(int)
    paths = []
    for i in range(nfiles):
        s = slice(bounds[i], bounds[i + 1])
        cols = {}
        for k in NAMES:
            v, ok = li[k][s], valid[k][s]
            if k == "l_shipdate":
                cols[k] = pa.array(v.astype("datetime64[D]"), pa.date32(),
                                   mask=~ok)
            else:
                cols[k] = pa.array([Decimal(int(x)).scaleb(-2) if o
                                    else None for x, o in zip(v, ok)],
                                   pa.decimal128(12, 2))
        path = str(tmp_path / f"lineitem-{i}.parquet")
        pq.write_table(pa.table(cols), path, compression="snappy",
                       store_decimal_as_integer=True)
        paths.append(path)
    return paths


def port_q6(paths):
    import spark_rapids_tpu_torch.session as S

    s = TpuSession(CONF, device="cpu")
    df = q6(s.read.schema(schema(T)).parquet(*paths), S)
    return df, df.collect()


def oracle_q6(paths):
    import spark_rapids_tpu.session as RS

    s = RefSession({"spark.rapids.sql.enabled": False})
    return q6(s.read.schema(schema(RT)).parquet(*paths), RS).collect()


CASES = {"main": dict(n=20_000, seed=1),
         "all_filtered": dict(n=3000, seed=2, discount_hi=4),
         "nulls": dict(n=8000, seed=3, null_share=0.1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_q6_parquet_matches_oracle_and_numpy(tmp_path, case):
    pytest.importorskip("pyarrow")
    li, valid = lineitem(**CASES[case])
    paths = write_files(tmp_path, li, valid)
    df, got = port_q6(paths)
    want = numpy_q6(li, valid)
    assert got == [(want,)]
    assert got == oracle_q6(paths)
    assert df.explain().splitlines()[0] == PLAN_LINE
    assert df.schema.fields[0].dataType == T.DecimalType(35, 4)
    assert df.collect() == got                  # a second run agrees


def test_q6_empty_parquet_file(tmp_path):
    pytest.importorskip("pyarrow")
    li, valid = lineitem(0, 4)
    paths = write_files(tmp_path, li, valid, nfiles=1)
    _, got = port_q6(paths)
    assert got == [(None,)] == oracle_q6(paths)


def test_q6_scan_of_no_files_gives_the_empty_aggregate():
    import spark_rapids_tpu_torch.session as S

    s = TpuSession(CONF, device="cpu")
    got = q6(s.read.schema(schema(T)).parquet(), S,
             count_(None, "n")).collect()
    assert got == [(None, 0)]


def test_q6_in_memory_and_empty(tmp_path):
    import spark_rapids_tpu_torch.session as S

    for n, seed in ((20_000, 5), (0, 6)):
        li, valid = lineitem(n, seed)
        s = TpuSession({}, device="cpu")
        host = [HostColumn.from_numpy(np.asarray(li[k]), f.dataType)
                for k, f in zip(NAMES, schema(T).fields)]
        got = q6(DataFrame(LocalTableScan(host, schema(T)), s), S).collect()
        assert got == [(numpy_q6(li, valid),)]


@pytest.fixture(scope="module")
def reference_device_run(tmp_path_factory):
    """The JAX device session once on the main files (its explain line and
    result), and ``__graft_entry__.entry``'s q6_step on its own arrays."""
    tmp = tmp_path_factory.mktemp("q6dev")
    li, valid = lineitem(**CASES["main"])
    paths = write_files(tmp, li, valid)
    out = run_jax(f"""
        import datetime
        from decimal import Decimal
        import jax
        from spark_rapids_tpu import types as T
        import spark_rapids_tpu.session as S
        money = T.DecimalType(12, 2)
        names = {NAMES!r}
        sch = T.StructType([T.StructField(n, T.DATE if n == "l_shipdate"
                                          else money) for n in names])
        s = S.TpuSession({CONF!r})
        col, lit, sum_ = S.col, S.lit, S.sum_
        df = (s.read.schema(sch).parquet(*{paths!r})
              .filter((col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                      & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                      & (col("l_discount") >= lit(Decimal("0.05")))
                      & (col("l_discount") <= lit(Decimal("0.07")))
                      & (col("l_quantity") < lit(Decimal(24))))
              .select((col("l_extendedprice") * col("l_discount"))
                      .alias("revenue"))
              .agg(sum_("revenue", "revenue")))
        (rev,), = df.collect()
        out["revenue"] = np.array(str(rev))
        out["plan"] = np.array(df.explain().splitlines()[0])
        import __graft_entry__
        fn, args = __graft_entry__.entry()
        total, count = jax.jit(fn)(*args)
        for k, a in zip(("price", "discount", "quantity", "shipdate",
                         "valid", "num_rows"), args):
            out[k] = np.asarray(a)
        out["sum"], out["count"] = np.asarray(total), np.asarray(count)
    """, tmp)
    return paths, li, valid, out


def test_q6_matches_reference_device_session(reference_device_run):
    paths, li, valid, out = reference_device_run
    df, got = port_q6(paths)
    assert str(out["plan"]) == PLAN_LINE == df.explain().splitlines()[0]
    assert got == [(Decimal(str(out["revenue"])),)]
    assert got == [(numpy_q6(li, valid),)]


def test_fused_stage_matches_graft_q6_step(reference_device_run):
    """``q6_step`` (the reference's standalone fused Q6) against the port's
    fused aggregate on the same arrays, carried over by batch_from_numpy."""
    import spark_rapids_tpu_torch.session as S

    out = reference_device_run[3]
    n = int(out["num_rows"])
    money = T.DecimalType(12, 2)
    sch = T.StructType([T.StructField("l_extendedprice", money),
                        T.StructField("l_discount", money),
                        T.StructField("l_quantity", money),
                        T.StructField("l_shipdate", T.DATE)])
    arrays = [out["price"], out["discount"], out["quantity"],
              out["shipdate"]]
    batch = batch_from_numpy([(a, out["valid"]) for a in arrays], sch,
                             torch.device("cpu"))
    s = TpuSession({}, device="cpu")
    host = [HostColumn.from_numpy(a, f.dataType)
            for a, f in zip(arrays, sch.fields)]
    root = q6(DataFrame(LocalTableScan(host, sch), s), S,
              count_(None, "n"))._planned()
    assert root.describe().endswith("fused=[FilterProject]")
    # the batch's buffer, finished (a buffer holds each sum's overflow
    # flag beside it)
    res = root._finish(root._aggregate_batch(batch)).to_host_columns()
    assert batch.num_rows == n
    assert to_py(*res[0].data[0]) == int(out["sum"])
    assert int(res[1].data[0]) == int(out["count"])


def test_unported_paths_raise():
    s = TpuSession({"spark.rapids.sql.enabled": False}, device="cpu")
    df = s.create_dataframe({"a": [1]}, T.StructType(
        [T.StructField("a", T.INT)]))
    with pytest.raises(NotOnGpu):
        df.agg(("sum", "a", "s")).collect()
    s = TpuSession({"spark.rapids.sql.format.parquet.reader.type":
                    "PERFILE"}, device="cpu")
    df = s.read.schema(schema(T)).parquet(os.devnull)
    with pytest.raises(NotOnGpu, match="host Parquet decode is not ported"):
        df.collect()
    with pytest.raises(NotImplementedError):
        s.read.parquet(os.devnull)

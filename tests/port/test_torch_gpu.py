"""Card-only checks of the port (marked ``gpu``; each skips without a CUDA
device).  This file imports no jax, so it also runs on a machine without
it: ``python -m pytest tests/port/test_torch_gpu.py --noconftest``."""
import datetime
from decimal import Decimal

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.io.parquet_encode import write_parquet_device
from spark_rapids_tpu_torch.io.parquet_native import split_hybrid_runs
from spark_rapids_tpu_torch.pallas import decode
from spark_rapids_tpu_torch.session import TpuSession, col, lit, sum_
from torch_port_data import hybrid_stream, page_batch


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.gpu
def test_k1_kernel_matches_plain_on_gpu():
    _need_gpu()
    rng = np.random.default_rng(21)
    for bw in range(1, 25):
        buf, total = hybrid_stream(rng, bw, 100_000, 5000)
        runs = split_hybrid_runs(buf, bw, total)
        dev = torch.from_numpy(np.frombuffer(buf, np.uint8).copy()).cuda()
        table = torch.from_numpy(decode.run_table(runs, total, bw)).cuda()
        before = decode.unpack_launches
        got = decode.unpack_runs(dev, 0, table, total)
        assert decode.unpack_launches == before + 1
        want = decode.unpack_runs_plain(dev, 0, table, total)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_k1_rejects_mixed_devices():
    _need_gpu()
    table = torch.from_numpy(decode.run_table([], 8, 3))
    with pytest.raises(ValueError):
        decode.unpack_runs(torch.zeros(8, dtype=torch.uint8, device="cuda"),
                           0, table, 8)


# multi-page batches: (kind, bw, count) per page, as torch_port_data makes
_GPU_BATCHES = [
    [("spark", bw, 20_000) for bw in (11, 11, 12, 12, 13)],
    [("ones", bw, 30_000) for bw in (2, 9, 24)],
    [("cut", bw, 25_000) for bw in (1, 7, 16, 21, 24)],
    [("one_run", 12, 100_000), ("ones", 12, 5_000), ("zero", 0, 77),
     ("spark", 13, 40_000), ("cut", 24, 9_000), ("one_run", 1, 30_001)],
]


@pytest.mark.gpu
@pytest.mark.parametrize("spec", range(len(_GPU_BATCHES)))
def test_k1_batches_match_plain_on_gpu(spec):
    """One launch over a batch of pages, its stream 13 bytes into the
    buffer, equals the plain version exactly."""
    _need_gpu()
    b = page_batch(np.random.default_rng(40 + spec), _GPU_BATCHES[spec])
    dev = torch.from_numpy(np.frombuffer(bytes(13) + b["buf"],
                                         np.uint8).copy()).cuda()
    table = torch.from_numpy(b["table"]).cuda()
    before = decode.unpack_launches
    got = decode.unpack_runs(dev, 13, table, b["total"])
    assert decode.unpack_launches == before + 1
    want = decode.unpack_runs_plain(dev, 13, table, b["total"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_many_page_chunks_take_one_launch_each():
    """The committed fixture (5 dictionary pages a column) decodes with one
    K1 launch per column chunk, on both transfer paths, equal to the arrays
    regenerated from its seed."""
    _need_gpu()
    import os
    import sys

    from spark_rapids_tpu_torch.io.parquet_device import read_parquet_device

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from chip_smoke import FIXTURE, fixture_lineitem, schemas

    li = fixture_lineitem()
    _, rsch = schemas()
    for compressed in (True, False):
        before = decode.unpack_launches
        batch = read_parquet_device(os.path.join(root, FIXTURE), rsch,
                                    torch.device("cuda"), compressed)
        assert decode.unpack_launches - before == len(rsch.fields)
        for f, c in zip(rsch.fields, batch.columns):
            np.testing.assert_array_equal(c.data.cpu().numpy(), li[f.name])


@pytest.mark.gpu
def test_q6_from_parquet_on_gpu_launches_k1(tmp_path):
    _need_gpu()
    rng = np.random.default_rng(5)
    n = 50_000
    q = rng.integers(1, 51, n) * 100
    d = rng.integers(0, 11, n)
    p = q // 100 * rng.integers(90_000, 210_000, n)
    s = (rng.integers(8035, 10441, n) + rng.integers(1, 122, n)).astype(
        np.int32)
    names = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
    wsch = T.StructType([T.StructField(nm, T.DATE if nm == "l_shipdate"
                                       else T.LONG, False) for nm in names])
    rsch = T.StructType([T.StructField(nm, T.DATE if nm == "l_shipdate"
                                       else T.DecimalType(12, 2))
                         for nm in names])
    path = str(tmp_path / "li.parquet")
    write_parquet_device(path, wsch, [HostColumn.from_numpy(a, f.dataType)
                                      for a, f in zip([q, p, d, s],
                                                      wsch.fields)], n,
                         device="cuda")
    sess = TpuSession({"spark.rapids.sql.format.parquet.decode.device": True,
                       "spark.rapids.sql.format.parquet.reader.type":
                       "PERFILE"})
    assert sess.device.type == "cuda"
    df = (sess.read.schema(rsch).parquet(path)
          .filter((col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                  & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                  & (col("l_discount") >= lit(Decimal("0.05")))
                  & (col("l_discount") <= lit(Decimal("0.07")))
                  & (col("l_quantity") < lit(Decimal(24))))
          .select((col("l_extendedprice") * col("l_discount"))
                  .alias("revenue"))
          .agg(sum_("revenue", "revenue")))
    before = decode.unpack_launches
    got = df.collect()
    assert decode.unpack_launches - before == 4
    f = (s >= 8766) & (s < 9131) & (d >= 5) & (d <= 7) & (q < 2400)
    assert got == [(Decimal(int((p[f] * d[f]).sum())).scaleb(-4),)]


@pytest.mark.gpu
def test_decimal128_limb_math_matches_cpu_on_gpu():
    """The CPU results are held against the JAX package in
    test_torch_decimal128.py; CUDA must wrap int64 the same way."""
    _need_gpu()
    from spark_rapids_tpu_torch.expr import decimal128 as D

    rng = np.random.default_rng(3)
    edges = np.array([0, 1, -1, 10 ** 18 - 1, -(10 ** 18 - 1), -(2 ** 63),
                      2 ** 63 - 1], np.int64)
    a = np.concatenate([np.repeat(edges, 7), rng.integers(
        -(2 ** 63), 2 ** 63 - 1, 5000, dtype=np.int64)])
    b = np.concatenate([np.tile(edges, 7), rng.integers(
        -(2 ** 63), 2 ** 63 - 1, 5000, dtype=np.int64)])
    valid = rng.random(len(a)) < 0.7
    for dev in ("cpu", "cuda"):
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        hi, lo = D.mul64_to_128(ta, tb)
        res = [hi, lo, *D.sum128_global(hi, lo,
                                        torch.from_numpy(valid).to(dev)),
               D.in_bounds(hi, lo, 37)]
        if dev == "cpu":
            want = [r.numpy() for r in res]
        else:
            for g, w in zip(res, want):
                np.testing.assert_array_equal(g.cpu().numpy(), w)

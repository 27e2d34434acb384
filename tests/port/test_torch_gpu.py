"""Card-only checks of the port (marked ``gpu``; each skips without a CUDA
device).  This file imports no jax, so it also runs on a machine without
it: ``python -m pytest tests/port/test_torch_gpu.py --noconftest``."""
import datetime
import math
import os
import sys
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
from torch_port_jaxref import REPO


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


def _qa_files(tmp_path, n, nfiles):
    sys.path.insert(0, REPO)
    import chip_smoke as C

    ss, dd = C.make_store_sales(n), C.make_date_dim()
    wsch, _, dsch = C.qa_schemas(T)
    bounds = np.linspace(0, n, nfiles + 1).astype(int)
    paths = []
    for i in range(nfiles):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        path = str(tmp_path / f"ss-{i}.parquet")
        write_parquet_device(path, wsch, [
            HostColumn.from_numpy(ss[f.name][lo:hi], f.dataType)
            for f in wsch.fields], hi - lo, device="cuda")
        paths.append(path)
    dd_path = str(tmp_path / "dd.parquet")
    write_parquet_device(dd_path, dsch, [
        HostColumn.from_numpy(dd[f.name], f.dataType) for f in dsch.fields],
        len(dd["date_sk"]), device="cuda")
    return C, ss, dd, paths, dd_path


@pytest.mark.gpu
def test_qa_from_parquet_on_gpu_equals_cpu(tmp_path):
    """bench qa on the card and on the CPU from the same files: equal to
    each other and to the numpy reference; K1 launches once per column
    chunk the query reads (3 store_sales columns a file, 4 of date_dim)."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S

    C, ss, dd, paths, dd_path = _qa_files(tmp_path, 60_000, 3)
    _, rsch, dsch = C.qa_schemas(T)
    got = {}
    for dev in ("cuda", "cpu"):
        s = S.TpuSession(C.QA_CONF, device=dev)
        q = C.qa_query(s.read.schema(rsch).parquet(*paths),
                       s.read.schema(dsch).parquet(dd_path), S)
        before = decode.unpack_launches
        got[dev] = q.collect()
        if dev == "cuda":
            assert decode.unpack_launches - before == 3 * 3 + 4
            assert q.collect() == got[dev]
    assert got["cuda"] == got["cpu"] == C.qa_reference(ss, dd)


@pytest.mark.gpu
def test_grouped_aggregates_and_two_key_join_on_gpu_equal_cpu():
    """Sort keys, segmented reductions, the decimal128 sums and the
    merge-rank search on the card, against the same queries on the CPU
    (held against the JAX package in test_torch_groupby.py and
    test_torch_join.py)."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.columnar.column import HostColumn as H
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    rng = np.random.default_rng(9)
    n = 20_000
    dec = T.DecimalType(30, 2)
    sch = T.StructType([T.StructField("k", T.INT), T.StructField("k2", T.LONG),
                        T.StructField("v", T.LONG), T.StructField("h", dec),
                        T.StructField("f", T.DOUBLE)])
    h = np.stack([rng.integers(-2 ** 30, 2 ** 30, n),
                  rng.integers(-2 ** 63, 2 ** 63 - 1, n)], axis=1)
    cols = [H.from_numpy(rng.integers(0, 50, n).astype(np.int32), T.INT,
                         rng.random(n) > 0.1),
            H.from_numpy(rng.integers(0, 4, n), T.LONG),
            H.from_numpy(rng.integers(-10 ** 9, 10 ** 9, n), T.LONG,
                         rng.random(n) > 0.1),
            H.from_numpy(h, dec, rng.random(n) > 0.1),
            H.from_numpy(rng.choice([0.0, -0.0, np.nan, 2.5], n), T.DOUBLE)]
    out = {}
    for dev in ("cuda", "cpu"):
        s = S.TpuSession({"spark.rapids.sql.reader.batchSizeRows": 6000},
                         device=dev)
        df = S.DataFrame(LocalTableScan(cols, sch), s)
        agg = (df.group_by("k", "f")
               .agg(S.sum_("v", "sv"), S.sum_("h", "sh"), S.min_("h", "mn"),
                    S.max_("v", "mx"), S.count_(None, "n"))
               .order_by("k", "f", "sv"))
        small = df.filter(S.col("v") < S.lit(-990_000_000)).select("k", "k2")
        joined = df.join(small, on=["k", "k2"]).agg(
            S.sum_("v", "sv"), S.count_(None, "n"))
        out[dev] = (agg.collect(), joined.collect())
    assert out["cuda"][1] == out["cpu"][1]
    assert [tuple("NaN" if x != x else x for x in r)
            for r in out["cuda"][0]] == [
        tuple("NaN" if x != x else x for x in r) for r in out["cpu"][0]]


def _returns_files(tmp_path, C, sr, nfiles):
    _, rsch = C.qb_schemas(T)
    n = len(sr["ticket"])
    bounds = np.linspace(0, n, nfiles + 1).astype(int)
    paths = []
    for i in range(nfiles):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        path = str(tmp_path / f"sr-{i}.parquet")
        write_parquet_device(path, rsch, [
            HostColumn.from_numpy(sr[f.name][lo:hi], f.dataType)
            for f in rsch.fields], hi - lo, device="cuda")
        paths.append(path)
    return paths


@pytest.mark.gpu
@pytest.mark.parametrize("decision", ["shuffled", "broadcast"])
def test_qb_from_parquet_on_gpu_equals_cpu(tmp_path, decision):
    """bench qb on the card and on the CPU from the same files, under each
    run-time decision of the adaptive join: shuffled (6,000 returns over a
    16 KiB threshold), broadcast (60 returns in three files, over a
    1,500-byte threshold on disk and within it once built).  Equal to
    each other
    and to the numpy reference; K1 launches once per column chunk the
    query reads (4 store_sales columns a file, 3 store_returns ones)."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S

    C, ss, _, paths, _ = _qa_files(tmp_path, 60_000, 3)
    sr = C.make_store_returns(ss, 6000 if decision == "shuffled" else 60)
    sr_paths = _returns_files(tmp_path, C, sr, 3)
    ssch, rsch = C.qb_schemas(T)
    threshold = 16 << 10 if decision == "shuffled" else 1500
    built = len(sr["ticket"]) * (9 + 5 + 9)
    on_disk = sum(os.path.getsize(p) for p in sr_paths)
    assert threshold < on_disk
    assert (built <= threshold) == (decision == "broadcast")
    conf = dict(C.QA_CONF, **{"spark.sql.autoBroadcastJoinThreshold":
                              str(threshold)})
    got = {}
    for dev in ("cuda", "cpu"):
        s = S.TpuSession(conf, device=dev)
        q = C.qb_query(s.read.schema(ssch).parquet(*paths),
                       s.read.schema(rsch).parquet(*sr_paths), S)
        before = decode.unpack_launches
        got[dev] = sorted(q.collect())
        assert f"decided={decision}(" in q.explain()
        if dev == "cuda":
            assert decode.unpack_launches - before == 4 * 3 + 3 * 3
            assert sorted(q.collect()) == got[dev]
    assert got["cuda"] == got["cpu"] == C.qb_reference(ss, sr)


@pytest.mark.gpu
def test_qc_from_parquet_on_gpu_equals_cpu(tmp_path):
    """bench qc on the card and on the CPU from the same files: equal to
    each other and to the numpy reference; K1 launches once per column
    chunk the query reads (3 store_sales columns a file)."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S

    C, ss, _, paths, _ = _qa_files(tmp_path, 60_000, 3)
    _, rsch, _ = C.qa_schemas(T)
    got = {}
    for dev in ("cuda", "cpu"):
        s = S.TpuSession(C.QA_CONF, device=dev)
        q = C.qc_query(s.read.schema(rsch).parquet(*paths), S)
        before = decode.unpack_launches
        got[dev] = C.qc_rows(q.collect())
        if dev == "cuda":
            assert decode.unpack_launches - before == 3 * 3
            assert C.qc_rows(q.collect()) == got[dev]
    assert got["cuda"] == got["cpu"] == C.qc_reference(ss)


@pytest.mark.gpu
def test_windows_and_left_outer_join_on_gpu_equal_cpu():
    """Every ported window function in both frames, and a left outer join
    with null keys on both sides, on the card against the same queries on
    the CPU (held against the JAX package in test_torch_window.py and
    test_torch_join.py)."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.columnar.column import HostColumn as H
    from spark_rapids_tpu_torch.plan.nodes import (LocalTableScan,
                                                   WindowFunction)

    rng = np.random.default_rng(12)
    n = 30_000
    sch = T.StructType([T.StructField("k", T.INT), T.StructField("o", T.INT),
                        T.StructField("v", T.LONG),
                        T.StructField("f", T.DOUBLE)])
    cols = [H.from_numpy(rng.integers(0, 300, n).astype(np.int32), T.INT,
                         rng.random(n) > 0.05),
            H.from_numpy(rng.integers(0, 50, n).astype(np.int32), T.INT,
                         rng.random(n) > 0.05),
            H.from_numpy(rng.integers(-10 ** 9, 10 ** 9, n), T.LONG,
                         rng.random(n) > 0.1),
            H.from_numpy(rng.choice([0.0, -0.0, np.nan, 2.5, -7.0], n),
                         T.DOUBLE, rng.random(n) > 0.1)]

    def norm(rows):
        return sorted((tuple("NaN" if x != x else x for x in r)
                       for r in rows), key=repr)

    out = {}
    for dev in ("cuda", "cpu"):
        s = S.TpuSession({"spark.rapids.sql.reader.batchSizeRows": 7000,
                          "spark.sql.autoBroadcastJoinThreshold": "-1"},
                         device=dev)
        df = S.DataFrame(LocalTableScan(cols, sch), s)
        res = []
        for frame in ("running", "unbounded"):
            fns = [WindowFunction(f, None, f) for f in (
                "row_number", "rank", "dense_rank", "percent_rank",
                "cume_dist")]
            fns.append(WindowFunction("ntile", None, "nt", buckets=4))
            fns += [WindowFunction(f, S.col(c), f"{f}_{c}")
                    for f in ("sum", "count", "min", "max")
                    for c in ("v", "f")]
            w = df.window(fns, partition_by=["k"],
                          order_by=[(S.col("o"), S.SortSpec(False, False))],
                          frame=frame)
            res.append(norm(w.collect()))
        right = df.filter(S.col("v") > S.lit(900_000_000)).select(
            "k", "o", "v")
        res.append(norm(df.select("k", "o").join(
            right, on=["k", "o"], how="left").collect()))
        out[dev] = res
    assert out["cuda"] == out["cpu"]


@pytest.mark.gpu
def test_murmur3_and_partition_slices_on_gpu_equal_cpu():
    """Spark's partition ids and the exchange's slices of one batch, on
    the card and on the CPU, for every hashed type with nulls."""
    _need_gpu()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.expr.base import col as ecol
    from spark_rapids_tpu_torch.ops.hashing import spark_partition_ids
    from spark_rapids_tpu_torch.plan.nodes import HashPartitioning

    rng = np.random.default_rng(31)
    n = 200_003
    cols = {"i": (T.INT, rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)),
            "l": (T.LONG, rng.integers(-2 ** 63, 2 ** 63 - 1, n)),
            "d": (T.DOUBLE, rng.standard_normal(n)),
            "f": (T.FLOAT, rng.standard_normal(n).astype(np.float32)),
            "b": (T.BOOLEAN, rng.integers(0, 2, n).astype(np.bool_)),
            "m": (T.DecimalType(12, 2), rng.integers(-10 ** 11, 10 ** 11, n))}
    cols["d"][1][:3] = [-0.0, np.nan, np.inf]
    sch = T.StructType([T.StructField(k, t) for k, (t, _) in cols.items()])

    def batch(device):
        return ColumnarBatch([DeviceColumn(
            t, torch.from_numpy(rng_valid).to(device),
            data=torch.from_numpy(a).to(device))
            for (t, a), rng_valid in zip(cols.values(), valids)], n, sch)

    valids = [rng.random(n) > 0.1 for _ in cols]
    cpu, gpu = batch("cpu"), batch("cuda")
    for k in range(len(cols)):
        want = spark_partition_ids(cpu.columns[k:k + 2], 211)
        got = spark_partition_ids(gpu.columns[k:k + 2], 211)
        assert torch.equal(got.cpu(), want)
    ex = TpuShuffleExchangeExec(HashPartitioning(
        [ecol("l").resolve(sch), ecol("i").resolve(sch)], 97), None)
    want = list(ex.partition_slices(cpu))
    got = list(ex.partition_slices(gpu))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        for gc, wc in zip(g.columns, w.columns):
            np.testing.assert_array_equal(gc.data.cpu().numpy(),
                                          wc.data.numpy())   # NaN == NaN
            assert torch.equal(gc.validity.cpu(), wc.validity)
    # strings of every tail length, multi-byte UTF-8, past a width bucket
    pool = ["", "a", "ab", "abc", "abcd", "MAIL", "1-URGENT",
            "4-NOT SPECIFIED", "naïve café", "z" * 40, None]
    h = HostColumn.from_pylist([pool[i] for i in
                                rng.integers(0, len(pool), n)], T.STRING)
    scpu, sgpu = (DeviceColumn.from_host(h, d) for d in ("cpu", "cuda"))
    for k in (None, 0):
        head = (lambda b: []) if k is None else (lambda b: [b.columns[k]])
        want = spark_partition_ids(head(cpu) + [scpu], 211)
        got = spark_partition_ids(head(gpu) + [sgpu], 211)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_spill_round_trip_through_pinned_memory(tmp_path):
    """Card -> pinned host -> disk -> card: the host tier is pinned, the
    bytes come back exact, and the disk tier's CRC holds."""
    _need_gpu()
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.memory.spill import SpillFramework

    n = 3_000_000
    sch = T.StructType([T.StructField("a", T.LONG),
                        T.StructField("m", T.DecimalType(30, 2))])

    def batch(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        a = torch.randint(-2 ** 62, 2 ** 62, (n,), device="cuda",
                          generator=g)
        return ColumnarBatch([
            DeviceColumn(T.LONG, a > 0, data=a),
            DeviceColumn(sch.fields[1].dataType, a % 3 != 0,
                         data=torch.stack([a, a * 7], 1))], n, sch)

    nbytes = batch(0).nbytes()
    fw = SpillFramework(pool_bytes=nbytes, host_limit=nbytes,
                        spill_dir=str(tmp_path))
    hs = [fw.track(batch(i)) for i in range(3)]
    assert [h.state for h in hs] == ["DISK", "HOST", "DEVICE"]
    assert all(t.is_pinned() for e in hs[1]._host for t in e.values())
    for i, h in enumerate(hs):
        got, want = h.get_batch(), batch(i)
        assert got.device.type == "cuda"
        for gc, wc in zip(got.columns, want.columns):
            assert torch.equal(gc.data, wc.data)
            assert torch.equal(gc.validity, wc.validity)
    assert fw.spill_to_disk_count >= 1 and fw.spill_to_host_count >= 2
    for h in hs:
        h.close()
    assert fw.device_used == 0


@pytest.mark.gpu
def test_with_retry_recovers_from_a_real_cuda_oom():
    """An allocation larger than the card raises torch.cuda.
    OutOfMemoryError inside the retry block: the block spills, empties the
    allocator's cache and splits the input until the halves fit."""
    _need_gpu()
    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.memory.retry import with_retry
    from spark_rapids_tpu_torch.memory.spill import SpillFramework
    import spark_rapids_tpu_torch.memory.spill as SP

    total = torch.cuda.get_device_properties(0).total_memory
    n = 1024
    sch = T.StructType([T.StructField("a", T.LONG)])
    b = ColumnarBatch([DeviceColumn(
        T.LONG, torch.ones(n, dtype=torch.bool, device="cuda"),
        data=torch.arange(n, device="cuda"))], n, sch)
    fw = SpillFramework(pool_bytes=1 << 30, host_limit=1 << 30,
                        spill_dir=None)
    SP._framework = fw
    try:
        other = fw.track(b.slice_rows(0, 10))

        def fn(batch):
            # bytes per row such that more than 256 rows do not fit
            per_row = total // 256
            x = torch.empty(batch.num_rows * per_row, dtype=torch.uint8,
                            device="cuda")
            del x
            return batch.columns[0].data.sum().item()

        snap = PC.snapshot()
        got = list(with_retry(fw.track(b), fn, min_split_rows=8))
        assert sum(got) == n * (n - 1) // 2 and len(got) >= 4
        assert PC.since(snap)["oom_retry_splits"] >= 2
        assert other.state == "HOST"
        other.close()
    finally:
        SP.reset_spill_framework()


@pytest.mark.gpu
def test_rung3_ooc_and_sub_partitioned_qb_on_gpu_equal_cpu(tmp_path):
    """bench's rung3_ooc at 500,000 rows under a 1 MiB pool (sized
    exchange, host blocks, spills) and qb from Parquet under a 256 KiB
    batch goal (the sub-partitioned join, 4 buckets for 690,000 built
    bytes), on the card and on the CPU: the rows of the numpy
    references."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    import spark_rapids_tpu_torch.session as S

    n = 500_000
    fact, dim = C.make_ooc(n)
    want = C.ooc_reference(fact, dim)
    conf = C.ooc_conf(1 << 20, n)
    for device in ("cuda", "cpu"):
        q = C.ooc_query(*C.ooc_frames(S, S.TpuSession(conf, device=device),
                                      fact, dim), S)
        assert C.plan_shape(q) == C.ooc_plan(1 << 20, n)
        assert C.ooc_rows(q.collect()) == want
        assert C.ooc_rows(q.collect()) == want
    ss = C.make_store_sales(300_000)
    sr = C.make_store_returns(ss, 30_000)
    ss_paths, _ = C.write_qa_files(ss, C.make_date_dim(), len(ss["ticket"]),
                                   str(tmp_path), "cuda")
    sr_paths = C.write_returns_files(sr, str(tmp_path), "cuda")
    ssch, rsch = C.qb_schemas(T)
    wq = C.qb_reference(ss, sr)
    for device in ("cuda", "cpu"):
        conf = dict(C.ooc_qb_conf(1 << 20),
                    **{"spark.rapids.sql.batchSizeBytes": "256k"})
        s = S.TpuSession(conf, device=device)
        q = C.qb_query(s.read.schema(ssch).parquet(*ss_paths),
                       s.read.schema(rsch).parquet(*sr_paths), S)
        assert sorted(q.collect()) == wq
        assert q._planned().children[0].sub_partitions == 4


@pytest.mark.gpu
def test_rung3_on_gpu_equals_cpu():
    """bench's rung3 at 400,000 rows, on the card and on the CPU: the
    reference's plans; the aggregate over the CPU stage equal to numpy;
    the out-of-core sort (a 1 MiB goal, a 4 MiB pool so that runs spill)
    counting every row, its sorted rows the input's, with more than one
    merge window read from the host tier."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.memory.spill import peek_spill_framework

    n = 400_000
    d = C.make_rung3(n)
    want = C.rung3_reference(d)
    conf = dict(C.rung3_conf(n), **{
        "spark.rapids.sql.batchSizeBytes": 1 << 20,
        "spark.rapids.tpu.test.deviceMemoryBytes": 4 << 20})
    for device in ("cuda", "cpu"):
        agg, srt = C.rung3_frames(S, S.TpuSession(conf, device=device), d)
        assert C.plan_shape(agg) == C.RUNG3_AGG_PLAN
        count_q = C.rung3_count_query(srt)
        assert C.plan_shape(count_q) == C.RUNG3_SORT_PLAN
        assert C.rung3_rows(agg.collect_host()) == want
        PC.reset_peaks()
        snap = PC.snapshot()
        assert count_q.collect() == [(n,)]
        delta = PC.since(snap)
        assert delta["ooc_sort_merge_windows"] > 1
        assert delta["ooc_sort_merge_upload_bytes"] > 0
        most = PC.peaks()["ooc_sort_merge_window_upload_bytes"]
        chunk_rows = count_q._planned().children[0].ooc_chunk_rows
        assert 0 < most <= (delta["ooc_sort_runs"] * chunk_rows
                            * C.RUNG3_SORT_ROW_BYTES)
        assert peek_spill_framework().spill_to_host_count > 0
        assert C.rung3_sort_check(srt.collect_host(), d) is None


@pytest.mark.gpu
def test_rung4_dist_on_gpu_equals_cpu():
    """bench's rung4_dist at 200,000 rows over two worker processes, on the
    card and on the CPU, ``bench0`` SIGKILLed at the 5th shipped block
    each time: the rows of ``cpu_dist``, a worker lost, partitions
    replayed; on the card no worker maps CUDA or torch."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import distributed as D
    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.distributed import client as DC
    from spark_rapids_tpu_torch.resilience.breaker import reset_breaker

    n = C.DIST_BENCH_ROWS
    fact, dim = C.make_dist(n)
    want = C.dist_reference(fact, dim)
    conf = C.dist_conf(n)
    for device in ("cuda", "cpu"):
        reset_breaker()
        D.reset_coordinator()
        coord = D.get_coordinator(TpuConf(conf))
        procs = {w: D.spawn_local_worker(coord, w,
                                         mem_bytes=C.dist_worker_mem(n))
                 for w in C.DIST_WORKERS}
        try:
            assert coord.wait_for_workers(2, timeout_s=C.DIST_JOIN_S)
            q = C.ooc_query(*C.ooc_frames(
                S, S.TpuSession(conf, device=device), fact, dim), S)
            assert C.plan_shape(q) == C.DIST_PLAN
            shipped = {"n": 0}

            def hook(exch, pid, seq):
                shipped["n"] += 1
                if shipped["n"] == C.DIST_KILL_AT:
                    procs["bench0"].kill()

            snap = PC.snapshot()
            DC.TEST_SHIP_HOOK = hook
            try:
                assert C.ooc_rows(q.collect()) == want
            finally:
                DC.TEST_SHIP_HOOK = None
            d = PC.since(snap)
            assert d["worker_lost"] == 1 and d["partitions_replayed"] >= 1
            assert C.ooc_rows(q.collect()) == want
            with open(f"/proc/{procs['bench1'].pid}/maps") as f:
                maps = f.read()
            assert "libcuda" not in maps and "libtorch" not in maps
        finally:
            C.stop_dist_workers(procs.values())
            D.reset_coordinator()


@pytest.mark.gpu
def test_rung5_recovery_on_gpu_equals_cpu():
    """bench's rung5_recovery at 200,000 rows on the card and on the CPU
    (``chip_smoke.run_rung5`` holds every collect to numpy, the plan to the
    reference's, and the kill at the first stage commit to a resume that
    serves it, with no leak and an empty recovery dir after the purge)."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C

    for device in ("cuda", "cpu"):
        r = C.run_rung5(C.REC_BENCH_ROWS, torch.device(device), "card test",
                        f"rung5_recovery {device}")
        assert r["delta"]["stages_recovered"] >= 1
        assert r["delta"]["queries_resumed"] >= 1
        assert r["launches"] == 0


@pytest.mark.gpu
def test_driver_kill_on_gpu():
    """A driver incarnation on the card SIGKILLed at its first stage
    commit; the next one, on the card, serves the committed stage from the
    re-attached workers, exact, with nothing left on them and no worker
    holding the card (``chip_smoke.run_driver_kill``)."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C

    torch.cuda.empty_cache()
    (res,) = C.run_driver_kill([("ckpt:1", C.DK_BENCH_ROWS,
                                 C.DK_WORKER_MEM)], "cuda", "card test",
                               "driver kill card test")
    assert res["result"]["counters"]["stages_recovered"] >= 1
    assert res["result"]["stranded_blocks"] == 0


@pytest.mark.gpu
def test_q6_hot_cache_on_gpu(tmp_path):
    """Q6 over four snappy files with the hot-table cache on the card: the
    miss decodes with K1 (one launch per column chunk), the hit launches
    nothing and uploads nothing, both exact; ``close`` leaves no handle."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C

    n = 200_000
    li = C.lineitem_q6(n, n / (C.SF10_ROWS / 10), 5)
    paths = C.write_files(li, n, str(tmp_path), torch.device("cuda"),
                          n_files=4)
    r = C.run_q6_hot(paths, C.q6_reference(li), "q6_parquet_hot card test",
                     torch.device("cuda"), "card test")
    (_, d1, l1), (_, d2, l2) = r["first"], r["second"]
    assert d1["hot_cache_misses"] == 1 and l1 == 16 and d1["bytes_h2d"] > 0
    assert d2["hot_cache_hits"] == 1 and l2 == 0 and d2["bytes_h2d"] == 0


@pytest.mark.gpu
def test_k1_on_width3_index_pages_matches_plain():
    """The index pages of a 5- or 7-value dictionary (l_shipmode,
    o_orderpriority): width 3, Spark-shaped 20,000-value pages in one
    launch."""
    _need_gpu()
    rng = np.random.default_rng(33)
    pb = page_batch(rng, [("spark", 3, 20_000)] * 6 + [("cut", 3, 7_001)])
    dev = torch.from_numpy(np.frombuffer(pb["buf"], np.uint8).copy()).cuda()
    table = torch.from_numpy(pb["table"]).cuda()
    before = decode.unpack_launches
    got = decode.unpack_runs(dev, 0, table, pb["total"])
    assert decode.unpack_launches == before + 1
    want = decode.unpack_runs_plain(dev, 0, table, pb["total"])
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.max()) < 8


@pytest.mark.gpu
def test_q12_on_gpu_equals_numpy(tmp_path):
    """TPC-H Q12 at test size on the card, from chip_smoke.py's files
    (dictionary strings, K1 once a dictionary chunk), from memory under
    phase 20's conf with a small pool, and the PLAIN-string file."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    import spark_rapids_tpu_torch.session as S

    orders, lineitem = C.make_q12(50_000, 5)
    want = C.q12_reference(orders, lineitem)
    dev = torch.device("cuda")
    o_paths, l_paths, plain = C.write_q12_files(
        orders, lineitem, str(tmp_path / "q12"), dev, n_files=2)
    _, _, ors, lrs = C.q12_schemas(T)
    s = S.TpuSession(C.Q12_CONF, device=dev)
    q = C.q12_query(s.read.schema(ors).parquet(*o_paths),
                    s.read.schema(lrs).parquet(*l_paths), S)
    decode.unpack_launches = 0
    assert q.collect() == want
    assert decode.unpack_launches == C.dict_chunks(
        o_paths, ors) + C.dict_chunks(l_paths, lrs)
    C.read_q12_plain(plain, orders, dev, "gpu")
    n = len(lineitem["l_orderkey"])
    conf = dict(C.ooc_conf(1 << 19, n), **{
        "spark.rapids.tpu.exchange.deviceResidentBytes": 1 << 16})
    mem = S.TpuSession(conf, device=dev)

    def frame(table, sch):
        from spark_rapids_tpu_torch.plan.nodes import LocalTableScan
        return S.DataFrame(LocalTableScan(C.q12_host_columns(
            table, sch, 0, len(table[sch.fields[0].name])), sch), mem)

    assert C.q12_query(frame(orders, ors), frame(lineitem, lrs),
                       S).collect() == want
    assert mem.close() == []


@pytest.mark.gpu
def test_join_types_and_new_aggregates_on_gpu_equal_cpu():
    """Left semi, left anti, right and full outer joins (broadcast,
    adaptive shuffled, sub-partitioned; an int and a string key, nulls
    on both sides) and the aggregates beyond sum, count, min and max
    (grouped and global, over several batches) on the card against the same queries on the CPU
    (held against the JAX package in test_torch_join_types.py and
    test_torch_agg_breadth.py).  Doubles to a relative 1e-9: the card
    adds floats in its own order, so a 12-digit rounding may flip."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.columnar.column import HostColumn as H
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    rng = np.random.default_rng(31)
    # a key's strings as selective as the int key: about one match a row
    words = np.array([f"key-{i}" + "z" * (i % 30) for i in range(4000)],
                     object)
    n, m = 20_000, 3_000

    def strings(vals, valid):
        return H.strings(list(vals), valid)

    psch = T.StructType([T.StructField("k", T.INT),
                         T.StructField("s", T.STRING),
                         T.StructField("v", T.DecimalType(12, 2)),
                         T.StructField("d", T.DOUBLE),
                         T.StructField("b", T.BOOLEAN)])
    bsch = T.StructType([T.StructField("k", T.INT),
                         T.StructField("s", T.STRING),
                         T.StructField("w", T.LONG)])
    pcols = [H.from_numpy(rng.integers(0, 3000, n).astype(np.int32), T.INT,
                          rng.random(n) > 0.05),
             strings(words[rng.integers(0, 3000, n)], rng.random(n) > 0.05),
             H.from_numpy(rng.integers(-10 ** 11, 10 ** 11, n),
                          T.DecimalType(12, 2), rng.random(n) > 0.1),
             H.from_numpy(rng.normal(0, 100, n), T.DOUBLE,
                          rng.random(n) > 0.1),
             H.from_numpy(rng.random(n) > 0.5, T.BOOLEAN,
                          rng.random(n) > 0.1)]
    bcols = [H.from_numpy(rng.integers(0, 4000, m).astype(np.int32), T.INT,
                          rng.random(m) > 0.05),
             strings(words[rng.integers(0, 4000, m)], rng.random(m) > 0.05),
             H.from_numpy(rng.integers(0, 10 ** 6, m), T.LONG)]

    def norm(rows):
        # rows of an aggregate sort by their unique key, joined rows carry
        # no computed double: the order is the same on both devices
        return sorted(rows, key=repr)

    def same(a, b):
        """Equal, doubles to a relative 1e-9 (NaN equal to NaN)."""
        return len(a) == len(b) and all(
            len(ra) == len(rb) and all(
                math.isclose(x, y, rel_tol=1e-9, abs_tol=1e-12)
                or (x != x and y != y)
                if isinstance(x, float) and isinstance(y, float) else x == y
                for x, y in zip(ra, rb))
            for ra, rb in zip(a, b))

    confs = [{}, {"spark.sql.autoBroadcastJoinThreshold": "-1"},
             {"spark.rapids.sql.batchSizeBytes": "8k",
              "spark.rapids.sql.reader.batchSizeRows": 4000}]
    out = {}
    for dev in ("cuda", "cpu"):
        res = []
        for conf in confs:
            s = S.TpuSession(conf, device=dev)
            left = S.DataFrame(LocalTableScan(pcols, psch), s)
            right = S.DataFrame(LocalTableScan(bcols, bsch), s)
            for how in ("left_semi", "left_anti", "right", "full"):
                for key in ("k", "s"):
                    res.append(norm(left.join(right, on=key,
                                              how=how).collect()))
            for keys in (["k"], []):
                res.append(norm(left.group_by(*keys).agg(
                    S.avg_("v", "av"), S.avg_("d", "ad"),
                    S.variance_("v", "vv"), S.stddev_pop_("d", "sd"),
                    S.count_if_("b", "ci"), S.bool_and_("b", "ba"),
                    S.bit_xor_("k", "bx"), S.bit_and_("k", "bn"),
                    ("first", "s", "fs"), ("last", "v", "lv")).collect()))
        out[dev] = res
    assert all(same(a, b) for a, b in zip(out["cuda"], out["cpu"]))


@pytest.mark.gpu
def test_q4_and_q1_on_gpu_equal_numpy(tmp_path):
    """TPC-H Q4 and its twins from phase 19's kind of files, and Q1 from
    phase 23's, at test size on the card: exact against numpy, K1 once a
    dictionary chunk, K1 equal to its plain version on Q1's width-1 and
    width-2 string index tables."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C

    dev = torch.device("cuda")
    orders, lineitem = C.make_q12(20_000, 5)
    o_paths, l_paths, _ = C.write_q12_files(
        orders, lineitem, str(tmp_path / "q4"), dev, n_files=2)
    ors, lrs = C.q4_schemas(T)
    for how in ("left_semi", "left_anti", "right", "full"):
        q = C._q4_files_query(o_paths, l_paths, how, C.Q12_CONF, dev)
        decode.unpack_launches = 0
        assert q.collect() == C.q4_reference(orders, lineitem, how)
        assert decode.unpack_launches == C.dict_chunks(
            o_paths, ors) + C.dict_chunks(l_paths, lrs)
    li = C.lineitem_q1(50_000, 10 * 50_000 / C.SF10_ROWS, 9)
    paths = C.write_q1_files(li, str(tmp_path / "q1"), dev, n_files=2)
    err, widths = C.check_string_k1(paths[:1], lambda p: C.q1_schema(T),
                                    dev, "gpu", "Q1")
    assert err == 0 and widths == [1, 2]
    import spark_rapids_tpu_torch.session as S
    q = C.q1_query(S.TpuSession(C.Q12_CONF, device=dev).read.schema(
        C.q1_schema(T)).parquet(*paths), S)
    decode.unpack_launches = 0
    assert q.collect() == C.q1_reference(li)
    assert decode.unpack_launches == C.dict_chunks(paths, C.q1_schema(T))


def _nl_sides(s, n_left=2000, n_right=1000):
    """Two tables for the nested-loop and cross joins: an int, a string and
    a decimal a side, nulls in the latter two; ``a = b`` matches about one
    right row in two thousand."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    rng = np.random.default_rng(43)
    words = np.array([f"w{i}" * (i % 5 + 1) for i in range(50)], object)

    def table(n, names):
        sch = T.StructType([T.StructField(names[0], T.INT),
                            T.StructField(names[1], T.STRING),
                            T.StructField(names[2], T.DecimalType(12, 2))])
        cols = [HostColumn.from_numpy(
                    rng.integers(0, 2000, n).astype(np.int32), T.INT),
                HostColumn.strings(list(words[rng.integers(0, 50, n)]),
                                   rng.random(n) > 0.1),
                HostColumn.from_numpy(rng.integers(-10 ** 9, 10 ** 9, n),
                                      T.DecimalType(12, 2),
                                      rng.random(n) > 0.1)]
        return S.DataFrame(LocalTableScan(cols, sch), s)

    return table(n_left, ["a", "s", "d"]), table(n_right, ["b", "t", "e"])


@pytest.mark.gpu
def test_nested_loop_and_cartesian_joins_on_gpu_equal_cpu():
    """The nested-loop join (inner, left outer, semi, anti) and the cross
    join under a filter on the card against the same queries on the CPU,
    at 2,000 x 1,000 = 2 M pairs, so each left batch takes two chunks of
    at most 2^20 pairs; the condition keeps about a thousand pairs, so
    thousands of rows are compared, not millions."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S

    out = {}
    for dev in ("cuda", "cpu"):
        s = S.TpuSession({}, device=dev)
        left, right = _nl_sides(s)
        cond = S.col("a").eq(S.col("b")) & (S.col("d") > S.col("e"))
        res = [sorted(left.join(right, cond, how).collect(), key=repr)
               for how in ("inner", "left", "left_semi", "left_anti")]
        q = left.cross_join(right).filter(cond)
        assert "TpuCartesianProductExec" in q.explain()
        res.append(sorted(q.collect(), key=repr))
        out[dev] = res
    assert out["cuda"] == out["cpu"]
    assert 200 < len(out["cuda"][0]) < 5000


@pytest.mark.gpu
def test_residual_condition_sub_partitioned_on_gpu_equals_cpu():
    """An inner equi-join with a residual condition on the sub-partitioned
    route (the built side over an 8 KiB goal) on the card against the
    CPU: the same rows, at least two buckets on both."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.plan import nodes as PN

    conf = {"spark.rapids.sql.batchSizeBytes": "8k",
            "spark.rapids.sql.reader.batchSizeRows": 500}
    out = {}
    for dev in ("cuda", "cpu"):
        s = S.TpuSession(conf, device=dev)
        left, right = _nl_sides(s, 20_000, 3_000)
        node = PN.SortMergeJoin(left.plan, right.plan,
                                [S.col("a").resolve(left.schema)],
                                [S.col("b").resolve(right.schema)],
                                PN.JoinType.INNER)
        df = S.DataFrame(node, s)
        node.condition = (S.col("d") > S.col("e")).resolve(df.schema)
        out[dev] = sorted(df.collect(), key=repr)
        assert df._planned().sub_partitions >= 2
    assert out["cuda"] == out["cpu"]
    assert 5000 < len(out["cuda"]) < 30_000


@pytest.mark.gpu
def test_q11_q15_q16_on_gpu_equal_numpy(tmp_path):
    """TPC-H Q11 (both forms), Q15 and q16_nolike from phases 24-26's kind
    of files at test size on the card: exact against numpy, K1 once a
    dictionary chunk of each scan."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    import spark_rapids_tpu_torch.session as S

    dev = torch.device("cuda")
    scale = 0.01
    tables, values = C.make_tpch_parts(scale, 5)
    li = C.lineitem_q15(int(round(C.SF10_ROWS * scale / 10)), scale, 6)
    paths = C.write_tpch_tables(tables, values, li, str(tmp_path), dev,
                                n_files=2)
    fraction = C.q11_fraction(1)
    for how in ("inner", "cross"):
        f = C.tpch_frames(paths, S.TpuSession(C.Q12_CONF, device=dev),
                          C.Q11_READS)
        decode.unpack_launches = 0
        rows = C.q11_query(f["partsupp"], f["supplier"], f["nation"], S,
                           fraction, how).collect()
        assert C.q11_check(rows, C.q11_reference(tables, fraction)) is None
        assert decode.unpack_launches == 2 * C.tpch_chunks(paths,
                                                           C.Q11_READS)
    f = C.tpch_frames(paths, S.TpuSession(C.Q12_CONF, device=dev),
                      C.Q15_READS)
    assert C.q15_query(f["lineitem"], f["supplier"], S).collect() \
        == C.q15_reference(li, tables, values)
    f = C.tpch_frames(paths, S.TpuSession(C.Q12_CONF, device=dev),
                      C.Q16_READS)
    decode.unpack_launches = 0
    assert C.q16_query(f["partsupp"], f["part"], S).collect() \
        == C.q16_reference(tables)
    assert decode.unpack_launches == C.tpch_chunks(paths, C.Q16_READS)


@pytest.mark.gpu
@pytest.mark.parametrize("width", (8, 32, 128, 512, 2048))
def test_string_functions_on_gpu_equal_cpu(width):
    """Every string case of ``torch_port_text`` (the DFA with an inner
    ``%`` and with ``_`` among them) on the card equals its CPU run, over
    3,000 seeded rows of ASCII, multibyte UTF-8, empty and null strings in
    each width bucket."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from torch_port_frames import frame
    from torch_port_text import (STRING_CASES, select_cases, string_schema,
                                 string_table)

    arrays, validity = string_table(40 + width, width, n=3000)
    rows = {dev: select_cases(S, frame(S, TpuSession({}, device=dev), arrays,
                                       string_schema(T), validity),
                              STRING_CASES, "expr.strings").collect()
            for dev in ("cuda", "cpu")}
    for i, name in enumerate(STRING_CASES):
        assert [r[i] for r in rows["cuda"]] == [r[i] for r in rows["cpu"]], \
            name


@pytest.mark.gpu
def test_date_functions_on_gpu_equal_cpu():
    """Every date case of ``torch_port_text`` on the card equals its CPU
    run (exact, ``months_between``'s doubles included) over 3,000 seeded
    days with dates before 1970 and year 1000, leap days and month ends;
    the TIMESTAMP cases too, evaluated on columns."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from torch_port_frames import frame
    from torch_port_text import (DATE_CASES, TS_CASES, date_schema,
                                 date_table, eval_cases, select_cases,
                                 timestamp_schema)

    arrays, validity = date_table(41)
    rows = {dev: select_cases(S, frame(S, TpuSession({}, device=dev), arrays,
                                       date_schema(T), validity),
                              DATE_CASES, "expr.datetime").collect()
            for dev in ("cuda", "cpu")}
    for i, name in enumerate(DATE_CASES):
        assert [r[i] for r in rows["cuda"]] == [r[i] for r in rows["cpu"]], \
            name
    ts = {dev: eval_cases(arrays, validity, timestamp_schema(T), TS_CASES,
                          dev) for dev in ("cuda", "cpu")}
    assert ts["cuda"] == ts["cpu"]


@pytest.mark.gpu
def test_q13_q22_q16_q9_on_gpu_equal_numpy(tmp_path):
    """TPC-H Q13, Q22, Q16 in full and Q9 from phases 27-29's kind of
    files at test size on the card: exact against numpy, K1 once a
    dictionary chunk of each scan."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C

    dev = torch.device("cuda")
    scale, seed = 0.01, 9
    tables, values = C.make_tpch_parts(scale, seed)
    pool = C.text_pool(seed + 1, 1 << 20)
    green, complain = C.add_text_columns(tables, scale, seed + 2, pool)
    customer, orders, li9 = C.make_text_tables(scale, seed + 3, pool)
    li = C.lineitem_q15(1000, scale, seed)
    paths = C.write_tpch_tables(tables, values, li, str(tmp_path), dev,
                                n_files=2)
    sch = C.tpch_all_schemas(T)
    for name, table in (("customer", customer), ("orders", orders),
                        ("lineitem9", li9)):
        paths[name] = C.write_tpch_files(name, table, values, sch[name],
                                         str(tmp_path), dev, 2)
    cases = [("q13", C.Q13_READS, None,
              lambda f, S: C.q13_query(f["customer"], f["orders"], S),
              C.q13_reference(customer, orders, pool)[0]),
             ("q22", C.Q22_READS, C.Q22_SCANS,
              lambda f, S: C.q22_query(f["customer"], f["orders"], S),
              C.q22_reference(customer, orders)[0]),
             ("q16", C.Q16_FULL_READS, None,
              lambda f, S: C.q16_full_query(f["partsupp"], f["part"],
                                            f["supplier"], S),
              C.q16_full_reference(tables, complain)),
             ("q9", C.Q9_READS, None,
              lambda f, S: C.q9_query(f["part"], f["supplier"],
                                      f["lineitem9"], f["partsupp"],
                                      f["orders"], f["nation"], S),
              C.q9_reference(tables, green, li9, orders))]
    for name, reads, scans, build, want in cases:
        decode.unpack_launches = 0
        assert C._text_query(paths, reads, build, dev).collect() == want, \
            name
        assert decode.unpack_launches == C.query_chunks(paths, reads, scans)


@pytest.mark.gpu
def test_arith_math_cast_on_gpu_equal_cpu():
    """Every case of ``torch_port_arith`` (division, the rest of
    arithmetic, bitwise and shifts, ``try_*``, the numeric casts, ``<=>``,
    the conditionals, every math function; the 38-digit cases in CPU
    stages) on the card equals its CPU run over the seeded edge-case table:
    exact (doubles bit for bit: +, -, *, /, sqrt and fmod are correctly
    rounded on both), but the transcendental functions, within ``ULPS``
    units in the last place of the CPU's; each ANSI case raises on the
    card."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException
    from torch_port_arith import (ANSI_CASES, DEVICE_CASES, HOST_CASES,
                                  TRANSCENDENTAL_CASES, ULPS, arith_schema,
                                  arith_table, columns, same, select_cases)
    from torch_port_frames import frame

    arrays, validity = arith_table(43, n=3000)
    for cases in (DEVICE_CASES, TRANSCENDENTAL_CASES, HOST_CASES):
        cols = {dev: columns(select_cases(S, frame(
            S, TpuSession({}, device=dev), arrays, arith_schema(T),
            validity), cases).collect(), cases) for dev in ("cuda", "cpu")}
        for name in cases:
            ulps = ULPS if name in TRANSCENDENTAL_CASES else 0
            bad = [(i, a, b) for i, (a, b) in enumerate(
                zip(cols["cuda"][name], cols["cpu"][name]))
                if not same(a, b, ulps)]
            assert not bad, (name, bad[:5])
    for name, build in ANSI_CASES.items():
        with pytest.raises(SparkArithmeticException):
            select_cases(S, frame(S, TpuSession(
                {"spark.sql.ansi.enabled": True}, device="cuda"), arrays,
                arith_schema(T), validity), {name: build}).collect()


@pytest.mark.gpu
def test_q14_q17_q8_on_gpu_equal_numpy(tmp_path):
    """TPC-H Q14, Q17 and Q8 from phases 30-31's kind of files at test
    size on the card: exact against numpy (the final divides in CPU
    stages), K1 once a dictionary chunk of each scan."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C

    dev = torch.device("cuda")
    scale, seed = 0.01, 9
    tables, values = C.make_tpch_parts(scale, seed)
    pool = C.text_pool(seed + 1, 1 << 20)
    C.add_text_columns(tables, scale, seed + 2, pool)
    C.add_arith_columns(tables, values, seed + 4)
    customer, orders, li9 = C.make_text_tables(scale, seed + 3, pool)
    paths = C.write_tpch_tables(tables, values,
                                C.lineitem_q15(1000, scale, seed),
                                str(tmp_path), dev, n_files=2)
    sch = C.tpch_all_schemas(T)
    for name, table in (("customer", customer), ("orders", orders),
                        ("lineitem9", li9)):
        paths[name] = C.write_tpch_files(name, table, values, sch[name],
                                         str(tmp_path), dev, 2)
    want = C.arith_references(tables, customer, orders, li9)
    for name in ("q14", "q17", "q8"):
        reads, scans = C.ARITH_READS[name]
        decode.unpack_launches = 0
        got = C._text_query(paths, reads,
                            lambda f, S: C.arith_query(name, f, S),
                            dev).collect()
        assert got == want[name], name
        assert decode.unpack_launches == C.query_chunks(paths, reads, scans)


@pytest.mark.gpu
def test_window_frames_on_gpu_equal_cpu():
    """Every window function in every frame of ``torch_port_windows``
    (``test_torch_window_frames.py``'s table and cases: RANGE frames over
    int, double and DATE keys both ways, ROWS frames at the 256-row cap,
    strings, decimals above 18 digits) on the card equals its CPU run:
    exact, but doubles within a relative 1e-9 (the card adds floats in
    its own order)."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.plan.nodes import WindowFunction as WF
    from torch_port_windows import CASES, same_rows, window

    for frame, order in CASES:
        got = window(S, WF, T, TpuSession({}, device="cuda"), frame,
                     order).collect()
        want = window(S, WF, T, TpuSession({}, device="cpu"), frame,
                      order).collect()
        assert same_rows(got, want, 1e-9), (frame, order)


@pytest.mark.gpu
def test_stats_aggregates_on_gpu_equal_cpu():
    """skewness, kurtosis, covar_*, corr and the nine regr_* grouped and
    global, on one batch and on several, on the card equal the CPU within
    a relative 1e-9."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from torch_port_windows import same_rows, stats_query

    for conf in ({}, {"spark.rapids.sql.reader.batchSizeRows": 130}):
        for grouped in (True, False):
            got, want = (sorted(stats_query(S, T, TpuSession(
                conf, device=dev), grouped).collect(), key=repr)
                for dev in ("cuda", "cpu"))
            assert same_rows(got, want, 1e-9), (conf, grouped)


def _hash_columns(rng, n=4000):
    """One column of every type xxhash64 takes, nulls included, with its
    numpy twin's (kind, data, validity): -0.0 and NaN among the floats,
    strings of 0..75 bytes (past the 32-byte stripes)."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn

    out = []
    specs = [("int", T.INT, np.int32), ("long", T.LONG, np.int64),
             ("int", T.DATE, np.int32), ("int", T.BYTE, np.int8),
             ("int", T.SHORT, np.int16), ("int", T.BOOLEAN, np.bool_),
             ("long", T.DecimalType(18, 4), np.int64)]
    for kind, dt, npd in specs:
        if npd is np.bool_:
            data = rng.random(n) > 0.5
        else:
            info = np.iinfo(npd)
            data = rng.integers(info.min, info.max, n, dtype=npd,
                                endpoint=True)
        valid = rng.random(n) > 0.1
        out.append(((kind, data, valid), DeviceColumn(
            dt, torch.from_numpy(valid), data=torch.from_numpy(data))))
    for kind, dt, npd in (("float", T.FLOAT, np.float32),
                          ("double", T.DOUBLE, np.float64)):
        data = (rng.standard_normal(n) * 1e3).astype(npd)
        data[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
        valid = rng.random(n) > 0.1
        out.append(((kind, data, valid), DeviceColumn(
            dt, torch.from_numpy(valid), data=torch.from_numpy(data))))
    words = ["".join(chr(c) for c in rng.integers(32, 127, k))
             for k in rng.integers(0, 76, n)]
    h = HostColumn.from_pylist(words, T.STRING).bucketed()
    valid = rng.random(n) > 0.1
    out.append((("string", (h.chars, h.lengths), valid), DeviceColumn(
        T.STRING, torch.from_numpy(valid), chars=torch.from_numpy(h.chars),
        lengths=torch.from_numpy(h.lengths))))
    return out


def _cuda(c):
    return c.map_rows(lambda t: t.cuda())


@pytest.mark.gpu
def test_xxhash64_on_gpu_equals_numpy_twin():
    """xxhash64 of every type it takes, alone and chained, seed 42 and
    another, on the card equals the numpy uint64 twin of
    ``chip_smoke.py`` bit for bit; so does the Hive hash's card run its
    CPU run."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from spark_rapids_tpu_torch.ops import hashing as H

    cols = _hash_columns(np.random.default_rng(61))
    for twin, col in cols:
        for seed in (42, 7):
            got = H.xxhash64_columns([_cuda(col)], seed=seed).cpu().numpy()
            np.testing.assert_array_equal(got, C.np_xxhash64([twin], seed),
                                          err_msg=f"{col.dtype} {seed}")
    got = H.xxhash64_columns([_cuda(c) for _, c in cols]).cpu().numpy()
    np.testing.assert_array_equal(got, C.np_xxhash64([t for t, _ in cols]))
    hive = [c for (kind, _, _), c in cols if kind != "long"
            or c.dtype == T.LONG]
    assert torch.equal(H.hive_hash_columns([_cuda(c) for c in hive]).cpu(),
                       H.hive_hash_columns(hive))


@pytest.mark.gpu
def test_hll_registers_and_bloom_words_on_gpu_equal_numpy():
    """The card's HLL registers (per group, ints and longs), its
    estimates, a bloom filter's words and its probe equal the numpy twins
    of ``chip_smoke.py``."""
    _need_gpu()
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.exec import aggregate as A
    from spark_rapids_tpu_torch.expr.hashexprs import BloomFilterMightContain
    from spark_rapids_tpu_torch.plan.nodes import AggregateExpression

    rng = np.random.default_rng(62)
    n, ng = 300_000, 7
    group = np.sort(rng.integers(0, ng, n))
    seg = torch.from_numpy(group).cuda()
    mask = torch.ones(n, dtype=torch.bool, device="cuda")
    g = A._Groups(torch.arange(n, device="cuda"), seg, ng, mask, None)
    for kind, dt, data in (("long", T.LONG, rng.integers(0, n, n)),
                           ("int", T.INT, rng.integers(-5000, 5000, n)
                            .astype(np.int32))):
        valid = rng.random(n) > 0.05
        c = DeviceColumn(dt, torch.from_numpy(valid).cuda(),
                         data=torch.from_numpy(data).cuda())
        regs = A._hll_registers(c, c.validity, g).data[:ng].cpu().numpy()
        h = C.np_xxhash64([(kind, data[valid], np.ones(valid.sum(), bool))])
        want = C.np_hll_registers(*C.np_hll_slots(h), group[valid], ng)
        np.testing.assert_array_equal(regs, want)
        np.testing.assert_array_equal(
            A._hll_estimate(torch.from_numpy(regs).cuda()).cpu().numpy(),
            C.np_hll_estimate(want))
    keys = rng.integers(-2 ** 62, 2 ** 62, 50_000)
    items, bits = 50_000, 1 << 20
    c = DeviceColumn(T.LONG, torch.ones(len(keys), dtype=torch.bool,
                                        device="cuda"),
                     data=torch.from_numpy(keys).cuda())
    g1 = A._Groups(None, torch.zeros(len(keys), dtype=torch.int64,
                                     device="cuda"), 1, c.validity, None)
    agg = AggregateExpression("bloom_filter_agg", None, "bf",
                              args=(items, bits))
    words = A._bloom_filter(agg, T.ArrayType(T.LONG, False), c, c.validity,
                            g1)
    ones = np.ones(len(keys), bool)
    h1 = C.np_xxhash64([("long", keys, ones)])
    h2 = C.np_xxhash64([("long", keys, ones)], 77)
    want = C.np_bloom_words(h1, h2, items, bits)
    np.testing.assert_array_equal(words.data[0].cpu().numpy(), want)
    probe = rng.integers(-2 ** 62, 2 ** 62, 100_000)
    probe[:1000] = keys[:1000]
    pc = DeviceColumn(T.LONG, torch.ones(len(probe), dtype=torch.bool,
                                         device="cuda"),
                      data=torch.from_numpy(probe).cuda())
    spread = words.map_rows(lambda t: t[:1].expand(len(probe),
                                                   *t.shape[1:]))
    mc = BloomFilterMightContain(None, None, items, bits).do_columnar_eval(
        None, [spread, pc])
    ones = np.ones(len(probe), bool)
    np.testing.assert_array_equal(mc.data.cpu().numpy(), C.np_might_contain(
        want, C.np_xxhash64([("long", probe, ones)]),
        C.np_xxhash64([("long", probe, ones)], 77), items, bits))
    assert mc.data[:1000].all()


@pytest.mark.gpu
def test_single_phase_aggregates_on_gpu_equal_cpu():
    """collect, percentile, HLL, the bloom filter and string min/max
    (``test_torch_single_phase_aggs.py``'s families), grouped and global,
    in one batch and in several, on the card equal their CPU run exactly
    (no float is added; a list keeps its arrival order, the sort being
    stable)."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from torch_port_aggs import BATCHES, FAMILIES, query
    from torch_port_frames import rows_key

    for family in FAMILIES:
        for conf in BATCHES.values():
            for grouped in (True, False):
                got, want = (query(S, T, TpuSession(conf, device=dev),
                                   family, grouped).collect()
                             for dev in ("cuda", "cpu"))
                assert rows_key(got) == rows_key(want), (family, conf,
                                                         grouped)


def _engine_table(s, n: int, seed: int):
    """A table for the CPU engine's card tests: int keys with nulls,
    strings, a decimal(22,2), doubles with NaN."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    d = rng.normal(0, 50, n)
    d[rng.random(n) < 0.05] = np.nan
    cols = {"k": [int(v) if ok else None for v, ok in
                  zip(rng.integers(0, 40, n), valid)],
            "s": [["", "a", "ab", "b", "zz"][v]
                  for v in rng.integers(0, 5, n)],
            "i": [int(v) for v in rng.integers(-10 ** 6, 10 ** 6, n)],
            "w": [Decimal(int(v)).scaleb(-2) if ok else None for v, ok in
                  zip(rng.integers(-10 ** 18, 10 ** 18, n), valid[::-1])],
            "d": [float(v) for v in d],
            "t": [f"{v:.3f}" for v in rng.normal(0, 9, n)]}
    sch = T.StructType([T.StructField("k", T.INT),
                        T.StructField("s", T.STRING),
                        T.StructField("i", T.INT),
                        T.StructField("w", T.DecimalType(22, 2)),
                        T.StructField("d", T.DOUBLE),
                        T.StructField("t", T.STRING)])
    return s.create_dataframe(cols, sch)


def _engine_queries(s):
    """name -> a query whose CPU stages read device subtrees."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.plan import nodes as PN

    left = _engine_table(s, 3000, 1)
    right = _engine_table(s, 2000, 2).select(
        S.col("k").alias("k2"), S.col("i").alias("j"), S.col("s").alias("s2"))
    out = {}
    for how in ("LEFT_SEMI", "LEFT_ANTI", "LEFT_OUTER", "RIGHT_OUTER",
                "FULL_OUTER"):
        j = PN.SortMergeJoin(left.plan, right.plan,
                             [S.col("k").resolve(left.schema)],
                             [S.col("k2").resolve(right.schema)],
                             getattr(PN.JoinType, how))
        j.condition = (S.col("i") > S.col("j")).resolve(T.StructType(
            list(left.schema.fields) + list(right.schema.fields)))
        out[how] = S.DataFrame(j, s)
    out["sort"] = left.order_by("s", "d", "k", ascending=[False, True, True])
    out["avg128"] = left.group_by("s").agg(S.avg_("w", "a"),
                                           S.variance_("w", "v"),
                                           S.sum_("w", "t"))
    out["rows300"] = left.window(
        [PN.WindowFunction(f, S.col(c), f"x{f}")
         for f, c in (("sum", "i"), ("min", "d"), ("max", "s"),
                      ("avg", "w"))], partition_by=["k"],
        order_by=[S.col("i")], frame=("rows", 150, 149))
    out["avg_string"] = left.group_by("k").agg(S.avg_("t", "a"),
                                               S.var_pop_("t", "v"))
    return out


@pytest.mark.gpu
def test_cpu_engine_nodes_on_gpu_equal_cpu():
    """The CPU engine's hash joins with a residual condition (semi, anti,
    left, right and full outer), a disabled sort, a decimal128 ``avg``, a
    window frame 300 rows wide and ``avg`` of a string, over device
    subtrees on the card, equal the same plans run on the CPU (doubles
    to 12 digits: the card adds the subtrees' doubles in its order)."""
    _need_gpu()
    from torch_port_frames import rows_key

    conf = {"spark.rapids.sql.exec.Sort": "false"}
    got = _engine_queries(TpuSession(conf, device="cuda"))
    want = _engine_queries(TpuSession(conf, device="cpu"))
    for name, q in got.items():
        g, w = q.collect(), want[name].collect()
        assert len(g) >= 5, name
        ordered = name == "sort"
        assert rows_key(g, approx_float=True, ordered=ordered) == rows_key(
            w, approx_float=True, ordered=ordered), name
    # O5: the avg of a string on the card, the oracle's 2.0
    s = TpuSession({}, device="cuda")
    df = s.create_dataframe({"t": ["1.5", "2.5", None]},
                            T.StructType([T.StructField("t", T.STRING)]))
    from spark_rapids_tpu_torch.session import avg_
    assert df.agg(avg_("t", "a")).collect() == [(2.0,)]


@pytest.mark.gpu
def test_timestamps_and_string_casts_on_gpu_equal_cpu():
    """Every case of ``torch_port_times`` (the date and time functions of
    slice 17, every string cast) on the card equals its CPU run over the
    seeded table, exactly; with ANSI on, the clean table's rows equal
    the CPU's and the full table raises; each shape the reference tags
    off runs as a CPU stage under the card's plan with the CPU's rows."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.expr.base import SparkArithmeticException
    from torch_port_frames import frame
    from torch_port_times import (ANSI_CASES, CASES, TAGGED_CONF, TAGGED_OFF,
                                  columns, same, select_cases, times_schema,
                                  times_table)

    def run(cases, dev, conf=None, clean=False):
        arrays, validity = times_table(29, n=2000, clean=clean)
        return columns(select_cases(S, frame(
            S, TpuSession(conf or {}, device=dev), arrays, times_schema(T),
            validity), cases).collect(), cases)

    ansi = {"spark.sql.ansi.enabled": True}
    ansi_cases = {n: CASES[n] for n in ANSI_CASES}
    for cases, conf, clean in ((CASES, {}, False), (ansi_cases, ansi, True)):
        got, want = (run(cases, d, conf, clean) for d in ("cuda", "cpu"))
        for name in cases:
            bad = [(i, a, b) for i, (a, b) in enumerate(
                zip(got[name], want[name])) if not same(a, b)]
            assert not bad, (name, bad[:5])
    for name, build in ansi_cases.items():
        with pytest.raises(SparkArithmeticException):
            run({name: build}, "cuda", ansi)
    for name, (build, words) in TAGGED_OFF.items():
        conf = TAGGED_CONF.get(name, {})
        got, want = (run({name: build}, d, conf)[name]
                     for d in ("cuda", "cpu"))
        assert all(same(a, b) for a, b in zip(got, want)), name


@pytest.mark.gpu
def test_clickbench_queries_on_gpu_equal_numpy():
    """Phase 36's queries over 300,000 hits rows from memory on the card:
    Q18 and Q24 against their numpy checks (ties at the tenth row may
    pick any tied group), Q42's rows (LIMIT 1010) equal the CPU's and
    numpy's, the zone query numpy's."""
    _need_gpu()
    import spark_rapids_tpu_torch.session as S
    from torch_port_frames import frame
    sys.path.insert(0, REPO)
    import chip_smoke as C

    hits = C.make_hits(300_000, 5)
    phrases = C.hits_phrases(6)
    arrays = {f.name: (phrases[hits[f.name]] if f.name == "SearchPhrase"
                       else hits[f.name]) for f in C.hits_schema(T).fields}
    refs = C.hits_references(hits, phrases, True)
    checks = C.hits_checks(hits, phrases, refs)
    rows = {}
    for dev in ("cuda", "cpu"):
        df = frame(S, TpuSession({}, device=dev), arrays, C.hits_schema(T))
        rows[dev] = {k: b(df, S).collect() for k, b in C.HITS_QUERIES.items()}
    for label, check in checks.items():
        assert check(rows["cuda"][label]) is None, label
    assert rows["cuda"]["Q42"] == rows["cpu"]["Q42"]
    assert len(rows["cuda"]["Q42"]) == C.Q42_OFFSET + C.Q42_LIMIT

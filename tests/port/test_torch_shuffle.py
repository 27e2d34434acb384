"""The TKU2 wire format (``shuffle/serializer.py``), the spill-backed
partition queues (``shuffle/partition_queues.py``) and the multi-partition
exchange that drives them, against the JAX package: a frame written by the
port decodes with the reference's ``deserialize_concat`` (child process)
to the same rows and one written by the reference decodes with the port's,
for every flat type with nulls and under each codec; a flipped bit raises
``ShuffleCorruption``; the queues' host-boundary blocks as in
``tests/test_out_of_core.py``.  Every comparison is exact."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.memory import spill as SP
from spark_rapids_tpu_torch.shuffle import serializer as SER
from spark_rapids_tpu_torch.shuffle.partition_queues import (
    SpillBackedPartitionQueues)
from torch_port_jaxref import run_jax

FIELDS = [("i", "INT", np.int32), ("l", "LONG", np.int64),
          ("d", "DATE", np.int32), ("b", "BOOLEAN", np.bool_),
          ("f", "DOUBLE", np.float64), ("m", "DecimalType(12, 2)", np.int64),
          ("w", "DecimalType(30, 4)", np.int64)]
CODECS = ["none", "zlib", "lz4"]


def arrays(n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, _, npd in FIELDS:
        if npd is np.bool_:
            data = rng.integers(0, 2, n).astype(np.bool_)
        elif npd is np.float64:
            data = rng.standard_normal(n)
        elif name == "w":
            data = rng.integers(-2 ** 62, 2 ** 62, (n, 2))
        else:
            data = rng.integers(-10 ** 9, 10 ** 9, n).astype(npd)
        out[name] = data
        out[name + "_valid"] = rng.random(n) > 0.2
    return out


def schema():
    return T.StructType([T.StructField(name, eval("T." + t))
                         for name, t, _ in FIELDS])


def port_batch(a, n):
    return ColumnarBatch([
        DeviceColumn(f.dataType, torch.from_numpy(a[f.name + "_valid"]),
                     data=torch.from_numpy(a[f.name]))
        for f in schema().fields], n, schema())


def assert_batch_equals(batch, a, n):
    assert batch.num_rows == n
    for f, c in zip(schema().fields, batch.columns):
        np.testing.assert_array_equal(c.validity.numpy(), a[f.name + "_valid"])
        np.testing.assert_array_equal(c.data.numpy(), a[f.name])


_REF_SCHEMA = f"""
    import jax.numpy as jnp
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.batch import ColumnarBatch
    from spark_rapids_tpu.columnar.column import DeviceColumn
    from spark_rapids_tpu.shuffle import serializer as SER
    fields = {[(n, t) for n, t, _ in FIELDS]!r}
    sch = T.StructType([T.StructField(n, eval("T." + t)) for n, t in fields])
"""


@pytest.mark.parametrize("codec", CODECS)
def test_frames_decode_across_packages(tmp_path, codec):
    """Port frames (two batches, 37 and 0 rows) through the reference's
    ``deserialize_concat``; a reference frame through the port's."""
    a, b = arrays(37, 1), arrays(53, 2)
    blobs = [SER.serialize_batch(port_batch(a, 37), codec),
             SER.serialize_batch(port_batch(arrays(0, 3), 0), codec)]
    inp = {"blob0": np.frombuffer(blobs[0], np.uint8),
           "blob1": np.frombuffer(blobs[1], np.uint8)}
    inp.update({"b_" + k: v for k, v in b.items()})
    out = run_jax(_REF_SCHEMA + f"""
    got = SER.deserialize_concat(
        [inp["blob0"].tobytes(), inp["blob1"].tobytes()], sch,
        codec={codec!r})
    out["rows"] = np.array(got.num_rows)
    for f, c in zip(sch.fields, got.columns):
        out[f.name] = np.asarray(c.data)[:got.num_rows]
        out[f.name + "_valid"] = np.asarray(c.validity)[:got.num_rows]
    n = len(inp["b_i"])
    mine = ColumnarBatch([
        DeviceColumn(f.dataType, jnp.asarray(inp["b_" + f.name + "_valid"]),
                     data=jnp.asarray(inp["b_" + f.name]))
        for f in sch.fields], n, sch)
    out["ref_blob"] = np.frombuffer(SER.serialize_batch(mine, {codec!r}),
                                    np.uint8)
    """, tmp_path, inp)
    assert int(out["rows"]) == 37
    for name, _, _ in FIELDS:
        np.testing.assert_array_equal(out[name], a[name])
        np.testing.assert_array_equal(out[name + "_valid"],
                                      a[name + "_valid"])
    got = SER.deserialize_concat([out["ref_blob"].tobytes()], schema(),
                                 codec=codec, device="cpu")
    assert_batch_equals(got, b, 53)


@pytest.mark.parametrize("codec", CODECS)
def test_flipped_bit_raises_shuffle_corruption(codec):
    a = arrays(40, 4)
    blob = SER.serialize_batch(port_batch(a, 40), codec)
    ok = SER.deserialize_concat([blob, blob], schema(), codec=codec,
                                device="cpu")
    assert ok.num_rows == 80
    for pos in (0, 6, len(blob) // 2, len(blob) - 1):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        with pytest.raises(SER.ShuffleCorruption):
            SER.deserialize_concat([bytes(bad)], schema(), codec=codec,
                                   device="cpu")


def test_codec_gate():
    """lz4 and zstd go to zstandard where it imports, else to zlib."""
    try:
        import zstandard  # noqa: F401
        want = "zstd"
    except ImportError:
        want = "zlib"
    assert SER.resolved_codec("lz4") == SER.resolved_codec("zstd") == want
    assert SER.resolved_codec(None) == "none"
    with pytest.raises(ValueError):
        SER._codec_pair("snappy")


@pytest.fixture()
def framework():
    SP.reset_spill_framework()
    fw = SP.SpillFramework(pool_bytes=1 << 30, host_limit=1 << 30,
                           spill_dir=None)
    SP._framework = fw
    yield fw
    SP.reset_spill_framework()


def test_partition_queues_host_boundary_blocks(framework):
    """A zero device budget frames every slice across the host boundary;
    reads reassemble losslessly (``tests/test_out_of_core.py:163``)."""
    a1, a2 = arrays(200, 5), arrays(200, 6)
    snap = PC.snapshot()
    q = SpillBackedPartitionQueues(2, schema(), device_budget=0,
                                   codec="none")
    q.append(0, port_batch(a1, 200))
    q.append(0, port_batch(a2, 200))
    assert q.host_blocks == 2
    d = PC.since(snap)
    assert d["exchange_host_blocks"] == 2
    assert d["exchange_host_block_bytes"] == q.host_block_bytes > 0
    out = q.read(0)
    assert q.read(1) is None
    both = {k: np.concatenate([a1[k], a2[k]]) for k in a1}
    assert_batch_equals(out, both, 400)
    q.close()
    assert framework.device_used == 0


def test_partition_queues_crc_bit_flip(framework):
    """A flipped bit in a queued block raises ``ShuffleCorruption``, never
    wrong rows (``tests/test_out_of_core.py:190``)."""
    q = SpillBackedPartitionQueues(1, schema(), device_budget=0,
                                   codec="none")
    q.append(0, port_batch(arrays(200, 7), 200))
    kind, blob = q._queues[0][0]
    assert kind == "host"
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0x40
    q._queues[0][0] = ("host", bytes(bad))
    with pytest.raises(SER.ShuffleCorruption):
        q.read(0)
    q.close()


def test_partition_queues_tiers_and_chunks(framework, tmp_path):
    """Slices stay on the device up to the budget, then host blobs, then
    files past the host budget; the drain comes in chunks of the target
    (by queued bytes), in append order, and releases everything."""
    n = 100
    parts = [arrays(n, 10 + i) for i in range(6)]
    nb = port_batch(parts[0], n).nbytes()
    one_blob = len(SER.serialize_batch(port_batch(parts[2], n), "zlib"))
    q = SpillBackedPartitionQueues(1, schema(), device_budget=2 * nb,
                                   codec="zlib", host_budget=one_blob,
                                   spill_dir=str(tmp_path))
    for a in parts:
        q.append(0, port_batch(a, n))
    kinds = [k for k, _ in q._queues[0]]
    assert kinds == ["dev", "dev", "host", "hostfile", "hostfile",
                     "hostfile"]
    assert q.device_bytes == 2 * nb == framework.device_used
    chunks = list(q.read_chunks(0, target_bytes=2 * nb))
    # entries count their queued bytes (a blob its compressed size)
    assert chunks[0].num_rows == 2 * n and len(chunks) >= 2
    rows = ColumnarBatch.concat(chunks)
    assert_batch_equals(rows, {k: np.concatenate([a[k] for a in parts])
                               for k in parts[0]}, 6 * n)
    assert q.device_bytes == 0 == framework.device_used
    assert list(tmp_path.iterdir()) == []
    q.close()


def test_exchange_streams_through_queues(framework):
    """A multi-partition exchange over a 1-byte device budget: every row
    comes out once, grouped by partition in partition order, and host
    blocks flowed (``tests/test_out_of_core.py``'s last case).  Through
    the shuffle manager (spill disabled, or CACHE_ONLY) the same rows come
    out in the same order."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.exec.basic import TpuLocalTableScanExec
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.expr.base import col
    from spark_rapids_tpu_torch.ops.hashing import spark_partition_ids
    from spark_rapids_tpu_torch.plan.nodes import HashPartitioning

    a = arrays(500, 8)
    sch = schema()
    host = [HostColumn.from_numpy(a[f.name], f.dataType,
                                  a[f.name + "_valid"]) for f in sch.fields]
    scan = TpuLocalTableScanExec(host, sch, torch.device("cpu"),
                                 target_batch_rows=120)
    conf = TpuConf({"spark.rapids.tpu.exchange.deviceResidentBytes": 1,
                    "spark.rapids.sql.batchSizeBytes": 2000})
    keys = [col("i").resolve(sch)]
    ex = TpuShuffleExchangeExec(HashPartitioning(keys, 5), scan, conf=conf)
    snap = PC.snapshot()
    out = list(ex.execute_columnar())
    d = PC.since(snap)
    assert d["exchange_host_blocks"] > 0
    assert d["exchange_partition_ns"] > 0 and d["exchange_spill_ns"] > 0
    assert len(out) > 5                  # partitions drain in chunks
    got = ColumnarBatch.concat(out)
    pids = spark_partition_ids([got.columns[0]], 5)
    assert torch.all(pids[1:] >= pids[:-1])
    assert sorted(got.columns[1].data.tolist()) == sorted(a["l"].tolist())
    assert framework.device_used == 0
    # the shuffle manager (spill disabled, or CACHE_ONLY) gives the same
    # rows in the same order: each partition's map outputs in batch order
    for manager_conf in ({"spark.rapids.tpu.exchange.spill.enabled": False},
                         {"spark.rapids.shuffle.mode": "CACHE_ONLY"}):
        ex = TpuShuffleExchangeExec(HashPartitioning(keys, 5), scan,
                                    conf=TpuConf(manager_conf))
        via = ColumnarBatch.concat(list(ex.execute_columnar()))
        for mine, theirs in zip(via.columns, got.columns):
            assert torch.equal(mine.data, theirs.data)
            assert torch.equal(mine.validity, theirs.validity)

"""The memory runtime (``memory/``) held to the reference's semantics, as
``tests/test_memory.py`` holds the JAX package's: the pool of
``TpuDeviceManager`` equal to the reference's for the same conf; spill
from the device to the host and to disk and back, with LRU victims, the
disk CRC and ``SpillCorruption``; ``with_retry`` under injected retries
and splits, a split exhausted, and a device OOM (``torch.cuda.
OutOfMemoryError``, raised here by the function itself); and
``with_retry_no_split``.  Every comparison is exact."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.config import TpuConf
from spark_rapids_tpu_torch.memory import device_manager as DM
from spark_rapids_tpu_torch.memory import spill as SP
from spark_rapids_tpu_torch.memory.retry import (TpuRetryOOM,
                                                 TpuSplitAndRetryOOM,
                                                 force_retry_oom,
                                                 force_split_and_retry_oom,
                                                 with_retry,
                                                 with_retry_no_split)

SCHEMA = T.StructType([T.StructField("a", T.LONG),
                       T.StructField("m", T.DecimalType(30, 2))])


def _batch(n=1000, start=0):
    """n rows: a = start.., m = 128-bit limbs; 1000 rows are 26,000
    bytes."""
    a = torch.arange(start, start + n, dtype=torch.int64)
    return ColumnarBatch([
        DeviceColumn(T.LONG, torch.ones(n, dtype=torch.bool), data=a),
        DeviceColumn(SCHEMA.fields[1].dataType, a % 3 != 0,
                     data=torch.stack([a, -a], 1))], n, SCHEMA)


@pytest.fixture(autouse=True)
def fresh_frameworks():
    SP.reset_spill_framework()
    DM.reset_device_manager()
    yield
    SP.reset_spill_framework()
    DM.reset_device_manager()
    force_retry_oom(0)
    force_split_and_retry_oom(0)


@pytest.mark.parametrize("conf", [
    {}, {"spark.rapids.tpu.test.deviceMemoryBytes": "48m"},
    {"spark.rapids.memory.gpu.allocFraction": "0.5",
     "spark.rapids.memory.gpu.reserve": "1g"}])
def test_pool_matches_reference(conf):
    """On the CPU both packages size the pool from the override, or from
    the 16 GiB stand-in (the reference's CPU backend reports no memory
    stats)."""
    from spark_rapids_tpu.config import TpuConf as RConf
    from spark_rapids_tpu.memory.device_manager import \
        TpuDeviceManager as RManager

    mine = DM.TpuDeviceManager(TpuConf(conf), device="cpu")
    ref = RManager(RConf(conf))
    assert (mine.pool_bytes, mine.physical_bytes, mine.reserve_bytes) == \
        (ref.pool_bytes, ref.physical_bytes, ref.reserve_bytes)
    assert mine.describe() == ref.describe()


def test_spill_device_to_host_and_back():
    """``tests/test_memory.py:43``: admitting a second batch past the pool
    moves the least recently used one to the host; bringing it back moves
    the other."""
    fw = SP.SpillFramework(pool_bytes=32 << 10, host_limit=1 << 30,
                           spill_dir=None)
    h1 = fw.track(_batch(1000))
    h2 = fw.track(_batch(1000, start=5000))
    assert h1.state == "HOST" and h2.state == "DEVICE"
    snap = PC.snapshot()
    got = h1.get_batch()
    assert got.columns[0].data[:3].tolist() == [0, 1, 2]
    assert torch.equal(got.columns[1].data, _batch(1000).columns[1].data)
    assert torch.equal(got.columns[1].validity,
                       _batch(1000).columns[1].validity)
    assert h1.state == "DEVICE" and h2.state == "HOST"
    assert PC.since(snap)["bytes_h2d"] == 26_000
    assert fw.spill_to_host_count == 2
    assert fw.spill_to_host_bytes == 52_000
    assert fw.device_used_peak == 26_000
    h1.close()
    h2.close()
    assert fw.device_used == 0 and fw.metrics()["deviceUsedBytes"] == 0


def test_spill_to_disk_and_back(tmp_path):
    """``tests/test_memory.py:61``: past the host limit handles go to disk,
    and every one still comes back exact."""
    fw = SP.SpillFramework(pool_bytes=32 << 10, host_limit=16 << 10,
                           spill_dir=str(tmp_path))
    handles = [fw.track(_batch(1000, start=i * 1000)) for i in range(4)]
    assert "DISK" in {h.state for h in handles}
    assert fw.spill_to_disk_count >= 1
    for i, h in enumerate(handles):
        b = h.get_batch()
        assert torch.equal(b.columns[0].data,
                           _batch(1000, start=i * 1000).columns[0].data)
        assert torch.equal(b.columns[1].data,
                           _batch(1000, start=i * 1000).columns[1].data)
        h.close()
    assert list(tmp_path.iterdir()) == []


def test_disk_crc_mismatch_raises(tmp_path):
    """A spill file whose bytes changed on disk raises ``SpillCorruption``
    when it is read back."""
    fw = SP.SpillFramework(pool_bytes=0, host_limit=0,
                           spill_dir=str(tmp_path))
    h = fw.track(_batch(500))
    fw.spill_device_pressure()
    assert h.state == "DISK"
    with np.load(h._disk_path) as z:
        arrays = dict(z)
    arrays["c0_data"][7] += 1
    np.savez(h._disk_path, **arrays)
    with pytest.raises(SP.SpillCorruption, match="CRC mismatch"):
        h.get_batch()
    h.close()


def test_pinned_handles_are_not_victims():
    fw = SP.SpillFramework(pool_bytes=40 << 10, host_limit=1 << 30,
                           spill_dir=None)
    h1 = fw.track(_batch(1000)).pin()
    h2 = fw.track(_batch(1000))
    assert h1.state == "DEVICE" and h2.state == "DEVICE"
    assert fw.device_used_peak == 52_000       # one batch over the pool
    assert not fw.ensure_room(1 << 20)
    assert h2.state == "HOST"
    h1.unpin()
    assert fw.spill_device_pressure() == 26_000 and h1.state == "HOST"


def _tracked(n):
    fw = SP.get_spill_framework(TpuConf(
        {"spark.rapids.tpu.test.deviceMemoryBytes": str(1 << 30)}))
    return fw, fw.track(_batch(n))


def test_with_retry_injected_retry():
    fw, h = _tracked(100)
    calls = []
    force_retry_oom(2)
    assert list(with_retry(h, lambda b: calls.append(b.num_rows)
                           or b.num_rows)) == [100]
    assert calls == [100] and fw.device_used == 0


def test_with_retry_injected_split():
    fw, h = _tracked(100)
    snap = PC.snapshot()
    force_split_and_retry_oom(1)
    out = list(with_retry(h, lambda b: b.columns[0].data.tolist()))
    assert out == [list(range(50)), list(range(50, 100))]
    assert PC.since(snap)["oom_retry_splits"] == 1
    assert fw.device_used == 0


def test_with_retry_split_exhausted():
    _, h = _tracked(1)
    force_split_and_retry_oom(1)
    with pytest.raises(TpuSplitAndRetryOOM):
        list(with_retry(h, lambda b: b.num_rows))


def test_with_retry_retries_exhausted():
    fw, h = _tracked(10)
    force_retry_oom(3)
    with pytest.raises(TpuRetryOOM):
        list(with_retry(h, lambda b: b.num_rows, max_attempts=3))
    assert fw.device_used == 0


def test_with_retry_device_oom_spills_and_splits():
    """A ``torch.cuda.OutOfMemoryError`` (wrapped, as a layer may raise
    it) spills the other handles and splits the input until it fits."""
    fw, h = _tracked(64)
    other = fw.track(_batch(10))

    def fn(b):
        if b.num_rows > 16:
            try:
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            except torch.cuda.OutOfMemoryError as e:
                raise RuntimeError("while probing") from e
        return b.num_rows

    assert list(with_retry(h, fn)) == [16, 16, 16, 16]
    assert other.state == "HOST"
    with pytest.raises(ValueError):
        list(with_retry(fw.track(_batch(4)), lambda b: int("x")))
    assert fw.device_used == 0
    other.close()


def test_with_retry_no_split():
    attempts = []

    def fn():
        attempts.append(1)
        if len(attempts) < 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "ok"

    SP.get_spill_framework(TpuConf({}))
    assert with_retry_no_split(fn) == "ok" and len(attempts) == 3
    force_retry_oom(1)
    assert with_retry_no_split(lambda: 5) == 5
    force_split_and_retry_oom(1)
    with pytest.raises(TpuSplitAndRetryOOM):
        with_retry_no_split(lambda: 5)

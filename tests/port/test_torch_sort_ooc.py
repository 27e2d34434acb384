"""The out-of-core sort (``exec/sort.py``) on the port against the
reference's CPU oracle: inputs over ``spark.rapids.sql.batchSizeBytes`` in
several batches are sorted into spillable runs and merged in windows of
``ooc_chunk_rows`` (64 here, so that there are many windows) rows a run.
Keys tie across runs, hold nulls first and last, sort descending on two
keys and on a decimal(25,4); a small pool forces spills, and the merge
then reads its windows from the host tier, at most ``ooc_chunk_rows``
rows of each run a window.  The sorted keys equal the
oracle's in order, the rows equal them as a multiset, and no row is lost
or repeated."""
import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.sort import TpuSortExec
from spark_rapids_tpu_torch.memory.spill import peek_spill_framework
from torch_port_frames import ORACLE, frame, rows_key

N = 3000
CHUNK = 64


def _schema(mod):
    return mod.StructType([mod.StructField("k", mod.INT),
                           mod.StructField("v", mod.LONG),
                           mod.StructField("m", mod.DecimalType(25, 4)),
                           mod.StructField("id", mod.LONG)])


def _table():
    rng = np.random.default_rng(29)
    m = rng.integers(-10 ** 12, 10 ** 12, N)
    m[::7] = m[3]                                   # ties in the decimal
    arrays = {"k": rng.integers(0, 6, N).astype(np.int32),
              "v": rng.integers(-50, 50, N),
              "m": np.stack([np.where(m < 0, -1, 0), m], 1).astype(np.int64),
              "id": np.arange(N, dtype=np.int64)}
    validity = {"k": rng.random(N) > 0.1, "v": rng.random(N) > 0.1,
                "m": rng.random(N) > 0.05}
    return arrays, validity


ORDERS = {
    "ties_nulls_first": lambda m, c: [(c("k"), m.SortSpec(True, True))],
    "nulls_last": lambda m, c: [(c("k"), m.SortSpec(True, False))],
    "desc_two_keys": lambda m, c: [(c("k"), m.SortSpec(False, False)),
                                   (c("v"), m.SortSpec(True, True))],
    "decimal_key": lambda m, c: [(c("m"), m.SortSpec(True, True))],
}


def sorted_frame(mod, types, session, orders):
    arrays, validity = _table()
    df = frame(mod, session, arrays, _schema(types), validity)
    return df.order_by(*ORDERS[orders](mod, mod.col))


def _sort_exec(node):
    while not isinstance(node, TpuSortExec):
        node = node.children[0]
    return node


@pytest.mark.parametrize("pool", [None, 64 << 10], ids=["resident",
                                                         "spilling"])
@pytest.mark.parametrize("orders", sorted(ORDERS))
def test_out_of_core_sort_matches_oracle(orders, pool):
    conf = {"spark.rapids.sql.batchSizeBytes": "16k",
            "spark.rapids.sql.reader.batchSizeRows": 400}
    if pool:
        conf["spark.rapids.tpu.test.deviceMemoryBytes"] = str(pool)
    df = sorted_frame(S, T, S.TpuSession(conf, device="cpu"), orders)
    sort = _sort_exec(df._planned())
    assert sort.ooc_bytes == 16 << 10
    sort.ooc_chunk_rows = CHUNK
    row_bytes = sum(b.nbytes() for b in
                    sort.children[0].execute_columnar()) / N
    PC.reset_peaks()
    snap = PC.snapshot()
    got = df.collect()
    d = PC.since(snap)
    most = PC.peaks()["ooc_sort_merge_window_upload_bytes"]
    windows = d["ooc_sort_merge_windows"]
    assert d["ooc_sort_runs"] == 8 and windows > N // (8 * CHUNK)
    assert len({r[3] for r in got}) == N          # every row exactly once
    want = sorted_frame(RS, RT, RS.TpuSession(ORACLE), orders).collect()
    pos = ["kvm".index(e.sql_string()) for e, _ in ORDERS[orders](S, S.col)]
    assert rows_key([tuple(r[p] for p in pos) for r in got], ordered=True) \
        == rows_key([tuple(r[p] for p in pos) for r in want], ordered=True)
    assert rows_key(got) == rows_key(want)
    fw = peek_spill_framework()
    if pool:
        assert fw.spill_to_host_count > 0
        assert d["ooc_sort_merge_upload_bytes"] > 0
        # no window reads more than CHUNK rows of each run (a run here is
        # N / 8 = 375 rows, so a window that brought runs back whole
        # moves more)
        assert 0 < most <= d["ooc_sort_runs"] * CHUNK * row_bytes
    else:
        assert fw.spill_to_host_count == 0
        assert d["ooc_sort_merge_upload_bytes"] == 0 and most == 0
    # a sync a window for the merge (none once every run ends within it),
    # one a batch for the collect, one a spill
    assert d["host_syncs"] <= 2 * windows + fw.spill_to_host_count


def test_small_input_sorts_in_core():
    """At most ``batchSizeBytes``, or one batch, the sort stays in core."""
    s = S.TpuSession({"spark.rapids.sql.reader.batchSizeRows": 400},
                     device="cpu")
    df = sorted_frame(S, T, s, "desc_two_keys")
    snap = PC.snapshot()
    got = df.collect()
    assert PC.since(snap)["ooc_sort_merge_windows"] == 0
    want = sorted_frame(RS, RT, RS.TpuSession(ORACLE),
                        "desc_two_keys").collect()
    assert rows_key(got) == rows_key(want)

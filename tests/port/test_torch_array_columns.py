"""Array columns of flat elements (``columnar/column.py``): the
reference's padded list layout, buffer for buffer against its
``HostColumn.from_pylist``; row gather, slice and concat at mixed element
widths; the host round trip with null lists and null elements; the
device width ladder; the spill framework's buffers; the TKU2 frames
(``shuffle/serializer.py``) against the reference's reader; a list
column through a scan, a filter and a projection; and a list column that
would reach a layer that cannot hold it raising ``NotOnGpu`` at plan
time."""
import datetime as dt

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   empty_column)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn
from spark_rapids_tpu_torch.exec.base import NotOnGpu

ROWS = {
    "LONG": [[1, None, 3], None, [], [2 ** 62, -(2 ** 62)], [None]],
    "INT": [[7], [None, None], None, list(range(12)), []],
    "DOUBLE": [[0.5, float("inf"), -0.0], None, [None, 1e300], [], [2.5]],
    "DATE": [[dt.date(1998, 1, 2)], None, [dt.date(1970, 1, 1), None], [],
             [dt.date(2024, 2, 29)] * 3],
    "BOOLEAN": [[True, False, None], [], None, [False], [True] * 9],
    "DEC": [[1.25, None], None, [-99999.99], [], [0.01, 0.02]],
}
TYPES = {"DEC": "DecimalType(7, 2)"}


def ptype(name, mod=T):
    return mod.ArrayType(eval("mod." + TYPES.get(name, name)))


def _rows(name):
    from decimal import Decimal

    rows = ROWS[name]
    if name == "DEC":
        rows = [None if r is None else [None if v is None else
                                        Decimal(str(v)) for v in r]
                for r in rows]
    return rows


@pytest.mark.parametrize("name", sorted(ROWS))
def test_host_layout_is_the_references(name):
    """data (n, longest list), int32 lengths, elem_valid; elements past a
    row's length zero and invalid; a null list length 0; the Python lists
    come back, nulls inside and outside lists."""
    from spark_rapids_tpu import types as RT
    from spark_rapids_tpu.columnar.column import HostColumn as RHost

    rows = _rows(name)
    h = HostColumn.from_pylist(rows, ptype(name))
    ref = RHost.from_pylist(rows, ptype(name, RT))
    for buf in ("validity", "data", "lengths", "elem_valid"):
        np.testing.assert_array_equal(getattr(h, buf), getattr(ref, buf),
                                      err_msg=buf)
        assert getattr(h, buf).dtype == getattr(ref, buf).dtype, buf
    assert h.to_pylist() == ref.to_pylist() == rows
    assert h.is_array and h.ewidth == max(len(r or []) for r in rows)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_device_rows_gather_slice_and_concat(name):
    """On the device a list widens to the bucket of the longest one;
    gather and slice keep every buffer row for row; a concat of columns at
    different element widths meets at the widest."""
    rows = _rows(name)
    h = HostColumn.from_pylist(rows, ptype(name))
    d = DeviceColumn.from_host(h, "cpu")
    assert d.ewidth == (32 if h.ewidth > 8 else 8)
    assert d.to_host(len(rows)).to_pylist() == rows
    idx = torch.tensor([4, 0, 0, 2])
    assert d.gather(idx).to_host(4).to_pylist() == [rows[i] for i in idx]
    assert d.slice(1, 4).to_host(3).to_pylist() == rows[1:4]
    short = DeviceColumn.from_host(HostColumn.from_pylist(rows[:1],
                                                          ptype(name)), "cpu")
    wide = DeviceColumn.from_host(h, "cpu").with_ewidth(128)
    both = DeviceColumn.concat([short, d, wide])
    assert both.ewidth == 128
    assert both.to_host(1 + 2 * len(rows)).to_pylist() == (
        rows[:1] + rows + rows)
    host_cat = HostColumn.concat([HostColumn.from_pylist(rows[:2],
                                                         ptype(name)), h])
    assert host_cat.to_pylist() == rows[:2] + rows


def test_buffers_in_one_fixed_order():
    """``tensors``/``rebuild_column`` carry validity, data, lengths and
    elem_valid, so the spill framework's buffers and an empty column work
    through the code that already exists."""
    from spark_rapids_tpu_torch.columnar.column import rebuild_column
    from spark_rapids_tpu_torch.memory.spill import buffer_names

    dt_ = ptype("LONG")
    d = DeviceColumn.from_host(HostColumn.from_pylist(ROWS["LONG"], dt_),
                               "cpu")
    assert [t.shape for t in d.tensors()] == [
        (5,), (5, 8), (5,), (5, 8)]
    assert buffer_names(dt_) == ["validity", "data", "lengths",
                                 "elem_valid"]
    back = rebuild_column(dt_, iter(d.tensors()))
    assert back.to_host(5).to_pylist() == ROWS["LONG"]
    e = empty_column(dt_, "cpu")
    assert e.is_array and e.capacity == 0
    assert e.to_host(0).to_pylist() == []
    st = T.StructType([T.StructField("a", dt_)])
    assert buffer_names(st) == ["validity", "0.validity", "0.data",
                                "0.lengths", "0.elem_valid"]


def test_spill_round_trip_keeps_lists(tmp_path):
    """A batch with a list column moved to the host, then to disk, by the
    spill framework comes back row for row."""
    from spark_rapids_tpu_torch.memory.spill import SpillFramework

    b = ColumnarBatch.from_host_columns(
        [HostColumn.from_pylist(ROWS["INT"], ptype("INT")),
         HostColumn.from_pylist(list(range(5)), T.LONG)], ["a", "x"], "cpu")
    for host_limit in (1 << 30, 0):
        fw = SpillFramework(pool_bytes=0, host_limit=host_limit,
                            spill_dir=str(tmp_path))
        h = fw.track(b)
        fw.spill_device_pressure()
        assert h.state == ("HOST" if host_limit else "DISK")
        assert h.get_batch().to_rows() == list(zip(ROWS["INT"], range(5)))
        h.close()


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_serializer_frames_lists_as_the_reference(tmp_path, codec):
    """The port's frames: ``kind`` array with the element dtype and the
    longest list, ragged elements and their packed validity; the
    reference's reader reads them (in the child) and the port's reader
    pads the frames' rows to the longest list of all of them."""
    from spark_rapids_tpu_torch.shuffle import serializer as SER
    from torch_port_jaxref import run_jax

    sch = T.StructType([T.StructField("a", ptype("LONG")),
                        T.StructField("x", T.INT)])
    b1 = ColumnarBatch.from_host_columns(
        [HostColumn.from_pylist(ROWS["LONG"], ptype("LONG")),
         HostColumn.from_pylist(list(range(5)), T.INT)], ["a", "x"], "cpu")
    b2 = ColumnarBatch.from_host_columns(
        [HostColumn.from_pylist([list(range(11)), None], ptype("LONG")),
         HostColumn.from_pylist([5, 6], T.INT)], ["a", "x"], "cpu")
    frames = [SER.serialize_batch(b, codec) for b in (b1, b2)]
    out = SER.deserialize_concat(frames, sch, codec, "cpu")
    want = list(zip(ROWS["LONG"] + [list(range(11)), None], range(7)))
    assert out.to_rows() == want
    assert out.columns[0].ewidth == 11
    ref = run_jax(f"""
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.shuffle.serializer import deserialize_concat
        sch = T.StructType([T.StructField("a", T.ArrayType(T.LONG)),
                            T.StructField("x", T.INT)])
        frames = [inp["f0"].tobytes(), inp["f1"].tobytes()]
        b = deserialize_concat(frames, sch, {codec!r})
        c = b.columns[0]
        for k in ("validity", "data", "lengths", "elem_valid"):
            out[k] = np.asarray(getattr(c, k))[:b.num_rows]
    """, tmp_path, {f"f{i}": np.frombuffer(f, np.uint8)
                    for i, f in enumerate(frames)})
    got = out.columns[0]
    for k in ("validity", "data", "lengths", "elem_valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), ref[k],
                                      err_msg=k)


def test_list_column_through_scan_filter_and_projection():
    """A LocalTableScan of a list column, filtered (a row gather) and
    projected, collected as Python lists.  An exchange cannot hold one
    (the reference's Exchange rule has no arrays, so it is a CPU stage,
    and the port's engine holds no list column): ``NotOnGpu`` at plan
    time."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    sch = T.StructType([T.StructField("a", ptype("DOUBLE")),
                        T.StructField("x", T.INT)])
    hosts = [HostColumn.from_pylist(ROWS["DOUBLE"], ptype("DOUBLE")),
             HostColumn.from_pylist(list(range(5)), T.INT)]
    s = S.TpuSession({"spark.rapids.sql.reader.batchSizeRows": 2},
                     device="cpu")
    df = S.DataFrame(LocalTableScan(hosts, sch), s)
    got = df.filter(S.col("x") > S.lit(0)).select("a", "x").collect()
    assert got == list(zip(ROWS["DOUBLE"][1:], range(1, 5)))
    with pytest.raises(NotOnGpu, match="Exchange in a CPU stage"):
        df.repartition(3, "x").explain()


def test_list_columns_that_no_layer_holds_raise_at_plan_time():
    """Arrays of strings are not ported (the reference keeps collect over
    them off its device); a list column in a CPU stage (here the scan's
    Project disabled) raises ``NotOnGpu`` when the plan is made, never a
    wrong row; the plan rewrite admits flat elements only."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.overrides.overrides import _ported_type
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    with pytest.raises(NotImplementedError, match="array<string>"):
        HostColumn.from_pylist([["a"]], T.ArrayType(T.STRING))
    assert _ported_type(ptype("LONG")) and _ported_type(ptype("DEC"))
    assert not _ported_type(T.ArrayType(T.STRING))
    assert not _ported_type(T.ArrayType(T.DecimalType(20, 2)))
    sch = T.StructType([T.StructField("a", ptype("LONG"))])
    hosts = [HostColumn.from_pylist(ROWS["LONG"], ptype("LONG"))]
    s = S.TpuSession({"spark.rapids.sql.exec.Project": "false"},
                     device="cpu")
    df = S.DataFrame(LocalTableScan(hosts, sch), s).select("a")
    with pytest.raises(NotOnGpu, match="array<bigint> in a CPU stage"):
        df.explain()

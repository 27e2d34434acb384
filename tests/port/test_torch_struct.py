"""Struct columns and struct expressions of the port against the JAX
package: host columns built and read back as the reference's
(``from_pylist``/``to_pylist``, null rows with null fields); a struct
column through the device and back, ``slice``, ``gather``, ``concat``,
the stream compaction and the spill framework's host and disk tiers,
children included in ``nbytes``, but not through the shuffle serializer; ``GetStructField`` with a null struct
and ``CreateNamedStruct`` on a batch, against the reference's CPU oracle
on the same rows.  Every comparison is exact."""
from decimal import Decimal

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.column import HostColumn as RefHostColumn
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.expr.base import BoundReference, EvalContext
from spark_rapids_tpu_torch.expr.complextypes import GetStructField
from spark_rapids_tpu_torch.memory import device_manager as DM
from spark_rapids_tpu_torch.memory import spill as SP
from spark_rapids_tpu_torch.ops.filterops import compact_columns
from torch_port_frames import ORACLE, rows_key

CPU = torch.device("cpu")


def struct_type(mod):
    return mod.StructType([mod.StructField("a", mod.LONG),
                           mod.StructField("b", mod.DecimalType(25, 4)),
                           mod.StructField("c", mod.INT)])


def rows(n=40, seed=5):
    """Struct rows as tuples, with null structs and null fields."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.2:
            out.append(None)
            continue
        a = int(rng.integers(-10 ** 12, 10 ** 12))
        b = None if rng.random() < 0.2 else (
            int(rng.integers(-10 ** 15, 10 ** 15)) * 10 ** 4 + i)
        out.append((a if rng.random() > 0.1 else None,
                    None if b is None else Decimal(b).scaleb(-4),
                    int(rng.integers(-50, 50))))
    return out


def test_host_struct_columns_match_reference():
    data = rows()
    h = HostColumn.from_pylist(data, struct_type(T))
    ref = RefHostColumn.from_pylist(data, struct_type(RT))
    assert h.to_pylist() == ref.to_pylist()
    assert np.array_equal(h.validity, ref.validity)
    for mine, theirs in zip(h.children, ref.children):
        assert np.array_equal(mine.validity, theirs.validity)
        assert np.array_equal(mine.data, theirs.data)
    assert h.slice_rows(5, 17).to_pylist() == ref.to_pylist()[5:17]
    assert HostColumn.concat([h.slice_rows(0, 9), h.slice_rows(9, 40)]
                             ).to_pylist() == data


def _struct_batch(data):
    st = struct_type(T)
    h = HostColumn.from_pylist(data, st)
    ids = HostColumn.from_numpy(np.arange(len(data), dtype=np.int64), T.LONG)
    schema = T.StructType([T.StructField("id", T.LONG),
                           T.StructField("s", st)])
    return ColumnarBatch.from_host_columns([ids, h], ["id", "s"], CPU), \
        schema


def test_struct_rows_through_the_device():
    """Upload, slice, gather, concat and compaction move the children
    with the struct; ``nbytes`` counts them."""
    data = rows()
    batch, _ = _struct_batch(data)
    c = batch.columns[1]
    assert c.is_struct and c.data is None and len(c.children) == 3
    # validity + a (validity, int64) + b (validity, limbs) + c
    assert c.nbytes() == 40 * (1 + 9 + 17 + 5)
    back = batch.to_host_columns()[1].to_pylist()
    assert back == data
    assert batch.slice_rows(7, 20).to_host_columns()[1].to_pylist() == \
        data[7:27]
    idx = torch.tensor([39, 0, 3, 3, 11])
    assert c.gather(idx).to_host(5).to_pylist() == [data[i]
                                                    for i in idx.tolist()]
    both = ColumnarBatch.concat([batch.slice_rows(30, 10),
                                 batch.slice_rows(0, 30)])
    assert both.to_host_columns()[1].to_pylist() == data[30:] + data[:30]
    mask = torch.tensor([i % 3 == 1 for i in range(40)])
    cols, kept = compact_columns(mask, batch.columns)
    got = ColumnarBatch(cols, kept, batch.schema).to_host_columns()
    assert got[1].to_pylist() == [d for i, d in enumerate(data)
                                  if i % 3 == 1]


def test_struct_columns_do_not_serialize():
    """The shuffle serializer keeps raising for nested columns (TKU2
    frames of structs are not ported)."""
    from spark_rapids_tpu_torch.shuffle.serializer import serialize_batch

    batch, _ = _struct_batch(rows())
    with pytest.raises(NotImplementedError, match="struct"):
        serialize_batch(batch, "zlib")


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_struct_batch_spills_and_comes_back(tmp_path, tier):
    """The spill framework moves a struct column's children to the host
    (and on to disk) and back, and reads a window of rows from the host
    tier without bringing the batch back."""
    SP.reset_spill_framework()
    DM.reset_device_manager()
    data = rows()
    batch, _ = _struct_batch(data)
    fw = SP.SpillFramework(pool_bytes=1 << 20,
                           host_limit=0 if tier == "disk" else 1 << 30,
                           spill_dir=str(tmp_path))
    h = fw.track(batch)
    assert fw.spill_device_pressure() == batch.nbytes()
    assert h.state == (SP.STATE_DISK if tier == "disk" else SP.STATE_HOST)
    if tier == "host":
        assert sorted(h._host[1]) == ["0.data", "0.validity", "1.data",
                                      "1.validity", "2.data", "2.validity",
                                      "validity"]
        part = h.get_rows(10, 5)
        assert h.state == SP.STATE_HOST
        assert part.to_host_columns()[1].to_pylist() == data[10:15]
    assert h.get_batch().to_host_columns()[1].to_pylist() == data
    assert h.state == SP.STATE_DEVICE
    h.close()


def test_get_struct_field_with_null_structs_matches_oracle():
    """``s.a`` and ``s.b`` over null structs and null fields: null where
    either is, as the reference's oracle gives them."""
    data = rows()
    batch, schema = _struct_batch(data)
    ctx = EvalContext(batch)
    ref = BoundReference(1, struct_type(T))
    got = {}
    for f in ("a", "b", "c"):
        e = GetStructField(ref, f).resolve(schema)
        col = e.eval_tpu(ctx)
        got[f] = col.to_host(40).to_pylist()
    oracle_df = RS.TpuSession(ORACLE).create_dataframe(
        {"id": list(range(40)), "s": data},
        RT.StructType([RT.StructField("id", RT.LONG),
                       RT.StructField("s", struct_type(RT))]))
    from spark_rapids_tpu.expr.complextypes import GetStructField as RG

    want = oracle_df.select(*[RG(RS.col("s"), f).alias(f)
                              for f in ("a", "b", "c")]).collect()
    assert list(zip(got["a"], got["b"], got["c"])) == want


def test_create_named_struct_on_the_device_matches_oracle():
    """``named_struct('x', id, 'y', 7).y`` runs on the device (every
    input is flat): the plan has no CPU stage and the rows are the
    oracle's."""
    data = rows()
    cols = {"id": list(range(40)), "s": data}

    def query(mod, types, session):
        from importlib import import_module

        CTm = import_module(mod.__name__.rsplit(".", 1)[0]
                            + ".expr.complextypes")
        df = session.create_dataframe(cols, types.StructType(
            [types.StructField("id", types.LONG),
             types.StructField("s", struct_type(types))]))
        df = df.filter(mod.col("id") > mod.lit(3))
        named = CTm.CreateNamedStruct(
            ["x", "y"], [mod.col("id"), mod.lit(7)])
        return df.select(mod.col("id"),
                         CTm.GetStructField(named, "y").alias("y"))

    port = query(S, T, S.TpuSession({}, device="cpu"))
    assert "Fallback reasons" not in port.explain()
    assert "TpuRowToColumnar" not in port.explain()
    want = query(RS, RT, RS.TpuSession(ORACLE)).collect()
    assert rows_key(port.collect()) == rows_key(want)

"""Types, columns and batches of the port against the JAX package."""
import datetime
from decimal import Decimal

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as RT
from spark_rapids_tpu.columnar.column import HostColumn as RefHostColumn
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn
from spark_rapids_tpu_torch.columnar.convert import batch_from_numpy
from spark_rapids_tpu_torch.device import resolve_device

CPU = torch.device("cpu")


def _type_pairs():
    names = ["BooleanType", "ByteType", "ShortType", "IntegerType",
             "LongType", "FloatType", "DoubleType", "StringType",
             "BinaryType", "DateType", "TimestampType", "NullType"]
    pairs = [(getattr(T, n)(), getattr(RT, n)()) for n in names]
    for p, s in [(1, 0), (7, 2), (12, 2), (18, 4), (19, 0), (25, 4),
                 (35, 4), (38, 10)]:
        pairs.append((T.DecimalType(p, s), RT.DecimalType(p, s)))
    return pairs


@pytest.mark.parametrize("pt,rt", _type_pairs(), ids=lambda t: repr(t))
def test_storage_dtype_and_is_128_agree(pt, rt):
    assert pt.simpleString == rt.simpleString
    try:
        want = RT.storage_dtype(rt)
    except TypeError:
        with pytest.raises(TypeError):
            T.storage_dtype(pt)
    else:
        assert T.storage_dtype(pt) == want
    if isinstance(rt, RT.DecimalType):
        assert pt.is_128 == rt.is_128


_VALUES = [
    (T.INT, RT.INT, [1, None, -7, 2 ** 31 - 1]),
    (T.LONG, RT.LONG, [None, 2 ** 63 - 1, -(2 ** 63), 0]),
    (T.DATE, RT.DATE, [datetime.date(1994, 1, 1), None,
                       datetime.date(1969, 12, 31)]),
    (T.BOOLEAN, RT.BOOLEAN, [True, False, None]),
    (T.DOUBLE, RT.DOUBLE, [1.5, None, -0.25]),
    (T.DecimalType(12, 2), RT.DecimalType(12, 2),
     [Decimal("0.05"), None, Decimal("-9999999999.99")]),
    (T.DecimalType(35, 4), RT.DecimalType(35, 4),
     [Decimal("1234567890123456789012345.6789"), None, Decimal("-0.0001")]),
]


@pytest.mark.parametrize("pt,rt,vals", _VALUES,
                         ids=[v[0].simpleString for v in _VALUES])
def test_host_device_host_round_trip(pt, rt, vals):
    ref = RefHostColumn.from_pylist(vals, rt)
    h = HostColumn.from_pylist(vals, pt)
    np.testing.assert_array_equal(h.validity, ref.validity)
    np.testing.assert_array_equal(h.data[h.validity], ref.data[ref.validity])
    back = DeviceColumn.from_host(h, CPU).to_host(len(vals))
    assert back.to_pylist() == ref.to_pylist()


def test_batch_from_numpy_takes_reference_columns():
    rng = np.random.default_rng(4)
    n = 300
    rschema = RT.StructType([RT.StructField("a", RT.LONG),
                             RT.StructField("d", RT.DecimalType(25, 4)),
                             RT.StructField("s", RT.DATE)])
    schema = T.StructType([T.StructField("a", T.LONG),
                           T.StructField("d", T.DecimalType(25, 4)),
                           T.StructField("s", T.DATE)])
    vals = {"a": [int(x) if x % 5 else None
                  for x in rng.integers(-99, 99, n)],
            "d": [Decimal(int(x)).scaleb(-4) if x % 7 else None
                  for x in rng.integers(-10 ** 15, 10 ** 15, n)],
            "s": [int(x) for x in rng.integers(8000, 10000, n)]}
    ref_cols = [RefHostColumn.from_pylist(vals[f.name], f.dataType)
                for f in rschema.fields]
    batch = batch_from_numpy(ref_cols, schema, CPU)
    assert batch.num_rows == n and batch.schema == schema
    assert batch.columns[1].data.shape == (n, 2)
    want = list(zip(*[c.to_pylist() for c in ref_cols]))
    assert batch.to_rows() == want
    pairs = [(c.data, c.validity) for c in ref_cols]
    assert batch_from_numpy(pairs, schema, CPU).to_rows() == want


def test_batch_from_numpy_rejects_shape_mismatch():
    schema = T.StructType([T.StructField("d", T.DecimalType(25, 4))])
    with pytest.raises(ValueError):
        batch_from_numpy([(np.zeros(3, np.int64), np.ones(3, bool))],
                         schema, CPU)


def test_concat_and_to_pydict():
    schema = T.StructType([T.StructField("x", T.INT)])
    b = ColumnarBatch.from_host_columns(
        [HostColumn.from_pylist([1, None], T.INT)], ["x"], CPU)
    cat = ColumnarBatch.concat([b, b])
    assert cat.num_rows == 4 and cat.schema == schema
    assert cat.to_pydict() == {"x": [1, None, 1, None]}


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
    assert resolve_device("cpu") == CPU

"""Spark-exact murmur3 (``ops/hashing.py``) and the exchange's partition
slices (``exec/exchange.py``) against the JAX package, whose device code
runs in the child process: every ported type with nulls, -0.0, NaN and
the special floats of ``tests/test_hash_functions.py``, strings at
several widths, several columns chained, another seed; then hash, round-robin and range slices of one
batch, row for row.  Every comparison is bit-exact."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from spark_rapids_tpu_torch.ops import hashing as H
from torch_port_jaxref import run_jax

N = 600
# name -> (numpy storage dtype, type name in both packages)
TYPES = {"int": (np.int32, "INT"), "long": (np.int64, "LONG"),
         "date": (np.int32, "DATE"), "byte": (np.int8, "BYTE"),
         "short": (np.int16, "SHORT"), "bool": (np.bool_, "BOOLEAN"),
         "float": (np.float32, "FLOAT"), "double": (np.float64, "DOUBLE"),
         "dec64": (np.int64, "DecimalType(12, 2)")}
SPECIAL = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1.5]


def column_data(name, rng):
    """Values covering the type's range and edge cases, and a validity
    with about one null in eight."""
    npd = TYPES[name][0]
    if npd is np.bool_:
        data = rng.integers(0, 2, N).astype(np.bool_)
    elif np.issubdtype(npd, np.floating):
        data = (rng.standard_normal(N) * 1e3).astype(npd)
        data[:len(SPECIAL)] = SPECIAL
        data[len(SPECIAL)] = np.array(np.nan, npd)   # another NaN row
    else:
        info = np.iinfo(npd)
        data = rng.integers(info.min, info.max, N, dtype=npd, endpoint=True)
        data[:3] = [0, info.min, info.max]
    valid = rng.random(N) > 0.125
    valid[:len(SPECIAL) + 1] = True
    return data, valid


def port_type(name):
    return eval("T." + TYPES[name][1])


def port_col(name, data, valid):
    return DeviceColumn(port_type(name), torch.from_numpy(valid),
                        data=torch.from_numpy(data))


def reference(tmp_path, combos, inputs, n_parts, seed):
    """murmur3_columns and spark_partition_ids of the reference for each
    combination of column names."""
    types = {k: v[1] for k, v in TYPES.items()}
    return run_jax(f"""
        import jax.numpy as jnp
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.columnar.column import DeviceColumn
        from spark_rapids_tpu.ops.hashing import (murmur3_columns,
                                                  spark_partition_ids)
        types = {types!r}
        for i, names in enumerate({combos!r}):
            cols = [DeviceColumn(eval("T." + types[n]),
                                 jnp.asarray(inp[n + "_valid"]),
                                 data=jnp.asarray(inp[n]))
                    for n in names]
            out[f"h{{i}}"] = np.asarray(murmur3_columns(cols, seed={seed}))
            out[f"p{{i}}"] = np.asarray(
                spark_partition_ids(cols, {n_parts}, seed={seed}))
    """, tmp_path, inputs)


@pytest.mark.parametrize("seed", [42, 100407])
def test_murmur3_and_partition_ids_match_reference(tmp_path, seed):
    rng = np.random.default_rng(seed)
    cols = {name: column_data(name, rng) for name in TYPES}
    inputs = {}
    for name, (data, valid) in cols.items():
        inputs[name], inputs[name + "_valid"] = data, valid
    combos = [[name] for name in TYPES] + [
        ["int", "long"], ["double", "date", "bool"],
        ["dec64", "float", "short", "byte"]]
    out = reference(tmp_path, combos, inputs, 37, seed)
    for i, names in enumerate(combos):
        pcols = [port_col(n, *cols[n]) for n in names]
        h = H.murmur3_columns(pcols, seed=seed)
        p = H.spark_partition_ids(pcols, 37, seed=seed)
        assert h.dtype == torch.int32
        np.testing.assert_array_equal(h.numpy(), out[f"h{i}"],
                                      err_msg=str(names))
        np.testing.assert_array_equal(p.numpy(), out[f"p{i}"],
                                      err_msg=str(names))
        assert int(p.min()) >= 0 and int(p.max()) < 37


# prefixes of one another, every tail length, multi-byte UTF-8 and bytes
# above 127 (the sign-extended tail), past the first width bucket
_STRINGS = ["", "a", "ab", "abc", "abcd", "abcde", "MAIL", "SHIP",
            "1-URGENT", "4-NOT SPECIFIED", "é", "naïve café", "\xff\xfe",
            "zzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzz"]


@pytest.mark.parametrize("width", [None, 8, 64])
def test_murmur3_of_strings_matches_reference(tmp_path, width):
    """Strings alone and chained after an int, at the host width (the
    longest value) and padded wider: the padding must not change a hash
    (``width`` 8 holds no row past 8 bytes, so it uses the short ones)."""
    from torch_port_frames import string_host
    import spark_rapids_tpu_torch.columnar.column as PCOL

    rng = np.random.default_rng(11)
    pool = [v for v in _STRINGS if width is None or len(v.encode()) <= width]
    vals = np.asarray(pool, object)[rng.integers(0, len(pool), N)]
    h = string_host(PCOL, vals, rng.random(N) > 0.125)
    if width is not None:
        h = h.with_width(width)
    ints, ivalid = column_data("int", rng)
    out = run_jax(f"""
        import jax.numpy as jnp
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.columnar.column import DeviceColumn
        from spark_rapids_tpu.ops.hashing import (murmur3_columns,
                                                  spark_partition_ids)
        s = DeviceColumn(T.STRING, jnp.asarray(inp["valid"]),
                         chars=jnp.asarray(inp["chars"]),
                         lengths=jnp.asarray(inp["lengths"]))
        i = DeviceColumn(T.INT, jnp.asarray(inp["ivalid"]),
                         data=jnp.asarray(inp["ints"]))
        for name, cols in (("s", [s]), ("is", [i, s])):
            out["h" + name] = np.asarray(murmur3_columns(cols))
            out["p" + name] = np.asarray(spark_partition_ids(cols, 37))
    """, tmp_path, {"valid": h.validity, "chars": h.chars,
                    "lengths": h.lengths, "ints": ints, "ivalid": ivalid})
    s = DeviceColumn(T.STRING, torch.from_numpy(h.validity),
                     chars=torch.from_numpy(h.chars),
                     lengths=torch.from_numpy(h.lengths))
    i = port_col("int", ints, ivalid)
    for name, cols in (("s", [s]), ("is", [i, s])):
        np.testing.assert_array_equal(H.murmur3_columns(cols).numpy(),
                                      out["h" + name], err_msg=name)
        np.testing.assert_array_equal(
            H.spark_partition_ids(cols, 37).numpy(), out["p" + name],
            err_msg=name)


def test_special_floats_and_nulls():
    """-0.0 hashes as 0.0 and every NaN as one NaN, float and double; a
    null passes the seed through (``murmur3`` of an all-null column is the
    seed)."""
    for name in ("float", "double"):
        npd = TYPES[name][0]
        d = np.array(SPECIAL + [np.nan], npd)
        d[-1] = np.frombuffer(np.array([0x7FF0000000000001 if npd is
                                        np.float64 else 0x7F800001],
                                       np.int64 if npd is np.float64
                                       else np.int32).tobytes(), npd)[0]
        h = H.murmur3_columns([port_col(name, d, np.ones(len(d), bool))])
        assert h[0] == h[1]                  # 0.0 and -0.0
        assert h[2] == h[6]                  # two NaN bit patterns
        assert len(set(h[[0, 2, 3, 4, 5]].tolist())) == 5
    nulls = port_col("long", np.arange(4, dtype=np.int64),
                     np.zeros(4, bool))
    assert H.murmur3_columns([nulls]).tolist() == [42] * 4


def test_decimal128_keys_raise():
    c = DeviceColumn(T.DecimalType(20, 0), torch.ones(2, dtype=torch.bool),
                     data=torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(NotOnGpu, match="above 18 digits"):
        H.spark_partition_ids([c], 4)


def _slice_inputs(rng, n=500):
    return {"x": np.arange(n, dtype=np.int64),
            "k": rng.integers(-50, 50, n).astype(np.int32),
            "k_valid": rng.random(n) > 0.1}


def test_partition_slices_match_reference(tmp_path):
    """Hash, round-robin and range slices of one batch: the same rows (by
    row id ``x``) in the same order under each partition id."""
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec
    from spark_rapids_tpu_torch.expr.base import col
    from spark_rapids_tpu_torch.ops.sortkeys import SortSpec
    from spark_rapids_tpu_torch.plan import nodes as PN

    inp = _slice_inputs(np.random.default_rng(3))
    out = run_jax("""
        import jax.numpy as jnp
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.columnar.batch import ColumnarBatch
        from spark_rapids_tpu.columnar.column import DeviceColumn
        from spark_rapids_tpu.exec.exchange import TpuShuffleExchangeExec
        from spark_rapids_tpu.expr.base import col
        from spark_rapids_tpu.ops.sortkeys import SortSpec
        from spark_rapids_tpu.plan import nodes as PN
        n = len(inp["x"])
        sch = T.StructType([T.StructField("x", T.LONG),
                            T.StructField("k", T.INT)])
        b = ColumnarBatch([
            DeviceColumn(T.LONG, jnp.ones(n, bool), data=jnp.asarray(inp["x"])),
            DeviceColumn(T.INT, jnp.asarray(inp["k_valid"]),
                         data=jnp.asarray(inp["k"]))], n, sch)
        k = col("k").resolve(sch)
        parts = {"hash": PN.HashPartitioning([k], 7),
                 "rr": PN.RoundRobinPartitioning(5),
                 "range": PN.RangePartitioning([(k, SortSpec())], 6)}

        class Leaf:
            output = sch

        for name, p in parts.items():
            ex = TpuShuffleExchangeExec(p, Leaf())
            for pid, sl in ex.partition_slices(b):
                out[f"{name}_{pid}"] = np.asarray(
                    sl.columns[0].data)[:sl.num_rows]
    """, tmp_path, inp)
    n = len(inp["x"])
    sch = T.StructType([T.StructField("x", T.LONG),
                        T.StructField("k", T.INT)])
    b = ColumnarBatch([
        DeviceColumn(T.LONG, torch.ones(n, dtype=torch.bool),
                     data=torch.from_numpy(inp["x"])),
        DeviceColumn(T.INT, torch.from_numpy(inp["k_valid"]),
                     data=torch.from_numpy(inp["k"]))], n, sch)
    k = col("k").resolve(sch)
    parts = {"hash": PN.HashPartitioning([k], 7),
             "rr": PN.RoundRobinPartitioning(5),
             "range": PN.RangePartitioning([(k, SortSpec())], 6)}
    for name, p in parts.items():
        ex = TpuShuffleExchangeExec(p, None)
        got = {pid: sl.columns[0].data.numpy()
               for pid, sl in ex.partition_slices(b)}
        want = {int(key.split("_")[1]): v for key, v in out.items()
                if key.startswith(name + "_") and len(v)}
        assert sorted(got) == sorted(want), name
        for pid in got:
            np.testing.assert_array_equal(got[pid], want[pid],
                                          err_msg=f"{name} {pid}")
        assert sum(len(v) for v in got.values()) == n

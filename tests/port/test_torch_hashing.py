"""Spark-exact murmur3, xxhash64 and Hive hash (``ops/hashing.py``) and
the exchange's partition slices (``exec/exchange.py``) against the JAX
package, whose device code runs in the child process: every ported type
with nulls, -0.0, NaN and the special floats of
``tests/test_hash_functions.py``, strings at several widths (past
xxhash64's 32-byte stripes), several columns chained, another seed; the
session's ``hash_`` and ``xxhash64_`` and ``hive_hash`` against the
reference's CPU oracle; then hash, round-robin and range slices of one
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


# -- xxhash64 and Hive hash ----------------------------------------------------

#: the types of ``tests/test_hash_functions.py`` (timestamps aside: the
#: port has none), decimal(18, 4) among them
XX_TYPES = dict(TYPES, dec18=(np.int64, "DecimalType(18, 4)"))
XX_COMBOS = [[n] for n in XX_TYPES] + [["str5"], ["str75"]] + [
    ["int", "str75", "double", "long"], ["dec18", "float", "short", "byte"],
    ["str5", "bool", "date"]]


def _strings(rng, longest):
    """UTF-8 strings of 0..``longest`` bytes (multi-byte characters and
    bytes above 127 included)."""
    alphabet = list("abcXYZ 09") + ["é", "漢", "\x7f"]
    out = []
    for _ in range(N):
        s = "".join(rng.choice(alphabet, rng.integers(0, longest + 1)))
        out.append(s.encode("utf-8")[:longest].decode("utf-8", "ignore"))
    return np.asarray(out, object)


@pytest.fixture(scope="module")
def xx_inputs(tmp_path_factory):
    """Per type its data and validity; the reference's xxhash64 (seed 42
    and another) and Hive hash of each combination, one child call."""
    from torch_port_frames import string_host
    import spark_rapids_tpu_torch.columnar.column as PCOL

    rng = np.random.default_rng(77)
    cols, inputs = {}, {}
    for name in XX_TYPES:
        npd = XX_TYPES[name][0]
        if name == "dec18":
            data = rng.integers(-10 ** 18 + 1, 10 ** 18, N)
            valid = rng.random(N) > 0.125
        else:
            data, valid = column_data(name, rng)
        cols[name] = (data.astype(npd), valid)
        inputs[name], inputs[name + "_valid"] = cols[name]
    for name, longest in (("str5", 5), ("str75", 75)):
        h = string_host(PCOL, _strings(rng, longest), rng.random(N) > 0.125)
        h = h.bucketed()
        cols[name] = h
        for k in ("validity", "chars", "lengths"):
            inputs[f"{name}_{k}"] = getattr(h, k)
    types = {k: v[1] for k, v in XX_TYPES.items()}
    out = run_jax(f"""
        import jax.numpy as jnp
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.columnar.column import DeviceColumn
        from spark_rapids_tpu.ops.hashing import (hive_hash_columns,
                                                  xxhash64_columns)
        types = {types!r}

        def col(n):
            if n.startswith("str"):
                return DeviceColumn(T.STRING,
                                    jnp.asarray(inp[n + "_validity"]),
                                    chars=jnp.asarray(inp[n + "_chars"]),
                                    lengths=jnp.asarray(inp[n + "_lengths"]))
            return DeviceColumn(eval("T." + types[n]),
                                jnp.asarray(inp[n + "_valid"]),
                                data=jnp.asarray(inp[n]))

        for i, names in enumerate({XX_COMBOS!r}):
            cs = [col(n) for n in names]
            out[f"xx42_{{i}}"] = np.asarray(xxhash64_columns(cs))
            out[f"xx7_{{i}}"] = np.asarray(xxhash64_columns(cs, seed=7))
            if not any(n.startswith("dec") for n in names):
                out[f"hive_{{i}}"] = np.asarray(hive_hash_columns(cs))
    """, tmp_path_factory.mktemp("xx"), inputs)
    return cols, out


def _xx_col(cols, name):
    if name.startswith("str"):
        h = cols[name]
        return DeviceColumn(T.STRING, torch.from_numpy(h.validity),
                            chars=torch.from_numpy(h.chars),
                            lengths=torch.from_numpy(h.lengths))
    data, valid = cols[name]
    return DeviceColumn(eval("T." + XX_TYPES[name][1]),
                        torch.from_numpy(valid), data=torch.from_numpy(data))


@pytest.mark.parametrize("combo", range(len(XX_COMBOS)),
                         ids=["+".join(c) for c in XX_COMBOS])
def test_xxhash64_and_hive_hash_match_reference(xx_inputs, combo):
    cols, out = xx_inputs
    names = XX_COMBOS[combo]
    pcols = [_xx_col(cols, n) for n in names]
    for seed in (42, 7):
        got = H.xxhash64_columns(pcols, seed=seed)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), out[f"xx{seed}_{combo}"],
                                      err_msg=f"xxhash64 seed {seed}")
    if f"hive_{combo}" in out:
        got = H.hive_hash_columns(pcols)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), out[f"hive_{combo}"])


def test_xxhash64_special_floats_and_decimal128():
    """-0.0 hashes as 0.0 and every NaN as one, float and double; a null
    passes the seed; a decimal above 18 digits raises ``NotOnGpu``."""
    for name in ("float", "double"):
        d = np.array([0.0, -0.0, np.nan, 1.0, -np.nan], XX_TYPES[name][0])
        h = H.xxhash64_columns([port_col(name, d, np.ones(5, bool))])
        assert h[0] == h[1] and h[2] == h[4] and h[0] != h[3]
    nulls = port_col("long", np.arange(3, dtype=np.int64), np.zeros(3, bool))
    assert H.xxhash64_columns([nulls]).tolist() == [42] * 3
    c = DeviceColumn(T.DecimalType(20, 0), torch.ones(2, dtype=torch.bool),
                     data=torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(NotOnGpu, match="above 18 digits"):
        H.xxhash64_columns([c])


def _hash_frame(mod, types, session):
    from torch_port_frames import frame

    rng = np.random.default_rng(5)
    sch = types.StructType([
        types.StructField("a", types.INT), types.StructField("b", types.STRING),
        types.StructField("c", types.DOUBLE),
        types.StructField("d", types.DecimalType(9, 2)),
        types.StructField("e", types.DATE)])
    arr = {"a": rng.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32),
           "b": _strings(rng, 40)[:256],
           "c": np.where(rng.random(256) < 0.1, -0.0,
                         rng.normal(0, 1e6, 256)),
           "d": rng.integers(-10 ** 9 + 1, 10 ** 9, 256),
           "e": rng.integers(-1000, 30000, 256).astype(np.int32)}
    valid = {k: rng.random(256) > 0.3 for k in arr}
    return frame(mod, session, arr, sch, valid)


def test_session_hash_expressions_match_the_oracle():
    """``hash_`` and ``xxhash64_`` over one column and over five chained,
    and ``hive_hash`` over the types it takes, equal the reference's CPU
    oracle row for row (also run in a CPU stage: the Project disabled)."""
    import spark_rapids_tpu.session as RS
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu import types as RT
    from spark_rapids_tpu.expr.hashexprs import HiveHash as RHive
    from spark_rapids_tpu_torch.expr.hashexprs import HiveHash
    from torch_port_frames import ORACLE

    def q(mod, types, session, hive):
        df = _hash_frame(mod, types, session)
        return df.select(
            mod.hash_("a").alias("h1"), mod.xxhash64_("b").alias("x1"),
            mod.hash_("a", "b", "c", "d", "e").alias("h5"),
            mod.xxhash64_("a", "b", "c", "d", "e").alias("x5"),
            hive([mod.col("a"), mod.col("b"), mod.col("c"),
                  mod.col("e")]).alias("hv"))

    want = q(RS, RT, RS.TpuSession(ORACLE), RHive).collect()
    for conf in ({}, {"spark.rapids.sql.exec.Project": "false"}):
        got = q(S, T, S.TpuSession(conf, device="cpu"), HiveHash).collect()
        assert got == want, conf

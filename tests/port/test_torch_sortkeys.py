"""``ops/sortkeys.py`` against the JAX package's: ``float_order_key`` over
-0.0, NaNs of several payloads and infinities; ``sort_permutation`` over
multi-key orders with ties (ASC/DESC, NULLS FIRST/LAST, INT, DOUBLE with
-0.0 and NaN, DATE, decimal128); ``group_segments``.  The reference runs
in the child process (its functions compile XLA programs).  Every
comparison is exact."""
import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import sortkeys as SK
from torch_port_jaxref import run_jax

N = 600
#: (ascending, nulls_first) per key column, in column order
SPECS = [[(True, True), (True, True), (True, True), (True, True)],
         [(False, False), (True, False), (False, True), (True, True)],
         [(True, False), (False, False), (True, True), (False, False)],
         [(False, True), (False, True), (False, False), (True, False)]]


def special_floats(rng, n, subnormal=True):
    odd_nans = np.array([0x7FF0000000000001, 0xFFF8000000000005,
                         0x7FF8000000000000], np.uint64).view(np.float64)
    pool = np.concatenate([[0.0, -0.0, np.inf, -np.inf, 1.5, -1.5],
                           odd_nans, rng.normal(size=6)])
    if subnormal:
        pool = np.concatenate([pool, [5e-324, -5e-324]])
    return rng.choice(pool, n)


def key_table(seed):
    """Four key columns with few distinct values each (many ties)."""
    rng = np.random.default_rng(seed)
    big = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, 5)]
    big = [v * 10 ** 9 for v in big] + [0, -1]
    dec = [big[i] for i in rng.integers(0, len(big), N)]
    limbs = np.array([[(v >> 64), ((v & (2 ** 64 - 1)) ^ 2 ** 63) - 2 ** 63]
                      for v in dec], np.int64)
    return {
        "i": (rng.integers(-2, 3, N).astype(np.int32),
              rng.random(N) > 0.15),
        # no subnormals: the reference keys them with 0.0 (see above)
        "f": (special_floats(rng, N, subnormal=False), rng.random(N) > 0.1),
        "d": (rng.integers(18000, 18004, N).astype(np.int32),
              rng.random(N) > 0.1),
        "h": (limbs, rng.random(N) > 0.1)}


TYPES = {"i": T.INT, "f": T.DOUBLE, "d": T.DATE, "h": T.DecimalType(30, 2)}


def test_float_order_key_matches_reference(tmp_path):
    x = special_floats(np.random.default_rng(1), 400)
    out = run_jax("""
        import jax.numpy as jnp
        from spark_rapids_tpu.ops.sortkeys import float_order_key
        out["k"] = np.asarray(float_order_key(jnp.asarray(inp["x"])))
    """, tmp_path, {"x": x})
    got = SK.float_order_key(torch.from_numpy(x)).numpy()
    # the reference's XLA CPU flushes subnormals to zero, so it keys
    # +-5e-324 with 0.0; the port keeps IEEE (and Spark) order there
    sub = (x != 0) & (np.abs(x) < np.finfo(np.float64).tiny)
    assert sub.any()
    np.testing.assert_array_equal(got[~sub], out["k"][~sub])
    np.testing.assert_array_equal(out["k"][sub], 0)
    np.testing.assert_array_equal(got[sub], np.where(x[sub] > 0, 1, -2))
    # Spark's normalisation: -0.0 keys with 0.0, NaNs key alike, largest
    assert len(set(got[x == 0.0])) == 1
    assert len(set(got[np.isnan(x)])) == 1
    assert got[np.isnan(x)][0] > got[~np.isnan(x)].max()


def test_sort_permutation_and_segments_match_reference(tmp_path):
    tab = key_table(2)
    inputs = {}
    for name, (data, valid) in tab.items():
        inputs[name + "_data"], inputs[name + "_valid"] = data, valid
    inputs["specs"] = np.array(SPECS, np.bool_)
    out = run_jax("""
        import jax.numpy as jnp
        from spark_rapids_tpu import types as T
        from spark_rapids_tpu.columnar.column import DeviceColumn
        from spark_rapids_tpu.ops.sortkeys import (SortSpec, pack_sort_keys,
                                                   group_segments,
                                                   sort_permutation)
        types = {"i": T.INT, "f": T.DOUBLE, "d": T.DATE,
                 "h": T.DecimalType(30, 2)}
        cols = [DeviceColumn(t, jnp.asarray(inp[k + "_valid"]),
                             data=jnp.asarray(inp[k + "_data"]))
                for k, t in types.items()]
        n = cols[0].validity.shape[0]
        mask = jnp.ones(n, jnp.bool_)
        for si, spec in enumerate(inp["specs"]):
            specs = [SortSpec(bool(a), bool(nf)) for a, nf in spec]
            perm = sort_permutation(cols, specs, mask)
            out[f"perm{si}"] = np.asarray(perm)
            words = [w[perm] for w in pack_sort_keys(cols, specs, mask)]
            part = jnp.arange(n) < n - 7       # a masked-out tail
            seg, num = group_segments(words, part)
            out[f"seg{si}"], out[f"num{si}"] = np.asarray(seg), np.asarray(num)
    """, tmp_path, inputs)
    cols = [DeviceColumn(TYPES[k], torch.from_numpy(v),
                         data=torch.from_numpy(d))
            for k, (d, v) in tab.items()]
    mask = torch.ones(N, dtype=torch.bool)
    for si, spec in enumerate(SPECS):
        specs = [SK.SortSpec(a, nf) for a, nf in spec]
        perm = SK.sort_permutation(cols, specs, mask)
        np.testing.assert_array_equal(perm.numpy(), out[f"perm{si}"])
        words = [w[perm] for w in SK.pack_sort_keys(cols, specs, mask)]
        seg, num = SK.group_segments(words, torch.arange(N) < N - 7)
        np.testing.assert_array_equal(seg.numpy(), out[f"seg{si}"])
        assert int(num) == int(out[f"num{si}"])


def test_lexsort_matches_numpy_and_segments_of_nothing():
    rng = np.random.default_rng(3)
    keys = [rng.integers(-3, 3, 500) for _ in range(3)]
    perm = SK.lexsort([torch.from_numpy(k) for k in keys])
    np.testing.assert_array_equal(perm.numpy(), np.lexsort(keys[::-1]))
    seg, num = SK.group_segments([torch.zeros(0, dtype=torch.int64)],
                                 torch.zeros(0, dtype=torch.bool))
    assert seg.shape == (0,) and int(num) == 0
    seg, num = SK.group_segments([torch.tensor([4, 4, 5])],
                                 torch.zeros(3, dtype=torch.bool))
    assert int(num) == 0


def test_string_keys_raise():
    """String keys, which raised before the string columns were ported,
    now sort (``test_torch_strings.py``: the reference's words and a
    length word) and hash (``test_torch_hashing.py``: murmur3 against the
    reference's); neither raises."""
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.ops.hashing import spark_partition_ids

    c = DeviceColumn.from_host(HostColumn.from_pylist(["b", None, "a"],
                                                      T.STRING), "cpu")
    perm = SK.sort_permutation([c], [SK.SortSpec()],
                               torch.ones(3, dtype=torch.bool))
    assert perm.tolist() == [1, 2, 0]
    ids = spark_partition_ids([c], 4)
    assert ids.shape == (3,) and int(ids.min()) >= 0 and int(ids.max()) < 4

"""The port's 128-bit limb math against ``spark_rapids_tpu/expr/decimal128.py``
on the same numpy int64 inputs (the JAX side runs jitted in a child
process, see ``torch_port_jaxref``).  Exact equality."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch.expr import decimal128 as D
from torch_port_jaxref import run_jax

I64_MIN, I64_MAX = -(2 ** 63), 2 ** 63 - 1
E18 = 10 ** 18 - 1


def _inputs():
    rng = np.random.default_rng(17)
    edges = np.array([0, 1, -1, E18, -E18, I64_MIN, I64_MAX, I64_MIN + 1,
                      2 ** 32, -(2 ** 32), 2 ** 32 - 1, 10 ** 9], np.int64)
    a = np.concatenate([np.repeat(edges, len(edges)),
                        rng.integers(I64_MIN, I64_MAX, 3000, np.int64)])
    b = np.concatenate([np.tile(edges, len(edges)),
                        rng.integers(I64_MIN, I64_MAX, 3000, np.int64)])
    # sums: decimal(25,4)-sized products plus near-overflow limb pairs
    h = np.concatenate([rng.integers(-2 ** 20, 2 ** 20, 5000, np.int64),
                        np.array([2 ** 62, 2 ** 62, -2 ** 62], np.int64)])
    l = rng.integers(I64_MIN, I64_MAX, len(h), np.int64)
    valid = rng.random(len(h)) < 0.8
    return {"a": a, "b": b, "h": h, "l": l, "valid": valid}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    inp = _inputs()
    out = run_jax("""
        import jax, jax.numpy as jnp
        from spark_rapids_tpu.expr import decimal128 as D
        a, b = jnp.asarray(inp["a"]), jnp.asarray(inp["b"])
        hi, lo = jax.jit(D.mul64_to_128)(a, b)
        out["mul_hi"], out["mul_lo"] = np.asarray(hi), np.asarray(lo)
        h, l = jnp.asarray(inp["h"]), jnp.asarray(inp["l"])
        def sums(h, l, v):
            return D.sum128_global(h, l, v)
        res = jax.jit(sums)(h, l, jnp.asarray(inp["valid"]))
        for k, v in zip(("ok", "any", "hi", "lo"), res):
            out["sum_" + k] = np.asarray(v)
        out["inb38"] = np.asarray(jax.jit(
            lambda h, l: D.in_bounds(h, l, 38))(h, l))
        out["inb25"] = np.asarray(jax.jit(
            lambda h, l: D.in_bounds(h, l, 25))(h >> 40, l))
    """, tmp_path_factory.mktemp("dec128"), inp)
    return inp, out


def test_mul64_to_128(ref):
    inp, out = ref
    hi, lo = D.mul64_to_128(torch.from_numpy(inp["a"]),
                            torch.from_numpy(inp["b"]))
    np.testing.assert_array_equal(hi.numpy(), out["mul_hi"])
    np.testing.assert_array_equal(lo.numpy(), out["mul_lo"])
    for x, y, h, l in zip(inp["a"][:144], inp["b"][:144], hi[:144].tolist(),
                          lo[:144].tolist()):
        assert D.to_py(h, l) == int(x) * int(y)


def test_sum128_global(ref):
    inp, out = ref
    got = D.sum128_global(torch.from_numpy(inp["h"]),
                          torch.from_numpy(inp["l"]),
                          torch.from_numpy(inp["valid"]))
    for k, g in zip(("ok", "any", "hi", "lo"), got):
        np.testing.assert_array_equal(g.numpy(), out["sum_" + k])


def test_in_bounds(ref):
    inp, out = ref
    h, l = torch.from_numpy(inp["h"]), torch.from_numpy(inp["l"])
    np.testing.assert_array_equal(D.in_bounds(h, l, 38).numpy(),
                                  out["inb38"])
    np.testing.assert_array_equal(D.in_bounds(h >> 40, l, 25).numpy(),
                                  out["inb25"])


@pytest.mark.parametrize("k", [0, 1, 4, 9, 13, 20])
def test_pow10_rescale_round_trips(k):
    rng = np.random.default_rng(k)
    v = [int(x) for x in rng.integers(-10 ** 17, 10 ** 17, 200)]
    hi, lo = D.from64(torch.tensor(v, dtype=torch.int64))
    over, h2, l2 = D.mul128_pow10(hi, lo, k)
    assert not over.any()
    assert [D.to_py(a, b) for a, b in zip(h2.tolist(), l2.tolist())] == \
        [x * 10 ** k for x in v]
    h3, l3 = D.div128_pow10_half_up(h2, l2, k)
    assert torch.equal(h3, hi) and torch.equal(l3, lo)

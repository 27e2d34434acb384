"""``ops/segment.py`` against the JAX package's segmented reductions:
``seg_sum``, ``seg_count``, ``seg_min``/``seg_max`` (int32, int64, bool,
and doubles with NaN, where NaN is greatest) and ``seg_first_index``, over
sorted segment ids with empty segments and null values, and over one
segment.  The reference runs in the child process.  Every comparison is
exact; the float sums add values that are exact in any order."""
import numpy as np
import torch

from spark_rapids_tpu_torch.ops import segment as SEG
from torch_port_jaxref import run_jax

N = 700


def seg_inputs(seed, nseg):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, nseg, N)) if nseg > 1 else np.zeros(N)
    f = rng.integers(-8, 8, N) / 4.0
    f[rng.random(N) < 0.1] = np.nan
    # a segment whose valid values are all NaN, one with none valid
    f[seg == 2] = np.nan
    valid = rng.random(N) > 0.2
    valid[seg == 3] = False
    return {"seg": seg.astype(np.int32), "valid": valid,
            "mask": rng.random(N) > 0.1,
            "i32": rng.integers(-2 ** 31, 2 ** 31, N).astype(np.int32),
            "i64": rng.integers(-2 ** 40, 2 ** 40, N),
            "b": rng.random(N) > 0.5, "f": f}


REF = """
import jax.numpy as jnp
from spark_rapids_tpu.ops import segment as SEG
for nseg in (1, 9):
    x = {k: jnp.asarray(v) for k, v in inp.items() if k.endswith(f"_{nseg}")}
    g = lambda k: x[f"{k}_{nseg}"]
    seg, valid = g("seg"), g("valid")
    for name in ("i64", "f"):
        s, has = SEG.seg_sum(g(name), valid, seg, nseg)
        out[f"sum_{name}_{nseg}"], out[f"sumhas_{name}_{nseg}"] = s, has
    out[f"count_{nseg}"] = SEG.seg_count(valid, seg, nseg)
    for name in ("i32", "i64", "b", "f"):
        for fn in ("seg_min", "seg_max"):
            m, has = getattr(SEG, fn)(g(name), valid, seg, nseg, name == "f")
            out[f"{fn}_{name}_{nseg}"] = m
            out[f"{fn}has_{name}_{nseg}"] = has
    out[f"first_{nseg}"] = SEG.seg_first_index(seg, g("mask"), nseg)
out.update({k: np.asarray(v) for k, v in out.items()})
"""


def test_segment_reductions_match_reference(tmp_path):
    inputs = {}
    for nseg in (1, 9):
        for k, v in seg_inputs(nseg, nseg).items():
            inputs[f"{k}_{nseg}"] = v
    out = run_jax(REF, tmp_path, inputs)
    for nseg in (1, 9):
        x = {k[:-len(f"_{nseg}")]: torch.from_numpy(v)
             for k, v in inputs.items() if k.endswith(f"_{nseg}")}
        seg, valid = x["seg"].to(torch.int64), x["valid"]
        for name in ("i64", "f"):
            s, has = SEG.seg_sum(x[name], valid, seg, nseg)
            np.testing.assert_array_equal(s.numpy(),
                                          out[f"sum_{name}_{nseg}"])
            np.testing.assert_array_equal(has.numpy(),
                                          out[f"sumhas_{name}_{nseg}"])
        np.testing.assert_array_equal(
            SEG.seg_count(valid, seg, nseg).numpy(), out[f"count_{nseg}"])
        for name in ("i32", "i64", "b", "f"):
            for fn in ("seg_min", "seg_max"):
                m, has = getattr(SEG, fn)(x[name], valid, seg, nseg,
                                          name == "f")
                want_has = out[f"{fn}has_{name}_{nseg}"]
                np.testing.assert_array_equal(has.numpy(), want_has)
                # a segment with no valid value is null: its data is not
                # compared
                np.testing.assert_array_equal(
                    m.numpy()[want_has], out[f"{fn}_{name}_{nseg}"][want_has])
        np.testing.assert_array_equal(
            SEG.seg_first_index(seg, x["mask"], nseg).numpy(),
            out[f"first_{nseg}"])


def test_nan_rules_and_empty_input():
    seg = torch.tensor([0, 0, 1, 1, 2])
    v = torch.tensor([float("nan"), 1.0, float("nan"), float("nan"), 2.0])
    ok = torch.ones(5, dtype=torch.bool)
    mn, _ = SEG.seg_min(v, ok, seg, 3, True)
    mx, _ = SEG.seg_max(v, ok, seg, 3, True)
    assert mn.tolist()[0] == 1.0 and np.isnan(mn.tolist()[1])
    assert np.isnan(mx.tolist()[0]) and mx.tolist()[2] == 2.0
    empty = torch.zeros(0, dtype=torch.int64)
    none = torch.zeros(0, dtype=torch.bool)
    m, has = SEG.seg_min(empty, none, empty, 1, False)
    assert has.tolist() == [False] and m.shape == (1,)
    s, has = SEG.seg_sum(empty, none, empty, 1)
    assert s.tolist() == [0] and has.tolist() == [False]

"""K1 (bit-unpack / run expansion) of the port against the JAX package.

The plain torch version of K1 is held against the real TPU kernel body
(``_unpack_body`` through ``pl.pallas_call(..., interpret=True)``, built
here because ``_unpack_call`` does not import on this jax), against the
reference's numpy twin ``expand_runs_host`` for every width, and on the
edge cases.  Every comparison is exact.  The CUDA kernel itself is checked
against the plain version by ``test_torch_gpu.py`` and by ``chip_smoke.py``
on the card.
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu.io.parquet_native import \
    split_hybrid_runs as ref_split_hybrid_runs
from spark_rapids_tpu.pallas.decode import expand_runs_host as ref_expand
from spark_rapids_tpu_torch.io.parquet_native import Run, split_hybrid_runs
from spark_rapids_tpu_torch.pallas import decode
from torch_port_data import _varint, hybrid_stream
from torch_port_jaxref import run_jax

PALLAS_WIDTHS = (1, 4, 11, 13, 24)


def port_expand(buf: bytes, bw: int, total: int) -> np.ndarray:
    runs = split_hybrid_runs(buf, bw, total)
    dev = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    out = decode.expand_runs_dev(runs, dev, 0, total, bw)
    assert out.dtype == torch.int32 and out.shape == (total,)
    return out.numpy().astype(np.uint32)


@pytest.fixture(scope="module")
def pallas_outputs(tmp_path_factory):
    """``_unpack_body`` in interpret mode on random payloads, per width."""
    rng = np.random.default_rng(11)
    payloads = {f"p{bw}": rng.integers(0, 256, 700 * bw, dtype=np.uint8)
                for bw in PALLAS_WIDTHS}
    out = run_jax("""
        from functools import partial
        import jax, jax.numpy as jnp
        from jax.experimental import pallas as pl
        from spark_rapids_tpu.pallas.decode import _unpack_body
        for key, payload in inp.items():
            bw = int(key[1:])
            groups = len(payload) // bw
            tiles = 1
            while tiles * 512 < groups:
                tiles *= 2
            mat = np.zeros((tiles * 512, 128), np.uint32)
            mat[:groups, :bw] = payload.reshape(groups, bw)
            fn = jax.jit(pl.pallas_call(
                partial(_unpack_body, bw=bw),
                out_shape=jax.ShapeDtypeStruct(mat.shape, jnp.uint32),
                grid=(tiles,),
                in_specs=[pl.BlockSpec((512, 128), lambda i: (i, 0))],
                out_specs=pl.BlockSpec((512, 128), lambda i: (i, 0)),
                interpret=True))
            out["o" + key[1:]] = np.asarray(fn(mat))[:groups, :8].reshape(-1)
    """, tmp_path_factory.mktemp("pallas"), payloads)
    return payloads, out


@pytest.mark.parametrize("bw", PALLAS_WIDTHS)
def test_plain_matches_pallas_kernel_body(pallas_outputs, bw):
    payloads, out = pallas_outputs
    payload = payloads[f"p{bw}"]
    count = 700 * 8 - 3                       # not a multiple of 8
    run = Run(True, count, 0, 0, len(payload))
    got = decode.unpack_runs_plain(
        torch.from_numpy(payload.copy()), 0,
        {k: torch.from_numpy(v) for k, v in
         decode.run_table([run], count).items()}, bw, count)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  out[f"o{bw}"][:count])


@pytest.mark.parametrize("bw", range(1, 25))
def test_plain_matches_expand_runs_host(bw):
    rng = np.random.default_rng(100 + bw)
    buf, total = hybrid_stream(rng, bw, 20_000, 700)
    runs = split_hybrid_runs(buf, bw, total)
    ref_runs = ref_split_hybrid_runs(buf, bw, total)
    assert [vars(r) for r in runs] == [vars(r) for r in ref_runs]
    # bytes past the cut payload read as zero, which the reference twin
    # (np.frombuffer with the run's full length) needs spelled out
    want = ref_expand(ref_runs, buf + bytes(bw), total, bw)
    np.testing.assert_array_equal(port_expand(buf, bw, total), want)


def test_zero_width_empty_and_all_rle_pages():
    rng = np.random.default_rng(5)
    # bw=0: a single-entry dictionary, every index is 0
    buf = _varint((4 << 1) | 1) + _varint(9 << 1)
    runs = split_hybrid_runs(buf, 0, 41)
    np.testing.assert_array_equal(
        decode.expand_runs_dev(runs, torch.from_numpy(
            np.frombuffer(buf, np.uint8).copy()), 0, 41, 0).numpy(),
        ref_expand(ref_split_hybrid_runs(buf, 0, 41), buf, 41, 0))
    # an empty page
    assert port_expand(b"", 7, 0).shape == (0,)
    # all RLE runs, and more values asked for than the runs hold
    buf, _ = hybrid_stream(rng, 9, 5000, 300, rle_share=1.0)
    total = sum(r.count for r in split_hybrid_runs(buf, 9, 1 << 30)) + 50
    want = ref_expand(ref_split_hybrid_runs(buf, 9, total), buf, total, 9)
    np.testing.assert_array_equal(port_expand(buf, 9, total), want)
    assert want[-50:].sum() == 0


def test_wrapper_rejects_bad_arguments():
    table = {k: torch.from_numpy(v) for k, v in
             decode.run_table([Run(True, 8, 0, 0, 25)], 8).items()}
    buf = torch.zeros(32, dtype=torch.uint8)
    with pytest.raises(ValueError):
        decode.unpack_runs(buf, 0, table, 25, 8)
    with pytest.raises(ValueError):
        decode.unpack_runs(buf, 0, table, 0, 8)
    with pytest.raises(TypeError):
        decode.unpack_runs(buf.to(torch.int32), 0, table, 3, 8)
    bad = dict(table, count=table["count"].to(torch.int32))
    with pytest.raises(TypeError):
        decode.unpack_runs(buf, 0, bad, 3, 8)
    with pytest.raises(ValueError):
        decode.unpack_runs(torch.zeros(64, dtype=torch.uint8)[::2], 0,
                           table, 3, 8)


def test_cpu_tensors_take_the_plain_version():
    before = decode.unpack_launches
    rng = np.random.default_rng(8)
    buf, total = hybrid_stream(rng, 5, 3000, 200)
    port_expand(buf, 5, total)
    assert decode.unpack_launches == before

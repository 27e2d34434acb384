"""K1 (bit-unpack / run expansion) of the port against the JAX package.

The plain torch version of K1 is held against the real TPU kernel body
(``_unpack_body`` through ``pl.pallas_call(..., interpret=True)``, built
here because ``_unpack_call`` does not import on this jax), against the
reference's numpy twin ``expand_runs_host`` for every width, on batches of
pages as the scan hands them to one launch (over the kernel's tiles, at
tile sizes that cut runs), and on the edge cases.  Every comparison is
exact.  The CUDA kernel itself is checked against the plain version by
``test_torch_gpu.py`` and by ``chip_smoke.py`` on the card.
"""
import numpy as np
import pytest
import torch

from spark_rapids_tpu.io.parquet_native import \
    split_hybrid_runs as ref_split_hybrid_runs
from spark_rapids_tpu.pallas.decode import expand_runs_host as ref_expand
from spark_rapids_tpu_torch.io.parquet_native import Run, split_hybrid_runs
from spark_rapids_tpu_torch.pallas import decode
from torch_port_data import _varint, hybrid_stream, page_batch
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
        torch.from_numpy(decode.run_table([run], count, bw)), count)
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
    table = torch.from_numpy(decode.run_table([Run(True, 8, 0, 0, 25)], 8, 3))
    buf = torch.zeros(32, dtype=torch.uint8)
    # widths outside 0..24 never reach a table
    with pytest.raises(ValueError):
        decode.run_table([Run(True, 8, 0, 0, 25)], 8, 25)
    with pytest.raises(ValueError):
        decode.run_table([Run(True, 8, 0, 0, 25)], 8, -1)
    with pytest.raises(TypeError):
        decode.unpack_runs(buf.to(torch.int32), 0, table, 8)
    with pytest.raises(TypeError):
        decode.unpack_runs(buf, 0, table.to(torch.int64), 8)
    with pytest.raises(TypeError):
        decode.unpack_runs(buf, 0, table.reshape(-1), 8)
    with pytest.raises(ValueError):
        decode.unpack_runs(torch.zeros(64, dtype=torch.uint8)[::2], 0,
                           table, 8)
    with pytest.raises(ValueError):
        decode.unpack_runs(buf, 0, torch.zeros((4, 2), dtype=torch.int32).t(),
                           8)
    with pytest.raises(ValueError):
        decode.unpack_runs(buf, 0, table[:0], 8)
    # offsets and counts past the kernel's 32-bit indices raise, never wrap
    for base, total in ((-1, 8), (1 << 31, 8), (0, 1 << 31)):
        with pytest.raises(ValueError):
            decode.unpack_runs(buf, base, table, total)


def test_cpu_tensors_take_the_plain_version():
    before = decode.unpack_launches
    rng = np.random.default_rng(8)
    buf, total = hybrid_stream(rng, 5, 3000, 200)
    port_expand(buf, 5, total)
    assert decode.unpack_launches == before


# Batches of pages, as the scan hands every dictionary page of a chunk to
# one launch: (width, runs) per page.  "spark" pages hold 504-value packed
# runs (63 groups, as parquet-mr and Arrow write them) with the width
# growing from page to page; "ones" pages single-value RLE runs among
# short packed ones; "cut" pages a last payload cut short; "mixed" all of
# them, with a 1-run page and a width-0 page.
BATCHES = {
    "spark": [("spark", 6, 2000), ("spark", 6, 1999), ("spark", 7, 2000),
              ("spark", 9, 1500)],
    "ones": [("ones", 5, 800), ("ones", 11, 700), ("ones", 24, 900)],
    "cut": [("cut", 3, 1200), ("cut", 17, 1000), ("cut", 21, 1100)],
    "mixed": [("one_run", 12, 3000), ("ones", 12, 500), ("zero", 0, 77),
              ("spark", 13, 1300), ("cut", 24, 700), ("one_run", 1, 999)],
}
TILES = (8, 100, 504, decode.TILE)


@pytest.fixture(scope="module")
def batches():
    return {name: page_batch(np.random.default_rng(30 + i), spec)
            for i, (name, spec) in enumerate(BATCHES.items())}


@pytest.fixture(scope="module")
def jax_batch_expansions(batches, tmp_path_factory):
    """The JAX package's ``expand_runs_host`` on every page of every
    batch, run in the child process."""
    inp = {}
    for name, b in batches.items():
        for p, (stream, bw, count) in enumerate(b["pages"]):
            inp[f"{name}:{p}:{bw}:{count}"] = np.frombuffer(
                stream + bytes(max(bw, 1)), np.uint8)
    return run_jax("""
        from spark_rapids_tpu.io.parquet_native import split_hybrid_runs
        from spark_rapids_tpu.pallas.decode import expand_runs_host
        for key, padded in inp.items():
            _, _, bw, count = key.split(":")
            bw, count = int(bw), int(count)
            buf = padded.tobytes()
            runs = split_hybrid_runs(buf[:len(buf) - max(bw, 1)], bw, count)
            out[key] = expand_runs_host(runs, buf, count, bw)
    """, tmp_path_factory.mktemp("batch"), inp)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("name", list(BATCHES))
@pytest.mark.parametrize("lead", [0, 13])
def test_plain_batches_match_expand_runs_host(batches, jax_batch_expansions,
                                              name, tile, lead):
    """One batch table over several pages, its stream ``lead`` bytes into
    the buffer (a base that is no multiple of 16), expanded over tiles
    that cut runs, equals the pages expanded one by one on the host."""
    b = batches[name]
    buf = torch.from_numpy(np.frombuffer(bytes(lead) + b["buf"],
                                         np.uint8).copy())
    got = decode.unpack_runs_plain(buf, lead, torch.from_numpy(b["table"]),
                                   b["total"], tile=tile).numpy()
    want = [ref_expand(ref_split_hybrid_runs(stream, bw, count),
                       stream + bytes(max(bw, 1)), count, bw)
            for stream, bw, count in b["pages"]]
    np.testing.assert_array_equal(got.astype(np.uint32), np.concatenate(want))
    port = [decode.expand_runs_host(split_hybrid_runs(stream, bw, count),
                                    stream + bytes(max(bw, 1)), count, bw)
            for stream, bw, count in b["pages"]]
    np.testing.assert_array_equal(np.concatenate(port), np.concatenate(want))
    jax = [jax_batch_expansions[f"{name}:{p}:{bw}:{count}"]
           for p, (_, bw, count) in enumerate(b["pages"])]
    np.testing.assert_array_equal(np.concatenate(jax), np.concatenate(want))


@pytest.mark.parametrize("name", list(BATCHES))
def test_batch_run_table_is_page_tables_shifted(batches, name):
    b = batches[name]
    table, total = decode.batch_run_table(b["entries"])
    np.testing.assert_array_equal(table, b["table"])
    assert table.dtype == np.int32 and table.shape[1] == 4
    assert total == sum(count for _, _, count in b["pages"])
    parts, got = [], 0
    for runs, count, bw, byte_base, stream_len in b["entries"]:
        t = decode.run_table(runs, count, bw, stream_len).astype(np.int64)
        t[:, 0] += got
        t[:, 2] += byte_base
        parts.append(t)
        got += count
    np.testing.assert_array_equal(table, np.concatenate(parts))
    # out offsets cover [0, total) in order, every row holds values
    counts = table[:, 1].astype(np.int64) & ((1 << 26) - 1)
    np.testing.assert_array_equal(table[:, 0], np.cumsum(counts) - counts)
    assert counts.min() > 0 and counts.sum() == total
    # packed rows stay inside their page's stream
    widths = table[:, 1] >> 26
    ends = table[:, 2].astype(np.int64) + table[:, 3]
    page_end = np.repeat([e[3] + e[4] for e in b["entries"]],
                         [len(decode.run_table(*e[:3], e[4]))
                          for e in b["entries"]])
    assert (ends[widths > 0] <= page_end[widths > 0]).all()


def test_long_runs_split_into_rows(monkeypatch):
    """A run longer than a row's count field takes several rows, packed
    ones cut at whole groups; the values do not change."""
    rng = np.random.default_rng(9)
    buf, total = hybrid_stream(rng, 10, 3000, 900, rle_share=0.5)
    runs = split_hybrid_runs(buf, 10, total)
    want = decode.expand_runs_host(runs, buf + bytes(10), total, 10)
    monkeypatch.setattr(decode, "MAX_ROW_VALUES", 64)
    table = decode.run_table(runs, total, 10)
    assert len(table) > len(runs)
    assert ((table[:, 1] & ((1 << 26) - 1)) <= 64).all()
    got = decode.unpack_runs_plain(
        torch.from_numpy(np.frombuffer(buf, np.uint8).copy()), 0,
        torch.from_numpy(table), total, tile=128)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_batches_past_32_bit_indices_raise():
    with pytest.raises(ValueError):
        decode.batch_run_table([([], 1 << 30, 3, 0, 0), ([], 1 << 30, 3, 0,
                                                         0)])
    with pytest.raises(ValueError):
        decode.batch_run_table([([Run(True, 8, 0, 0, 3)], 8, 3, 1 << 31,
                                 3)])

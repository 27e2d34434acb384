"""The port's torch snappy gather against the JAX package's host twin."""
import numpy as np
import pytest
import torch

from spark_rapids_tpu.pallas.decompress import decompress_to_host
from spark_rapids_tpu_torch.native import snappy_compress, snappy_uncompress
from spark_rapids_tpu_torch.pallas.decompress import (TooFragmented,
                                                      raw_to_device,
                                                      snappy_to_device)


def _streams():
    rng = np.random.default_rng(3)
    yield "rle_chains", np.repeat(rng.integers(0, 256, 400, dtype=np.uint8),
                                  rng.integers(1, 300, 400)).tobytes()
    yield "single_byte", bytes(70_000)
    words = [b"lineitem", b"orders", b"part", b"supp", b"nation"]
    yield "text", b" ".join(words[i] for i in rng.integers(0, 5, 20_000))
    yield "mixed", b"".join(
        rng.integers(0, 256, int(rng.integers(1, 90)),
                     dtype=np.uint8).tobytes() * int(rng.integers(1, 40))
        for _ in range(300))


@pytest.mark.parametrize("name,raw", list(_streams()),
                         ids=[n for n, _ in _streams()])
def test_gather_matches_host_twin(name, raw):
    comp = snappy_compress(raw)
    want = decompress_to_host(comp)
    assert want == raw
    assert snappy_uncompress(comp, len(raw)) == raw
    # a decoded cost above any op overhead: this test is about the bytes
    got = snappy_to_device(comp, torch.device("cpu"),
                           decoded_cost=len(raw) + 12 * len(comp))
    assert got.dtype == torch.uint8
    assert got.numpy().tobytes() == want


def test_dist1_chain_longer_than_a_pass():
    # one literal byte then a copy at distance 1 spanning 1 MiB: the chain
    # needs every pointer-doubling pass
    raw = b"\x07" * (1 << 20)
    got = snappy_to_device(snappy_compress(raw), torch.device("cpu"))
    assert got.numpy().tobytes() == decompress_to_host(
        snappy_compress(raw)) == raw


def test_incompressible_page_routes_to_decoded_transfer():
    raw = np.random.default_rng(9).integers(0, 256, 50_000,
                                            dtype=np.uint8).tobytes()
    comp = snappy_compress(raw)
    with pytest.raises(TooFragmented):
        snappy_to_device(comp, torch.device("cpu"))
    # a decoded cost above the compressed size lets it through
    got = snappy_to_device(comp, torch.device("cpu"),
                           decoded_cost=2 * len(comp))
    assert got.numpy().tobytes() == raw


def test_empty_block_and_raw_region():
    assert snappy_to_device(b"\x00", torch.device("cpu")).shape == (0,)
    assert raw_to_device(b"abc", torch.device("cpu")).tolist() == \
        [97, 98, 99]


def test_malformed_stream_raises():
    with pytest.raises(ValueError):
        snappy_to_device(b"\x05\x09", torch.device("cpu"))

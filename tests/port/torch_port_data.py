"""Random Parquet RLE / bit-packed hybrid streams for the port's K1 tests
(numpy only, so the card-only tests can use it without jax)."""
import numpy as np


def _varint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def hybrid_stream(rng, bw, total, max_run, rle_share=0.4, cut=True):
    """Random RLE/bit-packed runs; the last packed payload is cut short
    when ``cut``.  Returns (bytes, value count <= what the runs hold)."""
    vbytes = (bw + 7) // 8
    parts, got, last_packed = [], 0, None
    while got < total:
        want = int(rng.integers(1, max_run + 1))
        if rng.random() < rle_share:
            value = int(rng.integers(0, 1 << bw)) if bw else 0
            parts.append(_varint(want << 1)
                         + value.to_bytes(vbytes, "little"))
            got += want
        else:
            groups = -(-want // 8)
            parts.append(_varint((groups << 1) | 1))
            parts.append(rng.integers(0, 256, groups * bw,
                                      dtype=np.uint8).tobytes())
            last_packed = len(parts) - 1
            got += groups * 8
    if cut and last_packed is not None:
        p = parts[last_packed]
        parts[last_packed] = p[:max(len(p) - int(rng.integers(1, bw + 1)), 0)]
        parts = parts[:last_packed + 1]
    return b"".join(parts), total - int(rng.integers(0, 8))

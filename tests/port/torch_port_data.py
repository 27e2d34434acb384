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


def _spark_page(rng, bw, count):
    """``count`` values in 504-value bit-packed runs (63 groups), the runs
    parquet-mr and Arrow write."""
    parts, got = [], 0
    while got < count:
        groups = -(-min(504, count - got) // 8)
        parts.append(_varint((groups << 1) | 1)
                     + rng.integers(0, 256, groups * bw,
                                    dtype=np.uint8).tobytes())
        got += groups * 8
    return b"".join(parts), count


def _one_run_page(rng, bw, count):
    groups = -(-count // 8)
    return (_varint((groups << 1) | 1)
            + rng.integers(0, 256, groups * bw, dtype=np.uint8).tobytes(),
            count)


def page_batch(rng, spec):
    """A batch of pages as the scan joins them for one K1 launch.  ``spec``
    holds ``(kind, bw, count)`` per page: kind "spark" (504-value packed
    runs), "ones" (single-value RLE runs among short packed runs), "cut"
    (a last payload cut short), "one_run" (one packed run) or "zero" (a
    width-0 page).  Returns the pages ``(stream, bw, count)``, their
    ``batch_run_table`` entries, the joined stream, the table and the
    value count."""
    from spark_rapids_tpu_torch.io.parquet_native import split_hybrid_runs
    from spark_rapids_tpu_torch.pallas import decode

    pages = []
    for kind, bw, count in spec:
        if kind == "spark":
            stream, count = _spark_page(rng, bw, count)
        elif kind == "ones":
            stream, count = hybrid_stream(rng, bw, count, 3, rle_share=0.8)
        elif kind == "cut":
            stream, count = hybrid_stream(rng, bw, count, 300)
        elif kind == "one_run":
            stream, count = _one_run_page(rng, bw, count)
        else:
            stream = _varint((4 << 1) | 1) + _varint(9 << 1)
        pages.append((stream, bw, count))
    entries, base = [], 0
    for stream, bw, count in pages:
        entries.append((split_hybrid_runs(stream, bw, count), count, bw,
                        base, len(stream)))
        base += len(stream)
    table, total = decode.batch_run_table(entries)
    return {"pages": pages, "entries": entries, "table": table,
            "total": total, "buf": b"".join(p[0] for p in pages)}

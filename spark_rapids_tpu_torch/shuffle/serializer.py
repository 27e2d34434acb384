"""The TKU2 wire format — port of ``spark_rapids_tpu/shuffle/serializer.py``
for flat, string and array columns.

A batch crossing the exchange's host boundary becomes one frame
(little-endian), byte-compatible with the reference's:

    magic  b"TKU2"
    u32    CRC32 of everything after this word
    u32    header_len
    bytes  header: utf-8 JSON {num_rows, cols: [...]}
    buffers back to back, 8-byte aligned, in header order

Per column the header records the kind ("flat", "string" or "array"),
for a flat column the numpy dtype string and the trailing shape (``[2]``
for decimal128 limbs), for a string its longest length (``width``), for
an array its element dtype string and longest list (``ewidth``), and each
buffer's (offset, length).  Validity travels bit-packed (LSB first).  A
string travels ragged: its int32 lengths, then the rows' bytes back to
back, so padding bytes never cross (the C copies of
``native/host_kernels.cpp``); the reader pads them again to the width's
bucket.  An array travels ragged too: its int32 lengths, the elements
inside each row's length back to back, then their validity bit-packed;
the reader pads the rows to the longest list of all the frames, as the
reference's does.  The optional
codec compresses the whole frame: lz4 and zstd go to ``zstandard`` where
it imports, else to zlib level 1, as in the reference (both sides of a
shuffle resolve the codec through the same gate).  A frame whose CRC, magic
or compressed stream is wrong raises ``ShuffleCorruption``.

``deserialize_concat`` assembles many frames into one batch: one host
array per buffer across all frames, then one upload each.  Struct
columns are not ported yet.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    round_up_bucket)
from spark_rapids_tpu_torch.device import DeviceLike, resolve_device
from spark_rapids_tpu_torch.perfcounters import sync_get, to_device

MAGIC = b"TKU2"


class ShuffleCorruption(RuntimeError):
    """A shuffle block failed its integrity check (CRC32 mismatch, bad
    magic, or a codec that rejected the bytes)."""


def resolved_codec(codec: Optional[str]) -> str:
    """The codec that runs for ``codec``: none, zstd or zlib (lz4 and zstd
    go to zstandard where it imports, else to zlib, as in the
    reference)."""
    c = (codec or "none").lower()
    if c in ("none", "uncompressed"):
        return "none"
    if c in ("zstd", "lz4"):
        try:
            import zstandard  # noqa: F401
        except ImportError:
            return "zlib"
        return "zstd"
    if c == "zlib":
        return "zlib"
    raise ValueError(f"unknown shuffle codec {codec}")


def _codec_pair(codec: Optional[str]):
    """(compress, decompress) for ``codec``."""
    c = resolved_codec(codec)
    if c == "zstd":
        import zstandard

        return (zstandard.ZstdCompressor(level=1).compress,
                zstandard.ZstdDecompressor().decompress)
    if c == "zlib":
        return (lambda b: zlib.compress(b, 1)), zlib.decompress
    return (lambda b: b), (lambda b: b)


def _align8(n: int) -> int:
    return (n + 7) & ~7


def serialize_batch(batch: ColumnarBatch,
                    codec: Optional[str] = None) -> bytes:
    """Device batch -> one frame on the host (one host sync for all its
    buffers)."""
    n = batch.num_rows
    header_cols = []
    buffers: List[bytes] = []
    offset = 0

    def add_buffer(raw: bytes) -> Tuple[int, int]:
        nonlocal offset
        off = offset
        buffers.append(raw)
        pad = _align8(len(raw)) - len(raw)
        if pad:
            buffers.append(b"\0" * pad)
        offset += _align8(len(raw))
        return off, len(raw)

    flat = []
    for c in batch.columns:
        if c.is_struct:
            raise NotImplementedError(
                f"serializing {c.dtype.simpleString} columns is not ported")
        flat += [t[:n] for t in c.tensors()]
    host = iter(sync_get(*flat))
    for c in batch.columns:
        validity = next(host)
        vbuf = add_buffer(np.packbits(validity,
                                      bitorder="little").tobytes())
        if c.is_string:
            from spark_rapids_tpu_torch.native import padded_to_ragged

            chars, lengths = next(host), next(host)
            packed, _ = padded_to_ragged(chars, lengths)
            lbuf = add_buffer(lengths.astype(np.int32).tobytes())
            cbuf = add_buffer(packed.tobytes())
            header_cols.append({"kind": "string",
                                "width": int(lengths.max()) if n else 0,
                                "validity": vbuf, "lengths": lbuf,
                                "chars": cbuf})
            continue
        if c.is_array:
            data, lengths, ev = next(host), next(host), next(host)
            lengths = lengths.astype(np.int32)
            take = np.arange(data.shape[1])[None, :] < lengths[:, None]
            lbuf = add_buffer(lengths.tobytes())
            dbuf = add_buffer(np.ascontiguousarray(data[take]).tobytes())
            ebuf = add_buffer(np.packbits(ev[take],
                                          bitorder="little").tobytes())
            header_cols.append({"kind": "array", "dtype": data.dtype.str,
                                "ewidth": int(lengths.max()) if n else 0,
                                "validity": vbuf, "lengths": lbuf,
                                "data": dbuf, "elem_valid": ebuf})
            continue
        data = np.ascontiguousarray(next(host))
        dbuf = add_buffer(data.tobytes())
        header_cols.append({"kind": "flat", "dtype": data.dtype.str,
                            "trail": list(data.shape[1:]),
                            "validity": vbuf, "data": dbuf})
    header = json.dumps({"num_rows": n, "cols": header_cols}).encode()
    payload = b"".join([struct.pack("<I", len(header)), header] + buffers)
    frame = b"".join([MAGIC, struct.pack("<I", zlib.crc32(payload)),
                      payload])
    comp, _ = _codec_pair(codec)
    return comp(frame)


def _parse(frame: bytes):
    """(header, body) of a frame whose magic and CRC hold.  (The
    reference also reads its checksum-less TKU1 frames, which nothing
    writes any more.)"""
    if frame[:4] != MAGIC:
        raise ShuffleCorruption(f"bad shuffle frame magic {frame[:4]!r}")
    (want,) = struct.unpack_from("<I", frame, 4)
    got = zlib.crc32(memoryview(frame)[8:])
    if got != want:
        raise ShuffleCorruption(
            f"shuffle frame CRC mismatch: wrote {want:#010x}, "
            f"read {got:#010x} over {len(frame) - 8} bytes")
    (hlen,) = struct.unpack_from("<I", frame, 8)
    header = json.loads(frame[12: 12 + hlen].decode())
    return header, memoryview(frame)[12 + hlen:]


def _decode_frame(block: bytes, decomp) -> tuple:
    """Decompress and parse one block; a codec that rejects the bytes
    raises the same ``ShuffleCorruption`` as a CRC mismatch."""
    try:
        frame = decomp(block)
    except Exception as e:
        raise ShuffleCorruption(
            f"shuffle block failed to decompress: "
            f"{type(e).__name__}: {e}") from e
    return _parse(frame)


def deserialize_concat(blocks: Sequence[bytes], schema: T.StructType,
                       codec: Optional[str] = None,
                       device: DeviceLike = None) -> ColumnarBatch:
    """Many frames -> ONE batch on ``device``: each buffer assembled on
    the host across all frames, then uploaded once."""
    device = resolve_device(device)
    _, decomp = _codec_pair(codec)
    parsed = [_decode_frame(b, decomp) for b in blocks]
    total = sum(h["num_rows"] for h, _ in parsed)
    cols: List[DeviceColumn] = []
    for ci, f in enumerate(schema.fields):
        if isinstance(f.dataType, T.StringType):
            cols.append(_string_column(parsed, ci, total, device))
            continue
        if isinstance(f.dataType, T.ArrayType):
            cols.append(_array_column(parsed, ci, total, f.dataType, device))
            continue
        if isinstance(f.dataType, T.StructType):
            raise NotImplementedError(
                f"deserializing {f.dataType.simpleString} columns is not "
                "ported")
        sdt = np.dtype(T.storage_dtype(f.dataType))
        trail = tuple(parsed[0][0]["cols"][ci].get("trail", ())) \
            if parsed else ((2,) if isinstance(f.dataType, T.DecimalType)
                            and f.dataType.is_128 else ())
        validity = np.empty(total, dtype=np.bool_)
        data = np.empty((total,) + trail, dtype=sdt)
        k = int(np.prod(trail)) if trail else 1
        row = 0
        for h, body in parsed:
            n = h["num_rows"]
            col = h["cols"][ci]
            validity[row: row + n] = _unpack_validity(body, col, n)
            doff, _ = col["data"]
            data[row: row + n] = np.frombuffer(
                body, np.dtype(col["dtype"]), count=n * k, offset=doff
            ).reshape((n,) + trail)
            row += n
        cols.append(DeviceColumn(f.dataType, to_device(validity, device),
                                 data=to_device(data, device)))
    return ColumnarBatch(cols, total, schema)


def _unpack_validity(body, col, n: int) -> np.ndarray:
    voff, vlen = col["validity"]
    vbits = np.frombuffer(body, np.uint8, count=vlen, offset=voff)
    return np.unpackbits(vbits, count=n, bitorder="little").astype(np.bool_)


def _array_column(parsed, ci: int, total: int, dt: T.ArrayType,
                  device) -> DeviceColumn:
    """Column ``ci`` of the frames as one array column, its rows padded
    to the longest list of all the frames."""
    ew = max([h["cols"][ci]["ewidth"] for h, _ in parsed] + [1])
    sdt = np.dtype(T.storage_dtype(dt.elementType))
    validity = np.empty(total, dtype=np.bool_)
    data = np.zeros((total, ew), dtype=sdt)
    ev = np.zeros((total, ew), dtype=np.bool_)
    lengths = np.empty(total, dtype=np.int32)
    row = 0
    for h, body in parsed:
        n = h["num_rows"]
        col = h["cols"][ci]
        validity[row: row + n] = _unpack_validity(body, col, n)
        loff, _ = col["lengths"]
        lens = np.frombuffer(body, np.int32, count=n, offset=loff)
        lengths[row: row + n] = lens
        total_e = int(lens.sum())
        doff, _ = col["data"]
        eoff, elen = col["elem_valid"]
        take = np.arange(ew)[None, :] < lens[:, None]
        data[row: row + n][take] = np.frombuffer(
            body, np.dtype(col["dtype"]), count=total_e, offset=doff)
        ev[row: row + n][take] = np.unpackbits(
            np.frombuffer(body, np.uint8, count=elen, offset=eoff),
            count=total_e, bitorder="little").astype(np.bool_)
        row += n
    return DeviceColumn(dt, to_device(validity, device),
                        data=to_device(data, device),
                        lengths=to_device(lengths, device),
                        elem_valid=to_device(ev, device))


def _string_column(parsed, ci: int, total: int, device) -> DeviceColumn:
    """Column ``ci`` of the frames as one string column, its chars padded
    to the bucket of the longest length."""
    from spark_rapids_tpu_torch.native import ragged_to_padded

    width = round_up_bucket(max([h["cols"][ci]["width"] for h, _ in parsed]
                                + [1]))
    validity = np.empty(total, dtype=np.bool_)
    chars = np.zeros((total, width), dtype=np.uint8)
    lengths = np.empty(total, dtype=np.int32)
    row = 0
    for h, body in parsed:
        n = h["num_rows"]
        col = h["cols"][ci]
        validity[row: row + n] = _unpack_validity(body, col, n)
        loff, _ = col["lengths"]
        lens = np.frombuffer(body, np.int32, count=n, offset=loff)
        lengths[row: row + n] = lens
        w = col["width"]
        if w:
            coff, clen = col["chars"]
            offs = np.zeros(n + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            chars[row: row + n, :w] = ragged_to_padded(
                np.frombuffer(body, np.uint8, count=clen, offset=coff),
                offs, w)
        row += n
    return DeviceColumn(T.STRING, to_device(validity, device),
                        chars=to_device(chars, device),
                        lengths=to_device(lengths, device))

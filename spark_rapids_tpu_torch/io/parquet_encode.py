"""Parquet ENCODE — port of ``spark_rapids_tpu/io/parquet_encode.py`` for
flat INT32 / INT64 / DATE / TIMESTAMP (INT64 with the TIMESTAMP_MICROS
annotation) columns, decimals of up to 18 digits, stored
as parquet-mr stores them (annotated INT32 up to 9 digits, INT64 above),
and strings as PLAIN BYTE_ARRAY with the UTF8 annotation, as the
reference writes them (no dictionary for strings: the reference's writer
has none).  ``chip_smoke.py`` writes its lineitem, store_sales and orders
files with it; the card's machine has no pyarrow.

Device (torch ops on the writer's device): the dictionary build (sorted
uniques), the index computation (``searchsorted`` into the dictionary) and
the k-bit LSB-first packing of the index stream and of the definition
levels.  Host: thrift compact page headers and footer, snappy framing
through the C compressor (``native.snappy_compress``), file layout.  Each
column chunk is one dictionary page plus one data page holding one
bit-packed run, as in the reference.  ``encode_column`` and
``write_chunks`` are the two halves of ``write_parquet_device``, so a
caller can put chunks of its own making into a file.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.device import DeviceLike, resolve_device
from spark_rapids_tpu_torch.io.parquet_native import (CODEC_SNAPPY,
                                                      CODEC_UNCOMPRESSED,
                                                      ENC_PLAIN, ENC_RLE,
                                                      ENC_RLE_DICT,
                                                      PAGE_DATA, PAGE_DICT,
                                                      TYPE_BYTE_ARRAY,
                                                      TYPE_INT32, TYPE_INT64)
from spark_rapids_tpu_torch.perfcounters import sync_get, to_device

# thrift compact type nibbles
_CT_TRUE, _CT_FALSE, _CT_BYTE = 1, 2, 3
_CT_I16, _CT_I32, _CT_I64, _CT_DOUBLE = 4, 5, 6, 7
_CT_BINARY, _CT_LIST, _CT_SET, _CT_MAP, _CT_STRUCT = 8, 9, 10, 11, 12


class _TW:
    """Minimal thrift compact-protocol WRITER (the reader's inverse)."""

    def __init__(self):
        self.buf = bytearray()

    def varint(self, v: int):
        while True:
            b = v & 0x7F
            v >>= 7
            self.buf.append(b | 0x80 if v else b)
            if not v:
                return

    def zigzag(self, v: int):
        self.varint((v << 1) ^ (v >> 63) if v < 0 else (v << 1))

    def field(self, fid: int, last: int, ctype: int) -> int:
        delta = fid - last
        if 0 < delta < 16:
            self.buf.append((delta << 4) | ctype)
        else:
            self.buf.append(ctype)
            self.zigzag(fid)
        return fid

    def write_i(self, fid: int, last: int, v: int, ctype=_CT_I64) -> int:
        last = self.field(fid, last, ctype)
        self.zigzag(v)
        return last

    def write_bin(self, fid: int, last: int, v: bytes) -> int:
        last = self.field(fid, last, _CT_BINARY)
        self.varint(len(v))
        self.buf += v
        return last

    def write_list_header(self, fid: int, last: int, n: int,
                          etype: int) -> int:
        last = self.field(fid, last, _CT_LIST)
        if n < 15:
            self.buf.append((n << 4) | etype)
        else:
            self.buf.append(0xF0 | etype)
            self.varint(n)
        return last

    def stop(self):
        self.buf.append(0)


# ---------------------------------------------------------------------------
# device ops
# ---------------------------------------------------------------------------

_BYTE_WEIGHTS = [1, 2, 4, 8, 16, 32, 64, 128]


def device_bitpack(values: torch.Tensor, bit_width: int) -> torch.Tensor:
    """k-bit little-endian pack of (n,) nonneg ints (< 2^31) -> uint8."""
    if bit_width == 0:
        return torch.zeros(0, dtype=torch.uint8, device=values.device)
    shifts = torch.arange(bit_width, dtype=torch.int32, device=values.device)
    bits = ((values.to(torch.int32)[:, None] >> shifts[None, :]) & 1)
    flat = bits.reshape(-1).to(torch.uint8)
    pad = (-flat.shape[0]) % 8
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    w = torch.tensor(_BYTE_WEIGHTS, dtype=torch.int32, device=values.device)
    return (flat.view(-1, 8).to(torch.int32) * w).sum(1).to(torch.uint8)


def dict_encode(data: torch.Tensor, mask: torch.Tensor):
    """Sorted dictionary of the valid values and every row's int32 index
    into it (invalid rows index 0)."""
    uniques = torch.unique(data[mask].to(torch.int64), sorted=True)
    if uniques.shape[0] == 0:
        return uniques, torch.zeros(data.shape[0], dtype=torch.int32,
                                    device=data.device)
    pos = torch.searchsorted(uniques, data.to(torch.int64))
    pos = torch.where(mask, pos.clamp(0, uniques.shape[0] - 1), 0)
    return uniques, pos.to(torch.int32)


# ---------------------------------------------------------------------------
# host assembly
# ---------------------------------------------------------------------------

def _hybrid_bitpacked(packed: bytes, n_values: int, bw: int) -> bytes:
    """One bit-packed run of the RLE/bit-packed hybrid."""
    groups = -(-n_values // 8)
    header = bytearray()
    v = (groups << 1) | 1
    while True:
        b = v & 0x7F
        v >>= 7
        header.append(b | 0x80 if v else b)
        if not v:
            break
    need = groups * bw
    body = packed[:need] if len(packed) >= need else \
        packed + b"\0" * (need - len(packed))
    return bytes(header) + body


_PHYS = {T.IntegerType: TYPE_INT32, T.DateType: TYPE_INT32,
         T.LongType: TYPE_INT64, T.TimestampType: TYPE_INT64,
         T.StringType: TYPE_BYTE_ARRAY}
_CONVERTED_UTF8, _CONVERTED_DECIMAL, _CONVERTED_DATE = 0, 5, 6
_CONVERTED_TIMESTAMP_MICROS = 10


def _phys(dt: T.DataType) -> int:
    """Physical type of a supported column: a decimal of up to 9 digits is
    INT32 and one of up to 18 INT64, as parquet-mr writes them."""
    if isinstance(dt, T.DecimalType):
        return TYPE_INT32 if dt.precision <= 9 else TYPE_INT64
    return _PHYS[type(dt)]


def supported_schema(schema: T.StructType) -> bool:
    return all(type(f.dataType) in _PHYS
               or (isinstance(f.dataType, T.DecimalType)
                   and not f.dataType.is_128) for f in schema.fields)


def _page_header(page_type: int, usize: int, csize: int, n_values: int,
                 encoding: int, def_encoding: int = ENC_RLE) -> bytes:
    tw = _TW()
    last = 0
    last = tw.write_i(1, last, page_type, _CT_I32)
    last = tw.write_i(2, last, usize, _CT_I32)
    last = tw.write_i(3, last, csize, _CT_I32)
    if page_type == PAGE_DATA:
        last = tw.field(5, last, _CT_STRUCT)    # data_page_header
        l2 = 0
        l2 = tw.write_i(1, l2, n_values, _CT_I32)
        l2 = tw.write_i(2, l2, encoding, _CT_I32)
        l2 = tw.write_i(3, l2, def_encoding, _CT_I32)   # def level enc
        l2 = tw.write_i(4, l2, ENC_RLE, _CT_I32)        # rep level enc
        tw.stop()
    else:                                       # dictionary page
        last = tw.field(7, last, _CT_STRUCT)    # dictionary_page_header
        l2 = 0
        l2 = tw.write_i(1, l2, n_values, _CT_I32)
        l2 = tw.write_i(2, l2, ENC_PLAIN, _CT_I32)
        tw.stop()
    tw.stop()
    return bytes(tw.buf)


def _compress(codec: int, payload: bytes) -> bytes:
    if codec == CODEC_SNAPPY:
        from spark_rapids_tpu_torch.native import snappy_compress

        return snappy_compress(payload)
    return payload


class ChunkMeta:
    """What the footer records of one column chunk: ``dict_off`` True when
    the chunk starts with a dictionary page; ``data_off`` the first data
    page's offset in the chunk; ``usize`` the headers and uncompressed
    payloads, ``csize`` the chunk's bytes."""

    __slots__ = ("name", "phys", "n", "encodings", "codec",
                 "data_off", "dict_off", "csize", "usize", "dict_usize")


def plain_byte_array(chars: np.ndarray, lens: np.ndarray) -> bytes:
    """Rows of a char matrix as a PLAIN BYTE_ARRAY payload: each value's
    4-byte little-endian length, then its bytes; vectorised scatters, no
    loop over rows."""
    lens = lens.astype(np.int64)
    k = len(lens)
    starts = np.cumsum(lens + 4) - (lens + 4)
    out = np.zeros(int((lens + 4).sum()), np.uint8)
    for b in range(4):
        out[starts + b] = (lens >> (8 * b)) & 0xFF
    total = int(lens.sum())
    if total:
        rows = np.repeat(np.arange(k), lens)
        within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        out[np.repeat(starts + 4, lens) + within] = chars[rows, within]
    return out.tobytes()


def encode_column(f: T.StructField, col, n: int, codec: int,
                  use_dict: bool, device):
    """One column chunk -> (pages bytes, ChunkMeta).  ``col`` carries
    numpy ``validity`` and ``data`` (a string ``chars`` and ``lengths``);
    a string is always PLAIN."""
    phys = _phys(f.dataType)
    nullable = bool(f.nullable)
    validity = np.asarray(col.validity[:n], np.bool_)
    mask = to_device(validity, device)

    def_bytes = b""
    if nullable:
        (packed,) = sync_get(device_bitpack(mask.to(torch.int32), 1))
        def_bytes = _hybrid_bitpacked(packed.tobytes(), n, 1)
        def_bytes = struct.pack("<I", len(def_bytes)) + def_bytes

    pages = bytearray()
    meta = ChunkMeta()
    meta.name = f.name
    meta.phys = phys
    meta.n = n
    meta.codec = codec
    meta.dict_off = None
    wire = "<i4" if phys == TYPE_INT32 else "<i8"
    if phys == TYPE_BYTE_ARRAY:
        keep = validity if nullable else np.ones(n, np.bool_)
        payload = def_bytes + plain_byte_array(
            np.asarray(col.chars[:n])[keep], np.asarray(col.lengths[:n])[keep])
        meta.encodings = [ENC_PLAIN, ENC_RLE]
        enc = ENC_PLAIN
    elif use_dict:
        data = to_device(np.asarray(col.data[:n]), device)
        uniques, idx = dict_encode(data, mask)
        n_uniq = int(uniques.shape[0])
        bw = max((n_uniq - 1).bit_length(), 1)
        if nullable:
            # v1 data pages hold only the DEFINED values
            idx = idx[mask]
        n_defined = int(idx.shape[0])
        packed, uvals = sync_get(device_bitpack(idx, bw), uniques)
        dict_payload = uvals.astype(wire).tobytes()
        cdict = _compress(codec, dict_payload)
        meta.dict_off = True
        dict_header = _page_header(PAGE_DICT, len(dict_payload),
                                   len(cdict), n_uniq, ENC_PLAIN)
        pages += dict_header
        pages += cdict
        meta.dict_usize = len(dict_header) + len(dict_payload)
        body = bytes([bw]) + _hybrid_bitpacked(packed.tobytes(),
                                               n_defined, bw)
        payload = def_bytes + body
        meta.encodings = [ENC_RLE_DICT, ENC_PLAIN, ENC_RLE]
        enc = ENC_RLE_DICT
    else:
        data = np.asarray(col.data[:n])
        if nullable:
            data = data[validity]
        payload = def_bytes + data.astype(wire).tobytes()
        meta.encodings = [ENC_PLAIN, ENC_RLE]
        enc = ENC_PLAIN

    cpayload = _compress(codec, bytes(payload))
    header = _page_header(PAGE_DATA, len(payload), len(cpayload), n, enc)
    data_page_pos = len(pages)
    pages += header
    pages += cpayload
    # total_uncompressed_size = page headers + UNCOMPRESSED payloads
    meta.usize = (getattr(meta, "dict_usize", 0) + len(header)
                  + len(payload))
    meta.csize = len(pages)
    meta.data_off = data_page_pos
    return bytes(pages), meta


def write_parquet_device(path: str, schema: T.StructType, cols, n: int,
                         compression: str = "snappy",
                         use_dict: bool = True,
                         device: DeviceLike = None) -> Dict[str, int]:
    """Write one parquet file (one row group) with pages encoded on
    ``device`` (``cuda`` unless the caller names another; no GPU and no
    device raises).  ``cols`` are host columns (``.validity``, ``.data``).
    Returns stats for tests and metrics."""
    device = resolve_device(device)
    if not supported_schema(schema):
        raise TypeError("the port's writer takes INT32/INT64/DATE/"
                        "TIMESTAMP, "
                        "decimal(p<=18) and string columns only: "
                        f"{schema.simpleString}")
    codec = CODEC_SNAPPY if compression == "snappy" \
        else CODEC_UNCOMPRESSED
    return write_chunks(path, schema, [
        encode_column(f, c, n, codec, use_dict, device)
        for f, c in zip(schema.fields, cols)], n)


def write_chunks(path: str, schema: T.StructType, chunks, n: int
                 ) -> Dict[str, int]:
    """One file of one row group from its encoded column chunks
    (``encode_column``'s ``(pages, meta)`` pairs, in schema order)."""
    out = bytearray(b"PAR1")
    chunk_metas: List[Tuple[ChunkMeta, int]] = []
    for pages, meta in chunks:
        chunk_metas.append((meta, len(out)))
        out += pages

    # ---- footer ----
    tw = _TW()
    last = 0
    last = tw.write_i(1, last, 1, _CT_I32)               # version
    # schema: root + one element per field
    last = tw.write_list_header(2, last, 1 + len(schema.fields),
                                _CT_STRUCT)
    root = _TW()
    r_last = 0
    r_last = root.write_bin(4, r_last, b"schema")
    r_last = root.write_i(5, r_last, len(schema.fields), _CT_I32)
    tw.buf += root.buf
    tw.stop()
    for f in schema.fields:
        el = _TW()
        e_last = 0
        e_last = el.write_i(1, e_last, _phys(f.dataType), _CT_I32)
        e_last = el.write_i(3, e_last, 1 if f.nullable else 0, _CT_I32)
        e_last = el.write_bin(4, e_last, f.name.encode())
        if isinstance(f.dataType, T.DateType):
            e_last = el.write_i(6, e_last, _CONVERTED_DATE, _CT_I32)
        elif isinstance(f.dataType, T.TimestampType):
            e_last = el.write_i(6, e_last, _CONVERTED_TIMESTAMP_MICROS,
                                _CT_I32)
        elif isinstance(f.dataType, T.StringType):
            e_last = el.write_i(6, e_last, _CONVERTED_UTF8, _CT_I32)
        elif isinstance(f.dataType, T.DecimalType):
            e_last = el.write_i(6, e_last, _CONVERTED_DECIMAL, _CT_I32)
            e_last = el.write_i(7, e_last, f.dataType.scale, _CT_I32)
            e_last = el.write_i(8, e_last, f.dataType.precision, _CT_I32)
        tw.buf += el.buf
        tw.stop()
    last = tw.write_i(3, last, n, _CT_I64)               # num_rows
    # one row group
    last = tw.write_list_header(4, last, 1, _CT_STRUCT)
    rg = _TW()
    g_last = 0
    g_last = rg.write_list_header(1, g_last, len(chunk_metas), _CT_STRUCT)
    total = 0
    for meta, base in chunk_metas:
        cc = _TW()
        c_last = 0
        c_last = cc.write_i(2, c_last, base, _CT_I64)    # file_offset
        c_last = cc.field(3, c_last, _CT_STRUCT)         # meta_data
        m = _TW()
        m_last = 0
        m_last = m.write_i(1, m_last, meta.phys, _CT_I32)
        m_last = m.write_list_header(2, m_last, len(meta.encodings),
                                     _CT_I32)
        for e in meta.encodings:
            m.zigzag(e)
        m_last = m.write_list_header(3, m_last, 1, _CT_BINARY)
        m.varint(len(meta.name.encode()))
        m.buf += meta.name.encode()
        m_last = m.write_i(4, m_last, meta.codec, _CT_I32)
        m_last = m.write_i(5, m_last, meta.n, _CT_I64)   # num_values
        m_last = m.write_i(6, m_last, meta.usize, _CT_I64)
        m_last = m.write_i(7, m_last, meta.csize, _CT_I64)
        m_last = m.write_i(9, m_last, base + meta.data_off, _CT_I64)
        if meta.dict_off is not None:
            # field 11: dictionary_page_offset (10 is index_page_offset)
            m_last = m.write_i(11, m_last, base, _CT_I64)
        cc.buf += m.buf
        cc.buf.append(0)        # end meta_data struct
        rg.buf += cc.buf
        rg.buf.append(0)        # end column chunk struct
        total += meta.csize
    g_last = rg.write_i(2, g_last, total, _CT_I64)       # total_byte_size
    g_last = rg.write_i(3, g_last, n, _CT_I64)           # num_rows
    tw.buf += rg.buf
    tw.stop()                                            # end row group
    last = tw.write_bin(6, last, b"spark-rapids-tpu-torch device encoder")
    tw.stop()                                            # end FileMetaData

    footer = bytes(tw.buf)
    out += footer
    out += struct.pack("<I", len(footer))
    out += b"PAR1"
    with open(path, "wb") as fh:
        fh.write(out)
    return {"bytes": len(out), "columns": len(chunk_metas)}

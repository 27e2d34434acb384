"""Native Parquet page reader — the port's copy of
``spark_rapids_tpu/io/parquet_native.py`` (host only, numpy and stdlib).

A thrift-compact FileMetaData/PageHeader parser, page walker, and
RLE/bit-packed-hybrid RUN SPLITTER.  The device half
(``pallas/decode.py``) expands the runs with the K1 kernel and gathers
dictionaries.  Host work is O(#pages + #runs), never O(#values): run
headers are varints scanned on the host; value bytes upload untouched.

Supported subset: non-nested columns of INT32/INT64/DOUBLE/FLOAT/BOOLEAN
and BYTE_ARRAY, data pages v1 and v2, PLAIN or
RLE_DICTIONARY/PLAIN_DICTIONARY encodings, UNCOMPRESSED or SNAPPY
(``native/host_kernels.cpp``).  A BYTE_ARRAY dictionary page parses on
the host into a padded char matrix and its lengths (``dict_chars``,
``dict_lens``); a data page keeps its value bytes (``value_buf``: the
dictionary indices, or a PLAIN page's interleaved lengths and bytes) for
the device decode.  Anything else raises ``_Unsupported``; the port has
no host decode to fall back to.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"PAR1"

# thrift compact type ids
_CT_STOP = 0
_CT_TRUE = 1
_CT_FALSE = 2
_CT_BYTE = 3
_CT_I16 = 4
_CT_I32 = 5
_CT_I64 = 6
_CT_DOUBLE = 7
_CT_BINARY = 8
_CT_LIST = 9
_CT_SET = 10
_CT_MAP = 11
_CT_STRUCT = 12


class _Thrift:
    """Minimal thrift compact-protocol reader -> {field_id: value} dicts."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        shift = acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not b & 0x80:
                return acc
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_value(self, ctype: int):
        if ctype in (_CT_TRUE, _CT_FALSE):
            return ctype == _CT_TRUE
        if ctype == _CT_BYTE:
            v = self.buf[self.pos]
            self.pos += 1
            return v - 256 if v >= 128 else v
        if ctype in (_CT_I16, _CT_I32, _CT_I64):
            return self.zigzag()
        if ctype == _CT_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ctype == _CT_BINARY:
            n = self.varint()
            v = self.buf[self.pos:self.pos + n]
            self.pos += n
            return v
        if ctype == _CT_LIST or ctype == _CT_SET:
            head = self.buf[self.pos]
            self.pos += 1
            size = head >> 4
            etype = head & 0x0F
            if size == 15:
                size = self.varint()
            return [self.read_value(etype) for _ in range(size)]
        if ctype == _CT_STRUCT:
            return self.read_struct()
        if ctype == _CT_MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            kt, vt = kv >> 4, kv & 0x0F
            return {self.read_value(kt): self.read_value(vt)
                    for _ in range(size)}
        raise ValueError(f"thrift compact type {ctype}")

    def read_struct(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        last_id = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == _CT_STOP:
                return out
            delta = head >> 4
            ctype = head & 0x0F
            if delta == 0:
                fid = self.zigzag()
            else:
                fid = last_id + delta
            last_id = fid
            if ctype in (_CT_TRUE, _CT_FALSE):
                out[fid] = ctype == _CT_TRUE
            else:
                out[fid] = self.read_value(ctype)


# parquet enums (format/parquet.thrift)
TYPE_BOOLEAN, TYPE_INT32, TYPE_INT64 = 0, 1, 2
TYPE_FLOAT, TYPE_DOUBLE, TYPE_BYTE_ARRAY = 4, 5, 6
ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE = 0, 2, 3
ENC_RLE_DICT = 8
CODEC_UNCOMPRESSED, CODEC_SNAPPY, CODEC_ZSTD = 0, 1, 6
PAGE_DATA, PAGE_DICT, PAGE_DATA_V2 = 0, 2, 3


@dataclasses.dataclass
class ColumnInfo:
    name: str
    ptype: int
    optional: bool
    codec: int
    encodings: List[int]
    num_values: int
    data_page_offset: int
    dict_page_offset: Optional[int]
    total_compressed: int


@dataclasses.dataclass
class RowGroupInfo:
    num_rows: int
    columns: List[ColumnInfo]


@dataclasses.dataclass
class Run:
    """One RLE/bit-packed hybrid run (host-parsed header, device-expanded
    payload)."""

    is_packed: bool
    count: int        # values in the run
    value: int        # RLE repeated value (is_packed=False)
    byte_off: int     # payload offset into the level/index buffer
    nbytes: int


def read_footer(data: bytes) -> Tuple[List[RowGroupInfo], List[str]]:
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ValueError("not a parquet file")
    flen = struct.unpack_from("<I", data, len(data) - 8)[0]
    if flen > len(data) - 12:
        err = ValueError(
            f"parquet footer truncated (footer length {flen} exceeds "
            f"file size {len(data)})")
        err.srt_offset = len(data) - 8
        raise err
    try:
        return _read_footer_meta(data, flen)
    except (IndexError, struct.error, KeyError, TypeError) as e:
        # byte-offset context for the fault classifier / quarantine
        err = ValueError(
            f"corrupt parquet footer metadata near byte "
            f"{len(data) - 8 - flen} ({type(e).__name__}: {e})")
        err.srt_offset = len(data) - 8 - flen
        raise err from e


def _read_footer_meta(data: bytes, flen: int):
    meta = _Thrift(data, len(data) - 8 - flen).read_struct()
    schema = meta[2]
    # schema[0] is the root; leaves follow in order (non-nested only)
    names, optional, ptypes = [], {}, {}
    for el in schema[1:]:
        name = el[4].decode()
        names.append(name)
        optional[name] = el.get(3, 0) == 1  # repetition OPTIONAL
        ptypes[name] = el.get(1)
    groups = []
    for rg in meta[4]:
        cols = []
        for cc in rg[1]:
            md = cc[3]
            path = b".".join(md[3]).decode()
            cols.append(ColumnInfo(
                name=path, ptype=md[1],
                optional=optional.get(path, True),
                codec=md[4], encodings=md[2], num_values=md[5],
                data_page_offset=md[9],
                dict_page_offset=md.get(11),
                total_compressed=md[7]))
        groups.append(RowGroupInfo(num_rows=rg[3], columns=cols))
    return groups, names


def _decompress(buf: bytes, codec: int, usize: int) -> bytes:
    if codec == CODEC_UNCOMPRESSED:
        return buf
    if codec == CODEC_SNAPPY:
        from spark_rapids_tpu_torch.native import snappy_uncompress

        return snappy_uncompress(buf, usize)
    raise _Unsupported(f"codec {codec}")


class _Unsupported(Exception):
    """Feature outside the device-decode subset (the scan raises it)."""


def split_hybrid_runs(buf: bytes, bit_width: int,
                      total: int) -> List[Run]:
    """Parse RLE/bit-packed hybrid run headers (no value decode)."""
    runs: List[Run] = []
    t = _Thrift(buf)
    got = 0
    vbytes = (bit_width + 7) // 8
    while got < total and t.pos < len(buf):
        header = t.varint()
        if header & 1:
            groups = header >> 1
            count = groups * 8
            nbytes = groups * bit_width
            runs.append(Run(True, min(count, total - got), 0, t.pos,
                            nbytes))
            t.pos += nbytes
        else:
            count = header >> 1
            raw = buf[t.pos:t.pos + vbytes]
            value = int.from_bytes(raw, "little") if vbytes else 0
            runs.append(Run(False, min(count, total - got), value, t.pos,
                            vbytes))
            t.pos += vbytes
        got += runs[-1].count
    return runs


@dataclasses.dataclass
class PageData:
    """One decoded-on-host-STRUCTURE data page: raw bytes stay packed.

    The ``raw_*`` fields (compressed transfer) describe the page
    region AS STORED IN THE FILE so the device path can ship compressed
    bytes across the link and decompress them there: ``raw_values`` is
    the stored bytes covering the value stream (the whole page for v1;
    the separately-compressed values region for v2), ``raw_usize`` its
    decompressed size, ``value_off``/``def_off`` the byte offsets of the
    value / definition-level payloads inside the DECOMPRESSED region
    (``def_off`` None when the levels live outside it — v2, or a
    required column)."""

    num_values: int
    encoding: int
    def_runs: Optional[List[Run]]   # None: required column
    def_buf: Optional[bytes]
    value_buf: bytes                # PLAIN values or packed indices
    index_bit_width: int            # dictionary index width (dict pages)
    raw_values: Optional[bytes] = None
    raw_codec: int = CODEC_UNCOMPRESSED
    raw_usize: int = 0
    value_off: int = 0
    def_off: Optional[int] = None


@dataclasses.dataclass
class ColumnPages:
    info: ColumnInfo
    dictionary: Optional[np.ndarray]  # decoded dict values (PLAIN, host view)
    pages: List[PageData]
    # BYTE_ARRAY dictionaries: padded (ndict, width) uint8 + per-entry len
    dict_chars: Optional[np.ndarray] = None
    dict_lens: Optional[np.ndarray] = None


_PLAIN_DTYPES = {TYPE_INT32: np.int32, TYPE_INT64: np.int64,
                 TYPE_FLOAT: np.float32, TYPE_DOUBLE: np.float64}


def _parse_byte_array_dict(raw: bytes, n: int):
    """PLAIN byte_array dictionary page -> (padded chars, lengths)."""
    lens = np.empty(n, np.int32)
    offs = np.empty(n, np.int64)
    pos = 0
    for i in range(n):
        ln = struct.unpack_from("<I", raw, pos)[0]
        lens[i] = ln
        offs[i] = pos + 4
        pos += 4 + ln
    w = max(int(lens.max()) if n else 1, 1)
    chars = np.zeros((max(n, 1), w), np.uint8)
    buf = np.frombuffer(raw, np.uint8)
    for i in range(n):
        chars[i, :lens[i]] = buf[offs[i]: offs[i] + lens[i]]
    return chars, lens


def read_column_pages(data: bytes, info: ColumnInfo,
                      num_rows: int) -> ColumnPages:
    if (info.ptype not in _PLAIN_DTYPES
            and info.ptype not in (TYPE_BOOLEAN, TYPE_BYTE_ARRAY)):
        raise _Unsupported(f"parquet type {info.ptype}")
    start = (info.dict_page_offset
             if info.dict_page_offset is not None
             and 0 < info.dict_page_offset < info.data_page_offset
             else info.data_page_offset)
    pos = start
    end = start + info.total_compressed
    dictionary = None
    dict_chars = dict_lens = None
    pages: List[PageData] = []
    values_seen = 0
    while pos < end and values_seen < info.num_values:
        try:
            t = _Thrift(data, pos)
            header = t.read_struct()
        except (IndexError, struct.error) as e:
            # byte-offset context for the fault classifier / quarantine
            err = ValueError(
                f"corrupt parquet page header for column "
                f"{info.name!r} near byte {pos} "
                f"({type(e).__name__}: {e})")
            err.srt_offset = pos
            raise err from e
        pos = t.pos
        ptype = header[1]
        usize = header[2]
        csize = header[3]
        page_raw = data[pos:pos + csize]
        pos += csize
        if ptype == PAGE_DICT:
            raw = _decompress(page_raw, info.codec, usize)
            dph = header[7]
            n = dph[1]
            if info.ptype == TYPE_BOOLEAN:
                raise _Unsupported("boolean dictionary")
            if info.ptype == TYPE_BYTE_ARRAY:
                dict_chars, dict_lens = _parse_byte_array_dict(raw, n)
                dictionary = np.arange(n)  # presence marker
            else:
                dictionary = np.frombuffer(
                    raw, _PLAIN_DTYPES[info.ptype], count=n)
            continue
        if ptype == PAGE_DATA_V2:
            # v2: def/rep levels sit UNCOMPRESSED before the (optionally
            # compressed) values; def levels have no 4-byte length prefix
            dp2 = header[8]
            nvals = dp2[1]
            enc = dp2[4]
            dll = dp2.get(5, 0) or 0
            rll = dp2.get(6, 0) or 0
            if rll:
                raise _Unsupported("repetition levels (nested)")
            compressed = dp2.get(7, True)
            def_runs = None
            def_buf = None
            if info.optional and dll:
                def_buf = page_raw[:dll]
                def_runs = split_hybrid_runs(def_buf, 1, nvals)
            vraw_stored = page_raw[dll + rll:]
            vraw = vraw_stored
            if compressed:
                vraw = _decompress(vraw, info.codec, usize - dll - rll)
            off = 0
            ibw = 0
            if enc in (ENC_PLAIN_DICT, ENC_RLE_DICT):
                ibw = vraw[off]
                off += 1
            elif enc != ENC_PLAIN:
                raise _Unsupported(f"encoding {enc}")
            pages.append(PageData(
                nvals, enc, def_runs, def_buf, vraw[off:], ibw,
                raw_values=vraw_stored,
                raw_codec=info.codec if compressed else CODEC_UNCOMPRESSED,
                raw_usize=len(vraw), value_off=off, def_off=None))
            values_seen += nvals
            continue
        if ptype != PAGE_DATA:
            raise _Unsupported(f"page type {ptype}")
        raw = _decompress(page_raw, info.codec, usize)
        dp = header[5]
        nvals = dp[1]
        enc = dp[2]
        off = 0
        def_runs = None
        def_buf = None
        if info.optional:
            if dp[3] != ENC_RLE:
                raise _Unsupported("definition level encoding")
            dlen = struct.unpack_from("<I", raw, 0)[0]
            def_buf = raw[4:4 + dlen]
            def_runs = split_hybrid_runs(def_buf, 1, nvals)
            off = 4 + dlen
        ibw = 0
        if enc in (ENC_PLAIN_DICT, ENC_RLE_DICT):
            ibw = raw[off]
            off += 1
        elif enc != ENC_PLAIN:
            raise _Unsupported(f"encoding {enc}")
        pages.append(PageData(
            nvals, enc, def_runs, def_buf, raw[off:], ibw,
            raw_values=page_raw, raw_codec=info.codec, raw_usize=len(raw),
            value_off=off,
            def_off=4 if def_runs is not None else None))
        values_seen += nvals
    return ColumnPages(info, dictionary, pages, dict_chars, dict_lens)

"""Device-side Parquet column assembly — port of
``spark_rapids_tpu/io/parquet_device.py`` for numeric and string columns.

The host half (``io/parquet_native.py``) parses footers, page headers and
run headers; the device half expands runs and unpacks bits with the K1
kernel (``pallas/decode.py``) and gathers dictionary values.

With compressed transfer on, each eligible chunk ships its pages' STORED
bytes and decompresses them on the device (``pallas/decompress.py``); a
chunk whose pages fall outside that subset, or whose compressed form is no
lighter (``TooFragmented``), ships decoded pages instead
(``chunk_decode_fallbacks``).  Both routes decode the indices of all the
dictionary pages of a chunk with one K1 launch over a joined byte buffer
and one run table (``pallas/decode.py::batch_run_table``).  A
feature outside the supported subset raises ``_Unsupported``: the port has
no host decode to fall back to.

A BYTE_ARRAY column decodes to a string column.  Its dictionary pages'
indices go through K1 as a numeric column's do, one launch a chunk; a
PLAIN page (the pages parquet-mr writes once a dictionary overflows, or a
writer without dictionaries) walks its lengths on the host in C and
becomes a page-local char matrix.  Each file's dictionaries and page
matrices are stacked on the host at the bucket of the longest value, with
a zero row for the nulls, uploaded once, and gathered once by the rows'
indices on the device.  A PLAIN string page has no compressed-transfer
route (its interleaved lengths need the host walk): its chunk ships
decoded pages (``chunk_decode_fallbacks``), as in the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    column_torch_dtype,
                                                    round_up_bucket,
                                                    torch_dtype)
from spark_rapids_tpu_torch.io.parquet_native import (
    CODEC_SNAPPY,
    CODEC_UNCOMPRESSED,
    ENC_PLAIN,
    ENC_PLAIN_DICT,
    ENC_RLE_DICT,
    TYPE_BOOLEAN,
    TYPE_BYTE_ARRAY,
    TYPE_FLOAT,
    TYPE_INT32,
    TYPE_INT64,
    _PLAIN_DTYPES,
    _Unsupported,
    read_column_pages,
    read_footer,
    split_hybrid_runs,
)
from spark_rapids_tpu_torch.pallas.decode import (
    MAX_BIT_WIDTH,
    batch_run_table,
    expand_runs_dev,
    expand_runs_host,
    expand_table_dev,
    unpack_bitpacked_dev,
)
from spark_rapids_tpu_torch.pallas.decompress import (
    TooFragmented,
    raw_to_device,
    snappy_to_device,
)


class _CompressedUnsupported(Exception):
    """Page outside the compressed-transfer subset: the caller re-decodes
    the CHUNK through the decoded transfer (same values, more link bytes)."""


_OK_TYPES = {
    TYPE_INT32: (T.IntegerType, T.DateType, T.ByteType, T.ShortType,
                 T.DecimalType),
    TYPE_INT64: (T.LongType, T.TimestampType, T.DecimalType),
    TYPE_FLOAT: (T.FloatType,),
    5: (T.DoubleType,),          # TYPE_DOUBLE
    TYPE_BOOLEAN: (T.BooleanType,),
    TYPE_BYTE_ARRAY: (T.StringType,),
}


def _check_field(info, dt: T.DataType):
    ok = _OK_TYPES.get(info.ptype)
    if ok is None or not isinstance(dt, ok):
        raise _Unsupported(
            f"column {info.name}: parquet type {info.ptype} as "
            f"{dt.simpleString}")
    if isinstance(dt, T.DecimalType) and dt.is_128:
        raise _Unsupported("decimal128 device decode")


def expand_defined(page, device):
    """Definition levels -> (defined bool tensor, ndef): host expansion of
    the 1-bit stream, uploaded as a bool vector."""
    levels, ndef = _host_levels(page)
    if levels is None:
        return torch.ones(ndef, dtype=torch.bool, device=device), ndef
    return PC.to_device(levels, device), ndef


def _host_levels(page):
    """-> (bool definition levels, or None for a required column; ndef)."""
    n = page.num_values
    if page.def_runs is None:
        return None, n
    levels = expand_runs_host(page.def_runs, page.def_buf, n, 1)
    levels = levels.astype(np.bool_)
    return levels, int(levels.sum())


def _page_dev_region(page, device) -> torch.Tensor:
    """Ship the page's STORED bytes and return the decompressed region as a
    device uint8 tensor (the compressed-transfer entry point)."""
    if page.raw_values is None:
        raise _CompressedUnsupported("no stored-page bytes recorded")
    if page.raw_codec == CODEC_UNCOMPRESSED:
        return raw_to_device(page.raw_values, device)
    if page.raw_codec == CODEC_SNAPPY:
        # what the decoded transfer would ship: the value payload plus
        # (when the levels live inside the region) the defined vector
        decoded_cost = len(page.value_buf) + (
            page.num_values if page.def_off is not None else 0)
        return snappy_to_device(page.raw_values, device, decoded_cost)
    raise _CompressedUnsupported(
        f"codec {page.raw_codec} has no device decompressor")


def _expand_defined_dev(page, dev_region):
    """Compressed-path twin of :func:`expand_defined`: v1 levels expand on
    the device from the decompressed region; the defined COUNT comes from
    the host-parsed runs, which costs neither a transfer nor a sync."""
    device = dev_region.device
    n = page.num_values
    levels, ndef = _host_levels(page)
    if levels is None:
        return torch.ones(n, dtype=torch.bool, device=device), n
    if page.def_off is not None:
        lv = expand_runs_dev(page.def_runs, dev_region, page.def_off, n, 1)
        return lv.to(torch.bool), ndef
    # v2: levels sit uncompressed outside the values region
    return PC.to_device(levels, device), ndef


def scatter_present(vals, defined, ndef, n):
    """Compacted present values -> row positions (null rows zero-filled)."""
    if ndef == n:
        return vals
    if ndef == 0:
        return torch.zeros(n, dtype=vals.dtype, device=vals.device)
    pos = torch.cumsum(defined.to(torch.int64), 0) - 1
    safe = pos.clamp(0, ndef - 1)
    return torch.where(defined, vals[safe], torch.zeros((), dtype=vals.dtype,
                                                        device=vals.device))


def _dict_values(dictionary_dev, idx):
    n = int(dictionary_dev.shape[0])
    if n == 0:
        raise _Unsupported("empty dictionary")
    return torch.index_select(dictionary_dev, 0, idx.clamp(0, n - 1))


def _check_dict_pages(pages, dictionary_dev):
    if dictionary_dev is None:
        raise _Unsupported("dictionary page missing")
    for page in pages:
        if page.index_bit_width > MAX_BIT_WIDTH:
            raise _Unsupported(
                f"dictionary index width {page.index_bit_width}")


def _join_defined(parts, dev_levels, device):
    """Per-page definition levels -> one bool vector over the pages.
    ``parts`` holds ``(n, src)`` per page: ``src`` None (required, all
    defined), a host bool array (all of them upload as one), or the offset
    of the page's levels in the device vector ``dev_levels``."""
    srcs = [src for _, src in parts]
    host = [src for src in srcs if isinstance(src, np.ndarray)]
    up = PC.to_device(np.concatenate(host), device) if host else None
    if len(host) == len(parts):
        return up
    if all(src is None for src in srcs):
        return torch.ones(sum(n for n, _ in parts), dtype=torch.bool,
                          device=device)
    if all(isinstance(src, int) for src in srcs):
        return dev_levels != 0
    pieces, q = [], 0
    for n, src in parts:
        if src is None:
            pieces.append(torch.ones(n, dtype=torch.bool, device=device))
        elif isinstance(src, np.ndarray):
            pieces.append(up[q:q + n])
            q += n
        else:
            pieces.append(dev_levels[src:src + n] != 0)
    return torch.cat(pieces)


def _index_entry(page, ndef, byte_base):
    """A page's dictionary indices as a ``batch_run_table`` entry."""
    bw = page.index_bit_width
    return (split_hybrid_runs(page.value_buf, bw, ndef), ndef, bw,
            byte_base, len(page.value_buf))


def _dict_indices(pages, device):
    """The dictionary pages of one chunk, decoded transfer -> (the indices
    of their defined values, the definition levels over all their rows,
    the defined count): one upload each of the joined index streams, the
    run table and the levels, and one K1 launch."""
    levels = [_host_levels(page) for page in pages]
    entries, base = [], 0
    for page, (_, ndef) in zip(pages, levels):
        entries.append(_index_entry(page, ndef, base))
        base += len(page.value_buf)
    table, ndef = batch_run_table(entries)
    buf = PC.to_device(np.frombuffer(
        b"".join(page.value_buf for page in pages), np.uint8), device)
    idx = expand_table_dev(buf, 0, table, ndef)
    defined = _join_defined([(page.num_values, lv)
                             for page, (lv, _) in zip(pages, levels)],
                            None, device)
    return idx, defined, ndef


def _dict_indices_compressed(pages, device):
    """Compressed-transfer twin of :func:`_dict_indices`: each page's
    stored bytes cross the link and decompress on the device; the regions
    are joined with one ``torch.cat``, and one K1 launch expands every
    page's indices and v1 definition levels (their rows follow the
    indices in the table)."""
    regions = [_page_dev_region(page, device) for page in pages]
    buf = torch.cat(regions) if len(regions) > 1 else regions[0]
    entries, level_entries, parts = [], [], []
    ndef_all = nlev = start = 0
    for page, region in zip(pages, regions):
        n = page.num_values
        levels, ndef = _host_levels(page)
        if levels is None or page.def_off is None:
            parts.append((n, levels))         # None, or v2 levels
        else:
            parts.append((n, nlev))
            level_entries.append((page.def_runs, n, 1, start + page.def_off,
                                  len(page.def_buf)))
            nlev += n
        entries.append(_index_entry(page, ndef, start + page.value_off))
        ndef_all += ndef
        start += int(region.shape[0])
    table, total = batch_run_table(entries + level_entries)
    out = expand_table_dev(buf, 0, table, total)
    defined = _join_defined(parts, out[ndef_all:], device)
    return out[:ndef_all], defined, ndef_all


def _decode_dict_pages(pages, dt: T.DataType, dictionary_dev, device,
                       compressed: bool):
    """The dictionary pages of one chunk -> (values, validity) over all of
    them: their indices (one K1 launch), one dictionary gather, one cast
    and one scatter."""
    _check_dict_pages(pages, dictionary_dev)
    idx, defined, ndef = (_dict_indices_compressed if compressed
                          else _dict_indices)(pages, device)
    vals = _dict_values(dictionary_dev, idx).to(column_torch_dtype(dt))
    n = sum(page.num_values for page in pages)
    return scatter_present(vals, defined, ndef, n), defined


def _decode_plain_page(page, info, dt: T.DataType, device):
    """One PLAIN data page, decoded transfer -> (values (n,), validity)."""
    n = page.num_values
    defined, ndef = expand_defined(page, device)
    if page.encoding != ENC_PLAIN:
        raise _Unsupported(f"encoding {page.encoding}")
    if info.ptype == TYPE_BOOLEAN:
        payload = PC.to_device(np.frombuffer(page.value_buf, np.uint8),
                               device)
        vals = unpack_bitpacked_dev(payload, 1, ndef)
    else:
        np_dt = _PLAIN_DTYPES[info.ptype]
        vals = PC.to_device(
            np.frombuffer(page.value_buf, np_dt, count=ndef), device)
    vals = vals.to(column_torch_dtype(dt))
    return scatter_present(vals, defined, ndef, n), defined


def _decode_plain_page_compressed(page, info, dt: T.DataType, device):
    """Compressed-transfer twin of :func:`_decode_plain_page`: the stored
    page bytes cross the link, decompress on the device, and the values
    decode from the device-resident region."""
    n = page.num_values
    dev = _page_dev_region(page, device)
    defined, ndef = _expand_defined_dev(page, dev)
    if page.encoding != ENC_PLAIN:
        raise _Unsupported(f"encoding {page.encoding}")
    if info.ptype == TYPE_BOOLEAN:
        vals = unpack_bitpacked_dev(dev[page.value_off:], 1, ndef)
    else:
        np_dt = np.dtype(_PLAIN_DTYPES[info.ptype])
        lo = page.value_off
        region = dev[lo:lo + ndef * np_dt.itemsize]
        if int(region.shape[0]) < ndef * np_dt.itemsize:
            raise _Unsupported("PLAIN value region short")
        # clone: a dtype view needs an aligned storage offset
        vals = region.clone().view(torch_dtype(np_dt))
    vals = vals.to(column_torch_dtype(dt))
    return scatter_present(vals, defined, ndef, n), defined


def _decode_numeric_chunk(f, info, cp, use_compressed: bool,
                          dictionary_dev, device):
    """One column chunk -> (values, validity) lists in page order.  Its
    dictionary pages decode together, with one K1 launch, against the
    chunk's dictionary already on the device; PLAIN pages one by one."""
    dict_pos = [i for i, page in enumerate(cp.pages)
                if page.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT)]
    in_batch = set(dict_pos)
    plain = (_decode_plain_page_compressed if use_compressed
             else _decode_plain_page)
    out = [None if i in in_batch else plain(page, info, f.dataType, device)
           for i, page in enumerate(cp.pages)]
    if dict_pos:
        pages = [cp.pages[i] for i in dict_pos]
        vals, valid = _decode_dict_pages(pages, f.dataType, dictionary_dev,
                                         device, use_compressed)
        if len(pages) == len(cp.pages):
            return [vals], [valid]
        sizes = [page.num_values for page in pages]
        for i, v, ok in zip(dict_pos, vals.split(sizes), valid.split(sizes)):
            out[i] = (v, ok)
    return [v for v, _ in out], [ok for _, ok in out]


def _chunk_compressed_eligible(cp, is_string: bool) -> bool:
    """Every page of the chunk must sit inside the compressed-transfer
    subset BEFORE any bytes ship; a PLAIN string page never does."""
    return all(page.raw_values is not None
               and page.raw_codec in (CODEC_UNCOMPRESSED, CODEC_SNAPPY)
               and not (is_string and page.encoding == ENC_PLAIN)
               for page in cp.pages)


class _StringSources:
    """One file's string column: the char matrices its rows gather from
    (row groups' dictionaries, PLAIN pages' values), stacked on the host
    in the order they come, and the rows' indices into the stack."""

    def __init__(self):
        self.mats = []            # (chars (k, w) uint8, lengths (k,) int32)
        self.rows = 0             # rows of the stack so far

    def add(self, chars: np.ndarray, lens: np.ndarray) -> int:
        """Append a matrix; -> its first row in the stack."""
        base = self.rows
        self.mats.append((chars, lens))
        self.rows += int(lens.shape[0])
        return base

    def gather(self, dt: T.DataType, idx: torch.Tensor, valid: torch.Tensor
               ) -> DeviceColumn:
        """The column: a null row takes the stack's last row (zeros, length
        0); one upload of the stack, one gather of chars and lengths."""
        longest = max([int(l.max()) for _, l in self.mats if len(l)] + [1])
        w = round_up_bucket(longest)
        chars = np.zeros((self.rows + 1, w), np.uint8)
        lens = np.zeros(self.rows + 1, np.int32)
        at = 0
        for c, l in self.mats:
            k = int(l.shape[0])
            chars[at:at + k, :c.shape[1]] = c[:, :w]
            lens[at:at + k] = l
            at += k
        chars_dev = PC.to_device(chars, idx.device)
        lens_dev = PC.to_device(lens, idx.device)
        idx = torch.where(valid, idx, self.rows)
        return DeviceColumn(dt, valid, chars=chars_dev[idx],
                            lengths=lens_dev[idx])


def _string_dict_indices(pages, cp, dict_base: int, compressed: bool,
                         device):
    """The dictionary pages of one string chunk -> (stack indices, validity)
    over their rows: one K1 launch for the indices, offset by the row
    group's dictionary in the stack."""
    if cp.dict_chars is None:
        raise _Unsupported(f"column {cp.info.name}: dictionary page missing")
    _check_dict_pages(pages, cp.dictionary)
    idx, defined, ndef = (_dict_indices_compressed if compressed
                          else _dict_indices)(pages, device)
    ndict = int(cp.dict_lens.shape[0])
    idx = idx.to(torch.int64).clamp_(0, max(ndict - 1, 0)) + dict_base
    n = sum(page.num_values for page in pages)
    return scatter_present(idx, defined, ndef, n), defined


def _decode_plain_string_page(page, sources: _StringSources, device):
    """A PLAIN BYTE_ARRAY page -> (stack indices, validity): the lengths
    walked on the host in C, the values gathered into a page-local char
    matrix in one numpy pass and added to the stack."""
    from spark_rapids_tpu_torch.native import plain_byte_array_lens

    n = page.num_values
    defined, ndef = expand_defined(page, device)
    lens = plain_byte_array_lens(page.value_buf, ndef)
    buf = np.frombuffer(page.value_buf, np.uint8)
    starts = 4 * np.arange(1, ndef + 1, dtype=np.int64) + (
        np.cumsum(lens, dtype=np.int64) - lens)
    w = max(int(lens.max()) if ndef else 1, 1)
    pos = starts[:, None] + np.arange(w, dtype=np.int64)[None, :]
    inside = np.arange(w, dtype=np.int32)[None, :] < lens[:, None]
    chars = np.where(inside, buf[np.clip(pos, 0, max(len(buf) - 1, 0))],
                     0).astype(np.uint8)
    base = sources.add(chars, lens)
    idx = torch.arange(base, base + ndef, dtype=torch.int64, device=device)
    return scatter_present(idx, defined, ndef, n), defined


def _decode_string_chunk(f, cp, use_compressed: bool,
                         sources: _StringSources, device):
    """One string column chunk -> (stack indices, validity) lists in page
    order.  Its dictionary pages decode together (one K1 launch) against
    the row group's dictionary, added to the stack once; PLAIN pages add
    their own matrices."""
    dict_pos = [i for i, page in enumerate(cp.pages)
                if page.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT)]
    for page in cp.pages:
        if page.encoding not in (ENC_PLAIN, ENC_PLAIN_DICT, ENC_RLE_DICT):
            raise _Unsupported(f"byte_array encoding {page.encoding}")
    out = [None] * len(cp.pages)
    if dict_pos:
        base = (sources.add(cp.dict_chars, cp.dict_lens)
                if cp.dict_chars is not None else 0)
        pages = [cp.pages[i] for i in dict_pos]
        idx, valid = _string_dict_indices(pages, cp, base, use_compressed,
                                          device)
        sizes = [page.num_values for page in pages]
        for i, v, ok in zip(dict_pos, idx.split(sizes), valid.split(sizes)):
            out[i] = (v, ok)
    for i, page in enumerate(cp.pages):
        if out[i] is None:
            out[i] = _decode_plain_string_page(page, sources, device)
    return [v for v, _ in out], [ok for _, ok in out]


def read_parquet_device(path: str, schema: T.StructType, device,
                        compressed: bool = True) -> ColumnarBatch:
    """One file -> one device batch.  Escaping errors name the file."""
    try:
        return _read_parquet_device(path, schema, device, compressed)
    except _Unsupported as e:
        raise _Unsupported(f"{path}: {e}") from e


def _read_parquet_device(path: str, schema: T.StructType, device,
                         compressed: bool) -> ColumnarBatch:
    with open(path, "rb") as fh:
        data = fh.read()
    groups, names = read_footer(data)
    for w in schema.field_names():
        if w not in names:
            raise _Unsupported(f"column {w} missing from file")
    total = sum(g.num_rows for g in groups)
    per_field_vals: List[List] = [[] for _ in schema.fields]
    per_field_valid: List[List] = [[] for _ in schema.fields]
    sources = [_StringSources() if isinstance(f.dataType, T.StringType)
               else None for f in schema.fields]
    for g in groups:
        by_name = {c.name: c for c in g.columns}
        for fi, f in enumerate(schema.fields):
            info = by_name.get(f.name)
            if info is None:
                raise _Unsupported(f"column {f.name} missing in row group")
            _check_field(info, f.dataType)
            cp = read_column_pages(data, info, g.num_rows)
            src = sources[fi]
            use_comp = compressed and _chunk_compressed_eligible(
                cp, src is not None)
            if compressed and not use_comp:
                PC.bump("chunk_decode_fallbacks")
            if src is not None:
                mark = (len(src.mats), src.rows)

                def decode(comp):
                    return _decode_string_chunk(f, cp, comp, src, device)
            else:
                # uploaded once: a chunk that falls back keeps its
                # dictionary
                dictionary_dev = (PC.to_device(cp.dictionary, device)
                                  if cp.dictionary is not None else None)

                def decode(comp):
                    return _decode_numeric_chunk(f, info, cp, comp,
                                                 dictionary_dev, device)
            try:
                vals, valids = decode(use_comp)
            except (_CompressedUnsupported, TooFragmented):
                if not use_comp:
                    raise
                PC.bump("chunk_decode_fallbacks")
                if src is not None:      # drop what the attempt stacked
                    del src.mats[mark[0]:]
                    src.rows = mark[1]
                vals, valids = decode(False)
            per_field_vals[fi].extend(vals)
            per_field_valid[fi].extend(valids)
    cols = []
    for fi, f in enumerate(schema.fields):
        pv, pm = per_field_vals[fi], per_field_valid[fi]
        if not pv:
            pv = [torch.zeros(0, dtype=torch.int64 if sources[fi]
                              else column_torch_dtype(f.dataType),
                              device=device)]
            pm = [torch.zeros(0, dtype=torch.bool, device=device)]
        vals = torch.cat(pv) if len(pv) > 1 else pv[0]
        valid = torch.cat(pm) if len(pm) > 1 else pm[0]
        if vals.shape[0] != total:
            raise _Unsupported(f"column {f.name}: {vals.shape[0]} values "
                               f"for {total} rows")
        if sources[fi] is not None:
            cols.append(sources[fi].gather(f.dataType, vals.to(torch.int64),
                                           valid))
            continue
        cols.append(DeviceColumn(f.dataType, valid, data=vals))
    return ColumnarBatch(cols, total, schema)

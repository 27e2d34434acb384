"""Device-side Parquet column assembly — port of the numeric path of
``spark_rapids_tpu/io/parquet_device.py``.

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
                                                    torch_dtype)
from spark_rapids_tpu_torch.io.parquet_native import (
    CODEC_SNAPPY,
    CODEC_UNCOMPRESSED,
    ENC_PLAIN,
    ENC_PLAIN_DICT,
    ENC_RLE_DICT,
    TYPE_BOOLEAN,
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


def _decode_dict_pages(pages, dt: T.DataType, dictionary_dev, device):
    """The dictionary pages of one chunk, decoded transfer -> (values,
    validity) over all of them: one upload each of the joined index
    streams, the run table and the definition levels; one K1 launch, one
    dictionary gather, one cast and one scatter."""
    _check_dict_pages(pages, dictionary_dev)
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
    vals = _dict_values(dictionary_dev, idx).to(column_torch_dtype(dt))
    n = sum(page.num_values for page in pages)
    return scatter_present(vals, defined, ndef, n), defined


def _decode_dict_pages_compressed(pages, dt: T.DataType, dictionary_dev,
                                  device):
    """Compressed-transfer twin of :func:`_decode_dict_pages`: each page's
    stored bytes cross the link and decompress on the device as before;
    the regions are joined with one ``torch.cat``, and one K1 launch
    expands every page's indices and v1 definition levels (their rows
    follow the indices in the table)."""
    _check_dict_pages(pages, dictionary_dev)
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
    vals = _dict_values(dictionary_dev, out[:ndef_all])
    vals = vals.to(column_torch_dtype(dt))
    n = sum(page.num_values for page in pages)
    return scatter_present(vals, defined, ndef_all, n), defined


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
        batch = (_decode_dict_pages_compressed if use_compressed
                 else _decode_dict_pages)
        vals, valid = batch(pages, f.dataType, dictionary_dev, device)
        if len(pages) == len(cp.pages):
            return [vals], [valid]
        sizes = [page.num_values for page in pages]
        for i, v, ok in zip(dict_pos, vals.split(sizes), valid.split(sizes)):
            out[i] = (v, ok)
    return [v for v, _ in out], [ok for _, ok in out]


def _chunk_compressed_eligible(cp) -> bool:
    """Every page of the chunk must sit inside the compressed-transfer
    subset BEFORE any bytes ship."""
    return all(page.raw_values is not None
               and page.raw_codec in (CODEC_UNCOMPRESSED, CODEC_SNAPPY)
               for page in cp.pages)


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
    for g in groups:
        by_name = {c.name: c for c in g.columns}
        for fi, f in enumerate(schema.fields):
            info = by_name.get(f.name)
            if info is None:
                raise _Unsupported(f"column {f.name} missing in row group")
            _check_field(info, f.dataType)
            cp = read_column_pages(data, info, g.num_rows)
            use_comp = compressed and _chunk_compressed_eligible(cp)
            if compressed and not use_comp:
                PC.bump("chunk_decode_fallbacks")
            # uploaded once: a chunk that falls back keeps its dictionary
            dictionary_dev = (PC.to_device(cp.dictionary, device)
                              if cp.dictionary is not None else None)
            try:
                vals, valids = _decode_numeric_chunk(
                    f, info, cp, use_comp, dictionary_dev, device)
            except (_CompressedUnsupported, TooFragmented):
                if not use_comp:
                    raise
                PC.bump("chunk_decode_fallbacks")
                vals, valids = _decode_numeric_chunk(
                    f, info, cp, False, dictionary_dev, device)
            per_field_vals[fi].extend(vals)
            per_field_valid[fi].extend(valids)
    cols = []
    for fi, f in enumerate(schema.fields):
        pv, pm = per_field_vals[fi], per_field_valid[fi]
        if not pv:
            pv = [torch.zeros(0, dtype=column_torch_dtype(f.dataType),
                              device=device)]
            pm = [torch.zeros(0, dtype=torch.bool, device=device)]
        vals = torch.cat(pv) if len(pv) > 1 else pv[0]
        valid = torch.cat(pm) if len(pm) > 1 else pm[0]
        if vals.shape[0] != total:
            raise _Unsupported(f"column {f.name}: {vals.shape[0]} values "
                               f"for {total} rows")
        cols.append(DeviceColumn(f.dataType, valid, data=vals))
    return ColumnarBatch(cols, total, schema)

"""Device-side Parquet column assembly — port of the numeric path of
``spark_rapids_tpu/io/parquet_device.py``.

The host half (``io/parquet_native.py``) parses footers, page headers and
run headers; the device half expands runs and unpacks bits with the K1
kernel (``pallas/decode.py``) and gathers dictionary values.

With compressed transfer on, each eligible chunk ships its pages' STORED
bytes and decompresses them on the device (``pallas/decompress.py``); a
chunk whose pages fall outside that subset, or whose compressed form is no
lighter (``TooFragmented``), ships decoded pages instead
(``chunk_decode_fallbacks``).  Both routes decode indices with K1.  A
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
    expand_runs,
    expand_runs_dev,
    expand_runs_host,
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
    n = page.num_values
    if page.def_runs is not None:
        levels = expand_runs_host(page.def_runs, page.def_buf, n, 1)
        defined_np = levels.astype(np.bool_)
        return PC.to_device(defined_np, device), int(defined_np.sum())
    return torch.ones(n, dtype=torch.bool, device=device), n


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
    if page.def_runs is None:
        return torch.ones(n, dtype=torch.bool, device=device), n
    levels = expand_runs_host(page.def_runs, page.def_buf, n, 1)
    ndef = int(levels.astype(np.bool_).sum())
    if page.def_off is not None:
        lv = expand_runs_dev(page.def_runs, dev_region, page.def_off, n, 1)
        return lv.to(torch.bool), ndef
    # v2: levels sit uncompressed outside the values region
    return PC.to_device(levels.astype(np.bool_), device), ndef


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


def _decode_page(page, info, dt: T.DataType, dictionary_dev, device):
    """One data page, decoded transfer -> (values (n,), validity (n,))."""
    n = page.num_values
    defined, ndef = expand_defined(page, device)
    if page.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT):
        if dictionary_dev is None:
            raise _Unsupported("dictionary page missing")
        if page.index_bit_width > MAX_BIT_WIDTH:
            raise _Unsupported(
                f"dictionary index width {page.index_bit_width}")
        runs = split_hybrid_runs(page.value_buf, page.index_bit_width, ndef)
        idx = expand_runs(runs, page.value_buf, ndef, page.index_bit_width,
                          device)
        vals = _dict_values(dictionary_dev, idx)
    elif page.encoding == ENC_PLAIN:
        if info.ptype == TYPE_BOOLEAN:
            payload = PC.to_device(np.frombuffer(page.value_buf, np.uint8),
                                   device)
            vals = unpack_bitpacked_dev(payload, 1, ndef)
        else:
            np_dt = _PLAIN_DTYPES[info.ptype]
            vals = PC.to_device(
                np.frombuffer(page.value_buf, np_dt, count=ndef), device)
    else:
        raise _Unsupported(f"encoding {page.encoding}")
    vals = vals.to(column_torch_dtype(dt))
    return scatter_present(vals, defined, ndef, n), defined


def _decode_page_compressed(page, info, dt: T.DataType, dictionary_dev,
                            device):
    """Compressed-transfer twin of :func:`_decode_page`: the stored page
    bytes cross the link, decompress on the device, and the value stream
    decodes from the device-resident region."""
    n = page.num_values
    dev = _page_dev_region(page, device)
    defined, ndef = _expand_defined_dev(page, dev)
    if page.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT):
        if dictionary_dev is None:
            raise _Unsupported("dictionary page missing")
        if page.index_bit_width > MAX_BIT_WIDTH:
            raise _Unsupported(
                f"dictionary index width {page.index_bit_width}")
        runs = split_hybrid_runs(page.value_buf, page.index_bit_width, ndef)
        idx = expand_runs_dev(runs, dev, page.value_off, ndef,
                              page.index_bit_width)
        vals = _dict_values(dictionary_dev, idx)
    elif page.encoding == ENC_PLAIN:
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
    else:
        raise _Unsupported(f"encoding {page.encoding}")
    vals = vals.to(column_torch_dtype(dt))
    return scatter_present(vals, defined, ndef, n), defined


def _decode_numeric_chunk(f, info, cp, use_compressed: bool, device):
    dictionary_dev = (PC.to_device(cp.dictionary, device)
                      if cp.dictionary is not None else None)
    vals: List = []
    valids: List = []
    for page in cp.pages:
        if use_compressed:
            v, ok = _decode_page_compressed(page, info, f.dataType,
                                            dictionary_dev, device)
        else:
            v, ok = _decode_page(page, info, f.dataType, dictionary_dev,
                                 device)
        vals.append(v)
        valids.append(ok)
    return vals, valids


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
            try:
                vals, valids = _decode_numeric_chunk(f, info, cp, use_comp,
                                                     device)
            except (_CompressedUnsupported, TooFragmented):
                if not use_comp:
                    raise
                PC.bump("chunk_decode_fallbacks")
                vals, valids = _decode_numeric_chunk(f, info, cp, False,
                                                     device)
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

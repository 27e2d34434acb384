"""The port's Parquet reader and writer against pyarrow.

Files pyarrow writes read identically through the port, over dictionary
or plain encoding, snappy or no codec, with or without nulls, data pages
v1 and v2, for INT32, INT64, DATE and decimal(12,2) stored as INT64; and
files the port writes read back identically through pyarrow and the port.
Files with pyarrow's 20,000-row pages decode each dictionary-encoded
chunk with one K1 call, equal to decoding its pages one by one.
"""
import datetime
import itertools
import os
import textwrap

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.io.parquet_device import read_parquet_device
from spark_rapids_tpu_torch.io.parquet_encode import write_parquet_device

CPU = torch.device("cpu")
N = 6000
_EPOCH = datetime.date(1970, 1, 1)


def _column(kind: str, rng, nulls: bool):
    """(pyarrow array, port type, storage values, validity)."""
    import pyarrow as pa
    from decimal import Decimal

    valid = rng.random(N) > 0.15 if nulls else np.ones(N, bool)
    if kind == "int32":
        v = rng.integers(-500, 500, N).astype(np.int32)
        arr, dt = pa.array(v, pa.int32(), mask=~valid), T.INT
    elif kind == "int64":
        v = rng.integers(-2 ** 40, 2 ** 40, N).astype(np.int64)
        v[::7] = v[3]                            # some repeats for the dict
        arr, dt = pa.array(v, pa.int64(), mask=~valid), T.LONG
    elif kind == "date":
        v = rng.integers(8035, 10440, N).astype(np.int32)
        arr = pa.array(v.astype("datetime64[D]"), pa.date32(), mask=~valid)
        dt = T.DATE
    else:                                        # decimal(12,2) as INT64
        v = rng.integers(-10 ** 6, 10 ** 6, N).astype(np.int64)
        arr = pa.array([Decimal(int(x)).scaleb(-2) if ok else None
                        for x, ok in zip(v, valid)], pa.decimal128(12, 2))
        dt = T.DecimalType(12, 2)
    return arr, dt, v, valid


_MATRIX = list(itertools.product(
    ["dict", "plain"], ["snappy", "none"], [True, False], ["1.0", "2.0"]))


@pytest.mark.parametrize("enc,codec,nulls,page_version", _MATRIX,
                         ids=["-".join(map(str, m)) for m in _MATRIX])
def test_port_reads_pyarrow_files(tmp_path, enc, codec, nulls, page_version):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    rng = np.random.default_rng(
        _MATRIX.index((enc, codec, nulls, page_version)))
    kinds = ["int32", "int64", "date", "decimal"]
    cols = {k: _column(k, rng, nulls) for k in kinds}
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({k: c[0] for k, c in cols.items()}), path,
                   compression=codec, use_dictionary=(enc == "dict"),
                   data_page_version=page_version, data_page_size=2048,
                   row_group_size=2500, store_decimal_as_integer=True)
    schema = T.StructType([T.StructField(k, cols[k][1]) for k in kinds])
    for compressed in (True, False):
        batch = read_parquet_device(path, schema, CPU, compressed)
        assert batch.num_rows == N
        for k, c in zip(kinds, batch.columns):
            _, dt, v, valid = cols[k]
            np.testing.assert_array_equal(c.validity.numpy(), valid)
            np.testing.assert_array_equal(c.data.numpy()[valid], v[valid])
            assert not c.data.numpy()[~valid].any()   # null rows zero-fill
        # every column arrives exactly as pyarrow decodes it
        want = pq.read_table(path).to_pydict()
        got = batch.to_pydict()
        for k in kinds:
            assert got[k] == want[k], k


@pytest.mark.parametrize("codec,use_dict,nullable",
                         list(itertools.product(["snappy", "none"],
                                                [True, False],
                                                [True, False])))
def test_port_written_files_read_back(tmp_path, codec, use_dict, nullable):
    pq = pytest.importorskip("pyarrow.parquet")
    rng = np.random.default_rng(7)
    n = 5001
    schema = T.StructType([T.StructField("i", T.INT, nullable),
                           T.StructField("l", T.LONG, nullable),
                           T.StructField("d", T.DATE, nullable)])
    valid = rng.random(n) > 0.2 if nullable else np.ones(n, bool)
    data = [rng.integers(-40, 40, n).astype(np.int32),
            rng.integers(-2 ** 50, 2 ** 50, n).astype(np.int64) // 977,
            rng.integers(8000, 9000, n).astype(np.int32)]
    cols = [HostColumn(f.dataType, valid, data=d)
            for f, d in zip(schema.fields, data)]
    path = str(tmp_path / "port.parquet")
    write_parquet_device(path, schema, cols, n, compression=codec,
                         use_dict=use_dict, device=CPU)
    tbl = pq.read_table(path)
    for f, d in zip(schema.fields, data):
        got = tbl.column(f.name).to_pylist()
        want = [(_EPOCH + datetime.timedelta(days=int(x))
                 if isinstance(f.dataType, T.DateType) else int(x))
                if ok else None for x, ok in zip(d, valid)]
        assert got == want, f.name
    batch = read_parquet_device(path, schema, CPU)
    for c, d in zip(batch.columns, data):
        np.testing.assert_array_equal(c.validity.numpy(), valid)
        np.testing.assert_array_equal(c.data.numpy()[valid], d[valid])


@pytest.mark.parametrize("use_dict,nullable", list(itertools.product(
    [True, False], [True, False])))
def test_port_writes_annotated_decimals(tmp_path, use_dict, nullable):
    """DECIMAL(7,2) as annotated INT32 and DECIMAL(12,2) as annotated
    INT64, as Spark writes them: pyarrow reads Decimals of those types, and
    the port reads the values back."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from decimal import Decimal

    from spark_rapids_tpu_torch.io.parquet_native import (TYPE_INT32,
                                                          TYPE_INT64,
                                                          read_footer)

    rng = np.random.default_rng(21)
    n = 3001
    schema = T.StructType([T.StructField("s", T.DecimalType(7, 2), nullable),
                           T.StructField("p", T.DecimalType(12, 2),
                                         nullable)])
    valid = rng.random(n) > 0.2 if nullable else np.ones(n, bool)
    data = [rng.integers(-10 ** 7 + 1, 10 ** 7, n),
            rng.integers(-10 ** 12 + 1, 10 ** 12, n)]
    path = str(tmp_path / "dec.parquet")
    write_parquet_device(path, schema, [HostColumn(f.dataType, valid, data=d)
                                        for f, d in zip(schema.fields, data)],
                         n, use_dict=use_dict, device=CPU)
    groups, _ = read_footer(open(path, "rb").read())
    assert [c.ptype for c in groups[0].columns] == [TYPE_INT32, TYPE_INT64]
    tbl = pq.read_table(path)
    assert tbl.schema.types == [pa.decimal128(7, 2), pa.decimal128(12, 2)]
    for f, d in zip(schema.fields, data):
        want = [Decimal(int(x)).scaleb(-2) if ok else None
                for x, ok in zip(d, valid)]
        assert tbl.column(f.name).to_pylist() == want, f.name
    batch = read_parquet_device(path, schema, CPU)
    for c, d in zip(batch.columns, data):
        np.testing.assert_array_equal(c.validity.numpy(), valid)
        np.testing.assert_array_equal(c.data.numpy()[valid], d[valid])


def test_writer_packs_one_run_per_page_and_reader_counts_fallbacks(tmp_path):
    from spark_rapids_tpu_torch.io.parquet_native import (read_column_pages,
                                                          read_footer,
                                                          split_hybrid_runs)

    rng = np.random.default_rng(2)
    n = 4099
    schema = T.StructType([T.StructField("q", T.LONG, False)])
    data = rng.integers(1, 51, n).astype(np.int64) * 100
    path = str(tmp_path / "q.parquet")
    write_parquet_device(path, schema,
                         [HostColumn.from_numpy(data, T.LONG)], n,
                         device=CPU)
    raw = open(path, "rb").read()
    groups, names = read_footer(raw)
    cp = read_column_pages(raw, groups[0].columns[0], n)
    (page,) = cp.pages
    assert page.index_bit_width == 6 and len(cp.dictionary) == 50
    runs = split_hybrid_runs(page.value_buf, 6, n)
    assert len(runs) == 1 and runs[0].is_packed and runs[0].count == n
    snap = PC.snapshot()
    batch = read_parquet_device(path, schema, CPU, compressed=True)
    np.testing.assert_array_equal(batch.columns[0].data.numpy(), data)
    # random 6-bit indices do not compress: the page ships decoded
    fell_back = PC.since(snap)
    assert fell_back["chunk_decode_fallbacks"] == 1
    # ... and the chunk's dictionary crosses the link once, as it does
    # when the decoded transfer is asked for
    snap = PC.snapshot()
    read_parquet_device(path, schema, CPU, compressed=False)
    assert fell_back["bytes_h2d"] == PC.since(snap)["bytes_h2d"]


@pytest.mark.parametrize("codec", ["snappy", "none"])
def test_plain_boolean_pages_and_unsupported_encoding(tmp_path, codec):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_rapids_tpu_torch.io.parquet_native import _Unsupported

    rng = np.random.default_rng(12)
    v, valid = rng.random(N) < 0.5, rng.random(N) > 0.1
    schema = T.StructType([T.StructField("b", T.BOOLEAN)])
    path = str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"b": pa.array(v, mask=~valid)}), path,
                   compression=codec, data_page_size=512)
    for compressed in (True, False):
        col = read_parquet_device(path, schema, CPU, compressed).columns[0]
        np.testing.assert_array_equal(col.validity.numpy(), valid)
        np.testing.assert_array_equal(col.data.numpy()[valid], v[valid])
    # v2 pages RLE-encode booleans, outside the subset: the port raises
    # where the reference would re-read the file with pyarrow
    pq.write_table(pa.table({"b": pa.array(v, mask=~valid)}), path,
                   compression=codec, data_page_version="2.0")
    with pytest.raises(_Unsupported, match="encoding 3"):
        read_parquet_device(path, schema, CPU)


def test_writer_defaults_to_cuda_and_raises_without_a_gpu(tmp_path):
    schema = T.StructType([T.StructField("q", T.LONG, False)])
    cols = [HostColumn.from_numpy(np.arange(8, dtype=np.int64), T.LONG)]
    path = str(tmp_path / "default.parquet")
    if torch.cuda.is_available():
        write_parquet_device(path, schema, cols, 8)
        np.testing.assert_array_equal(
            read_parquet_device(path, schema, CPU).columns[0].data.numpy(),
            np.arange(8))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            write_parquet_device(path, schema, cols, 8)
        assert not os.path.exists(path)


def _per_page_chunk(info, dt, cp, compressed):
    """Decode a chunk page by page, with one K1 call per page and per
    definition-level stream: the first slice's per-page decode."""
    from spark_rapids_tpu_torch.columnar.column import column_torch_dtype
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io.parquet_native import split_hybrid_runs
    from spark_rapids_tpu_torch.pallas import decode

    dictionary = (PC.to_device(cp.dictionary, CPU)
                  if cp.dictionary is not None else None)
    vals, valids = [], []
    for page in cp.pages:
        if page.encoding == 0:                   # PLAIN
            plain = (PD._decode_plain_page_compressed if compressed
                     else PD._decode_plain_page)
            v, ok = plain(page, info, dt, CPU)
        else:
            bw = page.index_bit_width
            if compressed:
                dev = PD._page_dev_region(page, CPU)
                ok, ndef = PD._expand_defined_dev(page, dev)
                base = page.value_off
            else:
                ok, ndef = PD.expand_defined(page, CPU)
                dev = PC.to_device(np.frombuffer(page.value_buf, np.uint8),
                                   CPU)
                base = 0
            runs = split_hybrid_runs(page.value_buf, bw, ndef)
            idx = decode.expand_runs_dev(runs, dev, base, ndef, bw)
            v = PD._dict_values(dictionary, idx).to(column_torch_dtype(dt))
            v = PD.scatter_present(v, ok, ndef, page.num_values)
        vals.append(v)
        valids.append(ok)
    return torch.cat(vals), torch.cat(valids)


def _counted(monkeypatch):
    """Count calls of the K1 wrapper (on the CPU: its plain version)."""
    from spark_rapids_tpu_torch.pallas import decode

    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    return calls


_PAGES = list(itertools.product(["snappy", "none"], [False, True],
                                ["1.0", "2.0"]))


@pytest.mark.parametrize("codec,nulls,page_version", _PAGES,
                         ids=["-".join(map(str, m)) for m in _PAGES])
def test_pyarrow_pages_decode_with_one_call_per_chunk(tmp_path, monkeypatch,
                                                      codec, nulls,
                                                      page_version):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.io.parquet_native import (read_column_pages,
                                                          read_footer)
    from spark_rapids_tpu_torch.pallas.decompress import TooFragmented

    rng = np.random.default_rng(_PAGES.index((codec, nulls, page_version)))
    n = 45_001                                   # 3 pages of <= 20,000
    data = {
        "q": rng.integers(1, 51, n) * 100,                  # width 6
        "p": rng.integers(0, 30_000, n),         # width grows page by page
        "d": rng.integers(8035, 10441, n).astype(np.int32),
        "c": np.repeat(rng.integers(0, 40, n // 1000 + 1),   # RLE runs
                       1000)[:n].astype(np.int32),
    }
    types = {"q": (pa.int64(), T.LONG), "p": (pa.int64(), T.LONG),
             "d": (pa.date32(), T.DATE), "c": (pa.int32(), T.INT)}
    valid = {k: rng.random(n) > 0.1 if nulls else np.ones(n, bool)
             for k in data}
    path = str(tmp_path / "pages.parquet")
    pq.write_table(pa.table({k: pa.array(v, types[k][0], mask=~valid[k])
                             for k, v in data.items()}), path,
                   compression=codec, data_page_version=page_version)
    schema = T.StructType([T.StructField(k, types[k][1]) for k in data])
    raw = open(path, "rb").read()
    groups, _ = read_footer(raw)
    (group,) = groups
    widths = {}
    calls = _counted(monkeypatch)
    for f, info in zip(schema.fields, group.columns):
        cp = read_column_pages(raw, info, group.num_rows)
        assert [p.num_values for p in cp.pages] == [20_000, 20_000, 5_001]
        assert all(p.encoding in (2, 8) for p in cp.pages)
        widths[f.name] = [p.index_bit_width for p in cp.pages]
        for compressed in (True, False):
            got = []
            for decode_chunk in ("batched", "per page"):
                calls[0] = 0
                snap = PC.snapshot()
                use = compressed
                while True:
                    try:
                        if decode_chunk == "batched":
                            dictionary = (PC.to_device(cp.dictionary, CPU)
                                          if cp.dictionary is not None
                                          else None)
                            v, ok = PD._decode_numeric_chunk(
                                f, info, cp, use, dictionary, CPU)
                            v, ok = torch.cat(v), torch.cat(ok)
                        else:
                            v, ok = _per_page_chunk(info, f.dataType, cp,
                                                    use)
                        break
                    except (PD._CompressedUnsupported, TooFragmented):
                        assert use
                        use = False
                got.append((v, ok, PC.since(snap)["bytes_h2d"], calls[0],
                            use))
            (bv, bok, bbytes, bcalls, buse), (pv, pok, pbytes, _, _) = got
            np.testing.assert_array_equal(bv.numpy(), pv.numpy())
            np.testing.assert_array_equal(bok.numpy(), pok.numpy())
            np.testing.assert_array_equal(bok.numpy(), valid[f.name])
            np.testing.assert_array_equal(bv.numpy()[valid[f.name]],
                                          data[f.name][valid[f.name]])
            # the same link bytes: the tables' rows are the same rows
            assert bbytes == pbytes, (f.name, compressed)
            assert bcalls == 1, (f.name, compressed, buse)
    assert widths["p"][0] < widths["p"][-1]      # per-row widths matter
    for compressed in (True, False):
        calls[0] = 0
        batch = read_parquet_device(path, schema, CPU, compressed)
        assert calls[0] == len(schema.fields)
        assert batch.to_pydict() == {
            k: [(_EPOCH + datetime.timedelta(days=int(x)) if k == "d"
                 else int(x)) if ok else None
                for x, ok in zip(v, valid[k])] for k, v in data.items()}


# -- string columns ------------------------------------------------------------

def _strings(rng, n, distinct, nulls):
    """n strings over ``distinct`` values of 1-19 bytes (multi-byte UTF-8
    among them), about a tenth null when ``nulls``."""
    words = [("é" if i % 5 == 0 else "v") * (1 + i % 9) + str(i)
             for i in range(distinct)]
    pick = rng.integers(0, distinct, n)
    valid = rng.random(n) > 0.1 if nulls else np.ones(n, bool)
    return [words[p] if ok else None for p, ok in zip(pick, valid)]


def _reference_decode(tmp_path, path, nullable=True):
    """The reference's device decode of ``path``'s column ``s`` (child
    process), as Python strings: its decoded transfer, which compiles a
    third of what its compressed one does on the CPU."""
    from torch_port_jaxref import REF_K1_INTERPRET, run_jax

    out = run_jax(REF_K1_INTERPRET + textwrap.dedent(f"""
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf, set_conf
    from spark_rapids_tpu.io.parquet_device import read_parquet_device
    set_conf(TpuConf({{"spark.rapids.sql.format.parquet.transfer.compressed":
                      False}}))
    sch = T.StructType([T.StructField("s", T.STRING, {nullable!r})])
    b = read_parquet_device({path!r}, sch)
    set_conf(TpuConf())
    vals = b.columns[0].to_host(b.num_rows).to_pylist()
    out["valid"] = np.array([v is not None for v in vals])
    out["lens"] = np.array([len((v or "").encode()) for v in vals])
    out["bytes"] = np.frombuffer(b"".join((v or "").encode() for v in vals),
                                 np.uint8)
    """), tmp_path)
    ends = np.cumsum(out["lens"])
    raw = out["bytes"].tobytes()
    return [raw[e - n:e].decode() if ok else None
            for e, n, ok in zip(ends, out["lens"], out["valid"])]


_STR_FILES = list(itertools.product(["dict", "overflow"], ["1.0", "2.0"]))


@pytest.fixture(scope="module")
def string_files(tmp_path_factory):
    """Per (kind, page version): a pyarrow file of dictionary-encoded
    strings over 2 row groups (kind "dict"), or, past a small dictionary
    page limit, PLAIN pages after the dictionary pages ("overflow", the
    dictionary overflow of parquet-mr and Arrow); its values, and the
    reference's device decode of it."""
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    tmp = tmp_path_factory.mktemp("strings")
    out = {}
    for i, (kind, version) in enumerate(_STR_FILES):
        rng = np.random.default_rng(i)
        vals = _strings(rng, 6000, 7 if kind == "dict" else 3000, True)
        path = str(tmp / f"{kind}-{version}.parquet")
        pq.write_table(pa.table({"s": pa.array(vals, pa.string())}), path,
                       compression="snappy", data_page_version=version,
                       dictionary_pagesize_limit=2048, data_page_size=1024,
                       row_group_size=3000)
        assert vals == pq.read_table(path).column("s").to_pylist()
        out[(kind, version)] = (path, vals,
                                _reference_decode(tmp, path))
    return out


_STR_CASES = [(k, v, c) for k, v in _STR_FILES for c in (True, False)]


@pytest.mark.parametrize("kind,page_version,compressed", _STR_CASES,
                         ids=[f"{k}-{v}-{'comp' if c else 'decoded'}"
                              for k, v, c in _STR_CASES])
def test_string_pages_match_pyarrow_and_reference(string_files, monkeypatch,
                                                  kind, page_version,
                                                  compressed):
    from spark_rapids_tpu_torch.io.parquet_native import (ENC_PLAIN,
                                                          read_column_pages,
                                                          read_footer)

    path, vals, ref = string_files[(kind, page_version)]
    assert ref == vals                          # the reference's decode
    raw = open(path, "rb").read()
    groups, _ = read_footer(raw)
    assert len(groups) == 2
    encs = [p.encoding for g in groups
            for p in read_column_pages(raw, g.columns[0], g.num_rows).pages]
    assert (ENC_PLAIN in encs) == (kind == "overflow")
    schema = T.StructType([T.StructField("s", T.STRING)])
    calls = _counted(monkeypatch)
    snap = PC.snapshot()
    col = read_parquet_device(path, schema, CPU, compressed).columns[0]
    assert col.to_host(len(vals)).to_pylist() == vals
    assert calls[0] == 2                         # one a chunk
    if kind == "overflow" and compressed:        # PLAIN: no compressed route
        assert PC.since(snap)["chunk_decode_fallbacks"] == 2
    assert col.width == 32 and not col.chars[~col.validity].any()


@pytest.mark.parametrize("nullable", [True, False])
def test_port_writer_plain_strings_read_back(tmp_path, nullable):
    """The port writes strings as the reference does: PLAIN BYTE_ARRAY
    with the UTF8 annotation; pyarrow, the port and the reference read
    them back."""
    pq = pytest.importorskip("pyarrow.parquet")
    from spark_rapids_tpu_torch.io.parquet_native import (ENC_PLAIN,
                                                          TYPE_BYTE_ARRAY,
                                                          read_column_pages,
                                                          read_footer)

    rng = np.random.default_rng(31)
    n = 4001
    vals = _strings(rng, n, 50, nullable)
    schema = T.StructType([T.StructField("s", T.STRING, nullable),
                           T.StructField("i", T.INT, nullable)])
    ints = rng.integers(-9, 9, n).astype(np.int32)
    valid = np.array([v is not None for v in vals])
    path = str(tmp_path / "ps.parquet")
    write_parquet_device(path, schema, [
        HostColumn.from_pylist(vals, T.STRING),
        HostColumn(T.INT, valid, data=ints)], n, device=CPU)
    raw = open(path, "rb").read()
    groups, _ = read_footer(raw)
    info = groups[0].columns[0]
    assert info.ptype == TYPE_BYTE_ARRAY
    assert [p.encoding for p in read_column_pages(raw, info, n).pages] == [
        ENC_PLAIN]
    tbl = pq.read_table(path)
    assert str(tbl.schema.field("s").type) == "string"
    assert tbl.column("s").to_pylist() == vals
    batch = read_parquet_device(path, schema, CPU)
    assert batch.columns[0].to_host(n).to_pylist() == vals
    assert _reference_decode(tmp_path, path, nullable) == vals

"""Shared pieces of the port's query tests: one table, given as numpy
arrays, made into a DataFrame of either package, and rows compared as
``tests/asserts.py`` compares them (its ``approximate_float`` rounds
doubles to 12 significant digits; -0.0 equals 0.0; NaN equals NaN)."""
import math
from decimal import Decimal

import numpy as np

ORACLE = {"spark.rapids.sql.enabled": False}


def string_host(column, values, validity=None):
    """A string ``HostColumn`` of the package whose ``columnar.column``
    module is ``column``: ``values`` an array of ``str`` (UTF-8 encoded)
    or ``bytes``; a row's chars zero past its length, a null row's length
    0 (the layout both packages hold)."""
    n = len(values)
    valid = (np.ones(n, np.bool_) if validity is None
             else np.asarray(validity, np.bool_))
    enc = [b"" if not ok else v.encode("utf-8") if isinstance(v, str)
           else bytes(v) for v, ok in zip(values, valid)]
    lengths = np.array([len(b) for b in enc], np.int32)
    chars = np.zeros((n, max(int(lengths.max()) if n else 0, 1)), np.uint8)
    for i, b in enumerate(enc):
        chars[i, :len(b)] = np.frombuffer(b, np.uint8)
    types = __import__(column.__name__.split(".")[0] + ".types",
                       fromlist=["STRING"])
    return column.HostColumn(types.STRING, valid, chars=chars,
                             lengths=lengths)


def frame(mod, session, arrays, schema, validity=None):
    """A ``LocalTableScan`` DataFrame of ``arrays`` (name -> numpy array in
    the field's storage form, strings as ``str`` or ``bytes``;
    ``validity``: name -> bool array) in the package whose ``session``
    module is ``mod``."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    column = __import__(pkg + ".columnar.column", fromlist=["HostColumn"])
    nodes = __import__(pkg + ".plan.nodes", fromlist=["LocalTableScan"])
    validity = validity or {}
    host = [string_host(column, arrays[f.name], validity.get(f.name))
            if type(f.dataType).__name__ == "StringType" else
            column.HostColumn.from_numpy(np.asarray(arrays[f.name]),
                                         f.dataType,
                                         validity.get(f.name))
            for f in schema.fields]
    return mod.DataFrame(nodes.LocalTableScan(host, schema), session)


def _normalize(v, approx_float: bool):
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if v == 0.0:
            return 0.0
        if approx_float:
            return float(f"{v:.12g}")
    if isinstance(v, Decimal):
        return ("dec", str(v.normalize()))
    return v


def rows_key(rows, approx_float: bool = False, ordered: bool = False):
    """Rows in a comparable form; sorted unless ``ordered``."""
    out = [tuple(type(v).__name__ + ":" + repr(_normalize(v, approx_float))
                 for v in r) for r in rows]
    return out if ordered else sorted(out)


def write_parquet_files(tmp_path, name, arrays, schema, nfiles):
    """``arrays`` (name -> numpy array in storage form: unscaled integers
    for decimals) as ``nfiles`` snappy files written by pyarrow, decimals
    with their DECIMAL annotation over integers, as Spark stores them."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n = len(arrays[schema.fields[0].name])
    bounds = np.linspace(0, n, nfiles + 1).astype(int)
    paths = []
    for i in range(nfiles):
        cols = {}
        for f in schema.fields:
            v = arrays[f.name][bounds[i]:bounds[i + 1]]
            dt = f.dataType
            cols[f.name] = (pa.array([Decimal(int(x)).scaleb(-dt.scale)
                                      for x in v],
                                     pa.decimal128(dt.precision, dt.scale))
                            if type(dt).__name__ == "DecimalType"
                            else pa.array(v))
        path = str(tmp_path / f"{name}-{i}.parquet")
        pq.write_table(pa.table(cols), path, compression="snappy",
                       store_decimal_as_integer=True)
        paths.append(path)
    return paths

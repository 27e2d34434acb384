#!/usr/bin/env python3
"""Write the multi-page Q6 lineitem fixture ``q6_lineitem_pages.parquet``.

    python3 tests/port/make_pages_fixture.py

One snappy, dictionary-encoded Parquet file, written by pyarrow the way
Spark's and Arrow's writers lay out a file: data pages of 20,000 rows,
v1 page headers, one row group.  It holds the four Q6 columns of
``chip_smoke.py::lineitem_q6`` (TPC-H 4.2.3 rules) for ``FIXTURE_ROWS``
rows from ``FIXTURE_SEED``, as required columns: unscaled cents in INT64
and days in DATE.  So each column chunk is 5 dictionary pages, and the
index width grows with the dictionary from page to page.

The machine with the card has no pyarrow: ``chip_smoke.py`` reads the
committed file and regenerates the same arrays from the seed with numpy.
The script checks that every data page kept its dictionary encoding
(pyarrow writes PLAIN once a dictionary passes 1 MB) and that the file
reads back equal to the arrays.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
PATH = os.path.join(HERE, "q6_lineitem_pages.parquet")
PAGE_ROWS = 20_000


def write(path: str = PATH) -> str:
    import pyarrow as pa
    import pyarrow.parquet as pq

    sys.path.insert(0, REPO)
    from chip_smoke import fixture_lineitem
    from spark_rapids_tpu_torch.io.parquet_native import (ENC_PLAIN_DICT,
                                                          ENC_RLE_DICT,
                                                          read_column_pages,
                                                          read_footer)

    li = fixture_lineitem()
    n = len(li["l_shipdate"])
    fields = [pa.field(name, pa.date32() if name == "l_shipdate"
                       else pa.int64(), nullable=False) for name in li]
    arrays = [pa.array(li[f.name], f.type) for f in fields]
    pq.write_table(pa.Table.from_arrays(arrays, schema=pa.schema(fields)),
                   path, compression="snappy", use_dictionary=True,
                   max_rows_per_page=PAGE_ROWS, row_group_size=n,
                   data_page_version="1.0")
    data = open(path, "rb").read()
    groups, _ = read_footer(data)
    for g in groups:
        for info in g.columns:
            pages = read_column_pages(data, info, g.num_rows).pages
            if len(pages) != -(-n // PAGE_ROWS):
                raise SystemExit(f"{info.name}: {len(pages)} data pages")
            if any(p.encoding not in (ENC_PLAIN_DICT, ENC_RLE_DICT)
                   for p in pages):
                raise SystemExit(f"{info.name}: a page is not dictionary-"
                                 "encoded")
    back = pq.read_table(path)
    for name, want in li.items():
        got = back.column(name).to_numpy()
        if not np.array_equal(got.astype(want.dtype), want):
            raise SystemExit(f"{name} reads back different")
    return path


if __name__ == "__main__":
    p = write()
    print(f"{p}: {os.path.getsize(p)} bytes")

"""The hot-table cache of the port (``io/hot_cache.py``) against the JAX
package's: one sequence of scans, run by each package over its own copy of
the same snappy Parquet files (written by the port's writer), counts the
same hits, misses and evictions and returns the same rows.  The sequence:
a miss then a hit; a rewritten file misses; another column set misses; a
scan abandoned under ``limit`` publishes nothing; ``close`` empties the
cache; under a bound that holds one table, least recently used tables are
evicted; a scan over the bound is never cached; after the last ``close``
the spill framework holds no handle, persistent ones included.  The
bounds are set from each package's own bytes for one table (the
reference pads its device columns).  The reference's side runs in the
child process of ``torch_port_jaxref.py``.  Then, on the port alone: a
hit moves no byte and launches no decode; cached batches are persistent
spillables that survive the framework built anew for the next collect,
spill to the host under pressure and come back exact."""
import json
import os
import shutil
import sys

import pytest

from spark_rapids_tpu_torch import perfcounters as PC
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io.hot_cache import clear_hot_cache
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

ROWS = 6000
NAMES = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]

# the sequence, in either package; ``{dev}`` is the port's device argument
_SEQ = '''
import hashlib, os
import {pkg}.session as S
from {pkg} import perfcounters as PC
from {pkg} import types as T
from {pkg}.io.hot_cache import peek_hot_cache
from {pkg}.memory.spill import peek_spill_framework
root = {root!r}
t1, t2 = ([os.path.join(root, t, f"lineitem-{{i:02d}}.parquet")
           for i in range(2)] for t in ("t1", "t2"))
KEYS = ("hot_cache_hits", "hot_cache_misses", "hot_cache_evictions")
NAMES = {names!r}


def sch(cols):
    return T.StructType([T.StructField(
        n, T.DATE if n == "l_shipdate" else T.LONG)
        for n in cols])


def session(bound=None):
    c = {{"spark.rapids.sql.format.parquet.decode.device": True,
          "spark.rapids.sql.format.parquet.reader.type": "PERFILE",
          "spark.rapids.tpu.scan.hotTableCache.enabled": True}}
    if bound is not None:
        c["spark.rapids.tpu.scan.hotTableCache.maxBytes"] = int(bound)
    return S.TpuSession(c{dev})


steps = []


def step(name, s, paths, cols, limit=None):
    before = PC.snapshot()
    df = s.read.schema(sch(cols)).parquet(*paths)
    if limit:
        df = df.limit(limit)
    rows = df.collect()
    after = PC.snapshot()
    digest = hashlib.sha1(repr(sorted(rows)).encode()).hexdigest()
    steps.append([name, [after[k] - before[k] for k in KEYS], len(rows),
                  digest if not limit else ""])


two, three = ["l_quantity", "l_discount"], NAMES[:3]
s = session()
step("miss", s, t1, NAMES)
one = peek_hot_cache().stats()["bytes"]
step("hit", s, t1, NAMES)
with open(t1[0], "rb") as f:
    data = f.read()
with open(t1[0], "wb") as f:
    f.write(data)
st = os.stat(t1[0])
os.utime(t1[0], ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
step("rewritten file", s, t1, NAMES)
step("other columns", s, t1, two)
step("limit", s, t1, three, limit=5)
step("after limit", s, t1, three)
step("hit after limit", s, t1, three)
leaks = s.close()
steps.append(["closed", peek_hot_cache().stats()["entries"], len(leaks)])
s = session(one * 3 // 2)
step("bound: t1", s, t1, NAMES)
step("bound: t2 evicts t1", s, t2, NAMES)
step("bound: t1 evicts t2", s, t1, NAMES)
step("bound: t1 hit", s, t1, NAMES)
s.close()
s = session(one // 2)
step("over bound", s, t1, NAMES)
step("over bound again", s, t1, NAMES)
leaks = s.close()
fw = peek_spill_framework()
steps.append(["end", peek_hot_cache().stats()["entries"], len(leaks),
              len(fw.leak_report(include_persistent=True)) if fw else 0])
'''

_WANT_COUNTS = [
    ("miss", [0, 1, 0]), ("hit", [1, 0, 0]), ("rewritten file", [0, 1, 0]),
    ("other columns", [0, 1, 0]), ("limit", [0, 1, 0]),
    ("after limit", [0, 1, 0]), ("hit after limit", [1, 0, 0]),
    ("bound: t1", [0, 1, 0]), ("bound: t2 evicts t1", [0, 1, 1]),
    ("bound: t1 evicts t2", [0, 1, 1]), ("bound: t1 hit", [1, 0, 0]),
    ("over bound", [0, 1, 0]), ("over bound again", [0, 1, 0])]


def _write_tables(root: str):
    """Two tables (``t1/``, ``t2/``) of two files each: chip_smoke's Q6
    lineitem columns from two seeds, written by the port's writer."""
    for i, name in enumerate(("t1", "t2")):
        li = C.lineitem_q6(ROWS, 0.01, 41 + i)
        C.write_files(li, ROWS, os.path.join(root, name), "cpu", n_files=2)


@pytest.fixture
def clean():
    clear_hot_cache()
    try:
        yield
    finally:
        clear_hot_cache()


def test_hot_cache_sequence_matches_reference(tmp_path, clean):
    base = str(tmp_path / "port")
    _write_tables(base)
    ref_root = str(tmp_path / "ref")
    shutil.copytree(base, ref_root)
    scope = {}
    exec(_SEQ.format(pkg="spark_rapids_tpu_torch", root=base,
                     dev=', device="cpu"', names=NAMES), scope)
    ours = scope["steps"]
    out = run_jax(_SEQ.format(pkg="spark_rapids_tpu", root=ref_root,
                              dev="", names=NAMES)
                  + 'out["steps"] = np.array(__import__("json").dumps(steps))',
                  tmp_path)
    theirs = json.loads(str(out["steps"]))
    assert ours == theirs
    counts = [(st[0], st[1]) for st in ours if st[0] not in ("closed",
                                                           "end")]
    assert counts == _WANT_COUNTS
    assert ["closed", 0, 0] in ours and ours[-1] == ["end", 0, 0, 0]


def test_hit_moves_no_byte_and_survives_a_new_framework(tmp_path, clean):
    """A hit uploads nothing and runs no decode; the cached batches are
    persistent: a collect's query-end cleanup and the leak report leave
    them alone, the framework built anew for the next collect takes them
    over, and under a pool too small for them they spill to the host and
    come back exact."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.io.hot_cache import peek_hot_cache
    from spark_rapids_tpu_torch.lifecycle import leak_report_all
    from spark_rapids_tpu_torch.memory import spill
    from spark_rapids_tpu_torch.pallas import decode

    _write_tables(str(tmp_path))
    paths = [str(tmp_path / "t1" / f"lineitem-{i:02d}.parquet")
             for i in range(2)]
    sch = T.StructType([T.StructField(n, T.DATE if n == "l_shipdate"
                                      else T.DecimalType(12, 2))
                        for n in NAMES])
    conf = {"spark.rapids.sql.format.parquet.decode.device": True,
            "spark.rapids.tpu.scan.hotTableCache.enabled": True}
    s = S.TpuSession(conf, device="cpu")
    want = s.read.schema(sch).parquet(*paths).collect()
    fw1 = spill.peek_spill_framework()
    assert len(fw1.leak_report(include_persistent=True)) == 2
    assert leak_report_all() == []
    calls = {"n": 0}
    orig = decode.unpack_runs

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    decode.unpack_runs = counting
    try:
        before = PC.snapshot()
        got = s.read.schema(sch).parquet(*paths).collect()
    finally:
        decode.unpack_runs = orig
    d = PC.since(before)
    assert got == want and calls["n"] == 0
    assert d["hot_cache_hits"] == 1 and d["bytes_h2d"] == 0
    fw2 = spill.peek_spill_framework()
    assert fw2 is not fw1 and not fw1.leak_report(include_persistent=True)
    handles = [h for h in fw2._handles if h.persistent]
    assert len(handles) == 2
    # a pool with no room: both spill to the host and come back exact
    fw2.pool_bytes = 0
    assert fw2.spill_device_pressure() == sum(h.device_bytes
                                              for h in handles)
    assert all(h.state == spill.STATE_HOST for h in handles)
    assert s.read.schema(sch).parquet(*paths).collect() == want
    assert peek_hot_cache().stats()["entries"] == 1
    assert s.close() == []
    assert peek_hot_cache().stats()["entries"] == 0
    assert spill.peek_spill_framework().leak_report(
        include_persistent=True) == []

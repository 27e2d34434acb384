"""String columns in the port against the JAX package, on seeded rows:
the padded layout's round trips, ``gather``, ``slice`` and ``concat``
across widths; the string literal; ``=``, ``<``, ``>=``, ``IN`` (with a
null candidate), ``CASE WHEN`` and ``If`` with string and flat branches
against the reference's device session (child process); key words against
the reference's and the "a" / "a\\x00" finding; the sort, group-by and
join with string keys and string payload (a string key through sized
hash exchanges and a sub-partitioned join too) against the reference's
CPU oracle session; a TKU2 frame of a string batch byte-equal to the
reference's, and the reference's frame decoded by the port.  Every
comparison is exact."""
import textwrap

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn
from spark_rapids_tpu_torch.expr.base import EvalContext, Literal
from spark_rapids_tpu_torch.ops.sortkeys import _column_key_words
from spark_rapids_tpu_torch.shuffle import serializer as SER
from torch_port_frames import ORACLE, frame, rows_key, string_host
from torch_port_jaxref import run_jax

CPU = torch.device("cpu")
# prefixes of one another, the empty string, multi-byte UTF-8, a string
# past the first width bucket, and the dictionary's own values
POOL = ["", "a", "ab", "abc", "b", "MAIL", "SHIP", "MAI", "MAILS", "AIR",
        "REG AIR", "1-URGENT", "2-HIGH", "4-NOT SPECIFIED", "é", "ü-x",
        "zzzzzzzzzzz", "naïve café"]
N = 300


def table(seed: int, n: int = N):
    """k (long), s and t (strings, nulls in s), x (int)."""
    rng = np.random.default_rng(seed)
    pool = np.asarray(POOL, dtype=object)
    return ({"k": rng.integers(0, 40, n), "s": pool[rng.integers(0, len(POOL),
                                                                 n)],
             "t": pool[rng.integers(0, len(POOL), n)],
             "x": rng.integers(-50, 50, n).astype(np.int32)},
            {"s": rng.random(n) > 0.15})


def schema(T_):
    return T_.StructType([T_.StructField("k", T_.LONG),
                          T_.StructField("s", T_.STRING),
                          T_.StructField("t", T_.STRING),
                          T_.StructField("x", T_.INT)])


def strs(values, valid):
    return [v if ok else None for v, ok in zip(values, valid)]


# -- the layout ---------------------------------------------------------------

_VALS = ["", "a", None, "12345678", "123456789", "naïve café", "ü"]


def test_round_trip_and_widths():
    h = HostColumn.from_pylist(_VALS, T.STRING)
    assert h.to_pylist() == _VALS
    assert h.width == len("naïve café".encode())
    d = DeviceColumn.from_host(h, CPU)
    assert d.width == 32                       # the bucket of 12 bytes
    assert d.to_host(len(_VALS)).to_pylist() == _VALS
    assert not d.chars[2].any() and int(d.lengths[2]) == 0


def _both_widths():
    """A width-8 column of 2 rows concatenated with a width-32 one."""
    narrow = DeviceColumn.from_host(HostColumn.from_pylist(["x", "yz"],
                                                           T.STRING), CPU)
    assert narrow.width == 8
    return DeviceColumn.concat(
        [narrow, DeviceColumn.from_host(HostColumn.from_pylist(
            _VALS, T.STRING), CPU)])


def test_concat_across_widths():
    both = _both_widths()
    assert both.width == 32
    assert both.to_host(9).to_pylist() == ["x", "yz"] + _VALS


def test_gather_and_slice():
    both = _both_widths()
    idx = torch.tensor([6, 0, 5, 2])
    assert both.gather(idx).to_host(4).to_pylist() == ["123456789", "x",
                                                        "12345678", ""]
    assert both.slice(3, 6).to_host(3).to_pylist() == ["a", None, "12345678"]


def test_host_concat_and_numpy_values():
    h = HostColumn.from_pylist(_VALS, T.STRING)
    host = HostColumn.concat([HostColumn.from_pylist(["abc"], T.STRING), h])
    assert host.to_pylist() == ["abc"] + _VALS
    # numpy str and bytes arrays, as the tests' tables hold them
    arr = np.asarray(["q", b"r\x00s"], dtype=object)
    assert HostColumn.from_numpy(arr, T.STRING).to_pylist() == ["q", "r\x00s"]


_PAIRS = [("", ""), ("", "a"), ("a", "a"), ("a", "ab"), ("ab", "b"),
          ("a", "a\x00"), ("a\x00", "a\x01"), ("a\x00b", "a"),
          ("MAIL", "MAILS"), ("é", "z"), ("zzzzzzzzz", "zzzzzzzz"),
          ("4-NOT SPECIFIED", "4-NOT")]


@pytest.mark.parametrize("a,b", _PAIRS)
def test_string_compare_is_utf8_byte_order(a, b):
    """``string_compare`` across widths (8 and 32) against Python's order
    of the UTF-8 bytes, which is Spark's."""
    from spark_rapids_tpu_torch.expr.predicates import string_compare

    l = DeviceColumn.from_host(HostColumn.from_pylist([a, b], T.STRING), CPU)
    r = DeviceColumn.from_host(HostColumn.from_pylist([b, a], T.STRING), CPU)
    r = r.with_width(32 if r.width == 8 else 8) if max(
        len(a.encode()), len(b.encode())) <= 8 else r
    lt, eq = string_compare(l, r)
    ab, bb = a.encode(), b.encode()
    assert lt.tolist() == [ab < bb, bb < ab]
    assert eq.tolist() == [ab == bb, ab == bb]


def test_batch_rows_and_empty_batch():
    a, v = table(3, 20)
    df = frame(S, S.TpuSession({}, device="cpu"), a, schema(T), v)
    rows = df.collect()
    assert rows == [(int(k), s, t, int(x)) for k, s, t, x in zip(
        a["k"], strs(a["s"], v["s"]), a["t"], a["x"])]
    from spark_rapids_tpu_torch.columnar.batch import empty_batch

    e = empty_batch(schema(T), CPU)
    assert e.columns[1].width == 8 and e.to_rows() == []


def test_batch_from_numpy_takes_reference_string_columns():
    """The data carried across: a reference ``HostColumn`` of strings and
    a ``(values, validity)`` pair become the port's string columns."""
    from spark_rapids_tpu.columnar.column import HostColumn as RHost
    from spark_rapids_tpu_torch.columnar.convert import batch_from_numpy

    vals = ["MAIL", None, "", "naïve café", "x"]
    ref = RHost.from_pylist(vals, RT.STRING)
    pair = (np.asarray(["a", "bb", "", "é", "z"], dtype=object),
            np.array([True, True, False, True, True]))
    sch = T.StructType([T.StructField("r", T.STRING),
                        T.StructField("p", T.STRING)])
    b = batch_from_numpy([ref, pair], sch, CPU)
    assert b.columns[0].width == 32 and b.columns[1].width == 8
    assert b.to_pydict() == {"r": vals, "p": ["a", "bb", None, "é", "z"]}


@pytest.mark.parametrize("value", ["SHIP", "", "naïve café", None])
def test_string_literal(value):
    b = ColumnarBatch([DeviceColumn(T.INT, torch.ones(3, dtype=torch.bool),
                                    data=torch.zeros(3, dtype=torch.int32))],
                      3, T.StructType([T.StructField("i", T.INT)]))
    lit = Literal(value, T.STRING) if value is None else Literal.of(value)
    c = lit.eval_tpu(EvalContext(b))
    assert c.dtype == T.STRING
    assert c.width == (8 if value is None else max(len(value.encode()), 1))
    assert c.to_host(3).to_pylist() == [value] * 3


# -- expressions against the reference ---------------------------------------

_EXPRS = """
def exprs(mod, pkg):
    import datetime as dt
    import importlib
    from decimal import Decimal
    CO = importlib.import_module(pkg + ".expr.conditional")
    col, lit = mod.col, mod.lit
    s, t, x, m, d = col("s"), col("t"), col("x"), col("m"), col("d")
    return {
        "eq": s.eq(t), "lt": s < t, "le": s <= lit("MAIL"),
        "gt": s > lit(""), "ge": s >= lit("MAIL"), "ne": ~s.eq(t),
        "isin": s.isin("MAIL", "SHIP", ""), "isin_null": s.isin("ab", None),
        "isin_int": x.isin(1, -7, 30), "isin_int_null": x.isin(2, None),
        "isin_dec": m.isin(Decimal("1.25"), Decimal("-3.00")),
        "isin_date": d.isin(dt.date(1994, 1, 1), dt.date(1995, 6, 30)),
        "case_str": CO.CaseWhen([(s.eq(lit("MAIL")), t),
                                 (x > lit(10), s)], lit("other")),
        "case_flat": CO.CaseWhen([(s.isin("a", "b"), lit(1)),
                                  (t < lit("M"), x)]),
        "case_dec": CO.CaseWhen([(x > lit(0), m)], lit(Decimal("0.50"))),
        "if_str": CO.If(x > lit(0), s, t),
        "if_flat": CO.If(s.eq(t), col("k"), lit(7)),
        "if_date": CO.If(x < lit(-20), d, lit(dt.date(2000, 1, 1))),
    }
"""
#: the expressions over flat columns only, which a CPU stage runs
_FLAT = ["isin_int", "isin_int_null", "isin_dec", "isin_date", "case_dec",
         "if_date"]


def _wide(seed: int):
    a, v = table(seed)
    rng = np.random.default_rng(seed + 1)
    a["m"] = rng.integers(-400, 400, N) * 25        # decimal(12,2) cents
    a["d"] = rng.integers(8760, 9300, N).astype(np.int32)
    a["d"][::17] = 8766                              # 1994-01-01
    a["x"][::13] = 30
    return a, dict(v, m=rng.random(N) > 0.1)


def _wide_schema(T_):
    return T_.StructType(list(schema(T_).fields) + [
        T_.StructField("m", T_.DecimalType(12, 2)),
        T_.StructField("d", T_.DATE)])


@pytest.fixture(scope="module")
def expr_results(tmp_path_factory):
    """Each expression's column from the reference's device session
    (child), its CPU oracle, the port, and the port with the projection
    as a CPU stage (the flat ones)."""
    a, v = _wide(11)
    lists = {"k": a["k"].tolist(), "x": a["x"].tolist(), "m": a["m"].tolist(),
             "d": a["d"].tolist(), "s": list(a["s"]), "t": list(a["t"])}
    valid = {k: w.tolist() for k, w in v.items()}
    out = run_jax(_EXPRS + textwrap.dedent(f"""
    import sys
    sys.path.insert(0, "tests/port")
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from torch_port_frames import frame
    sch = T.StructType([T.StructField("k", T.LONG),
                        T.StructField("s", T.STRING),
                        T.StructField("t", T.STRING),
                        T.StructField("x", T.INT),
                        T.StructField("m", T.DecimalType(12, 2)),
                        T.StructField("d", T.DATE)])
    lists = {lists!r}
    arrays = {{"k": np.array(lists["k"]), "x": np.array(lists["x"], np.int32),
               "m": np.array(lists["m"]),
               "d": np.array(lists["d"], np.int32),
               "s": lists["s"], "t": lists["t"]}}
    valid = {{k: np.array(w) for k, w in {valid!r}.items()}}
    df = frame(RS, RS.TpuSession({{}}), arrays, sch, valid)
    named = exprs(RS, "spark_rapids_tpu")
    rows = df.select(*[e.alias(n) for n, e in named.items()]).collect()
    for i, n in enumerate(named):
        out[n] = np.array([repr(r[i]) for r in rows])
    """), tmp_path_factory.mktemp("exprs"))
    ns = {}
    exec(_EXPRS, ns)

    def columns(mod, pkg, session, types, names=None):
        named = ns["exprs"](mod, pkg)
        names = names or list(named)
        rows = frame(mod, session, a, _wide_schema(types), v).select(
            *[named[n].alias(n) for n in names]).collect()
        return {n: [repr(r[i]) for r in rows] for i, n in enumerate(names)}

    return (out, columns(RS, "spark_rapids_tpu", RS.TpuSession(ORACLE), RT),
            columns(S, "spark_rapids_tpu_torch",
                    S.TpuSession({}, device="cpu"), T),
            columns(S, "spark_rapids_tpu_torch", S.TpuSession(
                {"spark.rapids.sql.exec.Project": "false"}, device="cpu"),
                T, _FLAT))


@pytest.mark.parametrize("name", ["eq", "lt", "le", "gt", "ge", "ne", "isin",
                                  "isin_null", "isin_int", "isin_int_null",
                                  "isin_dec", "isin_date", "case_str",
                                  "case_flat", "case_dec", "if_str",
                                  "if_flat", "if_date"])
def test_expression_matches_reference(expr_results, name):
    ref_device, oracle, port, _ = expr_results
    assert port[name] == list(ref_device[name]) == oracle[name]
    assert len(set(port[name])) > 1                  # not a constant


@pytest.mark.parametrize("name", _FLAT)
def test_flat_expression_in_a_cpu_stage(expr_results, name):
    """``In``, ``If`` and ``CaseWhen`` run in the port's CPU engine too
    (a projection the conf keeps off the device)."""
    _, oracle, _, cpu_stage = expr_results
    assert cpu_stage[name] == oracle[name]


# -- key words -----------------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(5, 64), (6, 1), (7, 200)])
def test_key_words_are_the_references_then_the_length(tmp_path, seed, n):
    a, v = table(seed, n)
    h = string_host(__import__("spark_rapids_tpu_torch.columnar.column",
                               fromlist=["x"]), a["s"], v["s"])
    out = run_jax("""
    import jax.numpy as jnp
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.column import DeviceColumn
    from spark_rapids_tpu.ops.sortkeys import _column_key_words
    c = DeviceColumn(T.STRING, jnp.asarray(inp["valid"]),
                     chars=jnp.asarray(inp["chars"]),
                     lengths=jnp.asarray(inp["lengths"]))
    out["words"] = np.stack([np.asarray(w) for w in _column_key_words(c)])
    """, tmp_path, {"valid": h.validity, "chars": h.chars,
                    "lengths": h.lengths})
    c = DeviceColumn.from_host(h, CPU).with_width(h.width)
    words = _column_key_words(c)
    np.testing.assert_array_equal(
        np.stack([w.numpy() for w in words[:-1]]), out["words"])
    np.testing.assert_array_equal(words[-1].numpy(), h.lengths)


def test_trailing_nul_groups_apart_unlike_the_reference(tmp_path):
    """The finding: the reference's key words carry no length, so its
    device group-by puts "a" and "a\\x00" in one group (and its join
    matches them); the port's length word keeps them apart, as Spark and
    the reference's CPU oracle do."""
    vals = ["a", "a\x00", "a", "b", "a\x00"]
    out = run_jax(f"""
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    sch = T.StructType([T.StructField("s", T.STRING)])
    df = RS.TpuSession({{}}).create_dataframe({{"s": {vals!r}}}, sch)
    rows = df.group_by("s").agg(RS.count_(None, "n")).collect()
    out["rows"] = np.array(sorted(repr(r) for r in rows))
    """, tmp_path)
    # the reference: one group of 4 for "a" and "a\x00", shown as "a"
    assert list(out["rows"]) == ["('a', 4)", "('b', 1)"]
    sch = T.StructType([T.StructField("s", T.STRING)])
    df = S.TpuSession({}, device="cpu").create_dataframe({"s": vals}, sch)
    got = sorted(df.group_by("s").agg(S.count_(None, "n")).collect())
    assert got == [("a", 2), ("a\x00", 2), ("b", 1)]          # the port
    rsch = RT.StructType([RT.StructField("s", RT.STRING)])
    oracle = RS.TpuSession(ORACLE).create_dataframe({"s": vals}, rsch)
    assert sorted(oracle.group_by("s").agg(RS.count_(None, "n"))
                  .collect()) == got
    assert df.order_by("s").collect() == [
        ("a",), ("a",), ("a\x00",), ("a\x00",), ("b",)]


# -- operators against the reference's CPU oracle --------------------------------

def _both(build, seed: int, conf=None):
    """``build(mod, df, other)`` over the same two tables in both packages:
    (the port's rows, the reference oracle's rows)."""
    a, v = table(seed)
    b, w = table(seed + 100, 90)
    s = S.TpuSession(conf or {}, device="cpu")
    got = build(S, frame(S, s, a, schema(T), v),
                frame(S, s, b, schema(T), w)).collect()
    r = RS.TpuSession(ORACLE)
    want = build(RS, frame(RS, r, a, schema(RT), v),
                 frame(RS, r, b, schema(RT), w)).collect()
    return got, want


@pytest.mark.parametrize("ascending", [[True, False, True, True],
                                       [False, True, True, True],
                                       [True, True, False, True],
                                       [False, False, True, False]])
def test_sort_on_string_keys_with_string_payload(ascending):
    got, want = _both(lambda mod, df, _: df.order_by(
        "s", "t", "k", "x", ascending=ascending), 21)
    assert got == want


@pytest.mark.parametrize("batch_rows", [None, 37, 128])
def test_group_by_string_keys(batch_rows):
    conf = ({} if batch_rows is None
            else {"spark.rapids.sql.reader.batchSizeRows": batch_rows})
    got, want = _both(lambda mod, df, _: df.group_by("s", "t").agg(
        mod.sum_("x", "sx"), mod.count_(None, "n")), 22, conf)
    assert rows_key(got) == rows_key(want)


@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("key", ["s", "k"])
def test_join_with_string_payload(how, key):
    """Both sides carry strings; on the string key the probe side's widths
    (8 and 32) meet the build side's.  The long key is joined without
    broadcast (the adaptive join)."""
    def q(mod, df, other):
        o = other.select(mod.col("s").alias("s"), mod.col("t").alias("u"),
                         mod.col("k").alias("kk"), "k")
        return df.join(o.select(key, "u", "kk"), key, how)
    conf = {"spark.sql.autoBroadcastJoinThreshold": "-1"} if key == "k" \
        else {}
    got, want = _both(q, 23 if key == "s" else 24, conf)
    assert rows_key(got) == rows_key(want)


def test_join_on_string_key_hashes_it():
    """A string join key hashed twice: both sides through hash exchanges
    sized past their one planned partition (a 64 KiB pool), then a build
    side over batchSizeBytes, which the join sub-partitions by murmur3 of
    the key at run time."""
    conf = {"spark.rapids.tpu.test.deviceMemoryBytes": str(1 << 16),
            "spark.sql.shuffle.partitions": 1,
            "spark.rapids.sql.batchSizeBytes": 4096,
            "spark.sql.autoBroadcastJoinThreshold": "-1",
            "spark.sql.adaptive.enabled": False}

    def q(mod, df, other):
        o = other.filter(mod.col("k") < mod.lit(3)).select(
            mod.col("s").alias("s"), mod.col("t").alias("u"),
            mod.col("k").alias("kk"))
        return df.join(o, "s", "inner")

    a, v = table(25, 1700)
    b, w = table(125, 2000)
    s = S.TpuSession(conf, device="cpu")
    df = q(S, frame(S, s, a, schema(T), v), frame(S, s, b, schema(T), w))
    got = df.collect()
    join = df._planned()
    assert type(join).__name__ == "TpuShuffledSymmetricHashJoinExec"
    exchanges = [c.children[0] for c in join.children]
    assert [(e.partitioning.describe(), e._ooc_sized)
            for e in exchanges] == [("hashpartitioning(s, 2)", True)] * 2
    assert join.sub_partitions > 1
    r = RS.TpuSession(ORACLE)
    want = q(RS, frame(RS, r, a, schema(RT), v),
             frame(RS, r, b, schema(RT), w)).collect()
    assert rows_key(got) == rows_key(want)
    assert s.close() == []


# -- the TKU2 frame ----------------------------------------------------------------

@pytest.mark.parametrize("codec", ["none", "zlib", "lz4"])
@pytest.mark.parametrize("rows", [45, 1])
def test_frame_is_byte_equal_to_the_references(tmp_path, codec, rows):
    a, v = table(31, rows)
    mod = __import__("spark_rapids_tpu_torch.columnar.column",
                     fromlist=["x"])
    hs, ht = string_host(mod, a["s"], v["s"]), string_host(mod, a["t"])
    inp = {"k": a["k"], "s_valid": hs.validity, "s_chars": hs.chars,
           "s_len": hs.lengths, "t_chars": ht.chars, "t_len": ht.lengths}
    out = run_jax(f"""
    import jax.numpy as jnp
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.batch import ColumnarBatch
    from spark_rapids_tpu.columnar.column import DeviceColumn, HostColumn
    from spark_rapids_tpu.shuffle import serializer as SER
    sch = T.StructType([T.StructField("k", T.LONG),
                        T.StructField("s", T.STRING),
                        T.StructField("t", T.STRING)])
    n = len(inp["k"])
    cols = [HostColumn(T.LONG, np.ones(n, np.bool_), data=inp["k"]),
            HostColumn(T.STRING, inp["s_valid"], chars=inp["s_chars"],
                       lengths=inp["s_len"]),
            HostColumn(T.STRING, np.ones(n, np.bool_), chars=inp["t_chars"],
                       lengths=inp["t_len"])]
    b = ColumnarBatch.from_host_columns(cols, ["k", "s", "t"])
    out["frame"] = np.frombuffer(SER.serialize_batch(b, {codec!r}), np.uint8)
    """, tmp_path, inp)
    sch = T.StructType([T.StructField("k", T.LONG),
                        T.StructField("s", T.STRING),
                        T.StructField("t", T.STRING)])
    n = len(a["k"])
    batch = ColumnarBatch([
        DeviceColumn.from_host(HostColumn.from_numpy(a["k"], T.LONG), CPU),
        DeviceColumn.from_host(hs, CPU), DeviceColumn.from_host(ht, CPU)],
        n, sch)
    mine = SER.serialize_batch(batch, codec)
    assert mine == out["frame"].tobytes()      # the codecs are the same
    ref = SER.deserialize_concat([out["frame"].tobytes(), mine], sch,
                                 codec=codec, device=CPU)
    got = batch.to_rows()
    assert ref.to_rows() == got + got
    longest = max(len(x.encode()) for x in a["s"])
    assert ref.columns[1].width == (8 if longest <= 8 else 32)

"""TIMESTAMP columns, the date and time functions of slice 17 and every
string cast, against the reference: a seeded table of 256 rows
(``torch_port_times.py``: instants before 1970, 29 February, the year
10000 edge, a DST gap and overlap in America/Los_Angeles, strings that
parse and strings that do not), the port on the CPU against the
reference's device session (in the child process, one call for the
module) and its CPU oracle, with ANSI off and on.  Every comparison is
exact.  Where the reference's two paths disagree the port takes Spark's
side and the test pins it by name (R29); where they agree against Spark
the port follows them and the test pins the departure (R30, R31).  Also:
the shapes the reference's rules tag off the device, run in the port's
CPU engine with the oracle's rows; each operator on a TIMESTAMP key; the
TIMESTAMP round trip through the port's writer and decoder; ``tzdb``'s
tables against the reference's."""
import datetime as dt
import json

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.base import SparkArithmeticException
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax
from torch_port_times import (ANSI_CASES, ANSI_OVERFLOW, CASES, TAGGED_CONF,
                              TAGGED_OFF, UNKNOWN_ZONE, columns, decode,
                              mods, same, select_cases, times_schema,
                              times_table)

SEED = 17
ANSI = {"spark.sql.ansi.enabled": True}
UTC = dt.timezone.utc


def _frame(mod, types, session, clean=False):
    arrays, validity = times_table(SEED, clean=clean)
    return frame(mod, session, arrays, times_schema(types), validity)


#: the time fields of a DATE on every path (R29)
DATE_TIME_FIELDS = {
    "hour_of_date": lambda X, c: X.D.Hour(c("d")),
    "minute_of_date": lambda X, c: X.D.Minute(c("d")),
    "second_of_date": lambda X, c: X.D.Second(c("d")),
}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference device session's column of every case (one collect,
    or one a case where the whole fails), its ANSI columns on the clean
    table and its time fields of a DATE, in one child call."""
    out = run_jax("""
    import json, sys
    sys.path.insert(0, "tests/port")
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import test_torch_timestamps as M
    import torch_port_times as X
    get_device_manager(TpuConf({}))
    enc = lambda rows, cases: {n: [X.encode(v) for v in c]
                               for n, c in X.columns(rows, cases).items()}
    def run(cases, conf, clean=False):
        return X.select_cases(RS, M._frame(RS, T, RS.TpuSession(conf),
                                           clean), cases).collect()
    raised = {}
    def each(cases, conf, clean=False, tag=""):
        # one collect, or one a case where the whole fails
        try:
            return enc(run(cases, conf, clean), cases)
        except Exception:
            got = {}
            for n, b in cases.items():
                try:
                    got.update(enc(run({n: b}, conf, clean), {n: b}))
                except Exception as ex:
                    raised[tag + n] = type(ex).__name__
            return got
    cols = each(X.CASES, {})
    ansi_cases = {n: X.CASES[n] for n in X.ANSI_CASES}
    ansi = each(ansi_cases, M.ANSI, True, "clean_ansi_")
    fields = enc(run(M.DATE_TIME_FIELDS, {}), M.DATE_TIME_FIELDS)
    out["json"] = np.array([json.dumps({
        "cols": cols, "raised": raised, "ansi": ansi, "fields": fields})])
    """, tmp_path_factory.mktemp("timesref"))
    got = json.loads(str(out["json"][0]))
    dec = {k: {n: [decode(v) for v in c] for n, c in got[k].items()}
           for k in ("cols", "ansi", "fields")}
    dec["raised"] = got["raised"]
    return dec


@pytest.fixture(scope="module")
def port_and_oracle():
    """The port's columns (one collect) and the reference oracle's (one
    collect)."""
    port = columns(select_cases(
        S, _frame(S, T, S.TpuSession({}, device="cpu")), CASES).collect(),
        CASES)
    oracle = columns(select_cases(
        RS, _frame(RS, RT, RS.TpuSession(ORACLE)), CASES).collect(), CASES)
    return port, oracle


def _differs(a, b):
    return [(i, x, y) for i, (x, y) in enumerate(zip(a, b))
            if not same(x, y)]


#: cases where the reference's device departs from its oracle and from
#: Spark on some rows, and the port takes the oracle's side: name -> the
#: rows where it does (R32: a boolean string with spaces around it)
DEVICE_DEPARTS = {"cast_str_bool": lambda a: [
    i for i, (v, ok) in enumerate(zip(a["bs"], _valid("bs")))
    if ok and v != v.strip()]}


def _valid(name):
    return times_table(SEED)[1][name]


@pytest.mark.parametrize("name", list(CASES))
def test_case_equals_reference(name, reference, port_and_oracle):
    """The port's column equals the reference device's and its oracle's,
    row for row and type for type (but for ``DEVICE_DEPARTS``, where it
    equals the oracle and departs from the device on those rows only)."""
    got = port_and_oracle[0][name]
    assert len(got) == 256
    assert not _differs(got, port_and_oracle[1][name])[:5], name
    assert name not in reference["raised"], reference["raised"][name]
    off = [i for i, _, _ in _differs(got, reference["cols"][name])]
    if name in DEVICE_DEPARTS:
        assert off and off == DEVICE_DEPARTS[name](times_table(SEED)[0])
        return
    assert not off[:5], name


@pytest.mark.parametrize("name", ANSI_CASES)
def test_ansi_case_equals_reference(name, reference):
    """With ANSI on: on the clean table every path gives the rows of
    ANSI off (the port equal to the reference's device and oracle); on
    the full table, which holds strings that do not parse and invalid
    dates, the port and the reference's oracle raise."""
    build = {name: CASES[name]}
    got = columns(select_cases(S, _frame(
        S, T, S.TpuSession(ANSI, device="cpu"), True), build).collect(),
        build)[name]
    plain = columns(select_cases(S, _frame(
        S, T, S.TpuSession({}, device="cpu"), True), build).collect(),
        build)[name]
    oracle = columns(select_cases(RS, _frame(
        RS, RT, RS.TpuSession(dict(ORACLE, **ANSI)), True), build)
        .collect(), build)[name]
    assert not _differs(got, plain)
    assert not _differs(got, oracle)[:5]
    assert "clean_ansi_" + name not in reference["raised"]
    assert not _differs(got, reference["ansi"][name])[:5]
    assert any(v is not None for v in got)
    with pytest.raises(SparkArithmeticException):
        select_cases(S, _frame(S, T, S.TpuSession(ANSI, device="cpu")),
                     build).collect()
    with pytest.raises(Exception):
        select_cases(RS, _frame(RS, RT, RS.TpuSession(dict(ORACLE, **ANSI))),
                     build).collect()


def test_ansi_timestamp_seconds_overflow():
    """``timestamp_seconds`` past the long range of microseconds: null
    with ANSI off, an error with ANSI on, on every path."""
    build = ANSI_OVERFLOW["timestamp_seconds_overflow"]

    def run(mod, types, session):
        sch = types.StructType([types.StructField("l", types.LONG)])
        df = frame(mod, session, {"l": np.array([2 ** 63 - 1, -1,
                                                 9223372036855])}, sch)
        return [r[0] for r in df.select(
            build(mods(mod), mod.col).alias("v")).collect()]

    want = [None, dt.datetime(1969, 12, 31, 23, 59, 59, tzinfo=UTC), None]
    assert run(S, T, S.TpuSession({}, device="cpu")) == want
    assert run(RS, RT, RS.TpuSession(ORACLE)) == want
    with pytest.raises(SparkArithmeticException):
        run(S, T, S.TpuSession(ANSI, device="cpu"))
    with pytest.raises(Exception):
        run(RS, RT, RS.TpuSession(dict(ORACLE, **ANSI)))


def test_r29_time_fields_of_a_date_are_midnight(reference):
    """R29: ``hour``/``minute``/``second`` of a DATE.  The reference's
    device reads the day number as microseconds, its oracle reads the
    day before 1970 as the last second of a day: they disagree.  Spark
    casts the DATE to its midnight; the port gives 0, 0, 0."""
    rows = select_cases(S, _frame(S, T, S.TpuSession({}, device="cpu")),
                        DATE_TIME_FIELDS).collect()
    arrays, validity = times_table(SEED)
    valid = validity["d"]
    assert all(r == (0, 0, 0) for r, ok in zip(rows, valid) if ok)
    dev = reference["fields"]
    # 1969-12-31 is day -1: the device's -1 microsecond is hour -1
    assert arrays["d"][0] == -1
    assert (dev["hour_of_date"][0], dev["minute_of_date"][0],
            dev["second_of_date"][0]) != (0, 0, 0)
    oracle = select_cases(RS, _frame(RS, RT, RS.TpuSession(ORACLE)),
                          DATE_TIME_FIELDS).collect()
    assert oracle[0] == (23, 59, 59)
    # the oracle reads the day number as microseconds too: from day 0 to
    # day 10^6 (1970 to 4707) that is midnight's 0, 0, 0, as the port's
    near = (arrays["d"] >= 0) & (arrays["d"] < 10 ** 6) & valid
    assert [r for r, ok in zip(oracle, near) if ok] == \
        [(0, 0, 0)] * int(near.sum())
    assert any(r != (0, 0, 0) for r, d, ok in zip(oracle, arrays["d"], valid)
               if ok and d >= 10 ** 6)


def _one_ts(mod, types, session, build, micros):
    sch = types.StructType([types.StructField("ts", types.TIMESTAMP)])
    df = frame(mod, session, {"ts": np.array(micros, np.int64)}, sch)
    return [r[0] for r in df.select(
        build(mods(mod), mod.col).alias("v")).collect()]


def test_r30_extract_yearofweek_is_the_calendar_year():
    """R30: ``extract(YEAROFWEEK FROM 2019-12-30)`` is 2019 in both of
    the reference's paths and the port; Spark's ISO week-numbering year is
    2020."""
    build = CASES["extract_yearofweek"]
    us = [(dt.datetime(2019, 12, 30) - dt.datetime(1970, 1, 1))
          // dt.timedelta(microseconds=1)]
    assert _one_ts(S, T, S.TpuSession({}, device="cpu"), build, us) == [2019]
    assert _one_ts(RS, RT, RS.TpuSession(ORACLE), build, us) == [2019]


def test_r31_extract_second_is_whole_seconds():
    """R31: ``extract(SECOND ...)`` is an INT of whole seconds: 1 for
    00:00:01.5 and 59 for -1 microsecond, in both of the reference's
    paths and the port; Spark gives decimal(8,6) 1.500000 and
    59.999999."""
    build = CASES["extract_second"]
    us = [1_500_000, -1]
    assert _one_ts(S, T, S.TpuSession({}, device="cpu"), build, us) == [1, 59]
    assert _one_ts(RS, RT, RS.TpuSession(ORACLE), build, us) == [1, 59]
    X = mods(S)
    e = X.D.Extract(S.lit("second"), S.col("ts")).resolve(
        T.StructType([T.StructField("ts", T.TIMESTAMP)]))
    assert e.dataType == T.INT


@pytest.mark.parametrize("name", sorted(TAGGED_OFF))
def test_tagged_off_shape_runs_in_a_cpu_stage(name):
    """Each shape the reference's rules keep off the device is tagged
    with its words and runs in the port's CPU engine with the oracle's
    rows."""
    build, words = TAGGED_OFF[name]
    conf = TAGGED_CONF.get(name, {})
    df = select_cases(S, _frame(S, T, S.TpuSession(conf, device="cpu")),
                      {name: build})
    assert words in df.explain()
    got = [r[0] for r in df.collect()]
    want = [r[0] for r in select_cases(
        RS, _frame(RS, RT, RS.TpuSession(dict(ORACLE, **conf))),
        {name: build}).collect()]
    assert not _differs(got, want)[:5]
    assert any(v is not None for v in got)


@pytest.mark.parametrize("name", sorted(UNKNOWN_ZONE))
def test_unknown_zone_raises_in_a_cpu_stage(name):
    """An unknown zone is tagged off the device; the CPU engine raises
    on it, as the reference's oracle does."""
    build, words = UNKNOWN_ZONE[name]
    df = select_cases(S, _frame(S, T, S.TpuSession({}, device="cpu")),
                      {name: build})
    assert words in df.explain()
    with pytest.raises(ValueError):
        df.collect()
    with pytest.raises(Exception):
        select_cases(RS, _frame(RS, RT, RS.TpuSession(ORACLE)),
                     {name: build}).collect()


def test_captured_clock_is_one_value_per_query():
    """current_date, current_timestamp and localtimestamp: one value for
    every row, taken when the expression is built, on the device and in
    a CPU stage (under a tagged-off ``date_format``)."""
    import time

    X = mods(S)
    before = int(time.time() * 1e6)
    ct, cd, lt = (X.D.CurrentTimestamp(), X.D.CurrentDate(),
                  X.D.LocalTimestamp())
    after = int(time.time() * 1e6)
    df = _frame(S, T, S.TpuSession({}, device="cpu"))
    rows = df.select(ct.alias("t"), cd.alias("d"), lt.alias("l")).collect()
    stage = df.select(ct.alias("t"), X.D.DateFormat(
        ct, S.lit("EEE yyyy")).alias("f")).collect()
    t = rows[0][0]
    us = (t - dt.datetime(1970, 1, 1, tzinfo=UTC)) // dt.timedelta(
        microseconds=1)
    assert before <= us <= after
    assert {r[0] for r in rows} == {t} and {r[0] for r in stage} == {t}
    assert {r[1] for r in rows} == {t.date()}
    assert len({r[2] for r in rows}) == 1
    assert {r[1] for r in stage} == {t.strftime("%a %Y")}


#: operators on a TIMESTAMP key: name -> query(mod, df)
def _ops(mod, df, WF):
    c = mod.col
    return {
        "sort": lambda: df.order_by(c("ts"), c("i"), ascending=[False,
                                                                True]),
        "group_by": lambda: df.group_by(c("ts")).agg(
            mod.count_(None, "n"), mod.min_(c("i"), "lo")),
        "min_max_first_last_count": lambda: df.group_by(c("k")).agg(
            mod.min_(c("ts"), "a"), mod.max_(c("ts"), "b"),
            ("first", c("ts"), "f"), ("last", c("ts"), "g"),
            mod.count_(c("ts"), "n")),
        "join": lambda: df.join(df.select(c("ts"), c("i").alias("j")),
                                on="ts"),
        "exchange": lambda: df.repartition(7, c("ts")).group_by(
            c("ts")).agg(mod.count_(None, "n")),
        "range_window": lambda: df.window(
            [WF("sum", c("i"), "x"), WF("count", c("i"), "y")],
            partition_by=["k"], order_by=[c("ts")],
            frame=("range", 86_400_000_000, 3_600_000_000)),
        "hash": lambda: df.select(c("ts"), mod.hash_(c("ts"), c("k")),
                                  mod.xxhash64_(c("ts"))),
    }


def _key_frame(mod, types, session):
    """Few distinct instants (before and after 1970, one null in ten) so
    that groups, joins and frames hold several rows."""
    rng = np.random.default_rng(SEED + 1)
    n = 240
    ts = rng.integers(-4, 4, n) * 43_200_000_000 + rng.integers(0, 3, n)
    arrays = {"ts": ts, "i": rng.integers(-50, 50, n).astype(np.int32),
              "k": rng.integers(0, 5, n).astype(np.int32)}
    sch = types.StructType([types.StructField("ts", types.TIMESTAMP),
                            types.StructField("i", types.INT),
                            types.StructField("k", types.INT)])
    return frame(mod, session, arrays, sch,
                 {"ts": rng.random(n) > 0.1, "i": rng.random(n) > 0.1,
                  "k": np.ones(n, np.bool_)})


@pytest.mark.parametrize("op", ["sort", "group_by",
                                "min_max_first_last_count", "join",
                                "exchange", "range_window", "hash"])
def test_operator_takes_a_timestamp_key(op):
    """Each operator takes a TIMESTAMP as its int64 microseconds and
    equals the reference's oracle (the sort in order, the rest as
    sets)."""
    from spark_rapids_tpu.plan.nodes import WindowFunction as RWF
    from spark_rapids_tpu_torch.plan.nodes import WindowFunction as PWF

    got = _ops(S, _key_frame(S, T, S.TpuSession({}, device="cpu")),
               PWF)[op]().collect()
    want = _ops(RS, _key_frame(RS, RT, RS.TpuSession(ORACLE)), RWF)[op]()\
        .collect()
    assert rows_key(got, ordered=op == "sort") == \
        rows_key(want, ordered=op == "sort")


def test_timestamp_key_through_the_out_of_core_exchange():
    """A group-by on a TIMESTAMP key over a sized exchange whose
    partitions spill to the host under a small pool: the spilled frames
    carry the column exact."""
    from spark_rapids_tpu_torch import perfcounters as PC

    n = 120_000
    conf = {"spark.rapids.tpu.test.deviceMemoryBytes": str(512 << 10),
            "spark.rapids.sql.batchSizeBytes": 1 << 20,
            "spark.rapids.sql.reader.batchSizeRows": n // 16,
            "spark.rapids.tpu.exchange.maxPartitions": 16,
            "spark.sql.adaptive.enabled": False}
    rng = np.random.default_rng(SEED + 2)
    arrays = {"ts": rng.integers(-10 ** 6, 10 ** 6, n) * 1_000_003,
              "i": rng.integers(0, 100, n).astype(np.int32)}
    sch = T.StructType([T.StructField("ts", T.TIMESTAMP),
                        T.StructField("i", T.INT)])
    s = S.TpuSession(conf, device="cpu")
    q = frame(S, s, arrays, sch).repartition(2, S.col("ts")).group_by(
        S.col("ts")).agg(S.sum_(S.col("i"), "t"))
    assert "sized 2->16 partitions" in q.explain()
    snap = PC.snapshot()
    got = q.collect()
    assert PC.since(snap)["exchange_host_blocks"] > 0
    want = {}
    for t_, i in zip(arrays["ts"].tolist(), arrays["i"].tolist()):
        want[t_] = want.get(t_, 0) + i
    assert sorted((int((r[0] - dt.datetime(1970, 1, 1, tzinfo=UTC))
                       // dt.timedelta(microseconds=1)), r[1])
                  for r in got) == sorted(want.items())


def test_timestamp_round_trip_through_writer_and_k1(tmp_path):
    """A TIMESTAMP written by the port's writer (INT64, TIMESTAMP_MICROS,
    dictionary pages) reads back exact through the port's decoder (K1's
    plain version on the CPU), and pyarrow reads the annotation as
    microseconds."""
    import pyarrow.parquet as pq

    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.io.parquet_encode import write_parquet_device

    arrays, validity = times_table(SEED)
    sch = T.StructType([T.StructField("ts", T.TIMESTAMP),
                        T.StructField("ts2", T.TIMESTAMP)])
    path = str(tmp_path / "ts.parquet")
    cols = [HostColumn.from_numpy(arrays[f.name], f.dataType,
                                  validity[f.name]) for f in sch.fields]
    write_parquet_device(path, sch, cols, len(arrays["ts"]), device="cpu")
    pa_type = pq.read_schema(path).field("ts").type
    assert str(pa_type).startswith("timestamp[us")
    got = S.TpuSession({"spark.rapids.sql.format.parquet.decode.device":
                        True}, device="cpu").read.schema(sch).parquet(
        path).collect()
    epoch = dt.datetime(1970, 1, 1, tzinfo=UTC)
    for j, name in enumerate(("ts", "ts2")):
        want = [epoch + dt.timedelta(microseconds=int(v)) if ok else None
                for v, ok in zip(arrays[name], validity[name])]
        assert [r[j] for r in got] == want


def test_tzdb_equals_the_reference_across_a_gap_and_an_overlap():
    """``tzdb``'s tables equal the reference's for every zone of the
    table; in America/Los_Angeles the wall time 02:30 of the spring gap
    maps forward to 10:30 UTC and 01:30 of the autumn overlap takes the
    earlier offset (-7 h), as java.time resolves them."""
    from spark_rapids_tpu import tzdb as R
    from spark_rapids_tpu_torch import tzdb as P
    from torch_port_times import ZONES, _us

    for zone in ZONES:
        a, b = P.zone_tables(zone), R.zone_tables(zone)
        for key in ("utc_instants", "wall_starts", "offsets"):
            assert np.array_equal(a[key], b[key]), (zone, key)
    assert not P.is_known_zone("Mars/Olympus_Mons")
    rows = _one_ts(S, T, S.TpuSession({}, device="cpu"), lambda X_, c:
                   X_.D.ToUTCTimestamp(c("ts"), S.lit("America/Los_Angeles")),
                   [_us(2019, 3, 10, 2, 30), _us(2019, 11, 3, 1, 30)])
    assert rows == [dt.datetime(2019, 3, 10, 10, 30, tzinfo=UTC),
                    dt.datetime(2019, 11, 3, 8, 30, tzinfo=UTC)]


def test_negative_rows_offset_runs_in_a_cpu_stage():
    """``("rows", -1, 1)`` frames the row after (tagged off the device by
    the reference's rule, run by the port's CPU engine with the oracle's
    rows)."""
    from spark_rapids_tpu.plan.nodes import WindowFunction as RWF
    from spark_rapids_tpu_torch.plan.nodes import WindowFunction as PWF

    def q(mod, types, session, WF):
        return _key_frame(mod, types, session).window(
            [WF("sum", mod.col("i"), "x"), WF("max", mod.col("i"), "y")],
            partition_by=["k"], order_by=[mod.col("ts"), mod.col("i")],
            frame=("rows", -1, 2))
    w = q(S, T, S.TpuSession({}, device="cpu"), PWF)
    assert "offsets must be non-negative" in w.explain()
    assert rows_key(w.collect()) == rows_key(
        q(RS, RT, RS.TpuSession(ORACLE), RWF).collect())


def test_r32_string_to_boolean_trims():
    """R32: cast(' true ' AS BOOLEAN).  The reference's device compares
    the untrimmed string (null), its oracle trims (true), as Spark
    does; the port trims."""
    def run(mod, types, session):
        sch = types.StructType([types.StructField("s", types.STRING)])
        df = frame(mod, session, {"s": np.array([" true ", "no\t", "y"],
                                                object)}, sch)
        return [r[0] for r in df.select(mods(mod).C(
            mod.col("s"), types.BOOLEAN).alias("v")).collect()]

    assert run(S, T, S.TpuSession({}, device="cpu")) == [True, False, True]
    assert run(RS, RT, RS.TpuSession(ORACLE)) == [True, False, True]


def test_string_casts_are_in_the_table():
    """Every pair of the reference's ``_CASTS`` is in the port's, and the
    two tables name the same pairs."""
    from spark_rapids_tpu.expr import cast as RC
    from spark_rapids_tpu_torch.expr import cast as PC

    assert set(PC._CASTS) == set(RC._CASTS)
    assert not hasattr(PC, "STRING_CASTS")

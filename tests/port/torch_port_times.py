"""A seeded table of TIMESTAMP, DATE and string edge cases, and the date,
time and string-cast expressions of slice 17 built in either package, for
the CPU tests against the reference (``test_torch_timestamps.py``) and
the card test (``test_torch_gpu.py``).  Imports numpy only, so the card's
machine (no jax) can use it.

The table holds instants before 1970 and at -1 microsecond, 29 February,
the year 10000 edge (a string, a ``make_date`` and the last microsecond of
9999), and a DST gap and overlap in America/Los_Angeles (2019-03-10
02:30 and 2019-11-03 01:30 as wall times; 2019-03-10 10:00 and
2019-11-03 09:00 UTC as instants); strings that parse and strings that do
not, for every string cast."""
import datetime as dt
import importlib
import types as _types
from decimal import Decimal

import numpy as np

N_ROWS = 256
_EPOCH = dt.datetime(1970, 1, 1)


def _us(*args) -> int:
    return (dt.datetime(*args) - _EPOCH) // dt.timedelta(microseconds=1)


def _days(*args) -> int:
    return (dt.date(*args) - dt.date(1970, 1, 1)).days


#: TIMESTAMP edges: around the epoch, before 1970, 29 February, the DST
#: gap and overlap of America/Los_Angeles as wall times and as instants
TS_EDGES = (-1, 0, 1, _us(2019, 12, 30, 0, 0, 1, 500000),
            _us(1969, 12, 31, 23, 59, 59), _us(1900, 1, 1, 12, 34, 56, 789),
            _us(2000, 2, 29, 23, 59, 59, 999999), _us(2024, 2, 29, 6, 0),
            _us(2019, 3, 10, 2, 30), _us(2019, 11, 3, 1, 30),
            _us(2019, 3, 10, 10, 0), _us(2019, 11, 3, 9, 0),
            _us(2019, 3, 10, 9, 59, 59, 999999), _us(1066, 10, 14, 9, 0),
            _us(2013, 7, 14, 23, 59, 30))
TS2_EDGES = (_us(9999, 12, 31, 23, 59, 59, 999999), 0, -1,
             _us(2020, 1, 31, 0, 0), _us(2019, 12, 31, 23, 0),
             _us(1900, 3, 1), _us(2000, 3, 31, 23, 59, 59, 999999))
D_EDGES = (-1, 0, _days(2019, 12, 30), _days(2000, 2, 29),
           _days(2024, 2, 29), _days(1900, 3, 1), _days(1969, 1, 1),
           _days(2019, 3, 10), _days(2021, 1, 3), _days(9999, 6, 30))
#: strings for the DATE and TIMESTAMP parses: valid, then invalid
TIME_STRINGS_OK = (
    "2019-12-30", " 2020-02-29T10:11:12.5Z", "1969-12-31 23:59:59.999999",
    "2019-3-5", "2019-03-10 02:30:00", "2019-11-03T01:30", "2021",
    "2021-07", "2019-12-30 00:00:01.123456789", "1900-01-01 00:00:00+08:00",
    "2000-02-29 12:00:00-0530", "2013-07-14T23:59:30z", "9999-12-31",
    "1970-01-01 00:00:00 ", "2019-12-30T5:6:7", "2019-06-15 1:02:03-8",
    "02019-01-01")
TIME_STRINGS_BAD = (
    "10000-01-01", "2019-02-29", "2019-13-01", "2019-12-32", "", "   ",
    "19-1-1", "2019/12/30", "2019-12-30X", "2019-12-30 25:00:00",
    "2019-12-30 12:60", "2019-12-30 12:00:00 UTC", "abc",
    "2019-12-30 12:00:00+19:00", "2019-12-30T", "2019-1-1 1:2:3.",
    "1234567-01-01")
#: strings for the integral, boolean and floating parses
NUM_STRINGS_OK = (
    "123", " -45 ", "+7", "0", "9223372036854775807",
    "-9223372036854775808", "1", "-1", "2147483647", "-2147483648",
    "127", "-128", "00042")
NUM_STRINGS_BAD = (
    "9223372036854775808", "-9223372036854775809", "12a", "", "1.5",
    "true", "No", "Y", "1e3", "NaN", "-Infinity", "1.5d", "0x10", "+",
    "- 1", "99999999999999999999")
BOOL_STRINGS = ("true", "FALSE", "t", "F", "yes", "No", "y", "n", "1", "0",
                "maybe", "", "tru", " true")
DOUBLE_STRINGS = ("1.5", "-0.0", "NaN", "Infinity", "-Infinity", "1e308",
                  "1e309", "4.9e-324", " 12 ", "1.5d", "2f", "0x1p3", "abc",
                  "inf", "1_000", "")
ZONES = ("America/Los_Angeles", "UTC", "Asia/Kolkata", "Europe/Berlin",
         "Australia/Lord_Howe")
L_EDGES = (2 ** 63 - 1, -2 ** 63, 0, -1, 2 ** 31, 9223372036854,
           9223372036855, -9223372036855)
X_EDGES = (0.1, -0.0, float("nan"), float("inf"), float("-inf"), 1e7,
           9999999.0, 1e-3, 9.999e-4, 123456789.125, 1.0, -2.5e-5, 5e-324,
           1.7976931348623157e308, 100.0)
M_EDGES = (0, -1, 1, 999_999_999, -999_999_999, 5, -5, 1000, -12_345)
#: (year, month, day) for make_date: valid, then invalid
YMD_EDGES = ((2019, 12, 30), (2000, 2, 29), (1, 1, 1), (9999, 12, 30),
             (2019, 2, 29), (2019, 13, 1), (0, 1, 1), (10000, 1, 1),
             (2019, 4, 31), (2019, 0, 10))
#: seconds of make_timestamp, unscaled at scale 6: 60 exactly rolls over
SEC_EDGES = (0, 59_999_999, 60_000_000, 60_000_001, 30_500_000, 1)


def _edges(out, edges):
    k = min(len(edges), len(out))
    out[:k] = np.array(list(edges[:k]), dtype=out.dtype)
    return out


def _pool(rng, n, good, bad=()):
    """``n`` strings: the pools' values in turn first, then drawn."""
    vals = list(good) + list(bad)
    out = np.array([vals[i] if i < len(vals) else
                    vals[rng.integers(0, len(vals))] for i in range(n)],
                   object)
    return out


def times_table(seed: int, n: int = N_ROWS, clean: bool = False):
    """(arrays, validity) of the table; ``clean`` draws every string,
    ``make_date`` and ``make_timestamp`` argument from the valid pools
    only (so that an ANSI session raises nowhere), at the same seed."""
    rng = np.random.default_rng(seed)
    lo, hi = _us(1900, 1, 1), _us(2100, 1, 1)
    ts = _edges(rng.integers(lo, hi, n), TS_EDGES)
    ts2 = _edges(rng.integers(lo, hi, n), TS2_EDGES)
    d = _edges(rng.integers(_days(1900, 1, 1), _days(2100, 1, 1), n)
               .astype(np.int32), D_EDGES)
    bad = (lambda pool: ()) if clean else (lambda pool: pool)
    ymd = np.array([YMD_EDGES[i % (4 if clean else len(YMD_EDGES))]
                    if i < 24 else (rng.integers(1900, 2100),
                                    rng.integers(1, 13),
                                    rng.integers(1, 29))
                    for i in range(n)], np.int32)
    sec = _edges(rng.integers(0, 60_000_000, n), SEC_EDGES[:3] if clean
                 else SEC_EDGES)
    arrays = {
        "ts": ts, "ts2": ts2, "d": d,
        "s": _pool(rng, n, TIME_STRINGS_OK, bad(TIME_STRINGS_BAD)),
        "ns": _pool(rng, n, NUM_STRINGS_OK, bad(NUM_STRINGS_BAD)),
        "bs": _pool(rng, n, BOOL_STRINGS[:10], bad(BOOL_STRINGS[10:])),
        "xs": _pool(rng, n, DOUBLE_STRINGS[:11], bad(DOUBLE_STRINGS[11:])),
        "tz": _pool(rng, n, ZONES),
        "l": _edges(rng.integers(-2 ** 40, 2 ** 40, n), L_EDGES),
        "secs": rng.integers(-2_000_000_000, 4_000_000_000, n),
        "i": rng.integers(-100_000, 100_000, n).astype(np.int32),
        "b": rng.random(n) > 0.5,
        "m": _edges(rng.integers(-10 ** 9, 10 ** 9, n), M_EDGES),
        "x": _edges(rng.standard_normal(n) * 10.0 ** rng.integers(-5, 9, n),
                    X_EDGES),
        "f": (rng.standard_normal(n) * 10.0 ** rng.integers(-4, 8, n))
        .astype(np.float32),
        "k": rng.integers(-30, 31, n).astype(np.int32),
        "y": ymd[:, 0], "mo": ymd[:, 1], "dd": ymd[:, 2],
        "hh": rng.integers(0, 24, n).astype(np.int32),
        "mi": rng.integers(0, 60, n).astype(np.int32),
        "sec": sec,
    }
    if not clean:
        arrays["hh"][:3] = (24, -1, 23)
    validity = {name: rng.random(n) > 0.08 for name in arrays}
    for name in validity:
        validity[name][:24] = True
    return arrays, validity


def times_schema(T):
    f = T.StructField
    return T.StructType([
        f("ts", T.TIMESTAMP), f("ts2", T.TIMESTAMP), f("d", T.DATE),
        f("s", T.STRING), f("ns", T.STRING), f("bs", T.STRING),
        f("xs", T.STRING), f("tz", T.STRING), f("l", T.LONG),
        f("secs", T.LONG), f("i", T.INT), f("b", T.BOOLEAN),
        f("m", T.DecimalType(10, 3)), f("x", T.DOUBLE), f("f", T.FLOAT),
        f("k", T.INT), f("y", T.INT), f("mo", T.INT), f("dd", T.INT),
        f("hh", T.INT), f("mi", T.INT), f("sec", T.DecimalType(8, 6))])


def mods(session_mod):
    """The datetime module, ``Cast``, the types and ``lit`` of the package
    whose session module is ``session_mod``."""
    pkg = session_mod.__name__.rsplit(".", 1)[0]
    return _types.SimpleNamespace(
        D=importlib.import_module(f"{pkg}.expr.datetime"),
        C=importlib.import_module(f"{pkg}.expr.cast").Cast,
        H=importlib.import_module(f"{pkg}.expr.hashexprs"),
        T=importlib.import_module(f"{pkg}.types"), lit=session_mod.lit)


def _cast(col, tname):
    return lambda X, c: X.C(c(col), getattr(X.T, tname))


_TRUNC_UNITS = ("year", "quarter", "month", "week", "day", "hour",
                "minute", "second", "millisecond", "microsecond", "bad")
_ADD_UNITS = ("microsecond", "second", "hour", "day", "week", "month",
              "quarter", "year", "bad")
_DIFF_UNITS = ("second", "hour", "day", "week", "month", "quarter",
               "year", "bad")

#: cases both packages run on the device: name -> builder(X, col)
CASES = {
    "hour": lambda X, c: X.D.Hour(c("ts")),
    "minute": lambda X, c: X.D.Minute(c("ts")),
    "second": lambda X, c: X.D.Second(c("ts")),
    "unix_timestamp": lambda X, c: X.D.UnixTimestamp(c("ts")),
    "unix_timestamp_date": lambda X, c: X.D.UnixTimestamp(c("d")),
    "to_unix_timestamp": lambda X, c: X.D.ToUnixTimestamp(c("ts")),
    "next_day": lambda X, c: X.D.NextDay(c("d"), X.lit("Mon")),
    "next_day_ts": lambda X, c: X.D.NextDay(c("ts"), X.lit(" friday ")),
    "next_day_bad": lambda X, c: X.D.NextDay(c("d"), X.lit("xx")),
    "from_unixtime": lambda X, c: X.D.FromUnixTime(
        c("secs"), X.lit("yyyy-MM-dd HH:mm:ss")),
    "date_format": lambda X, c: X.D.DateFormat(c("ts"),
                                               X.lit("yyyy/MM/dd")),
    "date_format_date": lambda X, c: X.D.DateFormat(
        c("d"), X.lit("HH:mm dd.MM.yyyy")),
    "from_utc_la": lambda X, c: X.D.FromUTCTimestamp(
        c("ts"), X.lit("America/Los_Angeles")),
    "to_utc_la": lambda X, c: X.D.ToUTCTimestamp(
        c("ts"), X.lit("America/Los_Angeles")),
    "from_utc_kolkata": lambda X, c: X.D.FromUTCTimestamp(
        c("ts"), X.lit("Asia/Kolkata")),
    "to_utc_berlin": lambda X, c: X.D.ToUTCTimestamp(
        c("ts"), X.lit("Europe/Berlin")),
    "to_utc_lord_howe": lambda X, c: X.D.ToUTCTimestamp(
        c("ts"), X.lit("Australia/Lord_Howe")),
    "weekday": lambda X, c: X.D.WeekDay(c("d")),
    "weekday_ts": lambda X, c: X.D.WeekDay(c("ts")),
    "make_date": lambda X, c: X.D.MakeDate(c("y"), c("mo"), c("dd")),
    "make_timestamp": lambda X, c: X.D.MakeTimestamp(
        c("y"), c("mo"), c("dd"), c("hh"), c("mi"), c("sec")),
    "timestamp_seconds": lambda X, c: X.D.TimestampSeconds(c("secs")),
    "timestamp_seconds_double": lambda X, c: X.D.TimestampSeconds(c("x")),
    "timestamp_millis": lambda X, c: X.D.TimestampMillis(c("secs")),
    "timestamp_micros": lambda X, c: X.D.TimestampMicros(c("secs")),
    "unix_date": lambda X, c: X.D.UnixDate(c("d")),
    "date_from_unix_date": lambda X, c: X.D.DateFromUnixDate(c("i")),
    "unix_seconds": lambda X, c: X.D.UnixSeconds(c("ts")),
    "unix_millis": lambda X, c: X.D.UnixMillis(c("ts")),
    "unix_micros": lambda X, c: X.D.UnixMicros(c("ts")),
    "to_date_ts": lambda X, c: X.D.ToDate(c("ts")),
    "to_date_str": lambda X, c: X.D.ToDate(c("s")),
    "to_timestamp_str": lambda X, c: X.D.ToTimestamp(c("s")),
    "to_timestamp_date": lambda X, c: X.D.ToTimestamp(c("d")),
    **{f"date_trunc_{u}": (lambda u: lambda X, c: X.D.TruncTimestamp(
        X.lit(u), c("ts")))(u) for u in _TRUNC_UNITS},
    **{f"timestampadd_{u}": (lambda u: lambda X, c: X.D.TimestampAdd(
        u, c("k"), c("ts")))(u) for u in _ADD_UNITS},
    **{f"timestampdiff_{u}": (lambda u: lambda X, c: X.D.TimestampDiff(
        u, c("ts"), c("ts2")))(u) for u in _DIFF_UNITS},
    "convert_timezone": lambda X, c: X.D.ConvertTimezone(
        "America/Los_Angeles", "UTC", c("ts")),
    "convert_timezone_2": lambda X, c: X.D.ConvertTimezone(
        "Europe/Berlin", "Asia/Kolkata", c("ts")),
    "monthname": lambda X, c: X.D.MonthName(c("d")),
    "dayname": lambda X, c: X.D.DayName(c("ts")),
    "date_part_year": lambda X, c: X.D.DatePart("year", c("ts")),
    "date_part_doy": lambda X, c: X.D.DatePart("doy", c("d")),
    "date_part_hour": lambda X, c: X.D.DatePart("hour", c("ts")),
    "to_date_fmt": lambda X, c: X.D.ParseToDate(c("s"),
                                                X.lit("yyyy-MM-dd")),
    "to_timestamp_fmt": lambda X, c: X.D.ParseToTimestamp(
        c("s"), X.lit("yyyy-MM-dd HH:mm:ss")),
    "try_to_timestamp": lambda X, c: X.D.TryToTimestamp(c("s")),
    **{f"extract_{f}": (lambda f: lambda X, c: X.D.Extract(
        X.lit(f), c("ts")))(f)
       for f in ("year", "yearofweek", "month", "day", "dayofweek", "doy",
                 "quarter", "week", "hour", "minute", "second")},
    "extract_month_date": lambda X, c: X.D.Extract(X.lit("mon"), c("d")),
    "cast_int_str": _cast("i", "STRING"),
    "cast_long_str": _cast("l", "STRING"),
    "cast_bool_str": _cast("b", "STRING"),
    "cast_dec_str": _cast("m", "STRING"),
    "cast_date_str": _cast("d", "STRING"),
    "cast_ts_str": _cast("ts", "STRING"),
    "cast_ts2_str": _cast("ts2", "STRING"),
    "cast_double_str": _cast("x", "STRING"),
    "cast_float_str": _cast("f", "STRING"),
    "cast_str_int": _cast("ns", "INT"),
    "cast_str_long": _cast("ns", "LONG"),
    "cast_str_byte": _cast("ns", "BYTE"),
    "cast_str_bool": _cast("bs", "BOOLEAN"),
    "cast_str_date": _cast("s", "DATE"),
    "cast_str_ts": _cast("s", "TIMESTAMP"),
    "cast_str_double": _cast("xs", "DOUBLE"),
    "cast_str_float": _cast("xs", "FLOAT"),
    "cast_null_str": lambda X, c: X.C(X.lit(None), X.T.STRING),
    "cast_ts_date": _cast("ts", "DATE"),
    "cast_ts_long": _cast("ts", "LONG"),
}

#: cases whose result depends on ANSI: on the clean table each gives the
#: same rows with ANSI on; on the full table each raises with ANSI on
ANSI_CASES = ("cast_str_long", "cast_str_bool",
              "cast_str_date", "cast_str_ts", "cast_str_double",
              "make_date", "make_timestamp")
#: an ANSI overflow of ``timestamp_seconds`` (``l`` holds 2^63 - 1)
ANSI_OVERFLOW = {
    "timestamp_seconds_overflow": lambda X, c: X.D.TimestampSeconds(c("l")),
}

#: shapes the reference's rules tag off the device: name -> (builder,
#: the reason's words); the port runs them in its CPU engine
TAGGED_OFF = {
    "date_format_wide": (lambda X, c: X.D.DateFormat(
        c("ts"), X.lit("EEE, dd MMM yyyy a")), "unsupported pattern"),
    "from_unixtime_wide": (lambda X, c: X.D.FromUnixTime(
        c("secs"), X.lit("EEEE MMMM DD")), "unsupported pattern"),
    "from_utc_zone_column": (lambda X, c: X.D.FromUTCTimestamp(
        c("ts"), c("tz")), "timezone must be a literal"),
    "to_utc_zone_column": (lambda X, c: X.D.ToUTCTimestamp(
        c("ts"), c("tz")), "timezone must be a literal"),
    "to_date_other_pattern": (lambda X, c: X.D.ParseToDate(
        c("s"), X.lit("dd/MM/yyyy")), "outside the default-grammar"),
    "to_timestamp_other_pattern": (lambda X, c: X.D.ParseToTimestamp(
        c("s"), X.lit("yyyy/MM/dd HH")), "outside the default-grammar"),
    "hive_hash_ts": (lambda X, c: X.H.HiveHash([c("ts"), c("i")]),
                     "hive_hash of timestamp"),
    "cast_str_ts_conf_off": (_cast("s", "TIMESTAMP"),
                             "string->timestamp cast is disabled"),
}
#: the session conf of each tagged-off shape (the string -> timestamp
#: cast's switch off)
TAGGED_CONF = {"cast_str_ts_conf_off": {
    "spark.rapids.sql.castStringToTimestamp.enabled": "false"}}
#: unknown zones: tagged off, and the CPU engine raises as the
#: reference's oracle raises
UNKNOWN_ZONE = {
    "to_utc_unknown_zone": (lambda X, c: X.D.ToUTCTimestamp(
        c("ts"), X.lit("Mars/Olympus_Mons")), "unknown or unsupported"),
    "convert_timezone_unknown": (lambda X, c: X.D.ConvertTimezone(
        "Nowhere/Atlantis", "UTC", c("ts")), "unknown timezone"),
}


def select_cases(mod, df, cases):
    """``df`` with every case as a column named after it, in the package
    whose session module is ``mod``."""
    X = mods(mod)
    return df.select(*[(b[0] if isinstance(b, tuple) else b)(X, mod.col)
                       .alias(n) for n, b in cases.items()])


def columns(rows, cases):
    return {n: [r[i] for r in rows] for i, n in enumerate(cases)}


def encode(v):
    """A collected value as JSON: a float by its hex, a Decimal by its
    string, a datetime or date by its ISO form."""
    if isinstance(v, float):
        return {"f": v.hex()}
    if isinstance(v, Decimal):
        return {"d": str(v)}
    if isinstance(v, dt.datetime):
        return {"t": v.isoformat()}
    if isinstance(v, dt.date):
        return {"D": v.isoformat()}
    return v


def decode(v):
    if isinstance(v, dict):
        if "f" in v:
            return float.fromhex(v["f"])
        if "d" in v:
            return Decimal(v["d"])
        if "t" in v:
            return dt.datetime.fromisoformat(v["t"])
        return dt.date.fromisoformat(v["D"])
    return v


def same(a, b) -> bool:
    """Equal values of one type; NaN equals NaN."""
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return a == b and type(a) is type(b)

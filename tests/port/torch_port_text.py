"""Seeded string and date columns, and the string and date expressions of
slice 12 built in either package, for the CPU tests against the reference
(``test_torch_string_funcs.py``, ``test_torch_datetime.py``) and the card
tests (``test_torch_gpu.py``).  Imports numpy only, so the card's machine
(no jax) can use it."""
import datetime as dt
import importlib

import numpy as np

#: pieces the strings are drawn from: ASCII, spaces, LIKE's wildcards and
#: escape as data, 2-, 3- and 4-byte UTF-8
PIECES = ("", "a", "abc", "Hello", "World", "  pad  ", "special",
          "requests", "x_y%z", "back\\slash", "Customer", "Complaints",
          "MEDIUM POLISHED", "13-555-0199", "green", "e", "ünïcødé",
          "straße", "日本語", "テキスト", "😀", "naïve café",
          "HELLO", "hello", "H.llo", "c\na")
NEEDLES = ("", "a", "e", "l", "ab", "requests", "é", "本", "😀", " ",
           "Customer", "zz", "x_y", "%")
WIDTHS = (8, 32, 128)
EPOCH = dt.date(1970, 1, 1)
US_PER_DAY = 86_400_000_000
#: dates every date test holds: 0001-01-01, before 1970, leap days,
#: month ends, ISO week boundaries, 9999-12-31
EDGE_DATES = tuple(dt.date(*t) for t in (
    (1, 1, 1), (1, 12, 31), (999, 12, 31), (1000, 1, 1), (1582, 10, 15),
    (1900, 2, 28), (1900, 3, 1), (1969, 12, 31), (1970, 1, 1),
    (1999, 12, 31), (2000, 2, 29), (2000, 3, 31), (2001, 2, 28),
    (2004, 2, 29), (2020, 12, 31), (2021, 1, 3), (2021, 1, 4),
    (2023, 1, 31), (2023, 5, 31), (2024, 2, 29), (2026, 12, 28),
    (2027, 1, 1), (9999, 12, 31)))


def _cut(s: str, max_bytes: int) -> str:
    """``s`` cut to at most ``max_bytes`` UTF-8 bytes on a character
    boundary."""
    return s.encode()[:max_bytes].decode("utf-8", "ignore")


def string_table(seed: int, width: int, n: int = 600):
    """(arrays, validity) of ``n`` rows: ``s`` 1 to 4 + width / 8 pieces
    joined by spaces, at most ``width - 1`` bytes (so the column takes the
    ``width`` bucket of the ladder); ``t`` a needle; integer arguments
    ``pos``, ``ln``, ``k``, ``st``; about a tenth of each column null."""
    rng = np.random.default_rng(seed)
    s = np.array([_cut(" ".join(PIECES[j] for j in rng.integers(
        0, len(PIECES), rng.integers(1, 5 + width // 8))), width - 1)
        for _ in range(n)], object)
    t = np.array([NEEDLES[j] for j in rng.integers(0, len(NEEDLES), n)],
                 object)
    arrays = {"s": s, "t": t,
              "pos": rng.integers(-6, 12, n).astype(np.int32),
              "ln": rng.integers(-2, 10, n).astype(np.int32),
              "k": rng.integers(-2, 12, n).astype(np.int32),
              "st": rng.integers(-1, 8, n).astype(np.int32)}
    validity = {name: rng.random(n) > 0.1 for name in arrays}
    return arrays, validity


def date_table(seed: int, n: int = 3000):
    """(arrays, validity): ``d`` and ``d2`` days from 0001-03-01 to
    9999-10-31 with ``EDGE_DATES`` among them (but for 0001-01-01 and
    9999-12-31 shifted in, so that ``add_months`` by at most 2 stays in
    range), ``m`` months in [-2, 2], ``k`` days in [-40, 40]; a tenth of
    each null."""
    rng = np.random.default_rng(seed)
    lo = (dt.date(1, 3, 1) - EPOCH).days
    hi = (dt.date(9999, 10, 31) - EPOCH).days
    d = rng.integers(lo, hi + 1, n).astype(np.int32)
    edges = np.clip([(x - EPOCH).days for x in EDGE_DATES], lo, hi)
    d[:len(edges)] = edges
    d2 = rng.integers(lo, hi + 1, n).astype(np.int32)
    d2[len(edges):2 * len(edges)] = edges          # equal and month-end pairs
    d2[:len(edges)] = edges[::-1]
    arrays = {"d": d, "d2": d2,
              "m": rng.integers(-2, 3, n).astype(np.int32),
              "k": rng.integers(-40, 41, n).astype(np.int32)}
    validity = {name: rng.random(n) > 0.1 for name in arrays}
    for name in validity:
        validity[name][:2 * len(edges)] = True
    # ``ts`` and ``ts2``: TIMESTAMPs (microseconds, UTC) on ``d`` and
    # ``d2``'s days at a random time of day, so that a day before 1970
    # floors; drawn last, so that the date columns stay as they were
    for name, day in (("ts", d), ("ts2", d2)):
        arrays[name] = day.astype(np.int64) * US_PER_DAY + rng.integers(
            0, US_PER_DAY, n)
        validity[name] = validity["d" if name == "ts" else "d2"].copy()
    return arrays, validity


def string_schema(T):
    return T.StructType([T.StructField("s", T.STRING),
                         T.StructField("t", T.STRING),
                         T.StructField("pos", T.INT),
                         T.StructField("ln", T.INT),
                         T.StructField("k", T.INT),
                         T.StructField("st", T.INT)])


def date_schema(T):
    return T.StructType([T.StructField("d", T.DATE),
                         T.StructField("d2", T.DATE),
                         T.StructField("m", T.INT),
                         T.StructField("k", T.INT)])


def timestamp_schema(T):
    """``date_schema`` and the TIMESTAMPs ``ts`` and ``ts2``."""
    return T.StructType(date_schema(T).fields
                        + [T.StructField("ts", T.TIMESTAMP),
                           T.StructField("ts2", T.TIMESTAMP)])


#: string cases: name -> builder(S, col, lit); ``BYTE_CUTS`` are byte-
#: based on the card (and in the reference's device path), so the
#: reference's oracle agrees with them on ASCII rows only
STRING_CASES = {
    "length": lambda S, c, l: S.Length(c("s")),
    "octet_length": lambda S, c, l: S.OctetLength(c("s")),
    "bit_length": lambda S, c, l: S.BitLength(c("s")),
    "upper": lambda S, c, l: S.Upper(c("s")),
    "lower": lambda S, c, l: S.Lower(c("s")),
    "substring": lambda S, c, l: S.Substring(c("s"), c("pos"), c("ln")),
    "substring_lit": lambda S, c, l: c("s").substr(2, 3),
    "left": lambda S, c, l: S.StringLeft(c("s"), c("k")),
    "right": lambda S, c, l: S.StringRight(c("s"), c("k")),
    "concat": lambda S, c, l: S.Concat([c("s"), l("|"), c("t")]),
    "startswith": lambda S, c, l: S.StartsWith(c("s"), c("t")),
    "endswith": lambda S, c, l: S.EndsWith(c("s"), c("t")),
    "contains": lambda S, c, l: S.Contains(c("s"), c("t")),
    "contains_lit": lambda S, c, l: S.Contains(c("s"), l("é")),
    "instr": lambda S, c, l: S.StringInstr(c("s"), c("t")),
    "locate": lambda S, c, l: S.StringLocate(c("t"), c("s"), c("st")),
    "trim": lambda S, c, l: S.StringTrim(c("s")),
    "ltrim": lambda S, c, l: S.StringTrimLeft(c("s")),
    "rtrim": lambda S, c, l: S.StringTrimRight(c("s")),
    "like_prefix": lambda S, c, l: S.Like(c("s"), l("Hello%")),
    "like_suffix": lambda S, c, l: S.Like(c("s"), l("%World")),
    "like_contains": lambda S, c, l: S.Like(c("s"), l("%ünï%")),
    "like_exact": lambda S, c, l: S.Like(c("s"), l("abc")),
    "like_inner": lambda S, c, l: S.Like(c("s"), l("%special%requests%")),
    "like_underscore": lambda S, c, l: S.Like(c("s"), l("H_llo%")),
    "like_escape": lambda S, c, l: S.Like(c("s"), l("%x\\_y\\%z%")),
    "like_multibyte_": lambda S, c, l: S.Like(c("s"), l("%stra_e%")),
    "ilike": lambda S, c, l: S.ILike(c("s"), l("%hello%")),
    "ilike_underscore": lambda S, c, l: S.ILike(c("s"), l("h_LLO%")),
    "rlike": lambda S, c, l: S.RLike(c("s"), l("c[oa]m")),
    "rlike_anchored": lambda S, c, l: S.RLike(c("s"), l("^[a-z]+ [^ ]+$")),
}
BYTE_CUTS = ("substring", "substring_lit", "left", "right")

#: date cases: name -> builder(D, col, lit)
DATE_CASES = {
    "year": lambda D, c, l: D.Year(c("d")),
    "month": lambda D, c, l: D.Month(c("d")),
    "dayofmonth": lambda D, c, l: D.DayOfMonth(c("d")),
    "dayofweek": lambda D, c, l: D.DayOfWeek(c("d")),
    "dayofyear": lambda D, c, l: D.DayOfYear(c("d")),
    "quarter": lambda D, c, l: D.Quarter(c("d")),
    "weekofyear": lambda D, c, l: D.WeekOfYear(c("d")),
    "last_day": lambda D, c, l: D.LastDay(c("d")),
    "date_add": lambda D, c, l: D.DateAdd(c("d"), c("k")),
    "date_sub": lambda D, c, l: D.DateSub(c("d"), c("k")),
    "datediff": lambda D, c, l: D.DateDiff(c("d"), c("d2")),
    "add_months": lambda D, c, l: D.AddMonths(c("d"), c("m")),
    "months_between": lambda D, c, l: D.MonthsBetween(c("d"), c("d2")),
    "trunc_year": lambda D, c, l: D.TruncDate(c("d"), l("year")),
    "trunc_quarter": lambda D, c, l: D.TruncDate(c("d"), l("quarter")),
    "trunc_month": lambda D, c, l: D.TruncDate(c("d"), l("mm")),
    "trunc_week": lambda D, c, l: D.TruncDate(c("d"), l("week")),
    "trunc_bad": lambda D, c, l: D.TruncDate(c("d"), l("day")),
}

#: the date functions over a TIMESTAMP: its day, floored (months_between
#: adds the time of day); the port runs these on columns (``eval_cases``;
#: TIMESTAMP columns through a session: ``test_torch_timestamps.py``)
TS_CASES = {
    "ts_year": lambda D, c, l: D.Year(c("ts")),
    "ts_month": lambda D, c, l: D.Month(c("ts")),
    "ts_dayofmonth": lambda D, c, l: D.DayOfMonth(c("ts")),
    "ts_dayofweek": lambda D, c, l: D.DayOfWeek(c("ts")),
    "ts_dayofyear": lambda D, c, l: D.DayOfYear(c("ts")),
    "ts_quarter": lambda D, c, l: D.Quarter(c("ts")),
    "ts_weekofyear": lambda D, c, l: D.WeekOfYear(c("ts")),
    "ts_last_day": lambda D, c, l: D.LastDay(c("ts")),
    "ts_add_months": lambda D, c, l: D.AddMonths(c("ts"), c("m")),
    "ts_months_between": lambda D, c, l: D.MonthsBetween(c("ts"), c("ts2")),
    "ts_months_between_date": lambda D, c, l: D.MonthsBetween(c("ts"),
                                                              c("d2")),
    "ts_trunc_month": lambda D, c, l: D.TruncDate(c("ts"), l("month")),
    "ts_trunc_week": lambda D, c, l: D.TruncDate(c("ts"), l("week")),
}


def eval_cases(arrays, validity, schema, cases, device="cpu"):
    """The port's column of each case of ``cases`` (name -> list of Python
    values), each expression resolved against ``schema`` and evaluated on
    one batch of ``arrays`` on ``device``."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.expr import datetime as D
    from spark_rapids_tpu_torch.expr.base import EvalContext
    from spark_rapids_tpu_torch.session import col, lit

    fields = schema.fields
    batch = ColumnarBatch.from_host_columns(
        [HostColumn.from_numpy(arrays[f.name], f.dataType,
                               validity[f.name]) for f in fields],
        [f.name for f in fields], device)
    out = {}
    for name, build in cases.items():
        e = build(D, col, lit).resolve(schema)
        c = e.eval_tpu(EvalContext(batch))
        out[name] = c.to_host(batch.num_rows).to_pylist()
    return out


def select_cases(mod, df, cases, module: str):
    """``df`` with every case of ``cases`` as a column named after it, in
    the package whose session module is ``mod``; ``module`` is the
    expressions' module (``expr.strings`` or ``expr.datetime``)."""
    E = importlib.import_module(mod.__name__.rsplit(".", 1)[0] + "."
                                + module)
    return df.select(*[build(E, mod.col, mod.lit).alias(name)
                       for name, build in cases.items()])

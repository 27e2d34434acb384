"""The date functions of slice 12 (``expr/datetime.py``) and the
civil-calendar math of ``expr/cast.py`` against the reference: seeded days
from 0001-03-01 to 9999-10-31 with leap days, month ends, days before 1970
and before year 1000, and ISO week boundaries among them
(``torch_port_text.py``), the port on the CPU against the reference's
device session (run in the child process, one call for the module) and
its CPU oracle.  Every comparison is exact, ``months_between``'s doubles
against the oracle included (against the reference's device, within one
unit in the last place: ``test_date_case_equals_reference``);
``civil_from_days`` and ``days_from_civil`` are held to
Python's calendar over every day from 0001-01-01 to 9999-12-31."""
import datetime as dt
import json
import math

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expr.cast import civil_from_days, days_from_civil
from torch_port_frames import ORACLE, frame
from torch_port_jaxref import run_jax
from torch_port_text import (DATE_CASES, EDGE_DATES, EPOCH, TS_CASES,
                             date_schema, date_table, eval_cases,
                             select_cases, timestamp_schema)

SEED = 13


def _frame(mod, types, session):
    arrays, validity = date_table(SEED)
    return frame(mod, session, arrays, date_schema(types), validity)


def _ts_frame(mod, types, session):
    arrays, validity = date_table(SEED)
    return frame(mod, session, arrays, timestamp_schema(types), validity)


def _columns(rows, cases=DATE_CASES):
    return {n: [r[i] for r in rows] for i, n in enumerate(cases)}


def _jsonable(cols):
    return {n: [v if not isinstance(v, dt.date) else v.isoformat()
                for v in c] for n, c in cols.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference device session's column of every case, the
    TIMESTAMP cases too, in one child call (dates as ISO strings)."""
    out = run_jax("""
    import json, sys
    sys.path.insert(0, "tests/port")
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import test_torch_datetime as M
    import torch_port_text as X
    get_device_manager(TpuConf({}))
    rows = X.select_cases(RS, M._frame(RS, T, RS.TpuSession({})),
                          X.DATE_CASES, "expr.datetime").collect()
    ts_rows = X.select_cases(RS, M._ts_frame(RS, T, RS.TpuSession({})),
                             X.TS_CASES, "expr.datetime").collect()
    cols = M._columns(rows)
    cols.update(M._columns(ts_rows, X.TS_CASES))
    out["json"] = np.array([json.dumps(M._jsonable(cols))])
    """, tmp_path_factory.mktemp("dateref"))
    return json.loads(str(out["json"][0]))


@pytest.fixture(scope="module")
def port_and_oracle():
    rows = select_cases(S, _frame(S, T, S.TpuSession({}, device="cpu")),
                        DATE_CASES, "expr.datetime").collect()
    orows = select_cases(RS, _frame(RS, RT, RS.TpuSession(ORACLE)),
                         DATE_CASES, "expr.datetime").collect()
    return _columns(rows), _columns(orows)


@pytest.mark.parametrize("name", list(DATE_CASES))
def test_date_case_equals_reference(name, reference, port_and_oracle):
    """Exact; but the reference's device ``months_between`` rounds through
    XLA, which divides by 1e8 as a multiply by its reciprocal: some of its
    doubles are one unit in the last place off the oracle's (which the
    port's equal), e.g. -1450.0967741900001 against -1450.09677419 for
    months_between(1900-03-01, 2021-01-04); the port is held to those
    within one unit in the last place."""
    got, oracle = (c[name] for c in port_and_oracle)
    assert got == oracle
    ref = reference[name]
    if name == "months_between":
        assert all(a == b or (a is not None and abs(a - b) <= math.ulp(b))
                   for a, b in zip(got, ref))
        return
    assert _jsonable({name: got})[name] == ref


@pytest.fixture(scope="module")
def timestamp_cases():
    """The port's TIMESTAMP cases, evaluated on a batch on the CPU
    (TIMESTAMP columns through a session: ``test_torch_timestamps.py``),
    and the reference oracle's."""
    arrays, validity = date_table(SEED)
    got = eval_cases(arrays, validity, timestamp_schema(T), TS_CASES)
    orows = select_cases(RS, _ts_frame(RS, RT, RS.TpuSession(ORACLE)),
                         TS_CASES, "expr.datetime").collect()
    return got, _columns(orows, TS_CASES)


@pytest.mark.parametrize("name", list(TS_CASES))
def test_timestamp_case_equals_reference(name, reference, timestamp_cases):
    """A TIMESTAMP is read as its day, floored, also before 1970: exact
    against the reference's device result and its oracle; but the
    ``months_between`` doubles within one unit in the last place of
    both, the reference's device rounding through a reciprocal
    (``test_date_case_equals_reference``) and its oracle adding the time
    of day in another order."""
    got, oracle = (c[name] for c in timestamp_cases)
    ref = reference[name]
    if name.startswith("ts_months_between"):
        for want in (oracle, ref):
            assert all(a == b or (a is not None and abs(a - b)
                                  <= math.ulp(b))
                       for a, b in zip(got, want))
        return
    assert got == oracle
    assert _jsonable({name: got})[name] == ref


def test_date_arithmetic_on_a_timestamp_stays_off_the_device():
    """``date_add``, ``date_sub`` and ``datediff`` take DATEs only: a
    TIMESTAMP input is tagged off the device with its reason."""
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.expr import datetime as D
    from spark_rapids_tpu_torch.expr.base import BoundReference
    from spark_rapids_tpu_torch.overrides.meta import wrap_expr

    ts = BoundReference(0, T.TIMESTAMP)
    k = BoundReference(1, T.INT)
    for e in (D.DateAdd(ts, k), D.DateSub(ts, k), D.DateDiff(ts, ts),
              D.Year(ts)):
        e._resolve_type()
        meta = wrap_expr(e, TpuConf({}))
        meta.tag_for_tpu()
        if isinstance(e, D.Year):
            assert meta.can_this_run
            continue
        assert not meta.can_this_run
        assert any("date arithmetic takes DATE inputs only" in r
                   for r in meta.cannot_run_reasons)


def test_cases_cover_the_calendars_edges():
    arrays, validity = date_table(SEED)
    days = set(arrays["d"][validity["d"]].tolist())
    lo = (dt.date(1, 3, 1) - EPOCH).days
    for d in EDGE_DATES:
        assert max((d - EPOCH).days, lo) in days \
            or d == dt.date(9999, 12, 31)
    dates = [EPOCH + dt.timedelta(days=int(x)) for x in days]
    assert any(x.month == 2 and x.day == 29 for x in dates)
    assert any(x.year < 1000 for x in dates)
    assert any((x + dt.timedelta(days=1)).day == 1 for x in dates)
    ts = arrays["ts"][validity["ts"]]       # days before 1970 floor
    assert (ts < 0).any() and (ts % 86_400_000_000 != 0).all()


def test_add_months_clamps_to_the_month_end():
    """Jan 31 + 1 month is Feb 28 or Feb 29; Mar 31 - 1 month Feb's end."""
    days = [(dt.date(*t) - EPOCH).days for t in
            ((2023, 1, 31), (2024, 1, 31), (2024, 3, 31), (1900, 1, 31),
             (2000, 1, 30), (1, 3, 31))]
    f = frame(S, S.TpuSession({}, device="cpu"),
              {"d": np.array(days, np.int32),
               "m": np.array([1, 1, -1, 1, 1, -2], np.int32)},
              T.StructType([T.StructField("d", T.DATE),
                            T.StructField("m", T.INT)]))
    D = __import__("spark_rapids_tpu_torch.expr.datetime",
                   fromlist=["AddMonths"])
    rows = f.select(D.AddMonths(S.col("d"), S.col("m")).alias("x")).collect()
    assert [r[0] for r in rows] == [
        dt.date(2023, 2, 28), dt.date(2024, 2, 29), dt.date(2024, 2, 29),
        dt.date(1900, 2, 28), dt.date(2000, 2, 29), dt.date(1, 1, 31)]


def test_civil_math_over_every_day():
    lo = (dt.date(1, 1, 1) - EPOCH).days
    hi = (dt.date(9999, 12, 31) - EPOCH).days
    days = torch.arange(lo, hi + 1)
    y, m, d = civil_from_days(days)
    assert torch.equal(days_from_civil(y, m, d), days)
    step = 7919                     # a prime stride over the range
    want = [EPOCH + dt.timedelta(days=int(x)) for x in days[::step]]
    assert list(zip(y[::step].tolist(), m[::step].tolist(),
                    d[::step].tolist())) == [(w.year, w.month, w.day)
                                             for w in want]
    assert np.array_equal(np.diff(d.numpy())[(np.diff(m.numpy()) == 0)],
                          np.ones(int((np.diff(m.numpy()) == 0).sum())))

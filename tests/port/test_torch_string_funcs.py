"""The string functions of slice 12 (``expr/strings.py``) and the regex
transpiler (``regex/``) against the reference: each case over seeded
columns of ASCII, multibyte UTF-8 (2 to 4 bytes), empty and null rows at
widths 8, 32 and 128 (``torch_port_text.py``), the port on the CPU against
the reference's device session (planned and run in the child process,
one call for the module) and its CPU oracle.  Every comparison is exact.
``substring``, ``left`` and ``right`` cut bytes on the device, in the
reference as in the port; the oracle cuts characters, so it is held to
them on ASCII rows only (ROADMAP, Differences that bind the port).  The
DFA tables equal the reference transpiler's for every pattern; a pattern
the transpiler rejects plans a CPU stage with the reference's reason, and
the CPU stage gives the oracle's rows."""
import json

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.regex import transpiler as RX
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.regex import transpiler as PX
from torch_port_frames import ORACLE, frame
from torch_port_jaxref import run_jax
from torch_port_text import (BYTE_CUTS, STRING_CASES, WIDTHS, select_cases,
                             string_schema, string_table)

SEED = 12
#: patterns the transpiler rejects: (function, pattern)
REJECTED = (("like", "%_é%"), ("ilike", "%ÜN_%"), ("rlike", "(l)\\1"),
            ("rlike", "\\bHello"))
LIKE_PATTERNS = ("abc", "abc%", "%abc", "%abc%", "%", "", "a_c",
                 "%special%requests%", "%Customer%Complaints%",
                 "MEDIUM POLISHED%", "x\\_y\\%z", "\\\\%", "%a_b%c_",
                 "_%_%_")
RLIKE_PATTERNS = ("abc", "^a.c$", "c[oa]m", "^[a-z]+ [^ ]+$", "(ab|cd)+e?",
                  "\\d{3}-\\d{4}", "[^\\s]+x", "a$")


def rejected_query(mod, df, fn: str, pattern: str):
    E = __import__(mod.__name__.rsplit(".", 1)[0] + ".expr.strings",
                   fromlist=["Like"])
    cls = {"like": E.Like, "ilike": E.ILike, "rlike": E.RLike}[fn]
    return df.select("s", cls(mod.col("s"), mod.lit(pattern)).alias("m"))


def _frame(mod, types, session, width):
    arrays, validity = string_table(SEED + width, width)
    return frame(mod, session, arrays, string_schema(types), validity)


def _columns(rows, names):
    return {n: [r[i] for r in rows] for i, n in enumerate(names)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference device session's columns of every case at each
    width, and its plans of the rejected patterns, in one child call."""
    out = run_jax(f"""
    import json, sys
    sys.path.insert(0, "tests/port")
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.config import TpuConf
    from spark_rapids_tpu.memory.device_manager import get_device_manager
    import chip_smoke as C
    import test_torch_string_funcs as M
    import torch_port_text as X
    get_device_manager(TpuConf({{}}))
    res = {{}}
    for w in X.WIDTHS:
        df = M._frame(RS, T, RS.TpuSession({{}}), w)
        rows = X.select_cases(RS, df, X.STRING_CASES, "expr.strings").collect()
        res[str(w)] = M._columns(rows, list(X.STRING_CASES))
    for fn, p in M.REJECTED:
        q = M.rejected_query(RS, M._frame(RS, T, RS.TpuSession({{}}), 32),
                             fn, p)
        res[fn + p] = C.plan_shape(q)
    out["json"] = np.array([json.dumps(res)])
    """, tmp_path_factory.mktemp("stringref"))
    return json.loads(str(out["json"][0]))


@pytest.fixture(scope="module")
def port_and_oracle():
    """The port's (on the CPU) and the reference oracle's columns of every
    case at each width."""
    out = {}
    for w in WIDTHS:
        rows = select_cases(S, _frame(S, T, S.TpuSession({}, device="cpu"),
                                      w), STRING_CASES,
                            "expr.strings").collect()
        orows = select_cases(RS, _frame(RS, RT, RS.TpuSession(ORACLE), w),
                             STRING_CASES, "expr.strings").collect()
        out[w] = (_columns(rows, list(STRING_CASES)),
                  _columns(orows, list(STRING_CASES)))
    return out


@pytest.mark.parametrize("name", list(STRING_CASES))
def test_string_case_equals_reference(name, reference, port_and_oracle):
    for w in WIDTHS:
        got, oracle = (c[name] for c in port_and_oracle[w])
        assert got == reference[str(w)][name], w
        if name in BYTE_CUTS:
            s = string_table(SEED + w, w)[0]["s"]
            keep = [i for i, v in enumerate(s) if v.isascii()]
            got, oracle = [got[i] for i in keep], [oracle[i] for i in keep]
        assert got == oracle, w


def test_cases_cover_multibyte_empty_and_null_rows():
    for w in WIDTHS:
        arrays, validity = string_table(SEED + w, w)
        s = arrays["s"]
        assert max(len(v.encode()) for v in s) < w
        assert any(not v.isascii() for v in s) and any(v == "" for v in s)
        assert not validity["s"].all()
        assert {1, 2, 3, 4} <= {len(ch.encode()) for v in s for ch in v}


@pytest.mark.parametrize("pattern", LIKE_PATTERNS)
def test_like_dfa_tables_equal_reference(pattern):
    """Full-match tables of ``like_to_regex``, numpy-equal."""
    got = PX.compile_regex(PX.like_to_regex(pattern), full_match=True)
    want = RX.compile_regex(RX.like_to_regex(pattern), full_match=True)
    assert PX.like_to_regex(pattern) == RX.like_to_regex(pattern)
    assert np.array_equal(got.table, want.table)
    assert np.array_equal(got.accept, want.accept)
    assert got.n_states == want.n_states


@pytest.mark.parametrize("pattern", RLIKE_PATTERNS)
def test_rlike_dfa_tables_equal_reference(pattern):
    """Find-anywhere tables, numpy-equal."""
    got, want = PX.compile_regex(pattern), RX.compile_regex(pattern)
    assert np.array_equal(got.table, want.table)
    assert np.array_equal(got.accept, want.accept)


@pytest.mark.parametrize("fn,pattern", REJECTED)
def test_rejected_pattern_is_a_cpu_stage_with_the_oracles_rows(
        fn, pattern, reference):
    """The transpiler's reject tags the projection off the device with the
    reference's reason (the same explain), and the CPU stage's rows (the
    pattern through Python's ``re``) are the oracle's."""
    import chip_smoke as C

    q = rejected_query(S, _frame(S, T, S.TpuSession({}, device="cpu"), 32),
                       fn, pattern)
    assert C.plan_shape(q) == reference[fn + pattern]
    assert "cannot run on TPU because" in q.explain()
    oracle = rejected_query(RS, _frame(RS, RT, RS.TpuSession(ORACLE), 32),
                            fn, pattern).collect()
    assert q.collect() == oracle
    assert any(r[1] for r in oracle) or fn == "rlike"


@pytest.mark.parametrize("fn", ("like", "ilike", "rlike"))
def test_null_pattern_is_a_cpu_stage_of_nulls(fn):
    """A NULL pattern is tagged off the device and the CPU stage answers
    NULL on every row, as Spark does (the reference's oracle raises
    there: ROADMAP.md, fault R9)."""
    q = rejected_query(S, _frame(S, T, S.TpuSession({}, device="cpu"), 32),
                       fn, None)
    assert "cannot run on TPU because" in q.explain()
    rows = q.collect()
    assert len(rows) > 0 and all(r[1] is None for r in rows)


@pytest.mark.parametrize("fn", ("like", "ilike", "rlike"))
def test_column_pattern_is_refused_when_planned(fn):
    """A pattern that is not a literal is refused when the CPU stage is
    planned (``NotOnGpu``), not met at run time."""
    from spark_rapids_tpu_torch.exec.base import NotOnGpu

    E = __import__("spark_rapids_tpu_torch.expr.strings", fromlist=["Like"])
    cls = {"like": E.Like, "ilike": E.ILike, "rlike": E.RLike}[fn]
    df = _frame(S, T, S.TpuSession({}, device="cpu"), 32)
    with pytest.raises(NotOnGpu, match="pattern that is not a literal"):
        df.select("s", cls(S.col("s"), S.col("t")).alias("m")).collect()

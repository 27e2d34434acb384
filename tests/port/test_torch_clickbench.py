"""ClickBench's time queries Q18, Q24 and Q42 (and page views by the hour
in America/Los_Angeles) over ``chip_smoke.py``'s hits table at 20,000
rows, on the port (``device="cpu"``).

From memory: the plans against the reference device session's (planned
in the child process, one call for the module) and ``chip_smoke``'s
``HITS_PLANS``; the rows against ``chip_smoke``'s numpy checks and the
reference's CPU oracle session.  From the Parquet files phase 36 writes:
the rows against the oracle session reading the same files, then phase
36 itself (K1 once a dictionary chunk, against its plain version on the
EventTime and UserID index tables).  Q18 and Q24 order by a count and an
instant that tie: their checks take any of the tied rows, so the port
and the oracle are each held to numpy's; Q42 and the zone query are
exact, row for row."""
import sys

import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

ROWS = 20_000
SEED = 3


def data():
    hits = C.make_hits(ROWS, SEED)
    return hits, C.hits_phrases(SEED + 1)


@pytest.fixture(scope="module")
def hits():
    h, phrases = data()
    refs = C.hits_references(h, phrases, True)
    return h, phrases, C.hits_checks(h, phrases, refs)


def frames(mod, types, session, d):
    h, phrases = d[:2]
    arrays = {f.name: (phrases[h[f.name]] if f.name == "SearchPhrase"
                       else h[f.name]) for f in C.hits_schema(types).fields}
    return frame(mod, session, arrays, C.hits_schema(types))


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """The reference's explain of each query from memory, in one child
    call."""
    return run_jax("""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    import test_torch_clickbench as M
    df = M.frames(RS, T, RS.TpuSession({}), M.data())
    for name, build in C.HITS_QUERIES.items():
        out[name] = np.array(C.plan_shape(build(df, RS)))
    """, tmp_path_factory.mktemp("hitsref"))


def _check(label, checks, rows):
    bad = checks[label](rows)
    assert bad is None, bad


@pytest.mark.parametrize("label", list(C.HITS_QUERIES))
def test_query_from_memory(label, hits, reference_plans):
    """The plan is the reference's and ``HITS_PLANS``' (scans aside);
    the rows pass numpy's check twice, and so do the reference oracle's;
    Q42's and the zone query's rows equal the oracle's."""
    q = C.HITS_QUERIES[label](frames(S, T, S.TpuSession({}, device="cpu"),
                                     hits), S)
    plan = C.plan_shape(q)
    assert plan == list(reference_plans[label])
    assert plan[:-1] == C.HITS_PLANS[label][:-1]
    got = q.collect()
    _check(label, hits[2], got)
    _check(label, hits[2], q.collect())
    want = C.HITS_QUERIES[label](frames(RS, RT, RS.TpuSession(ORACLE),
                                        hits), RS).collect()
    _check(label, hits[2], want)
    if label in ("Q42", "hours_la"):
        assert got == want


def test_queries_from_parquet_equal_the_oracle(hits, tmp_path):
    """From the files phase 36 writes (the port's writer, TIMESTAMP_MICROS
    and dictionary pages): the port's rows and the reference oracle's,
    reading the same files, each pass numpy's checks; Q42's equal."""
    h, phrases, checks = hits
    paths = C.write_hits_files(h, phrases, str(tmp_path),
                               torch.device("cpu"), 2)
    port = S.TpuSession(C.Q12_CONF, device="cpu")
    oracle = RS.TpuSession(ORACLE)
    for label, build in C.HITS_QUERIES.items():
        got = build(port.read.schema(C.hits_reads(T, label)).parquet(
            *paths), S).collect()
        want = build(oracle.read.schema(C.hits_reads(RT, label)).parquet(
            *paths), RS).collect()
        _check(label, checks, got)
        _check(label, checks, want)
        if label in ("Q42", "hours_la"):
            assert got == want


def test_phase_36_from_parquet(hits, tmp_path, monkeypatch):
    """Phase 36 at test size (``chip_smoke.run_hits_phase``, the card's
    calls stubbed): every query exact against numpy with its plan
    ``HITS_PLANS``, K1 once a dictionary chunk and equal to its plain
    version on the first file's EventTime and UserID index tables."""
    from spark_rapids_tpu_torch.pallas import decode

    h, phrases, _ = hits
    dev = torch.device("cpu")
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(C, "profile_collect",
                        lambda collect, want, label, key=None: collect())
    real = decode.unpack_runs

    def counting(*a, **k):
        decode.unpack_launches += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    paths = C.write_hits_files(h, phrases, str(tmp_path), dev, 2)
    refs = C.hits_references(h, phrases, True)
    out = C.run_hits_phase(h, phrases, paths, dev, "cpu", True, refs)
    assert out["k1_err"] == 0 and out["widths"]
    for label in C.HITS_QUERIES:
        assert out[label]["launches"] > 0


def test_hits_table_is_clickbench_shaped():
    """The generator's promises: EventTime whole seconds in July 2013
    UTC and EventDate its day, CounterID 62 on about a tenth of the rows,
    SearchPhrase empty on about seven in eight, phrases of 5 to 60
    bytes."""
    h, phrases = data()
    secs = h["EventTime"] // 1_000_000
    assert (h["EventTime"] % 1_000_000 == 0).all()
    assert secs.min() >= C.HITS_T0
    assert secs.max() < C.HITS_T0 + C.HITS_DAYS * 86_400
    assert np.array_equal(h["EventDate"], secs // 86_400)
    assert 0.08 < (h["CounterID"] == 62).mean() < 0.12
    assert 0.85 < (h["SearchPhrase"] == 0).mean() < 0.9
    lens = [len(p.encode()) for p in phrases[1:]]
    assert min(lens) >= 5 and max(lens) <= 60 and phrases[0] == ""

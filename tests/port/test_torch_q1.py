"""TPC-H Q1 (three decimal averages over 128-bit sums, the charge a
decimal(26,4) x decimal(13,2) product in a CPU stage, string group and
sort keys through it) on the port (``device="cpu"``) at 20,000 lines
from ``chip_smoke.py``'s generator, against ``chip_smoke.q1_reference``
(numpy and Python integers) and the JAX package's CPU oracle session:
from memory, over several batches, and from the Parquet files
``chip_smoke.py`` writes (money columns INT64 annotated DECIMAL(12,2),
the strings dictionary-encoded with index widths 2 and 1, which K1 reads
exactly as its plain version).  The plan equals the reference's (planned
in the child process) and ``chip_smoke.q1_plan``.  Every comparison is
exact."""
import sys

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

N = 20_000
SEED = 20261018


@pytest.fixture(scope="module")
def q1_table():
    li = C.lineitem_q1(N, 10 * N / C.SF10_ROWS, SEED)
    want = C.q1_reference(li)
    assert [r[:2] for r in want] == [("A", "F"), ("N", "F"), ("N", "O"),
                                     ("R", "F")]
    return li, want


def memory_q1(mod, types, session, li):
    arrays = dict(li, **{k: C.q12_strings(li[k], v)
                         for k, v in C.Q1_VALUES.items()})
    return C.q1_query(frame(mod, session, arrays, C.q1_schema(types)), mod)


@pytest.mark.parametrize("batch_rows", [None, 3000])
def test_q1_from_memory(q1_table, tmp_path, batch_rows):
    li, want = q1_table
    conf = ({} if batch_rows is None
            else {"spark.rapids.sql.reader.batchSizeRows": batch_rows})
    q = memory_q1(S, T, S.TpuSession(conf, device="cpu"), li)
    assert C.plan_shape(q) == C.q1_plan()
    assert q.collect() == want
    assert q.collect() == want
    if batch_rows is None:
        ref = run_jax(f"""
        import sys
        sys.path.insert(0, "tests/port")
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        from test_torch_q1 import memory_q1
        li = C.lineitem_q1({N}, {10 * N / C.SF10_ROWS!r}, {SEED})
        q = memory_q1(RS, T, RS.TpuSession({{}}), li)
        out["plan"] = np.array(C.plan_shape(q))
        """, tmp_path)
        assert C.plan_shape(q) == list(ref["plan"])
        oracle = memory_q1(RS, RT, RS.TpuSession(ORACLE), li)
        assert oracle.collect() == want


def test_q1_from_parquet(q1_table, tmp_path, monkeypatch):
    """Phase 23's path at test size: two files, K1 once for each of their
    14 dictionary chunks, the string index tables (widths 2 and 1) equal
    to the plain version."""
    from spark_rapids_tpu_torch.pallas import decode

    li, want = q1_table
    paths = C.write_q1_files(li, str(tmp_path), torch.device("cpu"),
                             n_files=2)
    err, widths = C.check_string_k1(paths[:1], lambda p: C.q1_schema(T),
                                    torch.device("cpu"), "cpu", "Q1")
    assert err == 0 and widths == [1, 2]
    calls = [0]
    real = decode.unpack_runs

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    monkeypatch.setattr(decode, "unpack_runs", counting)
    s = S.TpuSession(C.Q12_CONF, device="cpu")
    q = C.q1_query(s.read.schema(C.q1_schema(T)).parquet(*paths), S)
    assert q.collect() == want
    assert calls[0] == C.dict_chunks(paths, C.q1_schema(T)) == 2 * 7
    assert C.plan_shape(q) == C.q1_plan()

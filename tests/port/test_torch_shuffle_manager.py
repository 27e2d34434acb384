"""The shuffle manager of the port (``shuffle/manager.py``): with
``spark.rapids.tpu.exchange.spill.enabled=false`` (MULTITHREADED: each map
output's slices serialized on the writer pool into the host block store)
and with ``spark.rapids.shuffle.mode=CACHE_ONLY`` (slices kept on the
device), a multi-partition exchange runs through the manager, as the
reference's does (``spark_rapids_tpu/exec/exchange.py:297-319``): rows
equal to the reference's CPU oracle session and to numpy, plans equal to
the reference's (child process), every registration dropped.  The port
runs on ``device="cpu"``."""
import sys

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu_torch.lifecycle import leak_report_all
from spark_rapids_tpu_torch.shuffle import manager as M
from torch_port_frames import ORACLE, rows_key
from torch_port_jaxref import REPO, run_jax

sys.path.insert(0, REPO)
import chip_smoke as C  # noqa: E402

N = 20_000
BASE = {"spark.sql.autoBroadcastJoinThreshold": "-1",
        "spark.sql.adaptive.enabled": False,
        "spark.rapids.sql.reader.batchSizeRows": N // 8,
        "spark.rapids.tpu.shuffle.singleDeviceCoalesce": False}
MODES = {"spill_disabled": dict(BASE, **{
             "spark.rapids.tpu.exchange.spill.enabled": False}),
         "cache_only": dict(BASE, **{
             "spark.rapids.shuffle.mode": "CACHE_ONLY"})}


def _queries(mod, s):
    """rung4_dist's join and grouped sum, and a repartition of the fact
    table by k into 5 partitions."""
    fact, dim = C.make_dist(N)
    f, d = C.ooc_frames(mod, s, fact, dim)
    return {"join_agg": C.ooc_query(f, d, mod),
            "repartition": f.repartition(5, "k")}


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    out = run_jax(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu.config import TpuConf
        from spark_rapids_tpu.memory.device_manager import get_device_manager
        for mode, conf in {MODES!r}.items():
            get_device_manager(TpuConf(conf))
            fact, dim = C.make_dist({N})
            f, d = C.ooc_frames(RS, RS.TpuSession(conf), fact, dim)
            qs = {{"join_agg": C.ooc_query(f, d, RS),
                   "repartition": f.repartition(5, "k")}}
            for name, q in qs.items():
                out[mode + ":" + name] = np.array(q.explain().splitlines())
    """, tmp_path_factory.mktemp("plans"))
    return {k: list(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_exchange_through_the_shuffle_manager(mode, reference_plans,
                                              monkeypatch):
    conf = MODES[mode]
    oracle = _queries(RS, RS.TpuSession(ORACLE))
    port = _queries(S, S.TpuSession(conf, device="cpu"))
    fact, dim = C.make_dist(N)
    writes = []
    write = M.TpuShuffleManager.write_map_output

    def counted(self, sid, map_id, slices):
        writes.append((self.mode, sum(b is not None for b in slices)))
        return write(self, sid, map_id, slices)

    monkeypatch.setattr(M.TpuShuffleManager, "write_map_output", counted)
    for name, q in port.items():
        assert q.explain().splitlines() == reference_plans[
            mode + ":" + name]
        rows = q.collect()
        assert rows_key(rows) == rows_key(oracle[name].collect())
        if name == "join_agg":
            assert C.ooc_rows(rows) == C.dist_reference(fact, dim)
        else:
            assert sorted(r[1] for r in rows) == sorted(fact["v"].tolist())
    want_mode = "CACHE_ONLY" if mode == "cache_only" else "MULTITHREADED"
    # 8 fact batches and 1 dimension batch for the join, 8 for the
    # repartition, each a map task with slices for several partitions
    assert len(writes) == 17
    assert all(m == want_mode and k > 1 for m, k in writes)
    assert M.peek_shuffle_manager().active_shuffles() == []
    assert leak_report_all() == []
    if mode == "spill_disabled":
        assert M.peek_shuffle_manager().blocks_written > 0

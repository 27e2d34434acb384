"""The failure taxonomy of the port (``resilience/classify.py``) against the
reference's ``classify_failure``: one table of exceptions — bare, wrapped
with ``raise ... from``, raised while handling another, and disowned with
``raise ... from None`` — each labelled the same by both packages.  Then
the port's own signal, ``torch.cuda.OutOfMemoryError``, as ``deviceOom``,
the one predicate ``memory/retry.py`` reads, and the one difference: XLA's
status strings mean nothing to the port."""
import errno
import socket

import pytest
import torch

from spark_rapids_tpu.resilience import classify as REF
from spark_rapids_tpu.resilience.faults import (InjectedCompileError,
                                                InjectedTransientError)
from spark_rapids_tpu_torch.distributed.protocol import (ProtocolCorruption,
                                                         ProtocolDesync,
                                                         RemoteOpError,
                                                         WorkerDegraded,
                                                         WorkerLost)
from spark_rapids_tpu_torch.lifecycle import (QueryCancelled,
                                              QueryDeadlineExceeded,
                                              QueryRejected)
from spark_rapids_tpu_torch.memory import retry
from spark_rapids_tpu_torch.memory.retry import (TpuRetryOOM,
                                                 TpuSplitAndRetryOOM)
from spark_rapids_tpu_torch.memory.spill import SpillCorruption
from spark_rapids_tpu_torch.resilience import classify as K
from spark_rapids_tpu_torch.shuffle.serializer import ShuffleCorruption


def _wrapped(inner):
    try:
        try:
            raise inner
        except BaseException as e:
            raise RuntimeError("stage failed") from e
    except RuntimeError as outer:
        return outer


def _during(inner):
    try:
        try:
            raise inner
        except BaseException:
            raise RuntimeError("while handling")
    except RuntimeError as outer:
        return outer


def _disowned(inner):
    try:
        try:
            raise inner
        except BaseException:
            raise RuntimeError("unrelated") from None
    except RuntimeError as outer:
        return outer


CASES = {
    "runtime": (lambda: RuntimeError("boom"), K.DETERMINISTIC),
    "value": (lambda: ValueError("bad shape"), K.DETERMINISTIC),
    "connection": (lambda: ConnectionError("refused"), K.TRANSIENT),
    "reset": (lambda: ConnectionResetError("reset"), K.TRANSIENT),
    "pipe": (lambda: BrokenPipeError("pipe"), K.TRANSIENT),
    "socket_timeout": (lambda: socket.timeout("timed out"), K.TRANSIENT),
    "timeout": (lambda: TimeoutError("op timed out"), K.TRANSIENT),
    "wrapped_connection": (lambda: _wrapped(ConnectionError("x")),
                           K.TRANSIENT),
    "during_connection": (lambda: _during(ConnectionError("x")),
                          K.TRANSIENT),
    "oserror_reset": (lambda: OSError(errno.ECONNRESET, "reset"),
                      K.TRANSIENT),
    "oserror_enospc": (lambda: OSError(errno.ENOSPC, "disk full"),
                       K.DETERMINISTIC),
    "worker_lost": (lambda: WorkerLost("w9", "no heartbeat"),
                    K.WORKER_LOST),
    "wrapped_worker_lost": (lambda: _wrapped(WorkerLost("w9")),
                            K.WORKER_LOST),
    "worker_degraded": (lambda: WorkerDegraded("w9", "slow"),
                        K.WORKER_DEGRADED),
    "protocol_corruption": (lambda: ProtocolCorruption("crc"),
                            K.DETERMINISTIC),
    "protocol_desync": (lambda: ProtocolDesync("rid"), K.TRANSIENT),
    "remote_op_error": (lambda: RemoteOpError("ENOSPC"), K.DETERMINISTIC),
    "shuffle_corruption": (lambda: ShuffleCorruption("crc"),
                           K.DETERMINISTIC),
    "wrapped_shuffle_corruption": (
        lambda: _wrapped(ShuffleCorruption("crc")), K.DETERMINISTIC),
    "spill_corruption": (lambda: SpillCorruption("crc"), K.DETERMINISTIC),
    "cancelled": (lambda: QueryCancelled("q1"), K.PROPAGATE),
    "deadline": (lambda: QueryDeadlineExceeded("q1"), K.PROPAGATE),
    "rejected": (lambda: QueryRejected("full"), K.PROPAGATE),
    "wrapped_cancel": (
        lambda: _wrapped(QueryCancelled("q1")), K.PROPAGATE),
    "keyboard": (lambda: KeyboardInterrupt(), K.PROPAGATE),
    "retry_oom": (lambda: TpuRetryOOM("injected"), K.DEVICE_OOM),
    "split_oom": (lambda: TpuSplitAndRetryOOM("injected"), K.DEVICE_OOM),
    "wrapped_oom": (lambda: _wrapped(TpuRetryOOM("x")), K.DEVICE_OOM),
    "disowned_oom": (lambda: _disowned(TpuRetryOOM("x")), K.DETERMINISTIC),
    "cuda_oom_message": (
        lambda: RuntimeError("CUDA error: out of memory"), K.DEVICE_OOM),
    "injected_transient": (lambda: InjectedTransientError("x"),
                           K.TRANSIENT),
    "injected_compile": (lambda: InjectedCompileError("x"),
                         K.DETERMINISTIC),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_classification_matches_reference(case):
    make, label = CASES[case]
    assert REF.classify_failure(make()) == label
    assert K.classify_failure(make()) == label
    assert K.is_device_oom(make()) == REF.is_device_oom(make())


def test_torch_oom_is_device_oom():
    """torch's OOM, bare or wrapped, is a device OOM, and ``with_retry``
    reads the same predicate."""
    oom = torch.cuda.OutOfMemoryError("Tried to allocate 2.00 GiB")
    assert K.classify_failure(oom) == K.DEVICE_OOM
    assert K.classify_failure(_wrapped(oom)) == K.DEVICE_OOM
    assert retry._is_device_oom(_wrapped(oom))
    assert not retry._is_device_oom(RuntimeError("boom"))


def test_xla_status_strings_mean_nothing_to_the_port():
    """The reference reads XLA status codes in messages; the port has no
    XLA, so a message alone does not make an OOM or a transient error."""
    oom = RuntimeError("RESOURCE_EXHAUSTED: while allocating")
    assert REF.classify_failure(oom) == REF.DEVICE_OOM
    assert K.classify_failure(oom) == K.DETERMINISTIC


def test_breaker_plan_keys_match_reference():
    """The breaker keys a plan node by its class and a digest of its
    expressions' SQL; the port's keys of rung4_dist's plan, under a filter
    and a projection, are the reference's node for node."""
    import sys

    import spark_rapids_tpu.session as RS
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu.resilience.breaker import plan_key as ref_key
    from spark_rapids_tpu_torch.resilience.breaker import plan_key
    from torch_port_jaxref import REPO

    sys.path.insert(0, REPO)
    import chip_smoke as C

    def plan(mod, session):
        fact, dim = C.make_dist(100)
        f, d = C.ooc_frames(mod, session, fact, dim)
        f = f.filter(mod.col("v") > mod.lit(0)).select("k", "v")
        return C.ooc_query(f, d, mod).plan

    def keys(node, key):
        return [key(node)] + [k for c in node.children for k in keys(c, key)]

    conf = {"spark.sql.autoBroadcastJoinThreshold": "-1"}
    mine = keys(plan(S, S.TpuSession(conf, device="cpu")), plan_key)
    theirs = keys(plan(RS, RS.TpuSession(conf)), ref_key)
    assert mine == theirs
    assert len({k[0] for k in mine}) >= 5

"""The port stands alone: it imports neither jax nor the JAX package."""
import ast
import os
import subprocess
import sys

import pytest

from torch_port_jaxref import REPO

PORT = os.path.join(REPO, "spark_rapids_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_leaves_no_jax_in_sys_modules():
    code = ("import sys, spark_rapids_tpu_torch.session, "
            "spark_rapids_tpu_torch.io.scan, "
            "spark_rapids_tpu_torch.io.parquet_encode, "
            "spark_rapids_tpu_torch.columnar.convert, "
            "spark_rapids_tpu_torch.overrides.overrides, "
            "spark_rapids_tpu_torch.exec.window, "
            "spark_rapids_tpu_torch.exec.join, "
            "spark_rapids_tpu_torch.exec.generate, "
            "spark_rapids_tpu_torch.exec.aggregate, "
            "spark_rapids_tpu_torch.ops.segment, "
            "spark_rapids_tpu_torch.expr.decimal128, "
            "spark_rapids_tpu_torch.plan.nodes, "
            "spark_rapids_tpu_torch.exec.exchange, "
            "spark_rapids_tpu_torch.expr.conditional, "
            "spark_rapids_tpu_torch.exec.coalesce, "
            "spark_rapids_tpu_torch.exec.partition_sizing, "
            "spark_rapids_tpu_torch.memory.retry, "
            "spark_rapids_tpu_torch.shuffle.partition_queues, "
            "spark_rapids_tpu_torch.cpu.oracle, "
            "spark_rapids_tpu_torch.overrides.meta, "
            "spark_rapids_tpu_torch.overrides.transitions, "
            "spark_rapids_tpu_torch.expr.complextypes, "
            "spark_rapids_tpu_torch.lifecycle, "
            "spark_rapids_tpu_torch.resilience.breaker, "
            "spark_rapids_tpu_torch.resilience.classify, "
            "spark_rapids_tpu_torch.shuffle.manager, "
            "spark_rapids_tpu_torch.exec.ici, "
            "spark_rapids_tpu_torch.distributed.coordinator, "
            "spark_rapids_tpu_torch.distributed.client, "
            "spark_rapids_tpu_torch.distributed.worker, "
            "spark_rapids_tpu_torch.lifecycle.journal, "
            "spark_rapids_tpu_torch.io.hot_cache, "
            "spark_rapids_tpu_torch.compilecache.keys, "
            "spark_rapids_tpu_torch.expr.predicates, "
            "spark_rapids_tpu_torch.ops.sortkeys, "
            "spark_rapids_tpu_torch.io.parquet_device, "
            "spark_rapids_tpu_torch.shuffle.serializer, "
            "spark_rapids_tpu_torch.memory.spill, "
            "spark_rapids_tpu_torch.regex, "
            "spark_rapids_tpu_torch.regex.transpiler, "
            "spark_rapids_tpu_torch.expr.strings, "
            "spark_rapids_tpu_torch.expr.datetime, "
            "spark_rapids_tpu_torch.tzdb, "
            "spark_rapids_tpu_torch.expr.mathfuncs, "
            "spark_rapids_tpu_torch.expr.arithmetic, "
            "spark_rapids_tpu_torch.expr.cast, "
            "spark_rapids_tpu_torch.expr.hashexprs, "
            "spark_rapids_tpu_torch.ops.hashing, "
            "spark_rapids_tpu_torch.columnar.column, "
            "spark_rapids_tpu_torch.columnar.batch, "
            "spark_rapids_tpu_torch.native\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print(','.join(bad))\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_worker_imports_neither_torch_nor_jax():
    """``python -m spark_rapids_tpu_torch.distributed.worker --help`` runs
    with neither torch nor jax in ``sys.modules``: a worker starts without
    them and can never open a CUDA context."""
    code = ("import runpy, sys\n"
            "sys.argv = ['worker', '--help']\n"
            "try:\n"
            "    runpy.run_module('spark_rapids_tpu_torch.distributed.worker',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'spark_rapids_tpu')]\n"
            "print('BAD', ','.join(bad))\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert "--coordinator" in proc.stdout


def test_workers_are_spawned_without_the_card(monkeypatch):
    """``spawn_local_worker`` starts a fresh interpreter (fork and exec)
    running the port's worker module with ``CUDA_VISIBLE_DEVICES``
    empty; its store size is the coordinator's unless the caller gives
    one."""
    from spark_rapids_tpu_torch import distributed as D

    seen = {}

    def popen(cmd, env=None, **kw):
        seen.update(cmd=cmd, env=env)
        return "proc"

    class Coord:
        heartbeat_s, op_timeout_s, telemetry_ring, port = 0.1, 1.0, 8, 5
        worker_mem = 12345

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setattr(D.subprocess, "Popen", popen)
    assert D.spawn_local_worker(Coord(), "w0", mem_bytes=4096) == "proc"
    assert seen["cmd"][:3] == [sys.executable, "-m",
                               "spark_rapids_tpu_torch.distributed.worker"]
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == ""
    assert seen["env"]["PYTHONPATH"].split(os.pathsep)[0] == REPO
    mem = seen["cmd"].index("--mem-bytes") + 1
    assert seen["cmd"][mem] == "4096"
    D.spawn_local_worker(Coord(), "w1")
    assert seen["cmd"][mem] == "12345"
    assert "--reattach-ms" not in seen["cmd"]
    D.spawn_local_worker(Coord(), "w2", reattach_ms=5000,
                         endpoint_file="/r/coordinator.endpoint")
    assert seen["cmd"][-4:] == ["--reattach-ms", "5000", "--endpoint-file",
                                "/r/coordinator.endpoint"]

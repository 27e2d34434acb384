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
            "spark_rapids_tpu_torch.exec.exchange, "
            "spark_rapids_tpu_torch.expr.conditional, "
            "spark_rapids_tpu_torch.exec.coalesce, "
            "spark_rapids_tpu_torch.exec.partition_sizing, "
            "spark_rapids_tpu_torch.memory.retry, "
            "spark_rapids_tpu_torch.shuffle.partition_queues, "
            "spark_rapids_tpu_torch.cpu.oracle, "
            "spark_rapids_tpu_torch.overrides.meta, "
            "spark_rapids_tpu_torch.overrides.transitions, "
            "spark_rapids_tpu_torch.expr.complextypes\n"
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

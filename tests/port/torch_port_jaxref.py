"""Run JAX-package reference code in a child process.

The full suite (``pytest tests/``) runs every test in one process, and that
process is known to crash inside an XLA compile after roughly a thousand
compiles (ROADMAP.md, fault R2).  Port tests collect first (``tests/port/``
sorts before ``tests/test_*``), so any XLA program they compiled in-process
would move that crash earlier.  Reference computations that compile
(interpret-mode Pallas, jitted limb math, the JAX device session) therefore
run in one child interpreter, started at first use and shared by every
port test module, and hand back numpy arrays.  Numpy-only references
(``expand_runs_host``, ``decompress_to_host``) and the CPU oracle session
(no compiles) run in-process.
"""
from __future__ import annotations

import atexit
import json
import os
import select
import subprocess
import sys
import tempfile
import textwrap

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_WORKER_SRC = r'''
import json, sys, traceback
import numpy as np
for line in sys.stdin:
    job = json.loads(line)
    try:
        inp = dict(np.load(job["inp"], allow_pickle=False))
        out = {}
        exec(compile(job["code"], "<jax reference>", "exec"),
             {"np": np, "inp": inp, "out": out})
        np.savez(job["out"], **out)
        reply = {"ok": True}
    except BaseException:
        reply = {"ok": False, "error": traceback.format_exc()}
    sys.stdout.write(json.dumps(reply) + "\n")
    sys.stdout.flush()
'''

_worker = None

#: Child code that makes the reference's device decode run here: its
#: ``_unpack_call`` traces K1's body in an ``enable_x64`` scope that this
#: jax does not export, so the same ``pallas_call`` (the real kernel body,
#: the same tile padding, interpret mode) is bound without that scope.
REF_K1_INTERPRET = """
from functools import partial as _partial
import jax as _jax
import jax.numpy as _jnp
from jax.experimental import pallas as _pl
import spark_rapids_tpu.pallas.decode as _D
# kept on the module, so the child's later jobs reuse the compiled calls
_K1 = _D.__dict__.setdefault("_interpret_k1", {})
def _interpret_unpack_call(padded, bw, groups):
    tiles = 1
    while tiles * _D._TILE < groups:
        tiles *= 2
    # padded in numpy: one compiled program per (tiles, bw), not per page
    mat = np.zeros((tiles * _D._TILE, _D._LANES), np.uint32)
    mat[:groups, :bw] = np.asarray(padded).reshape(groups, bw)
    if (tiles, bw) not in _K1:
        _K1[(tiles, bw)] = _jax.jit(_pl.pallas_call(
            _partial(_D._unpack_body, bw=bw),
            out_shape=_jax.ShapeDtypeStruct(mat.shape, _jnp.uint32),
            grid=(tiles,),
            in_specs=[_pl.BlockSpec((_D._TILE, _D._LANES),
                                    lambda i: (i, 0))],
            out_specs=_pl.BlockSpec((_D._TILE, _D._LANES),
                                    lambda i: (i, 0)),
            interpret=True))
    return _K1[(tiles, bw)](mat)[:, :8]
_D._unpack_call = _interpret_unpack_call
"""


def _stop_worker():
    if _worker is not None and _worker.poll() is None:
        _worker.stdin.close()
        try:
            _worker.wait(timeout=30)
        except subprocess.TimeoutExpired:
            _worker.kill()
            _worker.wait(timeout=30)


def _get_worker() -> subprocess.Popen:
    global _worker
    if _worker is None or _worker.poll() is not None:
        # one CPU device, as the port runs on one card: tests/conftest.py
        # asks XLA for 8 host devices, under which the reference keeps its
        # hash exchanges instead of collapsing them to one partition
        flags = " ".join(f for f in os.environ.get("XLA_FLAGS", "").split()
                         if "host_platform_device_count" not in f)
        # each reference program is compiled once and run on test-sized
        # inputs, so its compile time is most of its cost: XLA's backend
        # (LLVM) optimization passes are off.  Fast math stays off at
        # every level; the tests hold integers and decimals exactly and
        # doubles to 12 significant digits.
        flags += " --xla_backend_optimization_level=0"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
                   XLA_FLAGS=flags)
        log = tempfile.TemporaryFile()   # the child's warnings, unread
        _worker = subprocess.Popen(
            [sys.executable, "-c", _WORKER_SRC], cwd=REPO, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
            text=True)
        log.close()
        atexit.register(_stop_worker)
    return _worker


def run_jax(code: str, tmp_path, inputs=None, timeout: int = 300) -> dict:
    """Execute ``code`` with ``inp`` (dict of the ``inputs`` arrays), an
    empty dict ``out`` and ``np`` in scope; return ``out`` as numpy
    arrays.  Raises with the child's traceback if the code fails."""
    inp = os.path.join(str(tmp_path), "jaxref_in.npz")
    outp = os.path.join(str(tmp_path), "jaxref_out.npz")
    np.savez(inp, **(inputs or {}))
    w = _get_worker()
    w.stdin.write(json.dumps({"code": textwrap.dedent(code), "inp": inp,
                              "out": outp}) + "\n")
    w.stdin.flush()
    ready, _, _ = select.select([w.stdout], [], [], timeout)
    if not ready:
        w.kill()
        w.wait(timeout=30)
        raise TimeoutError(f"JAX reference took over {timeout} s")
    line = w.stdout.readline()
    if not line:
        raise RuntimeError(f"JAX reference process died (rc {w.poll()})")
    reply = json.loads(line)
    if not reply["ok"]:
        raise RuntimeError(f"JAX reference failed:\n{reply['error']}")
    return dict(np.load(outp, allow_pickle=False))

"""ctypes bindings for the host snappy codec in ``native/host_kernels.cpp``.

The port's own loader (the reference's is ``spark_rapids_tpu/native.py``):
it compiles the unchanged C++ source with g++ into the port's git-ignored
build directory, keyed on a hash of the source, and binds only the two
snappy entry points the Parquet path needs.  There is no pure-Python
fallback: at SF10 a Python snappy would hide a broken toolchain behind hours
of host time, so a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_ROOT, "native", "host_kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
_lock = threading.Lock()
_lib = None


def build_shared(src: str, name: str, cmd_prefix) -> str:
    """Compile ``src`` into ``BUILD_DIR/<name>-<hash>.so`` unless that file
    exists; returns its path.  The object is written under a temporary
    name and renamed, so concurrent builders never load a partial file."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(list(cmd_prefix) + ["-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded host library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_shared(
                SRC, "host_kernels", ["g++", "-O3", "-shared", "-fPIC"]))
            for fn in (lib.snappy_uncompress, lib.snappy_compress):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64]
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def snappy_uncompress(data: bytes, usize: int) -> bytes:
    """Raw snappy block decompression (parquet's default codec)."""
    inp = np.frombuffer(data, np.uint8)
    out = np.empty(max(usize, 1), np.uint8)
    n = get_lib().snappy_uncompress(inp.ctypes.data, len(inp),
                                    out.ctypes.data, len(out))
    if n < 0:
        raise ValueError("malformed snappy block")
    return out[:n].tobytes()


def snappy_compress(data: bytes) -> bytes:
    """Raw snappy block compression (the Parquet writer's codec)."""
    inp = np.frombuffer(data, np.uint8)
    cap = len(data) + len(data) // 6 + 32
    out = np.empty(cap, np.uint8)
    n = get_lib().snappy_compress(inp.ctypes.data, len(inp),
                                  out.ctypes.data, cap)
    if n < 0:
        raise ValueError("snappy compress overflow")
    return out[:n].tobytes()

"""ctypes bindings for the host kernels in ``native/host_kernels.cpp``.

The port's own loader (the reference's is ``spark_rapids_tpu/native.py``):
it compiles the unchanged C++ source with g++ into the port's git-ignored
build directory, keyed on a hash of the source, and binds the entry
points the port calls: the snappy codec (the Parquet path), the length
walk of a PLAIN BYTE_ARRAY page (the string decode) and the padded <->
ragged char copies (the TKU2 serializer's string columns).  There is no pure-Python
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
            lib.plain_byte_array_lens.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            lib.plain_byte_array_lens.restype = ctypes.c_int64
            lib.padded_to_ragged.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
            lib.padded_to_ragged.restype = None
            lib.ragged_to_padded.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p]
            lib.ragged_to_padded.restype = None
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


def plain_byte_array_lens(buf: bytes, n: int) -> np.ndarray:
    """The int32 lengths of the ``n`` values of a PLAIN BYTE_ARRAY page
    (4-byte little-endian length, then the bytes, per value)."""
    lens = np.zeros(max(n, 1), np.int32)
    if n:
        inp = np.frombuffer(buf, np.uint8)
        if get_lib().plain_byte_array_lens(inp.ctypes.data, len(inp), n,
                                           lens.ctypes.data) < 0:
            raise ValueError("malformed PLAIN byte_array page")
    return lens[:n]


def padded_to_ragged(chars: np.ndarray, lengths: np.ndarray):
    """A (rows, width) uint8 char matrix and its lengths -> (the rows'
    bytes back to back, int64 offsets of rows + 1 entries)."""
    chars = np.ascontiguousarray(chars, np.uint8)
    rows, width = chars.shape
    l32 = np.ascontiguousarray(lengths, np.int32)
    out = np.empty(int(np.minimum(l32.astype(np.int64), width).sum()),
                   np.uint8)
    offsets = np.zeros(rows + 1, np.int64)
    if rows:
        get_lib().padded_to_ragged(chars.ctypes.data, l32.ctypes.data, rows,
                                   width, out.ctypes.data,
                                   offsets.ctypes.data)
    return out, offsets


def ragged_to_padded(buf: np.ndarray, offsets: np.ndarray,
                     width: int) -> np.ndarray:
    """Rows' bytes back to back and their int64 offsets -> a zero-padded
    (rows, width) uint8 matrix."""
    rows = len(offsets) - 1
    out = np.zeros((rows, max(width, 1)), np.uint8)
    if rows:
        buf = np.ascontiguousarray(buf, np.uint8)
        offsets = np.ascontiguousarray(offsets, np.int64)
        get_lib().ragged_to_padded(buf.ctypes.data, offsets.ctypes.data,
                                   rows, out.shape[1], out.ctypes.data)
    return out

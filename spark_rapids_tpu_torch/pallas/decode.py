"""Parquet RLE / bit-packed hybrid decode — port of
``spark_rapids_tpu/pallas/decode.py``.

K1 (``unpack_runs``) replaces the TPU kernel ``_unpack_body``.  The
reference launches that kernel once per bit-packed run of a page and
concatenates the pieces; the port hands the whole host-parsed run table of
a page (``io/parquet_native.py::split_hybrid_runs``) to one CUDA launch
(``csrc/unpack_runs.cu``), which writes every value of the page.

``unpack_runs`` dispatches on the device of its tensors: a CUDA tensor
launches the kernel (and raises if it cannot), a CPU tensor runs
``unpack_runs_plain``, the same function in plain torch int64 arithmetic
(CPU torch has no uint32 shift).  ``unpack_launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List

import numpy as np
import torch

from spark_rapids_tpu_torch.perfcounters import to_device

MAX_BIT_WIDTH = 24

#: kernel launches of ``unpack_runs`` (the CPU plain version does not count)
unpack_launches = 0

_TABLE_KEYS = ("out_off", "count", "is_packed", "byte_off", "nbytes",
               "value")
_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "unpack_runs.cu")
_lock = threading.Lock()
_kernel = None


def nvcc_command():
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build_kernel() -> ctypes.CDLL:
    """Build (once, keyed on the source hash) and bind the K1 launcher."""
    global _kernel
    with _lock:
        if _kernel is None:
            from spark_rapids_tpu_torch.native import build_shared

            lib = ctypes.CDLL(build_shared(_CSRC, "unpack_runs",
                                           nvcc_command()))
            fn = lib.unpack_runs_launch
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            fn.argtypes = [vp, i64, i64, vp, vp, vp, vp, vp, vp, i64,
                           ctypes.c_int, i64, vp, vp]
            fn.restype = ctypes.c_int
            _kernel = lib
        return _kernel


def run_table(runs, total: int) -> Dict[str, np.ndarray]:
    """Host run headers -> the int64 arrays the kernel reads.  Runs are
    clipped to ``total`` values exactly as the reference's ``expand_runs``
    clips them (``take = min(r.count, total - got)``)."""
    rows: List[tuple] = []
    got = 0
    for r in runs:
        take = min(r.count, total - got)
        if take <= 0:
            break
        rows.append((got, take, int(r.is_packed), r.byte_off, r.nbytes,
                     r.value if not r.is_packed else 0))
        got += take
    arr = np.array(rows, np.int64).reshape(-1, len(_TABLE_KEYS))
    return {k: np.ascontiguousarray(arr[:, i])
            for i, k in enumerate(_TABLE_KEYS)}


def _check(buf: torch.Tensor, table: Dict[str, torch.Tensor], bw: int):
    if not 1 <= bw <= MAX_BIT_WIDTH:
        raise ValueError(f"bit width {bw} outside 1..{MAX_BIT_WIDTH}")
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"payload must be 1-D uint8, got {buf.dtype} "
                        f"{tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("payload must be contiguous")
    n = None
    for k in _TABLE_KEYS:
        t = table[k]
        if t.dtype != torch.int64 or t.dim() != 1:
            raise TypeError(f"run table {k} must be 1-D int64")
        if not t.is_contiguous():
            raise ValueError(f"run table {k} must be contiguous")
        if t.device != buf.device:
            raise ValueError(f"run table {k} on {t.device}, payload on "
                             f"{buf.device}")
        if n is not None and t.shape[0] != n:
            raise ValueError("run table arrays differ in length")
        n = t.shape[0]
    if n == 0:
        raise ValueError("empty run table")


def unpack_runs(buf: torch.Tensor, base: int,
                table: Dict[str, torch.Tensor], bw: int,
                total: int) -> torch.Tensor:
    """Expand one page's runs -> (total,) int32 (uint32 values < 2^24).

    ``buf`` holds the payload bytes; run ``r``'s payload starts at
    ``base + table["byte_off"][r]`` and spans ``table["nbytes"][r]`` bytes.
    A CUDA ``buf`` launches K1; a CPU ``buf`` runs the plain version."""
    global unpack_launches
    _check(buf, table, bw)
    if buf.device.type == "cpu":
        return unpack_runs_plain(buf, base, table, bw, total)
    if buf.device.type != "cuda":
        raise ValueError(f"unpack_runs: unsupported device {buf.device}")
    tab = [table[k] for k in _TABLE_KEYS]
    out = torch.empty(total, dtype=torch.int32, device=buf.device)
    if total == 0:
        return out
    lib = build_kernel()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.unpack_runs_launch(
            buf.data_ptr(), buf.shape[0], base,
            *[t.data_ptr() for t in tab], tab[0].shape[0], bw, total,
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"unpack_runs launch failed: CUDA error {err}")
    unpack_launches += 1
    return out


def unpack_runs_plain(buf: torch.Tensor, base: int,
                      table: Dict[str, torch.Tensor], bw: int,
                      total: int) -> torch.Tensor:
    """Plain torch version of K1: the same index arithmetic in int64."""
    dev = buf.device
    i = torch.arange(total, dtype=torch.int64, device=dev)
    r = torch.searchsorted(table["out_off"], i, right=True) - 1
    k = i - table["out_off"][r]
    bit = k * bw
    start = base + table["byte_off"][r]
    end = torch.clamp(start + table["nbytes"][r], max=buf.shape[0])
    b0 = start + (bit >> 3)
    win = torch.zeros(total, dtype=torch.int64, device=dev)
    last = max(buf.shape[0] - 1, 0)
    for j in range(4):
        p = b0 + j
        byte = buf[p.clamp(0, last)].to(torch.int64) if buf.shape[0] \
            else torch.zeros_like(p)
        win |= torch.where(p < end, byte, 0) << (8 * j)
    packed = (win >> (bit & 7)) & ((1 << bw) - 1)
    v = torch.where(table["is_packed"][r] != 0, packed, table["value"][r])
    v = torch.where(k < table["count"][r], v, 0)
    return v.to(torch.int32)


def expand_runs_host(runs, buf: bytes, total: int, bw: int) -> np.ndarray:
    """Host (numpy) run expansion — the reference's twin, used for the tiny
    definition-level streams whose defined count the host needs."""
    out = np.zeros(total, np.uint32)
    got = 0
    for r in runs:
        take = min(r.count, total - got)
        if take <= 0:
            break
        if r.is_packed:
            payload = np.frombuffer(buf, np.uint8, count=r.nbytes,
                                    offset=r.byte_off)
            if bw == 0:
                vals = np.zeros(take, np.uint32)
            elif bw == 1:
                vals = np.unpackbits(payload, bitorder="little")[:take]
            else:
                bits = np.unpackbits(payload, bitorder="little")
                usable = (len(bits) // bw) * bw
                vals = (bits[:usable].reshape(-1, bw).astype(np.uint32)
                        * (1 << np.arange(bw, dtype=np.uint32))).sum(
                    axis=1)[:take]
            out[got:got + take] = vals
        else:
            out[got:got + take] = r.value
        got += take
    return out


def expand_runs_dev(runs, dev_buf: torch.Tensor, base_off: int, total: int,
                    bw: int) -> torch.Tensor:
    """RLE/bit-packed hybrid runs -> (total,) int32 on ``dev_buf``'s device.
    Payload bytes already live in ``dev_buf`` (a page region) at
    ``base_off`` plus each run's ``byte_off``; only the run table (48 bytes
    a run) is uploaded."""
    table = run_table(runs, total) if bw > 0 else None
    if table is None or table["out_off"].shape[0] == 0:
        # bw=0 streams and empty pages hold only index 0 / nothing
        return torch.zeros(total, dtype=torch.int32, device=dev_buf.device)
    dev_table = {k: to_device(v, dev_buf.device) for k, v in table.items()}
    return unpack_runs(dev_buf, base_off, dev_table, bw, total)


def expand_runs(runs, buf: bytes, total: int, bw: int,
                device) -> torch.Tensor:
    """Decoded-transfer twin: upload the host stream ``buf`` (run headers
    and payloads), then expand it on the device."""
    dev_buf = to_device(np.frombuffer(buf, np.uint8), device)
    return expand_runs_dev(runs, dev_buf, 0, total, bw)


def unpack_bitpacked_dev(payload: torch.Tensor, bw: int,
                         count: int) -> torch.Tensor:
    """One bit-packed stream already on the device -> (count,) int32 (the
    PLAIN boolean page layout)."""
    from spark_rapids_tpu_torch.io.parquet_native import Run

    groups = (count + 7) // 8
    run = Run(True, count, 0, 0, groups * bw)
    return expand_runs_dev([run], payload, 0, count, bw)


def bound_bytes(table: Dict[str, np.ndarray], bw: int, total: int) -> int:
    """Bytes K1 must move for one page: the packed payload its values
    need, the run table, and 4 bytes out per value."""
    packed = table["is_packed"] != 0
    need = (table["count"][packed] * bw + 7) // 8
    pay = int(np.minimum(need, table["nbytes"][packed]).sum())
    return pay + 8 * len(_TABLE_KEYS) * len(table["out_off"]) + 4 * total

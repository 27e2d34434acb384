"""Parquet RLE / bit-packed hybrid decode — port of
``spark_rapids_tpu/pallas/decode.py``.

K1 (``unpack_runs``) replaces the TPU kernel ``_unpack_body``.  The
reference launches that kernel once per bit-packed run of a page and
concatenates the pieces; the port hands the host-parsed runs
(``io/parquet_native.py::split_hybrid_runs``) of a whole batch of pages —
every dictionary page of a column chunk — to one CUDA launch
(``csrc/unpack_runs.cu``) as one int32 table, ``(rows, 4)``::

    out_off | count + (bw << 26) | byte_off | nbytes (packed) or value (RLE)

``bw`` is the row's bit width, 0 for an RLE row: writers grow the index
width with the dictionary from page to page, so the width is per row.
``run_table`` builds a page's rows, ``batch_run_table`` joins pages.

``unpack_runs`` dispatches on the device of its tensors: a CUDA tensor
launches the kernel (and raises if it cannot), a CPU tensor runs
``unpack_runs_plain``, the same function in plain torch int64 arithmetic
over the kernel's tile decomposition (CPU torch has no uint32 shift).
``unpack_launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.perfcounters import to_device

MAX_BIT_WIDTH = 24
#: output values per block of the kernel (``kTile`` in the source)
TILE = 4096
#: values of one table row; a longer run takes several rows
MAX_ROW_VALUES = ((1 << 26) - 1) // 8 * 8
INDEX_LIMIT = (1 << 31) - 1
_COUNT_MASK = (1 << 26) - 1

#: kernel launches of ``unpack_runs`` (the CPU plain version does not count)
unpack_launches = 0

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
            if lib.unpack_runs_tile() != TILE:
                raise RuntimeError("unpack_runs.cu tile differs from TILE")
            fn = lib.unpack_runs_launch
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            fn.argtypes = [vp, i64, i64, vp, i64, i64, vp, vp]
            fn.restype = ctypes.c_int
            _kernel = lib
        return _kernel


def run_table(runs, total: int, bw: int,
              stream_len: Optional[int] = None) -> np.ndarray:
    """One page's runs -> its (rows, 4) int32 table.  Runs are clipped to
    ``total`` values exactly as the reference's ``expand_runs`` clips them
    (``take = min(r.count, total - got)``); values the runs do not reach
    get a row of zeros.  ``stream_len`` (the page's stream length) clips
    each packed payload, so that no row reads past its page."""
    if not 0 <= bw <= MAX_BIT_WIDTH:
        raise ValueError(f"bit width {bw} outside 0..{MAX_BIT_WIDTH}")
    rows: List[tuple] = []
    got = 0

    def add(take, width, off, last):
        nonlocal got
        while take > 0:
            part = min(take, MAX_ROW_VALUES)
            rows.append((got, part | width << 26, off, last))
            if width:                   # the next part's whole groups
                off += part // 8 * width
                last = max(last - part // 8 * width, 0)
            got += part
            take -= part

    for r in runs:
        take = min(r.count, total - got)
        if take <= 0:
            break
        if r.is_packed and bw:
            nb = r.nbytes if stream_len is None else max(
                min(r.nbytes, stream_len - r.byte_off), 0)
            add(take, bw, r.byte_off, nb)
        else:                           # bw == 0: every index is 0
            add(take, 0, r.byte_off, r.value if not r.is_packed else 0)
    add(total - got, 0, 0, 0)
    return _to_table(rows)


def _to_table(rows) -> np.ndarray:
    arr = np.array(rows, np.int64).reshape(-1, 4)
    if len(arr) and (arr.min() < 0 or arr.max() > INDEX_LIMIT):
        raise ValueError("run table entry outside the kernel's 32-bit "
                         "indices")
    return arr.astype(np.int32)


def batch_run_table(pages: Iterable[Tuple]) -> Tuple[np.ndarray, int]:
    """Join the run tables of a batch of pages -> (table, total values).

    ``pages`` holds ``(runs, count, bw, byte_base, stream_len)`` per page:
    its runs, its value count, its bit width, where its stream starts in
    the batch's byte buffer and its stream length.  Out offsets run on
    from page to page; byte offsets move by ``byte_base``."""
    parts = []
    got = 0
    for runs, count, bw, byte_base, stream_len in pages:
        t = run_table(runs, count, bw, stream_len).astype(np.int64)
        t[:, 0] += got
        t[:, 2] += byte_base
        parts.append(t)
        got += count
    if got > INDEX_LIMIT:
        raise ValueError(f"batch of {got} values outside the kernel's "
                         "32-bit indices")
    table = (np.concatenate(parts) if parts
             else np.zeros((0, 4), np.int64))
    return _to_table(table), got


def _check(buf: torch.Tensor, base: int, table: torch.Tensor, total: int):
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise TypeError(f"payload must be 1-D uint8, got {buf.dtype} "
                        f"{tuple(buf.shape)}")
    if not buf.is_contiguous():
        raise ValueError("payload must be contiguous")
    if table.dtype != torch.int32 or table.dim() != 2 or \
            table.shape[1] != 4:
        raise TypeError(f"run table must be (rows, 4) int32, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("run table must be contiguous")
    if table.device != buf.device:
        raise ValueError(f"run table on {table.device}, payload on "
                         f"{buf.device}")
    if table.shape[0] == 0:
        raise ValueError("empty run table")
    for name, v in (("payload length", buf.shape[0]), ("base", base),
                    ("value count", total)):
        if not 0 <= v <= INDEX_LIMIT:
            raise ValueError(f"{name} {v} outside the kernel's 32-bit "
                             "indices")


def unpack_runs(buf: torch.Tensor, base: int, table: torch.Tensor,
                total: int) -> torch.Tensor:
    """Expand a batch's runs -> (total,) int32 (uint32 values < 2^24).

    ``buf`` holds the payload bytes; row ``r``'s payload starts at
    ``base + table[r, 2]``.  A CUDA ``buf`` launches K1; a CPU ``buf``
    runs the plain version."""
    global unpack_launches
    _check(buf, base, table, total)
    if buf.device.type == "cpu":
        return unpack_runs_plain(buf, base, table, total)
    if buf.device.type != "cuda":
        raise ValueError(f"unpack_runs: unsupported device {buf.device}")
    out = torch.empty(total, dtype=torch.int32, device=buf.device)
    if total == 0:
        return out
    lib = build_kernel()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.unpack_runs_launch(
            buf.data_ptr(), buf.shape[0], base, table.data_ptr(),
            table.shape[0], total, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"unpack_runs launch failed: CUDA error {err}")
    unpack_launches += 1
    return out


def unpack_runs_plain(buf: torch.Tensor, base: int, table: torch.Tensor,
                      total: int, tile: int = TILE) -> torch.Tensor:
    """Plain torch version of K1, in int64, over the kernel's tiles: each
    tile's first and last rows by a search at the tile's ends, then a
    search for each value bounded by them."""
    dev = buf.device
    t = table.to(torch.int64)
    out_off, word, boff, last_w = (t[:, c].contiguous() for c in range(4))
    i = torch.arange(total, dtype=torch.int64, device=dev)
    ends = torch.arange(0, total, tile, dtype=torch.int64, device=dev)
    first = torch.searchsorted(out_off, ends, right=True) - 1
    last = torch.searchsorted(
        out_off, torch.clamp(ends + tile, max=total) - 1, right=True) - 1
    lo, hi = first[i // tile], last[i // tile]
    for _ in range(int(t.shape[0]).bit_length()):
        mid = (lo + hi + 1) >> 1
        ok = out_off[mid] <= i
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid - 1)
    r = lo
    k = i - out_off[r]
    bw = (word[r] >> 26) & 31
    bit = k * bw
    start = base + boff[r]
    end = torch.clamp(start + last_w[r], max=buf.shape[0])
    b0 = start + (bit >> 3)
    win = torch.zeros(total, dtype=torch.int64, device=dev)
    top = max(buf.shape[0] - 1, 0)
    for j in range(4):
        p = b0 + j
        byte = buf[p.clamp(0, top)].to(torch.int64) if buf.shape[0] \
            else torch.zeros_like(p)
        win |= torch.where(p < end, byte, 0) << (8 * j)
    packed = (win >> (bit & 7)) & ((1 << bw) - 1)
    v = torch.where(bw != 0, packed, last_w[r])
    v = torch.where(k < (word[r] & _COUNT_MASK), v, 0)
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


def expand_table_dev(dev_buf: torch.Tensor, base: int, table: np.ndarray,
                     total: int) -> torch.Tensor:
    """Upload a host run table (16 bytes a row) and expand it over the
    payload bytes already in ``dev_buf`` -> (total,) int32."""
    if total == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev_buf.device)
    return unpack_runs(dev_buf, base, to_device(table, dev_buf.device),
                       total)


def expand_runs_dev(runs, dev_buf: torch.Tensor, base_off: int, total: int,
                    bw: int) -> torch.Tensor:
    """One page's RLE/bit-packed hybrid runs -> (total,) int32 on
    ``dev_buf``'s device.  Payload bytes already live in ``dev_buf`` (a
    page region) at ``base_off`` plus each run's ``byte_off``."""
    return expand_table_dev(dev_buf, base_off, run_table(runs, total, bw),
                            total)


def unpack_bitpacked_dev(payload: torch.Tensor, bw: int,
                         count: int) -> torch.Tensor:
    """One bit-packed stream already on the device -> (count,) int32 (the
    PLAIN boolean page layout)."""
    from spark_rapids_tpu_torch.io.parquet_native import Run

    groups = (count + 7) // 8
    run = Run(True, count, 0, 0, groups * bw)
    return expand_runs_dev([run], payload, 0, count, bw)


def bound_bytes(table: np.ndarray, total: int) -> int:
    """Bytes K1 must move for one batch: the packed payload its values
    need, the run table as laid out, and 4 bytes out per value."""
    t = table.astype(np.int64)
    bw = (t[:, 1] >> 26) & 31
    need = ((t[:, 1] & _COUNT_MASK) * bw + 7) // 8
    pay = int(np.minimum(need, np.where(bw > 0, t[:, 3], 0)).sum())
    return pay + table.nbytes + 4 * total

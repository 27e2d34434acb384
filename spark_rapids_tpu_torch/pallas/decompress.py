"""Snappy page decompression on the device — port of
``spark_rapids_tpu/pallas/decompress.py``.

The host walks a raw snappy block's TAG BYTES only (``_parse_ops``: literal
payloads are skipped by length arithmetic) and uploads three op arrays with
the compressed bytes.  The device resolves every output byte's ultimate
literal source by pointer doubling:

    pass 0:  S[p] = comp offset        (p inside a literal op)
             S[p] = p - dist           (p inside a copy op)
    pass k:  S[p] = S[S[p]] where unresolved

``ceil(log2(usize)) + 1`` passes resolve any stream, dist-1 RLE chains
included, and a last gather reads the bytes.  The reference runs this as
stock XLA (``_gather_fn``); the port runs it as torch ops
(``torch.searchsorted`` plus gathers, about four launches a pass) on
exact-size tensors: the reference's power-of-two capacities only bounded
XLA recompiles.  ``snappy_gather_passes`` counts the passes.

When the compressed bytes plus 12 bytes per op would cross the link
heavier than the decoded page, :class:`TooFragmented` routes the caller to
the decoded transfer: a transport choice, never a different byte.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import perfcounters as PC


class TooFragmented(Exception):
    """Shipping this page compressed would cross the link heavier than
    the decoded path — the caller ships it decoded (transport cost
    only; correctness is identical either way)."""


def _parse_ops(data: bytes) -> Tuple[int, List[Tuple[int, int, int, int]]]:
    """Structural walk of a raw snappy block: (usize, ops).

    Each op is ``(kind, out_off, length, arg)`` with kind 0 = literal
    (arg = byte offset of the payload inside ``data``) and kind 1 = copy
    (arg = back-reference distance).  O(#ops) host work — literal
    payloads are skipped by length arithmetic, never touched."""
    n = len(data)
    pos = 0
    usize = 0
    shift = 0
    while True:
        if pos >= n:
            raise ValueError("malformed snappy varint")
        b = data[pos]
        pos += 1
        usize |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    ops: List[List[int]] = []
    out = 0

    def push(kind: int, o: int, length: int, arg: int) -> None:
        # coalesce: snappy splits a long match into 64-byte copies at
        # the SAME distance, and long literals into 60-byte runs with
        # adjacent payloads — merged they keep identical per-byte
        # semantics (out[p] = out[p - d] / comp payload) and the op
        # arrays ship ~100x smaller for structured pages
        if ops:
            k0, o0, l0, a0 = ops[-1]
            if k0 == kind and o0 + l0 == o and (
                    (kind == 1 and a0 == arg)
                    or (kind == 0 and a0 + l0 == arg)):
                ops[-1][2] = l0 + length
                return
        ops.append([kind, o, length, arg])

    while pos < n and out < usize:
        tag = data[pos]
        pos += 1
        t = tag & 3
        if t == 0:
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                if pos + nb > n:
                    raise ValueError("malformed snappy literal length")
                ln = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            length = ln + 1
            if pos + length > n:
                raise ValueError("malformed snappy literal")
            push(0, out, length, pos)
            pos += length
        else:
            if t == 1:
                length = ((tag >> 2) & 0x7) + 4
                if pos + 1 > n:
                    raise ValueError("malformed snappy copy")
                dist = ((tag >> 5) << 8) | data[pos]
                pos += 1
            elif t == 2:
                length = (tag >> 2) + 1
                if pos + 2 > n:
                    raise ValueError("malformed snappy copy")
                dist = int.from_bytes(data[pos:pos + 2], "little")
                pos += 2
            else:
                length = (tag >> 2) + 1
                if pos + 4 > n:
                    raise ValueError("malformed snappy copy")
                dist = int.from_bytes(data[pos:pos + 4], "little")
                pos += 4
            if dist <= 0 or dist > out:
                raise ValueError("malformed snappy copy offset")
            push(1, out, length, dist)
        out += length
    if out != usize:
        raise ValueError("snappy length mismatch")
    return usize, [tuple(op) for op in ops]


def snappy_gather(comp: torch.Tensor, op_out: torch.Tensor,
                  op_src: torch.Tensor, op_lit: torch.Tensor,
                  usize: int) -> torch.Tensor:
    """Decompressed (usize,) uint8 from the compressed bytes and the op
    arrays (int64; ``op_out`` ascending from 0), by pointer doubling."""
    dev = comp.device
    n_ops = op_out.shape[0]
    p = torch.arange(usize, dtype=torch.int64, device=dev)
    j = (torch.searchsorted(op_out, p, right=True) - 1).clamp(0, n_ops - 1)
    rel = p - op_out[j]
    # resolved sources encode as -(comp offset) - 1; unresolved ones stay
    # an earlier OUTPUT position (the copy's source)
    s = torch.where(op_lit[j] > 0, -(op_src[j] + rel) - 1, p - op_src[j])
    del j, rel
    npasses = max(usize - 1, 1).bit_length() + 1
    for _ in range(npasses):
        hop = s[s.clamp(0, usize - 1)]
        s = torch.where(s >= 0, hop, s)
    PC.bump("snappy_gather_passes", npasses)
    return comp[(-s - 1).clamp(0, comp.shape[0] - 1)]


def snappy_to_device(data: bytes, device,
                     decoded_cost: int = 0) -> torch.Tensor:
    """Raw snappy block -> decompressed (usize,) uint8 on ``device``.

    Only the compressed bytes and 12 bytes per op count as link bytes
    (``bytes_h2d``; ``bytes_h2d_logical`` counts the decoded size).
    ``decoded_cost`` is what the decoded transfer would ship for this page;
    when the compressed form is not lighter, :class:`TooFragmented` is
    raised.  Raises ValueError on malformed input."""
    usize, ops = _parse_ops(data)
    if usize == 0:
        return torch.zeros(0, dtype=torch.uint8, device=device)
    ship = len(data) + 12 * len(ops)
    if ship >= max(decoded_cost, usize):
        raise TooFragmented(
            f"compressed transfer larger than decoded ({ship} vs "
            f"{max(decoded_cost, usize)})")
    n_ops = len(ops)
    op_out = np.fromiter((o[1] for o in ops), np.int64, n_ops)
    op_src = np.fromiter((o[3] for o in ops), np.int64, n_ops)
    op_lit = np.fromiter((1 - o[0] for o in ops), np.int64, n_ops)
    PC.count_h2d(len(data) + 12 * n_ops, logical=usize)
    PC.bump("pages_device_decompressed")
    t0 = time.perf_counter_ns()
    comp = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(device)
    tabs = [torch.from_numpy(a).to(device) for a in (op_out, op_src, op_lit)]
    PC.bump("scan_transfer_ns", time.perf_counter_ns() - t0)
    return snappy_gather(comp, *tabs, usize)


def raw_to_device(data: bytes, device) -> torch.Tensor:
    """UNCOMPRESSED page region -> (n,) uint8 on ``device`` (the identity
    twin of :func:`snappy_to_device`)."""
    t0 = time.perf_counter_ns()
    out = PC.to_device(np.frombuffer(data, np.uint8), device)
    PC.bump("scan_transfer_ns", time.perf_counter_ns() - t0)
    return out


def decompress_to_host(data: bytes) -> bytes:
    """Host (numpy) reference for the device gather (tests + docs): the
    same op stream executed sequentially."""
    usize, ops = _parse_ops(data)
    out = np.zeros(usize, np.uint8)
    comp = np.frombuffer(data, np.uint8)
    for kind, o, length, arg in ops:
        if kind == 0:
            out[o:o + length] = comp[arg:arg + length]
        elif arg >= length:
            out[o:o + length] = out[o - arg:o - arg + length]
        else:
            reps = -(-length // arg)
            out[o:o + length] = np.tile(out[o - arg:o], reps)[:length]
    return out.tobytes()

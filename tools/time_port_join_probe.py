"""Time the port's join probe search on the card: one search per probe row
plus the build side's run ends (``exec/join.py::_equal_range``) against
the first version's two searches, left and right, each a shared sort of
build and probe words for several keys (copied below as ``_two_searches``);
and, for several key words, the word-by-word rank search
(``_rank_search`` over the build's ``_rank_tables``) against the second
version, one shared sort of build and probe words for the left position
(``_merge_rank_range``), also at bench qb's shapes: 2,880,099
store_returns keys (ticket, item_sk) against one store_sales file's
3,600,123 rows.

Usage: ``python3 tools/time_port_join_probe.py [--build N] [--probe N]``
on a machine with a CUDA card.  All versions must give the same bounds;
it prints the card's name and power limit, then one JSON line per case
with the device times in ms (CUDA events, mean of back-to-back calls
after a warm-up).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from spark_rapids_tpu_torch.exec import join as J  # noqa: E402
from spark_rapids_tpu_torch.ops.sortkeys import lexsort  # noqa: E402

_INT64_MAX = 0x7FFFFFFFFFFFFFFF


def _old_merge_rank(sorted_words, n_valid, query_words, side):
    n = sorted_words[0].shape[0]
    nq = query_words[0].shape[0]
    dev = sorted_words[0].device
    b_inv = (torch.arange(n, device=dev) >= n_valid).to(torch.int64)
    q_inv = torch.zeros(nq, dtype=torch.int64, device=dev)
    tie_b = torch.full((n,), 0 if side == "right" else 1, dtype=torch.int64,
                       device=dev)
    tie_q = torch.full((nq,), 1 if side == "right" else 0, dtype=torch.int64,
                       device=dev)
    words = [torch.cat([b_inv, q_inv])]
    words += [torch.cat([sw, qw]) for sw, qw in zip(sorted_words,
                                                    query_words)]
    words.append(torch.cat([tie_b, tie_q]))
    pos = lexsort(words)
    is_build = (pos < n).to(torch.int64)
    nb_before = torch.cumsum(is_build, 0) - is_build
    qpos = torch.where(is_build == 1, nq, pos - n)
    out = torch.zeros(nq + 1, dtype=torch.int64, device=dev)
    return out.scatter_(0, qpos, nb_before)[:nq]


def _merge_rank_range(sorted_words, run_end, n_valid, query_words):
    """The second version for several words: the left rank through one
    shared sort of build and probe words, the run's end from
    ``run_end``."""
    lo = _old_merge_rank(sorted_words, n_valid, query_words, "left")
    at = lo.clamp(max=max(sorted_words[0].shape[0] - 1, 0))
    match = lo < n_valid
    for sw, qw in zip(sorted_words, query_words):
        match &= sw[at] == qw
    return lo, torch.where(match, run_end[at], lo)


def _two_searches(sorted_words, n_valid, query_words):
    """The first version: a search for each side."""
    if len(sorted_words) == 1:
        lo = torch.searchsorted(sorted_words[0], query_words[0], side="left")
        hi = torch.searchsorted(sorted_words[0], query_words[0],
                                side="right")
        return torch.minimum(lo, n_valid), torch.minimum(hi, n_valid)
    return (_old_merge_rank(sorted_words, n_valid, query_words, "left"),
            _old_merge_rank(sorted_words, n_valid, query_words, "right"))


def _time_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--build", type=int, default=1_000_000)
    ap.add_argument("--probe", type=int, default=3_600_124)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    rng = np.random.default_rng(args.seed)
    n_valid = args.build - args.build // 10         # a null-key tail
    qb = _time_qb_shapes(rng, dev)
    if qb is None:
        return 1
    print(json.dumps(dict(qb, device=smi)))
    for nkeys in (1, 2):
        # a key of ~n_valid/4 distinct values per word: duplicate build keys
        # and probe keys that miss
        span = max(int(round((n_valid / 4) ** (1.0 / nkeys))), 2)
        keys = np.stack([rng.integers(0, span, n_valid)
                         for _ in range(nkeys)])
        keys = keys[:, np.lexsort(keys[::-1])]
        words = np.full((nkeys, args.build), _INT64_MAX, np.int64)
        words[:, :n_valid] = keys
        queries = np.stack([rng.integers(0, span + span // 8, args.probe)
                            for _ in range(nkeys)])
        w = [torch.from_numpy(x).to(dev) for x in words]
        q = [torch.from_numpy(x).to(dev) for x in queries]
        nv = torch.tensor(n_valid, device=dev)
        run_end = J._run_ends(w, nv)
        tables = J._rank_tables(w) if nkeys > 1 else None
        new = J._equal_range(w, run_end, nv, q, tables)
        old = _two_searches(w, nv, q)
        if not all(torch.equal(a, b) for a, b in zip(new, old)):
            print(f"{nkeys} key(s): the versions disagree", file=sys.stderr)
            return 1
        line = {
            "keys": nkeys, "build_rows": args.build, "probe_rows": args.probe,
            "matched_pairs": int((new[1] - new[0]).sum()),
            "one_search_ms": _time_ms(lambda: J._equal_range(w, run_end, nv,
                                                             q, tables)),
            "run_ends_ms": _time_ms(lambda: J._run_ends(w, nv)),
            "two_searches_ms": _time_ms(lambda: _two_searches(w, nv, q))}
        if nkeys > 1:
            line["merge_rank_search_ms"] = _time_ms(
                lambda: _merge_rank_range(w, run_end, nv, q))
            line["rank_tables_ms"] = _time_ms(lambda: J._rank_tables(w))
        print(json.dumps(dict(line, device=smi)))
    return 0


def _time_qb_shapes(rng, dev):
    """bench qb's probe: store_returns' unique (ticket, item_sk) keys,
    sorted as the build side sorts them, against one store_sales file,
    a tenth of whose rows were returned."""
    n_sales = 28_800_991
    n_build, n_probe = n_sales // 10, n_sales // 8
    tickets, items = n_sales // 8, 100_000
    key = np.unique(rng.integers(0, tickets, 2 * n_build) * (2 * items)
                    + rng.integers(1, items + 1, 2 * n_build))
    key = np.sort(rng.choice(key, n_build, replace=False))
    w = [torch.from_numpy(key // (2 * items)).to(dev),
         torch.from_numpy(key % (2 * items)).to(dev)]
    # one sale in ten was returned: a tenth of the probe rows hit a key
    qkey = (rng.integers(0, tickets, n_probe) * (2 * items)
            + rng.integers(1, items + 1, n_probe))
    hits = rng.random(n_probe) < 0.1
    qkey[hits] = rng.choice(key, int(hits.sum()))
    q = [torch.from_numpy(qkey // (2 * items)).to(dev),
         torch.from_numpy(qkey % (2 * items)).to(dev)]
    nv = torch.tensor(n_build, device=dev)
    run_end = J._run_ends(w, nv)
    tables = J._rank_tables(w)
    rank = J._equal_range(w, run_end, nv, q, tables)
    merged = _merge_rank_range(w, run_end, nv, q)
    if not all(torch.equal(a, b) for a, b in zip(rank, merged)):
        print("qb shapes: the versions disagree", file=sys.stderr)
        return None
    return {
        "case": "qb", "keys": 2, "build_rows": n_build,
        "probe_rows": n_probe,
        "matched_pairs": int((rank[1] - rank[0]).sum()),
        "rank_search_ms": _time_ms(
            lambda: J._equal_range(w, run_end, nv, q, tables)),
        "merge_rank_search_ms": _time_ms(
            lambda: _merge_rank_range(w, run_end, nv, q)),
        "rank_tables_ms": _time_ms(lambda: J._rank_tables(w)),
        "run_ends_ms": _time_ms(lambda: J._run_ends(w, nv))}


if __name__ == "__main__":
    sys.exit(main())

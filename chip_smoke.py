#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: TPC-H Q6 from snappy Parquet at SF10,
bench qa, qb and qc from Parquet at TPC-DS SF10's store_sales row count,
then bench's out-of-core rung (rung3_ooc), qb under a capped pool, bench's
rung3 (a CPU stage under the aggregate, the out-of-core sort), bench's
rung4_dist (its exchanges over two worker processes, one killed), bench's
rung5_recovery (the query journal, a query killed at a stage commit and
resumed), the driver SIGKILLed and restarted over re-attaching workers,
bench's q6_parquet_hot (Q6 over the hot-table cache), TPC-H Q12 at
SF10 (string columns end to end), from Parquet and out of core, TPC-H Q4
and the other join types on its tables (semi, anti, right and full
outer), TPC-H Q1 at SF10 (averages over 128-bit sums, a CPU stage
with strings and decimal products), and TPC-H Q11, Q15 and q16_nolike at
SF10 (nested-loop and cross joins, a residual condition, count
distinct).

    python3 chip_smoke.py [--scale 10] [--seed 20261017]

Needs one CUDA card (and the CUDA toolkit's nvcc); exits non-zero without
one, and without the ``spark_rapids_tpu_torch`` package beside it.
Phases, each failing the run at its first mismatch:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the K1 kernel (nvcc) and the host snappy library (g++), in
   parallel;
3. K1 against its plain torch version on the card, for every bit width
   1..24 over random hybrid run tables (RLE and packed runs, counts that
   are not multiples of 8, a truncated last payload), up to 64 Mi values;
   exact equality;
4. Q6 at ``--scale`` through the session: lineitem columns generated with
   numpy from ``--seed`` (TPC-H spec 4.2.3), written as 8 snappy,
   dictionary-encoded Parquet files by the port's writer, read back under
   the TPC-H schema (decimal(12,2), DATE) under the default reader type
   (AUTO, which must resolve to MULTITHREADED) and collected twice; both
   results must equal an exact numpy reference.  The launch counts are set
   to 0 just before the timed collect and read just after.  Then a
   stage-by-stage breakdown, and one collect under ``torch.profiler`` for
   K1's device time inside the query and the card's idle share;
5. Q6 in memory (``LocalTableScan``) on the same arrays, exact;
6. K1 timed with CUDA events at the pages the Q6 files hold, beside its
   bound and its plain version: with the L2 cache cold (a 256 MB scratch
   write before each launch, one pair of events per launch, the median)
   and warm, back to back and one launch alone between its events; as a
   yardstick, a ``fill_`` of the same output L2-cold; the torch snappy
   gather checked against the host decompressor on the same pages;
7. K1 on Spark-shaped batches at SF10 volume: for each index width of the
   Q6 files, one file's worth of values (7,498,256) as 375 pages of
   20,000 values in 504-value bit-packed runs, as parquet-mr and Arrow
   write them; one batched launch timed against the same pages launched
   one by one, both exact against the plain version, and the host's cost
   of parsing the runs and building the batch's table;
8. Q6 on the committed multi-page fixture (``tests/port/
   q6_lineitem_pages.parquet``, written by pyarrow with 20,000-row pages;
   ``tests/port/make_pages_fixture.py``): exact against numpy on arrays
   regenerated from the seed, with one K1 launch per column chunk;
9. bench qa (a broadcast join of store_sales with the quarter-1 dates of
   date_dim, a sum grouped by year and store, TPC-DS q3's ORDER BY and
   LIMIT 100): bench.py's store_sales generator (seed 20260730) at
   28,800,991 rows times ``--scale``/10, written as 8 snappy files of its
   seven columns by the port's writer, date_dim as one file; the query
   reads three columns under the default reader type.  The plan must be
   the reference's unfused plan;
   two collects and one from memory (``LocalTableScan``) must equal an
   integer numpy reference.  The counts are set to 0 just before the
   timed collect and read just after; then a breakdown by operator and
   one collect under ``torch.profiler``;
10. bench qb (store_sales LEFT JOIN store_returns on (ticket, item_sk),
    then ``ext_sales - coalesce(return_amt, 0.00)`` summed by store):
    phase 9's store_sales files, and bench.py's store_returns (one row in
    ten of store_sales, unique keys) written as 8 snappy files.  The
    returns are over the broadcast threshold, so the plan is the adaptive
    join over single-partition exchanges, and it must decide ``shuffled``
    at run time.  Two collects, the second timed with the counts set to 0
    just before it; both equal an integer numpy reference.  Then a
    breakdown by operator (the two scans, the join, the aggregate, and the
    join's probe search at qb's shapes), one collect under
    ``torch.profiler``, and the peak device memory;
11. bench qc (a sum grouped by store and date, then ``rank()`` over each
    store's days by the sum, descending, kept where the rank is at most
    5) from phase 9's files, in the same way: aggregate -> window ->
    filter, exact against an integer numpy reference;
12. bench rung3_ooc from memory (a fact table joined to a 5,000-row
    dimension on k, v summed by the dimension's group), bench.py's
    generator (seed 23) and conf, at bench's defaults (4,194,304 rows, an
    8 MiB pool) and at 28,800,991 rows under a 48 MiB pool: the pool is
    the spill framework's budget, the fact exchange is sized past 16
    partitions, its slices past the queues' device budget cross to the
    host as CRC-framed blocks (``exchange_host_blocks`` must be above 0),
    and two collects must equal bench.py's ``cpu_ooc``; the spill and
    exchange counters, the codec and the peak memory beside the pool (its
    breakdown is left out for the time limit);
13. bench qb from phase 10's files under the 48 MiB pool and a 6 MiB
    batch goal, without broadcast or adaptive execution: the built
    store_returns side is over the goal, so the join must sub-partition
    both sides into hash buckets; two collects exact, the bucket count,
    spills and K1 launches printed;
14. bench rung3 from memory, bench.py's generator (seed 11) and conf (a
    pool fraction under the 64 MiB floor, an 8 MiB batch goal, 8 reader
    batches), at bench's 2,000,000 rows and at a quarter of 28,800,991
    (for the time limit): the aggregate
    (a grouped decimal(25,4) sum, min and max and a sum of a struct
    field, the struct projection a CPU stage between the device filter
    and the aggregate) twice, exact against numpy; the sort of a union of
    8 scans by amt, out of core (sorted runs in the spill framework, a
    windowed merge), counted twice and collected once as host columns:
    amt numpy's sort, the rows the input's.  Both plans must be the
    reference's, with its fallback reasons; the merge must take more than
    one window, upload at most a window's rows a run each window, and at
    SF10 spill to the host.  Counters, spills and peak memory are printed
    (the breakdowns are left out for the time limit);
15. bench rung4_dist from memory, bench.py's generator (seed 29; a
    2,000-row dimension, 31 groups) and conf (the distributed tier on,
    100 ms heartbeats, LOST past 600 ms), at bench's 200,000 rows and at
    28,800,991: a coordinator in this process and two worker processes
    (``python -m spark_rapids_tpu_torch.distributed.worker``, started
    without the card) with stores of 5 bytes a row over 100; the plan
    keeps both hash exchanges (16 partitions), whose slices are framed as
    TKU2 blocks, shipped to the workers and kept in the engine process as
    the lineage copy.  ``bench0`` is SIGKILLed at the 5th shipped block
    inside the timed collect: its rows must equal bench.py's ``cpu_dist``, a
    worker lost and partitions replayed.  Then, on the survivor, at
    bench's size the trace A/B (min of 2 collects each way) and the hedge
    A/B (3 interleaved rounds), at SF10 one healthy collect (its
    breakdown is left out for the time limit); every collect exact, no
    hedge may win in a healthy one, and no process but the engine may
    hold the card;
16. bench rung5_recovery from memory, bench.py's generator (seed 31; the
    2,000-row dimension, 31 groups) and query, at bench's 200,000 rows and
    at 28,800,991: (a) the min of 3 collects with the journal off against
    the min of 3 with it on, each after a warm-up (``journalOverheadPct``
    and the records written, printed, not held); (b) under bench's
    checkpointing conf (8-partition hash exchanges, no coalesce, broadcast
    or adaptive execution; the plan the reference's): a cold collect, a
    collect killed by a ``BaseException`` from the journal's record hook
    at its first ``ckpt`` record (its end record suppressed), the journal
    closed, and the resumed collect, which must serve a stage
    (``stages_recovered`` and ``queries_resumed`` >= 1, the query
    ``resumable``).  Every collect exact; no leak after the kill or the
    resume; the recovery dir empty after the purge.  Printed: the
    checkpoint bytes on disk, the cold, killed and resumed walls;
17. the driver killed: two worker processes (``python -m
    spark_rapids_tpu_torch.distributed.worker --reattach-ms 120000
    --endpoint-file <recovery dir>/coordinator.endpoint``, without the
    card) outlive driver incarnations that run as ``chip_smoke.py
    --driver-incarnation`` child processes on the card (an internal mode:
    one incarnation builds the coordinator, waits for the workers, arms
    its kill point and collects tools/run_stress.py's driver-kill query,
    seed 7, a 500-row dimension of 13 groups, under its conf).  Per round
    incarnation 1 is SIGKILLed at the kill point and incarnation 2 runs
    to its end: ``plan:1``, ``ship:6`` and ``ckpt:1`` at 200,000 rows
    with 32 MiB stores (the round at 28,800,991 rows with rung4_dist's
    stores and batching, which ``run_driver_kill`` also runs, is left out
    for the time limit).  Incarnation 2 must equal numpy,
    classify every journaled query (the crashed one not completed; after
    ``ckpt`` resumable, a stage served), leave no block on the workers
    and leak nothing, and no worker may map CUDA;
18. bench q6_parquet_hot: phase 4's files read PERFILE with the hot-table
    cache under a 4 GiB bound: the first collect misses with phase 4's K1
    launches and ``bytes_h2d``, the second hits with no K1 launch and no
    ``bytes_h2d``, timed beside phase 4's collect; under the 1 GiB
    default the same scan (over the bound) never hits; bench's own cell,
    1,000,000 rows in 4 snappy files under the default bound, hits on its
    repeat; after each ``session.close()`` the spill framework holds no
    handle, persistent ones included;
19. TPC-H Q12 (spec 2.4.12) at ``--scale``: orders (15,000,000 at SF10)
    and lineitem (1-7 lines an order) from ``--seed`` per spec 4.2.3,
    written as 8 + 8 snappy files, one row group each, the numeric
    columns by the port's writer, l_shipmode and o_orderpriority
    dictionary-encoded as parquet-mr writes them
    (``encode_dict_strings``: a PLAIN dictionary page, 20,000-value
    RLE_DICTIONARY pages of width 3), and orders' first file again with
    PLAIN strings by the port's writer.  Under the default reader type,
    a timed collect equal to numpy (``('MAIL', ...), ('SHIP', ...)``); the
    plan the reference's (``q12_plan``), its adaptive join deciding on
    22 bytes a filtered line; K1 launched once for each dictionary column
    chunk in the timed collect (its breakdown by operator and its
    collect under ``torch.profiler`` are left out for the time limit),
    and the PLAIN-string file read alone, every row equal;
20. Q12 from memory under phase 12's conf (the 48 MiB pool, a batch goal
    of an eighth of it, no broadcast, no adaptive execution): both
    exchanges sized, their slices past the queues' device budget framed
    to the host as TKU2 blocks carrying the strings (at least one), one
    collect exact, no leak; then the orders exchange's write and read
    alone;
21. TPC-H Q4 (spec 2.4.4) from phase 19's files: the quarter's orders
    that have a late line (EXISTS, a left semi join), counted by
    priority; a timed collect equal to numpy, the plan the reference's
    (``q4_plan``) with the adaptive join deciding ``shuffled`` over the
    late lines' 9 bytes each, K1 once a dictionary column chunk read
    (its breakdown by operator and its profiled collect are left out for
    the time limit);
22. the other join types on Q4's tables: the NOT EXISTS twin (left
    anti; semi + anti equal the quarter's orders per priority), the
    quarter's orders right and full outer joined to the late lines,
    counted by priority with the null group, each exact and planned as
    the reference plans it; then Q4 and its anti twin from memory under
    phase 12's conf, collected once each, the built late lines
    sub-partitioned into >= 2 buckets, exact, no leak;
23. TPC-H Q1 (spec 2.4.1) at ``--scale``: lineitem (59,986,052 rows at
    SF10) from ``--seed`` + 1 per spec 4.2.3 (``lineitem_q1``) as 8 snappy
    files, the money columns INT64 annotated DECIMAL(12,2), l_returnflag
    and l_linestatus dictionary-encoded (index widths 2 and 1); K1 held
    against its plain version on the first file's string index tables;
    a timed collect equal to numpy exactly (four sums, three HALF_UP
    decimal(16,6) averages over decimal(22,2) sums, the count), the plan
    the reference's with the Project as a CPU stage (``q1_plan``), K1
    once a dictionary chunk (its profiled collect and its breakdown are
    left out for the time limit);
24. TPC-H Q11 (spec 2.4.11, NATION GERMANY, FRACTION 0.0001 / SF) at
    ``--scale``: nation, supplier (100,000 at SF10), part (2,000,000) and
    partsupp (8,000,000) from ``--seed`` + 2 per spec 4.2.3
    (``make_tpch_parts``), written as snappy files (8 a table, nation
    one), money INT64 DECIMAL(12,2), every string dictionary-encoded by
    ``encode_dict_strings``; K1 held against its plain version on part's
    and nation's string index tables (widths 5 and 8).  Q11's threshold
    (the nation's stock times FRACTION, a CPU stage) is a one-row side
    joined by a nested-loop join on ``value > threshold``; a timed
    collect exact against numpy, the plan the reference's (``q11_plan``), K1
    once a dictionary chunk of both sides' scans; a breakdown (scans,
    joins, the value sum, the threshold's device side, CPU stage and
    upload, the nested-loop join; its profiled collect is left out for
    the time limit); then the same
    query as a cross join and a filter (``TpuCartesianProductExec``);
25. the nested-loop join's left semi, left anti and left outer types on
    Q11's rows (semi the inner rows, anti the rest, semi + anti every
    part, left outer the inner rows with the threshold and the rest with
    a null one) and a full outer one, a CPU stage with the reference's
    reason, equal to the left outer's rows; then partsupp ⋈ part with the
    residual condition ``ps_availqty > p_size * 100``, planned by hand,
    on the broadcast join, the shuffled join and, under phase 13's conf,
    the sub-partitioned join (>= 2 buckets); each exact, each plan the
    reference's;
26. TPC-H Q15 (spec 2.4.15, DATE 1996-01-01) over its own lineitem
    (59,986,052 rows at SF10, ``lineitem_q15`` from ``--seed`` + 3:
    l_suppkey by the spec's formula from l_partkey) and phase 24's
    supplier: the revenue view, its max as a one-row side of an equality
    nested-loop join, the supplier's columns by an equi-join; and
    ``q16_nolike``, TPC-H Q16 without its two LIKE predicates: the
    count(distinct ps_suppkey) by brand, type and size, planned as a
    dedup aggregate under the count.  Each collected once, timed, exact,
    the plan the reference's, K1 once a dictionary chunk (their profiled
    collects are left out for the time limit);
27-29. TPC-H Q13 and Q22, Q16 in full, and Q9 (strings, LIKE through
    the regex DFA, dates) over customer, orders and Q9's lineitem from
    ``--seed`` + 5 and + 6, strings as parquet-mr writes them; each
    timed, exact, planned as the reference plans it, K1 once a dictionary
    chunk (their profiled collects and breakdowns by operator are left
    out for the time limit);
30. TPC-H Q14 (spec 2.4.14, 1995-09) over Q9's lineitem (with
    L_SHIPDATE = O_ORDERDATE + [1, 121]) and part, and Q17 (Brand#23, MED
    BOX; part with P_CONTAINER from ``--seed`` + 8): K1 held against its
    plain version on part's first file's p_container table; each timed
    (its profiled collect and breakdown left out for the time limit),
    exact against numpy and Python integers, planned as the reference
    plans it (the final decimal
    divide a CPU stage; Q17's avg grouped by part and joined back with
    the residual ``l_quantity < 0.2 * avg``), the device subtree under
    the CPU stage the reference's with its joins decided as predicted, K1
    once a dictionary chunk;
31. TPC-H Q8 (spec 2.4.8, BRAZIL, AMERICA, ECONOMY ANODIZED STEEL) over
    eight tables (region written as one file, nation read twice), the
    same checks, the sort on the card over the CPU stage;
32. windows and statistics over phases 9-11's store_sales files: K1
    held against its plain version on item_sk's index tables; a TPC-DS
    Q47-shaped query (monthly sums cast to DOUBLE, a window ``avg`` over
    the unbounded frame, ``rank``/``lag``/``lead``, Q47's filter, the top
    100), moving frames over all 28,800,991 rows (ROWS 3 PRECEDING to 3
    FOLLOWING per item; RANGE 6 PRECEDING to CURRENT ROW and RANGE
    UNBOUNDED PRECEDING per store) and per-item ``skewness``,
    ``kurtosis``, ``corr``, ``covar_*`` and ``regr_*``;
33. windows over phase 27's orders and customer: each customer's order
    history (``row_number``, ``lag``, ``lead`` with a default, a trailing
    90-day RANGE frame over the DATE key) and phones per nation by
    balance (string ``lag``/``lead``, ``first_value`` IGNORE NULLS,
    ``last_value``, ``max`` over ``range_running``, ``min`` over
    ``unbounded``).  Each of phases 32-33's queries is planned as the
    reference plans it (its fusions aside), collected once under the
    profiler and twice timed, every row held
    against numpy references computed in threads from phase 32's start,
    K1 once a dictionary chunk (their breakdowns by operator, PR 14's in
    PERF.md, are left out for the time limit);
34. the rest of the aggregates over phases 9-11's, 19's and 27's files:
    per store the median profit, the 90th percentile of the sales, an
    approximate median and min/max, and over every row the median with
    ``approx_count_distinct`` (single-phase); HLL reach per store and
    over every row, each estimate equal to a numpy uint64 twin
    (xxhash64, the registers, the formula) and within 4 standard errors
    of the exact count; a runtime bloom filter join (``bloom_filter_agg``
    over 1993Q3's orders, probed by ``might_contain`` through a one-row
    cross join), its words and the first file's passes equal to the
    twin's, its rows to numpy's join without a filter, its
    false-positive rate printed; each customer's order dates
    (``collect_list``) and years (``collect_set``) as array columns; the
    least and greatest phone per nation.  Planned as the reference plans
    them (the two-phase HLL collapsed), collected once under the profiler
    and twice timed against references computed in threads from the
    phase's start, K1 once a dictionary chunk;
35. TPC-H Q21 (spec 2.4.21, SAUDI ARABIA) and supp_revenue_avg over
    phase 29's lines and orders: L_COMMITDATE, L_RECEIPTDATE and
    O_ORDERSTATUS drawn by spec 4.2.3 from ``--seed`` + 305, written as
    8 snappy files of ``lineitem21`` (4 columns) and of ``orders21`` (2),
    K1 held against its plain version on their index tables; Q21 written
    with hash joins, EXISTS and NOT EXISTS a LeftSemi and a LeftAnti
    sort-merge join carrying ``l_suppkey <> l1.l_suppkey`` as their
    residual condition (two CPU stages of the port's engine over device
    subtrees, the rest on the card); supp_revenue_avg the lines shipped
    in 1995, ``avg`` and ``sum`` of ``l_extendedprice * (1 -
    l_discount)`` by supplier (a decimal128 average: a CPU stage), the
    top 100 by that average.  Each planned as the reference plans it
    (the device subtrees under its CPU stages too), collected once under
    the profiler and twice timed, exact against numpy and Python-integer
    references computed in threads from the phase's start, K1 once a
    dictionary chunk, its CPU stages timed inside the profiled collect:
    the engine's work, the device subtrees they read, the downloads and
    the uploads.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  The whole run's wall time is printed
before them.
"""
from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from decimal import Decimal

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SF10_ROWS = 59_986_052
N_FILES = 8
K1_BIG_VALUES = 64 << 20           # values in the largest K1 check page
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
K1_SOURCE = "spark_rapids_tpu_torch/csrc/unpack_runs.cu"
K1_REPLACES = "spark_rapids_tpu/pallas/decode.py:31"
L2_FLUSH_BYTES = 256 << 20         # written before each L2-cold launch
COLD_ITERS = 20
FILE_VALUES = SF10_ROWS // N_FILES  # values of one SF10 file's chunk
SPARK_PAGE_VALUES = 20_000         # parquet-mr and Arrow page row limit
SPARK_RUN_VALUES = 504             # 63 groups, parquet-mr's packed run
FIXTURE = os.path.join("tests", "port", "q6_lineitem_pages.parquet")
FIXTURE_ROWS = 100_000
FIXTURE_SEED = 20261017


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def lineitem_q6(n: int, scale: float, seed: int):
    """The four Q6 columns as unscaled cents / epoch days (TPC-H 4.2.3)."""
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n, dtype=np.int64)
    discount = rng.integers(0, 11, n, dtype=np.int64)          # 0.00..0.10
    partkey = rng.integers(1, max(int(scale * 200_000), 1) + 1, n,
                           dtype=np.int64)
    retail = (90_000 + (partkey // 10) % 20_001
              + 100 * (partkey % 1_000))                        # cents
    start = 8035                                                # 1992-01-01
    end = 10440                                                 # 1998-08-02
    orderdate = rng.integers(start, end + 1, n, dtype=np.int64)
    shipdate = (orderdate + rng.integers(1, 122, n)).astype(np.int32)
    return {"l_quantity": quantity * 100,
            "l_extendedprice": quantity * retail,
            "l_discount": discount,
            "l_shipdate": shipdate}


def fixture_lineitem():
    """The Q6 arrays of the multi-page fixture, from its seed: lineitem
    at the scale factor whose table holds ``FIXTURE_ROWS`` rows."""
    return lineitem_q6(FIXTURE_ROWS, FIXTURE_ROWS / (SF10_ROWS / 10),
                       FIXTURE_SEED)


def q6_reference(li) -> Decimal:
    f = ((li["l_shipdate"] >= 8766) & (li["l_shipdate"] < 9131)
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 2400))
    rev = int(np.sum(li["l_extendedprice"][f] * li["l_discount"][f],
                     dtype=np.int64))
    return Decimal(rev).scaleb(-4)


def q6_query(df):
    from datetime import date

    from spark_rapids_tpu_torch.session import col, lit, sum_

    return (df.filter((col("l_shipdate") >= lit(date(1994, 1, 1)))
                      & (col("l_shipdate") < lit(date(1995, 1, 1)))
                      & (col("l_discount") >= lit(Decimal("0.05")))
                      & (col("l_discount") <= lit(Decimal("0.07")))
                      & (col("l_quantity") < lit(Decimal(24))))
            .select((col("l_extendedprice") * col("l_discount"))
                    .alias("revenue"))
            .agg(sum_("revenue", "revenue")))


def schemas():
    from spark_rapids_tpu_torch import types as T

    names = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
    money = T.DecimalType(12, 2)
    write = T.StructType([T.StructField(nm, T.DATE if nm == "l_shipdate"
                                        else T.LONG, False)
                          for nm in names])
    read = T.StructType([T.StructField(nm, T.DATE if nm == "l_shipdate"
                                       else money, False)
                         for nm in names])
    return write, read


def write_files(li, n: int, out_dir: str, device, n_files: int = N_FILES):
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.io.parquet_encode import write_parquet_device

    wsch, _ = schemas()
    os.makedirs(out_dir, exist_ok=True)
    bounds = np.linspace(0, n, n_files + 1).astype(np.int64)
    paths = []
    for i in range(n_files):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        cols = [HostColumn.from_numpy(li[f.name][lo:hi], f.dataType)
                for f in wsch.fields]
        path = os.path.join(out_dir, f"lineitem-{i:02d}.parquet")
        write_parquet_device(path, wsch, cols, hi - lo, device=device)
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# bench qa data: store_sales and date_dim as bench.py generates them
# ---------------------------------------------------------------------------

SS_SF10_ROWS = 28_800_991          # TPC-DS SF10 store_sales
SS_SEED = 20260730                 # bench.py's store_sales seed
N_STORES = 40
N_ITEMS = 100_000
N_DATES = 2555                     # ~7 years of date_dim
DATE_SK0 = 2_450_000               # TPC-DS-style surrogate key base
QA_LIMIT = 100
QA_PLAN = ["TpuTopN 100",
           "  TpuHashAggregate(Complete) keys=[d_year, store_sk] "
           "aggs=[sum(ext_sales) AS sum_sales]",
           "    TpuBroadcastHashJoinExec Inner [date_sk=date_sk]",
           "      <scan>",
           "      TpuBroadcastExchangeExec",
           "        TpuFilter ((d_qoy = 1))",
           "          <scan>"]

QB_PLAN = ["TpuHashAggregate(Complete) keys=[store_sk] aggs=[sum(net) AS "
           "net_sales] fused=[Project]",
           "  TpuAdaptiveJoin(threshold=10485760)[TpuShuffledSymmetricHash"
           "JoinExec LeftOuter [ticket=ticket, item_sk=item_sk]] "
           "decided=shuffled(<bytes>)",
           "    TpuAdaptiveShuffleReader(target=1073741824B small=4194304B)",
           "      TpuShuffleExchange SinglePartition",
           "        <scan>",
           "    TpuAdaptiveShuffleReader(target=1073741824B small=4194304B)",
           "      TpuShuffleExchange SinglePartition",
           "        <scan>"]
QC_PLAN = ["TpuFilter ((rk <= 5))",
           "  TpuWindow [rank] frame=running",
           "    TpuHashAggregate(Complete) keys=[store_sk, date_sk] "
           "aggs=[sum(ext_sales) AS day_sales]",
           "      <scan>"]


def make_store_sales(n: int):
    """bench.py's seven store_sales columns (``ext_sales`` and
    ``net_profit`` in unscaled cents of DECIMAL(7,2))."""
    rng = np.random.default_rng(SS_SEED)
    return {
        "date_sk": (DATE_SK0
                    + rng.integers(0, N_DATES, n)).astype(np.int32),
        "store_sk": rng.integers(1, N_STORES + 1, n).astype(np.int32),
        "item_sk": rng.integers(1, N_ITEMS + 1, n).astype(np.int32),
        "ticket": rng.integers(0, max(n // 8, 1), n),
        "quantity": rng.integers(1, 100, n),
        "ext_sales": rng.integers(100, 1_000_000, n),
        "net_profit": rng.integers(-100_000, 400_000, n),
    }


def make_date_dim():
    sk = np.arange(DATE_SK0, DATE_SK0 + N_DATES, dtype=np.int32)
    day = np.arange(N_DATES)
    year = (1998 + day // 365).astype(np.int32)
    doy = day % 365
    qoy = (doy // 92 + 1).clip(1, 4).astype(np.int32)
    moy = (doy // 31 + 1).clip(1, 12).astype(np.int32)
    return {"date_sk": sk, "d_year": year, "d_qoy": qoy, "d_moy": moy}


def qa_schemas(T):
    """(store_sales as written to Parquet and as bench.py holds it in
    memory, store_sales as the query reads it, date_dim) in the types
    module ``T`` of either package.  The money columns are DECIMAL(7,2),
    which the writer stores as annotated INT32, as Spark does."""
    dec72 = T.DecimalType(7, 2)
    names = ["date_sk", "store_sk", "item_sk", "ticket", "quantity",
             "ext_sales", "net_profit"]
    types = [T.INT, T.INT, T.INT, T.LONG, T.LONG, dec72, dec72]
    table = T.StructType([T.StructField(nm, t, False)
                          for nm, t in zip(names, types)])
    read = T.StructType([T.StructField("date_sk", T.INT, False),
                         T.StructField("store_sk", T.INT, False),
                         T.StructField("ext_sales", dec72, False)])
    dates = T.StructType([T.StructField(nm, T.INT, False)
                          for nm in ("date_sk", "d_year", "d_qoy", "d_moy")])
    return table, read, dates


def qa_query(sales, dates, mod):
    """bench.py's qa with TPC-DS q3's ORDER BY and LIMIT, from the
    ``col``/``lit``/``sum_``/``SortSpec`` of either package's session."""
    col, lit = mod.col, mod.lit
    return (sales.join(dates.filter(col("d_qoy").eq(lit(1))), on="date_sk")
            .group_by("d_year", "store_sk")
            .agg(mod.sum_("ext_sales", "sum_sales"))
            .order_by(col("d_year"),
                      (col("sum_sales"),
                       mod.SortSpec(ascending=False, nulls_first=False)),
                      col("store_sk"))
            .limit(QA_LIMIT))


def make_store_returns(ss, n_ret: int):
    """bench.py's store_returns: a sample of the sales rows with unique
    (ticket, item_sk), ``return_amt`` in unscaled cents of DECIMAL(7,2)."""
    import torch

    rng = np.random.default_rng(7)
    key = torch.from_numpy(ss["ticket"] * np.int64(2 * N_ITEMS)
                           + ss["item_sk"])
    # np.unique(key, return_index=True)'s first indices, by one stable
    # sort (torch's uses every core)
    skey, perm = torch.sort(key, stable=True)
    start = torch.ones(len(skey), dtype=torch.bool)
    start[1:] = skey[1:] != skey[:-1]
    first_idx = perm[start].numpy()
    take = rng.choice(len(first_idx), size=min(n_ret, len(first_idx)),
                      replace=False)
    idx = first_idx[take]
    return {
        "ticket": ss["ticket"][idx],
        "item_sk": ss["item_sk"][idx],
        "return_amt": rng.integers(50, 500_000, len(idx)),
    }


def qb_schemas(T):
    """(store_sales as qb reads it, store_returns as written and read) in
    the types module ``T`` of either package."""
    dec72 = T.DecimalType(7, 2)
    sales = T.StructType([T.StructField("store_sk", T.INT, False),
                          T.StructField("item_sk", T.INT, False),
                          T.StructField("ticket", T.LONG, False),
                          T.StructField("ext_sales", dec72, False)])
    returns = T.StructType([T.StructField("ticket", T.LONG, False),
                            T.StructField("item_sk", T.INT, False),
                            T.StructField("return_amt", dec72, False)])
    return sales, returns


def qb_query(sales, rets, mod):
    """bench.py's ``build_qb`` over two DataFrames of the package whose
    session module is ``mod``."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    T = importlib.import_module(pkg + ".types")
    CO = importlib.import_module(pkg + ".expr.conditional")
    B = importlib.import_module(pkg + ".expr.base")
    col = mod.col
    joined = sales.join(rets, on=["ticket", "item_sk"], how="left")
    net = (col("ext_sales")
           - CO.Coalesce([col("return_amt"),
                          B.Literal(Decimal("0.00"), T.DecimalType(7, 2))]))
    return (joined.select(col("store_sk"), net.alias("net"))
            .group_by("store_sk").agg(mod.sum_("net", "net_sales")))


def qb_reference(ss, sr):
    """bench.py's ``cpu_qb_vectorized`` in int64: each sale's return found
    by a search of the sorted return keys, then net sums per store, as
    the query's rows (store_sk, net_sales), by store."""
    import torch

    k = np.int64(2 * N_ITEMS)
    skey = ss["ticket"] * k + ss["item_sk"]
    rkey = sr["ticket"] * k + sr["item_sk"]
    order = np.argsort(rkey)
    rk_sorted = rkey[order]
    ramt_sorted = sr["return_amt"][order]
    # the searches and the sums in torch on the host (every core)
    pos = torch.searchsorted(torch.from_numpy(rk_sorted),
                             torch.from_numpy(skey)).numpy()
    pos_c = np.clip(pos, 0, max(len(rk_sorted) - 1, 0))
    found = (len(rk_sorted) > 0) & (rk_sorted[pos_c] == skey)
    matched = np.where(found, ramt_sorted[pos_c], 0)
    net = ss["ext_sales"].astype(np.int64) - matched
    sums = torch.zeros(N_STORES + 1, dtype=torch.int64).index_add_(
        0, torch.from_numpy(ss["store_sk"].astype(np.int64)),
        torch.from_numpy(net)).numpy()
    present = np.zeros(N_STORES + 1, np.bool_)
    present[ss["store_sk"]] = True
    return [(s, Decimal(int(sums[s])).scaleb(-2))
            for s in range(1, N_STORES + 1) if present[s]]


def qc_query(sales, mod):
    """bench.py's ``build_qc`` over a DataFrame of the package whose
    session module is ``mod``."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    nodes = importlib.import_module(pkg + ".plan.nodes")
    col, lit = mod.col, mod.lit
    daily = (sales.group_by("store_sk", "date_sk")
             .agg(mod.sum_("ext_sales", "day_sales")))
    ranked = daily.window(
        [nodes.WindowFunction("rank", None, "rk")],
        partition_by=["store_sk"],
        order_by=[(col("day_sales"), mod.SortSpec(ascending=False,
                                                  nulls_first=False))])
    return ranked.filter(col("rk") <= lit(5))


def qc_reference(ss):
    """bench.py's ``cpu_qc_vectorized`` in int64: day sums per (store,
    date), ranked within each store by the sum, descending (ties share
    the rank), kept to rank 5; a set of (store_sk, date_sk, cents,
    rank)."""
    key = ss["store_sk"].astype(np.int64) * np.int64(N_DATES + 1) \
        + (ss["date_sk"].astype(np.int64) - DATE_SK0)
    sums = np.zeros((N_STORES + 1) * (N_DATES + 1), np.int64)
    np.add.at(sums, key, ss["ext_sales"].astype(np.int64))
    nz = np.nonzero(sums)[0]
    stores = nz // (N_DATES + 1)
    vals = sums[nz]
    order = np.lexsort((-vals, stores))
    st_sorted = stores[order]
    v_sorted = vals[order]
    idx = np.arange(len(order))
    starts = np.ones(len(order), np.bool_)
    starts[1:] = st_sorted[1:] != st_sorted[:-1]
    run_start = np.maximum.accumulate(np.where(starts, idx, -1))
    new_val = starts.copy()
    new_val[1:] |= v_sorted[1:] != v_sorted[:-1]
    anchor = np.maximum.accumulate(np.where(new_val, idx, -1))
    rank = anchor - run_start + 1
    keep = rank <= 5
    d_sorted = ((nz % (N_DATES + 1)) + DATE_SK0)[order]
    return {(int(s), int(d), int(v), int(r))
            for s, d, v, r in zip(st_sorted[keep], d_sorted[keep],
                                  v_sorted[keep], rank[keep])}


def qc_rows(rows):
    """The query's rows (store_sk, date_sk, day_sales, rk) as
    ``qc_reference``'s set; a repeated row fails."""
    out = {(int(s), int(d), int(v.scaleb(2)), int(r))
           for s, d, v, r in rows}
    if len(out) != len(rows):
        fail("qc returned a row twice")
    return out


def qa_reference(ss, dd, limit: int = QA_LIMIT):
    """bench.py's ``cpu_qa_vectorized`` in integers (a sort and segment
    sums in int64), then ordered and cut as the query orders and cuts."""
    qoy = np.zeros(DATE_SK0 + N_DATES + 1, np.int32)
    year = np.zeros(DATE_SK0 + N_DATES + 1, np.int32)
    qoy[dd["date_sk"]] = dd["d_qoy"]
    year[dd["date_sk"]] = dd["d_year"]
    f = qoy[ss["date_sk"]] == 1
    yk = year[ss["date_sk"][f]].astype(np.int64)
    key = (yk - 1998) * (N_STORES + 1) + ss["store_sk"][f]
    if key.size == 0:
        return []
    order = np.argsort(key, kind="stable")
    ks = key[order]
    vs = ss["ext_sales"][f].astype(np.int64)[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    sums = np.add.reduceat(vs, starts)
    rows = [(int(1998 + k // (N_STORES + 1)), int(k % (N_STORES + 1)),
             Decimal(int(v)).scaleb(-2)) for k, v in zip(ks[starts], sums)]
    rows.sort(key=lambda r: (r[0], -r[2], r[1]))
    return rows[:limit]


# ---------------------------------------------------------------------------
# bench rung3_ooc data: a fact table joined to a 5,000-row dimension, out of
# core (bench.py:1366-1472)
# ---------------------------------------------------------------------------

OOC_SEED = 23                      # bench.py's rung3_ooc seed
OOC_DIM = 5000
OOC_GROUPS = 25
BENCH_OOC_POOL = 8 << 20           # bench.py's BENCH_OOC_POOL_BYTES default
OOC_POOL = 48 << 20                # the slice's pool at SF10 rows
OOC_ROW_BYTES = 23                 # k int + v, pad long, a validity byte each


def bench_ooc_rows(pool: int) -> int:
    """bench.py's default fact rows for a pool: 10x the pool at 20 flat
    bytes a row, at least 2**20."""
    return max((10 * pool) // 20, 1 << 20)


def make_ooc(n: int):
    """bench.py's rung3_ooc tables: (fact, dim) as numpy columns."""
    rng = np.random.default_rng(OOC_SEED)
    fact = {"k": rng.integers(0, OOC_DIM, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n),
            "pad": rng.integers(0, 1 << 30, n)}
    dk = np.arange(OOC_DIM, dtype=np.int32)
    return fact, {"k": dk, "g": (dk % OOC_GROUPS).astype(np.int32)}


def ooc_conf(pool: int, n: int) -> dict:
    """bench.py's rung3_ooc conf: the pool through the test override, a
    batch goal of an eighth of it, 16 reader batches, no broadcast and no
    adaptive execution."""
    return {"spark.rapids.tpu.test.deviceMemoryBytes": str(pool),
            "spark.rapids.sql.batchSizeBytes": max(pool // 8, 1 << 20),
            "spark.rapids.sql.reader.batchSizeRows": max(n // 16, 1),
            "spark.sql.autoBroadcastJoinThreshold": "-1",
            "spark.sql.adaptive.enabled": False}


def ooc_frames(mod, session, fact, dim):
    """The two tables as ``LocalTableScan`` DataFrames of the package whose
    session module is ``mod`` (bench.py's ``_df``: non-nullable fields,
    int32 columns as INT and int64 as LONG)."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    T = importlib.import_module(pkg + ".types")
    HC = importlib.import_module(pkg + ".columnar.column").HostColumn
    LTS = importlib.import_module(pkg + ".plan.nodes").LocalTableScan

    def df(cols):
        types = [T.INT if v.dtype == np.int32 else T.LONG
                 for v in cols.values()]
        sch = T.StructType([T.StructField(k, t, False)
                            for k, t in zip(cols, types)])
        host = [HC.from_numpy(np.ascontiguousarray(v), t)
                for v, t in zip(cols.values(), types)]
        return mod.DataFrame(LTS(host, sch), session)

    return df(fact), df(dim)


def ooc_query(fact, dim, mod):
    return (fact.join(dim, on="k", how="inner")
            .group_by("g").agg(mod.sum_("v", "sv")))


def ooc_reference(fact, dim):
    """bench.py's ``cpu_ooc``: a bincount of v by the dimension's group,
    as {g: sum} over the non-zero sums."""
    sums = np.bincount(dim["g"][fact["k"]],
                       weights=fact["v"].astype(np.float64),
                       minlength=OOC_GROUPS)
    return {int(i): int(sums[i]) for i in range(OOC_GROUPS) if sums[i]}


def ooc_rows(rows):
    return {int(g): int(sv) for g, sv in rows if sv}


def ooc_plan(pool: int, n: int):
    """The reference's plan for rung3_ooc at ``n`` fact rows and ``pool``:
    the fact exchange sized to ceil(n * 23 / (pool / 8)) partitions."""
    est = n * OOC_ROW_BYTES
    parts = min(-(-est // max(pool // 8, 1 << 16)), 256)
    goal = max(pool // 8, 1 << 20)
    return ["TpuHashAggregate(Complete) keys=[g] aggs=[sum(v) AS sv]",
            "  TpuShuffledSymmetricHashJoinExec Inner [k=k]",
            f"    TpuCoalesceBatches TargetSize({goal})",
            f"      TpuShuffleExchange hashpartitioning(k, {parts}) "
            f"[sized 16->{parts} partitions (est {est}B)]",
            "        <scan>",
            f"    TpuCoalesceBatches TargetSize({goal})",
            "      TpuShuffleExchange SinglePartition",
            "        <scan>"]


def ooc_qb_conf(pool: int) -> dict:
    """Phase 13: qb from Parquet under rung3_ooc's pool and batch goal,
    with no broadcast and no adaptive execution."""
    return dict(QA_CONF, **{
        "spark.rapids.tpu.test.deviceMemoryBytes": str(pool),
        "spark.rapids.sql.batchSizeBytes": max(pool // 8, 1 << 20),
        "spark.sql.autoBroadcastJoinThreshold": "-1",
        "spark.sql.adaptive.enabled": False})


def ooc_qb_plan(goal: int):
    """qb's plan with adaptive execution off: a coalesce to ``goal`` over
    each (single-partition) exchange, the join bare."""
    return ["TpuHashAggregate(Complete) keys=[store_sk] aggs=[sum(net) AS "
            "net_sales] fused=[Project]",
            "  TpuShuffledSymmetricHashJoinExec LeftOuter [ticket=ticket, "
            "item_sk=item_sk]",
            f"    TpuCoalesceBatches TargetSize({goal})",
            "      TpuShuffleExchange SinglePartition",
            "        <scan>",
            f"    TpuCoalesceBatches TargetSize({goal})",
            "      TpuShuffleExchange SinglePartition",
            "        <scan>"]


# ---------------------------------------------------------------------------
# bench rung3: a struct column through a CPU stage, then a grouped
# decimal(25,4) sum/min/max; and an out-of-core sort of a union of 8 scans
# (bench.py:1226-1352)
# ---------------------------------------------------------------------------

RUNG3_SEED = 11                    # bench.py's rung3 seed
RUNG3_BENCH_ROWS = 2_000_000       # bench.py's rung3 size
RUNG3_CHUNKS = 8                   # the sort input's scans
RUNG3_SORT_ROW_BYTES = 49          # k int, amt limbs, 3 longs, 5 validity
RUNG3_AGG_PLAN = [
    "TpuHashAggregate(Complete) keys=[k] aggs=[sum(amt) AS sum_amt, "
    "min(amt) AS lo, max(amt) AS hi, sum(sa) AS ssa]",
    "  TpuRowToColumnar <- Project [k, amt, s.a AS sa]",
    "Fallback reasons:",
    "      !Project cannot run on TPU because expression BoundReference "
    "produces an unsupported type: struct<a:bigint,b:int> is not supported"]
RUNG3_SORT_PLAN = (
    ["TpuHashAggregate(Complete) keys=[] aggs=[count_star(*) AS count]",
     "  TpuSort [amt ASC]"]
    + [f"    {'  ' * i}TpuUnionExec" for i in range(RUNG3_CHUNKS - 1)]
    + [f"    {'  ' * (RUNG3_CHUNKS - 1)}<scan>"] * 2
    + [f"    {'  ' * i}<scan>" for i in range(RUNG3_CHUNKS - 2, 0, -1)])


def make_rung3(n: int):
    """bench.py's rung3 columns (seed 11): k, amt (decimal(25,4)
    unscaled), qty, and the struct's a and b."""
    rng = np.random.default_rng(RUNG3_SEED)
    return {"k": rng.integers(0, 1000, n).astype(np.int32),
            "amt": rng.integers(-10 ** 12, 10 ** 12, n),
            "qty": rng.integers(1, 100, n).astype(np.int32),
            "sa": rng.integers(0, 10 ** 6, n),
            "sb": rng.integers(-500, 500, n).astype(np.int32)}


def rung3_conf(n: int) -> dict:
    """bench.py's rung3 conf: a pool fraction under the 64 MiB floor, an
    8 MiB batch goal, 8 reader batches."""
    return {"spark.rapids.sql.enabled": True,
            "spark.rapids.memory.gpu.allocFraction": 0.0001,
            "spark.rapids.sql.batchSizeBytes": 8 << 20,
            "spark.rapids.sql.reader.batchSizeRows": max(n // 8, 1)}


def _amt_limbs(amt):
    return np.stack([np.where(amt < 0, -1, 0), amt],
                    axis=1).astype(np.int64)


def rung3_frames(mod, session, d):
    """bench.py's two rung3 DataFrames, in the package whose session
    module is ``mod``: (the aggregate over the struct projection, the
    sort of a union of 8 scans)."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    T = importlib.import_module(pkg + ".types")
    HC = importlib.import_module(pkg + ".columnar.column").HostColumn
    LTS = importlib.import_module(pkg + ".plan.nodes").LocalTableScan
    GSF = importlib.import_module(pkg + ".expr.complextypes").GetStructField
    n = len(d["k"])
    dec = T.DecimalType(25, 4)
    struct_t = T.StructType([T.StructField("a", T.LONG, False),
                             T.StructField("b", T.INT, False)])
    ones = np.ones(n, np.bool_)
    host = [HC.from_numpy(d["k"], T.INT),
            HC(dec, ones, data=_amt_limbs(d["amt"])),
            HC.from_numpy(d["qty"], T.INT),
            HC(struct_t, ones, children=[HC.from_numpy(d["sa"], T.LONG),
                                         HC.from_numpy(d["sb"], T.INT)])]
    schema = T.StructType([T.StructField("k", T.INT, False),
                           T.StructField("amt", dec, False),
                           T.StructField("qty", T.INT, False),
                           T.StructField("s", struct_t, False)])
    col, lit = mod.col, mod.lit
    agg = (mod.DataFrame(LTS(host, schema), session)
           .filter(col("qty") > lit(5))
           .select(col("k"), col("amt"), GSF(col("s"), "a").alias("sa"))
           .group_by("k")
           .agg(mod.sum_("amt", "sum_amt"), mod.min_("amt", "lo"),
                mod.max_("amt", "hi"), mod.sum_("sa", "ssa")))
    schema = T.StructType([T.StructField("k", T.INT, False),
                           T.StructField("amt", dec, False),
                           T.StructField("sa", T.LONG, False),
                           T.StructField("sa2", T.LONG, False),
                           T.StructField("sa3", T.LONG, False)])
    step = -(-n // RUNG3_CHUNKS)
    df = None
    for c0 in range(0, n, step):
        sl = slice(c0, min(c0 + step, n))
        sa = d["sa"][sl]
        part = [HC.from_numpy(d["k"][sl], T.INT),
                HC(dec, np.ones(sl.stop - sl.start, np.bool_),
                   data=_amt_limbs(d["amt"][sl])),
                HC.from_numpy(sa, T.LONG), HC.from_numpy(sa * 2, T.LONG),
                HC.from_numpy(sa + 7, T.LONG)]
        part = mod.DataFrame(LTS(part, schema), session)
        df = part if df is None else df.union(part)
    return agg, df.order_by(col("amt"))


def rung3_count_query(sort_q):
    """What ``DataFrame.count`` collects: count(*) over the sort."""
    return sort_q.agg(("count_star", None, "count"))


def rung3_reference(d):
    """bench's aggregate in numpy, exact: {k: (sum, min, max of amt
    unscaled, sum of sa)} over the rows with qty > 5 (amt summed in two
    int64 halves, so nothing wraps)."""
    keep = d["qty"] > 5
    k, amt, sa = d["k"][keep], d["amt"][keep], d["sa"][keep]
    order = np.argsort(k, kind="stable")
    k, amt, sa = k[order], amt[order], sa[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    hi, lo = np.divmod(amt, 10 ** 6)
    s_hi = np.add.reduceat(hi, starts)
    s_lo = np.add.reduceat(lo, starts)
    mins = np.minimum.reduceat(amt, starts)
    maxs = np.maximum.reduceat(amt, starts)
    ssa = np.add.reduceat(sa, starts)
    return {int(k[s]): (int(s_hi[i]) * 10 ** 6 + int(s_lo[i]),
                        int(mins[i]), int(maxs[i]), int(ssa[i]))
            for i, s in enumerate(starts)}


def _dec_ints(h) -> list:
    """A decimal host column's unscaled values as Python ints (limbs read
    as one 128-bit integer each)."""
    if h.data.ndim == 1:
        return [int(v) for v in h.data]
    return [(int(a) << 64) + (int(b) & (2 ** 64 - 1)) for a, b in h.data]


def rung3_rows(host) -> dict:
    """The aggregate's host columns as ``rung3_reference``'s dict; every
    value must be valid."""
    if not all(bool(h.validity.all()) for h in host):
        return {"null": True}
    k, s, lo, hi, ssa = host
    return {int(kk): t for kk, t in zip(
        k.data, zip(_dec_ints(s), _dec_ints(lo), _dec_ints(hi),
                    (int(v) for v in ssa.data)))}


def rung3_sort_check(host, d):
    """None when the sorted frame's host columns are ``d``'s rows with amt
    non-decreasing and equal to numpy's sort, else a complaint."""
    k, amt, sa, sa2, sa3 = host
    n = len(d["k"])
    if k.num_rows != n:
        return f"{k.num_rows} rows, want {n}"
    lo = amt.data[:, 1]
    if not np.array_equal(amt.data[:, 0], np.where(lo < 0, -1, 0)):
        return "amt limbs out of the int64 range"
    if not np.array_equal(lo, np.sort(d["amt"])):
        return "amt is not numpy's sort of amt"
    if not (np.array_equal(sa2.data, sa.data * 2)
            and np.array_equal(sa3.data, sa.data + 7)):
        return "rows came apart (sa2, sa3 do not follow sa)"
    got = np.lexsort((sa.data, lo, k.data))
    want = np.lexsort((d["sa"], d["amt"], d["k"]))
    if not (np.array_equal(k.data[got], d["k"][want])
            and np.array_equal(lo[got], d["amt"][want])
            and np.array_equal(sa.data[got], d["sa"][want])):
        return "the multiset of (k, amt, sa) rows differs from the input"
    return None


# ---------------------------------------------------------------------------
# bench rung4_dist: the fact-dimension join and grouped sum over two worker
# processes, one of them SIGKILLed mid-shuffle (bench.py:1473-1687)
# ---------------------------------------------------------------------------

DIST_SEED = 29                     # bench.py's rung4_dist seed
DIST_DIM = 2000
DIST_GROUPS = 31
DIST_BENCH_ROWS = 200_000          # bench.py's BENCH_DIST_ROWS default
DIST_KILL_AT = 5                   # bench0 dies at the 5th shipped block
DIST_JOIN_S = 60                   # the workers must join within this
DIST_WORKERS = ("bench0", "bench1")
DIST_PLAN = ["TpuHashAggregate(Complete) keys=[g] aggs=[sum(v) AS sv]",
             "  TpuShuffledSymmetricHashJoinExec Inner [k=k]",
             "    TpuCoalesceBatches TargetSize(262144)",
             "      TpuShuffleExchange hashpartitioning(k, 16)",
             "        <scan>",
             "    TpuCoalesceBatches TargetSize(262144)",
             "      TpuShuffleExchange hashpartitioning(k, 16)",
             "        <scan>"]


def make_dist(n: int, seed: int = DIST_SEED):
    """bench.py's rung4_dist tables (and, with its seed, rung5_recovery's):
    (fact, dim) as numpy columns."""
    rng = np.random.default_rng(seed)
    fact = {"k": rng.integers(0, DIST_DIM, n).astype(np.int32),
            "v": rng.integers(-1000, 1000, n)}
    dk = np.arange(DIST_DIM, dtype=np.int32)
    return fact, {"k": dk, "g": (dk % DIST_GROUPS).astype(np.int32)}


def dist_worker_mem(n: int) -> int:
    """bench.py's per-worker store: 5 bytes a fact row over 100, so the
    shuffle is about 100x one store."""
    return max((n * 5) // 100, 4096)


def dist_conf(n: int) -> dict:
    """bench.py's rung4_dist conf: the distributed tier on, no broadcast
    and no adaptive execution, a 256 KiB batch goal, 16 reader batches,
    and fast liveness (100 ms heartbeats, LOST past 600 ms)."""
    return {"spark.rapids.sql.enabled": True,
            "spark.rapids.tpu.distributed.enabled": True,
            "spark.sql.autoBroadcastJoinThreshold": "-1",
            "spark.sql.adaptive.enabled": False,
            "spark.rapids.sql.batchSizeBytes": 256 << 10,
            "spark.rapids.sql.reader.batchSizeRows": max(n // 16, 1),
            "spark.rapids.tpu.distributed.heartbeatMs": 100,
            "spark.rapids.tpu.distributed.workerLostMs": 600,
            "spark.rapids.tpu.distributed.opTimeoutMs": 1000}


def dist_reference(fact, dim, n_groups: int = DIST_GROUPS):
    """bench.py's ``cpu_dist``: {g: sum of v} over the non-zero sums of
    ``n_groups`` groups."""
    sums = np.bincount(dim["g"][fact["k"]],
                       weights=fact["v"].astype(np.float64),
                       minlength=n_groups)
    return {int(i): int(sums[i]) for i in range(n_groups) if sums[i]}


# ---------------------------------------------------------------------------
# K1 checks
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


def random_hybrid_stream(rng, bw: int, total: int, max_run: int):
    """A hybrid RLE/bit-packed stream of at least ``total`` values whose
    last packed payload is cut short; returns (bytes, total)."""
    vbytes = (bw + 7) // 8
    parts = []
    got = 0
    last_packed = None
    while got < total:
        want = int(rng.integers(1, max_run + 1))
        if rng.random() < 0.4:
            value = int(rng.integers(0, 1 << bw))
            parts.append(_varint(want << 1)
                         + value.to_bytes(vbytes, "little"))
            got += want
        else:
            groups = -(-want // 8)
            parts.append(_varint((groups << 1) | 1))
            parts.append(rng.integers(0, 256, groups * bw,
                                      dtype=np.uint8).tobytes())
            last_packed = len(parts) - 1
            got += groups * 8
    if last_packed is not None:                 # truncate the last payload
        p = parts[last_packed]
        parts[last_packed] = p[:max(len(p) - int(rng.integers(1, bw + 1)),
                                    0)]
        parts = parts[:last_packed + 1]
    buf = b"".join(parts)
    return buf, total - int(rng.integers(0, 8))


def check_k1(device, seed: int):
    import torch

    from spark_rapids_tpu_torch.io.parquet_native import split_hybrid_runs
    from spark_rapids_tpu_torch.pallas import decode
    from spark_rapids_tpu_torch.perfcounters import to_device

    rng = np.random.default_rng(seed)
    cases = [(bw, 1 << 20, 2048) for bw in range(1, 25)]
    cases.append((13, K1_BIG_VALUES, K1_BIG_VALUES // 4))
    cases.append((24, K1_BIG_VALUES, K1_BIG_VALUES // 3))
    for bw, total, max_run in cases:
        buf, total = random_hybrid_stream(rng, bw, total, max_run)
        runs = split_hybrid_runs(buf, bw, total)
        table = decode.run_table(runs, total, bw)
        dev_buf = to_device(np.frombuffer(buf, np.uint8), device)
        dev_tab = to_device(table, device)
        got = decode.unpack_runs(dev_buf, 0, dev_tab, total)
        want = decode.unpack_runs_plain(dev_buf, 0, dev_tab, total)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            fail(f"K1 bw={bw} total={total}: {bad} values differ from "
                 "the plain version")
        if total <= (1 << 21):
            # zero bytes past the cut payload: what the kernel reads there
            host = decode.expand_runs_host(runs, buf + bytes(bw), total, bw)
            if not np.array_equal(got.cpu().numpy().astype(np.uint32), host):
                fail(f"K1 bw={bw}: differs from expand_runs_host")
        del got, want, dev_buf, dev_tab
    log(f"K1: equal to its plain version for every bw in 1..24 and at "
        f"{K1_BIG_VALUES} values (bw 13, 24), max_abs_err 0")


def check_decimal128(device, seed: int):
    """The 64x64->128 multiply and the 128-bit sum on the card, against
    Python integers, at the int64 edges (wrapping int64 on CUDA)."""
    import torch

    from spark_rapids_tpu_torch.expr import decimal128 as D

    rng = np.random.default_rng(seed)
    edges = [0, 1, -1, 10 ** 18 - 1, -(10 ** 18 - 1), -(2 ** 63),
             2 ** 63 - 1, 2 ** 32, -(2 ** 32) + 1]
    a = edges * len(edges) + [int(x) for x in rng.integers(
        -(2 ** 63), 2 ** 63 - 1, 4096, dtype=np.int64)]
    b = [e for e in edges for _ in edges] + [int(x) for x in rng.integers(
        -(2 ** 63), 2 ** 63 - 1, 4096, dtype=np.int64)]
    hi, lo = D.mul64_to_128(torch.tensor(a, device=device),
                            torch.tensor(b, device=device))
    got = [D.to_py(h, l) for h, l in zip(hi.tolist(), lo.tolist())]
    if got != [x * y for x, y in zip(a, b)]:
        fail("mul64_to_128 on the card differs from exact products")
    valid = torch.ones(len(a), dtype=torch.bool, device=device)
    for n in (len(edges) ** 2, len(a)):     # the edges alone; all of them
        ok, _, sh, sl = D.sum128_global(hi[:n], lo[:n], valid[:n])
        want = sum(x * y for x, y in zip(a[:n], b[:n]))
        fits = -(2 ** 127) <= want < 2 ** 127
        if bool(ok) != fits or (fits and D.to_py(int(sh), int(sl)) != want):
            fail(f"sum128_global on the card differs from the exact sum "
                 f"of {n} products")
    log(f"decimal128: mul64_to_128 and sum128_global exact on the card "
        f"({len(a)} products incl. +-(10^18-1) and INT64_MIN)")


def _cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``iters`` back-to-back calls (L2 warm)."""
    import torch

    for _ in range(warmup):
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


_flush = None
SLEEP_CYCLES = 200_000             # ~0.1 ms: the host queues the launch


def _event_time_ms(fn, iters: int, cold: bool) -> float:
    """Median device time of one call of ``fn``, each call between its own
    pair of events.  Before each pair the card sleeps ~0.1 ms, touching no
    memory, so that the host has queued the call before the first event
    fires and the pair holds the kernel alone, not the host's launch cost.
    ``cold``: a 256 MB scratch write before each call leaves the L2 cache
    holding none of its inputs; else the previous call left them there."""
    import torch

    global _flush
    if cold and _flush is None:
        _flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                             device="cuda")
    fn()
    pairs = []
    for _ in range(iters):
        if cold:
            _flush.fill_(1)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def main_path_pages(path: str):
    """The dictionary-index data pages of one Q6 file, as the scan sees them."""
    from spark_rapids_tpu_torch.io.parquet_native import (read_column_pages,
                                                          read_footer)

    with open(path, "rb") as fh:
        data = fh.read()
    groups, _ = read_footer(data)
    out = []
    for g in groups:
        for info in g.columns:
            cp = read_column_pages(data, info, g.num_rows)
            out += [(info.name, page) for page in cp.pages]
    return out


def time_k1_and_gather(paths, device):
    """K1 at every index page of the first file, L2 cold and warm, and the
    snappy gather on the same stored pages against the host
    decompressor."""
    import torch

    from spark_rapids_tpu_torch.io.parquet_native import split_hybrid_runs
    from spark_rapids_tpu_torch.native import snappy_uncompress
    from spark_rapids_tpu_torch.pallas import decode
    from spark_rapids_tpu_torch.pallas.decompress import (_parse_ops,
                                                          snappy_gather)
    from spark_rapids_tpu_torch.perfcounters import to_device

    totals = {"ms": 0.0, "ms_cold": 0.0, "fill_ms": 0.0, "plain_ms": 0.0,
              "bound_bytes": 0}
    max_err = 0
    for name, page in main_path_pages(paths[0]):
        bw, n = page.index_bit_width, page.num_values
        runs = split_hybrid_runs(page.value_buf, bw, n)
        table = decode.run_table(runs, n, bw, len(page.value_buf))
        dev_buf = to_device(np.frombuffer(page.value_buf, np.uint8), device)
        dev_tab = to_device(table, device)

        def kernel():
            return decode.unpack_runs(dev_buf, 0, dev_tab, n)

        def plain():
            return decode.unpack_runs_plain(dev_buf, 0, dev_tab, n)

        ms_cold = _event_time_ms(kernel, COLD_ITERS, cold=True)
        ms = _cuda_time_ms(kernel, 20)
        ms_alone = _event_time_ms(kernel, 20, cold=False)
        plain_ms = _cuda_time_ms(plain, 3, warmup=1)
        # yardstick: writing the output alone, under the same protocol
        out = torch.empty(n, dtype=torch.int32, device=device)
        fill_ms = _event_time_ms(lambda: out.fill_(0), COLD_ITERS,
                                 cold=True)
        err = int((kernel().to(torch.int64) - plain().to(torch.int64))
                  .abs().max())
        max_err = max(max_err, err)
        nbytes = decode.bound_bytes(table, n)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"K1 page {name}: bw={bw} values={n} runs={len(runs)} kernel "
            f"{ms_cold:.4f} ms L2-cold ({bound_ms / ms_cold:.2f} of bound), "
            f"{ms:.4f} ms warm back to back, {ms_alone:.4f} ms warm alone; "
            f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({nbytes} "
            f"bytes); the output alone (fill_) {fill_ms:.4f} ms L2-cold")
        totals["ms"] += ms
        totals["ms_cold"] += ms_cold
        totals["fill_ms"] += fill_ms
        totals["plain_ms"] += plain_ms
        totals["bound_bytes"] += nbytes
        # the torch snappy gather on the stored page, against the host
        usize, ops = _parse_ops(page.raw_values)
        comp = to_device(np.frombuffer(page.raw_values, np.uint8), device)
        arrs = [to_device(np.array([o[i] for o in ops], np.int64), device)
                for i in (1, 3)]
        lit = to_device(np.array([1 - o[0] for o in ops], np.int64), device)
        got = snappy_gather(comp, arrs[0], arrs[1], lit, usize).cpu().numpy()
        want = np.frombuffer(snappy_uncompress(page.raw_values, usize),
                             np.uint8)
        if not np.array_equal(got, want):
            fail(f"snappy gather differs from the host on page {name}")
        log(f"snappy gather page {name}: {usize} bytes, {len(ops)} ops, "
            "equal to the host decompressor")
    if max_err:
        fail(f"K1 differs from its plain version at the main-path pages "
             f"(max_abs_err {max_err})")
    bound_ms = totals["bound_bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"K1 main-path pages: {totals['ms_cold']:.4f} ms L2-cold "
        f"({bound_ms / totals['ms_cold']:.2f} of bound), {totals['ms']:.4f}"
        f" ms warm back to back, bound {bound_ms:.4f} ms; the outputs alone"
        f" (fill_) {totals['fill_ms']:.4f} ms L2-cold")
    return totals, max_err


def spark_pages(rng, bw: int, total: int):
    """``total`` values of width ``bw`` as parquet-mr and Arrow write a
    column chunk: pages of ``SPARK_PAGE_VALUES`` values, each a row of
    bit-packed runs of ``SPARK_RUN_VALUES`` values; random indices."""
    pages = []
    for lo in range(0, total, SPARK_PAGE_VALUES):
        n = min(SPARK_PAGE_VALUES, total - lo)
        groups = [SPARK_RUN_VALUES // 8] * (n // SPARK_RUN_VALUES)
        if n % SPARK_RUN_VALUES:
            groups.append(-(-(n % SPARK_RUN_VALUES) // 8))
        payload = rng.integers(0, 256, sum(groups) * bw,
                               dtype=np.uint8).tobytes()
        parts, at = [], 0
        for g in groups:
            parts += [_varint((g << 1) | 1), payload[at:at + g * bw]]
            at += g * bw
        pages.append((b"".join(parts), n))
    return pages


def time_spark_batches(device, seed: int):
    """K1 on one SF10 file's worth of Spark-shaped pages for each index
    width of the Q6 files: one batched launch against the same pages
    launched one by one; both exact against the plain version."""
    import torch

    from spark_rapids_tpu_torch.io.parquet_native import split_hybrid_runs
    from spark_rapids_tpu_torch.pallas import decode
    from spark_rapids_tpu_torch.perfcounters import to_device

    rng = np.random.default_rng(seed)
    totals = {"ms_cold": 0.0, "bound_bytes": 0}
    for bw in (4, 6, 12, 21):
        pages = spark_pages(rng, bw, FILE_VALUES)
        t0 = time.perf_counter()
        entries, base = [], 0
        for buf, n in pages:
            entries.append((split_hybrid_runs(buf, bw, n), n, bw, base,
                            len(buf)))
            base += len(buf)
        table, total = decode.batch_run_table(entries)
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_buf = to_device(np.frombuffer(b"".join(b for b, _ in pages),
                                          np.uint8), device)
        dev_tab = to_device(table, device)
        page_tabs = [(e[3], e[1], to_device(decode.run_table(*e[:3], e[4]),
                                            device)) for e in entries]

        def batched():
            return decode.unpack_runs(dev_buf, 0, dev_tab, total)

        def one_by_one():
            return [decode.unpack_runs(dev_buf, b, t, n)
                    for b, n, t in page_tabs]

        want = decode.unpack_runs_plain(dev_buf, 0, dev_tab, total)
        before = decode.unpack_launches
        got = batched()
        launches = decode.unpack_launches - before
        if not torch.equal(got, want) or not torch.equal(
                torch.cat(one_by_one()), want):
            fail(f"K1 on the Spark-shaped batch, bw={bw}, differs from its "
                 "plain version")
        ms_cold = _event_time_ms(batched, COLD_ITERS, cold=True)
        ms = _cuda_time_ms(batched, 20)
        ms_alone = _event_time_ms(batched, 20, cold=False)
        pages_cold = _event_time_ms(one_by_one, 5, cold=True)
        plain_ms = _cuda_time_ms(
            lambda: decode.unpack_runs_plain(dev_buf, 0, dev_tab, total), 3,
            warmup=1)
        nbytes = decode.bound_bytes(table, total)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"K1 Spark-shaped bw={bw}: {len(pages)} pages, {len(table)} "
            f"rows, {total} values; one launch ({launches}) {ms_cold:.4f} ms "
            f"L2-cold ({bound_ms / ms_cold:.2f} of bound), {ms:.4f} ms warm "
            f"back to back, {ms_alone:.4f} ms warm alone; {len(pages)} "
            f"launches one by one {pages_cold:.4f} ms L2-cold;"
            f" plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({nbytes} "
            f"bytes); host runs + table {host_ms:.1f} ms; equal")
        totals["ms_cold"] += ms_cold
        totals["bound_bytes"] += nbytes
        del dev_buf, dev_tab, page_tabs, got, want
    return totals


def run_fixture_q6(device):
    """Q6 on the committed multi-page fixture, exact against numpy; the
    launch count is read around one collect."""
    import torch

    from spark_rapids_tpu_torch.io.parquet_device import read_parquet_device
    from spark_rapids_tpu_torch.pallas import decode
    from spark_rapids_tpu_torch.session import TpuSession

    path = os.path.join(HERE, FIXTURE)
    if not os.path.exists(path):
        fail(f"fixture {FIXTURE} missing")
    li = fixture_lineitem()
    want = q6_reference(li)
    _, rsch = schemas()
    batch = read_parquet_device(path, rsch, device)
    for f, c in zip(rsch.fields, batch.columns):
        if not np.array_equal(c.data.cpu().numpy(), li[f.name]):
            fail(f"fixture column {f.name} differs from numpy")
    s = TpuSession({"spark.rapids.sql.format.parquet.decode.device": True,
                    "spark.rapids.sql.format.parquet.reader.type":
                    "PERFILE"}, device=device)
    q = q6_query(s.read.schema(rsch).parquet(path))
    torch.cuda.synchronize()
    decode.unpack_launches = 0
    got = q.collect()
    launches = decode.unpack_launches
    if got != [(want,)]:
        fail(f"Q6 on the fixture: {got} != {want}")
    if launches != len(rsch.fields):
        fail(f"Q6 on the fixture launched K1 {launches} times, not once "
             "per column chunk")
    log(f"Q6 fixture ({FIXTURE_ROWS} rows, 20,000-row pages): revenue "
        f"{got[0][0]} == numpy reference; columns equal; "
        f"unpack_launches={launches}")


def check_gather_chains(device, seed: int):
    """A compressible stream with dist-1 RLE chains through the gather."""
    from spark_rapids_tpu_torch.native import snappy_compress
    from spark_rapids_tpu_torch.pallas.decompress import snappy_to_device

    rng = np.random.default_rng(seed)
    raw = np.repeat(rng.integers(0, 256, 1 << 16, dtype=np.uint8),
                    rng.integers(1, 600, 1 << 16)).tobytes()
    got = snappy_to_device(snappy_compress(raw), device).cpu().numpy()
    if got.tobytes() != raw:
        fail("snappy gather differs on an RLE-chain stream")
    log(f"snappy gather: RLE-chain stream of {len(raw)} bytes equal")


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def build_all():
    from spark_rapids_tpu_torch import native
    from spark_rapids_tpu_torch.pallas import decode

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(decode.build_kernel), pool.submit(native.get_lib)]
        for f in futs:
            f.result()
    return time.perf_counter() - t0


def run_q6(paths, li, n: int, device):
    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.pallas import decode
    from spark_rapids_tpu_torch.session import TpuSession

    _, rsch = schemas()
    want = q6_reference(li)
    conf = {"spark.rapids.sql.format.parquet.decode.device": True}
    s = TpuSession(conf, device=device)
    q = q6_query(s.read.schema(rsch).parquet(*paths))
    plan = q.explain().splitlines()
    log("plan:\n" + "\n".join(plan))
    if plan[0] != ("TpuHashAggregate(Complete) keys=[] aggs=[sum(revenue) "
                   "AS revenue] fused=[FilterProject]"):
        fail(f"unexpected plan line {plan[0]!r}")
    check_default_reader(plan, "Q6")
    first = q.collect()
    if first != [(want,)]:
        fail(f"Q6 from Parquet, first run: {first} != {want}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode.unpack_launches = 0
    snap = PC.snapshot()
    t0 = time.perf_counter()
    second = q.collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = decode.unpack_launches
    delta = PC.since(snap)
    if second != [(want,)]:
        fail(f"Q6 from Parquet, second run: {second} != {want}")
    if launches <= 0:
        fail("the Q6 run launched K1 no time")
    log(f"Q6 parquet: revenue {second[0][0]} == numpy reference; {n} rows "
        f"in {secs:.3f} s = {n / secs:.0f} rows/s")
    log(f"Q6 parquet counters: unpack_launches={launches} "
        f"bytes_h2d={delta['bytes_h2d']} host_syncs={delta['host_syncs']} "
        f"chunk_decode_fallbacks={delta['chunk_decode_fallbacks']} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    return {"seconds": secs, "launches": launches, "want": want, "query": q,
            "delta": delta}


def profile_collect(collect, want_rows, label: str, key=None):
    """One more collect (``collect()``: a query's ``collect`` or
    ``collect_host``) under ``torch.profiler``, its rows (through ``key``,
    if given) equal to ``want_rows``: K1's device time summed
    over its launches inside the query, and the share of the collect's
    wall time in which the card ran nothing (kernels and copies merged
    into busy intervals).  The profiler's own host cost makes the collect
    slower, so the idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        got = collect()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if (key(got) if key else got) != want_rows:
        fail(f"{label} under the profiler differs from the reference")
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"{label} profile: the profiler saw no device activity; K1 "
            "time inside the query and the idle share not measured")
        return
    k1 = [e for e in dev if "unpack_runs" in e.name]
    k1_ms = sum(e.time_range.elapsed_us() for e in k1) / 1e3
    busy_us, end = 0.0, None
    for e in sorted(dev, key=lambda e: e.time_range.start):
        a, b = e.time_range.start, e.time_range.end
        if end is None or a > end:
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    idle = 1.0 - busy_us / (wall_s * 1e6)
    log(f"{label} profile: collect {wall_s:.3f} s under the profiler; "
        f"K1 {len(k1)} launches, {k1_ms:.4f} ms device time in all; device "
        f"busy {busy_us / 1e3:.3f} ms over {len(dev)} kernels and copies; "
        f"idle share {idle:.4f}")


def time_breakdown(paths, device):
    """Where one Parquet Q6 spends its time, stage by stage: the host half
    of the scan alone, the whole device decode of a file, and the fused
    filter/project/aggregate on a batch already on the card."""
    import torch

    from spark_rapids_tpu_torch.io.parquet_device import read_parquet_device
    from spark_rapids_tpu_torch.io.parquet_native import split_hybrid_runs
    from spark_rapids_tpu_torch.session import TpuSession

    t0 = time.perf_counter()
    for p in paths:
        for _, page in main_path_pages(p):
            split_hybrid_runs(page.value_buf, page.index_bit_width,
                              page.num_values)
    host_s = time.perf_counter() - t0
    _, rsch = schemas()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = []
    for p in paths:
        batches.append(read_parquet_device(p, rsch, device))
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    s = TpuSession({"spark.rapids.sql.format.parquet.decode.device": True,
                    "spark.rapids.sql.format.parquet.reader.type":
                    "PERFILE"}, device=device)
    agg = q6_query(s.read.schema(rsch).parquet(*paths))._planned()
    agg._aggregate_batch(batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        agg._aggregate_batch(b)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    log(f"breakdown: host pages+run headers {host_s:.3f} s, scan (host + "
        f"H2D + device decode) {scan_s:.3f} s, fused stage+aggregate on "
        f"the card {stage_s:.4f} s, over {len(paths)} files")


def run_q6_memory(li, want, device):
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan
    from spark_rapids_tpu_torch.session import DataFrame, TpuSession

    _, rsch = schemas()
    s = TpuSession({}, device=device)
    host = [HostColumn.from_numpy(li[f.name], f.dataType)
            for f in rsch.fields]
    got = q6_query(DataFrame(LocalTableScan(host, rsch), s)).collect()
    if got != [(want,)]:
        fail(f"Q6 in memory: {got} != {want}")
    log(f"Q6 in memory: revenue {got[0][0]} == numpy reference")


QA_CONF = {"spark.rapids.sql.format.parquet.decode.device": True}


def write_qa_files(ss, dd, n: int, out_dir: str, device):
    """store_sales as ``N_FILES`` snappy files of its seven columns,
    date_dim as one file, by the port's writer."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.io.parquet_encode import write_parquet_device

    wsch, _, dsch = qa_schemas(T)
    os.makedirs(out_dir, exist_ok=True)
    bounds = np.linspace(0, n, N_FILES + 1).astype(np.int64)
    ss_paths = []
    for i in range(N_FILES):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        cols = [HostColumn.from_numpy(ss[f.name][lo:hi], f.dataType)
                for f in wsch.fields]
        path = os.path.join(out_dir, f"store_sales-{i:02d}.parquet")
        write_parquet_device(path, wsch, cols, hi - lo, device=device)
        ss_paths.append(path)
    dd_path = os.path.join(out_dir, "date_dim.parquet")
    write_parquet_device(dd_path, dsch,
                         [HostColumn.from_numpy(dd[f.name], f.dataType)
                          for f in dsch.fields], N_DATES, device=device)
    return ss_paths, dd_path


def qa_parquet_query(ss_paths, dd_path, device):
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    _, rsch, dsch = qa_schemas(T)
    s = S.TpuSession(QA_CONF, device=device)
    return qa_query(s.read.schema(rsch).parquet(*ss_paths),
                    s.read.schema(dsch).parquet(dd_path), S)


def plan_shape(q):
    """The explain's lines with the scans as ``<scan>`` and the adaptive
    join's measured bytes as ``<bytes>``."""
    return _shape_lines(q.explain().splitlines())


def _shape_lines(lines):
    return [re.sub(r"decided=(\w+)\(\d+B\)", r"decided=\1(<bytes>)", ln)
            if not ln.lstrip().startswith(("TpuFileSourceScan",
                                           "TpuLocalTableScan"))
            else ln[:len(ln) - len(ln.lstrip())] + "<scan>"
            for ln in lines]


def check_plan(q, want, label: str):
    """The explain must be the reference's unfused plan, scans aside."""
    if plan_shape(q) != want:
        fail(f"unexpected {label} plan:\n" + q.explain())


def check_qa_plan(q):
    check_plan(q, QA_PLAN, "qa")


def check_default_reader(plan_lines, label: str):
    """Under the default reader type (AUTO) the scan of the 8 files must
    resolve to MULTITHREADED, as the reference's does."""
    if not any(ln.strip().endswith(f"{N_FILES} files mode=MULTITHREADED")
               for ln in plan_lines):
        fail(f"{label}: the scan did not resolve AUTO to MULTITHREADED")


def timed_collects(q, check, label: str, n: int):
    """Two collects of ``q``, both held by ``check`` (rows -> None or a
    complaint).  The counts are set to 0 just before the timed second
    collect and read after it; prints its rows/s, counters and peak
    device memory."""
    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.pallas import decode

    bad = check(q.collect())
    if bad:
        fail(f"{label}, first run: {bad}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode.unpack_launches = 0
    snap = PC.snapshot()
    t0 = time.perf_counter()
    rows = q.collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = decode.unpack_launches
    delta = PC.since(snap)
    peak = torch.cuda.max_memory_allocated()
    bad = check(rows)
    if bad:
        fail(f"{label}, second run: {bad}")
    if launches <= 0:
        fail(f"the {label} run launched K1 no time")
    log(f"{label}: {len(rows)} rows == integer numpy reference; {n} "
        f"store_sales rows in {secs:.3f} s = {n / secs:.0f} rows/s")
    log(f"{label} counters: unpack_launches={launches} "
        f"bytes_h2d={delta['bytes_h2d']} host_syncs={delta['host_syncs']} "
        f"chunk_decode_fallbacks={delta['chunk_decode_fallbacks']} "
        f"max_memory_allocated={peak}")
    return {"seconds": secs, "launches": launches, "query": q,
            "rows": rows}


def run_qa(ss_paths, dd_path, want, n: int, device):
    """qa from Parquet, collected twice; both results exact."""
    q = qa_parquet_query(ss_paths, dd_path, device)
    check_qa_plan(q)
    check_default_reader(q.explain().splitlines(), "qa")
    log("qa plan:\n" + q.explain())
    out = timed_collects(
        q, lambda rows: None if rows == want else
        f"{rows[:3]}... != {want[:3]}...", "qa parquet", n)
    log(f"qa parquet: first {out['rows'][0]}, last {out['rows'][-1]}")
    return out


def fresh_plan(q):
    """A new exec tree for ``q`` (``q._planned()`` keeps one per conf,
    which the collects run)."""
    from spark_rapids_tpu_torch.overrides.overrides import TpuOverrides

    return TpuOverrides.apply(q.plan, q.session.conf, q.session.device)[0]


class _Replay:
    """A leaf that yields batches already on the card."""

    children = []

    def __init__(self, batches, output):
        self.batches = batches
        self.output = output
        self.device = batches[0].device if batches else None

    def execute_columnar(self):
        yield from self.batches


def _timed_run(node):
    """(seconds, batches) of running ``node`` to its end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = list(node.execute_columnar())
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _replay_leaf(parent, i: int):
    """Run ``parent.children[i]`` alone, then put a leaf that replays its
    output batches in its place: -> (seconds, batches)."""
    secs, batches = _timed_run(parent.children[i])
    parent.children[i] = _Replay(batches, parent.children[i].output)
    return secs, batches


def qa_breakdown(q):
    """Where a qa collect spends its time, operator by operator: each runs
    alone on its input batches, already on the card from the operator
    below (the same plan as the collect).  The join's time holds the
    date_dim scan, filter and broadcast."""
    topn = fresh_plan(q)
    agg = topn.children[0]
    join = agg.children[0]
    t_scan, _ = _replay_leaf(join, 0)
    t_join, _ = _replay_leaf(agg, 0)
    t_agg, _ = _replay_leaf(topn, 0)
    t_topn, _ = _timed_run(topn)
    log(f"qa breakdown: store_sales scan {t_scan:.4f} s, join "
        f"{t_join:.4f} s, aggregate {t_agg:.4f} s, top-N {t_topn:.4f} s")


def run_qa_memory(ss, dd, want, device):
    """qa from memory (``LocalTableScan``) over bench.py's seven columns."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    msch, _, dsch = qa_schemas(T)
    s = S.TpuSession({}, device=device)

    def frame(arrays, sch):
        return S.DataFrame(LocalTableScan(
            [HostColumn.from_numpy(arrays[f.name], f.dataType)
             for f in sch.fields], sch), s)

    q = qa_query(frame(ss, msch), frame(dd, dsch), S)
    check_qa_plan(q)
    t0 = time.perf_counter()
    got = q.collect()
    secs = time.perf_counter() - t0
    if got != want:
        fail("qa in memory differs from the reference")
    log(f"qa in memory: {len(got)} rows == integer numpy reference "
        f"({secs:.3f} s with the upload)")


def write_returns_files(sr, out_dir: str, device):
    """store_returns as ``N_FILES`` snappy files by the port's writer."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.io.parquet_encode import write_parquet_device

    _, rsch = qb_schemas(T)
    n = len(sr["ticket"])
    bounds = np.linspace(0, n, N_FILES + 1).astype(np.int64)
    paths = []
    for i in range(N_FILES):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        cols = [HostColumn.from_numpy(sr[f.name][lo:hi], f.dataType)
                for f in rsch.fields]
        path = os.path.join(out_dir, f"store_returns-{i:02d}.parquet")
        write_parquet_device(path, rsch, cols, hi - lo, device=device)
        paths.append(path)
    return paths


def run_qb(ss_paths, sr_paths, want, n: int, device):
    """qb from Parquet: the plan after the first collect must be the
    adaptive join decided ``shuffled``; both collects exact."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    ssch, rsch = qb_schemas(T)
    s = S.TpuSession(QA_CONF, device=device)
    q = qb_query(s.read.schema(ssch).parquet(*ss_paths),
                 s.read.schema(rsch).parquet(*sr_paths), S)
    out = timed_collects(
        q, lambda rows: None if sorted(rows) == want else
        f"{sorted(rows)[:3]}... != {want[:3]}...", "qb parquet", n)
    check_plan(q, QB_PLAN, "qb")
    log("qb plan after the collects:\n" + q.explain())
    return out


def qb_breakdown(q):
    """Where a qb collect spends its time, operator by operator, each on
    its input batches already on the card: the store_sales and
    store_returns scans, the adaptive join (its build side and the
    probes), the aggregate; then the join's probe search at qb's shapes
    (one store_sales batch against the whole build side), and the build
    side alone (its sort, run ends and rank tables)."""
    import torch

    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch

    agg = fresh_plan(q)
    join = agg.children[0]
    left_ex, right_ex = join.shuffled.children
    t_ss, ss_batches = _replay_leaf(left_ex, 0)
    t_sr, sr_batches = _replay_leaf(right_ex, 0)
    t_join, batches = _timed_run(join)
    agg.children[0] = _Replay(batches, join.output)
    t_agg, _ = _timed_run(agg)
    sh = join.shuffled
    build_batch = ColumnarBatch.concat(sr_batches)
    probe = ss_batches[0]
    build_ms = _cuda_time_ms(
        lambda: sh._prepare_build(build_batch, sh.right_keys), 5, warmup=1)
    build = sh._prepare_build(build_batch, sh.right_keys)
    probe_ms = _cuda_time_ms(lambda: sh._probe_counts(build, probe), 5,
                             warmup=1)
    torch.cuda.synchronize()
    log(f"qb breakdown: store_sales scan {t_ss:.4f} s, store_returns scan "
        f"{t_sr:.4f} s, join {t_join:.4f} s ({join.decision}), aggregate "
        f"{t_agg:.4f} s; build side (sort, run ends, rank tables) "
        f"{build_ms:.3f} ms over {build_batch.num_rows} rows; probe search "
        f"{probe_ms:.3f} ms a batch of {probe.num_rows} rows "
        f"({len(ss_batches)} batches)")


def run_qc(ss_paths, want, n: int, device):
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    _, rsch, _ = qa_schemas(T)
    s = S.TpuSession(QA_CONF, device=device)
    q = qc_query(s.read.schema(rsch).parquet(*ss_paths), S)
    check_plan(q, QC_PLAN, "qc")
    log("qc plan:\n" + q.explain())
    return timed_collects(
        q, lambda rows: None if qc_rows(rows) == want else
        f"{len(rows)} rows differ from the reference", "qc parquet", n)


def qc_breakdown(q):
    """Where a qc collect spends its time, operator by operator, each on
    its input batches already on the card."""
    filt = fresh_plan(q)
    win = filt.children[0]
    agg = win.children[0]
    t_scan, _ = _replay_leaf(agg, 0)
    t_agg, _ = _replay_leaf(win, 0)
    t_win, _ = _replay_leaf(filt, 0)
    t_filt, _ = _timed_run(filt)
    log(f"qc breakdown: store_sales scan {t_scan:.4f} s, aggregate "
        f"{t_agg:.4f} s, window {t_win:.4f} s, filter {t_filt:.4f} s")


def _spill_line(fw) -> str:
    m = fw.metrics()
    return (f"spillToHostCount={m['spillToHostCount']} "
            f"spillToHostBytes={m['spillToHostBytes']} "
            f"spillToDiskCount={m['spillToDiskCount']} "
            f"device_used_peak={m['deviceUsedPeakBytes']} "
            f"pool={fw.pool_bytes}")


def _ooc_collects(q, check, label: str, n: int, smi: str,
                  warm: bool = True):
    """Two collects of ``q`` (one without ``warm``), each held by
    ``check``; the counts (K1 launches, perfcounters, peak memory) set to
    0 just before the timed last one and read after it.  The spill
    framework is the one the last collect built."""
    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.memory.spill import peek_spill_framework
    from spark_rapids_tpu_torch.pallas import decode

    bad = check(q.collect()) if warm else None
    if bad:
        fail(f"{label}, first run: {bad}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode.unpack_launches = 0
    snap = PC.snapshot()
    t0 = time.perf_counter()
    rows = q.collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = decode.unpack_launches
    d = PC.since(snap)
    peak = torch.cuda.max_memory_allocated()
    bad = check(rows)
    if bad:
        fail(f"{label}, second run: {bad}")
    fw = peek_spill_framework()
    log(f"{label}: {len(rows)} rows == numpy reference; {n} rows in "
        f"{secs:.3f} s = {n / secs:.0f} rows/s [{smi}]")
    log(f"{label} spill: {_spill_line(fw)}; max_memory_allocated={peak} "
        f"[{smi}]")
    log(f"{label} counters: exchange_host_blocks={d['exchange_host_blocks']} "
        f"exchange_host_block_bytes={d['exchange_host_block_bytes']} "
        f"exchange_partition_ns={d['exchange_partition_ns']} "
        f"exchange_spill_ns={d['exchange_spill_ns']} "
        f"host_syncs={d['host_syncs']} bytes_h2d={d['bytes_h2d']} "
        f"bytes_d2h={d['bytes_d2h']} unpack_launches={launches} [{smi}]")
    return {"seconds": secs, "launches": launches, "delta": d,
            "metrics": fw.metrics(), "query": q}


def run_ooc(n: int, pool: int, device, smi: str, label: str,
            warm: bool = True):
    """Phase 12: bench's rung3_ooc from memory at ``n`` fact rows under
    ``pool``: the plan must be the reference's, with the fact exchange
    sized past 16 partitions; both collects (the timed one alone
    without ``warm``) equal ``cpu_ooc``; host blocks must have crossed
    the exchange's host boundary."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch.config import (SHUFFLE_COMPRESSION_CODEC,
                                               TpuConf)
    from spark_rapids_tpu_torch.shuffle.serializer import resolved_codec

    t0 = time.perf_counter()
    fact, dim = make_ooc(n)
    want = ooc_reference(fact, dim)
    flat = sum(a.nbytes for a in fact.values())
    log(f"{label} data: {n} fact rows, {flat} flat bytes = "
        f"{flat / pool:.1f}x the {pool}-byte pool; generated with the numpy "
        f"reference in {time.perf_counter() - t0:.1f} s")
    conf = ooc_conf(pool, n)
    s = S.TpuSession(conf, device=device)
    q = ooc_query(*ooc_frames(S, s, fact, dim), S)
    plan = ooc_plan(pool, n)
    check_plan(q, plan, label)
    parts = int(re.search(r"hashpartitioning\(k, (\d+)\)", plan[3])[1])
    if parts <= 16:
        fail(f"{label}: the fact exchange was sized to {parts} partitions")
    log(f"{label} plan:\n" + q.explain())
    codec = resolved_codec(TpuConf(conf).get(SHUFFLE_COMPRESSION_CODEC))
    log(f"{label} host-boundary codec: {codec}")
    del fact
    out = _ooc_collects(q, lambda rows: None if ooc_rows(rows) == want
                        else f"{ooc_rows(rows)} != {want}", label, n, smi,
                        warm)
    if out["delta"]["exchange_host_blocks"] <= 0:
        fail(f"{label}: no exchange slice crossed to the host")
    out.update(parts=parts, codec=codec)
    return out


def run_ooc_qb(ss_paths, sr_paths, want, n: int, pool: int, device,
               smi: str):
    """Phase 13: bench qb from phase 10's files under the capped pool; the
    built store_returns side is over the batch goal, so the join must
    sub-partition both sides; both collects exact."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    ssch, rsch = qb_schemas(T)
    s = S.TpuSession(ooc_qb_conf(pool), device=device)
    q = qb_query(s.read.schema(ssch).parquet(*ss_paths),
                 s.read.schema(rsch).parquet(*sr_paths), S)
    goal = ooc_qb_conf(pool)["spark.rapids.sql.batchSizeBytes"]
    check_plan(q, ooc_qb_plan(goal), "qb out of core")
    out = _ooc_collects(q, lambda rows: None if sorted(rows) == want else
                        f"{sorted(rows)[:3]}... != {want[:3]}...",
                        "qb out of core", n, smi)
    join = q._planned().children[0]
    if not join.sub_partitions:
        fail("qb out of core: the join did not sub-partition")
    if out["launches"] <= 0:
        fail("the qb out-of-core run launched K1 no time")
    log(f"qb out of core: the join sub-partitioned both sides into "
        f"{join.sub_partitions} buckets; K1 launches "
        f"{out['launches']} [{smi}]")
    out["buckets"] = join.sub_partitions
    return out


def _rung3_runs(fn, check, label: str, n: int, smi: str, runs: int = 2):
    """``runs`` calls of ``fn`` (a collect), each held by ``check``; the
    counts (perfcounters, K1 launches, peak memory) set to 0 just before
    each and read just after.  Prints seconds, rows/s, counters, spills
    and peak memory of each; returns the last call's."""
    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.memory.spill import peek_spill_framework
    from spark_rapids_tpu_torch.pallas import decode

    for i in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode.unpack_launches = 0
        PC.reset_peaks()
        snap = PC.snapshot()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        d = PC.since(snap)
        peaks = PC.peaks()
        launches = decode.unpack_launches
        peak = torch.cuda.max_memory_allocated()
        bad = check(got)
        if bad:
            fail(f"{label}, run {i + 1}: {bad}")
        fw = peek_spill_framework()
        log(f"{label} run {i + 1}: exact; {n} rows in {secs:.3f} s = "
            f"{n / secs:.0f} rows/s [{smi}]")
        log(f"{label} run {i + 1} counters: host_syncs={d['host_syncs']} "
            f"bytes_h2d={d['bytes_h2d']} bytes_d2h={d['bytes_d2h']} "
            f"ooc_sort_runs={d['ooc_sort_runs']} "
            f"ooc_sort_merge_windows={d['ooc_sort_merge_windows']} "
            f"ooc_sort_merge_upload_bytes="
            f"{d['ooc_sort_merge_upload_bytes']} "
            f"ooc_sort_merge_window_upload_bytes(max)="
            f"{peaks['ooc_sort_merge_window_upload_bytes']} "
            f"unpack_launches={launches} [{smi}]")
        log(f"{label} run {i + 1} spill: {_spill_line(fw)}; "
            f"max_memory_allocated={peak} [{smi}]")
    return {"seconds": secs, "delta": d, "peaks": peaks,
            "metrics": fw.metrics(), "launches": launches}


def run_rung3(n: int, device, smi: str, label: str, count_runs: int = 2):
    """Phase 14: bench's rung3 from memory at ``n`` rows under bench's
    conf (the 64 MiB pool floor): both plans the reference's; the
    aggregate twice, exact against numpy; the sort's count twice, equal
    to ``n`` (``count_runs`` times); the sorted frame collected as host
    columns, its amt numpy's
    sort and its rows the input's.  Every counted run must reach the
    kernels it needs: none (K1 stays at 0 launches)."""
    import spark_rapids_tpu_torch.session as S

    t0 = time.perf_counter()
    d = make_rung3(n)
    want = rung3_reference(d)
    s = S.TpuSession(rung3_conf(n), device=device)
    agg, srt = rung3_frames(S, s, d)
    flat = n * RUNG3_SORT_ROW_BYTES
    log(f"{label} data: {n} rows, sort input {flat} flat bytes = "
        f"{flat / (64 << 20):.2f}x the 64 MiB pool; generated with the "
        f"numpy reference in {time.perf_counter() - t0:.1f} s")
    check_plan(agg, RUNG3_AGG_PLAN, f"{label} aggregate")
    check_plan(rung3_count_query(srt), RUNG3_SORT_PLAN, f"{label} sort")
    log(f"{label} aggregate plan:\n" + agg.explain())
    out = {"agg": _rung3_runs(
        agg.collect_host, lambda h: None if rung3_rows(h) == want
        else "rows differ from the numpy reference", f"{label} aggregate",
        n, smi)}
    out["count"] = _rung3_runs(
        srt.count, lambda c: None if c == n else f"count {c} != {n}",
        f"{label} sort count", n, smi, runs=count_runs)
    out["sorted"] = _rung3_runs(
        srt.collect_host, lambda h: rung3_sort_check(h, d),
        f"{label} sorted collect", n, smi, runs=1)
    dc = out["count"]["delta"]
    runs = dc["ooc_sort_runs"]
    windows = dc["ooc_sort_merge_windows"]
    up = dc["ooc_sort_merge_upload_bytes"]
    if windows <= 1:
        fail(f"{label}: the sort merged in {windows} windows")
    # a window reads at most ooc_chunk_rows rows of each run: a window
    # that brought a whole run back (tens of MB at SF10) moves more
    sort_exec = fresh_plan(rung3_count_query(srt)).children[0]
    chunk_rows = sort_exec.ooc_chunk_rows
    cap = runs * chunk_rows * RUNG3_SORT_ROW_BYTES
    most = {k: out[k]["peaks"]["ooc_sort_merge_window_upload_bytes"]
            for k in ("count", "sorted")}
    for k, m in most.items():
        if m > cap:
            fail(f"{label}: a merge window of the {k} run moved {m} bytes,"
                 f" more than {runs} runs x {chunk_rows} rows x "
                 f"{RUNG3_SORT_ROW_BYTES} B = {cap}")
    log(f"{label} merge: {runs} runs, {windows} windows, {up} bytes "
        f"uploaded ({up / windows:.0f} a window on average; the most in "
        f"one window {most['count']} (count run), {most['sorted']} "
        f"(sorted collect), against {cap} = {runs} runs x {chunk_rows} "
        f"rows), host_syncs {dc['host_syncs']} [{smi}]")
    out["launches"] = sum(out[k]["launches"] for k in ("agg", "count"))
    return out


def _dist_collect(q, want, label: str, hook=None):
    """One collect of ``q`` held to ``want``, timed, with the perfcounters
    and K1's launches set to 0 just before it and read after it, and
    ``hook`` as the exchange's ship hook during it."""
    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.distributed import client as DC
    from spark_rapids_tpu_torch.pallas import decode

    torch.cuda.synchronize()
    decode.unpack_launches = 0
    snap = PC.snapshot()
    DC.TEST_SHIP_HOOK = hook
    try:
        t0 = time.perf_counter()
        rows = q.collect()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        DC.TEST_SHIP_HOOK = None
    d = PC.since(snap)
    if ooc_rows(rows) != want:
        fail(f"{label}: {ooc_rows(rows)} != {want}")
    return secs, d, decode.unpack_launches


def _dist_counters(d) -> str:
    return " ".join(f"{k}={d[k]}" for k in (
        "dist_blocks_shipped", "dist_block_bytes", "worker_lost",
        "partitions_replayed", "worker_heartbeat_misses", "fetch_hedges",
        "hedges_won", "bytes_d2h", "bytes_h2d", "host_syncs"))


def check_worker_contexts(procs, label: str):
    """Only the engine process may hold a CUDA context: no worker pid among
    ``nvidia-smi``'s compute apps, at most one app (the engine; a pid
    namespace may show it under another number), and no CUDA or torch
    library mapped into a worker process."""
    apps = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.split()
    pids = {w: p.pid for w, p in procs.items() if p.poll() is None}
    log(f"{label}: compute apps {apps}, engine pid {os.getpid()}, live "
        f"workers {pids}")
    if any(str(pid) in apps for pid in pids.values()) or len(apps) > 1:
        fail(f"{label}: a process besides the engine holds the card: "
             f"{apps}")
    for w, pid in pids.items():
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        if "libcuda" in maps or "libtorch" in maps:
            fail(f"{label}: worker {w} mapped CUDA or torch")


def run_dist(n: int, device, smi: str, label: str, ab: bool):
    """Phase 15: bench's rung4_dist at ``n`` fact rows, as bench runs it:
    a coordinator in this process, two worker processes with stores of
    ``dist_worker_mem(n)`` bytes, the plan's hash exchanges kept (16
    partitions each), and ``bench0`` SIGKILLed at the 5th shipped block
    inside the timed collect, whose rows must equal ``cpu_dist`` with a
    worker lost and partitions replayed.  Then healthy collects on the
    survivor: with ``ab`` the trace A/B (the min of 2 collects with trace
    propagation on and off) and the hedge A/B (3 interleaved rounds of
    hedging on and off, none of the collects with it off hedging), else
    one collect.  Every run is exact, and in every healthy collect no
    worker is lost and at most ``fetch_hedges`` hedges win."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import distributed as D
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.resilience.breaker import reset_breaker

    t0 = time.perf_counter()
    fact, dim = make_dist(n)
    want = dist_reference(fact, dim)
    mem = dist_worker_mem(n)
    conf = dist_conf(n)
    log(f"{label} data: {n} fact rows "
        f"({sum(a.nbytes for a in fact.values())} flat bytes), worker "
        f"stores {mem} bytes; generated with the numpy reference in "
        f"{time.perf_counter() - t0:.1f} s")
    # each run starts as bench's process does, with no breaker history:
    # the run before lost bench0, whose id would join QUARANTINED
    reset_breaker()
    D.reset_coordinator()
    coord = D.get_coordinator(TpuConf(conf))
    procs = {}
    try:
        t0 = time.perf_counter()
        procs = {w: D.spawn_local_worker(coord, w, mem_bytes=mem)
                 for w in DIST_WORKERS}
        if not coord.wait_for_workers(len(procs), timeout_s=DIST_JOIN_S):
            fail(f"{label}: the workers did not join in {DIST_JOIN_S} s")
        log(f"{label}: {len(procs)} workers joined in "
            f"{time.perf_counter() - t0:.2f} s")
        q = ooc_query(*ooc_frames(S, S.TpuSession(conf, device=device),
                                  fact, dim), S)
        check_plan(q, DIST_PLAN, label)
        log(f"{label} plan:\n" + q.explain())
        state = {"n": 0}

        def kill_bench0(exch, pid, seq):
            state["n"] += 1
            if state["n"] == DIST_KILL_AT \
                    and procs["bench0"].poll() is None:
                procs["bench0"].kill()

        secs, d, launches = _dist_collect(q, want, label, kill_bench0)
        if procs["bench0"].poll() is None:
            fail(f"{label}: bench0 was never killed")
        if d["worker_lost"] < 1 or d["partitions_replayed"] < 1:
            fail(f"{label}: the kill was not recovered: "
                 f"{_dist_counters(d)}")
        if d["dist_blocks_shipped"] <= 0:
            fail(f"{label}: no block was shipped to a worker")
        log(f"{label}: {len(want)} groups == cpu_dist with bench0 killed "
            f"at the {DIST_KILL_AT}th shipped block; {n} rows in "
            f"{secs:.3f} s = {n / secs:.0f} rows/s [{smi}]")
        log(f"{label} counters: {_dist_counters(d)} store ratio "
            f"{d['dist_block_bytes'] / mem:.1f}x unpack_launches="
            f"{launches} [{smi}]")
        out = {"seconds": secs, "delta": d, "launches": launches,
               "query": q, "coord": coord}
        healthy = []
        if ab:
            prior = coord.trace_enabled
            walls = {True: [], False: []}
            for mode in (True, True, False, False):
                coord.trace_enabled = mode
                walls[mode].append(_dist_collect(q, want, label))
            coord.trace_enabled = prior
            on, off = (min(x[0] for x in walls[m]) for m in (True, False))
            healthy += walls[True] + walls[False]
            log(f"{label} trace A/B: on {on:.4f} s, off {off:.4f} s, "
                f"traceOverheadPct {(on - off) * 100 / off:+.2f} [{smi}]")
            prior = coord.hedge_enabled
            walls = {True: [], False: []}
            for _ in range(3):
                for mode in (True, False):
                    coord.hedge_enabled = mode
                    walls[mode].append(_dist_collect(q, want, label))
            coord.hedge_enabled = prior
            on, off = (min(x[0] for x in walls[m]) for m in (True, False))
            healthy += walls[True] + walls[False]
            for _, dh, _ in walls[False]:
                if dh["fetch_hedges"]:
                    fail(f"{label}: a collect with hedging off hedged: "
                         f"{_dist_counters(dh)}")
            log(f"{label} hedge A/B: on {on:.4f} s, off {off:.4f} s, "
                f"hedgeOverheadPct {(on - off) * 100 / off:+.2f} [{smi}]")
        else:
            healthy.append(_dist_collect(q, want, label))
            secs_h, d_h, _ = healthy[-1]
            log(f"{label} healthy: {n} rows in {secs_h:.3f} s = "
                f"{n / secs_h:.0f} rows/s; {_dist_counters(d_h)} [{smi}]")
        # a hedge may win in a healthy collect: the soft deadline is the
        # reference's, max(softDeadlineMinMs, factor x the worker's EWMA),
        # and one slow fetch on a busy host crosses it; the collect stays
        # exact either way
        for _, dh, _ in healthy:
            if dh["hedges_won"] > dh["fetch_hedges"] or dh["worker_lost"] \
                    or dh["dist_blocks_shipped"] <= 0:
                fail(f"{label}: a healthy collect: {_dist_counters(dh)}")
        log(f"{label}: {len(healthy)} healthy collects exact, no worker "
            f"lost; fetch_hedges/hedges_won "
            + " ".join(f"{dh['fetch_hedges']}/{dh['hedges_won']}"
                       for _, dh, _ in healthy))
        check_worker_contexts(procs, label)
        out["healthy"] = healthy
        return out
    finally:
        stop_dist_workers(procs.values())
        D.reset_coordinator()


def stop_dist_workers(procs):
    """SIGKILL and reap worker processes, then remove the spill
    directories they could not remove themselves (those of dead pids in
    the temp directory, ``distributed/worker.py::reap_stale_spill_dirs``),
    so a run leaves no spilled block behind."""
    from spark_rapids_tpu_torch.distributed.worker import \
        reap_stale_spill_dirs

    for p in procs:
        p.kill()
        p.wait(timeout=10)
    reap_stale_spill_dirs()


# ---------------------------------------------------------------------------
# bench rung5_recovery: the query journal on the hot path, and a query
# killed at its first stage commit and resumed (bench.py:1681-1830)
# ---------------------------------------------------------------------------

REC_SEED = 31                      # bench.py's rung5_recovery seed
REC_BENCH_ROWS = 200_000           # bench.py's BENCH_REC_ROWS default
REC_REPEATS = 3                    # bench's min-of-repeats
# the recovery classes of a journaled query (lifecycle/journal.py)
COMPLETED, RESUMABLE, ABANDONED = "completed", "resumable", "abandoned"
REC_PLAN = ["TpuHashAggregate(Complete) keys=[g] aggs=[sum(v) AS sv]",
            "  TpuShuffledSymmetricHashJoinExec Inner [k=k]",
            "    TpuCoalesceBatches TargetSize(1073741824)",
            "      TpuShuffleExchange hashpartitioning(k, 8)",
            "        <scan>",
            "    TpuCoalesceBatches TargetSize(1073741824)",
            "      TpuShuffleExchange hashpartitioning(k, 8)",
            "        <scan>"]


def rec_conf(root: str, rec_on: bool, checkpointing: bool = False) -> dict:
    """bench.py's rung5_recovery conf: the journal under ``root`` when
    ``rec_on``; ``checkpointing`` keeps real 8-partition exchanges on one
    device (no coalesce, no broadcast, no adaptive execution), so stage
    boundaries materialize and commit."""
    c = {"spark.rapids.sql.enabled": True}
    if rec_on:
        c.update({"spark.rapids.tpu.recovery.enabled": True,
                  "spark.rapids.tpu.recovery.dir": root})
    if checkpointing:
        c.update({"spark.rapids.tpu.shuffle.singleDeviceCoalesce": False,
                  "spark.sql.shuffle.partitions": 8,
                  "spark.sql.autoBroadcastJoinThreshold": "-1",
                  "spark.sql.adaptive.enabled": False})
    return c


class _Die(BaseException):
    """A driver's death inside the process: a BaseException, so the commit
    path's ``except Exception`` cannot swallow it, as nothing swallows a
    SIGKILL."""


def checkpoint_bytes(root: str) -> int:
    """Bytes of the stage checkpoint files under the recovery dir
    ``root``."""
    total = 0
    for dirpath, _dirs, files in os.walk(os.path.join(root, "checkpoints")):
        total += sum(os.path.getsize(os.path.join(dirpath, f))
                     for f in files)
    return total


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_rung5(n: int, device, smi: str, label: str) -> dict:
    """Phase 16: bench's rung5_recovery from memory at ``n`` fact rows.
    (a) The journal's cost on the hot path: the min of ``REC_REPEATS``
    collects with recovery off against the min with it on, each after a
    warm-up (printed, not held).  (b) Under the checkpointing conf: a cold
    collect; a collect killed by a ``BaseException`` from the journal's
    record hook at the first ``ckpt`` record, its end record suppressed as
    a killed process writes none; the journal closed (the restart); the
    resumed collect, which must serve at least one stage.  Every collect
    exact against numpy; the plan the reference's; no leak after the kill
    (journal lines aside) or after the resume; the recovery dir empty
    after the purge."""
    import shutil
    import tempfile

    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.lifecycle import journal as JM
    from spark_rapids_tpu_torch.lifecycle import leak_report_all
    from spark_rapids_tpu_torch.memory.spill import peek_spill_framework
    from spark_rapids_tpu_torch.pallas import decode

    t0 = time.perf_counter()
    fact, dim = make_dist(n, REC_SEED)
    want = dist_reference(fact, dim)
    log(f"{label} data: {n} fact rows "
        f"({sum(a.nbytes for a in fact.values())} flat bytes); generated "
        f"with the numpy reference in {time.perf_counter() - t0:.1f} s")
    root = tempfile.mkdtemp(prefix="srt_rung5_")

    def build(conf):
        return ooc_query(*ooc_frames(S, S.TpuSession(conf, device=device),
                                     fact, dim), S)

    def timed(conf, what: str) -> float:
        _sync(device)
        t = time.perf_counter()
        rows = build(conf).collect()
        _sync(device)
        secs = time.perf_counter() - t
        if ooc_rows(rows) != want:
            fail(f"{label} {what}: {ooc_rows(rows)} != {want}")
        return secs

    decode.unpack_launches = 0
    try:
        # (a) the journal on the hot path
        timed(rec_conf(root, False), "warm-up, recovery off")
        off = min(timed(rec_conf(root, False), "recovery off")
                  for _ in range(REC_REPEATS))
        timed(rec_conf(root, True), "warm-up, recovery on")
        snap = PC.snapshot()
        on = min(timed(rec_conf(root, True), "recovery on")
                 for _ in range(REC_REPEATS))
        d_ab = PC.since(snap)
        log(f"{label} journal A/B: off {off:.4f} s, on {on:.4f} s, "
            f"journalOverheadPct {(on - off) * 100 / off:+.2f}, "
            f"journal_records_written "
            f"{d_ab['journal_records_written']} over {REC_REPEATS} "
            f"collects [{smi}]")
        # (b) cold, killed at the first stage commit, resumed
        ck = rec_conf(root, True, checkpointing=True)
        check_plan(build(ck), REC_PLAN, label)
        on_disk = []

        def measure(kind, _n):
            if kind == "ckpt":
                on_disk.append(checkpoint_bytes(root))

        JM.TEST_RECORD_HOOK = measure
        try:
            cold = timed(ck, "cold")
        finally:
            JM.TEST_RECORD_HOOK = None
        state = {"n": 0}

        def die(kind, _n):
            if kind == "ckpt":
                state["n"] += 1
                if state["n"] == 1:
                    raise _Die()

        orig_end = JM.journal_end
        JM.TEST_RECORD_HOOK = die
        JM.journal_end = lambda *a, **k: None
        died = False
        t = time.perf_counter()
        try:
            try:
                build(ck).collect()
            except _Die:
                died = True
        finally:
            JM.TEST_RECORD_HOOK = None
            JM.journal_end = orig_end
        killed = time.perf_counter() - t
        if not died:
            fail(f"{label}: the kill at the first stage commit never fired")
        kept = checkpoint_bytes(root)
        left = [ln for ln in leak_report_all() if "recovery" not in ln]
        if left:
            fail(f"{label}: the killed collect leaked: {left[:3]}")
        JM.reset_journal()                 # the restart
        snap = PC.snapshot()
        resume = timed(ck, "resumed")
        d = PC.since(snap)
        classes = JM.recovery_report()
        if d["stages_recovered"] < 1 or d["queries_resumed"] < 1:
            fail(f"{label}: the resume served no stage: stages_recovered="
                 f"{d['stages_recovered']} queries_resumed="
                 f"{d['queries_resumed']}")
        if RESUMABLE not in classes.values():
            fail(f"{label}: no query classified resumable: {classes}")
        leaks = leak_report_all() + peek_spill_framework().leak_report(
            include_persistent=True)
        if leaks:
            fail(f"{label}: leaks after the resume: {leaks[:3]}")
        log(f"{label}: cold {cold:.4f} s ({len(on_disk)} stage commits, "
            f"{on_disk[-1] if on_disk else 0} checkpoint bytes on disk at "
            f"the last), killed at the first commit after {killed:.4f} s "
            f"({kept} checkpoint bytes kept), resumed {resume:.4f} s = "
            f"{resume / cold:.3f} of cold; stages_recovered="
            f"{d['stages_recovered']} queries_resumed="
            f"{d['queries_resumed']} journal_recovery_discards="
            f"{d['journal_recovery_discards']} classification {classes}; "
            f"spill leak report empty [{smi}]")
        JM.reset_journal(purge=True)
        left = os.listdir(root)
        if left:
            fail(f"{label}: the recovery dir kept {left} after the purge")
        log(f"{label}: recovery dir empty after the purge; "
            f"unpack_launches={decode.unpack_launches}")
        return {"cold": cold, "killed": killed, "resume": resume,
                "off": off, "on": on, "delta": d,
                "launches": decode.unpack_launches}
    finally:
        JM.TEST_RECORD_HOOK = None
        JM.reset_journal(purge=True)
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the driver killed mid-query and restarted, its workers re-attaching
# (tools/run_stress.py::run_driver_kill, :1460)
# ---------------------------------------------------------------------------

DK_SEED = 7                        # run_stress.py's --driver-kill seed
DK_DIM = 500
DK_GROUPS = 13
DK_WORKERS = ("dk0", "dk1")
DK_WORKER_MEM = 32 << 20           # run_stress.py's worker store
DK_REATTACH_MS = 120_000
DK_BENCH_ROWS = 200_000
DK_KILLS = ("plan:1", "ship:6", "ckpt:1")


def make_driver_kill(n: int, seed: int = DK_SEED):
    """run_stress.py's driver-kill tables (``_driver_kill_query``): a fact
    of ``n`` rows on a 500-row dimension of 13 groups, from ``seed``."""
    rng = np.random.default_rng(seed)
    fact = {"k": rng.integers(0, DK_DIM, n).astype(np.int32),
            "v": rng.integers(-100, 100, n)}
    dk = np.arange(DK_DIM, dtype=np.int32)
    return fact, {"k": dk, "g": (dk % DK_GROUPS).astype(np.int32)}


def driver_kill_conf(root: str, n: int) -> dict:
    """run_stress.py's ``_driver_kill_conf`` (the distributed tier and the
    journal on, no broadcast, no adaptive execution, a 64 KiB batch goal,
    4,000-row reader batches, fast liveness).  Past bench's size the
    batching is ``dist_conf``'s (a 256 KiB goal, 16 reader batches), so
    an SF10 fact ships as rung4_dist's does.  The reference's
    ``compile.cacheDir`` has no counterpart: the port caches no
    programs."""
    c = {"spark.rapids.sql.enabled": True,
         "spark.rapids.tpu.distributed.enabled": True,
         "spark.rapids.tpu.recovery.enabled": True,
         "spark.rapids.tpu.recovery.dir": root,
         "spark.sql.autoBroadcastJoinThreshold": "-1",
         "spark.sql.adaptive.enabled": False,
         "spark.rapids.sql.batchSizeBytes": 64 << 10,
         "spark.rapids.sql.reader.batchSizeRows": 4000,
         "spark.rapids.tpu.distributed.heartbeatMs": 100,
         "spark.rapids.tpu.distributed.workerLostMs": 600,
         "spark.rapids.tpu.distributed.opTimeoutMs": 1000}
    if n > DK_BENCH_ROWS:
        d = dist_conf(n)
        for k in ("spark.rapids.sql.batchSizeBytes",
                  "spark.rapids.sql.reader.batchSizeRows"):
            c[k] = d[k]
    return c


def driver_incarnation(args) -> int:
    """One driver incarnation (``--driver-incarnation``, internal): build
    the coordinator (which publishes the endpoint file under the recovery
    dir), wait for the workers, arm the kill point, collect the
    driver-kill query and write the result JSON (rows, counters, the
    replay's classification, blocks left on the workers, leaks).  The
    kill points: ``plan:N`` and ``ckpt:N`` SIGKILL this process after the
    N-th journal record of that kind, ``ship:N`` after the N-th shipped
    block, ``none`` runs to the end (run_stress.py's
    ``driver_kill_child``)."""
    import signal

    import torch

    if not (args.recovery_dir and args.result_out):
        print("driver incarnation: --recovery-dir and --result-out are "
              "required", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("driver incarnation: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import distributed as D
    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.config import TpuConf
    from spark_rapids_tpu_torch.distributed import client as DC
    from spark_rapids_tpu_torch.lifecycle import journal as JM
    from spark_rapids_tpu_torch.lifecycle import leak_report_all
    from spark_rapids_tpu_torch.pallas import decode

    conf = driver_kill_conf(args.recovery_dir, args.rows)
    coord = D.get_coordinator(TpuConf(conf))
    if not coord.wait_for_workers(args.workers, timeout_s=60):
        print("driver incarnation: the workers never attached",
              file=sys.stderr)
        return 3
    kind_at, _, n_s = (args.kill_at or "none").partition(":")
    n_at = int(n_s) if n_s else 1
    state = {"n": 0}

    def count_and_kill():
        state["n"] += 1
        if state["n"] >= n_at:
            os.kill(os.getpid(), signal.SIGKILL)

    if kind_at == "ship":
        DC.TEST_SHIP_HOOK = lambda exch, pid, seq: count_and_kill()
    elif kind_at not in ("", "none"):
        JM.TEST_RECORD_HOOK = (lambda kind, n: count_and_kill()
                               if kind == kind_at else None)
    fact, dim = make_driver_kill(args.rows)
    q = ooc_query(*ooc_frames(S, S.TpuSession(conf, device=args.device),
                              fact, dim), S)
    t0 = time.perf_counter()
    rows = q.collect()
    _sync(args.device)
    wall = time.perf_counter() - t0
    d = PC.snapshot()
    stranded = 0
    for wid in sorted(coord.worker_inventory()):
        stranded += int(coord.worker_stats(wid).get("blocks", 0))
    out = {"rows": sorted([int(g), int(sv)] for g, sv in rows),
           "wall_s": wall,
           "counters": {k: d[k] for k in (
               "journal_records_written", "stages_recovered",
               "queries_resumed", "journal_recovery_discards",
               "recovery_leases_expired", "workers_joined",
               "dist_blocks_shipped", "partitions_replayed")},
           "unpack_launches": decode.unpack_launches,
           "recovery": JM.recovery_report(),
           "stranded_blocks": stranded,
           "leaks": leak_report_all()}
    tmp = args.result_out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, args.result_out)
    D.reset_coordinator()
    return 0


def run_driver_kill(rounds, device: str, smi: str, label: str) -> list:
    """Phase 17: for each (kill point, fact rows, worker store bytes) of
    ``rounds``, driver incarnation 1 (``--driver-incarnation`` in a child
    process on ``device``) is SIGKILLed at the kill point, and
    incarnation 2 then runs the same query to its end over the same
    recovery dir and the same two worker processes, which outlive both
    (``--reattach-ms``, ``--endpoint-file``).  Incarnation 1 must die by
    SIGKILL and incarnation 2 exit 0; its rows must equal numpy; every
    journaled query must be classified, the crashed one not completed;
    after a ``ckpt`` kill at least one stage must be served and the
    crashed query classified resumable; no block may be left on a
    worker, nothing may leak, and no worker may map CUDA.  A round whose
    store size differs from the last starts new workers."""
    import shutil
    import signal
    import tempfile

    root = tempfile.mkdtemp(prefix="srt_driver_kill_")
    endpoint = os.path.join(root, "coordinator.endpoint")
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    worker_env = dict(env, CUDA_VISIBLE_DEVICES="")
    workers, mem_now, results = {}, None, []

    def spawn_driver(tag: str, kill_at: str, n: int):
        cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"),
               "--driver-incarnation", "--recovery-dir", root,
               "--kill-at", kill_at, "--workers", str(len(DK_WORKERS)),
               "--rows", str(n), "--device", device,
               "--result-out", os.path.join(root, f"result_{tag}.json")]
        log_f = open(os.path.join(root, f"driver_{tag}.log"), "wb")
        try:
            return subprocess.Popen(cmd, env=env, stdout=log_f,
                                    stderr=log_f)
        finally:
            log_f.close()

    def log_tail(tag: str) -> str:
        try:
            with open(os.path.join(root, f"driver_{tag}.log"), "rb") as f:
                return f.read()[-1500:].decode("utf-8", "replace")
        except OSError:
            return "<no log>"

    def spawn_worker(wid: str, mem: int):
        cmd = [sys.executable, "-m",
               "spark_rapids_tpu_torch.distributed.worker",
               "--worker-id", wid, "--mem-bytes", str(mem),
               "--heartbeat-ms", "100", "--op-timeout-ms", "1000",
               "--endpoint-file", endpoint,
               "--reattach-ms", str(DK_REATTACH_MS)]
        return subprocess.Popen(cmd, env=worker_env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

    try:
        for i, (kp, n, mem) in enumerate(rounds):
            tag = f"{label} round {i} ({kp}, {n} rows)"
            t0 = time.perf_counter()
            fact, dim = make_driver_kill(n)
            want = dist_reference(fact, dim, DK_GROUPS)
            if mem != mem_now:
                stop_dist_workers(workers.values())
                workers = {}
                try:
                    os.unlink(endpoint)
                except OSError:
                    pass
            p1 = spawn_driver(f"{i}a", kp, n)
            if not workers:
                # the workers dial the endpoint the first incarnation's
                # coordinator publishes
                deadline = time.monotonic() + 120
                while not os.path.exists(endpoint) \
                        and time.monotonic() < deadline \
                        and p1.poll() is None:
                    time.sleep(0.05)
                if not os.path.exists(endpoint):
                    p1.kill()
                    p1.wait(timeout=30)
                    fail(f"{tag}: no coordinator endpoint appeared "
                         f"[{log_tail(f'{i}a')}]")
                workers = {w: spawn_worker(w, mem) for w in DK_WORKERS}
                mem_now = mem
            rc1 = p1.wait(timeout=600)
            t1 = time.perf_counter() - t0
            if rc1 != -signal.SIGKILL:
                fail(f"{tag}: incarnation 1 exited {rc1}, not by SIGKILL "
                     f"[{log_tail(f'{i}a')}]")
            t0 = time.perf_counter()
            p2 = spawn_driver(f"{i}b", "none", n)
            rc2 = p2.wait(timeout=600)
            t2 = time.perf_counter() - t0
            if rc2 != 0:
                fail(f"{tag}: incarnation 2 exited {rc2} "
                     f"[{log_tail(f'{i}b')}]")
            with open(os.path.join(root, f"result_{i}b.json")) as f:
                res = json.load(f)
            got = {g: sv for g, sv in res["rows"] if sv}
            if got != want:
                fail(f"{tag}: incarnation 2's rows {got} != {want}")
            classes = res["recovery"]
            if any(c not in (COMPLETED, RESUMABLE, ABANDONED)
                   for c in classes.values()):
                fail(f"{tag}: an unclassified journaled query: {classes}")
            crashed = [c for c in classes.values() if c != COMPLETED]
            if not crashed:
                fail(f"{tag}: the killed query was classified completed: "
                     f"{classes}")
            ctr = res["counters"]
            if kp.startswith("ckpt") and (ctr["stages_recovered"] < 1
                                          or RESUMABLE not in crashed):
                fail(f"{tag}: the committed stage was not served: "
                     f"stages_recovered={ctr['stages_recovered']} "
                     f"{classes}")
            if res["stranded_blocks"]:
                fail(f"{tag}: {res['stranded_blocks']} blocks left on the "
                     f"workers")
            if res["leaks"]:
                fail(f"{tag}: leaks: {res['leaks'][:3]}")
            if device == "cuda":
                check_worker_contexts(workers, tag)
            log(f"{tag}: incarnation 1 SIGKILLed after {t1:.2f} s; "
                f"incarnation 2 exact in {t2:.2f} s (collect "
                f"{res['wall_s']:.3f} s), classification {classes}, "
                f"stages_recovered={ctr['stages_recovered']} "
                f"queries_resumed={ctr['queries_resumed']} "
                f"journal_recovery_discards="
                f"{ctr['journal_recovery_discards']} dist_blocks_shipped="
                f"{ctr['dist_blocks_shipped']} stranded_blocks=0 "
                f"unpack_launches={res['unpack_launches']} [{smi}]")
            results.append({"kill": kp, "rows": n, "result": res,
                            "incarnation1_s": t1, "incarnation2_s": t2})
        return results
    finally:
        stop_dist_workers(workers.values())
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# bench q6_parquet_hot: Q6 over the hot-table cache (bench.py:1911-1937)
# ---------------------------------------------------------------------------

HOT_MAX_BYTES = 4 << 30            # over SF10 Q6's decoded columns
HOT_BENCH_ROWS = 1_000_000         # bench.py's q6_parquet rows
HOT_BENCH_FILES = 4


def hot_conf(max_bytes=None) -> dict:
    c = {"spark.rapids.sql.format.parquet.decode.device": True,
         "spark.rapids.sql.format.parquet.reader.type": "PERFILE",
         "spark.rapids.tpu.scan.hotTableCache.enabled": True}
    if max_bytes is not None:
        c["spark.rapids.tpu.scan.hotTableCache.maxBytes"] = max_bytes
    return c


def _hot_collect(q, want, label: str, device):
    """One collect held to ``want``: (seconds, perfcounter delta, K1
    launches), the counts set to 0 just before it."""
    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.pallas import decode

    _sync(device)
    decode.unpack_launches = 0
    snap = PC.snapshot()
    t0 = time.perf_counter()
    rows = q.collect()
    _sync(device)
    secs = time.perf_counter() - t0
    d = PC.since(snap)
    if rows != [(want,)]:
        fail(f"{label}: {rows} != {want}")
    return secs, d, decode.unpack_launches


def _hot_line(d, launches) -> str:
    return " ".join([f"unpack_launches={launches}"] + [
        f"{k}={d[k]}" for k in ("hot_cache_hits", "hot_cache_misses",
                                "hot_cache_evictions", "bytes_h2d",
                                "host_syncs")])


def run_q6_hot(paths, want, label: str, device, smi: str,
               max_bytes=None, miss=None) -> dict:
    """Two collects of Q6 over ``paths`` with the hot-table cache on (its
    bound ``max_bytes``, the default when None), each exact; then
    ``session.close()``.  Returns both collects' (seconds, delta,
    launches).  With ``miss`` (phase 4's launches and bytes_h2d) the
    first must miss with them and the second hit with no K1 launch and
    no bytes_h2d."""
    from spark_rapids_tpu_torch.session import TpuSession

    _, rsch = schemas()
    s = TpuSession(hot_conf(max_bytes), device=device)
    q = q6_query(s.read.schema(rsch).parquet(*paths))
    first = _hot_collect(q, want, f"{label} collect 1", device)
    second = _hot_collect(q, want, f"{label} collect 2", device)
    leaks = s.close()
    if leaks:
        fail(f"{label}: session.close() reported leaks: {leaks[:3]}")
    for i, (secs, d, launches) in enumerate((first, second), 1):
        log(f"{label} collect {i}: {secs:.4f} s, {_hot_line(d, launches)} "
            f"[{smi}]")
    if miss is not None:
        launches0, h2d0 = miss
        s1, d1, l1 = first
        s2, d2, l2 = second
        if d1["hot_cache_misses"] != 1 or d1["hot_cache_hits"] \
                or l1 != launches0 or d1["bytes_h2d"] != h2d0:
            fail(f"{label}: the first collect did not miss as phase 4 "
                 f"reads: {_hot_line(d1, l1)}, want unpack_launches="
                 f"{launches0} bytes_h2d={h2d0}")
        if d2["hot_cache_hits"] != 1 or l2 or d2["bytes_h2d"]:
            fail(f"{label}: the second collect did not hit: "
                 f"{_hot_line(d2, l2)}")
    return {"first": first, "second": second}


def run_hot(paths, q6, n: int, seed: int, device,
            smi: str):
    """Phase 18: bench's q6_parquet_hot.  Phase 4's SF10 files under a
    4 GiB bound (a miss with phase 4's launches and bytes_h2d, then a
    hit); the same files under the 1 GiB default (over the bound, never
    cached: no hit in two collects); bench's own cell, 1,000,000 rows as
    4 snappy files under the default bound (a hit on the repeat).  After
    each ``session.close()`` the spill framework holds no handle,
    persistent ones included."""
    from spark_rapids_tpu_torch.memory.spill import peek_spill_framework

    def no_handles(what):
        fw = peek_spill_framework()
        left = fw.leak_report(include_persistent=True) if fw else []
        if left:
            fail(f"q6_parquet_hot {what}: handles left after close(): "
                 f"{left[:3]}")

    big = run_q6_hot(paths, q6["want"], "q6_parquet_hot SF10", device,
                     smi, HOT_MAX_BYTES,
                     miss=(q6["launches"], q6["delta"]["bytes_h2d"]))
    no_handles("SF10")
    hit_s = big["second"][0]
    log(f"q6_parquet_hot SF10: the hit {hit_s:.4f} s against phase 4's "
        f"collect {q6['seconds']:.4f} s and this miss "
        f"{big['first'][0]:.4f} s; {n} rows = {n / hit_s:.0f} rows/s "
        f"[{smi}]")
    dflt = run_q6_hot(paths, q6["want"], "q6_parquet_hot SF10 default "
                      "bound", device, smi)
    if any(r[1]["hot_cache_hits"] for r in dflt.values()):
        fail("q6_parquet_hot: an SF10 scan over the 1 GiB default bound "
             "was cached")
    no_handles("default bound")
    li = lineitem_q6(HOT_BENCH_ROWS, HOT_BENCH_ROWS / (SF10_ROWS / 10),
                     seed)
    out_dir = os.path.join(HERE, "spark_rapids_tpu_torch", "build",
                           f"q6_hot_{HOT_BENCH_ROWS}_seed{seed}")
    small = write_files(li, HOT_BENCH_ROWS, out_dir, device,
                        HOT_BENCH_FILES)
    cell = run_q6_hot(small, q6_reference(li), "q6_parquet_hot bench "
                      "cell", device, smi)
    if cell["second"][1]["hot_cache_hits"] != 1 \
            or cell["second"][2] or cell["second"][1]["bytes_h2d"]:
        fail("q6_parquet_hot bench cell: the repeat did not hit: "
             + _hot_line(cell["second"][1], cell["second"][2]))
    no_handles("bench cell")
    return {"big": big, "default": dflt, "cell": cell}


# ---------------------------------------------------------------------------
# TPC-H Q12 (spec 2.4.12): string columns end to end, from Parquet at SF10
# ---------------------------------------------------------------------------

Q12_ORDERS_SF10 = 15_000_000       # TPC-H SF10 orders
Q12_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                  "5-LOW")
Q12_SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
Q12_VALUES = {"o_orderpriority": Q12_PRIORITIES,
              "l_shipmode": Q12_SHIPMODES}
Q12_MODES = ("MAIL", "SHIP")
Q12_RECEIPT = (8766, 9131)         # [1994-01-01, 1995-01-01) in epoch days
Q12_CONF = dict(QA_CONF)           # device decode on, default reader type


def make_q12(n_orders: int, seed: int):
    """orders and lineitem as TPC-H 4.2.3 draws the columns Q12 reads, from
    ``seed``: sparse order keys (the first 8 of each 32), o_orderdate
    uniform in 1992-01-01..1998-08-02, O_ORDERPRIORITY uniform over its 5
    values, 1-7 lines an order, L_SHIPMODE uniform over its 7 values,
    L_SHIPDATE = orderdate + [1, 121], L_COMMITDATE = orderdate + [30, 90],
    L_RECEIPTDATE = shipdate + [1, 30].  Strings are held as codes into
    ``Q12_PRIORITIES`` and ``Q12_SHIPMODES``."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_orders, dtype=np.int64)
    okey = (i // 8) * 32 + (i % 8) + 1
    odate = rng.integers(8035, 10440 + 1, n_orders).astype(np.int32)
    prio = rng.integers(0, len(Q12_PRIORITIES), n_orders).astype(np.int8)
    lines = rng.integers(1, 8, n_orders)
    n = int(lines.sum())
    od = np.repeat(odate, lines)
    ship = od + rng.integers(1, 122, n).astype(np.int32)
    orders = {"o_orderkey": okey, "o_orderdate": odate,
              "o_orderpriority": prio}
    lineitem = {"l_orderkey": np.repeat(okey, lines),
                "l_shipdate": ship,
                "l_commitdate": od + rng.integers(30, 91, n).astype(np.int32),
                "l_receiptdate": ship + rng.integers(1, 31, n).astype(
                    np.int32),
                "l_shipmode": rng.integers(0, len(Q12_SHIPMODES), n).astype(
                    np.int8),
                "order_row": np.repeat(i, lines)}
    return orders, lineitem


def q12_schemas(T):
    """(orders as written, lineitem as written, orders as Q12 reads it,
    lineitem as Q12 reads it) in the package whose ``types`` is ``T``;
    TPC-H's columns are NOT NULL."""
    def sch(fields):
        return T.StructType([T.StructField(nm, t, False)
                             for nm, t in fields])
    o = [("o_orderkey", T.LONG), ("o_orderdate", T.DATE),
         ("o_orderpriority", T.STRING)]
    li = [("l_orderkey", T.LONG), ("l_shipdate", T.DATE),
          ("l_commitdate", T.DATE), ("l_receiptdate", T.DATE),
          ("l_shipmode", T.STRING)]
    return sch(o), sch(li), sch([o[0], o[2]]), sch(li)


def q12_strings(codes, values):
    """Codes -> an object array of the values' strings."""
    return np.asarray(values, dtype=object)[codes]


def q12_query(orders, lineitem, mod):
    """TPC-H Q12 over two DataFrames of the package whose session module
    is ``mod``: lineitem filtered (the IN, the date order and the receipt
    year) joined to orders on the order key as the build side, the two
    CASE WHEN sums grouped by l_shipmode, ordered by it."""
    import datetime as dt

    pkg = mod.__name__.rsplit(".", 1)[0]
    CaseWhen = importlib.import_module(pkg + ".expr.conditional").CaseWhen
    col, lit = mod.col, mod.lit
    li = (lineitem
          .filter(col("l_shipmode").isin(*Q12_MODES)
                  & (col("l_commitdate") < col("l_receiptdate"))
                  & (col("l_shipdate") < col("l_commitdate"))
                  & (col("l_receiptdate") >= lit(dt.date(1994, 1, 1)))
                  & (col("l_receiptdate") < lit(dt.date(1995, 1, 1))))
          .select(col("l_orderkey").alias("orderkey"), "l_shipmode"))
    o = orders.select(col("o_orderkey").alias("orderkey"), "o_orderpriority")
    pr = col("o_orderpriority")
    high = pr.eq("1-URGENT") | pr.eq("2-HIGH")
    low = ~pr.eq("1-URGENT") & ~pr.eq("2-HIGH")
    return (o.join(li, "orderkey")
            .group_by("l_shipmode")
            .agg(mod.sum_(CaseWhen([(high, lit(1))], lit(0)),
                          "high_line_count"),
                 mod.sum_(CaseWhen([(low, lit(1))], lit(0)),
                          "low_line_count"))
            .order_by("l_shipmode"))


def q12_selected(lineitem):
    """The lines Q12's filter keeps (bool mask)."""
    modes = [Q12_SHIPMODES.index(m) for m in Q12_MODES]
    rec = lineitem["l_receiptdate"]
    com = lineitem["l_commitdate"]
    return (np.isin(lineitem["l_shipmode"], modes) & (com < rec)
            & (lineitem["l_shipdate"] < com)
            & (rec >= Q12_RECEIPT[0]) & (rec < Q12_RECEIPT[1]))


def q12_reference(orders, lineitem):
    """Q12 in numpy: the lines that pass the filter, each with its order's
    priority, counted by ship mode (the join is the generator's
    line -> order row map)."""
    mode = lineitem["l_shipmode"]
    sel = q12_selected(lineitem)
    high = orders["o_orderpriority"][lineitem["order_row"][sel]] <= 1
    m = mode[sel]
    out = []
    for name in sorted(Q12_MODES):
        k = m == Q12_SHIPMODES.index(name)
        if k.any():
            out.append((name, int((high & k).sum()), int((~high & k).sum())))
    return out


def q12_string_column(codes, values):
    """A NOT NULL string ``HostColumn`` of the port whose rows are
    ``values[codes]``, built by one gather from the values' matrix."""
    from spark_rapids_tpu_torch.columnar.column import HostColumn

    table = HostColumn.strings(list(values), np.ones(len(values), np.bool_))
    return HostColumn(table.dtype, np.ones(len(codes), np.bool_),
                      chars=table.chars[codes], lengths=table.lengths[codes])


def q12_host_columns(table, schema, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a Q12 table as the port's host columns of
    ``schema`` (strings from their codes)."""
    from spark_rapids_tpu_torch.columnar.column import HostColumn

    return [q12_string_column(table[f.name][lo:hi], Q12_VALUES[f.name])
            if f.name in Q12_VALUES else
            HostColumn.from_numpy(table[f.name][lo:hi], f.dataType)
            for f in schema.fields]


def encode_dict_strings(f, codes, values, device, codec: int):
    """A NOT NULL string column chunk, rows ``values[codes]``, dictionary-
    encoded as parquet-mr writes one (the port's writer has no dictionary
    for strings): a PLAIN dictionary page of the values that occur, in
    first-seen order, then RLE_DICTIONARY data pages of
    ``SPARK_PAGE_VALUES`` values, each one bit-packed run of the indices
    at the dictionary's bit width.  -> (pages bytes, ``ChunkMeta``) for
    ``parquet_encode.write_chunks``."""
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    from spark_rapids_tpu_torch.io.parquet_native import (ENC_PLAIN, ENC_RLE,
                                                          ENC_RLE_DICT,
                                                          PAGE_DATA,
                                                          PAGE_DICT,
                                                          TYPE_BYTE_ARRAY)
    from spark_rapids_tpu_torch.perfcounters import sync_get, to_device

    n = len(codes)
    present, first = np.unique(codes, return_index=True)
    order = present[np.argsort(first)]
    rank = np.zeros(len(values), np.int64)
    rank[order] = np.arange(len(order))
    table = q12_string_column(np.asarray(order), values)
    payload = PE.plain_byte_array(table.chars, table.lengths)
    cdict = PE._compress(codec, payload)
    dict_header = PE._page_header(PAGE_DICT, len(payload), len(cdict),
                                  len(order), ENC_PLAIN)
    pages = bytearray(dict_header) + cdict
    meta = PE.ChunkMeta()
    meta.name, meta.phys, meta.n, meta.codec = f.name, TYPE_BYTE_ARRAY, n, \
        codec
    meta.encodings = [ENC_RLE_DICT, ENC_PLAIN, ENC_RLE]
    meta.dict_off = True
    meta.data_off = len(pages)
    usize = len(dict_header) + len(payload)
    bw = max((len(order) - 1).bit_length(), 1)
    (packed,) = sync_get(PE.device_bitpack(to_device(rank[codes], device),
                                           bw))
    packed = packed.tobytes()
    for lo in range(0, n, SPARK_PAGE_VALUES):
        cnt = min(SPARK_PAGE_VALUES, n - lo)
        body = bytes([bw]) + PE._hybrid_bitpacked(
            packed[lo * bw // 8: -(-(lo + cnt) * bw // 8)], cnt, bw)
        cbody = PE._compress(codec, body)
        header = PE._page_header(PAGE_DATA, len(body), len(cbody), cnt,
                                 ENC_RLE_DICT)
        pages += header
        pages += cbody
        usize += len(header) + len(body)
    meta.usize, meta.csize = usize, len(pages)
    return bytes(pages), meta


def write_q12_files(orders, lineitem, out_dir: str, device,
                    n_files: int = N_FILES):
    """orders and lineitem as ``n_files`` snappy files each, one row group
    a file: numeric columns dictionary-encoded by the port's writer,
    strings by ``encode_dict_strings``; and orders' first file again with
    PLAIN strings, by the port's writer.  -> (orders paths, lineitem
    paths, the PLAIN file's path)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    from spark_rapids_tpu_torch.io.parquet_native import CODEC_SNAPPY

    ow, lw, _, _ = q12_schemas(T)
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for name, table, sch in (("orders", orders, ow),
                             ("lineitem", lineitem, lw)):
        n = len(table[sch.fields[0].name])
        bounds = np.linspace(0, n, n_files + 1).astype(np.int64)
        paths[name] = []
        for i in range(n_files):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            chunks = [encode_dict_strings(
                f, table[f.name][lo:hi], Q12_VALUES[f.name], device,
                CODEC_SNAPPY)
                if isinstance(f.dataType, T.StringType) else
                PE.encode_column(f, c, hi - lo, CODEC_SNAPPY, True, device)
                for f, c in zip(sch.fields, q12_host_columns(
                    table, sch, lo, hi))]
            path = os.path.join(out_dir, f"{name}-{i:02d}.parquet")
            PE.write_chunks(path, sch, chunks, hi - lo)
            paths[name].append(path)
    hi = int(np.linspace(0, len(orders["o_orderkey"]), n_files + 1)[1])
    plain = os.path.join(out_dir, "orders-plain.parquet")
    PE.write_parquet_device(plain, ow, q12_host_columns(orders, ow, 0, hi),
                            hi, device=device)
    return paths["orders"], paths["lineitem"], plain


def dict_chunks(paths, schema) -> int:
    """The column chunks of ``schema``'s columns in ``paths`` that hold
    dictionary pages: the K1 launches a scan of them makes."""
    from spark_rapids_tpu_torch.io.parquet_native import (ENC_PLAIN_DICT,
                                                          ENC_RLE_DICT,
                                                          read_column_pages,
                                                          read_footer)

    count = 0
    want = set(schema.field_names())
    for p in paths:
        with open(p, "rb") as fh:
            data = fh.read()
        groups, _ = read_footer(data)
        for g in groups:
            for info in g.columns:
                if info.name in want and any(
                        pg.encoding in (ENC_PLAIN_DICT, ENC_RLE_DICT)
                        for pg in read_column_pages(data, info,
                                                    g.num_rows).pages):
                    count += 1
    return count


def check_string_k1(paths, schema_of, device, smi: str, label: str):
    """``check_k1_tables`` on the string columns of ``schema_of(path)``."""
    from spark_rapids_tpu_torch import types as T

    return check_k1_tables(paths, lambda p: T.StructType(
        [f for f in schema_of(p).fields
         if isinstance(f.dataType, T.StringType)]), device, smi, label)


def check_k1_tables(paths, schema_of, device, smi: str, label: str):
    """K1 on the run tables the scan builds for the columns of ``paths``
    that ``schema_of(path)`` names (the file's schema as the query reads
    it): each file's fields are read as the scan reads them (compressed
    transfer on), the inputs of every K1 launch are kept, and each is run
    again through the kernel and its plain version.  -> (the largest
    difference, the index widths seen); a difference fails."""
    import torch

    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io import parquet_device as PD
    from spark_rapids_tpu_torch.pallas import decode
    from spark_rapids_tpu_torch.perfcounters import to_device

    calls = []
    real = PD.expand_table_dev

    def keep(buf, base, table, total):
        calls.append((buf, base, table, total))
        return real(buf, base, table, total)

    max_err = 0
    seen = set()
    for path in paths:
        sch = schema_of(path)
        widths = sorted({page.index_bit_width for name, page in
                         main_path_pages(path) if name in sch.field_names()
                         and page.index_bit_width})
        seen.update(widths)
        PD.expand_table_dev = keep
        try:
            PD.read_parquet_device(path, sch, device)
        finally:
            PD.expand_table_dev = real
        rows = values = 0
        for buf, base, table, total in calls:
            tab = to_device(table, device)
            got = decode.unpack_runs(buf, base, tab, total)
            want = decode.unpack_runs_plain(buf, base, tab, total)
            max_err = max(max_err, int((got.to(torch.int64)
                                        - want.to(torch.int64))
                                       .abs().max()) if total else 0)
            rows += len(table)
            values += total
        log(f"K1 on {os.path.basename(path)}'s index tables "
            f"({sch.field_names()}, widths {widths}): {len(calls)} "
            f"launches, {rows} run rows, {values} values; max_abs_err "
            f"{max_err} against the plain version; {smi}")
        calls.clear()
    if max_err:
        fail(f"K1 differs from its plain version on {label}'s index tables "
             f"(max_abs_err {max_err})")
    return max_err, sorted(seen)


def check_q12_k1(paths, device, smi: str) -> int:
    """K1 on the run tables phase 19's scan builds for the string columns
    of ``paths`` (one orders and one lineitem file), against its plain
    version."""
    from spark_rapids_tpu_torch import types as T

    _, _, ro, rl = q12_schemas(T)
    return check_string_k1(
        paths, lambda p: ro if "orders" in os.path.basename(p) else rl,
        device, smi, "Q12")[0]


def q12_plan(threshold: int = 10 << 20, decided: str = "shuffled",
             goal: int = 1 << 30, broadcast_planned: bool = False):
    """The reference's plan for Q12 after a collect (the reference's
    explain on the CPU, scans as ``<scan>``, the bytes as ``<bytes>``):
    the join broadcast at planning when the lineitem files are within
    ``threshold``, else adaptive, decided ``decided`` at run time."""
    head = [
        "TpuSort [l_shipmode ASC]",
        "  TpuHashAggregate(Complete) keys=[l_shipmode] aggs=[sum(CASE WHEN "
        "((o_orderpriority = '1-URGENT') OR (o_orderpriority = '2-HIGH')) "
        "THEN 1 ELSE 0 END) AS high_line_count, sum(CASE WHEN ((NOT "
        "(o_orderpriority = '1-URGENT')) AND (NOT (o_orderpriority = "
        "'2-HIGH'))) THEN 1 ELSE 0 END) AS low_line_count]"]
    orders = ["TpuProject [o_orderkey AS orderkey, o_orderpriority]",
              "  <scan>"]
    lines = ["TpuStageExec[FilterProject]", "  <scan>"]
    if broadcast_planned:
        return head + ["    TpuBroadcastHashJoinExec Inner "
                       "[orderkey=orderkey]"] + [
            "      " + ln for ln in orders] + [
            "      TpuBroadcastExchangeExec"] + [
            "        " + ln for ln in lines]
    reader = f"TpuAdaptiveShuffleReader(target={goal}B small=4194304B)"
    side = ["      " + reader, "        TpuShuffleExchange SinglePartition"]
    return head + [
        f"    TpuAdaptiveJoin(threshold={threshold})[TpuShuffledSymmetricHash"
        f"JoinExec Inner [orderkey=orderkey]] decided={decided}(<bytes>)"
    ] + side + ["          " + ln for ln in orders] + side + [
        "          " + ln for ln in lines]


def q12_build_bytes(lineitem) -> int:
    """The adaptive join's measured build side at Q12: 22 bytes a filtered
    line (the key and its validity, l_shipmode's 8 chars, length and
    validity), as the reference counts a row."""
    return 22 * int(q12_selected(lineitem).sum())


def _q12_collects(q, want, label: str, n: int, smi: str, check=None,
                  unit: str = "lineitem rows", warm: bool = True):
    """Two collects of ``q`` (one without ``warm``: the caller ran the
    first), both equal to ``want`` (or held by ``check``: rows -> None or
    a complaint); the counts (K1 launches, perfcounters, peak memory) set
    to 0 just before the timed last one and read just after it."""
    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.pallas import decode

    if check is None:
        def check(rows):
            return None if rows == want else f"{rows} != {want}"
    bad = check(q.collect()) if warm else None
    if bad:
        fail(f"{label}, first run: {bad}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    decode.unpack_launches = 0
    snap = PC.snapshot()
    t0 = time.perf_counter()
    rows = q.collect()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = decode.unpack_launches
    d = PC.since(snap)
    peak = torch.cuda.max_memory_allocated()
    bad = check(rows)
    if bad:
        fail(f"{label}, second run: {bad}")
    shown = rows if len(rows) <= 8 else f"{len(rows)} rows"
    log(f"{label}: {shown} == numpy reference; {n} {unit} in "
        f"{secs:.3f} s = {n / secs:.0f} rows/s [{smi}]")
    log(f"{label} counters: unpack_launches={launches} bytes_h2d="
        f"{d['bytes_h2d']} bytes_d2h={d['bytes_d2h']} host_syncs="
        f"{d['host_syncs']} chunk_decode_fallbacks="
        f"{d['chunk_decode_fallbacks']} exchange_host_blocks="
        f"{d['exchange_host_blocks']} exchange_spill_ns="
        f"{d['exchange_spill_ns']} max_memory_allocated={peak} [{smi}]")
    return {"seconds": secs, "launches": launches, "delta": d,
            "peak": peak, "query": q}


def run_q12(o_paths, l_paths, want, build_bytes: int, n: int, device,
            smi: str):
    """Phase 19: Q12 from the Parquet files, collected twice; the plan
    the reference's (its adaptive join decided by ``build_bytes``
    against the default threshold), K1 launched once per dictionary
    column chunk in the timed collect."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.config import (AUTO_BROADCAST_JOIN_THRESHOLD,
                                               TpuConf)

    _, _, ors, lrs = q12_schemas(T)
    s = S.TpuSession(Q12_CONF, device=device)
    q = q12_query(s.read.schema(ors).parquet(*o_paths),
                  s.read.schema(lrs).parquet(*l_paths), S)
    chunks = dict_chunks(o_paths, ors) + dict_chunks(l_paths, lrs)
    check_default_reader(q.explain().splitlines(), "Q12")
    out = _q12_collects(q, want, "Q12 parquet", n, smi, warm=False)
    threshold = TpuConf(Q12_CONF).get(AUTO_BROADCAST_JOIN_THRESHOLD)
    planned = sum(os.path.getsize(p) for p in l_paths) <= threshold
    decided = "broadcast" if build_bytes <= threshold else "shuffled"
    check_plan(q, q12_plan(threshold, decided,
                           broadcast_planned=planned), "Q12")
    join = "broadcast at planning"
    if not planned:
        join = [ln for ln in q.explain().splitlines()
                if "decided=" in ln][0].split("decided=")[1]
        if join != f"{decided}({build_bytes}B)":
            fail(f"Q12: the adaptive join decided {join}, not {decided} "
                 f"over the {build_bytes} B of the filtered lines")
    if out["launches"] != chunks:
        fail(f"Q12: K1 launched {out['launches']} times, not once for each "
             f"of the {chunks} dictionary column chunks")
    log("Q12 plan after the collects:\n" + q.explain())
    log(f"Q12 parquet: join {join}; K1 launches {out['launches']} == "
        f"{chunks} dictionary chunks [{smi}]")
    return out


def read_q12_plain(path, orders, device, smi: str):
    """The orders file with PLAIN string pages (the host length walk),
    read alone: every o_orderpriority row equal to the generator's."""
    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.io.parquet_device import read_parquet_device

    _, _, ors, _ = q12_schemas(T)
    snap = PC.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = read_parquet_device(path, ors, device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    d = PC.since(snap)
    n = b.num_rows
    want = q12_string_column(orders["o_orderpriority"][:n], Q12_PRIORITIES)
    col = b.columns[1]
    if not (np.array_equal(col.chars[:, :want.width].cpu().numpy(),
                           want.chars)
            and np.array_equal(col.lengths.cpu().numpy(), want.lengths)
            and not col.chars[:, want.width:].any()
            and np.array_equal(b.columns[0].data.cpu().numpy(),
                               orders["o_orderkey"][:n])):
        fail("Q12: the PLAIN-string orders file differs from the generator")
    log(f"Q12 PLAIN strings: {n} orders rows read alone in {secs:.3f} s, "
        f"every row equal; width {col.width}, bytes_h2d={d['bytes_h2d']}, "
        f"chunk_decode_fallbacks={d['chunk_decode_fallbacks']} [{smi}]")


def run_q12_ooc(orders, lineitem, want, pool: int, device, smi: str):
    """Phase 20: Q12 from memory under phase 12's conf (the capped pool, a
    batch goal of an eighth of it, no broadcast, no adaptive execution):
    both sides through sized hash exchanges on the order key, whose
    slices past the queues' device budget cross to the host as TKU2
    frames carrying the string columns; rows exact twice, host blocks
    written, no leak; then the orders exchange's write and read alone."""
    import torch

    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.config import BATCH_SIZE_BYTES
    from spark_rapids_tpu_torch.memory.spill import (get_spill_framework,
                                                     peek_spill_framework)
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan
    from spark_rapids_tpu_torch.shuffle.partition_queues import (
        SpillBackedPartitionQueues, host_boundary_codec, queue_device_budget)

    _, _, ors, lrs = q12_schemas(T)
    n = len(lineitem["l_orderkey"])
    conf = ooc_conf(pool, n)
    s = S.TpuSession(conf, device=device)

    def frame(table, sch):
        return S.DataFrame(LocalTableScan(q12_host_columns(
            table, sch, 0, len(table[sch.fields[0].name])), sch), s)

    q = q12_query(frame(orders, ors), frame(lineitem, lrs), S)
    log("Q12 out of core plan:\n" + q.explain())
    if sum("sized" in ln for ln in q.explain().splitlines()) != 2:
        fail("Q12 out of core: both exchanges must be sized")
    # one collect (about 13 s each), for the time limit
    out = _ooc_collects(q, lambda rows: None if rows == want else
                        f"{rows} != {want}", "Q12 out of core", n, smi,
                        warm=False)
    if out["delta"]["exchange_host_blocks"] <= 0:
        fail("Q12 out of core: no exchange slice crossed to the host")
    fw = peek_spill_framework()
    leaks = fw.leak_report() if fw is not None else []
    leaks += s.close()
    if leaks:
        fail(f"Q12 out of core: leaks {leaks[:3]}")
    # the orders exchange alone: its slices carry o_orderpriority
    get_spill_framework(s.conf, device)
    sort = fresh_plan(q)
    ex = sort.children[0].children[0].children[0].children[0]
    t_scan, batches = _replay_leaf(ex, 0)
    queues = SpillBackedPartitionQueues(
        ex.num_partitions, ex.output, queue_device_budget(s.conf),
        codec=host_boundary_codec(s.conf))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        for pid, sl in ex.partition_slices(b):
            queues.append(pid, sl)
    torch.cuda.synchronize()
    t_write = time.perf_counter() - t0
    del batches
    goal = int(s.conf.get(BATCH_SIZE_BYTES))
    t0 = time.perf_counter()
    rows = sum(c.num_rows for pid in range(ex.num_partitions)
               for c in queues.read_chunks(pid, target_bytes=goal))
    torch.cuda.synchronize()
    t_read = time.perf_counter() - t0
    blocks = queues.host_blocks
    queues.close()
    if blocks <= 0 or rows != len(orders["o_orderkey"]):
        fail(f"Q12 out of core: the orders exchange framed {blocks} host "
             f"blocks and read back {rows} rows")
    log(f"Q12 out of core orders exchange ({ex.num_partitions} partitions,"
        f" o_orderpriority in its frames): project + scan {t_scan:.4f} s, "
        f"write {t_write:.4f} s ({blocks} host blocks), read {t_read:.4f} "
        f"s, {rows} rows [{smi}]")
    return out


# ---------------------------------------------------------------------------
# TPC-H Q4 (spec 2.4.4): EXISTS as a left semi join, from phase 19's files;
# the other join types on its tables
# ---------------------------------------------------------------------------

Q4_QUARTER = (8582, 8674)          # [1993-07-01, 1993-10-01) in epoch days


def q4_schemas(T):
    """(orders as Q4 reads it, lineitem as Q4 reads it) from phase 19's
    files; TPC-H's columns are NOT NULL."""
    def sch(fields):
        return T.StructType([T.StructField(nm, t, False)
                             for nm, t in fields])
    return (sch([("o_orderkey", T.LONG), ("o_orderdate", T.DATE),
                 ("o_orderpriority", T.STRING)]),
            sch([("l_orderkey", T.LONG), ("l_commitdate", T.DATE),
                 ("l_receiptdate", T.DATE)]))


def q4_sides(orders, lineitem, mod):
    """``o_q``: the quarter's orders (``orderkey``, ``o_orderpriority``);
    ``l_q``: the late lines' ``orderkey``."""
    import datetime as dt

    col, lit = mod.col, mod.lit
    o_q = (orders.filter((col("o_orderdate") >= lit(dt.date(1993, 7, 1)))
                         & (col("o_orderdate") < lit(dt.date(1993, 10, 1))))
           .select(col("o_orderkey").alias("orderkey"), "o_orderpriority"))
    l_q = (lineitem.filter(col("l_commitdate") < col("l_receiptdate"))
           .select(col("l_orderkey").alias("orderkey")))
    return o_q, l_q


def q4_query(orders, lineitem, mod, how: str = "left_semi"):
    """TPC-H Q4 over two DataFrames of the package whose session module is
    ``mod``: the quarter's orders that have a late line (EXISTS, a left
    semi join; ``how="left_anti"`` is the NOT EXISTS twin), counted by
    o_orderpriority, ordered by it.  ``how="right"`` or ``"full"`` counts
    the outer join's rows by priority instead (the null group first)."""
    o_q, l_q = q4_sides(orders, lineitem, mod)
    return (o_q.join(l_q, "orderkey", how=how)
            .group_by("o_orderpriority")
            .agg(mod.count_(None, "order_count"))
            .order_by("o_orderpriority"))


def q4_reference(orders, lineitem, how: str = "left_semi"):
    """Q4 (or its twins) in numpy, from the generator's line -> order row
    map: [(priority or None, count)], ordered by priority, nulls first."""
    odate = orders["o_orderdate"]
    quarter = (odate >= Q4_QUARTER[0]) & (odate < Q4_QUARTER[1])
    late = lineitem["l_commitdate"] < lineitem["l_receiptdate"]
    rows = lineitem["order_row"][late]
    has_late = np.zeros(len(odate), np.bool_)
    has_late[rows] = True
    prio = orders["o_orderpriority"]
    k = len(Q12_PRIORITIES)
    if how in ("left_semi", "left_anti"):
        keep = quarter & (has_late if how == "left_semi" else ~has_late)
        counts = np.bincount(prio[keep], minlength=k)
        nulls = 0
    else:
        # one row a late line: its order's priority if the order is in
        # the quarter, else null; a full join adds the quarter's orders
        # without a late line
        in_q = quarter[rows]
        counts = np.bincount(prio[rows[in_q]], minlength=k)
        nulls = int((~in_q).sum())
        if how == "full":
            counts = counts + np.bincount(prio[quarter & ~has_late],
                                          minlength=k)
    out = [(None, nulls)] if nulls else []
    return out + [(Q12_PRIORITIES[i], int(c)) for i, c in enumerate(counts)
                  if c]


def q4_build_bytes(lineitem) -> int:
    """The adaptive join's measured build side at Q4: 9 bytes a late line
    (the key and its validity), as the reference counts a row."""
    return 9 * int((lineitem["l_commitdate"]
                    < lineitem["l_receiptdate"]).sum())


Q4_JOIN_NAMES = {"left_semi": "LeftSemi", "left_anti": "LeftAnti",
                 "right": "RightOuter", "full": "FullOuter"}


def q4_plan(how: str = "left_semi", threshold: int = 10 << 20,
            decided: str = "shuffled", goal: int = 1 << 30,
            broadcast_planned: bool = False):
    """The reference's plan for Q4 (or a twin) after a collect (the
    reference's explain on the CPU, scans as ``<scan>``, the bytes as
    ``<bytes>``): broadcast at planning when the lineitem files are
    within ``threshold``, else adaptive, decided ``decided``."""
    jt = Q4_JOIN_NAMES[how]
    head = ["TpuSort [o_orderpriority ASC]",
            "  TpuHashAggregate(Complete) keys=[o_orderpriority] "
            "aggs=[count_star(*) AS order_count]"]
    orders = ["TpuStageExec[FilterProject]", "  <scan>"]
    lines = ["TpuStageExec[FilterProject]", "  <scan>"]
    if broadcast_planned:
        return head + [f"    TpuBroadcastHashJoinExec {jt} "
                       "[orderkey=orderkey]"] + [
            "      " + ln for ln in orders] + [
            "      TpuBroadcastExchangeExec"] + [
            "        " + ln for ln in lines]
    reader = f"TpuAdaptiveShuffleReader(target={goal}B small=4194304B)"
    side = ["      " + reader, "        TpuShuffleExchange SinglePartition"]
    return head + [
        f"    TpuAdaptiveJoin(threshold={threshold})[TpuShuffledSymmetricHash"
        f"JoinExec {jt} [orderkey=orderkey]] decided={decided}(<bytes>)"
    ] + side + ["          " + ln for ln in orders] + side + [
        "          " + ln for ln in lines]


def _q4_files_query(o_paths, l_paths, how, conf, device):
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    ors, lrs = q4_schemas(T)
    s = S.TpuSession(conf, device=device)
    return q4_query(s.read.schema(ors).parquet(*o_paths),
                    s.read.schema(lrs).parquet(*l_paths), S, how)


def run_q4(o_paths, l_paths, want, build_bytes: int, n: int, device,
           smi: str):
    """Phase 21: Q4 from phase 19's files, collected twice; the plan the
    reference's, its adaptive join deciding ``shuffled`` over the late
    lines' ``build_bytes``; K1 launched once per dictionary column chunk
    of the columns Q4 reads in the timed collect."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.config import (AUTO_BROADCAST_JOIN_THRESHOLD,
                                               TpuConf)

    ors, lrs = q4_schemas(T)
    q = _q4_files_query(o_paths, l_paths, "left_semi", Q12_CONF, device)
    chunks = dict_chunks(o_paths, ors) + dict_chunks(l_paths, lrs)
    check_default_reader(q.explain().splitlines(), "Q4")
    out = _q12_collects(q, want, "Q4 parquet", n, smi, warm=False)
    threshold = TpuConf(Q12_CONF).get(AUTO_BROADCAST_JOIN_THRESHOLD)
    check_plan(q, q4_plan("left_semi", threshold, "shuffled"), "Q4")
    join = [ln for ln in q.explain().splitlines()
            if "decided=" in ln][0].split("decided=")[1]
    if join != f"shuffled({build_bytes}B)":
        fail(f"Q4: the adaptive join decided {join}, not shuffled over the "
             f"{build_bytes} B of the late lines")
    if out["launches"] != chunks:
        fail(f"Q4: K1 launched {out['launches']} times, not once for each "
             f"of the {chunks} dictionary column chunks")
    log("Q4 plan after the collects:\n" + q.explain())
    log(f"Q4 parquet: join {join}; K1 launches {out['launches']} == "
        f"{chunks} dictionary chunks [{smi}]")
    return out


def run_q4_join_types(o_paths, l_paths, orders, lineitem, semi, device,
                      smi: str):
    """Phase 22, from the files: Q4's NOT EXISTS twin (a left anti join),
    semi + anti equal to the quarter's orders per priority; the right and
    full outer joins of the quarter's orders and the late lines, counted
    by priority with the null group; each exact against numpy twice, each
    plan the reference's."""
    out = {}
    for how in ("left_anti", "right", "full"):
        want = q4_reference(orders, lineitem, how)
        q = _q4_files_query(o_paths, l_paths, how, Q12_CONF, device)
        res = _q12_collects(q, want, f"Q4 {how}", len(lineitem["l_orderkey"]),
                            smi)
        check_plan(q, q4_plan(how), f"Q4 {how}")
        out[how] = res
        del res["query"]
    anti = dict(q4_reference(orders, lineitem, "left_anti"))
    odate = orders["o_orderdate"]
    quarter = (odate >= Q4_QUARTER[0]) & (odate < Q4_QUARTER[1])
    per = np.bincount(orders["o_orderpriority"][quarter],
                      minlength=len(Q12_PRIORITIES))
    for i, p in enumerate(Q12_PRIORITIES):
        if dict(semi).get(p, 0) + anti.get(p, 0) != int(per[i]):
            fail(f"Q4: semi + anti of {p} is not the quarter's orders")
    log(f"Q4 join types: anti, right and full outer exact; semi + anti == "
        f"the quarter's {int(quarter.sum())} orders per priority [{smi}]")
    return out


def run_q4_ooc(orders, lineitem, pool: int, device, smi: str):
    """Phase 22, from memory under phase 12's conf (the capped pool, a
    batch goal of an eighth of it, no broadcast, no adaptive execution):
    Q4 and its anti twin, each collected once, exact; the
    built late lines are over the goal, so the join sub-partitions (>= 2
    buckets), and nothing leaks."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.memory.spill import peek_spill_framework
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    ors, lrs = q4_schemas(T)
    n = len(lineitem["l_orderkey"])
    out = {}
    for how in ("left_semi", "left_anti"):
        s = S.TpuSession(ooc_conf(pool, n), device=device)

        def frame(table, sch):
            return S.DataFrame(LocalTableScan(q12_host_columns(
                table, sch, 0, len(table[sch.fields[0].name])), sch), s)

        q = q4_query(frame(orders, ors), frame(lineitem, lrs), S, how)
        want = q4_reference(orders, lineitem, how)
        # one collect each: the sub-partitioned join at SF10 takes about
        # half a minute under this pool
        res = _ooc_collects(q, lambda rows: None if rows == want else
                            f"{rows} != {want}", f"Q4 {how} out of core", n,
                            smi, warm=False)
        join = q._planned().children[0].children[0]
        if not join.sub_partitions or join.sub_partitions < 2:
            fail(f"Q4 {how} out of core: the join did not sub-partition")
        fw = peek_spill_framework()
        leaks = fw.leak_report() if fw is not None else []
        leaks += s.close()
        if leaks:
            fail(f"Q4 {how} out of core: leaks {leaks[:3]}")
        log(f"Q4 {how} out of core: the join sub-partitioned both sides "
            f"into {join.sub_partitions} buckets; spills "
            f"{res['metrics']['spillToHostCount']}; no leak [{smi}]")
        res["buckets"] = join.sub_partitions
        del res["query"]
        out[how] = res
    return out


# ---------------------------------------------------------------------------
# TPC-H Q1 (spec 2.4.1): three avgs over 128-bit sums, a CPU stage with
# strings and decimal products above 18 digits, from Parquet at SF10
# ---------------------------------------------------------------------------

Q1_FLAGS = ("A", "N", "R")
Q1_STATUS = ("F", "O")
Q1_VALUES = {"l_returnflag": Q1_FLAGS, "l_linestatus": Q1_STATUS}
Q1_CURRENT = 9298                  # 1995-06-17, TPC-H's CURRENTDATE
Q1_SHIP_MAX = 10471                # 1998-09-02 = 1998-12-01 - 90 days


def lineitem_q1(n: int, scale: float, seed: int):
    """The columns Q1 reads, by TPC-H 4.2.3, from ``seed``: L_QUANTITY in
    [1, 50], L_EXTENDEDPRICE = quantity x the part's retail price (as
    ``lineitem_q6``), L_DISCOUNT in [0.00, 0.10], L_TAX in [0.00, 0.08]
    (unscaled cents), L_SHIPDATE = orderdate + [1, 121], L_RECEIPTDATE =
    shipdate + [1, 30]; L_RETURNFLAG R or A where the receipt is on or
    before 1995-06-17, else N, and L_LINESTATUS O where the ship date is
    after it, else F (codes into ``Q1_FLAGS`` and ``Q1_STATUS``)."""
    rng = np.random.default_rng(seed)
    quantity = rng.integers(1, 51, n, dtype=np.int64)
    partkey = rng.integers(1, max(int(scale * 200_000), 1) + 1, n,
                           dtype=np.int64)
    retail = (90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000))
    orderdate = rng.integers(8035, 10440 + 1, n, dtype=np.int64)
    ship = (orderdate + rng.integers(1, 122, n)).astype(np.int32)
    receipt = ship + rng.integers(1, 31, n).astype(np.int32)
    flag = np.where(receipt <= Q1_CURRENT,
                    np.where(rng.integers(0, 2, n) == 0, 0, 2), 1)
    return {"l_quantity": quantity * 100,
            "l_extendedprice": quantity * retail,
            "l_discount": rng.integers(0, 11, n, dtype=np.int64),
            "l_tax": rng.integers(0, 9, n, dtype=np.int64),
            "l_shipdate": ship,
            "l_returnflag": flag.astype(np.int8),
            "l_linestatus": (ship > Q1_CURRENT).astype(np.int8)}


def q1_schema(T):
    """lineitem as Q1's files hold it and Q1 reads it: the money columns
    DECIMAL(12,2) (INT64 annotated, as Spark writes them)."""
    money = T.DecimalType(12, 2)
    return T.StructType([T.StructField(nm, t, False) for nm, t in (
        ("l_quantity", money), ("l_extendedprice", money),
        ("l_discount", money), ("l_tax", money), ("l_shipdate", T.DATE),
        ("l_returnflag", T.STRING), ("l_linestatus", T.STRING))])


def q1_query(lineitem, mod):
    """TPC-H Q1 over a DataFrame of the package whose session module is
    ``mod``, its charge and discounted price projected before the
    aggregate: the lines shipped by 1998-09-02, grouped by return flag
    and line status, four sums, three averages and the count, ordered by
    the keys."""
    import datetime as dt

    col, lit = mod.col, mod.lit

    def disc():
        return col("l_extendedprice") * (lit(1) - col("l_discount"))

    li = (lineitem.filter(col("l_shipdate") <= lit(dt.date(1998, 9, 2)))
          .select("l_returnflag", "l_linestatus", "l_quantity",
                  "l_extendedprice", "l_discount",
                  disc().alias("disc_price"),
                  (disc() * (lit(1) + col("l_tax"))).alias("charge")))
    return (li.group_by("l_returnflag", "l_linestatus")
            .agg(mod.sum_("l_quantity", "sum_qty"),
                 mod.sum_("l_extendedprice", "sum_base_price"),
                 mod.sum_("disc_price", "sum_disc_price"),
                 mod.sum_("charge", "sum_charge"),
                 mod.avg_("l_quantity", "avg_qty"),
                 mod.avg_("l_extendedprice", "avg_price"),
                 mod.avg_("l_discount", "avg_disc"),
                 mod.count_(None, "count_order"))
            .order_by("l_returnflag", "l_linestatus"))


def _exact_sum(x) -> int:
    """An int64 array's exact sum (past int64) over 32-bit halves."""
    x = np.asarray(x, np.int64)
    return (int(np.sum(x >> 32, dtype=np.int64)) << 32) \
        + int(np.sum(x & 0xFFFFFFFF, dtype=np.int64))


def _avg_half_up(s: int, n: int, shift: int) -> int:
    """round_half_up(s * 10^shift / n) for an exact integer ``s``."""
    num = abs(s) * 10 ** shift
    q, r = divmod(num, n)
    q += 2 * r >= n
    return -q if s < 0 else q


def q1_reference(li):
    """Q1 in numpy and Python integers: [(flag, status, sum_qty,
    sum_base_price, sum_disc_price, sum_charge, avg_qty, avg_price,
    avg_disc, count)] with the decimals as ``Decimal`` at Spark's result
    scales (sums 2, 2, 4, 6; averages 6, HALF_UP), ordered by the
    keys."""
    keep = li["l_shipdate"] <= Q1_SHIP_MAX
    flag = li["l_returnflag"][keep]
    status = li["l_linestatus"][keep]
    qty = li["l_quantity"][keep]
    ep = li["l_extendedprice"][keep]
    disc = li["l_discount"][keep]
    dp = ep * (100 - disc)                                  # scale 4
    charge = dp * (100 + li["l_tax"][keep])                 # scale 6
    out = []
    for fi, f in enumerate(Q1_FLAGS):
        for si, st in enumerate(Q1_STATUS):
            g = (flag == fi) & (status == si)
            n = int(g.sum())
            if not n:
                continue
            s_qty, s_ep, s_disc = (_exact_sum(c[g]) for c in (qty, ep, disc))
            out.append((f, st, Decimal(s_qty).scaleb(-2),
                        Decimal(s_ep).scaleb(-2),
                        Decimal(_exact_sum(dp[g])).scaleb(-4),
                        Decimal(_exact_sum(charge[g])).scaleb(-6),
                        Decimal(_avg_half_up(s_qty, n, 4)).scaleb(-6),
                        Decimal(_avg_half_up(s_ep, n, 4)).scaleb(-6),
                        Decimal(_avg_half_up(s_disc, n, 4)).scaleb(-6), n))
    return out


def q1_plan():
    """The reference's plan for Q1 (explain on the CPU, the scan as
    ``<scan>``): the sort over the aggregate over the CPU stage (the
    Project, whose charge multiplies a decimal(26,4)), over the device
    filter and scan, with the reference's reason."""
    return [
        "TpuSort [l_returnflag ASC, l_linestatus ASC]",
        "  TpuHashAggregate(Complete) keys=[l_returnflag, l_linestatus] "
        "aggs=[sum(l_quantity) AS sum_qty, sum(l_extendedprice) AS "
        "sum_base_price, sum(disc_price) AS sum_disc_price, sum(charge) AS "
        "sum_charge, avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS "
        "avg_price, avg(l_discount) AS avg_disc, count_star(*) AS "
        "count_order]",
        "    TpuRowToColumnar <- Project [l_returnflag, l_linestatus, "
        "l_quantity, l_extendedprice, l_discount, (l_extendedprice * "
        "(CAST(1 AS decimal(10,0)) - l_discount)) AS disc_price, "
        "((l_extendedprice * (CAST(1 AS decimal(10,0)) - l_discount)) * "
        "(CAST(1 AS decimal(10,0)) + l_tax)) AS charge]",
        "Fallback reasons:",
        "        !Project cannot run on TPU because decimal multiply with an "
        "operand above 18 digits is not supported on TPU (needs 256-bit "
        "intermediates)"]


def write_q1_files(li, out_dir: str, device, n_files: int = N_FILES):
    """lineitem as ``n_files`` snappy files, one row group each: the
    numeric columns dictionary-encoded by the port's writer (the money
    columns INT64 annotated DECIMAL(12,2)), the two strings by
    ``encode_dict_strings`` (index widths 2 and 1)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    from spark_rapids_tpu_torch.io.parquet_native import CODEC_SNAPPY

    sch = q1_schema(T)
    os.makedirs(out_dir, exist_ok=True)
    n = len(li["l_quantity"])
    bounds = np.linspace(0, n, n_files + 1).astype(np.int64)
    paths = []
    for i in range(n_files):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        chunks = [encode_dict_strings(f, li[f.name][lo:hi],
                                      Q1_VALUES[f.name], device, CODEC_SNAPPY)
                  if f.name in Q1_VALUES else
                  PE.encode_column(f, HostColumn.from_numpy(
                      li[f.name][lo:hi], f.dataType), hi - lo, CODEC_SNAPPY,
                      True, device)
                  for f in sch.fields]
        path = os.path.join(out_dir, f"lineitem-q1-{i:02d}.parquet")
        PE.write_chunks(path, sch, chunks, hi - lo)
        paths.append(path)
    return paths


def run_q1(paths, want, n: int, device, smi: str):
    """Phase 23: Q1 from its files, collected once and timed (the profiled
    collect after it is the second), exact; the plan the reference's (the
    Project a CPU stage); K1 once per dictionary column chunk in the timed
    collect."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    sch = q1_schema(T)
    s = S.TpuSession(Q12_CONF, device=device)
    q = q1_query(s.read.schema(sch).parquet(*paths), S)
    chunks = dict_chunks(paths, sch)
    out = _q12_collects(q, want, "Q1 parquet", n, smi, warm=False)
    check_plan(q, q1_plan(), "Q1")
    if out["launches"] != chunks:
        fail(f"Q1: K1 launched {out['launches']} times, not once for each "
             f"of the {chunks} dictionary column chunks")
    log(f"Q1 parquet: K1 launches {out['launches']} == {chunks} dictionary "
        f"chunks [{smi}]")
    return out


# ---------------------------------------------------------------------------
# TPC-H Q11 and Q15 (a scalar subquery as a nested-loop join against a
# one-row broadcast side), and q16_nolike (count(distinct)), from Parquet
# ---------------------------------------------------------------------------

TPCH_NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT",
                "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN",
                "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE",
                "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM",
                "RUSSIA", "UNITED KINGDOM", "UNITED STATES")
TPCH_REGIONS = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                4, 2, 3, 3, 1)
TPCH_BRANDS = tuple(f"Brand#{m}{n}" for m in range(1, 6)
                    for n in range(1, 6))
TPCH_TYPES = tuple(f"{a} {b} {c}"
                   for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE",
                             "ECONOMY", "PROMO")
                   for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                             "BRUSHED")
                   for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
TPCH_VSTR = ("0123456789abcdefghijklmnopqrstuvwxyz"
             "ABCDEFGHIJKLMNOPQRSTUVWXYZ, ")    # 64 characters
Q11_NATION = "GERMANY"             # spec 2.4.11.3's validation parameters
Q15_WINDOW = (9496, 9587)          # [1996-01-01, 1996-04-01) in epoch days
Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)
Q16_BRAND = "Brand#45"


def q11_fraction(scale: float) -> Decimal:
    """FRACTION = 0.0001 / SF, written at 10 decimal places as qgen does
    (0.0000100000 at SF10)."""
    return (Decimal("0.0001") / Decimal(str(scale))).quantize(
        Decimal("0.0000000001"))


def _v_strings(rng, n: int, lo: int, hi: int):
    """``n`` of TPC-H's random v-strings (length uniform in [lo, hi]) as
    an object array of ``str``."""
    chars = np.frombuffer(TPCH_VSTR.encode(), np.uint8)[
        rng.integers(0, len(TPCH_VSTR), (n, hi))]
    lens = rng.integers(lo, hi + 1, n)
    return np.array([bytes(r[:k]).decode() for r, k in zip(chars, lens)],
                    dtype=object)


def make_tpch_parts(scale: float, seed: int):
    """nation, supplier, part and partsupp as TPC-H 4.2.3 draws the columns
    Q11, Q15 and Q16 read, from ``seed``: 25 nations; SF x 10,000
    suppliers (S_NAME ``Supplier#`` and the key in 9 digits, S_ADDRESS a
    v-string of 10-40 characters, S_NATIONKEY uniform in [0, 24], S_PHONE
    its country code 10 + nationkey and three random groups); SF x
    200,000 parts (P_BRAND ``Brand#MN`` with M, N uniform in [1, 5],
    P_TYPE uniform over the 150 syllable triples, P_SIZE uniform in [1,
    50]); four partsupp rows a part, PS_SUPPKEY by the spec's formula,
    PS_AVAILQTY uniform in [1, 9999], PS_SUPPLYCOST uniform in [1.00,
    1000.00] (cents).  Strings are codes into ``values`` (name -> the
    strings); a table whose every row has its own string holds
    ``arange`` codes and the row's string in ``values``."""
    rng = np.random.default_rng(seed)
    n_s = max(int(round(scale * 10_000)), 4)
    n_p = max(int(round(scale * 200_000)), 1)
    skey = np.arange(1, n_s + 1, dtype=np.int64)
    snation = rng.integers(0, 25, n_s).astype(np.int32)
    groups = rng.integers([100, 100, 1000], [1000, 1000, 10000], (n_s, 3))
    supplier = {"s_suppkey": skey, "s_name": np.arange(n_s),
                "s_address": np.arange(n_s), "s_nationkey": snation,
                "s_phone": np.arange(n_s)}
    values = {
        "n_name": TPCH_NATIONS, "p_brand": TPCH_BRANDS, "p_type": TPCH_TYPES,
        "s_name": np.array([f"Supplier#{k:09d}" for k in skey], object),
        "s_address": _v_strings(rng, n_s, 10, 40),
        "s_phone": np.array([f"{10 + c}-{a}-{b}-{d}" for c, (a, b, d)
                             in zip(snation, groups)], object)}
    nation = {"n_nationkey": np.arange(25, dtype=np.int32),
              "n_name": np.arange(25, dtype=np.int8),
              "n_regionkey": np.array(TPCH_REGIONS, np.int32)}
    pkey = np.arange(1, n_p + 1, dtype=np.int64)
    part = {"p_partkey": pkey,
            "p_brand": rng.integers(0, 25, n_p).astype(np.int8),
            "p_type": rng.integers(0, len(TPCH_TYPES), n_p).astype(np.int16),
            "p_size": rng.integers(1, 51, n_p).astype(np.int32)}
    ps_part = np.repeat(pkey, 4)
    i = np.tile(np.arange(4, dtype=np.int64), n_p)
    partsupp = {"ps_partkey": ps_part,
                "ps_suppkey": tpch_suppkey(ps_part, i, n_s),
                "ps_availqty": rng.integers(1, 10_000, 4 * n_p).astype(
                    np.int32),
                "ps_supplycost": rng.integers(100, 100_001, 4 * n_p)}
    return {"nation": nation, "supplier": supplier, "part": part,
            "partsupp": partsupp}, values


def tpch_suppkey(partkey, i, n_s: int):
    """The spec's supplier of a part: (partkey + i * (S/4 + (partkey - 1)
    / S)) mod S + 1 for i in [0, 3], S the supplier count."""
    return (partkey + i * (n_s // 4 + (partkey - 1) // n_s)) % n_s + 1


def lineitem_q15(n: int, scale: float, seed: int):
    """The columns Q15 reads, by TPC-H 4.2.3, from ``seed``: L_PARTKEY
    uniform over the parts, L_SUPPKEY the spec's supplier ``i`` (uniform
    in [0, 3]) of that part, L_EXTENDEDPRICE = quantity x the part's
    retail price (cents), L_DISCOUNT in [0.00, 0.10], L_SHIPDATE =
    orderdate + [1, 121]."""
    rng = np.random.default_rng(seed)
    n_s = max(int(round(scale * 10_000)), 4)
    partkey = rng.integers(1, max(int(round(scale * 200_000)), 1) + 1, n,
                           dtype=np.int64)
    suppkey = tpch_suppkey(partkey, rng.integers(0, 4, n), n_s)
    retail = (90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000))
    quantity = rng.integers(1, 51, n, dtype=np.int64)
    orderdate = rng.integers(8035, 10440 + 1, n).astype(np.int32)
    return {"l_suppkey": suppkey, "l_extendedprice": quantity * retail,
            "l_discount": rng.integers(0, 11, n, dtype=np.int64),
            "l_shipdate": orderdate + rng.integers(1, 122, n).astype(
                np.int32)}


def tpch_schemas(T):
    """The files' schemas (TPC-H's columns are NOT NULL; money
    DECIMAL(12,2) over INT64, as ``q1_schema``)."""
    money = T.DecimalType(12, 2)

    def sch(fields):
        return T.StructType([T.StructField(nm, t, False)
                             for nm, t in fields])
    return {
        "nation": sch([("n_nationkey", T.INT), ("n_name", T.STRING),
                       ("n_regionkey", T.INT)]),
        "supplier": sch([("s_suppkey", T.LONG), ("s_name", T.STRING),
                         ("s_address", T.STRING), ("s_nationkey", T.INT),
                         ("s_phone", T.STRING)]),
        "part": sch([("p_partkey", T.LONG), ("p_brand", T.STRING),
                     ("p_type", T.STRING), ("p_size", T.INT)]),
        "partsupp": sch([("ps_partkey", T.LONG), ("ps_suppkey", T.LONG),
                         ("ps_availqty", T.INT), ("ps_supplycost", money)]),
        "lineitem": sch([("l_suppkey", T.LONG), ("l_extendedprice", money),
                         ("l_discount", money), ("l_shipdate", T.DATE)])}


def write_tpch_files(name, table, values, schema, out_dir: str, device,
                     n_files: int = N_FILES):
    """A generated table as ``n_files`` snappy files, one row group each:
    numeric columns dictionary-encoded by the port's writer, strings by
    ``encode_dict_strings`` (a table whose rows each hold their own
    string gets the file's rows as its dictionary), a ``TextColumn`` by
    ``encode_mr_strings``."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    from spark_rapids_tpu_torch.io.parquet_native import CODEC_SNAPPY

    os.makedirs(out_dir, exist_ok=True)
    n = len(table[schema.fields[0].name])
    bounds = np.linspace(0, n, n_files + 1).astype(np.int64)
    paths = []
    for i in range(n_files):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        chunks = []
        for f in schema.fields:
            if isinstance(table[f.name], TextColumn):
                chars, lens = table[f.name].rows(lo, hi)
                chunks.append(encode_mr_strings(f, chars, lens, device,
                                                CODEC_SNAPPY))
            elif isinstance(f.dataType, T.StringType):
                codes, vals = table[f.name][lo:hi], values[f.name]
                if len(vals) == n:            # each row its own string
                    codes, vals = codes - lo, vals[lo:hi]
                chunks.append(encode_dict_strings(f, codes, vals, device,
                                                  CODEC_SNAPPY))
            else:
                chunks.append(PE.encode_column(
                    f, HostColumn.from_numpy(table[f.name][lo:hi],
                                             f.dataType),
                    hi - lo, CODEC_SNAPPY, True, device))
        path = os.path.join(out_dir, f"{name}-{i:02d}.parquet")
        PE.write_chunks(path, schema, chunks, hi - lo)
        paths.append(path)
    return paths


def q11_query(partsupp, supplier, nation, mod, fraction: Decimal,
              how: str = "inner"):
    """TPC-H Q11 over three DataFrames of the package whose session module
    is ``mod``: the stock value of each part held by the nation's
    suppliers, kept where it is above FRACTION of the nation's total (the
    scalar subquery: a one-row side joined by a nested-loop join), ordered
    by value descending, as (ps_partkey, value).  ``how="cross"`` writes
    the subquery as a cross join and a filter; ``left``, ``left_semi``,
    ``left_anti`` and ``full`` give the nested-loop join's other types on
    the same rows, with every column the join outputs."""
    col, lit = mod.col, mod.lit
    nat = (nation.filter(col("n_name").eq(Q11_NATION))
           .select(col("n_nationkey").alias("nationkey")))
    supp = (supplier.select(col("s_suppkey").alias("suppkey"),
                            col("s_nationkey").alias("nationkey"))
            .join(nat, "nationkey").select("suppkey"))
    rows = (partsupp.select("ps_partkey", col("ps_suppkey").alias("suppkey"),
                            "ps_availqty", "ps_supplycost")
            .join(supp, "suppkey"))

    def stock():
        return col("ps_supplycost") * col("ps_availqty")

    value = rows.group_by("ps_partkey").agg(mod.sum_(stock(), "value"))
    threshold = (rows.agg(mod.sum_(stock(), "total"))
                 .select((col("total") * lit(fraction)).alias("threshold")))
    cond = col("value") > col("threshold")
    if how == "cross":
        joined = value.cross_join(threshold).filter(cond)
    else:
        joined = value.join(threshold, cond, how)
    if how in ("inner", "cross"):
        joined = joined.select("ps_partkey", "value")
    return joined.order_by("value", ascending=False)


def q11_values(tables):
    """(part keys, their stock values in cents, the nation's total) in
    numpy: the parts held by the nation's suppliers."""
    ps, sup = tables["partsupp"], tables["supplier"]
    german = np.zeros(len(sup["s_suppkey"]) + 1, np.bool_)
    german[sup["s_suppkey"]] = sup["s_nationkey"] == TPCH_NATIONS.index(
        Q11_NATION)
    keep = german[ps["ps_suppkey"]]
    stock = ps["ps_supplycost"][keep] * ps["ps_availqty"][keep]
    keys, inv = np.unique(ps["ps_partkey"][keep], return_inverse=True)
    value = np.zeros(len(keys), np.int64)
    np.add.at(value, inv, stock)
    return keys, value, int(stock.sum())


def q11_reference(tables, fraction: Decimal, how: str = "inner"):
    """Q11 (or the nested-loop join's ``how`` on its rows) in numpy:
    [(ps_partkey, value)] with the value a ``Decimal`` at scale 2,
    ordered by value descending (ties in partkey order, which the checks
    do not hold the port to); left and full outer add the threshold, a
    ``Decimal`` at scale 12, or None."""
    keys, value, total = q11_values(tables)
    num, den = fraction.as_integer_ratio()
    # value > total * fraction, exact in integers (den > 0)
    above = value > (total * num) // den
    order = np.lexsort((keys, -value))
    rows = [(int(k), Decimal(int(v)).scaleb(-2), bool(a))
            for k, v, a in zip(keys[order], value[order], above[order])]
    if how in ("inner", "cross", "left_semi"):
        return [r[:2] for r in rows if r[2]]
    if how == "left_anti":
        return [r[:2] for r in rows if not r[2]]
    thr = Decimal(total).scaleb(-2) * fraction
    return [r[:2] + ((thr,) if r[2] else (None,)) for r in rows]


def q11_check(rows, want):
    """Q11's rows against numpy: the same rows, and the values in the
    same (descending) order; ties may come in any order."""
    if sorted(rows) != sorted(want) or [r[1] for r in rows] != [
            r[1] for r in want]:
        return f"{rows[:3]}... ({len(rows)} rows) != {want[:3]}... " \
               f"({len(want)} rows)"
    return None


def q15_query(lineitem, supplier, mod):
    """TPC-H Q15 over two DataFrames of the package whose session module
    is ``mod``: the revenue view (each supplier's discounted revenue over
    the quarter from 1996-01-01), its ``max`` as a one-row side joined by
    an equality nested-loop join, then the supplier's name, address and
    phone by an equi-join, ordered by s_suppkey."""
    import datetime as dt

    col, lit = mod.col, mod.lit

    def revenue0():
        return (lineitem
                .filter((col("l_shipdate") >= lit(dt.date(1996, 1, 1)))
                        & (col("l_shipdate") < lit(dt.date(1996, 4, 1))))
                .group_by(col("l_suppkey").alias("supplier_no"))
                .agg(mod.sum_(col("l_extendedprice")
                              * (lit(1) - col("l_discount")),
                              "total_revenue")))

    top = revenue0().agg(mod.max_("total_revenue", "max_revenue"))
    best = (revenue0()
            .join(top, col("total_revenue").eq(col("max_revenue")), "inner")
            .select(col("supplier_no").alias("suppkey"), "total_revenue"))
    supp = supplier.select(col("s_suppkey").alias("suppkey"), "s_suppkey",
                           "s_name", "s_address", "s_phone")
    return (supp.join(best, "suppkey")
            .select("s_suppkey", "s_name", "s_address", "s_phone",
                    "total_revenue")
            .order_by("s_suppkey"))


def q15_reference(li, tables, values):
    """Q15 in numpy: [(s_suppkey, s_name, s_address, s_phone,
    total_revenue)] with the revenue a ``Decimal`` at scale 4, ordered by
    s_suppkey."""
    ship = li["l_shipdate"]
    sel = (ship >= Q15_WINDOW[0]) & (ship < Q15_WINDOW[1])
    supp = li["l_suppkey"][sel]
    rev = li["l_extendedprice"][sel] * (100 - li["l_discount"][sel])
    keys, inv = np.unique(supp, return_inverse=True)
    total = np.zeros(len(keys), np.int64)
    np.add.at(total, inv, rev)
    best = keys[total == total.max()]
    row = {k: i for i, k in enumerate(tables["supplier"]["s_suppkey"])}
    return [(int(k), values["s_name"][row[k]], values["s_address"][row[k]],
             values["s_phone"][row[k]], Decimal(int(total.max())).scaleb(-4))
            for k in sorted(best)]


def q16_query(partsupp, part, mod):
    """``q16_nolike``: TPC-H Q16 without its two LIKE predicates (``p_type
    NOT LIKE 'MEDIUM POLISHED%'`` and the supplier-complaints ``NOT IN``):
    the suppliers of parts of another brand than Brand#45 in eight sizes,
    counted distinct by brand, type and size, ordered by the count
    descending, then brand, type and size."""
    col = mod.col
    parts = (part.filter(~col("p_brand").eq(Q16_BRAND)
                         & col("p_size").isin(*Q16_SIZES))
             .select(col("p_partkey").alias("partkey"), "p_brand", "p_type",
                     "p_size"))
    return (partsupp.select(col("ps_partkey").alias("partkey"), "ps_suppkey")
            .join(parts, "partkey")
            .group_by("p_brand", "p_type", "p_size")
            .agg(mod.count_distinct_("ps_suppkey", "supplier_cnt"))
            .order_by("supplier_cnt", "p_brand", "p_type", "p_size",
                      ascending=[False, True, True, True]))


def q16_reference(tables):
    """q16_nolike in numpy: [(p_brand, p_type, p_size, supplier_cnt)] in
    Q16's order."""
    part, ps = tables["part"], tables["partsupp"]
    ok = ((part["p_brand"] != TPCH_BRANDS.index(Q16_BRAND))
          & np.isin(part["p_size"], Q16_SIZES))
    row = ps["ps_partkey"] - 1                 # partkeys are 1..n dense
    sel = ok[row]
    r = row[sel]
    group = ((part["p_brand"][r].astype(np.int64) * len(TPCH_TYPES)
              + part["p_type"][r]) * 51 + part["p_size"][r])
    pairs = np.unique(group * (1 << 32) + ps["ps_suppkey"][sel])
    g, cnt = np.unique(pairs >> 32, return_counts=True)
    out = [(TPCH_BRANDS[x // 51 // len(TPCH_TYPES)],
            TPCH_TYPES[x // 51 % len(TPCH_TYPES)], int(x % 51), int(c))
           for x, c in zip(g, cnt)]
    return sorted(out, key=lambda t: (-t[3], t[0], t[1], t[2]))


_READER = "TpuAdaptiveShuffleReader(target=1073741824B small=4194304B)"


def _indent(lines, k: int):
    return [" " * k + ln for ln in lines]


def _adaptive(join: str, decided: str, left, right,
              threshold: int = 10 << 20):
    """An adaptive join over a single-partition exchange on each side (the
    reference's plan at one device), ``left`` and ``right`` the lines
    under each exchange."""
    side = [_READER, "  TpuShuffleExchange SinglePartition"]
    return ([f"TpuAdaptiveJoin(threshold={threshold})[TpuShuffledSymmetricHash"
             f"JoinExec Inner [{join}]] decided={decided}(<bytes>)"]
            + _indent(side, 2) + _indent(left, 6)
            + _indent(side, 2) + _indent(right, 6))


def q11_plan(how: str, fraction: Decimal):
    """The reference's plan for Q11 (or the nested-loop join's ``how`` on
    its rows) from the files after a collect (the reference's explain on
    the CPU, scans as ``<scan>``, the adaptive join's bytes as
    ``<bytes>``): the threshold's Project a CPU stage (a decimal(33,2)
    times a decimal(11,10)); a full outer nested-loop join a CPU stage
    too."""
    value = ["TpuHashAggregate(Complete) keys=[ps_partkey] aggs=[sum(("
             "ps_supplycost * CAST(ps_availqty AS decimal(10,0)))) AS value]"
             ] + _indent(_adaptive(
                 "suppkey=suppkey", "broadcast",
                 ["TpuProject [ps_partkey, ps_suppkey AS suppkey, "
                  "ps_availqty, ps_supplycost]", "  <scan>"],
                 ["TpuProject [suppkey]",
                  "  TpuBroadcastHashJoinExec Inner [nationkey=nationkey]",
                  "    TpuProject [s_suppkey AS suppkey, s_nationkey AS "
                  "nationkey]", "      <scan>",
                  "    TpuBroadcastExchangeExec",
                  "      TpuStageExec[FilterProject]", "        <scan>"]), 2)
    stage = (f"TpuRowToColumnar <- Project [(total * Decimal('{fraction}')) "
             "AS threshold]")
    why = ("!Project cannot run on TPU because decimal multiply with an "
           "operand above 18 digits is not supported on TPU (needs 256-bit "
           "intermediates)")
    cond = ("[(CAST(value AS decimal(38,12)) > CAST(threshold AS "
            "decimal(38,12)))]")
    head = ["TpuSort [value DESC]"]
    if how == "cross":
        return head + ["  TpuStageExec[FilterProject]",
                       "    TpuCartesianProductExec"] + _indent(
            value, 6) + ["      " + stage, "Fallback reasons:",
                         "        " + why]
    if how == "full":
        return head + [
            f"  TpuRowToColumnar <- BroadcastNestedLoopJoin FullOuter {cond}",
            "Fallback reasons:",
            "  !BroadcastNestedLoopJoin cannot run on TPU because nested-loop "
            "join type FullOuter is not supported on TPU (use an "
            "equi-join)", "      " + why]
    jt = {"inner": "Inner", "left": "LeftOuter", "left_semi": "LeftSemi",
          "left_anti": "LeftAnti"}[how]
    join = [f"TpuBroadcastNestedLoopJoin {jt} {cond}"] + _indent(
        value, 2) + ["  TpuBroadcastExchangeExec", "    " + stage]
    # a reason is indented by its node's depth in the CPU plan
    depth = 3
    if how == "inner":
        join = ["TpuProject [ps_partkey, value]"] + _indent(join, 2)
        depth = 4
    return head + _indent(join, 2) + ["Fallback reasons:",
                                      "  " * depth + why]


def q15_plan():
    """The reference's plan for Q15 from the files after a collect: the
    revenue view twice (its sum fused over the date filter), the max's
    one row broadcast to an equality nested-loop join, the supplier's
    columns by an adaptive join that broadcasts that one row."""
    revenue = ["TpuHashAggregate(Complete) keys=[l_suppkey AS supplier_no] "
               "aggs=[sum((l_extendedprice * (CAST(1 AS decimal(10,0)) - "
               "l_discount))) AS total_revenue] fused=[Filter]", "  <scan>"]
    best = (["TpuProject [supplier_no AS suppkey, total_revenue]",
             "  TpuBroadcastNestedLoopJoin Inner [(total_revenue = "
             "max_revenue)]"] + _indent(revenue, 4)
            + ["    TpuBroadcastExchangeExec",
               "      TpuHashAggregate(Complete) keys=[] aggs=["
               "max(total_revenue) AS max_revenue]"] + _indent(revenue, 8))
    return ["TpuSort [s_suppkey ASC]",
            "  TpuProject [s_suppkey, s_name, s_address, s_phone, "
            "total_revenue]"] + _indent(_adaptive(
                "suppkey=suppkey", "broadcast",
                ["TpuProject [s_suppkey AS suppkey, s_suppkey, s_name, "
                 "s_address, s_phone]", "  <scan>"], best), 4)


def q16_plan(decided: str, broadcast_planned: bool = False,
             threshold: int = 10 << 20):
    """The reference's plan for q16_nolike from the files after a collect,
    without its join-aggregate fusion (not ported): the count over the
    dedup aggregate over the join of partsupp with the filtered parts,
    broadcast at planning when the part files are within the threshold,
    else adaptive, decided ``decided``."""
    ps = ["TpuProject [ps_partkey AS partkey, ps_suppkey]", "  <scan>"]
    parts = ["TpuStageExec[FilterProject]", "  <scan>"]
    join = (["TpuBroadcastHashJoinExec Inner [partkey=partkey]"]
            + _indent(ps, 2) + ["  TpuBroadcastExchangeExec"]
            + _indent(parts, 4) if broadcast_planned
            else _adaptive("partkey=partkey", decided, ps, parts, threshold))
    return ["TpuSort [supplier_cnt DESC, p_brand ASC, p_type ASC, p_size "
            "ASC]",
            "  TpuHashAggregate(Complete) keys=[p_brand, p_type, p_size] "
            "aggs=[count(ps_suppkey) AS supplier_cnt]",
            "    TpuHashAggregate(Complete) keys=[p_brand, p_type, p_size, "
            "ps_suppkey] aggs=[]"] + _indent(join, 6)


def residual_plan(route: str):
    """The reference's plan for the residual-condition join built by hand
    (no exchange, so no adaptive join): the broadcast join over a
    broadcast part side, or the shuffled join bare."""
    agg = ("TpuHashAggregate(Complete) keys=[] aggs=[count_star(*) AS pairs, "
           "sum(ps_availqty) AS sum_availqty, sum(ps_suppkey) AS "
           "sum_suppkey, sum(p_size) AS sum_size]")
    ps = ["    TpuProject [ps_partkey AS partkey, ps_suppkey, ps_availqty]",
          "      <scan>"]
    if route == "broadcast":
        return [agg, "  TpuBroadcastHashJoinExec Inner [partkey=pkey]"] + ps \
            + ["    TpuBroadcastExchangeExec",
               "      TpuProject [p_partkey AS pkey, p_size]", "        <scan>"]
    return [agg, "  TpuShuffledSymmetricHashJoinExec Inner [partkey=pkey]"] \
        + ps + ["    TpuProject [p_partkey AS pkey, p_size]", "      <scan>"]


def q16_build_bytes(tables) -> int:
    """The adaptive join's measured build side at q16_nolike: 64 bytes a
    filtered part (the key and its validity; p_brand's 8 chars, p_type's
    32, each with a length and a validity; p_size and its validity), as
    the port counts a row."""
    part = tables["part"]
    return 64 * int(((part["p_brand"] != TPCH_BRANDS.index(Q16_BRAND))
                     & np.isin(part["p_size"], Q16_SIZES)).sum())


def residual_query(partsupp, part, mod, route: str):
    """partsupp ⋈ part on the part key with the residual condition
    ``ps_availqty > p_size * 100``, built as a plan by hand (the session
    plans no equi-join with a condition): a ``BroadcastHashJoin`` over a
    broadcast part side (``route="broadcast"``) or a ``SortMergeJoin``
    over the two sides, the shuffled join; then the pairs counted and
    summed."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    PN = importlib.import_module(pkg + ".plan.nodes")
    col, lit = mod.col, mod.lit
    ps = partsupp.select(col("ps_partkey").alias("partkey"), "ps_suppkey",
                         "ps_availqty")
    p = part.select(col("p_partkey").alias("pkey"), "p_size")
    lk = [col("partkey").resolve(ps.schema)]
    rk = [col("pkey").resolve(p.schema)]
    if route == "broadcast":
        node = PN.BroadcastHashJoin(ps.plan, PN.BroadcastExchange(p.plan), lk,
                                    rk, PN.JoinType.INNER)
    else:
        node = PN.SortMergeJoin(ps.plan, p.plan, lk, rk, PN.JoinType.INNER)
    joined = mod.DataFrame(node, ps.session)
    node.condition = (col("ps_availqty") > col("p_size") * lit(100)).resolve(
        joined.schema)
    return joined.agg(mod.count_(None, "pairs"),
                      mod.sum_("ps_availqty", "sum_availqty"),
                      mod.sum_("ps_suppkey", "sum_suppkey"),
                      mod.sum_("p_size", "sum_size"))


def residual_reference(tables):
    """The residual-condition join's one row in numpy."""
    ps, part = tables["partsupp"], tables["part"]
    size = part["p_size"][ps["ps_partkey"] - 1]
    keep = ps["ps_availqty"] > size * 100
    return [(int(keep.sum()), int(ps["ps_availqty"][keep].sum()),
             int(ps["ps_suppkey"][keep].sum()), int(size[keep].sum()))]


def tpch_frames(paths, s, reads):
    """The files of each table in ``reads`` (table -> the columns the
    query reads) as a DataFrame of session ``s`` under that read
    schema."""
    from spark_rapids_tpu_torch import types as T

    sch = tpch_all_schemas(T)
    return {name: s.read.schema(T.StructType(
        [f for f in sch[name].fields if f.name in cols])).parquet(
        *paths[name]) for name, cols in reads.items()}


def write_tpch_tables(tables, values, li, out_dir: str, device,
                      n_files: int = N_FILES):
    """partsupp, part, supplier and Q15's lineitem as ``n_files`` snappy
    files each, nation (25 rows) and region (5, where ``tables`` holds
    it) as one file; each with the columns of ``tpch_all_schemas`` that
    the table holds."""
    from spark_rapids_tpu_torch import types as T

    sch = tpch_all_schemas(T)
    out = {}
    for name in ("nation", "supplier", "part", "partsupp", "lineitem",
                 "region"):
        if name not in tables and name != "lineitem":
            continue
        table = li if name == "lineitem" else tables[name]
        written = T.StructType([f for f in sch[name].fields
                                if f.name in table])
        out[name] = write_tpch_files(name, table, values, written, out_dir,
                                     device, 1 if name in ("nation",
                                                           "region")
                                     else n_files)
    return out


def tpch_chunks(paths, names) -> int:
    """The K1 launches of scanning the columns ``names`` read from the
    tables' files: one per dictionary chunk."""
    from spark_rapids_tpu_torch import types as T

    sch = tpch_all_schemas(T)
    total = 0
    for table, cols in names.items():
        read = T.StructType([f for f in sch[table].fields if f.name in cols])
        total += dict_chunks(paths[table], read)
    return total


#: the columns each query reads, by table (its scans' K1 launches)
Q11_READS = {"partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty",
                          "ps_supplycost"),
             "supplier": ("s_suppkey", "s_nationkey"),
             "nation": ("n_nationkey", "n_name")}
Q15_READS = {"lineitem": ("l_suppkey", "l_extendedprice", "l_discount",
                          "l_shipdate"),
             "supplier": ("s_suppkey", "s_name", "s_address", "s_phone")}
Q16_READS = {"partsupp": ("ps_partkey", "ps_suppkey"),
             "part": ("p_partkey", "p_brand", "p_type", "p_size")}
RESIDUAL_READS = {"partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty"),
                  "part": ("p_partkey", "p_size")}


def _check_launches(label: str, got: int, want: int):
    if got != want:
        fail(f"{label}: K1 launched {got} times, not once for each of the "
             f"{want} dictionary column chunks")


def run_q11(paths, tables, scale: float, device, smi: str):
    """Phase 24: TPC-H Q11 from the files, collected once and timed (the
    breakdown and the profiled collect follow), exact against numpy, the
    plan the reference's; then the same query as a cross join and a
    filter."""
    import spark_rapids_tpu_torch.session as S

    fraction = q11_fraction(scale)
    want = q11_reference(tables, fraction)
    n = len(tables["partsupp"]["ps_partkey"])
    out = {}
    for how, label in (("inner", "Q11"), ("cross", "Q11 cross join")):
        f = tpch_frames(paths, S.TpuSession(Q12_CONF, device=device),
                        Q11_READS)
        q = q11_query(f["partsupp"], f["supplier"], f["nation"], S, fraction,
                      how)
        res = _q12_collects(q, want, label, n, smi,
                            check=lambda rows: q11_check(rows, want),
                            unit="partsupp rows", warm=False)
        check_plan(q, q11_plan(how, fraction), label)
        # both sides of the nested-loop join scan the three tables
        _check_launches(label, res["launches"],
                        2 * tpch_chunks(paths, Q11_READS))
        out[how] = res
    log("Q11 plan after the collects:\n" + out["inner"]["query"].explain())
    log(f"Q11: {len(want)} parts above FRACTION {fraction} of the "
        f"{Q11_NATION} stock, the first {want[:2]}; K1 launches "
        f"{out['inner']['launches']} [{smi}]")
    return out, want


def q11_breakdown(q, smi: str):
    """Where a Q11 collect spends its time, step by step, each on its
    input batches already on the card: the partsupp scan, supplier ⋈
    nation, the adaptive join, the grouped value sum; the threshold side
    (its device scans, joins and global sum with the download), its CPU
    stage (the decimal(33,2) x decimal(11,10) product on limbs) and the
    upload; the nested-loop join; the projection and the sort."""
    import torch

    from spark_rapids_tpu_torch.cpu.oracle import eval_expr

    sort = fresh_plan(q)
    proj = sort.children[0]
    bnlj = proj.children[0]
    agg = bnlj.children[0]
    join = agg.children[0]
    left, right = join.shuffled.children
    t_ps, _ = _replay_leaf(left, 0)
    t_supp, _ = _replay_leaf(right, 0)
    t_join, batches = _timed_run(join)
    agg.children[0] = _Replay(batches, join.output)
    t_agg, values = _timed_run(agg)
    r2c = bnlj.children[1].children[0]
    stage = r2c.cpu_plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cols, rows = stage.children[0].materialize_cpu()
    t_thr = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [eval_expr(e, cols, rows).to_host() for e in stage.exprs]
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    thr = list(r2c.upload(host))
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    bnlj.children = [_Replay(values, agg.output), _Replay(thr, r2c.output)]
    t_bnlj, pairs = _timed_run(bnlj)
    proj.children[0] = _Replay(pairs, bnlj.output)
    t_proj, projected = _timed_run(proj)
    sort.children[0] = _Replay(projected, proj.output)
    t_sort, _ = _timed_run(sort)
    n_left = sum(b.num_rows for b in values)
    log(f"Q11 breakdown: partsupp scan {t_ps:.4f} s, supplier ⋈ nation "
        f"{t_supp:.4f} s, join {t_join:.4f} s ({join.decision}), value sum "
        f"{t_agg:.4f} s ({n_left} parts); threshold side: device scans, "
        f"joins and sum + download {t_thr:.4f} s, CPU stage {t_cpu:.4f} s, "
        f"upload {t_up:.4f} s; nested-loop join {t_bnlj:.4f} s ({n_left} x "
        f"{sum(b.num_rows for b in thr)} pairs, "
        f"{sum(b.num_rows for b in pairs)} kept); project {t_proj:.4f} s, "
        f"sort {t_sort:.4f} s [{smi}]")


def run_bnlj_types(paths, tables, q11_rows, scale: float, device,
                   smi: str):
    """Phase 25: the nested-loop join's other types on Q11's rows — left
    semi (the inner rows), left anti (the rest), semi + anti (every
    part), left outer (the inner rows with the threshold, the rest with
    a null one), full outer (a CPU stage, the left outer's rows) — each
    collected once, exact, planned as the reference plans it."""
    import spark_rapids_tpu_torch.session as S

    fraction = q11_fraction(scale)
    n_rows = {}
    for how in ("left_semi", "left_anti", "left", "full"):
        want = q11_reference(tables, fraction, how)
        f = tpch_frames(paths, S.TpuSession(Q12_CONF, device=device),
                        Q11_READS)
        q = q11_query(f["partsupp"], f["supplier"], f["nation"], S, fraction,
                      how)
        t0 = time.perf_counter()
        rows = q.collect()
        secs = time.perf_counter() - t0
        bad = q11_check(rows, want)
        if bad:
            fail(f"Q11 {how} nested-loop join: {bad}")
        check_plan(q, q11_plan(how, fraction), f"Q11 {how}")
        n_rows[how] = len(rows)
        log(f"Q11 {how} nested-loop join: {len(rows)} rows == numpy in "
            f"{secs:.3f} s [{smi}]")
    n_parts = len(q11_values(tables)[0])
    if n_rows["left_semi"] != len(q11_rows) \
            or n_rows["left_semi"] + n_rows["left_anti"] != n_parts:
        fail("Q11: semi is not the inner rows, or semi + anti is not every "
             "part")
    log("Q11 full outer, a CPU stage:\n" + q.explain())
    log(f"Q11 join types: semi {n_rows['left_semi']} + anti "
        f"{n_rows['left_anti']} == the {n_parts} parts; left and full "
        f"outer exact [{smi}]")


def run_residual(paths, tables, pool: int, device, smi: str):
    """Phase 25: partsupp ⋈ part with ``ps_availqty > p_size * 100`` on
    the broadcast join, the shuffled join, and the shuffled join under
    phase 13's conf (the pool, a batch goal of an eighth of it), where the
    built part side is over the goal and sub-partitions; each exact
    against numpy, each plan the reference's."""
    import spark_rapids_tpu_torch.session as S

    want = residual_reference(tables)
    n = len(tables["partsupp"]["ps_partkey"])
    out = {}
    for route, conf in (("broadcast", Q12_CONF), ("shuffled", Q12_CONF),
                        ("sub_partitioned", ooc_qb_conf(pool))):
        f = tpch_frames(paths, S.TpuSession(conf, device=device),
                        RESIDUAL_READS)
        q = residual_query(f["partsupp"], f["part"], S,
                           "broadcast" if route == "broadcast"
                           else "shuffled")
        res = _q12_collects(q, want, f"residual condition {route}", n, smi,
                            unit="partsupp rows", warm=route == "broadcast")
        check_plan(q, residual_plan(route), f"residual {route}")
        _check_launches(f"residual {route}", res["launches"],
                        tpch_chunks(paths, RESIDUAL_READS))
        buckets = q._planned().children[0].sub_partitions
        if route == "sub_partitioned" and not (buckets or 0) >= 2:
            fail("residual condition: the join did not sub-partition")
        if route != "sub_partitioned" and buckets:
            fail(f"residual condition {route}: the join sub-partitioned")
        out[route] = res
        del res["query"]
        log(f"residual condition {route}: {want} == numpy; buckets "
            f"{buckets} [{smi}]")
    return out


def run_q15(paths, li, tables, values, device, smi: str):
    """Phase 26: TPC-H Q15 from the files (its own lineitem and phase 24's
    supplier), collected once and timed (the profiled collect follows),
    exact, the plan the reference's."""
    import spark_rapids_tpu_torch.session as S

    want = q15_reference(li, tables, values)
    f = tpch_frames(paths, S.TpuSession(Q12_CONF, device=device),
                    Q15_READS)
    q = q15_query(f["lineitem"], f["supplier"], S)
    res = _q12_collects(q, want, "Q15", len(li["l_suppkey"]), smi,
                        warm=False)
    check_plan(q, q15_plan(), "Q15")
    _check_launches("Q15", res["launches"],
                    tpch_chunks(paths, {"lineitem": Q15_READS["lineitem"]})
                    * 2 + tpch_chunks(paths, {"supplier":
                                              Q15_READS["supplier"]}))
    log("Q15 plan after the collects:\n" + q.explain())
    log(f"Q15: {want} [{smi}]")
    return res, want


def run_q16(paths, tables, device, smi: str):
    """Phase 26: q16_nolike from the files, collected once and timed (the
    profiled collect follows), exact, the plan the reference's (its
    count(distinct) as two aggregates)."""
    import spark_rapids_tpu_torch.session as S

    want = q16_reference(tables)
    f = tpch_frames(paths, S.TpuSession(Q12_CONF, device=device),
                    Q16_READS)
    q = q16_query(f["partsupp"], f["part"], S)
    res = _q12_collects(q, want, "q16_nolike",
                        len(tables["partsupp"]["ps_partkey"]), smi,
                        unit="partsupp rows", warm=False)
    build = q16_build_bytes(tables)
    decided = "broadcast" if build <= 10 << 20 else "shuffled"
    planned = sum(os.path.getsize(p) for p in paths["part"]) <= 10 << 20
    check_plan(q, q16_plan(decided, planned), "q16_nolike")
    join = "broadcast at planning"
    if not planned:
        join = [ln for ln in q.explain().splitlines()
                if "decided=" in ln][0].split("decided=")[1]
        if join != f"{decided}({build}B)":
            fail(f"q16_nolike: the adaptive join decided {join}, not "
                 f"{decided} over the {build} B of the filtered parts")
    _check_launches("q16_nolike", res["launches"],
                    tpch_chunks(paths, Q16_READS))
    log("q16_nolike plan after the collects:\n" + q.explain())
    log(f"q16_nolike: join {join}; {len(want)} groups, the first "
        f"{want[:2]} [{smi}]")
    return res, want


def run_tpch_phases(scale: float, seed: int, device, smi: str, out_dir: str,
                    pool: int = OOC_POOL):
    """Phases 24-31: TPC-H's nation, supplier, part and partsupp (seed + 2;
    P_NAME and S_COMMENT from seed + 6 and + 7 over the text pool of seed
    + 4, P_CONTAINER from seed + 8), region and Q15's lineitem (seed + 3)
    at ``scale``, written as snappy files;
    K1 against its plain version on part's and nation's string index
    tables; Q11 in both forms with a breakdown; the nested-loop join's
    other types and the residual condition on three routes (the
    sub-partitioned one under ``pool``); Q15 and q16_nolike; then phases
    27-29 (``run_text_phases``, seed + 5, whose lines and orders also
    give phase 35's tables) and 30-31 (``run_arith_phases``).  -> the
    launches and seconds the kernel line and the records take, phase 35's
    tables and the TPC-H tables."""
    from spark_rapids_tpu_torch import types as T

    t0 = time.perf_counter()
    tables, values = make_tpch_parts(scale, seed + 2)
    li = lineitem_q15(int(round(SF10_ROWS * scale / 10)), scale, seed + 3)
    tpool = text_pool(seed + 4)
    green, complain = add_text_columns(tables, scale, seed + 6, tpool)
    add_arith_columns(tables, values, seed + 8)
    gen_s = time.perf_counter() - t0
    paths = write_tpch_tables(tables, values, li, out_dir, device)
    sizes = {k: (len((li if k == "lineitem" else tables[k])[
        tpch_all_schemas(T)[k].fields[0].name]),
        sum(os.path.getsize(p) for p in v)) for k, v in paths.items()}
    log(f"TPC-H data (rows, bytes): {sizes}; generated in {gen_s:.1f} s, "
        f"written in {time.perf_counter() - t0 - gen_s:.1f} s")
    log("TPC-H dictionary index widths: " + str(sorted(
        {(os.path.basename(p).split("-")[0], name, page.index_bit_width)
         for v in paths.values() for p in v[:1]
         for name, page in main_path_pages(p)})))
    sch = tpch_schemas(T)
    k1_err, _ = check_string_k1(
        [paths["part"][0], paths["nation"][0]],
        lambda p: sch["nation" if "nation" in os.path.basename(p)
                      else "part"], device, smi, "part and nation")
    log(f"phases 24-26 data wall time {time.perf_counter() - t0:.1f} s")

    # 24. TPC-H Q11: the scalar subquery as a nested-loop join, and as a
    # cross join and a filter
    t1 = time.perf_counter()
    q11, q11_rows = run_q11(paths, tables, scale, device, smi)
    q11_breakdown(q11["inner"]["query"], smi)
    # its profiled collect (idle 0.99, PRs 11-15) is left out for the time
    # limit
    log(f"phase 24 wall time {time.perf_counter() - t1:.1f} s")

    # 25. the nested-loop join's other types on Q11's rows; the inner
    # equi-join's residual condition on three routes
    t1 = time.perf_counter()
    run_bnlj_types(paths, tables, q11_rows, scale, device, smi)
    residual = run_residual(paths, tables, pool, device, smi)
    log(f"phase 25 wall time {time.perf_counter() - t1:.1f} s")

    # 26. TPC-H Q15 (an equality nested-loop join against the max) and
    # q16_nolike (count(distinct))
    t1 = time.perf_counter()
    q15, _ = run_q15(paths, li, tables, values, device, smi)
    del li
    q16, _ = run_q16(paths, tables, device, smi)
    # their profiled collects (idle 0.75 and 0.99, PRs 11-16) are left
    # out for the time limit
    log(f"phase 26 wall time {time.perf_counter() - t1:.1f} s")
    log(f"phases 24-26 wall time {time.perf_counter() - t0:.1f} s")
    text = run_text_phases(scale, seed + 5, device, smi, out_dir, paths,
                           tables, values, tpool, green, complain)
    arith = run_arith_phases(device, smi, paths, text["arith_want"],
                             text["arith_rows"], text["n_lines"])
    return {"k1_err": max(k1_err, text["k1_err"], arith["k1_err"]),
            "text": text, "arith": arith, "paths": paths,
            "windows": text["windows"], "q21": text.pop("q21"),
            "tables": tables,
            "q11_launches": q11["inner"]["launches"],
            "q11_cross_launches": q11["cross"]["launches"],
            "residual_launches": sum(r["launches"]
                                     for r in residual.values()),
            "q15_launches": q15["launches"],
            "q16_launches": q16["launches"]}


# ---------------------------------------------------------------------------
# TPC-H Q13, Q22, Q16 and Q9 (spec 2.4.13, 2.4.22, 2.4.16, 2.4.9): string
# functions, LIKE through the regex DFA and date fields, from Parquet at
# SF10 (phases 27-29)
# ---------------------------------------------------------------------------

#: the spec's text grammar (4.2.2.14) and word lists with dbgen's weights
TEXT_NOUNS = (("packages", 40), ("requests", 40), ("accounts", 40),
              ("deposits", 40), ("foxes", 20), ("ideas", 20),
              ("theodolites", 20), ("pinto beans", 20),
              ("instructions", 20), ("dependencies", 10), ("excuses", 10),
              ("platelets", 10), ("asymptotes", 10), ("courts", 5),
              ("dolphins", 5), ("multipliers", 1), ("sauternes", 1),
              ("warthogs", 1), ("frets", 1), ("dinos", 1),
              ("attainments", 1), ("somas", 1), ("Tiresias", 1),
              ("patterns", 1), ("forges", 1), ("braids", 1), ("frays", 1),
              ("warhorses", 1), ("dugouts", 1), ("notornis", 1),
              ("epitaphs", 1), ("pearls", 1), ("tithes", 1), ("waters", 1),
              ("orbits", 1), ("gifts", 1), ("sheaves", 1), ("depths", 1),
              ("sentiments", 1), ("decoys", 1), ("realms", 1), ("pains", 1),
              ("grouches", 1), ("escapades", 1), ("hockey players", 1))
TEXT_VERBS = (("sleep", 20), ("wake", 20), ("are", 20), ("cajole", 20),
              ("haggle", 20), ("nag", 10), ("use", 10), ("boost", 10),
              ("affix", 5), ("detect", 5), ("integrate", 5),
              ("maintain", 1), ("nod", 1), ("was", 1), ("lose", 1),
              ("sublate", 1), ("solve", 1), ("thrash", 1), ("promise", 1),
              ("engage", 1), ("hinder", 1), ("print", 1), ("x-ray", 1),
              ("breach", 1), ("eat", 1), ("grow", 1), ("impress", 1),
              ("mold", 1), ("poach", 1), ("serve", 1), ("run", 1),
              ("dazzle", 1), ("snooze", 1), ("doze", 1), ("unwind", 1),
              ("kindle", 1), ("play", 1), ("hang", 1), ("believe", 1),
              ("doubt", 1))
TEXT_ADJECTIVES = (("special", 20), ("pending", 20), ("unusual", 20),
                   ("express", 20), ("furious", 1), ("sly", 1),
                   ("careful", 1), ("blithe", 1), ("quick", 1),
                   ("fluffy", 1), ("slow", 1), ("quiet", 1),
                   ("ruthless", 1), ("thin", 1), ("close", 1),
                   ("dogged", 1), ("daring", 1), ("brave", 1),
                   ("stealthy", 1), ("permanent", 1), ("enticing", 1),
                   ("idle", 1), ("busy", 1), ("regular", 50), ("final", 40),
                   ("ironic", 40), ("even", 30), ("bold", 20),
                   ("silent", 10))
TEXT_ADVERBS = (("sometimes", 1), ("always", 1), ("never", 1),
                ("furiously", 50), ("slyly", 50), ("carefully", 50),
                ("blithely", 40), ("quickly", 30), ("fluffily", 20),
                ("slowly", 1), ("quietly", 1), ("ruthlessly", 1),
                ("thinly", 1), ("closely", 1), ("doggedly", 1),
                ("daringly", 1), ("bravely", 1), ("stealthily", 1),
                ("permanently", 1), ("enticingly", 1), ("idly", 1),
                ("busily", 1), ("regularly", 1), ("finally", 1),
                ("ironically", 1), ("evenly", 1), ("boldly", 1),
                ("silently", 1))
TEXT_PREPOSITIONS = (("about", 50), ("above", 50), ("according to", 50),
                     ("across", 50), ("after", 50), ("against", 40),
                     ("along", 40), ("alongside of", 30), ("among", 30),
                     ("around", 20), ("at", 10), ("atop", 1),
                     ("before", 1), ("behind", 1), ("beneath", 1),
                     ("beside", 1), ("besides", 1), ("between", 1),
                     ("beyond", 1), ("by", 1), ("despite", 1),
                     ("during", 1), ("except", 1), ("for", 1), ("from", 1),
                     ("in place of", 1), ("inside", 1), ("instead of", 1),
                     ("into", 1), ("near", 1), ("of", 1), ("on", 1),
                     ("outside", 1), ("over", 1), ("past", 1), ("since", 1),
                     ("through", 1), ("throughout", 1), ("to", 1),
                     ("toward", 1), ("under", 1), ("until", 1), ("up", 1),
                     ("upon", 1), ("without", 1), ("with", 1),
                     ("within", 1))
TEXT_AUXILIARIES = (("do", 1), ("may", 1), ("might", 1), ("shall", 1),
                    ("will", 1), ("would", 1), ("can", 1), ("could", 1),
                    ("should", 1), ("ought to", 1), ("must", 1),
                    ("will have to", 1), ("shall have to", 1),
                    ("could have to", 1), ("should have to", 1),
                    ("must have to", 1), ("need to", 1), ("try to", 1))
TEXT_TERMINATORS = ((".", 50), (";", 1), (":", 1), ("?", 1), ("!", 1),
                    ("--", 1))
TEXT_GRAMMAR = (("N V T", 3), ("N V P T", 3), ("N V N T", 3),
                ("N P V N T", 1), ("N P V P T", 1))
TEXT_NOUN_PHRASES = (("N", 10), ("J N", 20), ("J, J N", 10), ("D J N", 50))
TEXT_VERB_PHRASES = (("V", 30), ("X V", 1), ("V D", 40), ("X V D", 1))
TEXT_POOL_BYTES = 16 << 20
#: P_NAME's 92 colours (spec 4.2.3)
TPCH_COLORS = (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower",
    "cornsilk", "cream", "cyan", "dark", "deep", "dim", "dodger", "drab",
    "firebrick", "floral", "forest", "frosted", "gainsboro", "ghost",
    "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
    "magenta", "maroon", "medium", "metallic", "midnight", "mint", "misty",
    "moccasin", "navajo", "navy", "olive", "orange", "orchid", "pale",
    "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy",
    "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat",
    "white", "yellow")
CUSTOMER_SF10 = 1_500_000
Q13_PATTERN = "%special%requests%"          # WORD1, WORD2 of 2.4.13.3
Q22_CODES = ("13", "31", "23", "29", "30", "18", "17")
Q16_TYPE_PREFIX = "MEDIUM POLISHED%"
Q16_COMPLAINTS = "%Customer%Complaints%"
Q9_PATTERN = "%green%"                       # COLOR of 2.4.9.3
STRING_DICT_LIMIT = 1 << 20                  # parquet-mr's dictionary bytes


def _pkg(mod, name: str):
    """Module ``name`` of the package whose session module is ``mod``."""
    return importlib.import_module(mod.__name__.rsplit(".", 1)[0] + "."
                                   + name)


def text_pool(seed: int, n_bytes: int = TEXT_POOL_BYTES) -> np.ndarray:
    """dbgen's text pool: sentences of the spec's grammar (4.2.2.14) with
    its weighted word lists, joined by single spaces, ``n_bytes`` long
    (uint8).  The words are drawn in bulk, the sentences put together in
    one pass."""
    rng = np.random.default_rng(seed)
    k = n_bytes // 4

    def draws(lst):
        words = [w for w, _ in lst]
        p = np.array([c for _, c in lst], np.float64)
        return iter(np.array(words, object)[rng.choice(
            len(words), size=k, p=p / p.sum())])
    nouns, verbs, adjs, advs, preps, auxs, terms, gram, nps, vps = (
        draws(x) for x in (TEXT_NOUNS, TEXT_VERBS, TEXT_ADJECTIVES,
                           TEXT_ADVERBS, TEXT_PREPOSITIONS, TEXT_AUXILIARIES,
                           TEXT_TERMINATORS, TEXT_GRAMMAR,
                           TEXT_NOUN_PHRASES, TEXT_VERB_PHRASES))

    def noun_phrase():
        return {"N": lambda: next(nouns),
                "J N": lambda: f"{next(adjs)} {next(nouns)}",
                "J, J N": lambda: f"{next(adjs)}, {next(adjs)} "
                                  f"{next(nouns)}",
                "D J N": lambda: f"{next(advs)} {next(adjs)} {next(nouns)}"
                }[next(nps)]()

    def verb_phrase():
        return {"V": lambda: next(verbs),
                "X V": lambda: f"{next(auxs)} {next(verbs)}",
                "V D": lambda: f"{next(verbs)} {next(advs)}",
                "X V D": lambda: f"{next(auxs)} {next(verbs)} {next(advs)}"
                }[next(vps)]()

    def prep_phrase():
        return f"{next(preps)} the {noun_phrase()}"
    parts, size = [], 0
    while size < n_bytes:
        words = []
        for sym in next(gram).split():
            words.append({"N": noun_phrase, "V": verb_phrase,
                          "P": prep_phrase}[sym]() if sym != "T" else None)
        s = " ".join(w for w in words if w) + next(terms)
        parts.append(s)
        size += len(s) + 1
    return np.frombuffer(" ".join(parts).encode()[:n_bytes], np.uint8)


def text_chars(pool: np.ndarray, rng, n: int, lo: int, hi: int):
    """``n`` texts of dbgen's ``TEXT(lo, hi)``: a length uniform in [lo,
    hi] and a random offset into the pool -> (offsets, lengths)."""
    lens = rng.integers(lo, hi + 1, n).astype(np.int32)
    offs = rng.integers(0, len(pool) - hi, n)
    return offs, lens


def slice_chars(pool: np.ndarray, offs, lens, width: int) -> np.ndarray:
    """The pool's slices [off, off + len) as a zero-padded char matrix (a
    gather of ``width``-byte windows; each offset at most the pool's
    length less ``width``)."""
    chars = np.lib.stride_tricks.sliding_window_view(pool, width)[offs]
    chars[np.arange(width)[None, :] >= lens[:, None]] = 0
    return chars


def pool_matches(pool: np.ndarray, offs, lens, words) -> np.ndarray:
    """Rows whose pool slice holds ``words`` in order (``%w1%w2%...%``):
    each word's first occurrence at or after the previous word's end,
    found by ``searchsorted`` over the pool's occurrences; no row loop."""
    end = offs + lens
    cur = offs.astype(np.int64)
    ok = np.ones(len(offs), np.bool_)
    raw = pool.tobytes()
    for w in words:
        b = w.encode()
        hits, i = [], raw.find(b)
        while i >= 0:
            hits.append(i)
            i = raw.find(b, i + 1)
        hits = np.array(hits + [1 << 40], np.int64)     # past every end
        at = hits[np.minimum(np.searchsorted(hits, cur), len(hits) - 1)]
        ok &= at + len(b) <= end
        cur = at + len(b)
    return ok


def make_customer_orders(scale: float, seed: int, pool: np.ndarray):
    """customer and orders as TPC-H 4.2.3 draws the columns Q13, Q22 and
    Q9 read, from ``seed``: SF x 150,000 customers (C_NATIONKEY uniform in
    [0, 24], C_PHONE its country code 10 + nationkey and 3-3-4 random
    digits, C_ACCTBAL uniform in [-999.99, 9999.99]); SF x 1,500,000
    orders with sparse keys (as ``make_q12``), O_CUSTKEY uniform over the
    customer keys not divisible by 3, O_ORDERDATE uniform in
    1992-01-01..1998-08-02, O_COMMENT a TEXT(19, 78).  C_PHONE is
    (chars, lengths); O_COMMENT its pool offsets and lengths
    (``comment_offs``, ``comment_lens``)."""
    rng = np.random.default_rng(seed)
    n_c = max(int(round(scale * CUSTOMER_SF10 / 10)), 3)
    n_o = int(round(Q12_ORDERS_SF10 * scale / 10))
    nation = rng.integers(0, 25, n_c).astype(np.int32)
    groups = rng.integers([100, 100, 1000], [1000, 1000, 10000], (n_c, 3))
    phone = np.zeros((n_c, 15), np.uint8)
    digits = [(10 + nation, 2), (groups[:, 0], 3), (groups[:, 1], 3),
              (groups[:, 2], 4)]
    pos = 0
    for v, k in digits:
        for j in range(k):
            phone[:, pos + j] = ord("0") + v // 10 ** (k - 1 - j) % 10
        pos += k
        if pos < 15:
            phone[:, pos] = ord("-")
            pos += 1
    customer = {"c_custkey": np.arange(1, n_c + 1, dtype=np.int64),
                "c_nationkey": nation,
                "c_phone": (phone, np.full(n_c, 15, np.int32)),
                "c_acctbal": rng.integers(-99_999, 1_000_000, n_c)}
    i = np.arange(n_o, dtype=np.int64)
    eligible = np.arange(1, n_c + 1, dtype=np.int64)
    eligible = eligible[eligible % 3 != 0]
    offs, lens = text_chars(pool, rng, n_o, 19, 78)
    orders = {"o_orderkey": (i // 8) * 32 + (i % 8) + 1,
              "o_custkey": eligible[rng.integers(0, len(eligible), n_o)],
              "o_orderdate": rng.integers(8035, 10440 + 1, n_o).astype(
                  np.int32),
              "comment_offs": offs, "comment_lens": lens}
    return customer, orders


def part_names(n_p: int, seed: int):
    """P_NAME: five distinct words of the 92 colours a part, from
    ``seed`` -> ((chars, lengths), the (n_p, 5) colour indices)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(TPCH_COLORS), (n_p, 5))
    while True:
        s = np.sort(idx, axis=1)
        dup = (s[:, 1:] == s[:, :-1]).any(axis=1)
        if not dup.any():
            break
        idx[dup] = rng.integers(0, len(TPCH_COLORS), (int(dup.sum()), 5))
    words = np.zeros((len(TPCH_COLORS), 10), np.uint8)
    wl = np.array([len(c) for c in TPCH_COLORS], np.int64)
    for k, c in enumerate(TPCH_COLORS):
        words[k, :len(c)] = np.frombuffer(c.encode(), np.uint8)
    lens = wl[idx].sum(axis=1) + 4
    chars = np.zeros((n_p, int(lens.max())), np.uint8)
    at = np.zeros(n_p, np.int64)
    rows = np.arange(n_p)
    for k in range(5):
        if k:
            chars[rows, at] = ord(" ")
            at += 1
        for j in range(10):
            m = j < wl[idx[:, k]]
            chars[rows[m], at[m] + j] = words[idx[m, k], j]
        at += wl[idx[:, k]]
    return (chars, lens.astype(np.int32)), idx


def supplier_comments(n_s: int, seed: int, pool: np.ndarray, scale: float):
    """S_COMMENT: a TEXT(25, 100) a supplier; SF x 5 of them hold
    ``Customer`` then ``Complaints`` at random places, SF x 5 others
    ``Customer`` then ``Recommends`` (spec 4.2.3) -> ((chars, lengths),
    the complaining rows' mask)."""
    rng = np.random.default_rng(seed)
    offs, lens = text_chars(pool, rng, n_s, 25, 100)
    chars = slice_chars(pool, offs, lens, 100)
    k = max(int(round(scale * 5)), 1)
    picked = rng.choice(n_s, 2 * k, replace=False)
    complain = np.zeros(n_s, np.bool_)
    complain[picked[:k]] = True
    for r, tail in [(r, "Complaints") for r in picked[:k]] + \
            [(r, "Recommends") for r in picked[k:]]:
        room = int(lens[r]) - 8 - len(tail)
        a = int(rng.integers(0, room + 1))
        b = int(rng.integers(a + 8, room + 8 + 1))
        chars[r, a:a + 8] = np.frombuffer(b"Customer", np.uint8)
        chars[r, b:b + len(tail)] = np.frombuffer(tail.encode(), np.uint8)
    return (chars, lens), complain


def lineitem_q9(orders, scale: float, seed: int):
    """The columns Q9 reads, by TPC-H 4.2.3, from ``seed``: 1-7 lines an
    order of ``orders``, L_PARTKEY uniform over the parts, L_SUPPKEY the
    spec's supplier ``i`` (uniform in [0, 3]) of that part (so each line
    meets its partsupp row), L_QUANTITY uniform in [1, 50] (DECIMAL(12,2)
    cents), L_EXTENDEDPRICE = quantity x the part's retail price,
    L_DISCOUNT in [0.00, 0.10], L_SHIPDATE = O_ORDERDATE + [1, 121] (from
    ``seed`` + 100, for Q14); ``order_row`` (the line's order row) is kept
    for the numpy references, not written."""
    rng = np.random.default_rng(seed)
    n_s = max(int(round(scale * 10_000)), 4)
    n_p = max(int(round(scale * 200_000)), 1)
    n_o = len(orders["o_orderkey"])
    lines = rng.integers(1, 8, n_o)
    n = int(lines.sum())
    partkey = rng.integers(1, n_p + 1, n, dtype=np.int64)
    supp_i = rng.integers(0, 4, n)
    quantity = rng.integers(1, 51, n, dtype=np.int64)
    retail = (90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1_000))
    order_row = np.repeat(np.arange(n_o, dtype=np.int64), lines)
    # L_SHIPDATE from a generator of its own, so the other columns stay
    # as phase 29 drew them
    ship = np.random.default_rng(seed + 100).integers(1, 122, n).astype(
        np.int32)
    return {"l_orderkey": orders["o_orderkey"][order_row],
            "l_partkey": partkey,
            "l_suppkey": tpch_suppkey(partkey, supp_i, n_s),
            "l_quantity": quantity * 100,
            "l_extendedprice": quantity * retail,
            "l_discount": rng.integers(0, 11, n, dtype=np.int64),
            "l_shipdate": orders["o_orderdate"][order_row] + ship,
            "order_row": order_row}


def encode_mr_strings(f, chars, lens, device, codec: int,
                      dict_limit: int = STRING_DICT_LIMIT):
    """A NOT NULL string column chunk as parquet-mr writes a column of
    many distinct values: dictionary-encoded pages (a PLAIN dictionary
    page, RLE_DICTIONARY data pages of ``SPARK_PAGE_VALUES`` values) until
    the dictionary passes ``dict_limit`` bytes, then PLAIN data pages for
    the rest of the chunk, from the page where it passed.  -> (pages
    bytes, ``ChunkMeta``)."""
    from spark_rapids_tpu_torch.io import parquet_encode as PE
    from spark_rapids_tpu_torch.io.parquet_native import (ENC_PLAIN, ENC_RLE,
                                                          ENC_RLE_DICT,
                                                          PAGE_DATA,
                                                          PAGE_DICT,
                                                          TYPE_BYTE_ARRAY)
    from spark_rapids_tpu_torch.perfcounters import sync_get, to_device

    n = len(lens)
    seen, order, codes, size = {}, [], [], 0
    dict_rows = 0
    for lo in range(0, n, SPARK_PAGE_VALUES):
        hi = min(lo + SPARK_PAGE_VALUES, n)
        added, page = [], []
        for i in range(lo, hi):
            b = chars[i, :lens[i]].tobytes()
            c = seen.get(b)
            if c is None:
                c = seen[b] = len(order)
                order.append(b)
                added.append(b)
                size += 4 + len(b)
            page.append(c)
            if size > dict_limit:
                break
        if size > dict_limit:
            for b in added:               # this page falls back to PLAIN
                del seen[b]
            del order[len(order) - len(added):]
            break
        codes += page
        dict_rows = hi
    meta = PE.ChunkMeta()
    meta.name, meta.phys, meta.n, meta.codec = f.name, TYPE_BYTE_ARRAY, n, \
        codec
    meta.encodings = [ENC_PLAIN, ENC_RLE]
    pages = bytearray()
    usize = 0
    if dict_rows:
        dlens = np.array([len(b) for b in order], np.int32)
        dchars = np.zeros((len(order), max(int(dlens.max()), 1)), np.uint8)
        for k, b in enumerate(order):
            dchars[k, :len(b)] = np.frombuffer(b, np.uint8)
        payload = PE.plain_byte_array(dchars, dlens)
        cdict = PE._compress(codec, payload)
        header = PE._page_header(PAGE_DICT, len(payload), len(cdict),
                                 len(order), ENC_PLAIN)
        pages += header + cdict
        usize += len(header) + len(payload)
        meta.encodings = [ENC_RLE_DICT, ENC_PLAIN, ENC_RLE]
        bw = max((len(order) - 1).bit_length(), 1)
        (packed,) = sync_get(PE.device_bitpack(to_device(
            np.array(codes, np.int64), device), bw))
        packed = packed.tobytes()
    meta.dict_off = bool(dict_rows)
    meta.data_off = len(pages)
    for lo in range(0, n, SPARK_PAGE_VALUES):
        cnt = min(SPARK_PAGE_VALUES, n - lo)
        if lo < dict_rows:
            body = bytes([bw]) + PE._hybrid_bitpacked(
                packed[lo * bw // 8: -(-(lo + cnt) * bw // 8)], cnt, bw)
            enc = ENC_RLE_DICT
        else:
            body = PE.plain_byte_array(chars[lo:lo + cnt], lens[lo:lo + cnt])
            enc = ENC_PLAIN
        cbody = PE._compress(codec, body)
        header = PE._page_header(PAGE_DATA, len(body), len(cbody), cnt, enc)
        pages += header + cbody
        usize += len(header) + len(body)
    meta.usize, meta.csize = usize, len(pages)
    return bytes(pages), meta


def q13_schemas(T):
    """customer, orders and Q9's lineitem as written (TPC-H's columns are
    NOT NULL; money DECIMAL(12,2) over INT64)."""
    money = T.DecimalType(12, 2)

    def sch(fields):
        return T.StructType([T.StructField(nm, t, False)
                             for nm, t in fields])
    return {
        "customer": sch([("c_custkey", T.LONG), ("c_nationkey", T.INT),
                         ("c_phone", T.STRING), ("c_acctbal", money)]),
        "orders": sch([("o_orderkey", T.LONG), ("o_custkey", T.LONG),
                       ("o_orderdate", T.DATE), ("o_comment", T.STRING)]),
        "lineitem9": sch([("l_orderkey", T.LONG), ("l_partkey", T.LONG),
                          ("l_suppkey", T.LONG), ("l_quantity", money),
                          ("l_extendedprice", money),
                          ("l_discount", money), ("l_shipdate", T.DATE)])}


def q13_query(customer, orders, mod):
    """TPC-H Q13 over two DataFrames of the package whose session module
    is ``mod``: each customer's orders whose comment is not like
    '%special%requests%' counted (0 for none: a left outer join, the
    ``NOT LIKE`` pushed into the orders side as Spark's optimizer pushes
    it), then the customers counted by that count, ordered by the count
    of customers descending, then the count descending."""
    S_ = _pkg(mod, "expr.strings")
    col, lit = mod.col, mod.lit
    o = (orders.filter(~S_.Like(col("o_comment"), lit(Q13_PATTERN)))
         .select(col("o_custkey").alias("custkey"), "o_orderkey"))
    c_orders = (customer.select(col("c_custkey").alias("custkey"),
                                "c_custkey")
                .join(o, "custkey", "left")
                .group_by("c_custkey")
                .agg(mod.count_("o_orderkey", "c_count")))
    return (c_orders.group_by("c_count").agg(mod.count_(None, "custdist"))
            .order_by("custdist", "c_count", ascending=[False, False]))


def q13_reference(customer, orders, pool):
    """Q13 in numpy: ([(c_count, custdist)] in Q13's order, the orders
    whose comment is like '%special%requests%')."""
    special = pool_matches(pool, orders["comment_offs"],
                           orders["o_comment"].lens, ("special", "requests"))
    n_c = len(customer["c_custkey"])
    counts = np.bincount(orders["o_custkey"][~special] - 1, minlength=n_c)
    c, dist = np.unique(counts, return_counts=True)
    rows = [(int(a), int(b)) for a, b in zip(c, dist)]
    return sorted(rows, key=lambda r: (-r[1], -r[0])), int(special.sum())


def q22_query(customer, orders, mod):
    """TPC-H Q22 over two DataFrames of the package whose session module
    is ``mod``: the customers whose phone's country code is one of
    ``Q22_CODES``, whose balance is above the average positive balance of
    those codes (the scalar subquery: a nested-loop join against its one
    row) and who have no order (NOT EXISTS: a left anti join), counted and
    their balances summed by country code, ordered by it."""
    col, lit = mod.col, mod.lit

    def code():
        return col("c_phone").substr(1, 2)
    cust = customer.filter(code().isin(*Q22_CODES))
    avg_bal = (cust.filter(col("c_acctbal") > lit(Decimal("0.00")))
               .agg(mod.avg_("c_acctbal", "avg_acctbal")))
    above = (cust.join(avg_bal, col("c_acctbal") > col("avg_acctbal"))
             .select(col("c_custkey").alias("custkey"), "c_phone",
                     "c_acctbal"))
    no_orders = above.join(orders.select(col("o_custkey").alias("custkey")),
                           "custkey", "left_anti")
    return (no_orders.select(code().alias("cntrycode"), "c_acctbal")
            .group_by("cntrycode")
            .agg(mod.count_(None, "numcust"),
                 mod.sum_("c_acctbal", "totacctbal"))
            .order_by("cntrycode"))


def q22_reference(customer, orders):
    """Q22 in numpy: [(cntrycode, numcust, totacctbal)] with the sum a
    ``Decimal`` at scale 2, ordered by cntrycode; and the average, a
    ``Decimal`` at scale 6 (HALF_UP)."""
    code = (10 + customer["c_nationkey"]).astype(np.int64)
    bal = customer["c_acctbal"]
    inset = np.isin(code, [int(c) for c in Q22_CODES])
    pos = inset & (bal > 0)
    s, k = int(bal[pos].sum()), int(pos.sum())
    avg6 = (2 * s * 10_000 + k) // (2 * k)          # HALF_UP, s > 0
    n_c = len(bal)
    has = np.bincount(orders["o_custkey"] - 1, minlength=n_c) > 0
    keep = inset & (bal * 10_000 > avg6) & ~has
    codes, inv = np.unique(code[keep], return_inverse=True)
    sums = np.zeros(len(codes), np.int64)
    np.add.at(sums, inv, bal[keep])
    cnt = np.bincount(inv, minlength=len(codes))
    return [(str(c), int(n), Decimal(int(t)).scaleb(-2))
            for c, n, t in zip(codes, cnt, sums)], \
        Decimal(avg6).scaleb(-6)


def q16_full_query(partsupp, part, supplier, mod):
    """TPC-H Q16 in full over three DataFrames of the package whose session
    module is ``mod``: ``q16_nolike`` with ``p_type NOT LIKE 'MEDIUM
    POLISHED%'`` and ``ps_suppkey NOT IN`` the suppliers whose comment is
    like '%Customer%Complaints%' (both columns NOT NULL, so a left anti
    join gives the rows of the null-aware NOT IN)."""
    S_ = _pkg(mod, "expr.strings")
    col, lit = mod.col, mod.lit
    parts = (part.filter(~col("p_brand").eq(Q16_BRAND)
                         & ~S_.Like(col("p_type"), lit(Q16_TYPE_PREFIX))
                         & col("p_size").isin(*Q16_SIZES))
             .select(col("p_partkey").alias("partkey"), "p_brand", "p_type",
                     "p_size"))
    complaints = (supplier.filter(S_.Like(col("s_comment"),
                                          lit(Q16_COMPLAINTS)))
                  .select(col("s_suppkey").alias("ps_suppkey")))
    return (partsupp.select(col("ps_partkey").alias("partkey"), "ps_suppkey")
            .join(complaints, "ps_suppkey", "left_anti")
            .join(parts, "partkey")
            .group_by("p_brand", "p_type", "p_size")
            .agg(mod.count_distinct_("ps_suppkey", "supplier_cnt"))
            .order_by("supplier_cnt", "p_brand", "p_type", "p_size",
                      ascending=[False, True, True, True]))


def q16_parts(tables):
    """Q16's parts: another brand than Brand#45, a type not like 'MEDIUM
    POLISHED%', one of the eight sizes (a mask over part's rows)."""
    part = tables["part"]
    medium_polished = np.array([t.startswith("MEDIUM POLISHED")
                                for t in TPCH_TYPES])
    return ((part["p_brand"] != TPCH_BRANDS.index(Q16_BRAND))
            & ~medium_polished[part["p_type"]]
            & np.isin(part["p_size"], Q16_SIZES))


def q16_full_reference(tables, complain):
    """Q16 in numpy: [(p_brand, p_type, p_size, supplier_cnt)] in Q16's
    order."""
    part, ps = tables["part"], tables["partsupp"]
    ok = q16_parts(tables)
    row = ps["ps_partkey"] - 1
    sel = ok[row] & ~complain[ps["ps_suppkey"] - 1]
    r = row[sel]
    group = ((part["p_brand"][r].astype(np.int64) * len(TPCH_TYPES)
              + part["p_type"][r]) * 51 + part["p_size"][r])
    pairs = np.unique(group * (1 << 32) + ps["ps_suppkey"][sel])
    g, cnt = np.unique(pairs >> 32, return_counts=True)
    out = [(TPCH_BRANDS[x // 51 // len(TPCH_TYPES)],
            TPCH_TYPES[x // 51 % len(TPCH_TYPES)], int(x % 51), int(c))
           for x, c in zip(g, cnt)]
    return sorted(out, key=lambda t: (-t[3], t[0], t[1], t[2]))


def q9_query(part, supplier, lineitem, partsupp, orders, nation, mod):
    """TPC-H Q9 over six DataFrames of the package whose session module is
    ``mod``: the lines of parts whose name holds 'green' (a left semi join
    on the part key), joined to their partsupp row (on part and supplier
    key), their supplier, their order and the supplier's nation; the
    profit ``l_extendedprice * (1 - l_discount) - ps_supplycost *
    l_quantity`` summed by nation and ``year(o_orderdate)``, ordered by
    nation, then year descending.  Each join's key is carried under its
    own name, and each join keeps only the columns that the rest reads."""
    S_ = _pkg(mod, "expr.strings")
    DT_ = _pkg(mod, "expr.datetime")
    col, lit = mod.col, mod.lit
    green = (part.filter(S_.Like(col("p_name"), lit(Q9_PATTERN)))
             .select(col("p_partkey").alias("partkey")))
    lines = (lineitem.select(col("l_orderkey").alias("orderkey"),
                             col("l_partkey").alias("partkey"),
                             col("l_suppkey").alias("suppkey"),
                             col("l_suppkey").alias("s_key"), "l_quantity",
                             "l_extendedprice", "l_discount")
             .join(green, "partkey", "left_semi"))
    ps = partsupp.select(col("ps_partkey").alias("partkey"),
                         col("ps_suppkey").alias("suppkey"),
                         "ps_supplycost")
    keep = ["orderkey", "l_quantity", "l_extendedprice", "l_discount",
            "ps_supplycost"]
    x = (lines.join(ps, ["partkey", "suppkey"]).select("s_key", *keep)
         .join(supplier.select(col("s_suppkey").alias("s_key"),
                               "s_nationkey"), "s_key")
         .select("s_nationkey", *keep)
         .join(orders.select(col("o_orderkey").alias("orderkey"),
                             "o_orderdate"), "orderkey")
         .select("s_nationkey", "o_orderdate", *keep[1:])
         .join(nation.select(col("n_nationkey").alias("s_nationkey"),
                             "n_name"), "s_nationkey"))
    profit = x.select(
        col("n_name").alias("nation"),
        DT_.Year(col("o_orderdate")).alias("o_year"),
        (col("l_extendedprice") * (lit(1) - col("l_discount"))
         - col("ps_supplycost") * col("l_quantity")).alias("amount"))
    return (profit.group_by("nation", "o_year")
            .agg(mod.sum_("amount", "sum_profit"))
            .order_by("nation", "o_year", ascending=[True, False]))


def q9_reference(tables, green, li, orders):
    """Q9 in numpy: [(nation, o_year, sum_profit)] with the sum a
    ``Decimal`` at scale 4, in Q9's order.  Each line meets every
    partsupp row of its (part, supplier) pair."""
    ps, sup = tables["partsupp"], tables["supplier"]
    sel = green[li["l_partkey"] - 1]
    pk, sk = li["l_partkey"][sel], li["l_suppkey"][sel]
    n_s = len(sup["s_suppkey"])
    key = pk * (n_s + 1) + sk
    ps_key = ps["ps_partkey"] * (n_s + 1) + ps["ps_suppkey"]
    order = np.argsort(ps_key, kind="stable")
    lo = np.searchsorted(ps_key[order], key, "left")
    hi = np.searchsorted(ps_key[order], key, "right")
    reps = hi - lo
    line = np.repeat(np.flatnonzero(sel), reps)
    ps_row = order[np.repeat(lo, reps) + (np.arange(int(reps.sum()))
                                          - np.repeat(np.cumsum(reps) - reps,
                                                      reps))]
    amount = (li["l_extendedprice"][line] * (100 - li["l_discount"][line])
              - ps["ps_supplycost"][ps_row] * li["l_quantity"][line])
    nat = sup["s_nationkey"][li["l_suppkey"][line] - 1].astype(np.int64)
    days = orders["o_orderdate"][li["order_row"][line]]
    year = (np.datetime64("1970-01-01", "D")
            + days.astype("timedelta64[D]")).astype("datetime64[Y]") \
        .astype(np.int64) + 1970
    name_rank = np.argsort(np.argsort(np.array(TPCH_NATIONS, object)))
    g = name_rank[nat] * 10_000 + (10_000 - year)
    keys, inv = np.unique(g, return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, amount)
    by_rank = {int(r): TPCH_NATIONS[i] for i, r in enumerate(name_rank)}
    return [(by_rank[int(k // 10_000)], int(10_000 - k % 10_000),
             Decimal(int(s)).scaleb(-4)) for k, s in zip(keys, sums)]


def _hash_join(jt: str, keys: str, how: str, left, right,
               threshold: int = 10 << 20):
    """A hash join's plan lines as the reference plans it at one device:
    broadcast at planning (``how="planned"``: the right side's files
    within ``threshold``), else adaptive over a single-partition exchange
    on each side, decided ``how``."""
    if how == "planned":
        return ([f"TpuBroadcastHashJoinExec {jt} [{keys}]"]
                + _indent(left, 2) + ["  TpuBroadcastExchangeExec"]
                + _indent(right, 4))
    side = [_READER, "  TpuShuffleExchange SinglePartition"]
    return ([f"TpuAdaptiveJoin(threshold={threshold})[TpuShuffledSymmetric"
             f"HashJoinExec {jt} [{keys}]] decided={how}(<bytes>)"]
            + _indent(side, 2) + _indent(left, 6)
            + _indent(side, 2) + _indent(right, 6))


_STAGE = ["TpuStageExec[FilterProject]", "  <scan>"]

#: each hash join of phases 27-29: its right side's table, and the bytes
#: a row of its measured build side holds as the port counts them (a
#: value's bytes and a validity byte a column; a string's width, its
#: length and a validity byte): the filtered orders' two keys, orders'
#: key, a complaining supplier's key, q16's filtered part (64, as
#: ``q16_build_bytes``), a green part's key, partsupp's two keys and
#: cost, a supplier's key and nation, an order's key and date, a nation
TEXT_JOINS = {"q13": ("orders", 18), "q22": ("orders", 9),
              "q16_anti": ("supplier", 9), "q16_join": ("part", 64),
              "q9_part": ("part", 9), "q9_partsupp": ("partsupp", 27),
              "q9_supplier": ("supplier", 14), "q9_orders": ("orders", 14),
              "q9_nation": ("nation", 42)}


def text_join_modes(paths, build_rows, threshold: int = 10 << 20):
    """Each join of ``TEXT_JOINS``: ``planned`` when its right side's
    files are within ``threshold``, else the adaptive join's decision
    over ``build_rows[join]`` rows of its build side."""
    out = {}
    for k, (table, row_bytes) in TEXT_JOINS.items():
        if sum(os.path.getsize(p) for p in paths[table]) <= threshold:
            out[k] = "planned"
        else:
            out[k] = "broadcast" if build_rows[k] * row_bytes <= threshold \
                else "shuffled"
    return out


def text_build_rows(tables, orders, green, complain, n_special: int):
    """The rows of each adaptive join's build side (``TEXT_JOINS``), from
    the generated tables (``n_special``: Q13's orders whose comment is
    like its pattern)."""
    n_o = len(orders["o_orderkey"])
    return {"q13": n_o - n_special, "q22": n_o,
            "q16_anti": int(complain.sum()),
            "q16_join": int(q16_parts(tables).sum()),
            "q9_part": int(green.sum()),
            "q9_partsupp": len(tables["partsupp"]["ps_partkey"]),
            "q9_supplier": len(tables["supplier"]["s_suppkey"]),
            "q9_orders": n_o, "q9_nation": 25}


def q13_plan(modes, threshold: int = 10 << 20):
    """The reference's plan for Q13 from the files after a collect."""
    join = _hash_join("LeftOuter", "custkey=custkey", modes["q13"],
                      ["TpuProject [c_custkey AS custkey, c_custkey]",
                       "  <scan>"], _STAGE, threshold)
    return ["TpuSort [custdist DESC, c_count DESC]",
            "  TpuHashAggregate(Complete) keys=[c_count] aggs=[count_star(*)"
            " AS custdist]",
            "    TpuHashAggregate(Complete) keys=[c_custkey] aggs=[count("
            "o_orderkey) AS c_count]"] + _indent(join, 6)


def q22_plan(modes, threshold: int = 10 << 20):
    """The reference's plan for Q22 from the files after a collect: the
    scalar subquery a nested-loop join against the broadcast average."""
    codes = ", ".join(f"'{c}'" for c in Q22_CODES)
    above = ["TpuProject [c_custkey AS custkey, c_phone, c_acctbal]",
             "  TpuBroadcastNestedLoopJoin Inner [(CAST(c_acctbal AS "
             "decimal(16,6)) > CAST(avg_acctbal AS decimal(16,6)))]",
             f"    TpuFilter ((substring(c_phone, 1, 2) IN ({codes})))",
             "      <scan>", "    TpuBroadcastExchangeExec",
             "      TpuHashAggregate(Complete) keys=[] aggs=[avg(c_acctbal) "
             "AS avg_acctbal] fused=[Filter+Filter]", "        <scan>"]
    join = _hash_join("LeftAnti", "custkey=custkey", modes["q22"], above,
                      ["TpuProject [o_custkey AS custkey]", "  <scan>"],
                      threshold)
    return ["TpuSort [cntrycode ASC]",
            "  TpuHashAggregate(Complete) keys=[cntrycode] aggs=[count_star"
            "(*) AS numcust, sum(c_acctbal) AS totacctbal] fused=[Project]"
            ] + _indent(join, 4)


def q16_full_plan(modes, threshold: int = 10 << 20):
    """The reference's plan for Q16 from the files after a collect,
    without its join-aggregate fusion (not ported)."""
    anti = _hash_join("LeftAnti", "ps_suppkey=ps_suppkey", modes["q16_anti"],
                      ["TpuProject [ps_partkey AS partkey, ps_suppkey]",
                       "  <scan>"], _STAGE, threshold)
    join = _hash_join("Inner", "partkey=partkey", modes["q16_join"], anti,
                      _STAGE, threshold)
    return ["TpuSort [supplier_cnt DESC, p_brand ASC, p_type ASC, p_size "
            "ASC]",
            "  TpuHashAggregate(Complete) keys=[p_brand, p_type, p_size] "
            "aggs=[count(ps_suppkey) AS supplier_cnt]",
            "    TpuHashAggregate(Complete) keys=[p_brand, p_type, p_size, "
            "ps_suppkey] aggs=[]"] + _indent(join, 6)


def q9_plan(modes, threshold: int = 10 << 20):
    """The reference's plan for Q9 from the files after a collect."""
    keep = "l_quantity, l_extendedprice, l_discount, ps_supplycost"
    j = _hash_join("LeftSemi", "partkey=partkey", modes["q9_part"],
                   ["TpuProject [l_orderkey AS orderkey, l_partkey AS "
                    "partkey, l_suppkey AS suppkey, l_suppkey AS s_key, "
                    "l_quantity, l_extendedprice, l_discount]", "  <scan>"],
                   _STAGE, threshold)
    j = _hash_join("Inner", "partkey=partkey, suppkey=suppkey",
                   modes["q9_partsupp"], j,
                   ["TpuProject [ps_partkey AS partkey, ps_suppkey AS "
                    "suppkey, ps_supplycost]", "  <scan>"], threshold)
    j = _hash_join("Inner", "s_key=s_key", modes["q9_supplier"],
                   [f"TpuProject [s_key, orderkey, {keep}]"] + _indent(j, 2),
                   ["TpuProject [s_suppkey AS s_key, s_nationkey]",
                    "  <scan>"], threshold)
    j = _hash_join("Inner", "orderkey=orderkey", modes["q9_orders"],
                   [f"TpuProject [s_nationkey, orderkey, {keep}]"]
                   + _indent(j, 2),
                   ["TpuProject [o_orderkey AS orderkey, o_orderdate]",
                    "  <scan>"], threshold)
    j = _hash_join("Inner", "s_nationkey=s_nationkey", modes["q9_nation"],
                   [f"TpuProject [s_nationkey, o_orderdate, {keep}]"]
                   + _indent(j, 2),
                   ["TpuProject [n_nationkey AS s_nationkey, n_name]",
                    "  <scan>"], threshold)
    return ["TpuSort [nation ASC, o_year DESC]",
            "  TpuHashAggregate(Complete) keys=[nation, o_year] aggs=[sum("
            "amount) AS sum_profit] fused=[Project]"] + _indent(j, 4)


class TextColumn:
    """A NOT NULL string column as the generators hold it: a char matrix
    and lengths, or slices of the text pool (materialised a block of rows
    at a time, when written)."""

    def __init__(self, lens, chars=None, pool=None, offs=None,
                 width: int = 0):
        self.lens, self.chars = lens, chars
        self.pool, self.offs, self.width = pool, offs, width

    def __len__(self):
        return len(self.lens)

    def rows(self, lo: int, hi: int):
        """(chars, lengths) of rows [lo, hi)."""
        if self.chars is not None:
            return self.chars[lo:hi], self.lens[lo:hi]
        return (slice_chars(self.pool, self.offs[lo:hi], self.lens[lo:hi],
                            self.width), self.lens[lo:hi])

    def strings(self):
        """Every row as ``str`` (small tables: the tests' frames)."""
        chars, lens = self.rows(0, len(self))
        return np.array([bytes(r[:k]).decode() for r, k in
                         zip(chars, lens)], dtype=object)


def op_breakdown(q, label: str, smi: str):
    """Where a collect of ``q`` spends its time, operator by operator: a
    fresh plan of it run once more with every operator's pulls timed (a
    synchronize on each side, so a batch's device work is charged to the
    operator that made it) less the pulls of the operators under it, the
    rest the CPU stages and their transitions; inside them, the scan's host half (page parsing and host
    decompression, run headers and run tables, PLAIN string pages) and
    the string work (the DFA, the literal and chunked substring
    searches).  -> (operator, seconds) pairs and the probes' seconds."""
    import torch

    from spark_rapids_tpu_torch.exec.base import TpuExec
    from spark_rapids_tpu_torch.expr import strings as S_
    from spark_rapids_tpu_torch.io import parquet_device as PD

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    from spark_rapids_tpu_torch.cpu.oracle import execute_cpu_plan
    from spark_rapids_tpu_torch.plan.nodes import SparkPlan

    root = fresh_plan(q)
    nodes, todo, seen = [], [root], set()
    while todo:
        n = todo.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        if isinstance(n, TpuExec):
            nodes.append(n)
        for v in vars(n).values():
            for c in (v if isinstance(v, (list, tuple)) else [v]):
                # device execs, and the CPU stages between them
                if isinstance(c, (TpuExec, SparkPlan)):
                    todo.append(c)
    own = {id(n): 0.0 for n in nodes}
    stack = []

    def timed(n, orig):
        def run():
            it = orig()
            while True:
                sync()
                t0 = time.perf_counter()
                stack.append(id(n))
                try:
                    b = next(it)
                except StopIteration:
                    return
                finally:
                    sync()
                    dt = time.perf_counter() - t0
                    stack.pop()
                    own[id(n)] += dt
                    if stack:
                        own[stack[-1]] -= dt
                yield b
        return run

    for n in nodes:
        n.execute_columnar = timed(n, n.execute_columnar)
    probes = {"scan host": {"mod": PD, "names": (
                  "read_column_pages", "split_hybrid_runs",
                  "batch_run_table", "_decode_plain_string_page")},
              "DFA": {"mod": S_, "names": ("run_dfa",)},
              "substring search": {"mod": S_, "names": (
                  "_match_literal_at", "_first_match_pos")}}
    spent = {k: 0.0 for k in probes}
    saved = []

    def probe(key, fn):
        def call(*a, **kw):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                spent[key] += time.perf_counter() - t0
        return call

    for key, p in probes.items():
        for name in p["names"]:
            fn = getattr(p["mod"], name)
            saved.append((p["mod"], name, fn))
            setattr(p["mod"], name, probe(key, fn))
    try:
        sync()
        t0 = time.perf_counter()
        if isinstance(root, TpuExec):
            for _ in root.execute_columnar():
                pass
        else:
            execute_cpu_plan(root)
        sync()
        total = time.perf_counter() - t0
    finally:
        for mod_, name, fn in saved:
            setattr(mod_, name, fn)
    ops = [(n.describe()[:48], own[id(n)]) for n in nodes
           if own[id(n)] >= 5e-4]
    if not isinstance(root, TpuExec) or any(hasattr(n, "cpu_plan")
                                            for n in nodes):
        # the rest: the CPU stages and their transitions (host work)
        ops.append(("CPU stages and transitions",
                    total - sum(own.values())))
    log(f"{label} breakdown ({total:.4f} s in all; each operator's own "
        "time): " + "; ".join(f"{d} {s:.4f} s" for d, s in ops)
        + " | inside them: " + ", ".join(f"{k} {v:.4f} s"
                                          for k, v in spent.items())
        + f" [{smi}]")
    return ops, spent


#: the columns phases 27-29's queries read, by table
Q13_READS = {"customer": ("c_custkey",),
             "orders": ("o_orderkey", "o_custkey", "o_comment")}
Q22_READS = {"customer": ("c_custkey", "c_phone", "c_acctbal"),
             "orders": ("o_custkey",)}
Q16_FULL_READS = {"partsupp": ("ps_partkey", "ps_suppkey"),
                  "part": ("p_partkey", "p_brand", "p_type", "p_size"),
                  "supplier": ("s_suppkey", "s_comment")}
#: tables a query scans more than once (Q22's subquery reads customer
#: again)
Q22_SCANS = {"customer": 2}
Q9_READS = {"part": ("p_partkey", "p_name"),
            "supplier": ("s_suppkey", "s_nationkey"),
            "lineitem9": ("l_orderkey", "l_partkey", "l_suppkey",
                          "l_quantity", "l_extendedprice", "l_discount"),
            "partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost"),
            "orders": ("o_orderkey", "o_orderdate"),
            "nation": ("n_nationkey", "n_name")}


def _text_query(paths, reads, build, device):
    import spark_rapids_tpu_torch.session as S

    f = tpch_frames(paths, S.TpuSession(Q12_CONF, device=device), reads)
    return build(f, S)


def query_chunks(paths, reads, scans=None) -> int:
    """The K1 launches of a query reading ``reads``: each table's
    dictionary chunks once a scan of it (``scans``: table -> scans, 1 if
    not named)."""
    scans = scans or {}
    return sum(scans.get(t, 1) * tpch_chunks(paths, {t: cols})
               for t, cols in reads.items())


def run_text_query(label: str, paths, reads, build, want, plan, n: int,
                   unit: str, device, smi: str, scans=None,
                   repeats: bool = True):
    """One of phases 27-31's queries from the files: collected once
    timed (its counters read), exact against numpy; the plan the
    reference's, K1 once a dictionary chunk of each scan; with
    ``repeats``, a collect under the profiler before it and its
    breakdown after it."""
    q = _text_query(paths, reads, build, device)
    if repeats:
        profile_collect(q.collect, want, f"{label} parquet")
    res = _q12_collects(q, want, label, n, smi, unit=unit, warm=False)
    check_plan(q, plan, label)
    want_k1 = query_chunks(paths, reads, scans)
    _check_launches(label, res["launches"], want_k1)
    log(f"{label} plan after the collects:\n" + q.explain())
    log(f"{label}: K1 launches {res['launches']} == {want_k1} dictionary "
        f"chunks; bytes_h2d {res['delta']['bytes_h2d']} host_syncs "
        f"{res['delta']['host_syncs']} [{smi}]")
    if repeats:
        res["breakdown"] = op_breakdown(q, label, smi)
    return res


def tpch_all_schemas(T):
    """``tpch_schemas`` with part's P_NAME and P_CONTAINER and supplier's
    S_COMMENT, ``q13_schemas``' customer, orders and Q9's lineitem, and
    region."""
    sch = dict(tpch_schemas(T))
    for name, extra in (("part", ("p_name", "p_container")),
                        ("supplier", ("s_comment",))):
        sch[name] = T.StructType(list(sch[name].fields)
                                 + [T.StructField(e, T.STRING, False)
                                    for e in extra])
    sch.update(q13_schemas(T))
    sch.update(q21_schemas(T))
    sch["region"] = T.StructType([T.StructField("r_regionkey", T.INT, False),
                                  T.StructField("r_name", T.STRING, False)])
    return sch


def add_text_columns(tables, scale: float, seed: int, pool: np.ndarray):
    """P_NAME (``seed``) and S_COMMENT (``seed`` + 1) added to phase 24's
    part and supplier, from generators of their own, so the other
    columns stay as ``make_tpch_parts`` drew them.  -> (the parts whose
    name holds 'green', the suppliers with complaints)."""
    n_p = len(tables["part"]["p_partkey"])
    n_s = len(tables["supplier"]["s_suppkey"])
    (chars, lens), idx = part_names(n_p, seed)
    tables["part"]["p_name"] = TextColumn(lens, chars)
    (chars, lens), complain = supplier_comments(n_s, seed + 1, pool, scale)
    tables["supplier"]["s_comment"] = TextColumn(lens, chars)
    return (idx == TPCH_COLORS.index("green")).any(axis=1), complain


def make_text_tables(scale: float, seed: int, pool: np.ndarray):
    """customer and orders (``seed``) and Q9's lineitem (``seed`` + 1), the
    strings as ``TextColumn``s."""
    customer, orders = make_customer_orders(scale, seed, pool)
    chars, lens = customer["c_phone"]
    customer["c_phone"] = TextColumn(lens, chars)
    orders["o_comment"] = TextColumn(orders["comment_lens"], pool=pool,
                                     offs=orders["comment_offs"], width=78)
    return customer, orders, lineitem_q9(orders, scale, seed + 1)


def run_text_phases(scale: float, seed: int, device, smi: str,
                    out_dir: str, paths, tables, values, pool, green,
                    complain):
    """Phases 27-29: customer and orders (``seed``) and Q9's lineitem
    (``seed`` + 1) at ``scale`` written as snappy files, the strings as
    parquet-mr writes many distinct values (dictionary pages, then PLAIN
    pages past 1 MiB of dictionary); K1 against its plain version on the
    orders and customer string index tables; TPC-H Q13 and Q22 (phase
    27), Q16 in full (phase 28) and Q9 (phase 29), each exact, planned as
    the reference plans it.  -> the launches and seconds the kernel line
    and the records take, and phase 35's tables."""
    from spark_rapids_tpu_torch import types as T

    t0 = time.perf_counter()
    customer, orders, li9 = make_text_tables(scale, seed, pool)
    gen_s = time.perf_counter() - t0
    # the numpy references in threads while the files are written
    refs = _start({
        "q13": lambda: q13_reference(customer, orders, pool),
        "q22": lambda: q22_reference(customer, orders),
        "q16": lambda: q16_full_reference(tables, complain),
        "q9": lambda: q9_reference(tables, green, li9, orders),
        "arith_want": lambda: arith_references(tables, customer, orders,
                                               li9),
        "arith_rows": lambda: arith_build_rows(tables, customer, orders,
                                               li9),
        # phase 35's tables, drawn from these lines and orders
        "q21": lambda: q21_tables(li9, orders, seed + 300)})
    sch = tpch_all_schemas(T)
    for name, table in (("customer", customer), ("orders", orders),
                        ("lineitem9", li9)):
        paths[name] = write_tpch_files(name, table, values, sch[name],
                                       out_dir, device)
    write_s = time.perf_counter() - t0 - gen_s
    want13, n_special = refs["q13"].result()
    want22, avg = refs["q22"].result()
    want16, want9 = refs["q16"].result(), refs["q9"].result()
    build_rows = text_build_rows(tables, orders, green, complain, n_special)
    sizes = {k: (len(t[sch[k].fields[0].name]),
                 sum(os.path.getsize(p) for p in paths[k]))
             for k, t in (("customer", customer), ("orders", orders),
                          ("lineitem9", li9))}
    log(f"phases 27-29 data (rows, bytes): {sizes}; generated in "
        f"{gen_s:.1f} s, written in {write_s:.1f} s beside the numpy "
        f"references, which took "
        f"{time.perf_counter() - t0 - gen_s - write_s:.1f} s more; "
        f"o_comment like "
        f"'{Q13_PATTERN}': {n_special / len(orders['o_orderkey']):.6f} of "
        f"the orders; Q22's average "
        f"positive balance {avg}; {int(green.sum())} green parts, "
        f"{int(complain.sum())} complaining suppliers")
    pages = collections.Counter(
        (os.path.basename(p), name, pg.encoding)
        for p in (paths["orders"][0], paths["customer"][0],
                  paths["part"][0], paths["supplier"][0])
        for name, pg in main_path_pages(p)
        if name in ("o_comment", "c_phone", "p_name", "s_comment"))
    log("phases 27-29 string pages (file, column, encoding: data pages; "
        "8 RLE_DICTIONARY, 0 PLAIN): " + str(sorted(pages.items())))
    k1_err, widths = check_string_k1(
        [paths["orders"][0], paths["customer"][0]],
        lambda p: sch["orders" if "orders" in os.path.basename(p)
                      else "customer"], device, smi, "orders and customer")
    n_o = len(orders["o_orderkey"])
    n_c = len(customer["c_custkey"])
    # phases 30-31's references and build sides, while the data is here
    out = {"k1_err": k1_err, "k1_widths": widths,
           "arith_want": refs["arith_want"].result(),
           "arith_rows": refs["arith_rows"].result(),
           "n_lines": len(li9["l_orderkey"]),
           # what phase 33's references read
           "windows": window_tables(customer, orders),
           "q21": refs["q21"].result()}
    del customer, orders
    log(f"phases 27-29 data wall time {time.perf_counter() - t0:.1f} s")
    modes = text_join_modes(paths, build_rows)

    # 27. TPC-H Q13 (NOT LIKE through the DFA, a left outer join, a count
    # of counts) and Q22 (substring, IN, a scalar subquery, NOT EXISTS)
    t1 = time.perf_counter()
    out["q13"] = run_text_query(
        "Q13", paths, Q13_READS,
        lambda f, S: q13_query(f["customer"], f["orders"], S), want13,
        q13_plan(modes), n_o, "orders", device, smi,
        # its profiled collect (idle 0.96-0.97, PRs 12-15) and breakdown
        # (the scan's host half, 13-17 s of 14-18 s: PERF.md section 5)
        # are left out for the time limit
        repeats=False)
    out["q22"] = run_text_query(
        "Q22", paths, Q22_READS,
        lambda f, S: q22_query(f["customer"], f["orders"], S), want22,
        q22_plan(modes), n_c, "customers", device, smi, Q22_SCANS,
        # its profiled collect (idle 0.97-0.98) and breakdown (PRs
        # 12-16) are left out for the time limit
        repeats=False)
    log(f"phase 27 wall time {time.perf_counter() - t1:.1f} s")

    # 28. TPC-H Q16 in full: NOT LIKE as a prefix test, the DFA on
    # s_comment, NOT IN as a left anti join
    t1 = time.perf_counter()
    out["q16"] = run_text_query(
        "Q16", paths, Q16_FULL_READS,
        lambda f, S: q16_full_query(f["partsupp"], f["part"],
                                    f["supplier"], S), want16,
        q16_full_plan(modes), len(tables["partsupp"]["ps_partkey"]),
        "partsupp rows", device, smi,
        # its profiled collect (idle 0.98) and breakdown (PRs 12-16) are
        # left out for the time limit
        repeats=False)
    log(f"phase 28 wall time {time.perf_counter() - t1:.1f} s")

    # 29. TPC-H Q9: '%green%' as a substring search, year(o_orderdate), a
    # six-table join, a 128-bit grouped sum of a difference
    t1 = time.perf_counter()
    out["q9"] = run_text_query(
        "Q9", paths, Q9_READS,
        lambda f, S: q9_query(f["part"], f["supplier"], f["lineitem9"],
                              f["partsupp"], f["orders"], f["nation"], S),
        want9, q9_plan(modes), len(li9["l_orderkey"]), "lineitem rows", device,
        smi, repeats=False)   # its idle share and breakdown: PERF.md
    log(f"phase 29 wall time {time.perf_counter() - t1:.1f} s")
    log(f"phases 27-29 wall time {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# TPC-H Q14, Q17 and Q8 (spec 2.4.14, 2.4.17, 2.4.8): decimal division in
# a CPU stage, a correlated avg joined back with a residual condition,
# eight tables (phases 30-31)
# ---------------------------------------------------------------------------

#: P_CONTAINER's 40 syllable pairs and R_NAME (spec 4.2.3)
TPCH_CONTAINERS = tuple(f"{a} {b}"
                        for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                        for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                                  "CAN", "DRUM"))
TPCH_REGION_NAMES = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")
Q14_MONTH = (9374, 9404)           # [1995-09-01, 1995-10-01) in epoch days
Q17_BRAND = "Brand#23"             # spec 2.4.17.3's validation parameters
Q17_CONTAINER = "MED BOX"
Q8_NATION = "BRAZIL"               # spec 2.4.8.3's validation parameters
Q8_REGION = "AMERICA"
Q8_TYPE = "ECONOMY ANODIZED STEEL"
Q8_DATES = (9131, 9861)            # 1995-01-01 .. 1996-12-31 in epoch days


def add_arith_columns(tables, values, seed: int):
    """P_CONTAINER (uniform over the spec's 40 containers, from ``seed``)
    added to phase 24's part, so its other columns stay as drawn; and
    region (5 rows)."""
    n_p = len(tables["part"]["p_partkey"])
    rng = np.random.default_rng(seed)
    tables["part"]["p_container"] = rng.integers(0, 40, n_p).astype(np.int8)
    values["p_container"] = TPCH_CONTAINERS
    tables["region"] = {"r_regionkey": np.arange(5, dtype=np.int32),
                        "r_name": np.arange(5, dtype=np.int8)}
    values["r_name"] = TPCH_REGION_NAMES


def _half_up(num, den):
    """num / den rounded HALF_UP (Python ints or int64 arrays, den > 0)."""
    q = (2 * abs(num) + den) // (2 * den)
    if isinstance(num, np.ndarray):
        return np.where(num < 0, -q, q)
    return -q if num < 0 else q


def _volume(li, rows):
    """l_extendedprice * (1 - l_discount) of ``rows`` at scale 4."""
    return li["l_extendedprice"][rows] * (100 - li["l_discount"][rows])


def q14_query(lineitem, part, mod):
    """TPC-H Q14 over two DataFrames of the package whose session module
    is ``mod``: the lines shipped in September 1995 (the filter pushed
    into the lineitem side), joined to their part; the revenue of the
    PROMO parts as a percentage of the month's, ``100.00 * sum(...) /
    sum(...)`` (a decimal divide whose numerator passes 18 digits: a CPU
    stage, as the reference tags it)."""
    S_ = _pkg(mod, "expr.strings")
    CO_ = _pkg(mod, "expr.conditional")
    col, lit = mod.col, mod.lit
    li = (lineitem.filter((col("l_shipdate") >= lit(_date(Q14_MONTH[0])))
                          & (col("l_shipdate") < lit(_date(Q14_MONTH[1]))))
          .select(col("l_partkey").alias("partkey"), "l_extendedprice",
                  "l_discount"))
    volume = col("l_extendedprice") * (lit(1) - col("l_discount"))
    x = (li.join(part.select(col("p_partkey").alias("partkey"), "p_type"),
                 "partkey")
         .select(CO_.CaseWhen([(S_.Like(col("p_type"), lit("PROMO%")),
                                volume)], lit(Decimal("0")))
                 .alias("promo"), volume.alias("volume")))
    return (x.agg(mod.sum_("promo", "promo_sum"),
                  mod.sum_("volume", "total_sum"))
            .select((lit(Decimal("100.00")) * col("promo_sum")
                     / col("total_sum")).alias("promo_revenue")))


def q14_reference(tables, li):
    """Q14 in numpy and Python integers: [(promo_revenue,)] at scale 6."""
    sel = np.flatnonzero((li["l_shipdate"] >= Q14_MONTH[0])
                         & (li["l_shipdate"] < Q14_MONTH[1]))
    promo_type = np.array([t.startswith("PROMO") for t in TPCH_TYPES])
    promo = promo_type[tables["part"]["p_type"][li["l_partkey"][sel] - 1]]
    vol = _volume(li, sel)
    num = 10_000 * int(vol[promo].sum())       # 100.00 x the sum: scale 6
    return [(Decimal(_half_up(num * 10 ** 4, int(vol.sum()))).scaleb(-6),)]


def q17_query(lineitem, part, mod):
    """TPC-H Q17 over two DataFrames of the package whose session module
    is ``mod``, decorrelated as Spark plans it: the lines of Brand#23 MED
    BOX parts, joined back to ``0.2 * avg(l_quantity)`` grouped by part
    over every line with the residual condition ``l_quantity < ...``; then
    ``sum(l_extendedprice) / 7.0`` (a CPU stage)."""
    col, lit = mod.col, mod.lit
    p = (part.filter(col("p_brand").eq(lit(Q17_BRAND))
                     & col("p_container").eq(lit(Q17_CONTAINER)))
         .select(col("p_partkey").alias("partkey"),
                 col("p_partkey").alias("p_key")))
    lines = (lineitem.select(col("l_partkey").alias("partkey"),
                             "l_quantity", "l_extendedprice")
             .join(p, "partkey"))
    limit = (lineitem.select(col("l_partkey").alias("p_key"), "l_quantity")
             .group_by("p_key").agg(mod.avg_("l_quantity", "avg_qty"))
             .select("p_key", (lit(Decimal("0.2")) * col("avg_qty"))
                     .alias("qty_limit")))
    j = lines.select("p_key", "l_quantity", "l_extendedprice").join(
        limit, "p_key")
    j.plan.condition = (col("l_quantity") < col("qty_limit")).resolve(
        j.schema)
    return (j.agg(mod.sum_("l_extendedprice", "price_sum"))
            .select((col("price_sum") / lit(Decimal("7.0")))
                    .alias("avg_yearly")))


def q17_reference(tables, li):
    """Q17 in numpy and Python integers: [(avg_yearly,)] at scale 6; the
    average HALF_UP at scale 6, the limit 0.2 x it at scale 7."""
    part = tables["part"]
    chosen = ((part["p_brand"] == TPCH_BRANDS.index(Q17_BRAND))
              & (part["p_container"] == TPCH_CONTAINERS.index(Q17_CONTAINER)))
    pk = li["l_partkey"] - 1
    n_p = len(part["p_partkey"])
    # a part's quantities sum below 2^53: exact in the float64 bincount
    sums = np.bincount(pk, weights=li["l_quantity"], minlength=n_p).astype(
        np.int64)
    counts = np.maximum(np.bincount(pk, minlength=n_p), 1)
    limit7 = 2 * _half_up(sums * 10 ** 4, counts)
    keep = chosen[pk] & (li["l_quantity"] * 10 ** 5 < limit7[pk])
    if not keep.any():
        return [(None,)]                      # the sum of no rows is NULL
    total = int(li["l_extendedprice"][keep].sum())
    return [(Decimal(_half_up(total * 10 ** 5, 70)).scaleb(-6),)]


def q8_query(part, supplier, lineitem, orders, customer, nation, region,
             mod):
    """TPC-H Q8 over seven DataFrames (nation read twice) of the package
    whose session module is ``mod``: the lines of ECONOMY ANODIZED STEEL
    parts ordered in 1995-1996 by AMERICA's customers, their volume
    ``l_extendedprice * (1 - l_discount)`` by ``year(o_orderdate)``, and
    BRAZIL's suppliers' share of it, ``sum(case ...) / sum(volume)`` (a CPU
    stage), ordered by year.  Each join's key is carried under its own
    name, and each join keeps only the columns that the rest reads."""
    DT_ = _pkg(mod, "expr.datetime")
    CO_ = _pkg(mod, "expr.conditional")
    col, lit = mod.col, mod.lit
    keep = ["l_extendedprice", "l_discount"]
    x = (lineitem.select(col("l_orderkey").alias("orderkey"),
                         col("l_partkey").alias("partkey"),
                         col("l_suppkey").alias("s_key"), *keep)
         .join(part.filter(col("p_type").eq(lit(Q8_TYPE)))
               .select(col("p_partkey").alias("partkey")), "partkey")
         .select("orderkey", "s_key", *keep)
         .join(orders.filter((col("o_orderdate") >= lit(_date(Q8_DATES[0])))
                             & (col("o_orderdate")
                                <= lit(_date(Q8_DATES[1]))))
               .select(col("o_orderkey").alias("orderkey"),
                       col("o_custkey").alias("custkey"), "o_orderdate"),
               "orderkey")
         .select("custkey", "s_key", "o_orderdate", *keep)
         .join(customer.select(col("c_custkey").alias("custkey"),
                               col("c_nationkey").alias("c_nation")),
               "custkey")
         .select("c_nation", "s_key", "o_orderdate", *keep)
         .join(nation.select(col("n_nationkey").alias("c_nation"),
                             col("n_regionkey").alias("regionkey")),
               "c_nation")
         .select("regionkey", "s_key", "o_orderdate", *keep)
         .join(region.filter(col("r_name").eq(lit(Q8_REGION)))
               .select(col("r_regionkey").alias("regionkey")), "regionkey")
         .select("s_key", "o_orderdate", *keep)
         .join(supplier.select(col("s_suppkey").alias("s_key"),
                               col("s_nationkey").alias("s_nation")),
               "s_key")
         .select("s_nation", "o_orderdate", *keep)
         .join(nation.select(col("n_nationkey").alias("s_nation"),
                             col("n_name").alias("nation")), "s_nation"))
    volume = col("l_extendedprice") * (lit(1) - col("l_discount"))
    shares = (x.select(DT_.Year(col("o_orderdate")).alias("o_year"),
                       CO_.CaseWhen([(col("nation").eq(lit(Q8_NATION)),
                                      volume)], lit(Decimal("0")))
                       .alias("nation_volume"), volume.alias("volume"))
              .group_by("o_year")
              .agg(mod.sum_("nation_volume", "nation_sum"),
                   mod.sum_("volume", "volume_sum")))
    return (shares.select("o_year", (col("nation_sum") / col("volume_sum"))
                          .alias("mkt_share"))
            .order_by("o_year"))


def q8_reference(tables, customer, orders, li):
    """Q8 in numpy and Python integers: [(o_year, mkt_share)] by year,
    the share at scale 6."""
    part, sup = tables["part"], tables["supplier"]
    days = orders["o_orderdate"][li["order_row"]]
    sel = np.flatnonzero(
        (part["p_type"][li["l_partkey"] - 1] == TPCH_TYPES.index(Q8_TYPE))
        & (days >= Q8_DATES[0]) & (days <= Q8_DATES[1]))
    cust = orders["o_custkey"][li["order_row"][sel]]
    region = np.array(TPCH_REGIONS)[customer["c_nationkey"][cust - 1]]
    sel = sel[region == TPCH_REGION_NAMES.index(Q8_REGION)]
    vol = _volume(li, sel)
    home = (sup["s_nationkey"][li["l_suppkey"][sel] - 1]
            == TPCH_NATIONS.index(Q8_NATION))
    year = (np.datetime64("1970-01-01", "D") + days[sel].astype(
        "timedelta64[D]")).astype("datetime64[Y]").astype(np.int64) + 1970
    out = []
    for y in np.unique(year):
        m = year == y
        total = int(vol[m].sum())
        out.append((int(y), Decimal(_half_up(int(vol[m & home].sum())
                                             * 10 ** 6, total)).scaleb(-6)))
    return out


def stage_plan_shape(q):
    """``plan_shape`` of the device subtrees under a query's CPU stages
    (the explain shows each as one ``ColumnarToRow`` line), in plan
    order."""
    planned = getattr(q, "_planned_with_meta", None) or q._planned
    root, _ = planned()
    out, todo = [], [root]
    while todo:
        n = todo.pop(0)
        if hasattr(n, "tpu_child"):
            out += _shape_lines(n.tpu_child.pretty().splitlines())
            continue
        todo.extend(getattr(n, "children", []))
        if hasattr(n, "cpu_plan"):
            todo.append(n.cpu_plan)
    return out


def arith_query(name: str, f, mod):
    """Q14, Q17 or Q8 over the DataFrames ``f`` (table -> DataFrame) of
    the package whose session module is ``mod``."""
    if name == "q14":
        return q14_query(f["lineitem9"], f["part"], mod)
    if name == "q17":
        return q17_query(f["lineitem9"], f["part"], mod)
    return q8_query(f["part"], f["supplier"], f["lineitem9"], f["orders"],
                    f["customer"], f["nation"], f["region"], mod)


def arith_references(tables, customer, orders, li):
    """The three queries' rows in numpy, by name."""
    return {"q14": q14_reference(tables, li),
            "q17": q17_reference(tables, li),
            "q8": q8_reference(tables, customer, orders, li)}


#: the columns phases 30-31's queries read, by table, and the tables
#: scanned more than once (Q17's lineitem twice, Q8's nation twice)
ARITH_READS = {
    "q14": ({"lineitem9": ("l_partkey", "l_extendedprice", "l_discount",
                           "l_shipdate"),
             "part": ("p_partkey", "p_type")}, None),
    "q17": ({"lineitem9": ("l_partkey", "l_quantity", "l_extendedprice"),
             "part": ("p_partkey", "p_brand", "p_container")},
            {"lineitem9": 2}),
    "q8": ({"lineitem9": ("l_orderkey", "l_partkey", "l_suppkey",
                          "l_extendedprice", "l_discount"),
            "part": ("p_partkey", "p_type"),
            "orders": ("o_orderkey", "o_custkey", "o_orderdate"),
            "customer": ("c_custkey", "c_nationkey"),
            "nation": ("n_nationkey", "n_regionkey", "n_name"),
            "region": ("r_regionkey", "r_name"),
            "supplier": ("s_suppkey", "s_nationkey")}, {"nation": 2})}

#: each hash join of phases 30-31: its right side's table, and the bytes
#: a row of its build side holds as the port counts them (``TEXT_JOINS``)
ARITH_JOINS = {"q14_part": ("part", 46), "q17_part": ("part", 18),
               "q17_limit": ("lineitem9", 26), "q8_part": ("part", 9),
               "q8_orders": ("orders", 23), "q8_customer": ("customer", 14),
               "q8_nation1": ("nation", 10), "q8_region": ("region", 5),
               "q8_supplier": ("supplier", 14), "q8_nation2": ("nation", 0)}


def arith_build_rows(tables, customer, orders, li):
    """The rows of each join's build side (``ARITH_JOINS``)."""
    part = tables["part"]
    q17 = ((part["p_brand"] == TPCH_BRANDS.index(Q17_BRAND))
           & (part["p_container"] == TPCH_CONTAINERS.index(Q17_CONTAINER)))
    dates = orders["o_orderdate"]
    return {"q14_part": len(part["p_partkey"]), "q17_part": int(q17.sum()),
            "q17_limit": len(np.unique(li["l_partkey"])),
            "q8_part": int((part["p_type"]
                            == TPCH_TYPES.index(Q8_TYPE)).sum()),
            "q8_orders": int(((dates >= Q8_DATES[0])
                              & (dates <= Q8_DATES[1])).sum()),
            "q8_customer": len(customer["c_custkey"]), "q8_nation1": 25,
            "q8_region": 1, "q8_supplier": len(
                tables["supplier"]["s_suppkey"]), "q8_nation2": 25}


def arith_join_modes(paths, build_rows, threshold: int = 10 << 20):
    """Each join of ``ARITH_JOINS``, as ``text_join_modes`` decides them;
    Q17's second join has no files on its right (an aggregate): it is
    always adaptive."""
    out = {}
    for k, (table, row_bytes) in ARITH_JOINS.items():
        if k != "q17_limit" and sum(os.path.getsize(p)
                                    for p in paths[table]) <= threshold:
            out[k] = "planned"
        else:
            out[k] = "broadcast" if build_rows[k] * row_bytes <= threshold \
                else "shuffled"
    return out


def arith_memory_modes():
    """The joins' modes from memory: broadcast at planning, but Q17's
    second join (an aggregate on its right: adaptive, not yet decided)."""
    modes = {k: "planned" for k in ARITH_JOINS}
    modes["q17_limit"] = "adaptive"
    return modes


def _stage_join(keys: str, lk: str, rk: str, mode: str, left, right,
                threshold: int):
    """A hash join's lines under a CPU stage (no coalescing reader: the
    device root's passes do not run there): broadcast at planning, or
    adaptive over a hash exchange on each side, decided ``mode`` (or not
    yet, ``adaptive``)."""
    if mode == "planned":
        return ([f"TpuBroadcastHashJoinExec Inner [{keys}]"]
                + _indent(left, 2) + ["  TpuBroadcastExchangeExec"]
                + _indent(right, 4))
    decided = "" if mode == "adaptive" else f" decided={mode}(<bytes>)"
    return ([f"TpuAdaptiveJoin(threshold={threshold})[TpuShuffledSymmetric"
             f"HashJoinExec Inner [{keys}]]{decided}",
             f"  TpuShuffleExchange hashpartitioning({lk}, 16)"]
            + _indent(left, 4)
            + [f"  TpuShuffleExchange hashpartitioning({rk}, 16)"]
            + _indent(right, 4))


_DIV_REASON = ("decimal divide intermediate exceeds 18 digits (128-bit "
               "division is not implemented on TPU)")
_VOLUME = "(l_extendedprice * (CAST(1 AS decimal(10,0)) - l_discount))"


def q14_plan(modes, threshold: int = 10 << 20):
    """(the explain, the device subtree under its CPU stage) of Q14 as the
    reference plans it: the divide and the 38-digit product in a CPU
    stage over the aggregate."""
    agg = ("TpuHashAggregate(Complete) keys=[] aggs=[sum(promo) AS "
           "promo_sum, sum(volume) AS total_sum]")
    plan = ["Project [((Decimal('100.00') * promo_sum) / total_sum) AS "
            "promo_revenue]", "  ColumnarToRow <- " + agg,
            "Fallback reasons:",
            f"!Project cannot run on TPU because {_DIV_REASON}; decimal "
            "multiply with an operand above 18 digits is not supported on "
            "TPU (needs 256-bit intermediates)"]
    join = _stage_join(
        "partkey=partkey", "partkey", "partkey", modes["q14_part"],
        ["TpuProject [l_partkey AS partkey, l_extendedprice, l_discount]",
         f"  TpuFilter (((l_shipdate >= {Q14_MONTH[0]}) AND (l_shipdate < "
         f"{Q14_MONTH[1]})))", "    <scan>"],
        ["TpuProject [p_partkey AS partkey, p_type]", "  <scan>"],
        threshold)
    stage = [agg, f"  TpuProject [CASE WHEN like(p_type, 'PROMO%') THEN "
             f"{_VOLUME} ELSE CAST(Decimal('0') AS decimal(26,4)) END AS "
             f"promo, {_VOLUME} AS volume]"] + _indent(join, 4)
    return plan, stage


def q17_plan(modes, threshold: int = 10 << 20):
    """(the explain, the device subtree under its CPU stage) of Q17 as the
    reference plans it."""
    agg = ("TpuHashAggregate(Complete) keys=[] aggs=[sum(l_extendedprice) "
           "AS price_sum]")
    plan = ["Project [(price_sum / Decimal('7.0')) AS avg_yearly]",
            "  ColumnarToRow <- " + agg, "Fallback reasons:",
            f"!Project cannot run on TPU because {_DIV_REASON}"]
    lines = _stage_join(
        "partkey=partkey", "partkey", "partkey", modes["q17_part"],
        ["TpuProject [l_partkey AS partkey, l_quantity, l_extendedprice]",
         "  <scan>"],
        ["TpuProject [p_partkey AS partkey, p_partkey AS p_key]",
         f"  TpuFilter (((p_brand = '{Q17_BRAND}') AND (p_container = "
         f"'{Q17_CONTAINER}')))", "    <scan>"], threshold)
    join = _stage_join(
        "p_key=p_key", "p_key", "p_key", modes["q17_limit"],
        ["TpuProject [p_key, l_quantity, l_extendedprice]"]
        + _indent(lines, 2),
        ["TpuProject [p_key, (Decimal('0.2') * avg_qty) AS qty_limit]",
         "  TpuHashAggregate(Complete) keys=[p_key] aggs=[avg(l_quantity) "
         "AS avg_qty]", "    TpuProject [l_partkey AS p_key, l_quantity]",
         "      <scan>"], threshold)
    return plan, [agg] + _indent(join, 2)


def q8_plan(modes, threshold: int = 10 << 20):
    """(the explain, the device subtree under its CPU stage) of Q8 as the
    reference plans it: the sort on the device over the CPU stage."""
    keep = "l_extendedprice, l_discount"
    plan = ["TpuSort [o_year ASC]",
            "  TpuRowToColumnar <- Project [o_year, (nation_sum / "
            "volume_sum) AS mkt_share]", "Fallback reasons:",
            f"  !Project cannot run on TPU because {_DIV_REASON}"]
    j = _stage_join(
        "partkey=partkey", "partkey", "partkey", modes["q8_part"],
        ["TpuProject [l_orderkey AS orderkey, l_partkey AS partkey, "
         f"l_suppkey AS s_key, {keep}]", "  <scan>"],
        ["TpuProject [p_partkey AS partkey]",
         f"  TpuFilter ((p_type = '{Q8_TYPE}'))", "    <scan>"], threshold)
    steps = [
        ("orderkey", "q8_orders", f"orderkey, s_key, {keep}",
         ["TpuProject [o_orderkey AS orderkey, o_custkey AS custkey, "
          "o_orderdate]", f"  TpuFilter (((o_orderdate >= {Q8_DATES[0]}) "
          f"AND (o_orderdate <= {Q8_DATES[1]})))", "    <scan>"]),
        ("custkey", "q8_customer", f"custkey, s_key, o_orderdate, {keep}",
         ["TpuProject [c_custkey AS custkey, c_nationkey AS c_nation]",
          "  <scan>"]),
        ("c_nation", "q8_nation1", f"c_nation, s_key, o_orderdate, {keep}",
         ["TpuProject [n_nationkey AS c_nation, n_regionkey AS regionkey]",
          "  <scan>"]),
        ("regionkey", "q8_region", f"regionkey, s_key, o_orderdate, {keep}",
         ["TpuProject [r_regionkey AS regionkey]",
          f"  TpuFilter ((r_name = '{Q8_REGION}'))", "    <scan>"]),
        ("s_key", "q8_supplier", f"s_key, o_orderdate, {keep}",
         ["TpuProject [s_suppkey AS s_key, s_nationkey AS s_nation]",
          "  <scan>"]),
        ("s_nation", "q8_nation2", f"s_nation, o_orderdate, {keep}",
         ["TpuProject [n_nationkey AS s_nation, n_name AS nation]",
          "  <scan>"])]
    for key, join, cols, right in steps:
        j = _stage_join(f"{key}={key}", key, key, modes[join],
                        [f"TpuProject [{cols}]"] + _indent(j, 2), right,
                        threshold)
    stage = ["TpuHashAggregate(Complete) keys=[o_year] aggs=[sum("
             "nation_volume) AS nation_sum, sum(volume) AS volume_sum]",
             f"  TpuProject [year(o_orderdate) AS o_year, CASE WHEN (nation "
             f"= '{Q8_NATION}') THEN {_VOLUME} ELSE CAST(Decimal('0') AS "
             f"decimal(26,4)) END AS nation_volume, {_VOLUME} AS volume]"]
    return plan, stage + _indent(j, 4)


ARITH_PLANS = {"q14": q14_plan, "q17": q17_plan, "q8": q8_plan}


def check_container_k1(paths, device, smi: str):
    """K1 against its plain version on part's first file's p_container
    index table (``check_string_k1``)."""
    from spark_rapids_tpu_torch import types as T

    sch = T.StructType([f for f in tpch_all_schemas(T)["part"].fields
                        if f.name == "p_container"])
    return check_string_k1([paths["part"][0]], lambda p: sch, device, smi,
                           "part's p_container")


def run_arith_query(label: str, name: str, paths, want, modes, n: int,
                    device, smi: str):
    """One of phases 30-31's queries from the files (``run_text_query``:
    timed, exact, planned as the reference plans it, K1 once a dictionary
    chunk of each scan; its profiled collect and breakdown, PR 13's and
    14's in PERF.md, left out for the time limit), and the device subtree
    under its CPU stage the reference's, its joins decided as ``modes``
    predicts."""
    reads, scans = ARITH_READS[name]
    plan, stage = ARITH_PLANS[name](modes)
    res = run_text_query(label, paths, reads,
                         lambda f, S: arith_query(name, f, S), want, plan, n,
                         "lineitem rows", device, smi, scans, repeats=False)
    if stage_plan_shape(res["query"]) != stage:
        fail(f"unexpected {label} plan under its CPU stage:\n"
             + "\n".join(stage_plan_shape(res["query"])))
    log(f"{label}: the device subtree under its CPU stage is the "
        f"reference's, its joins decided as predicted ({modes})")
    del res["query"]
    return res


def run_arith_phases(device, smi: str, paths, want, build_rows,
                     n_lines: int):
    """Phases 30-31: K1 against its plain version on part's first file's
    p_container index table; TPC-H Q14 and Q17 (phase 30) and Q8 (phase
    31) from phases 24-29's files (part with P_CONTAINER, Q9's lineitem
    with L_SHIPDATE) and region, each exact, planned as the reference
    plans it (the final divide a CPU stage), profiled and broken down.
    -> the launches and seconds the kernel line and the records take."""
    t0 = time.perf_counter()
    k1_err, widths = check_container_k1(paths, device, smi)
    modes = arith_join_modes(paths, build_rows)
    log(f"phases 30-31 data: region ({os.path.getsize(paths['region'][0])} "
        f"bytes), P_CONTAINER index widths {widths}; the joins' modes "
        f"predicted from the build sides' rows {build_rows}: {modes}")
    out = {"k1_err": k1_err}

    # 30. TPC-H Q14 (a decimal divide of two 128-bit sums in a CPU stage)
    # and Q17 (a grouped avg joined back with a residual condition)
    t1 = time.perf_counter()
    out["q14"] = run_arith_query("Q14", "q14", paths, want["q14"], modes,
                                 n_lines, device, smi)
    out["q17"] = run_arith_query("Q17", "q17", paths, want["q17"], modes,
                                 n_lines, device, smi)
    log(f"phase 30 wall time {time.perf_counter() - t1:.1f} s")

    # 31. TPC-H Q8: eight tables, year(o_orderdate), a share by year
    t1 = time.perf_counter()
    out["q8"] = run_arith_query("Q8", "q8", paths, want["q8"], modes,
                                n_lines, device, smi)
    log(f"phase 31 wall time {time.perf_counter() - t1:.1f} s")
    log(f"phases 30-31 wall time {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Windows and statistics at SF10 (phases 32-33): a TPC-DS Q47-shaped query,
# moving frames and per-item statistics over phases 9-11's store_sales;
# order histories and customer phones over phase 27's customer and orders
# ---------------------------------------------------------------------------

Q47_LIMIT = 100
#: the doubles' tolerance: relative to the larger of the value and the
#: scale of the terms it was computed from
WINDOW_RTOL = 1e-9
Q47_READS = ("date_sk", "store_sk", "item_sk", "ext_sales")
STATS_READS = ("item_sk", "quantity", "net_profit")
HISTORY_READS = {"orders": ("o_orderkey", "o_custkey", "o_orderdate")}
PHONES_READS = {"customer": ("c_custkey", "c_nationkey", "c_phone",
                             "c_acctbal")}


#: the plans, scans as ``<scan>``: the reference's, with its window-chain
#: fusion (the filter and project over the second window) and its
#: join-aggregate fusion not ported (ROADMAP item D6)
Q47_PLAN = [
    "TpuTopN 100",
    "  TpuStageExec[FilterProject]",
    "    TpuWindow [rank, lag, lead] frame=running",
    "      TpuWindow [avg] frame=unbounded",
    "        TpuProject [item_sk, store_sk, d_year, d_moy, CAST(monthly AS "
    "double) AS sum_sales]",
    "          TpuHashAggregate(Complete) keys=[item_sk, store_sk, d_year, "
    "d_moy] aggs=[sum(ext_sales) AS monthly]",
    "            TpuBroadcastHashJoinExec Inner [date_sk=date_sk]",
    "              <scan>",
    "              TpuBroadcastExchangeExec",
    "                TpuFilter ((((d_year = 1999) OR ((d_year = 1998) AND "
    "(d_moy = 12))) OR ((d_year = 2000) AND (d_moy = 1))))",
    "                  <scan>"]
MOVING_PLAN = [
    "TpuWindow [sum, max] frame=range_running",
    "  TpuWindow [sum, count, max, var_pop] frame=('range', 6, 0)",
    "    TpuWindow [avg, stddev_samp, min, first_value, last_value] "
    "frame=('rows', 3, 3)",
    "      TpuProject [item_sk, store_sk, date_sk, ticket, quantity, "
    "ext_sales, net_profit, CASE WHEN (quantity > CAST(90 AS bigint)) THEN "
    "None ELSE net_profit END AS np]",
    "        <scan>"]
STATS_PLAN = [
    "TpuHashAggregate(Complete) keys=[item_sk] aggs=[skewness(quantity) AS "
    "q_skew, kurtosis(net_profit) AS p_kurt, corr(quantity) AS corr, "
    "covar_samp(quantity) AS covar_samp, covar_pop(quantity) AS covar_pop, "
    "regr_slope(net_profit) AS slope, regr_intercept(net_profit) AS "
    "intercept, regr_r2(net_profit) AS r2, regr_count(net_profit) AS n]",
    "  <scan>"]
HISTORY_PLAN = [
    "TpuWindow [count, min] frame=('range', 90, 0)",
    "  TpuWindow [row_number, lag, lead] frame=running",
    "    <scan>"]
PHONES_PLAN = [
    "TpuWindow [min] frame=unbounded",
    "  TpuWindow [max] frame=range_running",
    "    TpuWindow [lag, lead, first_value, last_value] frame=running",
    "      TpuProject [c_custkey, c_nationkey, c_phone, c_acctbal, CASE WHEN "
    "(CAST(c_acctbal AS decimal(12,2)) < CAST(Decimal('0.00') AS "
    "decimal(12,2))) THEN None ELSE c_phone END AS ph]",
    "        <scan>"]


def _wf(mod):
    return _pkg(mod, "plan.nodes").WindowFunction


def q47_query(sales, dates, mod):
    """TPC-DS Q47's shape on bench's keys: the monthly sales of each
    (item, store) in 1999 and the months either side, as DOUBLE (the
    reference tags a window ``avg`` over a decimal off the device, and
    the port has no CPU window: a departure from the spec); the year's
    average per (item, store, year) over the unbounded frame; ``rank``,
    ``lag`` and ``lead`` per (item, store) by month (the spec's self-joins
    on rn +- 1, so both must exist); 1999's months more than 10% off
    their average, ordered by the difference, item and store, 100
    rows."""
    WF = _wf(mod)
    T_ = _pkg(mod, "types")
    A_ = _pkg(mod, "expr.arithmetic")
    col, lit = mod.col, mod.lit
    year, moy = col("d_year"), col("d_moy")
    dd = dates.filter(year.eq(lit(1999))
                      | (year.eq(lit(1998)) & moy.eq(lit(12)))
                      | (year.eq(lit(2000)) & moy.eq(lit(1))))
    monthly = (sales.join(dd, on="date_sk")
               .group_by("item_sk", "store_sk", "d_year", "d_moy")
               .agg(mod.sum_("ext_sales", "monthly"))
               .select("item_sk", "store_sk", "d_year", "d_moy",
                       col("monthly").cast(T_.DOUBLE).alias("sum_sales")))
    v1 = monthly.window(
        [WF("avg", col("sum_sales"), "avg_monthly_sales")],
        partition_by=["item_sk", "store_sk", "d_year"], order_by=[],
        frame="unbounded")
    v2 = v1.window(
        [WF("rank", None, "rn"), WF("lag", col("sum_sales"), "psum"),
         WF("lead", col("sum_sales"), "nsum")],
        partition_by=["item_sk", "store_sk"],
        order_by=["d_year", "d_moy"])
    avg = col("avg_monthly_sales")
    diff = col("sum_sales") - avg
    return (v2.filter(year.eq(lit(1999)) & (avg > lit(0.0))
                      & (A_.Abs(diff) / avg > lit(0.1))
                      & col("psum").is_not_null()
                      & col("nsum").is_not_null())
            .select("item_sk", "store_sk", "d_year", "d_moy", "sum_sales",
                    "avg_monthly_sales", "rn", "psum", "nsum",
                    diff.alias("diff"))
            .order_by(col("diff"), col("item_sk"), col("store_sk"))
            .limit(Q47_LIMIT))


def _q47_months(ss, dd):
    """The joined rows' (item, store, year, month) sums: sorted keys
    ``(item, store, year, month)`` and their sums in cents."""
    row = ss["date_sk"].astype(np.int64) - DATE_SK0
    year = dd["d_year"][row].astype(np.int64)
    moy = dd["d_moy"][row].astype(np.int64)
    keep = (year == 1999) | ((year == 1998) & (moy == 12)) \
        | ((year == 2000) & (moy == 1))
    key = (((ss["item_sk"][keep].astype(np.int64) * 64
             + ss["store_sk"][keep]) * 4 + (year[keep] - 1998)) * 16
           + moy[keep])
    order = np.argsort(key, kind="stable")
    key = key[order]
    starts = np.ones(len(key), np.bool_)
    starts[1:] = key[1:] != key[:-1]
    first = np.nonzero(starts)[0]
    cents = np.add.reduceat(ss["ext_sales"][keep][order].astype(np.int64),
                            first) if len(first) else np.zeros(0, np.int64)
    return key[first], cents


def q47_reference(ss, dd):
    """Q47's 100 rows from numpy: (item, store, year, month, sum, avg,
    rank, previous sum, next sum, sum - avg) as arrays."""
    key, cents = _q47_months(ss, dd)
    moy = key % 16
    year = 1998 + key // 16 % 4
    store = key // 64 % 64
    item = key // 4096
    sums = cents / np.float64(100)
    part = key // 64                       # (item, store)
    pyear = key // 16                      # (item, store, year)
    n = len(key)
    idx = np.arange(n)
    new_p = np.ones(n, np.bool_)
    new_p[1:] = part[1:] != part[:-1]
    new_y = np.ones(n, np.bool_)
    new_y[1:] = pyear[1:] != pyear[:-1]
    ystart = np.nonzero(new_y)[0]
    ysum = np.add.reduceat(sums, ystart)
    ycnt = np.diff(np.append(ystart, n))
    avg = (ysum / ycnt)[np.cumsum(new_y) - 1]
    rank = idx - np.maximum.accumulate(np.where(new_p, idx, 0)) + 1
    has_prev = ~new_p
    has_next = np.append(~new_p[1:], False)
    psum = np.where(has_prev, np.roll(sums, 1), 0.0)
    nsum = np.where(has_next, np.roll(sums, -1), 0.0)
    diff = sums - avg
    keep = ((year == 1999) & (avg > 0) & (np.abs(diff) / avg > 0.1)
            & has_prev & has_next)
    sel = np.nonzero(keep)[0]
    sel = sel[np.lexsort((store[sel], item[sel], diff[sel]))][:Q47_LIMIT]
    return {"item": item[sel], "store": store[sel], "year": year[sel],
            "moy": moy[sel], "sum": sums[sel], "avg": avg[sel],
            "rank": rank[sel], "psum": psum[sel], "nsum": nsum[sel],
            "diff": diff[sel]}


def _close(got, want, scale=None, rtol: float = WINDOW_RTOL):
    """Doubles within ``rtol`` of max(|want|, ``scale``), NaN with NaN;
    -> the count of rows that are not."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    ref = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    ok = (np.abs(got - want) <= rtol * ref) | (np.isnan(got)
                                               & np.isnan(want))
    return int((~ok).sum())


def q47_check(rows, want):
    """-> None when the port's rows are the reference's, in order (ints
    exact, doubles to ``WINDOW_RTOL``), else a complaint."""
    if len(rows) != len(want["item"]):
        return f"{len(rows)} rows, not {len(want['item'])}"
    cols = list(zip(*rows)) if rows else [()] * 10
    for i, k in enumerate(("item", "store", "year", "moy")):
        if list(cols[i]) != [int(v) for v in want[k]]:
            return f"{k} differs"
    if list(cols[6]) != [int(v) for v in want["rank"]]:
        return "rank differs"
    for i, k in ((4, "sum"), (5, "avg"), (7, "psum"), (8, "nsum")):
        if _close(cols[i], want[k]):
            return f"{k} differs"
    if _close(cols[9], want["diff"], want["avg"]):
        return "diff differs"
    return None


def moving_query(sales, mod):
    """Moving frames over every store_sales row: per item by (date,
    ticket), ROWS 3 PRECEDING to 3 FOLLOWING: ``avg`` and ``stddev_samp``
    of the quantity, ``min`` of the sales, ``first_value`` (IGNORE NULLS)
    and ``last_value`` of ``np`` (the profit, null where the quantity
    passes 90); per store by date, RANGE 6 PRECEDING to CURRENT ROW (a
    trailing seven days): ``sum`` of the sales, ``count`` of the tickets,
    ``max`` of the profit, ``var_pop`` of the quantity; the same
    partition over RANGE UNBOUNDED PRECEDING: ``sum`` of the quantity,
    ``max`` of the sales."""
    WF = _wf(mod)
    T_ = _pkg(mod, "types")
    CO_ = _pkg(mod, "expr.conditional")
    B_ = _pkg(mod, "expr.base")
    col, lit = mod.col, mod.lit
    np_ = CO_.CaseWhen([(col("quantity") > lit(90),
                         B_.Literal(None, T_.DecimalType(7, 2)))],
                       col("net_profit"))
    base = sales.select("item_sk", "store_sk", "date_sk", "ticket",
                        "quantity", "ext_sales", "net_profit",
                        np_.alias("np"))
    rows = base.window(
        [WF("avg", col("quantity"), "q_avg"),
         WF("stddev_samp", col("quantity"), "q_sd"),
         WF("min", col("ext_sales"), "s_min"),
         WF("first_value", col("np"), "np_first", ignore_nulls=True),
         WF("last_value", col("np"), "np_last")],
        partition_by=["item_sk"], order_by=["date_sk", "ticket"],
        frame=("rows", 3, 3))
    week = rows.window(
        [WF("sum", col("ext_sales"), "s_7d"),
         WF("count", col("ticket"), "n_7d"),
         WF("max", col("net_profit"), "p_max_7d"),
         WF("var_pop", col("quantity"), "q_var_7d")],
        partition_by=["store_sk"], order_by=["date_sk"],
        frame=("range", 6, 0))
    return week.window(
        [WF("sum", col("quantity"), "q_run"),
         WF("max", col("ext_sales"), "s_max_run")],
        partition_by=["store_sk"], order_by=["date_sk"],
        frame="range_running")


def moving_rows_reference(ss):
    """``moving_query``'s ROWS 3 PRECEDING .. 3 FOLLOWING columns per item
    by (date, ticket) from numpy, in the rows' order: name -> (values,
    validity)."""
    n = len(ss["item_sk"])
    q = ss["quantity"].astype(np.int64)
    sales = ss["ext_sales"].astype(np.int64)
    profit = ss["net_profit"].astype(np.int64)
    np_ok = q <= 90
    out = {}
    key = ((ss["item_sk"].astype(np.int64) << 34)
           | ((ss["date_sk"].astype(np.int64) - DATE_SK0) << 22)
           | ss["ticket"].astype(np.int64))
    order = np.argsort(key)
    if (np.diff(key[order]) == 0).any():
        # a repeated (item, date, ticket): ties keep the rows' order
        order = np.argsort(key, kind="stable")
    item = ss["item_sk"][order]
    qs, ss_, nps, oks = q[order], sales[order], profit[order], np_ok[order]
    # each row's frame [fs, fe): 3 rows either side, inside its item
    idx = np.arange(n)
    new = np.ones(n + 1, np.bool_)
    new[1:n] = item[1:] != item[:-1]
    first = np.maximum.accumulate(np.where(new[:n], idx, 0))
    end = np.minimum.accumulate(np.where(new[1:], idx + 1, n)[::-1])[::-1]
    fs = np.maximum(idx - 3, first)
    fe = np.minimum(idx + 4, end)
    cnt = fe - fs

    def frame_sum(a):
        c = np.zeros(n + 1, np.int64)
        np.cumsum(a, out=c[1:])
        return c[fe] - c[fs]

    # the mean and M2 from exact integer sums: M2 = (n sum(q^2) - sum(q)^2)
    # / n
    total = frame_sum(qs)
    mean = total / cnt
    m2 = (cnt * frame_sum(qs * qs) - total * total) / cnt
    s_min = ss_.copy()
    before, after = idx - fs, fe - idx
    for d in (1, 2, 3):
        np.minimum(s_min[d:], ss_[:n - d], out=s_min[d:],
                   where=before[d:] >= d)
        np.minimum(s_min[:n - d], ss_[d:], out=s_min[:n - d],
                   where=after[:n - d] > d)
    # the frame's first row with np (IGNORE NULLS), its last row's np
    nxt = np.minimum.accumulate(np.where(oks, idx, n)[::-1])[::-1]
    at = nxt[fs]
    sorted_cols = {
        "q_avg": (mean, np.ones(n, np.bool_)),
        "q_sd": (np.sqrt(m2 / np.maximum(cnt - 1, 1)), cnt > 1),
        "s_min": (s_min, np.ones(n, np.bool_)),
        "np_first": (nps[np.minimum(at, n - 1)], at < fe),
        "np_last": (nps[fe - 1], oks[fe - 1])}
    for k, (v, ok) in sorted_cols.items():
        vv = np.empty_like(v)
        vv[order] = v
        okk = np.empty_like(ok)
        okk[order] = ok
        out[k] = (vv, okk)
    return out


@np.errstate(divide="ignore", invalid="ignore")
def moving_range_reference(ss):
    """The RANGE columns per store by date: over a grid of (store, day)
    sums and maxima, rolled over the trailing seven days and cumulated."""
    n = len(ss["item_sk"])
    q = ss["quantity"].astype(np.int64)
    sales = ss["ext_sales"].astype(np.int64)
    profit = ss["net_profit"].astype(np.int64)
    out = {}
    st = ss["store_sk"].astype(np.int64)
    day = ss["date_sk"].astype(np.int64) - DATE_SK0
    cell = st * N_DATES + day
    size = (N_STORES + 1) * N_DATES
    grid = {"n": np.bincount(cell, minlength=size),
            "s": np.bincount(cell, sales, size).astype(np.int64),
            "q": np.bincount(cell, q, size).astype(np.int64),
            "q2": np.bincount(cell, q * q, size).astype(np.int64)}
    grid = {k: v.reshape(N_STORES + 1, N_DATES) for k, v in grid.items()}
    pmax = np.full(size, np.iinfo(np.int64).min)
    np.maximum.at(pmax, cell, profit)
    smax = np.full(size, np.iinfo(np.int64).min)
    np.maximum.at(smax, cell, sales)
    pmax = pmax.reshape(N_STORES + 1, N_DATES)
    smax = smax.reshape(N_STORES + 1, N_DATES)

    def trailing(a):
        c = np.concatenate([np.zeros((a.shape[0], 1), a.dtype),
                            np.cumsum(a, 1)], 1)
        lo = np.maximum(np.arange(N_DATES) - 6, 0)
        return c[:, 1:] - c[:, lo]

    n7, s7, q7, q27 = (trailing(grid[k]) for k in ("n", "s", "q", "q2"))
    p7 = pmax.copy()
    for d in range(1, 7):
        p7[:, d:] = np.maximum(p7[:, d:], pmax[:, :-d])
    # var_pop from exact integer sums: (n sum(q^2) - sum(q)^2) / n^2
    var7 = (n7 * q27 - q7 * q7) / (n7.astype(np.float64) ** 2)
    ones = np.ones(n, np.bool_)
    out["s_7d"] = (s7[st, day], ones)
    out["n_7d"] = (n7[st, day], ones)
    out["p_max_7d"] = (p7[st, day], ones)
    out["q_var_7d"] = (var7[st, day], ones)
    out["q_run"] = (np.cumsum(grid["q"], 1)[st, day], ones)
    out["s_max_run"] = (np.maximum.accumulate(smax, 1)[st, day], ones)
    return out


#: moving_query's window columns and how each compares: exactly, or as
#: doubles to ``WINDOW_RTOL``
MOVING_COLS = (("q_avg", "f"), ("q_sd", "f"), ("s_min", "i"),
               ("np_first", "i"), ("np_last", "i"), ("s_7d", "i"),
               ("n_7d", "i"), ("p_max_7d", "i"), ("q_var_7d", "f"),
               ("q_run", "i"), ("s_max_run", "i"))


def _host_values(c):
    """A host column's (values, validity): decimals as their unscaled
    integers, DATEs as days."""
    return np.asarray(c.data), np.asarray(c.validity, np.bool_)


def _check_columns(cols, names, want, kinds, input_cols=None):
    """Host columns (``names``) against ``want`` (name -> (values,
    validity)); ``input_cols`` (name -> array) checks the passed-through
    columns.  -> None, or a complaint naming the first column that
    differs."""
    by = dict(zip(names, cols))
    for name, arr in (input_cols or {}).items():
        v, _ = _host_values(by[name])
        if not np.array_equal(v.astype(np.int64), arr.astype(np.int64)):
            return f"the passed-through {name} differs"
    for name, kind in kinds:
        v, ok = _host_values(by[name])
        wv, wok = want[name]
        if not np.array_equal(ok, wok):
            return (f"{name}: {int((ok != wok).sum())} rows differ in "
                    "validity")
        if kind == "f":
            bad = _close(v[ok], np.asarray(wv)[ok])
        else:
            bad = int((v[ok].astype(np.int64)
                       != np.asarray(wv)[ok].astype(np.int64)).sum())
        if bad:
            return f"{name}: {bad} rows differ"
    return None


def stats_query(sales, mod):
    """Per item (100,000 groups): the quantity's skewness, the profit's
    kurtosis, their correlation and covariances, and the profit's linear
    regression on the quantity."""
    return sales.group_by("item_sk").agg(
        mod.skewness_("quantity", "q_skew"),
        mod.kurtosis_("net_profit", "p_kurt"),
        mod.corr_("quantity", "net_profit", "corr"),
        mod.covar_samp_("quantity", "net_profit", "covar_samp"),
        mod.covar_pop_("quantity", "net_profit", "covar_pop"),
        mod.regr_slope_("net_profit", "quantity", "slope"),
        mod.regr_intercept_("net_profit", "quantity", "intercept"),
        mod.regr_r2_("net_profit", "quantity", "r2"),
        mod.regr_count_("net_profit", "quantity", "n"))


@np.errstate(divide="ignore", invalid="ignore")
def stats_reference(ss):
    """``stats_query`` from numpy, two passes per item: item -> (values
    in the query's order, each one's scale: the size of the terms it was
    computed from, for the comparison)."""
    item = ss["item_sk"].astype(np.int64)
    size = int(item.max()) + 1
    x = ss["quantity"].astype(np.float64)
    y = ss["net_profit"].astype(np.float64) / 100
    n = np.bincount(item, minlength=size).astype(np.float64)
    has = n > 0
    nn = np.where(has, n, 1.0)
    mx = np.bincount(item, x, size) / nn
    my = np.bincount(item, y, size) / nn
    dx = x - mx[item]
    dy = y - my[item]
    mom = {k: np.bincount(item, v, size) for k, v in (
        ("xx", dx * dx), ("yy", dy * dy), ("xy", dx * dy),
        ("x3", dx ** 3), ("y4", dy ** 4), ("ax3", np.abs(dx) ** 3),
        ("axy", np.abs(dx * dy)))}
    xx, yy, xy = mom["xx"], mom["yy"], mom["xy"]
    slope = xy / np.where(xx != 0, xx, 1.0)
    cols = {
        "q_skew": (np.sqrt(n) * mom["x3"] / np.where(xx > 0, xx, 1.0) ** 1.5,
                   np.sqrt(n) * mom["ax3"] / np.where(xx > 0, xx, 1.0)
                   ** 1.5),
        "p_kurt": (n * mom["y4"] / np.where(yy > 0, yy, 1.0) ** 2 - 3.0,
                   n * mom["y4"] / np.where(yy > 0, yy, 1.0) ** 2),
        "corr": (xy / np.sqrt(xx * yy), mom["axy"] / np.sqrt(xx * yy)),
        "covar_samp": (xy / np.maximum(n - 1, 1), mom["axy"] / nn),
        "covar_pop": (xy / nn, mom["axy"] / nn),
        "slope": (slope, mom["axy"] / np.where(xx != 0, xx, 1.0)),
        "intercept": (my - slope * mx,
                      np.abs(my) + np.abs(slope * mx)
                      + mom["axy"] / np.where(xx != 0, xx, 1.0) * np.abs(mx)),
        "r2": (np.where(yy == 0, 1.0, xy * xy / (xx * yy)),
               2 * mom["axy"] * np.abs(xy) / np.where(xx * yy != 0,
                                                      xx * yy, 1.0)),
    }
    return {"items": np.nonzero(has)[0], "n": n.astype(np.int64),
            "cols": cols, "xx": xx, "yy": yy}


STATS_COLS = ("q_skew", "p_kurt", "corr", "covar_samp", "covar_pop",
              "slope", "intercept", "r2")


def stats_check(cols, want):
    """-> None when the port's host columns (item, the eight doubles,
    regr_count) equal the reference's: each double within
    ``WINDOW_RTOL`` of max(|value|, its terms' scale)."""
    item, ok = _host_values(cols[0])
    order = np.argsort(item)
    item = item[order]
    if not np.array_equal(item, want["items"]):
        return "the item keys differ"
    n = want["n"][item]
    xx, yy = want["xx"][item], want["yy"][item]
    valid_want = {"q_skew": xx != 0, "p_kurt": yy != 0, "corr": n > 0,
                  "covar_samp": n > 1, "covar_pop": n > 0,
                  "slope": xx != 0, "intercept": xx != 0, "r2": xx != 0}
    for i, name in enumerate(STATS_COLS, start=1):
        v, ok = _host_values(cols[i])
        v, ok = v[order], ok[order]
        if not np.array_equal(ok, valid_want[name]):
            return f"{name}: the validity differs"
        val, scale = want["cols"][name]
        bad = _close(v[ok], val[item][ok], scale[item][ok])
        if bad:
            return f"{name}: {bad} groups differ"
    cnt, _ = _host_values(cols[9])
    if not np.array_equal(cnt[order], n):
        return "regr_count differs"
    return None


def history_query(orders, mod):
    """A customer's order history: per customer by (date, key)
    ``row_number``, the previous order's date, the next order's key (-1
    for the last); per customer by date over RANGE 90 PRECEDING to
    CURRENT ROW, the count of orders and the earliest date in the trailing
    90 days."""
    WF = _wf(mod)
    col = mod.col
    ordered = orders.window(
        [WF("row_number", None, "rn"),
         WF("lag", col("o_orderdate"), "prev_date"),
         WF("lead", col("o_orderkey"), "next_key", default=-1)],
        partition_by=["o_custkey"], order_by=["o_orderdate", "o_orderkey"])
    return ordered.window(
        [WF("count", col("o_orderkey"), "n_90d"),
         WF("min", col("o_orderdate"), "first_90d")],
        partition_by=["o_custkey"], order_by=["o_orderdate"],
        frame=("range", 90, 0))


def history_reference(orders):
    """``history_query``'s window columns from numpy, in the rows'
    order."""
    cust = orders["o_custkey"].astype(np.int64)
    date = orders["o_orderdate"].astype(np.int64)
    okey = orders["o_orderkey"].astype(np.int64)
    n = len(cust)
    # dates offset by 128 so that date - 90 stays inside its customer
    dkey = (cust << 13) | (date - 8035 + 128)
    order = np.lexsort((okey, dkey))
    ck = dkey[order]
    idx = np.arange(n)
    new = np.ones(n, np.bool_)
    new[1:] = cust[order][1:] != cust[order][:-1]
    first = np.maximum.accumulate(np.where(new, idx, 0))
    has_next = np.append(~new[1:], False)
    ds = date[order]
    lo = np.searchsorted(ck, ck - 90, "left")
    hi = np.searchsorted(ck, ck, "right")
    sorted_cols = {
        "rn": (idx - first + 1, np.ones(n, np.bool_)),
        "prev_date": (np.roll(ds, 1), ~new),
        "next_key": (np.where(has_next, np.roll(okey[order], -1), -1),
                     np.ones(n, np.bool_)),
        "n_90d": (hi - lo, np.ones(n, np.bool_)),
        "first_90d": (ds[lo], np.ones(n, np.bool_))}
    out = {}
    for k, (v, ok) in sorted_cols.items():
        vv = np.empty_like(v)
        vv[order] = v
        okk = np.empty_like(ok)
        okk[order] = ok
        out[k] = (vv, okk)
    return out


HISTORY_COLS = (("rn", "i"), ("prev_date", "i"), ("next_key", "i"),
                ("n_90d", "i"), ("first_90d", "i"))


def phones_query(customer, mod):
    """Phones per nation by balance, highest first, with ``ph`` the phone
    of a customer whose balance is not negative (else null): the previous
    customer's phone ('none' for the first), ``ph`` two customers on, the
    first ``ph`` so far (IGNORE NULLS) and the current one (ROWS
    UNBOUNDED PRECEDING); the greatest phone so far, ties of balance
    included (RANGE UNBOUNDED PRECEDING); the nation's least ``ph``."""
    WF = _wf(mod)
    T_ = _pkg(mod, "types")
    CO_ = _pkg(mod, "expr.conditional")
    B_ = _pkg(mod, "expr.base")
    col, lit = mod.col, mod.lit
    ph = CO_.CaseWhen([(col("c_acctbal") < lit(Decimal("0.00")),
                        B_.Literal(None, T_.STRING))], col("c_phone"))
    desc = [(col("c_acctbal"), mod.SortSpec(ascending=False,
                                            nulls_first=False))]
    base = customer.select("c_custkey", "c_nationkey", "c_phone",
                           "c_acctbal", ph.alias("ph"))
    running = base.window(
        [WF("lag", col("c_phone"), "prev_phone", default="none"),
         WF("lead", col("ph"), "ph_2on", offset=2),
         WF("first_value", col("ph"), "ph_first", ignore_nulls=True),
         WF("last_value", col("ph"), "ph_last")],
        partition_by=["c_nationkey"], order_by=desc)
    peers = running.window([WF("max", col("c_phone"), "phone_max")],
                           partition_by=["c_nationkey"], order_by=desc,
                           frame="range_running")
    return peers.window([WF("min", col("ph"), "ph_min")],
                        partition_by=["c_nationkey"], order_by=desc,
                        frame="unbounded")


_PHONE_DIGITS = (0, 1, 3, 4, 5, 7, 8, 9, 11, 12, 13, 14)


def phone_numbers(chars) -> np.ndarray:
    """'NN-DDD-DDD-DDDD' char rows -> their 12 digits as an int64 (the
    same order as the strings')."""
    d = chars[:, list(_PHONE_DIGITS)].astype(np.int64) - ord("0")
    return d @ (10 ** np.arange(11, -1, -1, dtype=np.int64))


def phones_reference(customer):
    """``phones_query``'s window columns from numpy, in the rows' order;
    phones as ``phone_numbers``, 'none' as -1."""
    nation = customer["c_nationkey"].astype(np.int64)
    bal = customer["c_acctbal"].astype(np.int64)
    chars, _ = customer["c_phone"].rows(0, len(nation))
    phone = phone_numbers(chars)
    n = len(nation)
    order = np.lexsort((-bal, nation))
    ns, bs, ps = nation[order], bal[order], phone[order]
    ok = bs >= 0
    idx = np.arange(n)
    new = np.ones(n, np.bool_)
    new[1:] = ns[1:] != ns[:-1]
    seg = np.cumsum(new) - 1
    first = np.maximum.accumulate(np.where(new, idx, 0))
    j2 = np.minimum(idx + 2, n - 1)
    lead_in = (idx + 2 < n) & (seg[j2] == seg)
    nxt = np.minimum.accumulate(np.where(ok, idx, n)[::-1])[::-1]
    at = nxt[first]
    peer_new = new.copy()
    peer_new[1:] |= bs[1:] != bs[:-1]
    peer_last = np.append(np.nonzero(peer_new)[0][1:], n) - 1
    peer_last = peer_last[np.cumsum(peer_new) - 1]
    running_max = np.maximum.accumulate(ps + seg * 10 ** 13) - seg * 10 ** 13
    big = np.iinfo(np.int64).max
    mins = np.full(seg[-1] + 1 if n else 0, big)
    np.minimum.at(mins, seg[ok], ps[ok])
    sorted_cols = {
        "prev_phone": (np.where(new, -1, np.roll(ps, 1)),
                       np.ones(n, np.bool_)),
        "ph_2on": (ps[j2], lead_in & ok[j2]),
        "ph_first": (ps[np.minimum(at, n - 1)], at <= idx),
        "ph_last": (ps, ok),
        "phone_max": (running_max[peer_last], np.ones(n, np.bool_)),
        "ph_min": (mins[seg], mins[seg] != big)}
    out = {}
    for k, (v, vok) in sorted_cols.items():
        vv = np.empty_like(v)
        vv[order] = v
        okk = np.empty_like(vok)
        okk[order] = vok
        out[k] = (vv, okk)
    return out


PHONE_COLS = ("prev_phone", "ph_2on", "ph_first", "ph_last", "phone_max",
              "ph_min")


def phones_check(cols, names, want):
    """-> None when each string window column, read as
    ``phone_numbers`` ('none' as -1), is the reference's."""
    by = dict(zip(names, cols))
    for name in PHONE_COLS:
        c = by[name]
        chars = np.asarray(c.chars)
        lens = np.asarray(c.lengths)
        ok = np.asarray(c.validity, np.bool_)
        wv, wok = want[name]
        if not np.array_equal(ok, wok):
            return f"{name}: {int((ok != wok).sum())} rows differ in validity"
        none = ok & (lens == 4)
        if name == "prev_phone" and not (chars[none, :4] == np.frombuffer(
                b"none", np.uint8)).all():
            return "prev_phone: a short value is not 'none'"
        full = ok & (lens == 15)
        if not (full | none == ok).all():
            return f"{name}: a value of an unexpected length"
        got = np.full(len(ok), -1, np.int64)
        if full.any():
            got[full] = phone_numbers(chars[full, :15])
        if not np.array_equal(got[ok], np.asarray(wv)[ok]):
            return f"{name}: {int((got[ok] != wv[ok]).sum())} rows differ"
    return None


def run_timed_query(label: str, q, check, plan, n: int, unit: str,
                    want_k1: int, smi: str, host: bool = True,
                    probe=None, timed: int = 2):
    """One of phases 32-36's queries: the plan the reference's (its
    window-chain and join-aggregate fusions aside), one untimed collect
    under the profiler (the idle share; inside ``probe(label)``, a
    context whose value the result keeps as ``probe``), ``timed`` timed
    collects, each held by ``check`` (the rows, or with ``host`` the host
    columns: -> None or a complaint), K1 once a dictionary chunk, the
    counts read around the last."""
    import contextlib

    import torch

    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.memory.spill import peek_spill_framework
    from spark_rapids_tpu_torch.pallas import decode

    check_plan(q, plan, label)
    log(f"{label} plan:\n" + q.explain())
    collect = q.collect_host if host else q.collect
    with (probe(label) if probe else contextlib.nullcontext()) as probed:
        profile_collect(collect, None, f"{label} parquet", key=check)
    secs = []
    for _ in range(timed):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode.unpack_launches = 0
        snap = PC.snapshot()
        t0 = time.perf_counter()
        got = collect()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = decode.unpack_launches
        d = PC.since(snap)
        peak = torch.cuda.max_memory_allocated()
        bad = check(got)
        if bad:
            fail(f"{label}, timed run {len(secs)}: {bad}")
    _check_launches(label, launches, want_k1)
    used = peek_spill_framework().metrics()["deviceUsedPeakBytes"]
    rows = len(got) if not host else (got[0].validity.shape[0]
                                      if got else 0)
    log(f"{label}: {rows} rows == numpy reference; {n} {unit} "
        f"in {', '.join(f'{t:.3f}' for t in secs)} s = "
        f"{n / min(secs):.0f} rows/s at best [{smi}]")
    log(f"{label} counters: unpack_launches={launches} == {want_k1} "
        f"dictionary chunks; bytes_h2d={d['bytes_h2d']} bytes_d2h="
        f"{d['bytes_d2h']} host_syncs={d['host_syncs']} "
        f"device_used_peak={used} max_memory_allocated={peak} [{smi}]")
    return {"seconds": secs, "launches": launches, "peak": peak,
            "device_used_peak": used, "bytes_d2h": d["bytes_d2h"],
            "probe": probed}


def _start(jobs):
    """Each job in a thread of its own: name -> future."""
    pool = ThreadPoolExecutor(len(jobs))
    futures = {k: pool.submit(fn) for k, fn in jobs.items()}
    pool.shutdown(wait=False)
    return futures


def store_references(ss, dd):
    """Phase 32's numpy references, each in a thread of its own (numpy
    leaves the interpreter lock in its loops, so they run beside the
    phase's work on the card): name -> future."""
    return _start({"q47": lambda: q47_reference(ss, dd),
                   "moving_rows": lambda: moving_rows_reference(ss),
                   "moving_range": lambda: moving_range_reference(ss),
                   "stats": lambda: stats_reference(ss)})


def tpch_references(tables):
    """Phase 33's numpy references over ``window_tables``, each in a
    thread of its own: name -> future."""
    return _start({"orders_history": lambda: history_reference(
        tables["orders"]), "customer_phones": lambda: phones_reference(
        tables["customer"])})


def _reference(refs, *names):
    """The references ``names`` (merged), waited for; the wait printed."""
    t0 = time.perf_counter()
    out = {}
    for name in names:
        got = refs[name].result()
        out = {**out, **got} if len(names) > 1 else got
    log(f"{'+'.join(names)} reference ready after a wait of "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def _read(s, paths, schema, cols):
    from spark_rapids_tpu_torch import types as T

    return s.read.schema(T.StructType(
        [f for f in schema.fields if f.name in cols])).parquet(*paths)


def run_store_windows(refs, ss, ss_paths, dd_path, device, smi: str):
    """Phase 32 over phases 9-11's store_sales files and date_dim: K1
    against its plain version on item_sk's index tables; then Q47's shape
    (a), the per-item statistics (c) and the moving frames over every row
    (b), last, as their reference takes longest; each exact against numpy
    (``refs``: ``store_references``).  -> each query's launches and
    seconds."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    table, _, dsch = qa_schemas(T)
    n = len(ss["item_sk"])
    item_sch = T.StructType([f for f in table.fields if f.name == "item_sk"])
    k1_err, widths = check_k1_tables([ss_paths[0]], lambda p: item_sch,
                                     device, smi, "store_sales' item_sk")
    s = S.TpuSession(QA_CONF, device=device)
    out = {"k1_err": k1_err}

    def chunks(cols):
        return dict_chunks(ss_paths, T.StructType(
            [f for f in table.fields if f.name in cols]))

    want = _reference(refs, "q47")
    log("q47: the monthly sums are cast to DOUBLE before the window avg (a "
        "departure from TPC-DS Q47: the reference tags a window avg over a "
        "decimal off the device, and the port has no CPU window)")
    q = q47_query(_read(s, ss_paths, table, Q47_READS),
                  s.read.schema(dsch).parquet(dd_path), S)
    out["q47"] = run_timed_query(
        "q47", q, lambda rows: q47_check(rows, want), Q47_PLAN, n,
        "store_sales rows", chunks(Q47_READS) + dict_chunks([dd_path], dsch),
        smi, host=False)
    if len(want["item"]):
        log("q47: first row " + str({k: v[0] for k, v in want.items()}))

    want = _reference(refs, "stats")
    q = stats_query(_read(s, ss_paths, table, STATS_READS), S)
    out["stats"] = run_timed_query(
        "stats", q, lambda cols: stats_check(cols, want), STATS_PLAN, n,
        "store_sales rows", chunks(STATS_READS), smi)

    want = _reference(refs, "moving_rows", "moving_range")
    q = moving_query(_read(s, ss_paths, table, table.field_names()), S)
    names = q.schema.field_names()
    passed = {k: ss[k] for k in ("item_sk", "date_sk", "ticket")}
    out["moving"] = run_timed_query(
        "moving", q,
        lambda cols: _check_columns(cols, names, want, MOVING_COLS, passed),
        MOVING_PLAN, n, "store_sales rows", chunks(table.field_names()), smi)
    del want
    return out


def window_tables(customer, orders):
    """The columns phase 33's references read, kept when phase 27's data
    goes."""
    return {"orders": {k: orders[k] for k in HISTORY_READS["orders"]},
            "customer": {k: customer[k] for k in ("c_nationkey", "c_phone",
                                                  "c_acctbal")}}


def run_tpch_windows(refs, paths, tables, device, smi: str):
    """Phase 33 over phase 27's orders and customer files: the order
    histories (d) and the phones per nation (e), each exact against
    numpy (``refs``: ``tpch_references``).  -> each query's launches and
    seconds."""
    import spark_rapids_tpu_torch.session as S

    s = S.TpuSession(Q12_CONF, device=device)
    out = {}
    orders, customer = tables["orders"], tables["customer"]
    want = _reference(refs, "orders_history")
    q = history_query(tpch_frames(paths, s, HISTORY_READS)["orders"], S)
    names = q.schema.field_names()
    out["orders_history"] = run_timed_query(
        "orders_history", q,
        lambda cols: _check_columns(cols, names, want, HISTORY_COLS,
                                    {"o_orderkey": orders["o_orderkey"]}),
        HISTORY_PLAN, len(orders["o_orderkey"]), "orders",
        query_chunks(paths, HISTORY_READS), smi)
    want = _reference(refs, "customer_phones")
    q = phones_query(tpch_frames(paths, s, PHONES_READS)["customer"], S)
    names = q.schema.field_names()
    out["customer_phones"] = run_timed_query(
        "customer_phones", q, lambda cols: phones_check(cols, names, want),
        PHONES_PLAN, len(customer["c_nationkey"]), "customers",
        query_chunks(paths, PHONES_READS), smi)
    return out


# ---------------------------------------------------------------------------
# phase 34: array columns and the rest of the aggregates
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_XP1, _XP2, _XP3, _XP4, _XP5 = (np.uint64(p) for p in (
    0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9,
    0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5))


def _np_rotl(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _np_fmix(h):
    h = h ^ (h >> np.uint64(33))
    h = h * _XP2
    h = h ^ (h >> np.uint64(29))
    h = h * _XP3
    return h ^ (h >> np.uint64(32))


def _np_round(acc, k):
    return _np_rotl(acc + k * _XP2, 31) * _XP1


def _np_xxh_int(u32, seed):
    h = (seed + (_XP5 + np.uint64(4))) ^ (u32 * _XP1)
    return _np_fmix(_np_rotl(h, 23) * _XP2 + _XP3)


def _np_xxh_long(v, seed):
    h = (seed + (_XP5 + np.uint64(8))) ^ _np_round(np.zeros_like(v), v)
    return _np_fmix(_np_rotl(h, 27) * _XP1 + _XP4)


def _np_le(ch, base, nbytes: int):
    """Little-endian words of ``nbytes`` bytes of each row of the uint64
    byte matrix ``ch`` from ``base`` (positions clipped to the width)."""
    rows = np.arange(ch.shape[0])
    v = np.zeros(ch.shape[0], np.uint64)
    for t in range(nbytes):
        v |= ch[rows, np.clip(base + t, 0, ch.shape[1] - 1)] << np.uint64(
            8 * t)
    return v


def _np_xxh_string(chars, lengths, seed):
    """XXH64.hashUnsafeBytes of each row's first ``lengths`` bytes."""
    ch = chars.astype(np.uint64)
    ln = lengths.astype(np.int64)
    nst = ln // 32
    acc = [seed + _XP1 + _XP2, seed + _XP2, seed.copy(), seed - _XP1]
    for b in range(ch.shape[1] // 32):
        for j in range(4):
            k = np.zeros(len(ln), np.uint64)
            for t in range(8):
                k |= ch[:, 32 * b + 8 * j + t] << np.uint64(8 * t)
            acc[j] = np.where(b < nst, _np_round(acc[j], k), acc[j])
    merged = (_np_rotl(acc[0], 1) + _np_rotl(acc[1], 7)
              + _np_rotl(acc[2], 12) + _np_rotl(acc[3], 18))
    for v in acc:
        merged = (merged ^ _np_round(np.zeros_like(v), v)) * _XP1 + _XP4
    h = np.where(ln >= 32, merged, seed + _XP5) + ln.astype(np.uint64)
    if ch.shape[1] == 0:
        return _np_fmix(h)
    base = nst * 32
    rem = ln - base
    for j in range(3):
        k = _np_le(ch, base + 8 * j, 8)
        nh = _np_rotl(h ^ _np_round(np.zeros_like(k), k), 27) * _XP1 + _XP4
        h = np.where((j + 1) * 8 <= rem, nh, h)
    o4 = base + (rem // 8) * 8
    has4 = ln - o4 >= 4
    h = np.where(has4, _np_rotl(h ^ (_np_le(ch, o4, 4) * _XP1), 23) * _XP2
                 + _XP3, h)
    ob = o4 + np.where(has4, 4, 0)
    for t in range(3):
        idx = ob + t
        h = np.where(idx < ln, _np_rotl(h ^ (_np_le(ch, idx, 1) * _XP5), 11)
                     * _XP1, h)
    return _np_fmix(h)


def np_xxhash64(cols, seed: int = 42) -> np.ndarray:
    """Spark's xxhash64 of ``cols`` chained from ``seed``, in numpy
    uint64 (the twin of ``ops/hashing.py::xxhash64_columns``): each column
    a (kind, data, validity) triple, kind ``int`` (int, date, byte,
    short, bool), ``long`` (long, decimal of 18 digits or fewer),
    ``float``, ``double`` or ``string`` (data (chars, lengths)); a null
    passes the seed.  -> int64."""
    n = len(cols[0][2])
    h = np.full(n, seed & _M64, np.uint64)
    for kind, data, valid in cols:
        if kind == "string":
            hc = _np_xxh_string(*data, h)
        elif kind == "float":
            f = np.asarray(data, np.float32)
            f = np.where(f == 0, np.float32(0), f)
            bits = f.view(np.uint32).astype(np.uint64)
            hc = _np_xxh_int(np.where(np.isnan(f), np.uint64(0x7FC00000),
                                      bits), h)
        elif kind == "double":
            d = np.where(np.asarray(data, np.float64) == 0, 0.0, data)
            bits = np.where(np.isnan(d), np.uint64(0x7FF8000000000000),
                            d.view(np.uint64))
            hc = _np_xxh_long(bits, h)
        elif kind == "long":
            hc = _np_xxh_long(np.asarray(data, np.int64).view(np.uint64), h)
        else:
            hc = _np_xxh_int(np.asarray(data, np.int64).view(np.uint64)
                             & np.uint64(0xFFFFFFFF), h)
        h = np.where(valid, hc, h)
    return h.view(np.int64)


def np_clz64(x) -> np.ndarray:
    """Leading zero bits of uint64 words (64 for 0)."""
    n = np.zeros(len(x), np.int64)
    for s in (32, 16, 8, 4, 2, 1):
        z = (x >> np.uint64(64 - s)) == 0
        n += np.where(z, s, 0)
        x = np.where(z, x << np.uint64(s), x)
    return n + (x == 0)


HLL_P = 9


def np_hll_slots(h):
    """(register, rank) of each int64 xxhash64 (seed 42): the top p bits,
    and ``min(clz(h << p) + 1, 65 - p)``."""
    u = h.view(np.uint64)
    return ((u >> np.uint64(64 - HLL_P)).astype(np.int64),
            np.minimum(np_clz64(u << np.uint64(HLL_P)) + 1, 65 - HLL_P))


def np_hll_registers(register, rank, group, ngroups: int) -> np.ndarray:
    """HyperLogLog registers (``ngroups`` x 2^p) of the valid values'
    ``np_hll_slots``, ``group`` each one's group: each register's largest
    rank, read from a table of the ranks seen."""
    m = 1 << HLL_P
    seen = np.zeros((ngroups * m, 64), np.bool_)
    seen[group * m + register, rank] = True
    return (seen * np.arange(64)).max(axis=1).reshape(ngroups, m)


def np_hll_estimate(regs) -> np.ndarray:
    """The estimate of each row of registers: linear counting while the
    raw estimate is at most 2.5 m and a register is 0, else raw; rounded
    half to even."""
    m = regs.shape[1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    inv = np.ldexp(1.0, -regs.astype(np.int32)).sum(axis=1)
    raw = np.full(len(inv), alpha * m * m) / inv
    zeros = (regs == 0).sum(axis=1).astype(np.float64)
    lin = m * np.log(np.full(len(zeros), float(m)) / np.maximum(zeros, 1.0))
    est = np.where((raw <= 2.5 * m) & (zeros > 0), lin, raw)
    return np.round(est).astype(np.int64)


def _bloom_k(num_items: int, num_bits: int) -> int:
    return max(1, round(num_bits / num_items * np.log(2.0)))


def _bloom_bits(h1, h2, num_items: int, num_bits: int):
    for j in range(_bloom_k(num_items, num_bits)):
        yield np.remainder(h1 + np.int64(j) * h2, num_bits)


def np_bloom_words(h1, h2, num_items: int, num_bits: int) -> np.ndarray:
    """A bloom filter's int64 words over the values whose xxhash64s under
    seeds 42 and 77 are ``h1`` and ``h2``: bit ``b`` at bit ``b % 64`` of
    word ``b // 64`` (``np.packbits``, little bit order)."""
    bits = np.zeros(num_bits, np.bool_)
    for b in _bloom_bits(h1, h2, num_items, num_bits):
        bits[b] = True
    return np.packbits(bits.reshape(-1, 64), axis=1,
                       bitorder="little").view("<i8").reshape(-1)


def np_might_contain(words, h1, h2, num_items: int, num_bits: int):
    hit = np.ones(len(h1), np.bool_)
    for b in _bloom_bits(h1, h2, num_items, num_bits):
        hit &= ((words[b // 64] >> (b % 64)) & 1) == 1
    return hit


PCT_READS = ("store_sk", "ticket", "quantity", "ext_sales", "net_profit")
REACH_READS = ("store_sk", "item_sk", "ticket")
BLOOM_ITEMS, BLOOM_BITS = 600_000, 4_194_304
SETS_READS = {"orders": ("o_custkey", "o_orderdate")}
BOUNDS_READS = {"customer": ("c_nationkey", "c_phone")}
_READER = "TpuAdaptiveShuffleReader(target=1073741824B small=4194304B)"


def _single_phase_plan(agg: str):
    return [agg, "  " + _READER, "    TpuShuffleExchange SinglePartition",
            "      <scan>"]


PCT_PLAN = _single_phase_plan(
    "TpuHashAggregate(Complete) keys=[store_sk] aggs=[median(net_profit) "
    "AS med_profit, percentile(ext_sales) AS p90_sales, approx_percentile("
    "quantity) AS ap50_qty, min(quantity) AS min_qty, max(ext_sales) AS "
    "max_sales]")
PCT_GLOBAL_PLAN = _single_phase_plan(
    "TpuHashAggregate(Complete) keys=[] aggs=[median(net_profit) AS "
    "med_profit, approx_count_distinct(ticket) AS tickets]")
#: the two-phase HLL collapsed on one device (the reference keeps its
#: exchange of array<int> registers a CPU stage: ROADMAP, "Differences
#: that bind the port")
REACH_PLAN = [
    "TpuHashAggregate(Complete) keys=[store_sk] aggs=[approx_count_distinct"
    "(ticket) AS tickets, approx_count_distinct(item_sk) AS items]",
    "  <scan>"]
REACH_GLOBAL_PLAN = [
    "TpuHashAggregate(Complete) keys=[] aggs=[approx_count_distinct("
    "item_sk) AS items]", "  <scan>"]
SETS_PLAN = _single_phase_plan(
    "TpuHashAggregate(Complete) keys=[o_custkey] aggs=[collect_list("
    "o_orderdate) AS dates, collect_set(year(o_orderdate)) AS years]")
BOUNDS_PLAN = [
    "TpuHashAggregate(Complete) keys=[c_nationkey] aggs=[min(c_phone) AS "
    "phone_min, max(c_phone) AS phone_max]", "  <scan>"]
BOUNDS_GLOBAL_PLAN = [
    "TpuHashAggregate(Complete) keys=[] aggs=[min(c_phone) AS phone_min, "
    "max(c_phone) AS phone_max]", "  <scan>"]


def bloom_plan(broadcast: bool):
    """The bloom filter join's plan before its collect: the probe (a
    one-row cross join with the filter, might_contain, the filter) joined
    to the quarter's orders, broadcast at planning or adaptive."""
    quarter = (f"TpuFilter (((o_orderdate >= {Q4_QUARTER[0]}) AND "
               f"(o_orderdate < {Q4_QUARTER[1]})))")
    probe = [
        "TpuStageExec[Project+Filter]",
        "  TpuCartesianProductExec",
        "    <scan>",
        "    TpuHashAggregate(Complete) keys=[] aggs=[bloom_filter_agg("
        "o_orderkey) AS bf]",
        "      " + _READER,
        "        TpuShuffleExchange SinglePartition",
        "          " + quarter,
        "            <scan>"]
    orders = ["TpuStageExec[FilterProject]", "  <scan>"]
    head = ["TpuSort [o_orderpriority ASC]",
            "  TpuHashAggregate(Complete) keys=[o_orderpriority] "
            "aggs=[count_star(*) AS lines]"]
    if broadcast:
        return head + [
            "    TpuBroadcastHashJoinExec Inner [l_orderkey=l_orderkey]"] + [
            "      " + ln for ln in probe] + [
            "      TpuBroadcastExchangeExec"] + [
            "        " + ln for ln in orders]
    side = ["      " + _READER, "        TpuShuffleExchange SinglePartition"]
    return head + [
        "    TpuAdaptiveJoin(threshold=10485760)[TpuShuffledSymmetricHash"
        "JoinExec Inner [l_orderkey=l_orderkey]]"] + side + [
        "          " + ln for ln in probe] + side + [
        "          " + ln for ln in orders]


def pct_queries(sales, mod):
    """Per store: the median profit, the 90th percentile of the sales,
    the approximate median quantity, the least quantity and the largest
    sale; over every row: the median profit and the distinct tickets
    (the HLL single-phase beside the median)."""
    return (sales.group_by("store_sk").agg(
        mod.median_("net_profit", "med_profit"),
        mod.percentile_("ext_sales", 0.9, "p90_sales"),
        mod.approx_percentile_("quantity", 0.5, name="ap50_qty"),
        mod.min_("quantity", "min_qty"), mod.max_("ext_sales", "max_sales")),
        sales.agg(mod.median_("net_profit", "med_profit"),
                  mod.approx_count_distinct_("ticket", "tickets")))


def reach_queries(sales, mod):
    """Distinct tickets and items per store, and distinct items."""
    return (sales.group_by("store_sk").agg(
        mod.approx_count_distinct_("ticket", "tickets"),
        mod.approx_count_distinct_("item_sk", "items")),
        sales.agg(mod.approx_count_distinct_("item_sk", "items")))


def bloom_queries(orders, lineitem, mod):
    """The runtime bloom filter join: ``bf`` over the keys of the orders
    of 1993's third quarter; the lines whose key might be in it (a
    one-row cross join, ``might_contain``, the filter); those lines
    joined to the quarter's orders and counted by priority.  -> (the
    filter, the join, the join's right side)."""
    import datetime as dt

    col, lit = mod.col, mod.lit
    o_q = orders.filter((col("o_orderdate") >= lit(dt.date(1993, 7, 1)))
                        & (col("o_orderdate") < lit(dt.date(1993, 10, 1))))
    bf = o_q.agg(mod.bloom_filter_agg_("o_orderkey", "bf", BLOOM_ITEMS,
                                       BLOOM_BITS))
    probe = bloom_probe(lineitem, bf, mod)
    right = o_q.select(col("o_orderkey").alias("l_orderkey"),
                       "o_orderpriority")
    join = (probe.join(right, "l_orderkey")
            .group_by("o_orderpriority").agg(mod.count_(None, "lines"))
            .order_by("o_orderpriority"))
    return bf, join, right


def bloom_probe(lineitem, bf, mod):
    """The lines whose key might be in the one-row filter ``bf``: a cross
    join, ``might_contain``, the filter."""
    H = importlib.import_module(
        mod.__name__.rsplit(".", 1)[0] + ".expr.hashexprs")
    col = mod.col
    return lineitem.cross_join(bf).select(
        "l_orderkey", H.BloomFilterMightContain(
            col("bf"), col("l_orderkey"), BLOOM_ITEMS,
            BLOOM_BITS).alias("mc")).filter(col("mc"))


def sets_query(orders, mod):
    """Each customer's order dates (a list) and order years (a set)."""
    Year = importlib.import_module(
        mod.__name__.rsplit(".", 1)[0] + ".expr.datetime").Year
    return orders.group_by("o_custkey").agg(
        mod.collect_list_("o_orderdate", "dates"),
        mod.collect_set_(Year(mod.col("o_orderdate")), "years"))


def bounds_queries(customer, mod):
    """The least and greatest phone per nation, and over every customer."""
    aggs = (mod.min_("c_phone", "phone_min"), mod.max_("c_phone", "phone_max"))
    return customer.group_by("c_nationkey").agg(*aggs), customer.agg(*aggs)


def _np_percentile(group, values, ngroups: int, pct: float, scale: float):
    """Each group's interpolated percentile of the int64 ``values``,
    ``(v_lo (1 - frac) + v_hi frac) scale``, and its least and greatest
    value: the values counted per group over their range, each rank's
    value found in the running counts by a binary search."""
    lo_v = int(values.min())
    span = int(values.max()) - lo_v + 1
    cum = np.bincount(group * span + (values - lo_v),
                      minlength=ngroups * span).reshape(
                          ngroups, span).cumsum(axis=1)
    n = cum[:, -1]

    def at(rank):
        return np.array([np.searchsorted(cum[g], rank[g], side="right")
                         for g in range(ngroups)], np.int64) + lo_v

    r = pct * (np.maximum(n, 1) - 1).astype(np.float64)
    lo = np.floor(r).astype(np.int64)
    frac = r - lo.astype(np.float64)
    v_lo, v_hi = at(lo), at(np.ceil(r).astype(np.int64))
    res = (v_lo.astype(np.float64) * (1.0 - frac)
           + v_hi.astype(np.float64) * frac) * scale
    return res, v_lo, at(np.zeros(ngroups, np.int64)), at(n - 1)


def store_agg_references(ss):
    """store_pct's and store_reach's numpy references: per store (1..40)
    and over every row, with the xxhash64s (of each distinct value,
    gathered), registers and exact distinct counts behind the HLL
    estimates."""
    store = ss["store_sk"].astype(np.int64) - 1
    ns = N_STORES
    zero = np.zeros(len(store), np.int64)
    med, _, _, _ = _np_percentile(store, ss["net_profit"], ns, 0.5, 0.01)
    p90, _, _, max_sales = _np_percentile(store, ss["ext_sales"], ns, 0.9,
                                          0.01)
    _, ap50, min_qty, _ = _np_percentile(store, ss["quantity"], ns, 0.5,
                                         1.0)
    g_med = _np_percentile(zero, ss["net_profit"], 1, 0.5, 0.01)[0]
    regs, exact = {}, {}
    for name, col, kind in (("tickets", "ticket", "long"),
                            ("items", "item_sk", "int")):
        v = ss[col].astype(np.int64)
        dom = np.arange(int(v.max()) + 1)
        register, rank = np_hll_slots(np_xxhash64(
            [(kind, dom, np.ones(len(dom), np.bool_))]))
        regs[name] = np_hll_registers(register[v], rank[v], store, ns)
        seen = np.zeros((ns, len(dom)), np.bool_)
        seen[store, v] = True
        exact[name] = seen.sum(axis=1)
        exact[name + "_all"] = int(seen.any(axis=0).sum())
    every = {k: np_hll_estimate(r.max(axis=0, keepdims=True))[0]
             for k, r in regs.items()}
    return {
        "pct": [(s + 1, float(med[s]), float(p90[s]), int(ap50[s]),
                 int(min_qty[s]), Decimal(int(max_sales[s])).scaleb(-2))
                for s in range(ns)],
        "pct_global": [(float(g_med[0]), int(every["tickets"]))],
        "reach": [(s + 1, int(t), int(i)) for s, (t, i) in enumerate(zip(
            np_hll_estimate(regs["tickets"]),
            np_hll_estimate(regs["items"])))],
        "reach_global": [(int(every["items"]),)],
        "exact": exact}


def bloom_tables(orders, lineitem):
    """The columns phase 34's bloom filter join reads, kept when phase
    19's data goes: the orders, each line's order row, the first lineitem
    file's rows."""
    n_li = len(lineitem["order_row"])
    return {"orders": {k: orders[k] for k in (
        "o_orderkey", "o_orderdate", "o_orderpriority")},
        "order_row": lineitem["order_row"],
        "first_file": int(np.linspace(0, n_li, N_FILES + 1).astype(
            np.int64)[1])}


def bloom_references(t):
    """The bloom filter join's numpy references: the filter's words, the
    probe's passes over the first lineitem file and the true positives;
    the join's rows without a filter (each quarter line counted by its
    order's priority)."""
    o = t["orders"]
    odate = o["o_orderdate"]
    quarter = (odate >= Q4_QUARTER[0]) & (odate < Q4_QUARTER[1])
    keys = o["o_orderkey"][quarter]
    ones = np.ones(len(keys), np.bool_)
    words = np_bloom_words(np_xxhash64([("long", keys, ones)]),
                           np_xxhash64([("long", keys, ones)], 77),
                           BLOOM_ITEMS, BLOOM_BITS)
    rows = t["order_row"]
    first = o["o_orderkey"][rows[:t["first_file"]]]
    ones = np.ones(len(first), np.bool_)
    passes_first = int(np_might_contain(
        words, np_xxhash64([("long", first, ones)]),
        np_xxhash64([("long", first, ones)], 77), BLOOM_ITEMS,
        BLOOM_BITS).sum())
    in_q = quarter[rows]
    counts = np.bincount(o["o_orderpriority"][rows[in_q]],
                         minlength=len(Q12_PRIORITIES))
    return {"words": words, "passes_first": passes_first,
            "keys": int(quarter.sum()), "true_lines": int(in_q.sum()),
            "lines": len(rows),
            "rows": [(Q12_PRIORITIES[i], int(c))
                     for i, c in enumerate(counts) if c]}


def _padded_rows(group, values, ngroups: int, width: int, fill):
    """Rows of ``values`` (sorted by group, then value) as an (ngroups,
    width) matrix, ``fill`` past each group's count."""
    counts = np.bincount(group, minlength=ngroups)
    starts = np.cumsum(counts) - counts
    out = np.full((ngroups, width), fill, values.dtype)
    out[group, np.arange(len(group)) - starts[group]] = values
    return out, counts


def sets_reference(orders):
    """order_sets' reference, customers ascending: each one's dates
    ascending (the list as a sorted multiset) and its distinct years
    ascending, as (customer keys, dates, date counts, years, year
    counts) with unused slots -1."""
    cust = orders["o_custkey"].astype(np.int64)
    date = orders["o_orderdate"].astype(np.int64)
    keys, grp = np.unique(cust, return_inverse=True)
    order = np.lexsort((date, grp))
    g, d = grp[order], date[order]
    year = d.astype("datetime64[D]").astype("datetime64[Y]").astype(
        np.int64) + 1970
    width = int(np.bincount(grp).max())
    dates, n_dates = _padded_rows(g, d, len(keys), width, -1)
    first = np.ones(len(g), np.bool_)
    first[1:] = (g[1:] != g[:-1]) | (year[1:] != year[:-1])
    years, n_years = _padded_rows(g[first], year[first], len(keys), width,
                                  -1)
    return {"keys": keys, "dates": dates, "n_dates": n_dates,
            "years": years, "n_years": n_years, "largest": width}


def bounds_reference(customer):
    """phone_bounds' reference: each nation's least and greatest phone,
    and over every customer, as strings."""
    nation = customer["c_nationkey"].astype(np.int64)
    chars, lens = customer["c_phone"].rows(0, len(nation))
    num = phone_numbers(chars)
    order = np.lexsort((num, nation))
    ns = nation[order]
    first = np.ones(len(ns), np.bool_)
    first[1:] = ns[1:] != ns[:-1]
    last = np.append(first[1:], True)

    def text(i):
        return bytes(chars[i, :lens[i]]).decode()

    rows = [(int(n), text(a), text(b)) for n, a, b in zip(
        ns[first], order[first], order[last])]
    return {"rows": rows, "global": [(text(int(np.argmin(num))),
                                      text(int(np.argmax(num))))]}


def _rows_equal(label: str, want):
    """A check: the rows, sorted, equal ``want`` exactly (doubles to the
    last bit)."""
    def check(rows):
        got = sorted(rows, key=lambda r: (r[0] is not None, r[0]))
        if got != want:
            bad = [(g, w) for g, w in zip(got, want) if g != w][:3]
            return (f"{label}: {len(got)} rows against {len(want)}; first "
                    f"differences {bad}")
        return None
    return check


def _rows_in_order(label: str, want):
    """A check: the rows, in their order, equal ``want`` exactly."""
    def check(rows):
        if rows != want:
            bad = [(g, w) for g, w in zip(rows, want) if g != w][:3]
            return (f"{label}: {len(rows)} rows against {len(want)}; "
                    f"first differences {bad}")
        return None
    return check


def sets_check(want, seen: dict):
    """order_sets' check on the host columns: customers as numpy's, each
    set exactly numpy's (ascending), each list numpy's as a sorted
    multiset, no valid element past a row's length; the element width
    goes into ``seen``."""
    w = want["dates"].shape[1]             # the largest customer's orders

    def check(cols):
        keys, dates, years = cols
        seen["ewidth"] = dates.ewidth
        order = np.argsort(keys.data)
        if not np.array_equal(keys.data[order], want["keys"]):
            return "order_sets: the customers differ"
        for name, c in (("dates", dates), ("years", years)):
            n = c.lengths[order].astype(np.int64)
            if not np.array_equal(n, want["n_" + name]):
                return f"order_sets: {name} lengths differ"
            if c.ewidth < w or c.elem_valid[:, w:].any():
                return f"order_sets: {name} has elements past {w}"
            inside = np.arange(w)[None, :] < n[:, None]
            if not np.array_equal(c.elem_valid[order, :w], inside):
                return f"order_sets: {name}' element validity differs"
            data = c.data[order, :w].astype(np.int64)
            if name == "dates":
                data = np.sort(np.where(inside, data, np.iinfo(
                    np.int64).max), axis=1)
            if not np.array_equal(np.where(inside, data, -1), want[name]):
                return f"order_sets: {name} differ"
        return None
    return check


def run_agg_phase(ss, ss_paths, bloom, q4_paths, tables, tpch_paths,
                  device, smi: str):
    """Phase 34: the runtime bloom filter join over phase 19's orders and
    lineitem; order_sets and phone_bounds over phase 27's orders and
    customer; store_pct and store_reach over phases 9-11's store_sales
    files (last: their references take longest).  Every query planned as
    the reference plans it, collected once under the profiler and twice
    timed, held against numpy references computed in threads from the
    phase's start, K1 once a dictionary chunk.  -> each query's launches
    and seconds."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.plan.nodes import LocalTableScan

    refs = _start({"bloom": lambda: bloom_references(bloom),
                   "sets": lambda: sets_reference(tables["orders"]),
                   "bounds": lambda: bounds_reference(tables["customer"]),
                   "store": lambda: store_agg_references(ss)})
    out = {}

    def run(label, q, check, plan, n, unit, chunks, host=False):
        t0 = time.perf_counter()
        out[label] = run_timed_query(label, q, check, plan, n, unit, chunks,
                                     smi, host)
        out[label]["wall"] = time.perf_counter() - t0
        return out[label]

    # the runtime bloom filter join over phase 19's files
    ors = q12_schemas(T)[0]
    lrs = T.StructType([T.StructField("l_orderkey", T.LONG, False)])
    s = S.TpuSession(Q12_CONF, device=device)
    orders = s.read.schema(ors).parquet(*q4_paths[0])
    want = _reference(refs, "bloom")
    t0 = time.perf_counter()
    bf, join, right = bloom_queries(
        orders, s.read.schema(lrs).parquet(*q4_paths[1]), S)
    (words,) = bf.collect_host()
    if not np.array_equal(words.data[0], want["words"]):
        fail(f"bloom_join: the filter's words differ from numpy's in "
             f"{int((words.data[0] != want['words']).sum())} of "
             f"{len(want['words'])}")
    # the counts probe the filter just checked, from memory
    bf = S.DataFrame(LocalTableScan([words], bf.schema), s)
    passes_first = bloom_probe(s.read.schema(lrs).parquet(q4_paths[1][0]),
                               bf, S).count()
    if passes_first != want["passes_first"]:
        fail(f"bloom_join: the probe passes {passes_first} lines of the "
             f"first file, numpy {want['passes_first']}")
    passes = bloom_probe(s.read.schema(lrs).parquet(*q4_paths[1]), bf,
                         S).count()
    k = _bloom_k(BLOOM_ITEMS, BLOOM_BITS)
    fpr = (passes - want["true_lines"]) / (want["lines"] - want["true_lines"])
    expect = (1 - np.exp(-k * want["keys"] / BLOOM_BITS)) ** k
    log(f"bloom_join: {want['keys']} keys, {BLOOM_BITS} bits, k={k}; words "
        f"== numpy's; the probe passes {passes_first} lines of the first "
        f"file (== numpy's) and {passes} of {want['lines']} in all, "
        f"{want['true_lines']} of them true: false-positive rate {fpr:.5f} "
        f"(expected {expect:.5f}); the filter and the two counts in "
        f"{time.perf_counter() - t0:.1f} s")
    run("bloom_join", join, _rows_equal("bloom_join", want["rows"]),
        bloom_plan(S._is_broadcastable(right.plan, s.conf)),
        want["lines"], "lineitem rows",
        2 * dict_chunks(q4_paths[0], ors) + dict_chunks(q4_paths[1], lrs))
    log(f"bloom_join plan after the collects:\n{join.explain()}")

    # customer order sets and phone bounds over phase 27's files
    frames = tpch_frames(tpch_paths, s, {**SETS_READS, **BOUNDS_READS})
    want = _reference(refs, "sets")
    seen = {}
    res = run("order_sets", sets_query(frames["orders"], S),
              sets_check(want, seen), SETS_PLAN, len(tables["orders"][
                  "o_custkey"]), "orders", query_chunks(
                      tpch_paths, SETS_READS), host=True)
    log(f"order_sets: {len(want['keys'])} customers, the largest with "
        f"{want['largest']} orders: element width {seen['ewidth']} "
        f"(round_up_bucket); {res['bytes_d2h']} bytes downloaded")
    want = _reference(refs, "bounds")
    grouped, total = bounds_queries(frames["customer"], S)
    n_c = len(tables["customer"]["c_nationkey"])
    chunks = query_chunks(tpch_paths, BOUNDS_READS)
    run("phone_bounds", grouped, _rows_equal("phone_bounds", want["rows"]),
        BOUNDS_PLAN, n_c, "customers", chunks)
    run("phone_bounds_global", total, _rows_equal(
        "phone_bounds_global", want["global"]), BOUNDS_GLOBAL_PLAN, n_c,
        "customers", chunks)

    # store percentiles and reach over phases 9-11's files
    table = qa_schemas(T)[0]
    n_ss = len(ss["store_sk"])
    s = S.TpuSession(QA_CONF, device=device)
    want = _reference(refs, "store")
    for reads, queries, names, plans in (
            (PCT_READS, pct_queries, ("pct", "pct_global"),
             (PCT_PLAN, PCT_GLOBAL_PLAN)),
            (REACH_READS, reach_queries, ("reach", "reach_global"),
             (REACH_PLAN, REACH_GLOBAL_PLAN))):
        chunks = dict_chunks(ss_paths, T.StructType(
            [f for f in table.fields if f.name in reads]))
        for name, q, plan in zip(names, queries(
                _read(s, ss_paths, table, reads), S), plans):
            run("store_" + name, q, _rows_equal("store_" + name,
                                                want[name]),
                plan, n_ss, "store_sales rows", chunks)
    ex = want["exact"]
    rel = [(r[1] / t - 1, r[2] / i - 1) for r, t, i in zip(
        want["reach"], ex["tickets"], ex["items"])]
    rel_all = [want["pct_global"][0][1] / ex["tickets_all"] - 1,
               want["reach_global"][0][0] / ex["items_all"] - 1]
    worst = max([abs(x) for pair in rel for x in pair]
                + [abs(x) for x in rel_all])
    log(f"store_reach: HLL (512 registers) against np.unique: tickets per "
        f"store {min(r for r, _ in rel):+.4f}..{max(r for r, _ in rel):+.4f}"
        f", items per store {min(i for _, i in rel):+.4f}.."
        f"{max(i for _, i in rel):+.4f}; all tickets {rel_all[0]:+.4f} "
        f"({ex['tickets_all']} distinct), all items {rel_all[1]:+.4f} "
        f"({ex['items_all']} distinct); 4 standard errors "
        f"{4 * 1.04 / 512 ** 0.5:.4f}")
    if worst > 4 * 1.04 / 512 ** 0.5:
        fail(f"store_reach: an HLL estimate is {worst:.4f} off the exact "
             "count, past 4 standard errors")
    log("phase 34 walls: " + ", ".join(f"{k} {v['wall']:.1f} s"
                                       for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 35: TPC-H Q21 (spec 2.4.21) and supp_revenue_avg, through the CPU
# engine's hash joins with a residual condition and its aggregate
# ---------------------------------------------------------------------------

Q21_NATION = "SAUDI ARABIA"         # spec 2.4.21.3's validation parameter
Q21_CURRENT = 9298                  # CURRENTDATE, 1995-06-17 (spec 4.2.3)
REV_YEAR = (9131, 9496)             # [1995-01-01, 1996-01-01)
REV_LIMIT = 100
Q21_LIMIT = 100
Q21_STATUS = np.array(["F", "O", "P"], object)
#: the columns each query reads, by table
Q21_READS = {"supplier": ("s_suppkey", "s_name", "s_nationkey"),
             "nation": ("n_nationkey", "n_name"),
             "lineitem21": ("l_orderkey", "l_suppkey", "l_commitdate",
                            "l_receiptdate"),
             "orders21": ("o_orderkey", "o_orderstatus")}
#: Q21 scans lineitem21 three times (l1, l2, l3)
Q21_SCANS = {"lineitem21": 3}
REV_READS = {"lineitem9": ("l_suppkey", "l_extendedprice", "l_discount",
                           "l_shipdate")}


def q21_schemas(T):
    """Q21's lineitem and orders as written (NOT NULL columns)."""
    def sch(fields):
        return T.StructType([T.StructField(nm, t, False)
                             for nm, t in fields])
    return {"lineitem21": sch([("l_orderkey", T.LONG),
                               ("l_suppkey", T.LONG),
                               ("l_commitdate", T.DATE),
                               ("l_receiptdate", T.DATE)]),
            "orders21": sch([("o_orderkey", T.LONG),
                             ("o_orderstatus", T.STRING)])}


def q21_tables(li, orders, seed: int):
    """Phase 35's tables from phase 29's lineitem and orders, by TPC-H
    4.2.3, the new columns from a generator of their own (``seed``) so
    the old ones stay as drawn: L_COMMITDATE = O_ORDERDATE + [30, 90],
    L_RECEIPTDATE = L_SHIPDATE + [1, 30], O_ORDERSTATUS 'F' when every
    line of the order shipped by CURRENTDATE (1995-06-17), 'O' when none
    did, else 'P' (codes into ``Q21_STATUS``); ``order_row`` kept for the
    reference; and supp_revenue_avg's columns of the lines."""
    rng = np.random.default_rng(seed)
    row = li["order_row"]
    n = len(row)
    commit = (orders["o_orderdate"][row]
              + rng.integers(30, 91, n).astype(np.int32))
    receipt = li["l_shipdate"] + rng.integers(1, 31, n).astype(np.int32)
    n_o = len(orders["o_orderkey"])
    shipped = np.bincount(row, weights=li["l_shipdate"] <= Q21_CURRENT,
                          minlength=n_o)
    lines = np.bincount(row, minlength=n_o)
    status = np.where(shipped == lines, 0,
                      np.where(shipped == 0, 1, 2)).astype(np.int8)
    return {"lineitem21": {"l_orderkey": li["l_orderkey"],
                           "l_suppkey": li["l_suppkey"],
                           "l_commitdate": commit.astype(np.int32),
                           "l_receiptdate": receipt.astype(np.int32),
                           "order_row": row},
            "orders21": {"o_orderkey": orders["o_orderkey"],
                         "o_orderstatus": status},
            "revenue": {k: li[k] for k in (
                "l_suppkey", "l_extendedprice", "l_discount",
                "l_shipdate")}}


def _residual_join(mod, left, right, lk: str, rk: str, how: str, cond):
    """A sort-merge join on ``lk`` = ``rk`` of type ``how`` carrying the
    residual condition ``cond`` (over both sides' columns) on the node,
    built as the reference's tests build one."""
    PN = _pkg(mod, "plan.nodes")
    T_ = _pkg(mod, "types")
    j = PN.SortMergeJoin(left.plan, right.plan,
                         [mod.col(lk).resolve(left.schema)],
                         [mod.col(rk).resolve(right.schema)],
                         getattr(PN.JoinType, how))
    j.condition = cond.resolve(T_.StructType(list(left.schema.fields)
                                             + list(right.schema.fields)))
    return mod.DataFrame(j, left.session)


def _q21_sides(f, mod):
    """(l1's late lines of 'F' orders from suppliers of SAUDI ARABIA, l2,
    l3): nation ⋈ supplier ⋈ l1 ⋈ orders in the order of the text, each
    join's key carried under its own name, as Q9 carries them."""
    col, lit = mod.col, mod.lit
    nation = f["nation"].filter(col("n_name").eq(lit(Q21_NATION))).select(
        col("n_nationkey").alias("s_nationkey"))
    sup = (f["supplier"].select(col("s_suppkey").alias("s_key"), "s_name",
                                "s_nationkey")
           .join(nation, "s_nationkey").select("s_key", "s_name"))
    late = col("l_receiptdate") > col("l_commitdate")
    lines = f["lineitem21"]
    orders = f["orders21"].filter(col("o_orderstatus").eq(lit("F"))).select(
        col("o_orderkey").alias("o_key"))
    l1 = (lines.filter(late)
          .select(col("l_orderkey").alias("o_key"), "l_orderkey",
                  "l_suppkey", col("l_suppkey").alias("s_key"))
          .join(sup, "s_key").select("o_key", "l_orderkey", "l_suppkey",
                                     "s_name")
          .join(orders, "o_key").select("l_orderkey", "l_suppkey",
                                        "s_name"))
    l2 = lines.select(col("l_orderkey").alias("l2_orderkey"),
                      col("l_suppkey").alias("l2_suppkey"))
    l3 = lines.filter(late).select(col("l_orderkey").alias("l3_orderkey"),
                                   col("l_suppkey").alias("l3_suppkey"))
    return l1, l2, l3


def _q21_top(x, mod):
    return (x.group_by("s_name").agg(mod.count_(None, "numwait"))
            .order_by("numwait", "s_name", ascending=[False, True])
            .limit(Q21_LIMIT))


def q21_query(f, mod):
    """TPC-H Q21 over the DataFrames ``f`` of the package whose session
    module is ``mod``, written with hash joins: EXISTS as a LeftSemi
    sort-merge join with l2 on the order key with the residual condition
    ``l2_suppkey <> l_suppkey``, NOT EXISTS as a LeftAnti one with l3 (the
    late lines); ``count(*)`` by ``s_name``, ordered by numwait
    descending, then ``s_name``, the first 100."""
    col = mod.col
    l1, l2, l3 = _q21_sides(f, mod)
    semi = _residual_join(mod, l1, l2, "l_orderkey", "l2_orderkey",
                          "LEFT_SEMI", ~col("l2_suppkey").eq(col("l_suppkey")))
    anti = _residual_join(mod, semi, l3, "l_orderkey", "l3_orderkey",
                          "LEFT_ANTI", ~col("l3_suppkey").eq(col("l_suppkey")))
    return _q21_top(anti, mod)


def q21_bnlj_query(f, mod):
    """Q21 with EXISTS and NOT EXISTS as nested-loop joins on the
    conjoined condition (the route on which the reference's oracle applies
    it: its hash joins drop the condition of a semi or anti join, ROADMAP
    R26)."""
    col = mod.col
    l1, l2, l3 = _q21_sides(f, mod)
    semi = l1.join(l2, col("l_orderkey").eq(col("l2_orderkey"))
                   & ~col("l2_suppkey").eq(col("l_suppkey")), "left_semi")
    anti = semi.join(l3, col("l_orderkey").eq(col("l3_orderkey"))
                     & ~col("l3_suppkey").eq(col("l_suppkey")), "left_anti")
    return _q21_top(anti, mod)


def _same_group_counts(row, key, weight):
    """For each line, the ``weight``s of the lines of its order (the lines
    of an order are contiguous, at most 7) with its ``key``, itself
    included."""
    n = len(row)
    out = weight.astype(np.int64).copy()
    for d in range(1, 7):
        same = (row[d:] == row[:-d]) & (key[d:] == key[:-d])
        out[:-d] += same & weight[d:]
        out[d:] += same & weight[:-d]
    return out[:n]


def q21_reference(t, tables):
    """Q21 in numpy: [(s_name, numwait)] in Q21's order.  EXISTS holds
    where the order has a line of another supplier: its lines less its
    lines of this supplier; NOT EXISTS where it has no late line of
    another supplier: its late lines less this supplier's."""
    li = t["lineitem21"]
    row, sk = li["order_row"], li["l_suppkey"]
    late = li["l_receiptdate"] > li["l_commitdate"]
    n_o = len(t["orders21"]["o_orderkey"])
    lines = np.bincount(row, minlength=n_o)
    late_o = np.bincount(row, weights=late, minlength=n_o).astype(np.int64)
    ones = np.ones(len(row), np.bool_)
    exists = lines[row] - _same_group_counts(row, sk, ones) > 0
    none_late = late_o[row] - _same_group_counts(row, sk, late) == 0
    sup = tables["supplier"]
    saudi = sup["s_nationkey"][sk - 1] == TPCH_NATIONS.index(Q21_NATION)
    keep = (late & exists & none_late & saudi
            & (t["orders21"]["o_orderstatus"][row] == 0))
    keys, counts = np.unique(sk[keep], return_counts=True)
    order = np.lexsort((keys, -counts))[:Q21_LIMIT]
    return [(f"Supplier#{int(k):09d}", int(c))
            for k, c in zip(keys[order], counts[order])]


def revenue_query(lineitem, mod):
    """supp_revenue_avg, a supplier scorecard over TPC-H's lineitem: the
    lines shipped in 1995, their revenue ``l_extendedprice * (1 -
    l_discount)`` (a decimal(26,4)) averaged and summed by supplier; the
    100 suppliers of the highest average (then the key).  The average of
    a decimal above 18 digits is a CPU stage, as the reference tags it."""
    col, lit = mod.col, mod.lit
    x = (lineitem.filter((col("l_shipdate") >= lit(_date(REV_YEAR[0])))
                         & (col("l_shipdate") < lit(_date(REV_YEAR[1]))))
         .select("l_suppkey", (col("l_extendedprice")
                               * (lit(1) - col("l_discount"))).alias("rev")))
    return (x.group_by("l_suppkey")
            .agg(mod.avg_("rev", "avg_rev"), mod.sum_("rev", "sum_rev"))
            .order_by("avg_rev", "l_suppkey", ascending=[False, True])
            .limit(REV_LIMIT))


def revenue_reference(rev):
    """supp_revenue_avg in numpy and Python integers: [(l_suppkey,
    avg_rev, sum_rev)], exact sums (scale 4), averages HALF_UP at scale
    8, in the query's order."""
    ship = rev["l_shipdate"]
    sel = (ship >= REV_YEAR[0]) & (ship < REV_YEAR[1])
    sk = rev["l_suppkey"][sel]
    amt = rev["l_extendedprice"][sel] * (100 - rev["l_discount"][sel])
    keys, inv, cnt = np.unique(sk, return_inverse=True, return_counts=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, amt)
    out = []
    for k, s_, c in zip(keys, sums, cnt):
        q, r = divmod(abs(int(s_)) * 10 ** 4, int(c))
        q += 2 * r >= int(c)
        out.append((int(k), q if s_ >= 0 else -q, int(s_)))
    out.sort(key=lambda x: (-x[1], x[0]))
    return [(k, Decimal(a).scaleb(-8), Decimal(s_).scaleb(-4))
            for k, a, s_ in out[:REV_LIMIT]]


_RESIDUAL_REASON = ("non-inner join with residual condition is not "
                    "supported on TPU")
_AVG128_REASON = ("avg over decimals above 18 digits needs 128-bit "
                  "division; not supported on TPU yet")


def q21_plan():
    """Q21's explain as the reference plans it: the top-N and the
    aggregate on the card over the anti join's CPU stage (the semi join
    under it, each device subtree one ``ColumnarToRow`` line)."""
    return ["TpuTopN 100",
            "  TpuHashAggregate(Complete) keys=[s_name] aggs=[count_star(*) "
            "AS numwait]",
            "    TpuRowToColumnar <- SortMergeJoin LeftAnti "
            "[l_orderkey=l3_orderkey]", "Fallback reasons:",
            "          !SortMergeJoin cannot run on TPU because "
            + _RESIDUAL_REASON,
            "            !SortMergeJoin cannot run on TPU because "
            + _RESIDUAL_REASON]


def q21_modes(paths, q21, threshold: int = 10 << 20):
    """The orders join's mode (``text_join_modes``: broadcast at planning
    while the orders files are within ``threshold``, else the adaptive
    join's decision over the 'F' orders' keys, 9 bytes a row); the
    supplier join is adaptive (a join on its right) and broadcasts its few
    hundred suppliers."""
    if sum(os.path.getsize(p) for p in paths["orders21"]) <= threshold:
        orders = "planned"
    else:
        n_f = int((q21["orders21"]["o_orderstatus"] == 0).sum())
        orders = "broadcast" if 9 * n_f <= threshold else "shuffled"
    return {"orders": orders, "supplier": "broadcast"}


def q21_stage(modes, threshold: int = 10 << 20):
    """The device subtrees under Q21's CPU stages after a collect, in plan
    order (``stage_plan_shape``): l3's late lines, l1's joins, l2."""
    late = "TpuFilter ((l_receiptdate > l_commitdate))"
    nation = _stage_join(
        "s_nationkey=s_nationkey", "s_nationkey", "s_nationkey", "planned",
        ["TpuProject [s_suppkey AS s_key, s_name, s_nationkey]", "  <scan>"],
        ["TpuProject [n_nationkey AS s_nationkey]",
         f"  TpuFilter ((n_name = '{Q21_NATION}'))", "    <scan>"],
        threshold)
    sup = _stage_join(
        "s_key=s_key", "s_key", "s_key", modes["supplier"],
        ["TpuProject [l_orderkey AS o_key, l_orderkey, l_suppkey, l_suppkey "
         "AS s_key]", "  " + late, "    <scan>"],
        ["TpuProject [s_key, s_name]"] + _indent(nation, 2), threshold)
    orders = _stage_join(
        "o_key=o_key", "o_key", "o_key", modes["orders"],
        ["TpuProject [o_key, l_orderkey, l_suppkey, s_name]"]
        + _indent(sup, 2),
        ["TpuProject [o_orderkey AS o_key]",
         "  TpuFilter ((o_orderstatus = 'F'))", "    <scan>"], threshold)
    return (["TpuProject [l_orderkey AS l3_orderkey, l_suppkey AS "
             "l3_suppkey]", "  " + late, "    <scan>",
             "TpuProject [l_orderkey, l_suppkey, s_name]"]
            + _indent(orders, 2)
            + ["TpuProject [l_orderkey AS l2_orderkey, l_suppkey AS "
               "l2_suppkey]", "  <scan>"])


_REV_AGG = ("HashAggregate({}) keys=[l_suppkey] aggs=[avg(rev) AS avg_rev, "
            "sum(rev) AS sum_rev]")
#: supp_revenue_avg's explain: the top-N on the card over the Final
#: aggregate's CPU stage
REVENUE_PLAN = ["TpuTopN 100",
                "  TpuRowToColumnar <- " + _REV_AGG.format("Final"),
                "Fallback reasons:",
                "    !HashAggregate cannot run on TPU because "
                + _AVG128_REASON,
                "        !HashAggregate cannot run on TPU because "
                + _AVG128_REASON]
#: its device subtree: the exchange between the Partial and the Final
#: stage (the single-device passes do not run under a CPU stage)
REVENUE_STAGE = ["TpuShuffleExchange hashpartitioning(l_suppkey, 16)",
                 "  TpuRowToColumnar <- " + _REV_AGG.format("Partial")]


def cpu_stage_timers(smi: str):
    """A context for one collect that times its CPU stages, each timer's
    own time less the timers inside it (a synchronize on each side): the
    CPU engine's work (``TpuRowToColumnarExec.run_cpu_stage``), the device
    subtrees its stages read (``TpuMaterializedScan.materialize_cpu``),
    their downloads (``to_host_columns``) and the uploads of the stages'
    output (``from_host_columns``); the rest is the card's operators over
    the stages.  ``cpu_stage_timers(smi)(label)`` yields the seconds,
    printed on exit."""
    import contextlib

    import torch

    from spark_rapids_tpu_torch.columnar import batch as B
    from spark_rapids_tpu_torch.exec import transitions as X
    from spark_rapids_tpu_torch.overrides import transitions as OT

    @contextlib.contextmanager
    def timers(label: str):
        own = {"engine": 0.0, "device": 0.0, "download": 0.0,
               "upload": 0.0}
        stack = []

        def wrap(owner, name, key, when=None):
            real = getattr(owner, name)

            def call(*a, **kw):
                if when is not None and not when():
                    return real(*a, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                stack.append(key)
                try:
                    return real(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    stack.pop()
                    own[key] += dt
                    if stack:
                        own[stack[-1]] -= dt
            setattr(owner, name, call)
            return owner, name, real

        saved = [wrap(X.TpuRowToColumnarExec, "run_cpu_stage", "engine"),
                 wrap(OT.TpuMaterializedScan, "materialize_cpu", "device"),
                 # the downloads under a stage; the uploads of its rows
                 wrap(B.ColumnarBatch, "to_host_columns", "download",
                      lambda: bool(stack)),
                 wrap(B.ColumnarBatch, "from_host_columns", "upload")]
        t0 = time.perf_counter()
        try:
            yield own
        finally:
            for owner, name, real in saved:
                setattr(owner, name, real)
        own["total"] = time.perf_counter() - t0
        log(f"{label} CPU stages in the profiled collect "
            f"({own['total']:.4f} s): the CPU engine's own work "
            f"{own['engine']:.4f} s, the device subtrees its stages read "
            f"{own['device']:.4f} s, their downloads "
            f"{own['download']:.4f} s, the uploads of the stages' rows "
            f"{own['upload']:.4f} s [{smi}]")
    return timers


def run_q21_phase(tables, q21, paths, out_dir: str, device, smi: str):
    """Phase 35: Q21's lineitem and orders written as 8 snappy files each
    beside phase 29's; K1 against its plain version on their index
    tables; Q21 (two CPU stages of the hash joins with a residual
    condition, the rest on the card) and supp_revenue_avg over phase 29's
    lineitem (a CPU stage of the decimal128 average, the top-N on the
    card), each planned as the reference plans it, profiled, collected
    twice timed against its numpy reference (computed in a thread from
    the phase's start), its CPU stages timed inside the profiled collect.
    -> each query's launches and seconds."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    t0 = time.perf_counter()
    refs = _start({"q21": lambda: q21_reference(q21, tables),
                   "revenue": lambda: revenue_reference(q21["revenue"])})
    sch = q21_schemas(T)
    values = {"o_orderstatus": Q21_STATUS}
    for name in ("lineitem21", "orders21"):
        paths[name] = write_tpch_files(name, q21[name], values, sch[name],
                                       out_dir, device)
    sizes = {k: (len(q21[k][sch[k].fields[0].name]),
                 sum(os.path.getsize(p) for p in paths[k]))
             for k in ("lineitem21", "orders21")}
    log(f"phase 35 data (rows, bytes): {sizes}; written in "
        f"{time.perf_counter() - t0:.1f} s")
    k1_err, widths = check_k1_tables(
        [paths["lineitem21"][0], paths["orders21"][0]],
        lambda p: sch["orders21" if "orders" in os.path.basename(p)
                      else "lineitem21"], device, smi, "Q21's tables")
    s = S.TpuSession(Q12_CONF, device=device)
    frames = tpch_frames(paths, s, {**Q21_READS, **REV_READS})
    out = {}
    n_lines = len(q21["lineitem21"]["l_orderkey"])
    for label, q, want, plan, stage, reads, scans in (
            ("Q21", q21_query(frames, S), "q21", q21_plan(),
             q21_stage(q21_modes(paths, q21)), Q21_READS, Q21_SCANS),
            ("supp_revenue_avg", revenue_query(frames["lineitem9"], S),
             "revenue", REVENUE_PLAN, REVENUE_STAGE, REV_READS, None)):
        rows = _reference(refs, want)
        t1 = time.perf_counter()
        # the CPU stages timed inside the profiled collect
        out[label] = run_timed_query(
            label, q, _rows_in_order(label, rows), plan, n_lines,
            "lineitem rows", query_chunks(paths, reads, scans), smi,
            host=False, probe=cpu_stage_timers(smi))
        if stage_plan_shape(q) != stage:
            fail(f"unexpected {label} plan under its CPU stages:\n"
                 + "\n".join(stage_plan_shape(q)))
        out[label]["wall"] = time.perf_counter() - t1
    out["k1_err"] = k1_err
    log("phase 35 walls: " + ", ".join(
        f"{k} {v['wall']:.1f} s" for k, v in out.items() if k != "k1_err"))
    return out


# -- phase 36: ClickBench's time queries over hits ----------------------------

#: a quarter of ClickBench's 99,997,497 hits rows (the depth cut, for the
#: script's time limit)
HITS_ROWS = 25_000_000
HITS_T0 = 1_372_636_800            # 2013-07-01 00:00:00 UTC, in seconds
HITS_DAYS = 31                     # July 2013, ClickBench's month
HITS_COUNTERS = 6_500
HITS_USERS = 4_400_000
HITS_PHRASES = 20_000
Q42_DAYS = ("2013-07-14", "2013-07-15")
Q42_OFFSET = 1_000                 # no OFFSET in the port: LIMIT 1010 kept
Q42_LIMIT = 10                     # from row 1000 on the host
HITS_ZONE = "America/Los_Angeles"
#: the hits columns the queries read, with ClickBench's types (SMALLINT
#: IsRefresh and DontCountHits held as INT, as Parquet stores them)
HITS_COLUMNS = (("EventTime", "TIMESTAMP"), ("EventDate", "DATE"),
                ("CounterID", "INT"), ("UserID", "LONG"),
                ("SearchPhrase", "STRING"), ("IsRefresh", "INT"),
                ("DontCountHits", "INT"))


def hits_schema(T):
    return T.StructType([T.StructField(n, getattr(T, t), False)
                         for n, t in HITS_COLUMNS])


def hits_phrases(seed: int, k: int = HITS_PHRASES) -> np.ndarray:
    """SearchPhrase's vocabulary: '' (index 0), then ``k`` phrases of 5 to
    60 bytes, words drawn from TPC-H's word lists."""
    rng = np.random.default_rng(seed)
    words = np.array([w for w, _ in TEXT_NOUNS + TEXT_VERBS
                      + TEXT_ADJECTIVES], object)
    out = [""]
    for want in rng.integers(5, 61, k):
        text = " ".join(words[rng.integers(0, len(words), 12)])[:want]
        out.append(text[:-1] + "s" if text.endswith(" ") else text)
    return np.array(out, object)


def make_hits(n: int, seed: int):
    """hits as the queries read it, from ``seed``: ``EventTime`` whole
    seconds over July 2013 UTC and ``EventDate`` its day; ``CounterID``
    62 on one row in ten, the rest Zipf over about 6,500 counters;
    ``UserID`` from 4,400,000 random ids, skewed; ``SearchPhrase`` empty
    on about seven rows in eight, else a skewed draw of the vocabulary
    (codes into ``hits_phrases``); ``IsRefresh`` 1 on a tenth,
    ``DontCountHits`` 1 on a twentieth.  Also ``user_ix``, each row's id
    index (the numpy references group on it)."""
    rng = np.random.default_rng(seed)
    secs = HITS_T0 + rng.integers(0, HITS_DAYS * 86_400, n)
    counter = (rng.zipf(1.3, n) - 1) % HITS_COUNTERS + 1
    counter = np.where(counter == 62, 63, counter)
    counter[rng.random(n) < 0.1] = 62
    users = rng.integers(-2 ** 62, 2 ** 62, HITS_USERS)
    user_ix = (HITS_USERS * rng.random(n) ** 2).astype(np.int64)
    phrase = np.where(rng.random(n) < 0.875, 0, 1 + (
        HITS_PHRASES * rng.random(n) ** 2).astype(np.int64))
    return {"EventTime": secs * 1_000_000,
            "EventDate": (secs // 86_400).astype(np.int32),
            "CounterID": counter.astype(np.int32),
            "UserID": users[user_ix], "user_ix": user_ix,
            "SearchPhrase": phrase.astype(np.int32),
            "IsRefresh": (rng.random(n) < 0.1).astype(np.int32),
            "DontCountHits": (rng.random(n) < 0.05).astype(np.int32)}


def write_hits_files(hits, phrases, out_dir: str, device,
                     n_files: int = N_FILES):
    from spark_rapids_tpu_torch import types as T

    return write_tpch_files("hits", hits, {"SearchPhrase": phrases},
                            hits_schema(T), out_dir, device, n_files)


def _dt_exprs(mod):
    import importlib

    pkg = mod.__name__.rsplit(".", 1)[0]
    return (importlib.import_module(pkg + ".expr.datetime"),
            importlib.import_module(pkg + ".expr.cast").Cast,
            importlib.import_module(pkg + ".types"))


def q18_query(hits, mod):
    """ClickBench Q18: SELECT UserID, extract(minute FROM EventTime) AS m,
    SearchPhrase, COUNT(*) FROM hits GROUP BY UserID, m, SearchPhrase
    ORDER BY COUNT(*) DESC LIMIT 10."""
    D, _, _ = _dt_exprs(mod)
    col = mod.col
    m = D.Extract(mod.lit("minute"), col("EventTime")).alias("m")
    return (hits.group_by(col("UserID"), m, col("SearchPhrase"))
            .agg(mod.count_(None, "c")).order_by(col("c"), ascending=False)
            .limit(10))


def q24_query(hits, mod):
    """ClickBench Q24: SELECT SearchPhrase FROM hits WHERE SearchPhrase <>
    '' ORDER BY EventTime LIMIT 10."""
    col = mod.col
    return (hits.filter(~col("SearchPhrase").eq(mod.lit("")))
            .order_by(col("EventTime")).limit(10).select(col("SearchPhrase")))


def q42_query(hits, mod):
    """ClickBench Q42 without its OFFSET (the port has none, like the
    reference): SELECT DATE_TRUNC('minute', EventTime) AS M, COUNT(*) AS
    PageViews FROM hits WHERE CounterID = 62 AND EventDate >= '2013-07-14'
    AND EventDate <= '2013-07-15' AND IsRefresh = 0 AND DontCountHits = 0
    GROUP BY DATE_TRUNC('minute', EventTime) ORDER BY DATE_TRUNC('minute',
    EventTime) LIMIT 1010; the date literals are casts of strings, which
    the card evaluates (the reference folds no constant)."""
    D, Cast, T = _dt_exprs(mod)
    col, lit = mod.col, mod.lit
    day = [Cast(lit(d), T.DATE) for d in Q42_DAYS]
    keep = (col("CounterID").eq(lit(62)) & (col("EventDate") >= day[0])
            & (col("EventDate") <= day[1]) & col("IsRefresh").eq(lit(0))
            & col("DontCountHits").eq(lit(0)))
    return (hits.filter(keep)
            .group_by(D.TruncTimestamp(lit("minute"), col("EventTime"))
                      .alias("M"))
            .agg(mod.count_(None, "PageViews")).order_by(col("M"))
            .limit(Q42_OFFSET + Q42_LIMIT))


def hours_query(hits, mod):
    """Page views by hour of the day in America/Los_Angeles: hour(
    from_utc_timestamp(EventTime, zone)), counted and ordered."""
    D, _, _ = _dt_exprs(mod)
    col = mod.col
    h = D.Hour(D.FromUTCTimestamp(col("EventTime"), mod.lit(HITS_ZONE)))
    return (hits.group_by(h.alias("h")).agg(mod.count_(None, "n"))
            .order_by(col("h")))


HITS_QUERIES = {"Q18": q18_query, "Q24": q24_query, "Q42": q42_query,
                "hours_la": hours_query}


def _ts(micros: int):
    import datetime as _dt

    return (_dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)
            + _dt.timedelta(microseconds=int(micros)))


def q18_reference(hits, phrases):
    """(every group's count by its key, the top ten counts): the groups
    of (user, minute, phrase) counted by ``np.unique`` on one int64 key."""
    minute = (hits["EventTime"] // 60_000_000) % 60
    key = ((hits["user_ix"] * 60 + minute) * (len(phrases))
           + hits["SearchPhrase"])
    keys, counts = np.unique(key, return_counts=True)
    top = np.argsort(-counts, kind="stable")[:10]
    return keys, counts, sorted(counts[top].tolist(), reverse=True)


def q18_check(hits, phrases, ref):
    """Q18's rows: ten distinct groups in descending count, the counts
    numpy's top ten, each group's count its own (ties at the tenth count
    may pick any of the tied groups)."""
    keys, counts, top = ref
    users = {}

    def check(rows):
        got = [r[3] for r in rows]
        if got != top:
            return f"Q18 counts {got} against numpy's {top}"
        if len({r[:3] for r in rows}) != len(rows):
            return f"Q18 repeats a group: {rows}"
        for uid, m, phrase, c in rows:
            if uid not in users:
                users[uid] = int(hits["user_ix"][np.flatnonzero(
                    hits["UserID"] == uid)[0]])
            code = int(np.flatnonzero(phrases == phrase)[0])
            k = (users[uid] * 60 + m) * len(phrases) + code
            j = np.searchsorted(keys, k)
            if j >= len(keys) or keys[j] != k or counts[j] != c:
                return f"Q18 group {(uid, m, phrase)} counted {c}"
        return None
    return check


def q24_reference(hits, phrases):
    """(the phrases of the rows before the tenth instant, those at it):
    the non-empty rows ordered by EventTime."""
    ne = np.flatnonzero(hits["SearchPhrase"] != 0)
    t = hits["EventTime"][ne]
    t10 = np.partition(t, 9)[9]
    return (sorted(phrases[hits["SearchPhrase"][ne[t < t10]]].tolist()),
            phrases[hits["SearchPhrase"][ne[t == t10]]].tolist())


def q24_check(ref):
    """Q24's rows: every phrase before the tenth instant, the rest from
    those at it (ties at it may pick any)."""
    before, at = ref

    def check(rows):
        got = [r[0] for r in rows]
        rest = list(got)
        for p in before:
            if p not in rest:
                return f"Q24 lacks {p!r}: {got}"
            rest.remove(p)
        pool = list(at)
        for p in rest:
            if p not in pool:
                return f"Q24 {p!r} is not at the tenth instant: {got}"
            pool.remove(p)
        return None if len(got) == 10 else f"Q24 gave {len(got)} rows"
    return check


def q42_reference(hits):
    """Q42's rows 1000 to 1009: (minute, page views), minutes ascending."""
    lo, hi = ((np.datetime64(d) - np.datetime64("1970-01-01")).astype(int)
              for d in Q42_DAYS)
    keep = ((hits["CounterID"] == 62) & (hits["EventDate"] >= lo)
            & (hits["EventDate"] <= hi) & (hits["IsRefresh"] == 0)
            & (hits["DontCountHits"] == 0))
    minutes, counts = np.unique(hits["EventTime"][keep] // 60_000_000,
                                return_counts=True)
    end = Q42_OFFSET + Q42_LIMIT
    return [(_ts(m * 60_000_000), int(c))
            for m, c in zip(minutes[Q42_OFFSET:end], counts[Q42_OFFSET:end])]


def q42_check(want):
    def check(rows):
        got = rows[Q42_OFFSET:]
        return None if got == want else (
            f"Q42 rows {Q42_OFFSET}-: {got[:3]} against {want[:3]}")
    return check


def hours_reference(hits):
    """Page views by the zone's hour: July 2013 lies inside one DST period
    of the zone, so one offset, read from Python's zoneinfo (not from the
    port's tables), holds for the month."""
    import datetime as _dt
    from zoneinfo import ZoneInfo

    zi = ZoneInfo(HITS_ZONE)
    offs = {zi.utcoffset(_dt.datetime(2013, 7, d)) for d in (1, 16, 31)}
    if len(offs) != 1:
        fail(f"{HITS_ZONE} changes offset in July 2013: {offs}")
    off = int(offs.pop().total_seconds())
    h = ((hits["EventTime"] // 1_000_000 + off) // 3600) % 24
    return [(i, int(c)) for i, c in enumerate(np.bincount(h, minlength=24))]


def hits_references(hits, phrases, tz: bool):
    """The numpy references of phase 36, each in a thread."""
    jobs = {"Q18": lambda: q18_reference(hits, phrases),
            "Q24": lambda: q24_reference(hits, phrases),
            "Q42": lambda: q42_reference(hits)}
    if tz:
        jobs["hours_la"] = lambda: hours_reference(hits)
    return _start(jobs)


def hits_checks(hits, phrases, refs):
    return {"Q18": q18_check(hits, phrases, refs["Q18"].result()),
            "Q24": q24_check(refs["Q24"].result()),
            "Q42": q42_check(refs["Q42"].result()),
            **({"hours_la": _rows_in_order(
                "hours_la", refs["hours_la"].result())}
               if "hours_la" in refs else {})}


#: the port's plans of phase 36, scans as ``<scan>`` (the reference's:
#: ``tests/port/test_torch_clickbench.py``)
HITS_PLANS = {
    "Q18": ["TpuTopN 10",
            "  TpuHashAggregate(Complete) keys=[UserID, extract('minute' "
            "FROM EventTime) AS m, SearchPhrase] aggs=[count_star(*) AS c]",
            "    <scan>"],
    "Q24": ["TpuProject [SearchPhrase]",
            "  TpuTopN 10",
            "    TpuFilter ((NOT (SearchPhrase = '')))",
            "      <scan>"],
    "Q42": ["TpuTopN 1010",
            "  TpuHashAggregate(Complete) keys=[trunctimestamp('minute', "
            "EventTime) AS M] aggs=[count_star(*) AS PageViews] "
            "fused=[Filter]",
            "    <scan>"],
    "hours_la": ["TpuSort [h ASC]",
                 "  TpuHashAggregate(Complete) keys=[hour(fromutctimestamp("
                 "EventTime, 'America/Los_Angeles')) AS h] "
                 "aggs=[count_star(*) AS n]",
                 "    <scan>"]}


def has_zoneinfo() -> bool:
    """Whether this machine has the zone files ``tzdb`` reads."""
    from spark_rapids_tpu_torch.tzdb import is_known_zone

    return is_known_zone(HITS_ZONE)


def run_hits_phase(hits, phrases, paths, device, smi: str, tz: bool,
                   refs):
    """Phase 36: ClickBench Q18, Q24 and Q42 (and, with ``tz``, page views
    by the hour in America/Los_Angeles) from the hits files, each planned
    as the reference plans it, profiled, collected twice timed, exact
    against numpy (``refs``: the references' futures), K1 once a
    dictionary chunk; K1 against its plain version on the first file's
    EventTime and UserID index tables.  -> each query's launches and
    seconds, and K1's largest difference."""
    import spark_rapids_tpu_torch.session as S
    from spark_rapids_tpu_torch import types as T

    sch = hits_schema(T)
    k1_err, widths = check_k1_tables(
        [paths[0]], lambda p: T.StructType(
            [f for f in sch.fields if f.name in ("EventTime", "UserID")]),
        device, smi, "hits EventTime and UserID")
    s = S.TpuSession(Q12_CONF, device=device)
    checks = hits_checks(hits, phrases, refs)
    out = {"k1_err": k1_err, "widths": widths}
    n = len(hits["EventTime"])
    for label, build in HITS_QUERIES.items():
        if label not in checks:
            continue
        reads = hits_reads(T, label)
        q = build(s.read.schema(reads).parquet(*paths), S)
        t1 = time.perf_counter()
        # Q42's collect is 27 s of the host's snappy op walk (PERF.md):
        # one timed collect beside the profiled one, for the time limit
        out[label] = run_timed_query(
            label, q, checks[label], HITS_PLANS[label], n,
            "hits rows", dict_chunks(paths, reads), smi, host=False,
            timed=1 if label == "Q42" else 2)
        out[label]["wall"] = time.perf_counter() - t1
    log("phase 36 walls: " + ", ".join(
        f"{k} {v['wall']:.1f} s" for k, v in out.items()
        if isinstance(v, dict)))
    return out


def hits_reads(T, label: str):
    """The hits columns a query reads, as the scan's schema."""
    names = {"Q18": ("UserID", "EventTime", "SearchPhrase"),
             "Q24": ("SearchPhrase", "EventTime"),
             "Q42": ("EventTime", "CounterID", "EventDate", "IsRefresh",
                     "DontCountHits"),
             "hours_la": ("EventTime",)}[label]
    return T.StructType([f for f in hits_schema(T).fields
                         if f.name in names])


def run_hits_main(seed: int, device, smi: str):
    """Phase 36 at its size: hits made from ``seed + 306``, its numpy
    references started in threads beside the writes, the files written,
    then ``run_hits_phase``; the zone query where the zone files exist."""
    t0 = time.perf_counter()
    hits = make_hits(HITS_ROWS, seed + 306)
    phrases = hits_phrases(seed + 307)
    gen_s = time.perf_counter() - t0
    tz = has_zoneinfo()
    log(f"phase 36: zone files for {HITS_ZONE} "
        f"{'present' if tz else 'missing: the zone query does not run'}")
    refs = hits_references(hits, phrases, tz)
    out_dir = os.path.join(HERE, "spark_rapids_tpu_torch", "build",
                           f"hits_seed{seed + 306}")
    paths = write_hits_files(hits, phrases, out_dir, device)
    log(f"hits data: {HITS_ROWS} rows in {N_FILES} files "
        f"({sum(os.path.getsize(p) for p in paths)} bytes); generated in "
        f"{gen_s:.1f} s, written in {time.perf_counter() - t0 - gen_s:.1f} "
        f"s beside the numpy references")
    widths = sorted({(name, page.index_bit_width) for p in paths
                     for name, page in main_path_pages(p)
                     if page.index_bit_width})
    log(f"hits dictionary index widths: {widths}")
    if max(w for _, w in widths) > 24:
        fail(f"hits: an index width past K1's 24: {widths}")
    return run_hits_phase(hits, phrases, paths, device, smi, tz, refs)


def _date(days: int):
    import datetime as _dt

    return _dt.date(1970, 1, 1) + _dt.timedelta(days=days)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=20261017)
    # one driver incarnation of phase 17 (internal: the script starts it)
    ap.add_argument("--driver-incarnation", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--recovery-dir", help=argparse.SUPPRESS)
    ap.add_argument("--kill-at", default="none", help=argparse.SUPPRESS)
    ap.add_argument("--workers", type=int, default=len(DK_WORKERS),
                    help=argparse.SUPPRESS)
    ap.add_argument("--rows", type=int, default=DK_BENCH_ROWS,
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--result-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.driver_incarnation:
        return driver_incarnation(args)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import spark_rapids_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")

    # 2. build
    log(f"build: K1 (nvcc) and host snappy (g++) in {build_all():.1f} s")

    # 3. K1 against its plain version
    check_k1(device, args.seed)
    check_gather_chains(device, args.seed)
    check_decimal128(device, args.seed)

    # 4. Q6 from Parquet
    n = int(round(SF10_ROWS * args.scale / 10))
    t0 = time.perf_counter()
    li = lineitem_q6(n, args.scale, args.seed)
    data_dir = os.path.join(HERE, "spark_rapids_tpu_torch", "build",
                            f"q6_sf{args.scale:g}_seed{args.seed}")
    paths = write_files(li, n, data_dir, device)
    log(f"data: {n} rows written to {N_FILES} files "
        f"({sum(os.path.getsize(p) for p in paths)} bytes) in "
        f"{time.perf_counter() - t0:.1f} s")
    widths = sorted({(name, page.index_bit_width)
                     for p in paths for name, page in main_path_pages(p)})
    log(f"index bit widths: {widths}")
    q6 = run_q6(paths, li, n, device)

    time_breakdown(paths, device)
    profile_collect(q6["query"].collect, [(q6["want"],)], "Q6 parquet")

    # 5. Q6 in memory
    run_q6_memory(li, q6["want"], device)

    # 6. K1 timing at the main path's pages, snappy gather on them
    k1, err = time_k1_and_gather(paths, device)
    # 7. K1 on Spark-shaped batches; 8. Q6 on the multi-page fixture
    spark = time_spark_batches(device, args.seed)
    run_fixture_q6(device)

    # 9. bench qa from Parquet at TPC-DS SF10 store_sales rows
    n_ss = int(round(SS_SF10_ROWS * args.scale / 10))
    t0 = time.perf_counter()
    ss, dd = make_store_sales(n_ss), make_date_dim()
    want = qa_reference(ss, dd)
    ref_s = time.perf_counter() - t0
    qa_dir = os.path.join(HERE, "spark_rapids_tpu_torch", "build",
                          f"qa_sf{args.scale:g}")
    ss_paths, dd_path = write_qa_files(ss, dd, n_ss, qa_dir, device)
    log(f"qa data: {n_ss} store_sales rows in {N_FILES} files "
        f"({sum(os.path.getsize(p) for p in ss_paths)} bytes), date_dim "
        f"{N_DATES} rows; generated with the numpy reference in "
        f"{ref_s:.1f} s, written in {time.perf_counter() - t0 - ref_s:.1f} s")
    log("qa dictionary index widths: " + str(sorted(
        {(name, page.index_bit_width)
         for p in ss_paths + [dd_path] for name, page in main_path_pages(p)})))
    qa = run_qa(ss_paths, dd_path, want, n_ss, device)
    qa_breakdown(qa["query"])
    profile_collect(qa["query"].collect, want, "qa parquet")
    run_qa_memory(ss, dd, want, device)

    # 10. bench qb: the shuffled left outer join, then a grouped net sum
    t0 = time.perf_counter()
    sr = make_store_returns(ss, n_ss // 10)
    want_qb = qb_reference(ss, sr)
    ref_s = time.perf_counter() - t0
    sr_paths = write_returns_files(sr, qa_dir, device)
    log(f"qb data: {len(sr['ticket'])} store_returns rows in {N_FILES} "
        f"files ({sum(os.path.getsize(p) for p in sr_paths)} bytes); "
        f"generated with the numpy reference in {ref_s:.1f} s, written in "
        f"{time.perf_counter() - t0 - ref_s:.1f} s")
    qb_cols = {"store_sk", "item_sk", "ticket", "ext_sales", "return_amt"}
    log("qb dictionary index widths: " + str(sorted(
        {(os.path.basename(p).split("-")[0], name, page.index_bit_width)
         for p in ss_paths + sr_paths for name, page in main_path_pages(p)
         if name in qb_cols})))
    del sr
    qb = run_qb(ss_paths, sr_paths, want_qb, n_ss, device)
    qb_breakdown(qb["query"])
    profile_collect(qb["query"].collect, want_qb, "qb parquet", key=sorted)

    # 11. bench qc: a grouped sum, a rank window, rank <= 5 (store_sales
    # is kept for phase 32)
    want_qc = qc_reference(ss)
    qc = run_qc(ss_paths, want_qc, n_ss, device)
    qc_breakdown(qc["query"])
    profile_collect(qc["query"].collect, want_qc, "qc parquet", key=qc_rows)

    # 12. bench rung3_ooc from memory: at bench's defaults, then at SF10
    t0 = time.perf_counter()
    ooc_small = run_ooc(bench_ooc_rows(BENCH_OOC_POOL), BENCH_OOC_POOL,
                        device, smi, "rung3_ooc bench defaults")
    # at half of SF10's rows (still 5.7x the pool) and without a warm-up
    # collect, for the time limit
    ooc = run_ooc(n_ss // 2, OOC_POOL, device, smi, "rung3_ooc", warm=False)
    # its breakdown (93% host codec, PRs 5-15: PERF.md) is left out for
    # the time limit
    del ooc_small, ooc
    log(f"phase 12 wall time {time.perf_counter() - t0:.1f} s")

    # 13. bench qb out of core: the sub-partitioned join from Parquet
    t0 = time.perf_counter()
    ooc_qb = run_ooc_qb(ss_paths, sr_paths, want_qb, n_ss, OOC_POOL, device,
                        smi)
    log(f"phase 13 wall time {time.perf_counter() - t0:.1f} s")

    # 14. bench rung3: a CPU stage under the aggregate, the out-of-core
    # sort; at bench's size, then at SF10 rows
    t0 = time.perf_counter()
    run_rung3(RUNG3_BENCH_ROWS, device, smi, "rung3 bench size")
    # at a quarter of SF10's rows (5.3x the 64 MiB floor), the sort
    # counted once, for the time limit
    # (its aggregate and sort breakdowns, PRs 6-15's in PERF.md, are left
    # out for the time limit)
    rung3 = run_rung3(n_ss // 4, device, smi, "rung3", count_runs=1)
    if rung3["count"]["metrics"]["spillToHostCount"] <= 0:
        fail("rung3: the sort spilled nothing to the host")
    log(f"phase 14 wall time {time.perf_counter() - t0:.1f} s")

    # 15. bench rung4_dist: two worker processes, one killed mid-shuffle;
    # at bench's size with its A/Bs, then at SF10 rows with a breakdown
    t0 = time.perf_counter()
    run_dist(DIST_BENCH_ROWS, device, smi, "rung4_dist bench size", True)
    dist = run_dist(n_ss, device, smi, "rung4_dist", False)
    log(f"phase 15 wall time {time.perf_counter() - t0:.1f} s")

    # 16. bench rung5_recovery: the journal's cost, a kill at the first
    # stage commit and the resume; at bench's size, then at SF10 rows
    t0 = time.perf_counter()
    rec_small = run_rung5(REC_BENCH_ROWS, device, smi,
                          "rung5_recovery bench size")
    rec = run_rung5(n_ss, device, smi, "rung5_recovery")
    log(f"phase 16 wall time {time.perf_counter() - t0:.1f} s")

    # 17. the driver SIGKILLed mid-query and restarted, its two workers
    # re-attaching; the incarnations are child processes on the card
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # at bench's size only (the round at SF10 rows, about 31 s, is left
    # out for the time limit)
    dk = run_driver_kill(
        [(kp, DK_BENCH_ROWS, DK_WORKER_MEM) for kp in DK_KILLS], "cuda",
        smi, "driver kill")
    log(f"phase 17 wall time {time.perf_counter() - t0:.1f} s")

    # 18. bench q6_parquet_hot: phase 4's files over the hot-table cache
    t0 = time.perf_counter()
    hot = run_hot(paths, q6, n, args.seed, device, smi)
    log(f"phase 18 wall time {time.perf_counter() - t0:.1f} s")

    # 19. TPC-H Q12 from Parquet: string columns end to end
    t0 = time.perf_counter()
    n_orders = int(round(Q12_ORDERS_SF10 * args.scale / 10))
    orders, lineitem = make_q12(n_orders, args.seed)
    want_q12 = q12_reference(orders, lineitem)
    if [r[0] for r in want_q12] != sorted(Q12_MODES):
        fail(f"Q12 reference: {want_q12}")
    n_li = len(lineitem["l_orderkey"])
    ref_s = time.perf_counter() - t0
    q12_dir = os.path.join(HERE, "spark_rapids_tpu_torch", "build",
                           f"q12_sf{args.scale:g}_seed{args.seed}")
    o_paths, l_paths, plain = write_q12_files(orders, lineitem, q12_dir,
                                              device)
    o_bytes = sum(os.path.getsize(p) for p in o_paths)
    l_bytes = sum(os.path.getsize(p) for p in l_paths)
    log(f"Q12 data: {n_orders} orders ({o_bytes} bytes) and {n_li} "
        f"lineitem rows ({l_bytes} bytes) in {N_FILES} + {N_FILES} files; "
        f"generated with the numpy reference in {ref_s:.1f} s, written in "
        f"{time.perf_counter() - t0 - ref_s:.1f} s")
    log("Q12 dictionary index widths: " + str(sorted(
        {(name, page.index_bit_width) for p in o_paths + l_paths
         for name, page in main_path_pages(p)})))
    q12_k1_err = check_q12_k1([o_paths[0], l_paths[0]], device, smi)
    q12 = run_q12(o_paths, l_paths, want_q12, q12_build_bytes(lineitem),
                  n_li, device, smi)
    # its profiled collect (idle 0.97, PRs 9-15) and its breakdown (the
    # lineitem scan 5.76 of 6.75 s, PRs 9-16: PERF.md) are left out for
    # the time limit
    read_q12_plain(plain, orders, device, smi)
    del q12["query"]
    log(f"phase 19 wall time {time.perf_counter() - t0:.1f} s")

    # 20. Q12 through the out-of-core exchange, strings in its host frames
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    q12_ooc = run_q12_ooc(orders, lineitem, want_q12, OOC_POOL, device, smi)
    log(f"phase 20 wall time {time.perf_counter() - t0:.1f} s")

    # 21. TPC-H Q4 from phase 19's files: EXISTS as a left semi join
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    want_q4 = q4_reference(orders, lineitem)
    q4 = run_q4(o_paths, l_paths, want_q4, q4_build_bytes(lineitem), n_li,
                device, smi)
    # its profiled collect (idle 0.97, PRs 10-15) and its breakdown (the
    # lineitem scan 4.94 of 6.03 s, PRs 10-16: PERF.md) are left out for
    # the time limit
    del q4["query"]
    log(f"phase 21 wall time {time.perf_counter() - t0:.1f} s")

    # 22. the other join types on Q4's tables: the anti twin, right and
    # full outer from the files; Q4 and its twin sub-partitioned in memory
    t0 = time.perf_counter()
    q4_types = run_q4_join_types(o_paths, l_paths, orders, lineitem, want_q4,
                                 device, smi)
    torch.cuda.empty_cache()
    # on half of SF10's orders, for the time limit: the late lines are
    # still past the pool's goal, so both joins sub-partition
    half = len(orders["o_orderkey"]) // 2
    keep = lineitem["order_row"] < half
    q4_ooc = run_q4_ooc({k: v[:half] for k, v in orders.items()},
                        {k: v[keep] for k, v in lineitem.items()}, OOC_POOL,
                        device, smi)
    bloom = bloom_tables(orders, lineitem)     # for phase 34
    del orders, lineitem
    log(f"phase 22 wall time {time.perf_counter() - t0:.1f} s")

    # 23. TPC-H Q1 at SF10 from 8 new files: avg over 128-bit sums, a CPU
    # stage with strings and a 128 x 64-bit decimal product
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    li1 = lineitem_q1(n, args.scale, args.seed + 1)
    gen_s = time.perf_counter() - t0
    # the numpy reference in a thread while the files are written
    q1_ref = _start({"q1": lambda: q1_reference(li1)})["q1"]
    q1_dir = os.path.join(HERE, "spark_rapids_tpu_torch", "build",
                          f"q1_sf{args.scale:g}_seed{args.seed + 1}")
    q1_paths = write_q1_files(li1, q1_dir, device)
    write_s = time.perf_counter() - t0 - gen_s
    want_q1 = q1_ref.result()
    del li1
    log(f"Q1 data: {n} lineitem rows in {N_FILES} files "
        f"({sum(os.path.getsize(p) for p in q1_paths)} bytes); generated "
        f"in {gen_s:.1f} s, written in {write_s:.1f} s beside the numpy "
        f"reference, which took "
        f"{time.perf_counter() - t0 - gen_s - write_s:.1f} s more")
    log("Q1 dictionary index widths: " + str(sorted(
        {(name, page.index_bit_width) for p in q1_paths
         for name, page in main_path_pages(p)})))
    from spark_rapids_tpu_torch import types as _T
    q1_k1_err, q1_widths = check_string_k1(
        [q1_paths[0]], lambda p: q1_schema(_T), device, smi, "Q1")
    if not {1, 2} <= set(q1_widths):
        fail(f"Q1: the string index tables have widths {q1_widths}, not 1 "
             "and 2")
    q1 = run_q1(q1_paths, want_q1, n, device, smi)
    # its profiled collect (about 18 s; idle 0.63-0.69 in PRs 10-13) and
    # its breakdown (the CPU stage's round trip, PRs 10-15: PERF.md) are
    # left out for the time limit
    del q1["query"]
    log(f"phase 23 wall time {time.perf_counter() - t0:.1f} s")

    # 24-26. TPC-H Q11 and Q15 (scalar subqueries as nested-loop joins),
    # the nested-loop join's types, the residual condition on three
    # routes, and q16_nolike (count(distinct)), from 33 new files; 27-29.
    # TPC-H Q13, Q22, Q16 and Q9 (strings, LIKE through the DFA, dates)
    # from 24 more; 30-31. TPC-H Q14, Q17 and Q8 (decimal division in a
    # CPU stage) from those files and region
    torch.cuda.empty_cache()
    tpch_dir = os.path.join(HERE, "spark_rapids_tpu_torch", "build",
                            f"tpch_sf{args.scale:g}_seed{args.seed + 2}")
    tpch = run_tpch_phases(args.scale, args.seed, device, smi, tpch_dir)
    # 32. windows and statistics over phases 9-11's store_sales: TPC-DS
    # Q47's shape, moving ROWS and RANGE frames over every row, per-item
    # skewness, kurtosis, correlation and regression
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # phases 32-33's numpy references in threads beside phase 32's work
    store_refs = store_references(ss, dd)
    tpch_refs = tpch_references(tpch["windows"])
    w32 = run_store_windows(store_refs, ss, ss_paths, dd_path, device, smi)
    del store_refs                             # ss is kept for phase 34
    log(f"phase 32 wall time {time.perf_counter() - t0:.1f} s")

    # 33. windows over phase 27's orders and customer: order histories
    # (lag, lead, a trailing 90-day RANGE frame over a DATE key) and
    # phones per nation (string lead/lag, first/last, min/max)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    w33 = run_tpch_windows(tpch_refs, tpch["paths"],
                           tpch["windows"], device, smi)
    log(f"phase 33 wall time {time.perf_counter() - t0:.1f} s")

    # 34. percentiles and HLL reach per store, a runtime bloom filter
    # join, customers' order sets (array columns) and phone bounds
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    a34 = run_agg_phase(ss, ss_paths, bloom, (o_paths, l_paths),
                        tpch["windows"], tpch["paths"], device, smi)
    del ss, bloom
    log(f"phase 34 wall time {time.perf_counter() - t0:.1f} s")

    # 35. TPC-H Q21 (EXISTS and NOT EXISTS as hash joins with a residual
    # condition, two CPU stages) and supp_revenue_avg (a decimal128 avg
    # in a CPU stage) over phase 29's lines and orders
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    a35 = run_q21_phase(tpch["tables"], tpch.pop("q21"), tpch["paths"],
                        tpch_dir, device, smi)
    log(f"phase 35 wall time {time.perf_counter() - t0:.1f} s")

    # 36. ClickBench Q18, Q24 and Q42 over a 25,000,000-row hits table
    # from 8 new files: TIMESTAMP keys, extract, date_trunc, a string ->
    # DATE cast on the card; the zone query where the zone files exist
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    a36 = run_hits_main(args.seed, device, smi)
    log(f"phase 36 wall time {time.perf_counter() - t0:.1f} s")
    kernels = {"kernels": [{
        "name": "unpack_runs",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": q6["launches"],
        "max_abs_err": max(err, q12_k1_err, q1_k1_err, tpch["k1_err"],
                           w32["k1_err"], a35["k1_err"], a36["k1_err"]),
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_bytes"] / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
        "ms_l2_cold": k1["ms_cold"],
        "spark_ms_l2_cold": spark["ms_cold"],
        "spark_bound_ms": spark["bound_bytes"] / HBM_BYTES_PER_S * 1e3,
        "qa_launches": qa["launches"],
        "qb_launches": qb["launches"],
        "qc_launches": qc["launches"],
        "ooc_qb_launches": ooc_qb["launches"],
        "rung3_launches": rung3["launches"],
        "rung4_dist_launches": dist["launches"],
        "rung5_recovery_launches": rec_small["launches"] + rec["launches"],
        "driver_kill_launches": sum(r["result"]["unpack_launches"]
                                    for r in dk),
        "q6_hot_miss_launches": hot["big"]["first"][2],
        "q6_hot_hit_launches": hot["big"]["second"][2],
        "q12_launches": q12["launches"],
        "q12_ooc_launches": q12_ooc["launches"],
        "q4_launches": q4["launches"],
        "q4_join_types_launches": sum(r["launches"]
                                      for r in q4_types.values()),
        "q4_ooc_launches": sum(r["launches"] for r in q4_ooc.values()),
        "q1_launches": q1["launches"],
        "q11_launches": tpch["q11_launches"],
        "q11_cross_launches": tpch["q11_cross_launches"],
        "residual_launches": tpch["residual_launches"],
        "q15_launches": tpch["q15_launches"],
        "q16_nolike_launches": tpch["q16_launches"],
        "q13_launches": tpch["text"]["q13"]["launches"],
        "q22_launches": tpch["text"]["q22"]["launches"],
        "q16_launches": tpch["text"]["q16"]["launches"],
        "q9_launches": tpch["text"]["q9"]["launches"],
        "q14_launches": tpch["arith"]["q14"]["launches"],
        "q17_launches": tpch["arith"]["q17"]["launches"],
        "q8_launches": tpch["arith"]["q8"]["launches"],
        "q47_launches": w32["q47"]["launches"],
        "moving_launches": w32["moving"]["launches"],
        "stats_launches": w32["stats"]["launches"],
        "orders_history_launches": w33["orders_history"]["launches"],
        "customer_phones_launches": w33["customer_phones"]["launches"],
        **{f"{name}_launches": r["launches"] for name, r in a34.items()},
        "q21_launches": a35["Q21"]["launches"],
        "supp_revenue_avg_launches": a35["supp_revenue_avg"]["launches"],
        **{f"{name.lower()}_launches": r["launches"]
           for name, r in a36.items() if isinstance(r, dict)},
    }]}
    log(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

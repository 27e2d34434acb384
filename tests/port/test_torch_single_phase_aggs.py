"""The rest of the aggregates — ``collect_list``, ``collect_set``,
``percentile``, ``median``, ``approx_percentile``,
``approx_count_distinct``, ``bloom_filter_agg`` probed by
``might_contain`` and string ``min``/``max`` — against the JAX package's
CPU oracle session, grouped (a null key, a group whose inputs are all
null) and global, in one batch and in batches of 300 rows, and on an
empty input; the cases of the reference's ``tests/test_agg_breadth.py``
(percentiles at several ranks, doubles with NaN, an all-null group, HLL
over each type, the bloom filter join and its false negatives); the plan
of each against the reference device session's, planned once in the child
process.  Every value is exact: doubles to the last bit, lists in the
oracle's order (a ``collect_list`` in arrival order, a ``collect_set``
ascending).

The one difference of plan: the reference's two-phase
``approx_count_distinct`` runs its exchange as a CPU stage (its Partial
emits array<int> registers, which its Exchange's type signature refuses);
the port collapses the two phases into one aggregate on the device, as it
does every two-phase aggregate on one device."""
import numpy as np
import pytest
import torch

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_aggs import (BATCHES, FAMILIES, HLL_INPUTS, WORDS, query)
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax

def oracle(family, grouped=True, empty=False):
    return query(RS, RT, RS.TpuSession(ORACLE), family, grouped,
                 empty).collect()


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("batches", sorted(BATCHES))
@pytest.mark.parametrize("family", FAMILIES)
def test_aggregates_match_oracle(family, batches, grouped):
    got = query(S, T, S.TpuSession(BATCHES[batches], device="cpu"), family,
                grouped).collect()
    assert rows_key(got) == rows_key(oracle(family, grouped))
    assert len(got) == (9 + 1 if grouped else 1)


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_aggregates_over_an_empty_input(family, grouped):
    """A grouped empty input has no rows; a global one the reference's
    row: an empty list, an all-zero filter, HLL and counts 0, the rest
    null."""
    got = query(S, T, S.TpuSession({}, device="cpu"), family, grouped,
                empty=True).collect()
    if grouped:
        assert got == []
    assert rows_key(got) == rows_key(oracle(family, grouped, empty=True))


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    """Each family's plan in the reference device session, grouped and
    global (planned in the child: one call for the module)."""
    out = run_jax("""
        import sys
        sys.path.insert(0, "tests/port")
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        from torch_port_aggs import FAMILIES, query
        for f in FAMILIES:
            for grouped in (True, False):
                q = query(RS, T, RS.TpuSession({}), f, grouped)
                out[f"{f}_{grouped}"] = np.array(C.plan_shape(q))
    """, tmp_path_factory.mktemp("plans"))
    return {k: list(v) for k, v in out.items()}


#: the reference's two-phase HLL: Final over a CPU exchange (its Partial's
#: array<int> registers) over the Partial, as its explain prints it
HLL_REFERENCE_PLAN = [
    "TpuHashAggregate(Final) keys=[{keys}] aggs=[{aggs}]",
    "  TpuRowToColumnar <- Exchange {part}",
    "Fallback reasons:",
    "  !Exchange cannot run on TPU because " + "; ".join(
        f"exec Exchange output column 'h_{c}_hll': array<int> is not "
        "supported" for c in HLL_INPUTS)]


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("family", FAMILIES)
def test_plan_equals_the_reference(reference_plans, family, grouped):
    """The plan is the reference device session's: a single-phase family
    one Complete aggregate over the exchange (collapsed to one partition
    on one device) and its adaptive reader, string min/max one collapsed
    Complete aggregate; the two-phase HLL the one difference."""
    import sys

    from torch_port_jaxref import REPO

    sys.path.insert(0, REPO)
    import chip_smoke as C

    q = query(S, T, S.TpuSession({}, device="cpu"), family, grouped)
    got, want = C.plan_shape(q), reference_plans[f"{family}_{grouped}"]
    if family != "hll":
        assert got == want
        return
    a = ", ".join(a.describe() for a in q.plan.aggregates)
    keys = "g" if grouped else ""
    part = "hashpartitioning(g, 16)" if grouped else "SinglePartition"
    assert want == [ln.format(keys=keys, aggs=a, part=part)
                    for ln in HLL_REFERENCE_PLAN]
    assert got == [f"TpuHashAggregate(Complete) keys=[{keys}] aggs=[{a}]",
                   "  <scan>"]


def _kv(mod, types, session, values, vtype, valid=None, k=None):
    """A (k, v) frame: ``values`` of ``vtype`` (a type name of both
    packages), keys ``k`` (default 0..5)."""
    n = len(values)
    k = np.arange(n) % 6 if k is None else k
    sch = types.StructType([types.StructField("k", types.INT),
                            types.StructField("v", getattr(types, vtype))])
    return frame(mod, session, {"k": k.astype(np.int32), "v": values}, sch,
                 {"v": valid} if valid is not None else None)


def _values(vtype, rng, n=500):
    if vtype == "STRING":
        return WORDS[rng.integers(0, len(WORDS), n)]
    if vtype == "DOUBLE":
        v = rng.normal(0, 1e3, n)
        v[:4] = [np.nan, -0.0, np.inf, np.nan]
        return v
    info = np.iinfo(np.int32 if vtype == "INT" else np.int64)
    return rng.integers(info.min, info.max, n, dtype=info.dtype)


#: the reference's ``tests/test_agg_breadth.py`` cases: name -> (input
#: type, a function of the package's session module -> the aggregate)
REFERENCE_CASES = {
    **{f"percentile_{p}": ("LONG", lambda mod, p=p: mod.percentile_(
        "v", p, "p")) for p in (0.0, 0.25, 0.5, 0.9, 1.0)},
    **{f"approx_percentile_{p}": ("INT", lambda mod, p=p:
                                  mod.approx_percentile_("v", p, name="p"))
       for p in (0.1, 0.5, 0.99)},
    "percentile_doubles_with_nan": ("DOUBLE", lambda mod: mod.percentile_(
        "v", 0.5, "med")),
    **{f"approx_count_distinct_{t.lower()}": (
        t, lambda mod: mod.approx_count_distinct_("v", "acd"))
       for t in ("INT", "LONG", "STRING", "DOUBLE")},
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_breadth_cases(case):
    vtype, agg = REFERENCE_CASES[case]
    vals = _values(vtype, np.random.default_rng(7))
    valid = np.random.default_rng(8).random(len(vals)) > 0.1

    def run(mod, types, session):
        return _kv(mod, types, session, vals, vtype, valid).group_by(
            "k").agg(agg(mod)).collect()

    got = run(S, T, S.TpuSession({}, device="cpu"))
    assert rows_key(got) == rows_key(run(RS, RT, RS.TpuSession(ORACLE)))


def test_global_hll_and_all_null_percentile_group():
    """A global HLL of small ints; a group whose values are all null gives
    null percentiles (the reference's cases)."""
    vals = np.random.default_rng(9).integers(0, 51, 600)

    def hll(mod, types, session):
        return _kv(mod, types, session, vals, "LONG").agg(
            mod.approx_count_distinct_("v", "acd")).collect()

    got = hll(S, T, S.TpuSession({}, device="cpu"))
    assert got == hll(RS, RT, RS.TpuSession(ORACLE))
    assert abs(got[0][0] - 51) <= 3

    def pct(mod, types, session):
        return _kv(mod, types, session, np.array([0, 0, 5]), "LONG",
                   np.array([False, False, True]),
                   np.array([1, 1, 2])).group_by("k").agg(
            mod.percentile_("v", 0.5, "p"),
            mod.approx_percentile_("v", 0.5, name="ap")).collect()

    got = sorted(pct(S, T, S.TpuSession({}, device="cpu")))
    assert got == [(1, None, None), (2, 5.0, 5)]
    assert got == sorted(pct(RS, RT, RS.TpuSession(ORACLE)))


def bloom_query(mod, types, session, probe_seed=99):
    """The reference's runtime-filter case: a filter over 300 values in
    [0, 40], probed by 300 values in [0, 200] through a one-row cross
    join."""
    H = __import__(mod.__name__.rsplit(".", 1)[0] + ".expr.hashexprs",
                   fromlist=["BloomFilterMightContain"])
    build = _kv(mod, types, session, np.random.default_rng(10).integers(
        0, 41, 300), "INT")
    bloom = build.agg(mod.bloom_filter_agg_("v", "bf"))
    probe = _kv(mod, types, session, np.random.default_rng(
        probe_seed).integers(0, 201, 300), "INT")
    return probe.cross_join(bloom).select(
        mod.col("v"),
        H.BloomFilterMightContain(mod.col("bf"), mod.col("v")).alias("mc"))


def test_bloom_filter_join_and_no_false_negatives(reference_bloom_plan):
    import sys

    from torch_port_jaxref import REPO

    sys.path.insert(0, REPO)
    import chip_smoke as C

    got = bloom_query(S, T, S.TpuSession({}, device="cpu"))
    assert C.plan_shape(got) == reference_bloom_plan
    rows = got.collect()
    assert rows_key(rows) == rows_key(bloom_query(
        RS, RT, RS.TpuSession(ORACLE)).collect())
    built = set(np.random.default_rng(10).integers(0, 41, 300).tolist())
    assert all(mc for v, mc in rows if v in built)
    assert any(not mc for v, mc in rows)         # the filter filters
    # every value put in the filter probes true, over longs
    s = S.TpuSession({}, device="cpu")
    vals = np.random.default_rng(12).integers(-2 ** 62, 2 ** 62, 200)
    df = _kv(S, T, s, vals, "LONG")
    from spark_rapids_tpu_torch.expr.hashexprs import (
        BloomFilterMightContain)
    probe = df.cross_join(df.agg(S.bloom_filter_agg_("v", "bf"))).select(
        BloomFilterMightContain(S.col("bf"), S.col("v")).alias("mc"))
    assert all(r[0] is True for r in probe.collect())


@pytest.fixture(scope="module")
def reference_bloom_plan(tmp_path_factory):
    out = run_jax("""
        import sys
        sys.path.insert(0, "tests/port")
        import chip_smoke as C
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        from test_torch_single_phase_aggs import bloom_query
        out["plan"] = np.array(C.plan_shape(
            bloom_query(RS, T, RS.TpuSession({}))))
    """, tmp_path_factory.mktemp("bloom"))
    return list(out["plan"])


def test_one_row_cross_join_keeps_its_row_as_a_view():
    """A right side of one row pairs with the left batch as it is and
    spreads its row as a stride-0 view (no copy of a filter's words into
    every probe row); more rows still pair by index."""
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.exec.join import cross_pairs, left_chunks

    left = ColumnarBatch.from_host_columns(
        [HostColumn.from_pylist(list(range(5)), T.LONG)], ["a"], "cpu")
    words = HostColumn.from_pylist([[1, -1, 2 ** 62]],
                                   T.ArrayType(T.LONG, False))
    right = ColumnarBatch.from_host_columns([words], ["bf"], "cpu")
    sch = T.StructType(list(left.schema.fields) + list(right.schema.fields))
    out = cross_pairs(left, right, sch)
    assert out.num_rows == 5
    assert out.columns[0].data.data_ptr() == left.columns[0].data.data_ptr()
    bf = out.columns[1]
    for t in bf.tensors():
        assert t.stride(0) == 0
    assert bf.data.data_ptr() == right.columns[0].data.data_ptr()
    assert out.to_rows() == [(a, [1, -1, 2 ** 62]) for a in range(5)]
    assert [b.num_rows for b in left_chunks(left, 1, 2)] == [5]
    two = ColumnarBatch.concat([right, right])
    assert cross_pairs(left, two, sch).num_rows == 10
    assert [b.num_rows for b in left_chunks(left, 2, 4)] == [2, 2, 1]


def test_collect_width_is_the_largest_groups_bucket():
    """The lists are as wide as the bucket of the largest group's rows
    (``round_up_bucket``): 9 rows in a group make width 32."""
    s = S.TpuSession({}, device="cpu")
    k = np.array([1] * 9 + [2] * 3)
    df = _kv(S, T, s, np.arange(12), "LONG", k=k)
    q = df.group_by("k").agg(S.collect_list_("v", "c"))
    cols = q.collect_host()
    assert cols[1].ewidth == 32
    assert sorted(q.collect()) == [(1, list(range(9))), (2, [9, 10, 11])]


def test_hll_rank_counts_leading_zeros_of_every_word():
    """The register rank's leading-zero count is exact for 0, negative
    words and every single bit."""
    from spark_rapids_tpu_torch.exec.aggregate import _clz64

    words = [0, -1, 1, -2 ** 63, 2 ** 62] + [1 << b for b in range(63)]
    want = [64, 0, 63, 0, 1] + [63 - b for b in range(63)]
    got = _clz64(torch.tensor(words, dtype=torch.int64)).tolist()
    assert got == want

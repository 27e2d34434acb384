"""The per-stage CPU fallback of the port against the JAX package: the
tagging (``overrides/meta.py``) by the reference's own reasons, the
conversion with CPU stages (``TpuRowToColumnarExec`` under a device
parent, ``TpuMaterializedScan`` under a CPU node) and the port's CPU engine
(``cpu/oracle.py``).  Plans and their ``Fallback reasons`` are held
against the reference's ``explain`` (child process, planned and never
collected); rows against the reference's CPU oracle session.  A node the
reference runs on the device but the port has not ported still raises
``NotOnGpu``, as does a CPU stage the port's engine cannot run."""
import importlib
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu.expr.base import SparkArithmeticException as RErr
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from spark_rapids_tpu_torch.expr.base import (Literal,
                                              SparkArithmeticException)
from spark_rapids_tpu_torch.expr.complextypes import (CreateNamedStruct,
                                                      GetStructField)
from spark_rapids_tpu_torch.plan.nodes import LocalTableScan
from torch_port_frames import ORACLE, rows_key
from torch_port_jaxref import REPO, run_jax

N = 300


def _schema(mod):
    st = mod.StructType([mod.StructField("a", mod.LONG),
                         mod.StructField("b", mod.INT)])
    return mod.StructType([
        mod.StructField("i", mod.INT), mod.StructField("l", mod.LONG),
        mod.StructField("d", mod.DecimalType(12, 2)),
        mod.StructField("m", mod.DecimalType(25, 4)),
        mod.StructField("f", mod.BOOLEAN), mod.StructField("s", st)])


def _data():
    """Columns with nulls and values at the edges of their types."""
    rng = np.random.default_rng(17)
    i = rng.integers(-2 ** 31, 2 ** 31, N)
    i[:4] = [2 ** 31 - 1, -2 ** 31, 0, 5]
    l = rng.integers(-2 ** 62, 2 ** 62, N)
    d = rng.integers(-10 ** 11, 10 ** 11, N)
    m = [int(v) * 10 ** 6 + int(w) for v, w in
         zip(rng.integers(-10 ** 14, 10 ** 14, N), rng.integers(0, 10 ** 6,
                                                               N))]
    valid = {k: rng.random(N) > 0.15 for k in "ildmfs"}
    pick = (lambda k, vals: [None if not valid[k][r] else vals[r]
                             for r in range(N)])
    return {"i": pick("i", [int(v) for v in i]),
            "l": pick("l", [int(v) for v in l]),
            "d": pick("d", [Decimal(int(v)).scaleb(-2) for v in d]),
            "m": pick("m", [Decimal(v).scaleb(-4) for v in m]),
            "f": pick("f", [bool(v) for v in rng.random(N) > 0.5]),
            "s": pick("s", [(int(a), int(b)) for a, b in zip(
                rng.integers(0, 10 ** 6, N), rng.integers(-9, 9, N))])}


def base(mod, session):
    types = importlib.import_module(mod.__name__.rsplit(".", 1)[0]
                                    + ".types")
    return session.create_dataframe(_data(), _schema(types))


def expressions(mod):
    """Expressions the port runs on the card, over every column kind:
    wraps, decimal overflow to null, HALF_UP rescales, three-valued
    logic, null tests, coalesce; and a decimal multiply with an operand
    above 18 digits, which the reference keeps off the device."""
    pkg = mod.__name__.rsplit(".", 1)[0]
    types = importlib.import_module(pkg + ".types")
    CO = importlib.import_module(pkg + ".expr.conditional")
    c, lit = mod.col, mod.lit
    return [
        c("i"),
        (c("i") + c("i")).alias("ii"),
        (c("l") * c("l")).alias("ll"),
        (c("l") - c("i")).alias("li"),
        (c("d") + c("d")).alias("dd"),
        (c("d") - c("m")).alias("dm"),
        (c("d") * c("d")).alias("d2"),
        c("i").cast(types.DecimalType(12, 2)).alias("ci"),
        c("m").cast(types.DecimalType(20, 1)).alias("cm"),
        c("d").cast(types.DecimalType(5, 1)).alias("cd"),
        c("l").cast(types.INT).alias("cl"),
        (c("i") > lit(5)).alias("gt"),
        (c("m") <= c("d")).alias("le"),
        c("i").eq(c("l")).alias("eq"),
        ((c("i") > lit(0)) & c("f")).alias("a"),
        ((c("i") > lit(0)) | c("f")).alias("o"),
        (~c("f")).alias("n"),
        c("i").is_null().alias("isn"),
        c("m").is_not_null().alias("inn"),
        CO.Coalesce([c("i"), lit(7)]).alias("co"),
        CO.Nvl(c("d"), c("m")).alias("nv"),
        (c("m") * c("d")).alias("m2"),
    ]


def query(mod, session):
    return (base(mod, session).filter(mod.col("i").is_not_null()
                                      | mod.col("f"))
            .select(*expressions(mod)))


def reference_explain(tmp_path, conf, builder):
    """The reference's explain lines of ``builder(RS, session)`` (a
    function of this module) under ``conf``."""
    out = run_jax(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        sys.path.insert(0, {REPO + '/tests/port'!r})
        import spark_rapids_tpu.session as RS
        import test_torch_fallback as F
        df = F.{builder}(RS, RS.TpuSession({conf!r}))
        out["plan"] = np.array(df.explain().splitlines())
    """, tmp_path)
    return list(out["plan"])


@pytest.mark.parametrize("disabled", [None, "Project", "Filter"])
def test_cpu_stage_rows_and_plan_match_reference(tmp_path, disabled):
    """The decimal multiply above 18 digits keeps the Project off the
    device (a CPU stage at the root over the device filter); disabling
    the Filter as well puts both on the host; the rows are the oracle's,
    the plan and reasons the reference's."""
    conf = {} if disabled is None else {f"spark.rapids.sql.exec."
                                        f"{disabled}": "false"}
    df = query(S, S.TpuSession(conf, device="cpu"))
    lines = df.explain().splitlines()
    assert lines == reference_explain(tmp_path, conf, "query")
    assert lines[0].startswith("Project [")
    assert "Fallback reasons:" in lines
    want = query(RS, RS.TpuSession(dict(conf, **ORACLE))).collect()
    assert rows_key(df.collect()) == rows_key(want)


def struct_under_aggregate(mod, session):
    return (base(mod, session).filter(mod.col("i") > mod.lit(0))
            .select(mod.col("f"), importlib.import_module(
                mod.__name__.rsplit(".", 1)[0] + ".expr.complextypes")
                .GetStructField(mod.col("s"), "a").alias("sa"))
            .group_by("f").agg(mod.sum_("sa", "t"), mod.count_(None, "c")))


def test_struct_reference_is_a_cpu_stage_under_the_aggregate(tmp_path):
    """A struct ``BoundReference`` keeps its Project on the host between
    the device filter and the device aggregate, as in the reference."""
    df = struct_under_aggregate(S, S.TpuSession({}, device="cpu"))
    lines = df.explain().splitlines()
    assert lines == reference_explain(tmp_path, {}, "struct_under_aggregate")
    assert lines[1] == "  TpuRowToColumnar <- Project [f, s.a AS sa]"
    assert lines[-1].endswith("struct<a:bigint,b:int> is not supported")
    r2c = df._planned().children[0]
    mat = r2c.cpu_plan.children[0]
    assert mat.describe() == "ColumnarToRow <- TpuFilter ((i > 0))"
    want = struct_under_aggregate(RS, RS.TpuSession(ORACLE)).collect()
    assert rows_key(df.collect()) == rows_key(want)
    # the CPU stage's own rows: the oracle's Project over the same filter
    stage = r2c.run_cpu_stage()
    oracle = (base(RS, RS.TpuSession(ORACLE))
              .filter(RS.col("i") > RS.lit(0))
              .select(RS.col("f"), RS.col("s"))).collect()
    got = list(zip(*[h.to_pylist() for h in stage]))
    assert rows_key(got) == rows_key(
        [(f, None if s is None else s[0]) for f, s in oracle])


def test_unported_device_nodes_still_raise():
    """A string literal or column runs on the device and in a CPU stage
    now, and so do the max and the avg of a string (the avg parses it, as
    the reference's cast does: 2.0 over "1.5", "2.5" and NULL, the
    oracle's row); a string picked out of a struct in a CPU stage is not
    ported: ``NotOnGpu``, never a wrong row.  A disabled sort or aggregate
    is a CPU stage of the port's engine, with the oracle's rows; the
    whole-query oracle still raises.  (The name is kept from when more of
    these raised.)"""
    s = S.TpuSession({}, device="cpu")
    df = base(S, s).select(S.col("i"), Literal("x", T.STRING).alias("x"))
    assert {x for _, x in df.collect()} == {"x"}
    names = HostColumn.from_pylist(["a", None, "b"], T.STRING)
    df = S.DataFrame(LocalTableScan([names], T.StructType(
        [T.StructField("name", T.STRING)])), s)
    assert df.filter(S.col("name").is_not_null()).collect() == [("a",),
                                                                ("b",)]
    assert df.agg(S.max_("name", "m")).collect() == [("b",)]
    nums = HostColumn.from_pylist(["1.5", None, "2.5"], T.STRING)
    df = S.DataFrame(LocalTableScan([nums], T.StructType(
        [T.StructField("t", T.STRING)])), s)
    want = RS.TpuSession(ORACLE).create_dataframe(
        {"t": ["1.5", None, "2.5"]}, RT.StructType(
            [RT.StructField("t", RT.STRING)])).agg(RS.avg_("t", "m"))
    assert df.agg(S.avg_("t", "m")).collect() == want.collect() == [(2.0,)]
    s = S.TpuSession({"spark.rapids.sql.exec.Project": "false"},
                     device="cpu")
    # a string literal now passes through a CPU stage; a string picked
    # out of a struct does not
    df = base(S, s).select(S.col("i"), Literal("x", T.STRING).alias("x"))
    assert {x for _, x in df.collect()} == {"x"}
    named = CreateNamedStruct(["x"], [Literal("x", T.STRING)])
    df = base(S, s).select(GetStructField(named, "x").alias("x"))
    with pytest.raises(NotOnGpu, match="type string in a CPU stage"):
        df.explain()
    for node in ("Sort", "HashAggregate"):
        conf = {f"spark.rapids.sql.exec.{node}": "false"}

        def build(mod, sess, node=node):
            return (base(mod, sess).order_by("i") if node == "Sort"
                    else base(mod, sess).agg(mod.sum_("i", "t")))
        df = build(S, S.TpuSession(conf, device="cpu"))
        assert df.explain().startswith(node)
        want = build(RS, RS.TpuSession(dict(conf, **ORACLE))).collect()
        assert rows_key(df.collect(), ordered=True) == rows_key(
            want, ordered=True)
    s = S.TpuSession({"spark.rapids.sql.enabled": False}, device="cpu")
    with pytest.raises(NotOnGpu, match="whole-query CPU oracle"):
        base(S, s).collect()


def test_ansi_errors_in_a_cpu_stage_match_the_oracle():
    """Under ANSI an integer overflow in a CPU stage raises, as the
    oracle does; a row that does not overflow passes."""
    conf = {"spark.sql.ansi.enabled": "true",
            "spark.rapids.sql.exec.Project": "false"}
    for mod, sess, err in ((S, S.TpuSession(conf, device="cpu"),
                            SparkArithmeticException),
                           (RS, RS.TpuSession(dict(conf, **ORACLE)), RErr)):
        df = base(mod, sess)
        with pytest.raises(err):
            df.select((mod.col("i") + mod.col("i")).alias("x")).collect()
        ok = df.filter(mod.col("i").eq(mod.lit(5))).select(
            (mod.col("i") + mod.col("i")).alias("x")).collect()
        assert ok == [(10,)]


def test_union_of_cpu_and_device_children(tmp_path):
    """A union over a CPU stage and a device scan: a CPU child under the
    device union goes through ``TpuRowToColumnarExec``."""
    conf = {"spark.rapids.sql.exec.Filter": "false"}

    def build(mod, session):
        df = base(mod, session).select(mod.col("i"), mod.col("l"))
        return df.filter(mod.col("i") > mod.lit(0)).union(df)

    df = build(S, S.TpuSession(conf, device="cpu"))
    lines = df.explain().splitlines()
    assert lines[0] == "TpuUnionExec"
    assert lines[1].startswith("  TpuRowToColumnar <- Filter")
    want = build(RS, RS.TpuSession(dict(conf, **ORACLE))).collect()
    assert rows_key(df.collect()) == rows_key(want)



def test_cpu_engine_runs_every_ported_expression():
    """One set names the expressions the port runs (``overrides/meta.py``):
    the CPU engine has a handler for each of them and for nothing else."""
    from spark_rapids_tpu_torch.cpu import oracle
    from spark_rapids_tpu_torch.overrides.meta import PORTED_EXPRS

    assert set(oracle._HANDLERS) == PORTED_EXPRS


def test_cpu_engine_runs_the_nested_loop_join():
    """The CPU engine's plan nodes are the scan, filter, project, union,
    the nested-loop join, the aggregate, the three hash joins, the sort,
    the limits, the window and the exchanges passed through: a
    nested-loop join kept off the device (its exec disabled) is a CPU
    stage, with the reference's reason, whose rows are the device's; an
    equi-join with a residual condition that is not inner, which the
    reference runs as a CPU stage, gives Spark's rows there: each left
    row with the right rows that pass the condition, or nulls (the
    reference's hash-join oracle drops the condition, ROADMAP R26).
    (The name is kept from when the engine ran no hash join.)"""
    from spark_rapids_tpu_torch.cpu import oracle
    from spark_rapids_tpu_torch.plan import nodes as PN

    assert oracle.CPU_PLAN_NODES == {
        PN.LocalTableScan, PN.Filter, PN.Project, PN.Union,
        PN.BroadcastNestedLoopJoin, PN.HashAggregate, PN.SortMergeJoin,
        PN.ShuffledHashJoin, PN.BroadcastHashJoin, PN.Sort, PN.GlobalLimit,
        PN.LocalLimit, PN.Window, PN.Exchange, PN.BroadcastExchange}

    def joined(s, how="inner"):
        left = base(S, s).select("i", "d")
        right = base(S, s).select(S.col("i").alias("j")).filter(
            S.col("j") < S.lit(-2 ** 30))
        return left.join(right, S.col("i") > S.col("j"), how)

    off = S.TpuSession({"spark.rapids.sql.exec.BroadcastNestedLoopJoin":
                        "false"}, device="cpu")
    df = joined(off)
    lines = df.explain().splitlines()
    assert lines[0].startswith("BroadcastNestedLoopJoin Inner")
    assert lines[-1].endswith(
        "has been disabled by "
        "spark.rapids.sql.exec.BroadcastNestedLoopJoin=false")
    want = joined(S.TpuSession({}, device="cpu")).collect()
    assert len(want) > 100
    assert rows_key(df.collect()) == rows_key(want)
    s = S.TpuSession({}, device="cpu")
    left = base(S, s).select("i", "l")
    right = base(S, s).select(S.col("i").alias("k"), S.col("l").alias("n"))
    node = PN.BroadcastHashJoin(
        left.plan, PN.BroadcastExchange(right.plan),
        [S.col("i").resolve(left.schema)], [S.col("k").resolve(right.schema)],
        PN.JoinType.LEFT_OUTER)
    df = S.DataFrame(node, s)
    node.condition = (S.col("n") > S.col("i")).resolve(df.schema)
    lines = df.explain().splitlines()
    assert lines[0].startswith("BroadcastHashJoin LeftOuter")
    assert lines[-1].endswith("non-inner join with residual condition is "
                              "not supported on TPU")
    # each key meets its own row only (i is unique): a row whose l > i
    # keeps its pair, the others (and the null keys) get nulls
    rows = base(S, s).select("i", "l").collect()
    assert len({i for i, _ in rows if i is not None}) == sum(
        1 for i, _ in rows if i is not None)
    want = [(i, l, i, l) if i is not None and l is not None and l > i
            else (i, l, None, None) for i, l in rows]
    assert 20 < sum(1 for w in want if w[2] is not None) < len(want) - 20
    assert rows_key(df.collect()) == rows_key(want)


def test_open_breaker_entry_keeps_the_node_on_the_host():
    """An OPEN circuit-breaker entry for the Filter's key
    (``resilience/breaker.py``) places the Filter as
    ``spark.rapids.sql.exec.Filter=false`` does, with the breaker's reason;
    the rows stay the oracle's.  A TTL that has passed admits the node
    again (the half-open probe), and so does
    ``spark.rapids.tpu.resilience.enabled=false``."""
    from spark_rapids_tpu_torch import perfcounters as PC
    from spark_rapids_tpu_torch.resilience import breaker as B

    def plan_lines(conf):
        lines = query(S, S.TpuSession(conf, device="cpu")).explain()
        return lines.splitlines()

    def head(lines):
        return lines[:lines.index("Fallback reasons:")]

    on_device = plan_lines({})
    disabled = plan_lines({"spark.rapids.sql.exec.Filter": "false"})
    df = query(S, S.TpuSession({}, device="cpu"))
    node = df.plan
    while type(node).__name__ != "Filter":
        node = node.children[0]
    B.reset_breaker()
    try:
        B.get_breaker().record_failure(B.plan_key(node), 1, "injected")
        before = PC.snapshot()
        lines = df.explain().splitlines()
        assert PC.since(before)["breaker_plan_fallbacks"] == 1
        assert head(lines) == head(disabled) != head(on_device)
        assert any("circuit breaker open for Filter after 1 "
                   "deterministic failure(s) (injected)" in x
                   for x in lines)
        want = query(RS, RS.TpuSession(ORACLE)).collect()
        assert rows_key(df.collect()) == rows_key(want)
        assert plan_lines({"spark.rapids.tpu.resilience.enabled":
                           "false"}) == on_device
        assert plan_lines({"spark.rapids.tpu.resilience.breakerTtlSec":
                           "0"}) == on_device
        assert B.get_breaker().state_of(B.plan_key(node)) == B.HALF_OPEN
    finally:
        B.reset_breaker()

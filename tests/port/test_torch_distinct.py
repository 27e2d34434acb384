"""``count_distinct_`` and ``sum_distinct_`` against the JAX package: the
single-distinct-column rewrite plans the reference's two aggregates (a
dedup aggregate on the keys and the column, without functions, under the
plain aggregate; plans against its device session's ``explain``, planned
in the child process), and the rows equal its CPU oracle session's,
global and grouped, with null keys and null values, over one batch and
over several.  Mixing distinct and plain aggregates, and distinct
aggregates over two columns, raise the reference's
``NotImplementedError``s.  Every comparison is exact."""
from decimal import Decimal

import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from torch_port_frames import ORACLE, frame, rows_key
from torch_port_jaxref import run_jax

N = 600
COLUMNS = ["v", "d"]
BATCHES = {"one_batch": {}, "batches": {
    "spark.rapids.sql.reader.batchSizeRows": 100}}


def query(mod, types, session, column, grouped):
    rng = np.random.default_rng(17)
    arr = {"g": rng.integers(0, 6, N).astype(np.int32),
           "v": rng.integers(-20, 20, N).astype(np.int32),
           "d": rng.integers(-500, 500, N)}
    valid = {k: rng.random(N) > 0.15 for k in arr}
    sch = types.StructType([types.StructField("g", types.INT),
                            types.StructField("v", types.INT),
                            types.StructField("d", types.DecimalType(9, 2))])
    df = frame(mod, session, arr, sch, valid)
    gb = df.group_by("g") if grouped else df.group_by()
    return gb.agg(mod.count_distinct_(column, "cd"),
                  mod.sum_distinct_(column, "sd"))


@pytest.fixture(scope="module")
def reference_plans(tmp_path_factory):
    out = run_jax("""
    import sys
    sys.path.insert(0, "tests/port")
    import chip_smoke as C
    import spark_rapids_tpu.session as RS
    from spark_rapids_tpu import types as T
    import test_torch_distinct as M
    for column in M.COLUMNS:
        for grouped in (False, True):
            q = M.query(RS, T, RS.TpuSession({}), column, grouped)
            out[f"{column}-{grouped}"] = np.array(C.plan_shape(q))
            out[f"{column}-{grouped}-schema"] = np.array(
                [q.schema.simpleString])
    """, tmp_path_factory.mktemp("distinct"))
    return out


@pytest.mark.parametrize("batches", sorted(BATCHES))
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("column", COLUMNS)
def test_distinct_aggregates_match_the_reference(column, grouped, batches,
                                                 reference_plans):
    import sys

    from torch_port_jaxref import REPO

    sys.path.insert(0, REPO)
    import chip_smoke as C

    q = query(S, T, S.TpuSession(BATCHES[batches], device="cpu"), column,
              grouped)
    assert C.plan_shape(q) == list(reference_plans[f"{column}-{grouped}"])
    assert q.schema.simpleString == str(
        reference_plans[f"{column}-{grouped}-schema"][0])
    want = rows_key(query(RS, RT, RS.TpuSession(ORACLE), column,
                          grouped).collect())
    got = q.collect()
    assert rows_key(got) == want
    assert len(got) == (7 if grouped else 1)      # six keys and the null
    if column == "d" and not grouped:
        assert isinstance(got[0][1], Decimal)


@pytest.mark.parametrize("mod,types", [(S, T), (RS, RT)],
                         ids=["port", "reference"])
def test_unsupported_distinct_mixes_raise(mod, types):
    """The two shapes the rewrite does not take raise, in the reference's
    words, before anything is planned."""
    s = (mod.TpuSession({}, device="cpu") if mod is S
         else mod.TpuSession(ORACLE))
    sch = types.StructType([types.StructField("a", types.INT),
                            types.StructField("b", types.INT)])
    df = s.create_dataframe({"a": [1, 2], "b": [3, 4]}, sch)
    with pytest.raises(NotImplementedError,
                       match="mixing distinct and non-distinct"):
        df.agg(mod.count_distinct_("a", "x"), mod.sum_("b", "y"))
    with pytest.raises(NotImplementedError, match="over multiple columns"):
        df.agg(mod.count_distinct_("a", "x"), mod.sum_distinct_("b", "y"))

"""The table, aggregates and queries of the single-phase aggregate tests
(``test_torch_single_phase_aggs.py``), shared with the card tests
(``test_torch_gpu.py``): it imports no jax.  Each query is built in the
package whose session module is ``mod``."""
import numpy as np

from torch_port_frames import frame

N = 1500
WORDS = np.array(["x", "yy", "", "zebra", "a\x00", "a", "naïve café",
                  "a much longer string past the first width bucket"],
                 object)


def schema(mod):
    return mod.StructType([
        mod.StructField("g", mod.INT), mod.StructField("i", mod.INT),
        mod.StructField("l", mod.LONG), mod.StructField("d", mod.DOUBLE),
        mod.StructField("m", mod.DecimalType(7, 2)),
        mod.StructField("dt", mod.DATE), mod.StructField("s", mod.STRING)])


def data():
    rng = np.random.default_rng(41)
    g = rng.integers(0, 9, N).astype(np.int32)
    d = np.round(rng.normal(0, 50, N), 1)
    d[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
    arr = {"g": g, "i": rng.integers(-40, 40, N).astype(np.int32),
           "l": rng.integers(-2 ** 40, 2 ** 40, N), "d": d,
           "m": rng.integers(-10 ** 7 + 1, 10 ** 7, N),
           "dt": rng.integers(8000, 8400, N).astype(np.int32),
           "s": WORDS[rng.integers(0, len(WORDS), N)]}
    valid = {k: rng.random(N) > 0.1 for k in arr}
    valid["g"] = rng.random(N) > 0.05     # the null key's group
    for k in arr:
        if k != "g":
            valid[k] &= g != 8            # group 8: every input null
    return arr, valid


HLL_INPUTS = ("i", "l", "d", "m", "dt", "s")


def aggs(mod, family):
    """Each family's aggregates, built with the package's helpers."""
    F = {
        "collect": lambda: [
            mod.collect_list_("i", "cl_i"), mod.collect_list_("d", "cl_d"),
            mod.collect_list_("dt", "cl_dt"), mod.collect_set_("l", "cs_l"),
            mod.collect_set_("d", "cs_d"), mod.collect_set_("m", "cs_m")],
        "percentile": lambda: [
            mod.median_("d", "md_d"), mod.median_("m", "md_m"),
            mod.percentile_("l", 0.25, "p25_l"),
            mod.percentile_("i", 0.9, "p90_i"),
            mod.approx_percentile_("d", 0.5, name="ap_d"),
            mod.approx_percentile_("m", 0.1, name="ap_m")],
        "hll": lambda: [mod.approx_count_distinct_(c, f"h_{c}")
                        for c in HLL_INPUTS],
        "bloom": lambda: [
            mod.bloom_filter_agg_("l", "bf_l", 300, 4096),
            mod.bloom_filter_agg_("s", "bf_s", 50, 640)],
        "string_minmax": lambda: [mod.min_("s", "s_min"),
                                  mod.max_("s", "s_max")],
        "mixed": lambda: [mod.median_("l", "md"),
                          mod.approx_count_distinct_("i", "h"),
                          mod.count_("s", "c"), mod.min_("s", "s_min"),
                          mod.collect_set_("i", "cs")],
    }
    return F[family]()


FAMILIES = ("collect", "percentile", "hll", "bloom", "string_minmax",
            "mixed")
BATCHES = {"one_batch": {}, "batches": {
    "spark.rapids.sql.reader.batchSizeRows": 300}}


def query(mod, types, session, family, grouped=True, empty=False):
    arr, valid = data()
    df = frame(mod, session, arr, schema(types), valid)
    if empty:
        df = df.filter(mod.col("g") > mod.lit(100))
    gb = df.group_by("g") if grouped else df.group_by()
    return gb.agg(*aggs(mod, family))

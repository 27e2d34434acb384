"""The Parquet reader types on the port against the JAX package: for 1 and
8 files, in each of AUTO (the default), PERFILE, COALESCING and
MULTITHREADED, the scan's ``describe`` is the reference's (AUTO resolves
to MULTITHREADED for more than one file, else COALESCING; child process,
planned and never collected) and its rows, decoded on the device, are the
reference's CPU oracle's in file order.  Host decode still raises."""
import numpy as np
import pytest

import spark_rapids_tpu.session as RS
import spark_rapids_tpu_torch.session as S
from spark_rapids_tpu import types as RT
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.base import NotOnGpu
from torch_port_frames import ORACLE, rows_key, write_parquet_files
from torch_port_jaxref import run_jax

MODES = ["AUTO", "PERFILE", "COALESCING", "MULTITHREADED"]
DEVICE = {"spark.rapids.sql.format.parquet.decode.device": True}


def _schema(mod):
    return mod.StructType([mod.StructField("k", mod.INT),
                           mod.StructField("v", mod.LONG),
                           mod.StructField("m", mod.DecimalType(9, 2))])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("readers")
    rng = np.random.default_rng(3)
    n = 2400
    arrays = {"k": rng.integers(0, 50, n).astype(np.int32),
              "v": rng.integers(-10 ** 9, 10 ** 9, n),
              "m": rng.integers(-10 ** 8, 10 ** 8, n)}
    return {nf: write_parquet_files(d, f"t{nf}", arrays, _schema(RT), nf)
            for nf in (1, 8)}


def _conf(mode):
    return dict(DEVICE, **{"spark.rapids.sql.format.parquet.reader.type":
                           mode})


@pytest.fixture(scope="module")
def reference_scans(files, tmp_path_factory):
    out = run_jax(f"""
        import spark_rapids_tpu.session as RS
        from spark_rapids_tpu import types as T
        sch = T.StructType([T.StructField("k", T.INT),
                            T.StructField("v", T.LONG),
                            T.StructField("m", T.DecimalType(9, 2))])
        for nf, paths in {files!r}.items():
            for mode in {MODES!r}:
                conf = {DEVICE!r}
                conf["spark.rapids.sql.format.parquet.reader.type"] = mode
                df = RS.TpuSession(conf).read.schema(sch).parquet(*paths)
                out[f"{{nf}}-{{mode}}"] = np.array(df.explain().splitlines())
    """, tmp_path_factory.mktemp("readers_ref"))
    return {k: list(v) for k, v in out.items()}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nfiles", [1, 8])
def test_reader_type_describe_and_rows_match_reference(files, nfiles, mode,
                                                       reference_scans):
    paths = files[nfiles]
    df = S.TpuSession(_conf(mode), device="cpu").read.schema(
        _schema(T)).parquet(*paths)
    lines = df.explain().splitlines()
    assert lines == reference_scans[f"{nfiles}-{mode}"]
    want_mode = mode if mode != "AUTO" else (
        "MULTITHREADED" if nfiles > 1 else "COALESCING")
    assert lines == [f"TpuFileSourceScan parquet {nfiles} files "
                     f"mode={want_mode}"]
    want = RS.TpuSession(dict(_conf(mode), **ORACLE)).read.schema(
        _schema(RT)).parquet(*paths).collect()
    assert rows_key(df.collect(), ordered=True) == rows_key(want,
                                                            ordered=True)


def test_host_decode_still_raises(files):
    df = S.TpuSession({}, device="cpu").read.schema(_schema(T)).parquet(
        *files[8])
    with pytest.raises(NotOnGpu, match="pyarrow"):
        df.collect()

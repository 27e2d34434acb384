"""Device primitives shared by the operators: sort keys, segmented
reductions, compaction and gathers (port of ``spark_rapids_tpu/ops/``)."""

"""Device primitives shared by the operators: sort keys, segmented
reductions, compaction, gathers and Spark-exact murmur3 hashing (port of ``spark_rapids_tpu/ops/``)."""

"""spark_rapids_tpu_torch — the PyTorch and CUDA port of ``spark_rapids_tpu``.

The package runs the engine on ``torch`` tensors, on an NVIDIA H100 by
default (pass ``device="cpu"`` to run on the CPU).  It keeps the JAX
package's module layout and public names so each module sits beside its
counterpart, and it imports neither ``jax`` nor ``spark_rapids_tpu``.
It runs TPC-H Q6 end to end (a Parquet or in-memory scan, the filter,
the decimal product and the 128-bit sum) and bench qa (a broadcast hash
join, a sort-based grouped sum and a top-N).
"""

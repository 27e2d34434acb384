"""spark_rapids_tpu_torch — the PyTorch and CUDA port of ``spark_rapids_tpu``.

The package runs the engine on ``torch`` tensors, on an NVIDIA H100 by
default (pass ``device="cpu"`` to run on the CPU).  It keeps the JAX
package's module layout and public names so each module sits beside its
counterpart, and it imports neither ``jax`` nor ``spark_rapids_tpu``.
It runs TPC-H Q6 end to end (a Parquet or in-memory scan, the filter,
the decimal product and the 128-bit sum), bench qa, qb and qc (broadcast,
shuffled and adaptive joins, sort-based grouped sums, a rank window, a
top-N), the out-of-core path of bench's rung3_ooc (size-aware hash
exchanges over spill-backed partition queues, the spill framework and the
sub-partitioned join), bench's rung3 (CPU stages, the out-of-core sort),
and bench's rung4_dist: exchanges over worker processes (``distributed/``)
that survive a killed worker, every collect under the query lifecycle
(``lifecycle/``).  This file imports nothing, so a worker process
(``python -m spark_rapids_tpu_torch.distributed.worker``) starts without
torch.
"""

"""Device decode kernels.  The directory keeps the reference's name
(``spark_rapids_tpu/pallas/``) so each module sits beside its counterpart;
the kernels here are CUDA C++ for Hopper, sources under ``csrc/``."""

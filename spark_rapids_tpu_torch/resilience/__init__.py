"""Resilience — port of the part of ``spark_rapids_tpu/resilience/`` that
the distributed tier uses: the failure taxonomy (``classify.py``) and the
circuit breaker (``breaker.py``).  The fault-injection harness, the
per-operator fault domain and the runtime CPU fallback are not ported."""

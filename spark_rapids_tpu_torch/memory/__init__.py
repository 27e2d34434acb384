"""Memory runtime — port of ``spark_rapids_tpu/memory/`` without the
semaphore: the pool (``device_manager.py``), spillable batches with device,
pinned-host and disk tiers (``spill.py``) and the cooperative OOM retry
(``retry.py``)."""

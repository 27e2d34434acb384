"""Shuffle — port of ``spark_rapids_tpu/shuffle/``: the TKU2 wire format
(``serializer.py``), the spill-backed partition queues of the out-of-core
exchange and the distributed lineage buffer (``partition_queues.py``), and
the shuffle manager (``manager.py``)."""

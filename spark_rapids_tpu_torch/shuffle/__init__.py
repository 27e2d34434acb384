"""Shuffle — port of ``spark_rapids_tpu/shuffle/`` without the shuffle
manager: the TKU2 wire format (``serializer.py``) and the spill-backed
partition queues of the out-of-core exchange (``partition_queues.py``)."""

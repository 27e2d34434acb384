"""Plan fingerprints (port of ``spark_rapids_tpu/compilecache/``, keys
only: the port compiles no programs to cache)."""

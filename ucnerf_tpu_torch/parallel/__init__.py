"""Data parallelism over processes (port of ``ucnerf_tpu/parallel``)."""

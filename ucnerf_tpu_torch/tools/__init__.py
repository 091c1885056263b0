"""Experiment tools of the port (counterparts of the JAX package's
``tools/`` scripts), each run as ``python -m ucnerf_tpu_torch.tools.<name>``."""

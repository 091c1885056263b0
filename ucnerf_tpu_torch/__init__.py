"""PyTorch/CUDA port of ``ucnerf_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``train/``, ``data/``) and its channel-major public
layouts, so each function has an obvious counterpart to be tested against.
It imports torch and never jax or ``ucnerf_tpu``.

Ported so far: the canonical Waymo model's render path and training step
(``train/step.py``), the training entry point (``cli/train.py``), the
serving and extraction entry points (``cli/{eval,render,extract,tsdf}.py``)
and the CER-MVS depth estimator (``models/mvs/``, ``cli/mvs_train.py``,
``cli/mvs_depth.py``).  Every Pallas kernel of the JAX package has a
hand-written CUDA counterpart in ``csrc/`` (the hash-grid gather in
``gather.cu``, the table-gradient scatters in ``scatter.cu`` and
``scatter_chunked.cu``), launched on CUDA tensors by the wrappers in
``ops/gather.py`` and ``ops/scatter.py``; on CPU tensors every wrapper runs
its plain PyTorch version instead.  The MVS path reaches no Pallas kernel
and runs on PyTorch calls.
"""

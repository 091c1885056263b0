"""PyTorch/CUDA port of ``ucnerf_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its layout
(``ops/``, ``models/``, ``train/``, ``data/``) and its channel-major public
layouts, so each function has an obvious counterpart to be tested against.
It imports torch and never jax or ``ucnerf_tpu``.

Ported so far: the serving (render) path of the canonical Waymo model.  Its
forward hash-grid lookup runs the hand-written CUDA kernel in
``csrc/gather.cu`` on the card (``ops/gather.py``); on CPU tensors every
kernel wrapper runs its plain PyTorch version instead.
"""

"""Carry parameters from the JAX package into the port.

``params_from_jax(tree)`` takes the JAX model's parameter tree (nested dicts
of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) and returns the
port's ``state_dict``.  The port's modules carry the JAX names, so the only
changes are the dotted keys and the dense kernels: JAX stores them [in, out]
as ``kernel``, torch as ``weight`` [out, in].  Hash tables stay channel-major
[C, rows] on both sides.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX parameter tree -> the port's state_dict (float32 CPU tensors)."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(params_from_jax(value, name + "."))
            continue
        arr = np.array(value, np.float32)
        if key == "kernel":
            name = f"{prefix}weight"
            arr = arr.T
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out

"""Carry parameters between the JAX package and the port.

``params_from_jax(tree)`` takes the JAX model's parameter tree (nested dicts
of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``) and returns the
port's ``state_dict``; ``params_to_jax(state_dict)`` is its inverse (used to
compare the port's gradients with a JAX gradient tree leaf by leaf).  The
port's modules carry the JAX names, so the only changes are the dotted keys
and the kernels: JAX stores a dense kernel [in, out] and a conv kernel
[kh, kw, in, out] as ``kernel``, torch as ``weight`` [out, in] and
[out, in, kh, kw].  Hash tables stay channel-major [C, rows] on both sides.
The field's option layers (``normal_layer``, ``lin_glo_*``, the wider
``density_hidden`` of scale featurization) carry the JAX names and shapes,
so they cross the same way; both hold the GLO layers only for a field that
takes a ``glo_vec`` (the JAX one if one was passed at its init, the port's
``ZipMLP`` if built ``with_glo``), which neither model's fields do.
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
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def params_to_jax(state_dict: Mapping) -> Dict:
    """The port's state_dict (or any name -> tensor map, e.g. gradients) ->
    a JAX-style nested dict of float32 numpy arrays."""
    tree: Dict = {}
    for name, value in state_dict.items():
        *path, key = name.split(".")
        arr = np.array(value.detach().cpu().numpy(), np.float32)
        if key == "weight":
            key = "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(arr)
    return tree


def superpoint_params_from_npz(path) -> Dict[str, torch.Tensor]:
    """The npz of tools/convert_superpoint_weights.py (flat ``layer/kernel``
    HWIO and ``layer/bias`` keys, the JAX package's ``SuperPointNet`` tree)
    -> the state_dict of the port's ``pose.features.SuperPointNet``."""
    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            layer, kind = key.split("/")
            tree.setdefault(layer, {})[kind] = data[key]
    return params_from_jax(tree)

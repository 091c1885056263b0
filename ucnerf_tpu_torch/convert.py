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

The JAX package's checkpoints (an orbax train state, a flax msgpack MVS
tree) are read where JAX is installed, by ``tools/export_jax_checkpoint.py``,
which writes the neutral export below; this module reads it with numpy
alone.  Export layout (an uncompressed ``np.savez`` file):

- ``format`` = ``EXPORT_FORMAT`` and ``kind`` = ``"nerf"`` or ``"mvs"``;
- ``params/<flax path joined by '/'>``: the parameter tree in JAX's own
  layout (dense kernels [in, out], conv kernels HWIO, tables [C, rows]);
- for ``nerf`` only: ``adam/mu/<path>`` and ``adam/nu/<path>`` (Adam's
  moments, the parameters' layout), ``adam/count`` (Adam's update count),
  ``schedule/count`` (the learning-rate schedule's) and ``step``, int32.

``load_export`` reads and checks one; ``state_from_export`` fills a port
``TrainState`` from a ``nerf`` export and ``export_arrays`` /
``state_to_export`` form and write one back (so the card, which has no
JAX, can check the round trip);
``mvs_params_from_export`` gives the ``RAFTMVS`` state_dict of an ``mvs``
export.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

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


EXPORT_FORMAT = "ucnerf-jax-export/1"
_COUNTS = ("adam/count", "schedule/count", "step")


def load_export(path, kind: Optional[str] = None) -> Dict[str, np.ndarray]:
    """The arrays of the export at `path`, by key; raises unless its
    ``format`` is ``EXPORT_FORMAT`` and its ``kind`` is ``nerf`` or ``mvs``
    (and `kind`, when given)."""
    with np.load(path, allow_pickle=False) as data:
        export = {key: data[key] for key in data.files}
    fmt = str(export.get("format", ""))
    if fmt != EXPORT_FORMAT:
        raise ValueError(f"{path}: format {fmt!r}, expected "
                         f"{EXPORT_FORMAT!r} (an export of "
                         f"tools/export_jax_checkpoint.py)")
    found = str(export.get("kind", ""))
    if found not in ("nerf", "mvs") or kind not in (None, found):
        raise ValueError(f"{path}: kind {found!r}, expected "
                         f"{kind or 'nerf or mvs'!r}")
    return export


def _subtree(export: Mapping, prefix: str) -> Dict:
    """The nested dict of the keys under `prefix` (path parts split at
    '/')."""
    tree: Dict = {}
    for key, value in export.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
    return tree


def _jax_key(name: str) -> str:
    """A port parameter name as its export path."""
    *path, leaf = name.split(".")
    return "/".join(path + ["kernel" if leaf == "weight" else leaf])


def _check_names(label: str, got: Mapping, want: Mapping) -> None:
    """Raise unless `got` (port name -> tensor, from the export's `label`
    tree) has exactly the names and shapes of `want` (the model's
    parameters), naming every difference by its export key."""
    problems = [f"missing {label}/{_jax_key(n)}" for n in want if n not in got]
    for name, value in got.items():
        if name not in want:
            problems.append(f"unexpected {label}/{_jax_key(name)}")
        elif value.shape != want[name].shape:
            problems.append(f"{label}/{_jax_key(name)}: shape "
                            f"{tuple(value.shape)} in the export, "
                            f"{tuple(want[name].shape)} in the model")
    if problems:
        raise ValueError("export does not fit the model: "
                         + "; ".join(problems))


def _adam_state_template(adam: torch.optim.Adam, device) -> Dict:
    """The per-parameter state that `adam`'s class creates for a parameter
    on `device`, read off one real step of a one-element probe with the
    same options (the dtype and device of ``step`` vary with the torch
    version and with ``fused`` / ``capturable``)."""
    probe = torch.zeros(1, device=device, requires_grad=True)
    opt = type(adam)([probe], **adam.defaults)
    probe.grad = torch.zeros_like(probe)
    opt.step()
    template = opt.state[probe]
    if set(template) != {"step", "exp_avg", "exp_avg_sq"}:
        raise ValueError(f"Adam keeps {sorted(template)} per parameter; "
                         f"an export holds step, exp_avg and exp_avg_sq")
    return template


def state_from_export(export: Mapping, state):
    """Fill the port ``TrainState`` `state` (built from the run's preset and
    bindings, on its device) from the ``nerf`` export `export`: the
    parameters, Adam's moments and update count placed by parameter name
    (the camera deltas, ``cam_refine.*``, are Adam's second param group),
    the schedule's count and the step.  Everything is checked before
    anything is written: a key left over, a parameter or moment left
    unfilled or a shape that differs raises, naming it.  Returns the new
    ``TrainState``."""
    from ucnerf_tpu_torch.train.state import TrainState

    if str(export.get("kind", "")) != "nerf":
        raise ValueError(f"kind {str(export.get('kind', ''))!r}: a NeRF "
                         f"train state needs a 'nerf' export")
    trees = ("params", "adam/mu", "adam/nu")
    extra = [k for k in export if k not in ("format", "kind") + _COUNTS
             and not k.startswith(tuple(f"{t}/" for t in trees))]
    missing = [k for k in _COUNTS if k not in export]
    if extra or missing:
        raise ValueError(f"export keys: unexpected {extra}, missing "
                         f"{missing}")
    counts = {}
    for key in _COUNTS:
        value = export[key]
        if value.shape != () or value.dtype.kind not in "iu":
            raise ValueError(f"{key}: {value.dtype} {value.shape}, expected "
                             f"an integer scalar")
        counts[key] = int(value)
    named = dict(state.model.named_parameters())
    loaded = {t: params_from_jax(_subtree(export, f"{t}/")) for t in trees}
    for tree in trees:
        _check_names(tree, loaded[tree], named)

    model, opt = state.model, state.optimizer
    template = _adam_state_template(opt.adam, next(iter(named.values()))
                                    .device)
    model.load_state_dict(loaded["params"], strict=True)
    names = {id(p): n for n, p in named.items()}
    opt.adam.state.clear()
    for group in opt.adam.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            opt.adam.state[p] = {
                "step": torch.full_like(template["step"],
                                        counts["adam/count"]),
                "exp_avg": torch.empty_like(p).copy_(loaded["adam/mu"][name]),
                "exp_avg_sq": torch.empty_like(p).copy_(
                    loaded["adam/nu"][name])}
    opt.count = counts["schedule/count"]
    if opt.count > 0:
        # What the last update left in the param groups.
        opt.set_learning_rate(opt.count - 1)
    return TrainState(step=counts["step"], model=model, optimizer=opt)


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """{prefix + 'a/b/c': leaf} for every leaf of the nested mapping
    `tree`."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(flatten_tree(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def export_arrays(state) -> Dict[str, np.ndarray]:
    """The ``nerf`` export of the port ``TrainState`` `state`, by key
    (``state_from_export``'s inverse; a parameter Adam has not stepped yet
    gets zero moments and count 0)."""
    arrays = {"format": np.array(EXPORT_FORMAT), "kind": np.array("nerf")}
    named = dict(state.model.named_parameters())
    adam = state.optimizer.adam.state
    trees = {"params": named,
             "adam/mu": {n: adam[p]["exp_avg"] if p in adam
                         else torch.zeros_like(p) for n, p in named.items()},
             "adam/nu": {n: adam[p]["exp_avg_sq"] if p in adam
                         else torch.zeros_like(p) for n, p in named.items()}}
    for tree, tensors in trees.items():
        arrays.update(flatten_tree(params_to_jax(tensors), f"{tree}/"))
    steps = {int(adam[p]["step"]) if p in adam else 0
             for p in named.values()}
    if len(steps) != 1:
        raise ValueError(f"Adam's per-parameter counts differ: {steps}")
    arrays["adam/count"] = np.array(steps.pop(), np.int32)
    arrays["schedule/count"] = np.array(state.optimizer.count, np.int32)
    arrays["step"] = np.array(state.step, np.int32)
    return arrays


def state_to_export(state, path) -> None:
    """Write the port ``TrainState`` `state` as a ``nerf`` export at
    `path` (uncompressed, as the exporter writes)."""
    np.savez(path, **export_arrays(state))


def mvs_params_from_export(export: Mapping) -> Dict[str, torch.Tensor]:
    """The ``RAFTMVS`` state_dict of the ``mvs`` export `export` (the JAX
    ``cli.mvs_train --out`` tree)."""
    if str(export.get("kind", "")) != "mvs":
        raise ValueError(f"kind {str(export.get('kind', ''))!r}: the MVS "
                         f"model needs an 'mvs' export")
    extra = [k for k in export if k not in ("format", "kind")
             and not k.startswith("params/")]
    if extra:
        raise ValueError(f"export keys: unexpected {extra}")
    return params_from_jax(_subtree(export, "params/"))

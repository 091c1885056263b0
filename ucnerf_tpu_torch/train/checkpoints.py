"""Checkpointing: step-named folders, keep-last-N, resume
(port of ``ucnerf_tpu/train/checkpoints.py``).

Checkpoints live in ``{exp}/checkpoints/<step>/state.pt``; restore picks the
highest step, and at most ``total_limit`` checkpoints are kept.  The JAX
package writes its state tree with orbax; here ``torch.save`` writes the
model's ``state_dict``, Adam's state (its moments, and its param groups: the
field's and, with ``optimize_cameras``, the camera deltas') and the step
counts.  As in the JAX package, a checkpoint saved with camera refinement on
does not restore with it off, nor the other way round.  A JAX (orbax)
checkpoint is not read here: ``tools/export_jax_checkpoint.py`` exports it
on the JAX host to a numpy file, and ``cli.import_jax`` writes that as a
checkpoint of this module (``convert.state_from_export``).
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from ucnerf_tpu_torch.train.state import TrainState

_FILE = "state.pt"
# What orbax writes into a step folder.
_ORBAX_FILES = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _ckpt_dir(base_folder: str) -> str:
    return os.path.join(os.path.abspath(base_folder), "checkpoints")


def save_checkpoint(base_folder: str, state: TrainState, step: int,
                    total_limit: int = 1) -> str:
    """Save `state` under checkpoints/<step>, pruning old ones.

    The folder is written under a temporary name and renamed, so a run cut
    during the save leaves no half-written checkpoint to resume from."""
    root = _ckpt_dir(base_folder)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, str(step))
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"step": state.step,
                "model": state.model.state_dict(),
                "adam": state.optimizer.adam.state_dict(),
                "count": state.optimizer.count},
               os.path.join(tmp, _FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    # Keep only the newest `total_limit` checkpoints.
    steps = sorted(int(d) for d in os.listdir(root) if d.isdigit())
    for old in steps[:-total_limit] if total_limit > 0 else []:
        shutil.rmtree(os.path.join(root, str(old)), ignore_errors=True)
    return path


def latest_checkpoint_step(base_folder: str) -> Optional[int]:
    root = _ckpt_dir(base_folder)
    if not os.path.isdir(root):
        return None
    steps = [int(d) for d in os.listdir(root) if d.isdigit()]
    return max(steps) if steps else None


def is_jax_checkpoint(path: str) -> bool:
    """Whether the step folder `path` holds an orbax checkpoint of the JAX
    package."""
    return any(os.path.exists(os.path.join(path, name))
               for name in _ORBAX_FILES)


def _load(base_folder: str, step: int, device):
    path = os.path.join(_ckpt_dir(base_folder), str(step))
    if not os.path.exists(os.path.join(path, _FILE)) and is_jax_checkpoint(
            path):
        raise ValueError(
            f"{path} is a JAX (orbax) checkpoint: export it on the JAX host "
            f"with tools/export_jax_checkpoint.py --exp {base_folder} "
            f"-o scene.npz, then write a checkpoint of the port with python "
            f"-m ucnerf_tpu_torch.cli.import_jax --export scene.npz (same "
            f"preset and bindings, another Config.exp_name)")
    # weights_only: the file holds tensors and plain numbers, nothing else.
    return torch.load(os.path.join(path, _FILE), map_location=device,
                      weights_only=True)


def restore_model(base_folder: str, model: torch.nn.Module,
                  step: Optional[int] = None) -> int:
    """Load the newest checkpoint's parameters (or those of checkpoint
    `step`) into `model`, on the device it is on, and leave its optimizer
    state on disk (the serving CLIs need no Adam moments).  Returns the
    step; 0, with `model` untouched, when none exists."""
    if step is None:
        step = latest_checkpoint_step(base_folder)
    if step is None:
        return 0
    payload = _load(base_folder, step, next(model.parameters()).device)
    model.load_state_dict(payload["model"])
    return step


def restore_checkpoint(base_folder: str,
                       state: TrainState) -> tuple[TrainState, int]:
    """Restore the newest checkpoint into `state`'s model and optimizer, on
    the device they are on.

    Returns (state, step); (state as it is, 0) when none exists."""
    step = latest_checkpoint_step(base_folder)
    if step is None:
        return state, 0
    payload = _load(base_folder, step, next(state.model.parameters()).device)
    saved = len(payload["adam"]["param_groups"])
    if saved != len(state.optimizer.adam.param_groups):
        raise ValueError(
            f"checkpoint {step} holds {saved} optimizer param groups, the "
            f"run {len(state.optimizer.adam.param_groups)}: "
            f"Config.optimize_cameras differs from the saved run's")
    state.model.load_state_dict(payload["model"])
    state.optimizer.adam.load_state_dict(payload["adam"])
    state.optimizer.count = int(payload["count"])
    return TrainState(step=int(payload["step"]), model=state.model,
                      optimizer=state.optimizer), step

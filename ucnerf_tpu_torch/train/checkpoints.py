"""Checkpointing: step-named folders, keep-last-N, resume
(port of ``ucnerf_tpu/train/checkpoints.py``).

Checkpoints live in ``{exp}/checkpoints/<step>/state.pt``; restore picks the
highest step, and at most ``total_limit`` checkpoints are kept.  The JAX
package writes its state tree with orbax; here ``torch.save`` writes the
model's ``state_dict``, Adam's moments and the step counts.  The two formats
are not interchangeable: a JAX checkpoint crosses over as numpy parameters
through ``convert.params_from_jax``.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from ucnerf_tpu_torch.train.state import TrainState

_FILE = "state.pt"


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


def _load(base_folder: str, step: int, device):
    # weights_only: the file holds tensors and plain numbers, nothing else.
    return torch.load(os.path.join(_ckpt_dir(base_folder), str(step), _FILE),
                      map_location=device, weights_only=True)


def restore_model(base_folder: str, model: torch.nn.Module) -> int:
    """Load the newest checkpoint's parameters into `model`, on the device
    it is on, and leave its optimizer state on disk (the serving CLIs need
    no Adam moments).  Returns the step; 0, with `model` untouched, when
    none exists."""
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
    state.model.load_state_dict(payload["model"])
    state.optimizer.adam.load_state_dict(payload["adam"])
    state.optimizer.count = int(payload["count"])
    return TrainState(step=int(payload["step"]), model=state.model,
                      optimizer=state.optimizer), step

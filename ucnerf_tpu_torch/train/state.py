"""Train state and optimizer (port of ``ucnerf_tpu/train/state.py``).

The JAX package's optax chain, in its order: NaN/Inf in the gradients set to
0, the optional ``grad_max_val`` clip, the optional ``grad_max_norm`` clip
(optax's formula: keep the gradients if their global norm is below the
limit, else scale them by limit / norm), Adam (``torch.optim.Adam`` with the
config's betas and eps), and the log-lerp learning rate with its delayed
warm-up, evaluated at the optimizer's own update count as optax's
``scale_by_schedule`` does.  With camera refinement (``optimize_cameras``)
the se(3) deltas (``cam_refine.*``) form a second Adam param group whose
learning rate is the schedule's times ``cam_lr_mult``: the JAX chain scales
their Adam updates by the multiplier before the schedule, which is the same
step.  The clips see every parameter, the deltas included, as optax's do.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ucnerf_tpu_torch.configs import Config
from ucnerf_tpu_torch.ops import mathx


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` in place: keep the gradients if their
    global norm is below `max_norm`, else scale them by max_norm / norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class Optimizer:
    """The optax chain of ``create_optimizer`` over a list of parameters.

    ``update()`` reads each parameter's ``.grad`` (a missing one counts as
    zeros, as every leaf of a JAX gradient tree exists), cleans and clips the
    gradients in place, and takes one Adam step.  Parameters in
    `cam_params` (the camera deltas) make Adam's second param group, at
    ``cam_lr_mult`` times the scheduled learning rate.
    """

    def __init__(self, params, config: Config, cam_params=()):
        self.config = config
        self.params = list(params)
        cam = {id(p) for p in cam_params}
        groups = [{"params": [p for p in self.params if id(p) not in cam]}]
        self.lr_mults = [1.0]
        if cam:
            groups.append({"params": [p for p in self.params if id(p) in cam]})
            self.lr_mults.append(config.cam_lr_mult)
        self.adam = torch.optim.Adam(
            groups, lr=config.lr_init,
            betas=(config.adam_beta1, config.adam_beta2), eps=config.adam_eps)
        self.count = 0

    @torch.no_grad()
    def update(self):
        cfg = self.config
        grads = []
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        for g in grads:
            torch.nan_to_num_(g, nan=0.0, posinf=0.0, neginf=0.0)
        if cfg.grad_max_val > 0:
            for g in grads:
                g.clamp_(-cfg.grad_max_val, cfg.grad_max_val)
        if cfg.grad_max_norm > 0:
            clip_by_global_norm_(grads, cfg.grad_max_norm)
        self.set_learning_rate(self.count)
        self.adam.step()
        self.count += 1

    def set_learning_rate(self, count: int) -> None:
        """Set each param group's learning rate to the schedule's at update
        `count`, times the group's multiplier."""
        cfg = self.config
        lr = mathx.learning_rate_decay(count, cfg.lr_init, cfg.lr_final,
                                       cfg.max_steps, cfg.lr_delay_steps,
                                       cfg.lr_delay_mult)
        for group, mult in zip(self.adam.param_groups, self.lr_mults):
            group["lr"] = lr * mult


def create_optimizer(config: Config, params, cam_params=()) -> Optimizer:
    """Adam with the reference's betas/eps and the scheduled LR; the
    parameters in `cam_params` at ``cam_lr_mult`` times it."""
    return Optimizer(params, config, cam_params)


@dataclasses.dataclass
class TrainState:
    """Step count, model (the parameters) and optimizer (Adam's moments and
    the schedule's count)."""
    step: int
    model: nn.Module
    optimizer: Optimizer


def create_train_state(config: Config, model: nn.Module) -> TrainState:
    cam = getattr(model, "cam_refine", None)
    return TrainState(step=0, model=model, optimizer=create_optimizer(
        config, model.parameters(), () if cam is None else cam.parameters()))

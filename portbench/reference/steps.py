"""Plain PyTorch training steps and renders of the reference model.

``train`` takes the initial parameters and the steps' ray batches and
seeds, and runs each step as its configuration states it: the mean over
``microbatches`` equal slices of the batch of each slice's summed losses,
its gradient by autograd, NaNs zeroed, and one Adam update (the source's
betas and eps) at the log-lerp learning rate with its delayed warm-up.
``render`` renders a view in chunks of ``render_chunk_size`` rays, each
chunk's hex basis drawn from a CPU generator seeded from the chunk's size.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import losses as losses_lib
from portbench.reference import model as model_lib


def learning_rate(count, cfg):
    """The schedule at optimizer update `count` (float64 on the host)."""
    if cfg["lr_delay_steps"] > 0:
        frac = min(max(count / cfg["lr_delay_steps"], 0.0), 1.0)
        delay = cfg["lr_delay_mult"] + (1 - cfg["lr_delay_mult"]) * math.sin(
            0.5 * math.pi * frac)
    else:
        delay = 1.0
    t = min(max(count / cfg["max_steps"], 0.0), 1.0)
    lv0, lv1 = math.log(cfg["lr_init"]), math.log(cfg["lr_final"])
    return delay * math.exp(t * (lv1 - lv0) + lv0)


class Adam:
    """Adam with bias correction, eps outside the square root.  It starts
    from zero moments, or takes up given moments ``m``, ``v`` after ``t``
    updates."""

    def __init__(self, params, cfg, m=None, v=None, t=0):
        self.params = params
        self.b1, self.b2, self.eps = (cfg["adam_beta1"], cfg["adam_beta2"],
                                      cfg["adam_eps"])
        self.m = m or {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = v or {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = t

    @torch.no_grad()
    def step(self, grads, lr):
        self.t += 1
        c1, c2 = 1 - self.b1**self.t, 1 - self.b2**self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def train(params, cfg, batches, seeds, fracs, precision=None, opt=None):
    """Run len(batches) steps from `params` (a dict of leaf tensors on the
    card, updated in place).  batches: ray dicts of tensors; seeds: each
    step's generator seed; fracs: each step's train_frac; precision: the
    matrix products' (``model.Products``); opt: the ``Adam`` to step (a
    fresh one without).  Returns (losses [steps], first gradients {name:
    tensor}, the optimizer)."""
    opt = opt or Adam(params, cfg)
    micro = max(cfg["microbatches"], 1)
    step_losses, first = [], None
    for batch, seed, frac in zip(batches, seeds, fracs):
        n = batch["origins"].shape[0]
        if n % micro:
            raise ValueError(f"{n} rays in {micro} microbatches")
        size = n // micro
        gen = torch.Generator(device=batch["origins"].device).manual_seed(
            seed)
        for p in params.values():
            p.grad = None
        total_sum = 0.0
        for i in range(micro):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            rend, hist = model_lib.forward(params, cfg, mb, frac,
                                           generator=gen, train=True,
                                           precision=precision)
            total = sum(losses_lib.all_losses(cfg, mb, rend, hist).values())
            total.backward()
            total_sum += float(total.detach())
            del rend, hist, total
        grads = {}
        for k, p in params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            if micro > 1:
                g = g * (1.0 / micro)
            grads[k] = torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
            p.grad = None
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        opt.step(grads, learning_rate(opt.t, cfg))
        step_losses.append(total_sum / micro)
    return step_losses, first, opt


def hex_basis(seed, n):
    """[n, 3] normals from a CPU generator seeded from (seed, n)."""
    mixed = np.random.SeedSequence((seed, n)).generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(mixed >> np.uint64(1)))
    return torch.randn((n, 3), generator=gen)


@torch.no_grad()
def render(params, cfg, rays, eval_camidx=0, precision=None):
    """The final level's rgb, depth, acc and distance statistics of a flat
    ray batch, chunk by chunk, as numpy arrays."""
    chunk = cfg["render_chunk_size"]
    n = rays["origins"].shape[0]
    outs = []
    for i0 in range(0, n, chunk):
        part = {k: v[i0:i0 + chunk] for k, v in rays.items()}
        size = part["origins"].shape[0]
        basis = hex_basis(0, size).to(part["origins"].device)
        rend, _ = model_lib.forward(params, cfg, part, 1.0, rand_vec=basis,
                                    eval_camidx=eval_camidx, extras=True,
                                    precision=precision)
        last = rend[-1]
        outs.append({k: v.cpu().numpy() for k, v in last.items()
                     if k in OUTPUTS})
    return {k: np.concatenate([o[k] for o in outs]) for k in OUTPUTS}


OUTPUTS = ("rgb", "depth", "acc", "distance_mean", "distance_median",
           "distance_percentile_5", "distance_percentile_95")

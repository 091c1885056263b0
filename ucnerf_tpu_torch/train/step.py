"""Model construction, the train step and the image renderer
(port of ``ucnerf_tpu/train/step.py``: ``init_model``, ``dummy_batch``,
``make_train_step``, ``make_eval_step`` and ``render_image``).

``make_train_step`` runs the JAX step's microbatch accumulation as one
Python loop (the JAX scan and ``host_microbatches`` are two ways of running
it): forward, losses and backward per microbatch, gradients summed and
scaled by 1/microbatches, then one optimizer update.  ``render_image``
chunks an image's rays on the host, renders each chunk with the eval step
(optionally in ``render_subchunks`` sequential pieces, which bound the
activation peak at the piece's size), and reassembles numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ucnerf_tpu_torch.configs import Config
from ucnerf_tpu_torch.models.model import UCNeRFModel
from ucnerf_tpu_torch.train import losses as losses_lib
from ucnerf_tpu_torch.train.state import TrainState


def init_model(config: Config, seed: int = 0, device="cuda") -> UCNeRFModel:
    """Construct the model with parameters drawn from a seeded generator.

    Parameters are drawn on the CPU (so a seed gives the same weights on
    every device) and then moved to `device`.
    """
    generator = torch.Generator().manual_seed(seed)
    model = UCNeRFModel(config, generator)
    return model.to(device).eval()


def dummy_batch(config: Config, n: int) -> Dict[str, np.ndarray]:
    """A synthetic ray batch with the canonical layout (the JAX package's
    ``dummy_batch``: spatially diverse random rays)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origins = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    return {
        "origins": origins,
        "directions": d.copy(),
        "viewdirs": d.copy(),
        "cam_dirs": d.copy(),
        "radii": np.full((n, 1), 1e-3, np.float32),
        "near": np.full((n, 1), config.near, np.float32),
        "far": np.full((n, 1), config.far, np.float32),
        "cam_idx": (rng.integers(0, max(config.training_views, 1), n)
                    .astype(np.int32)),
        "phys_cam_idx": (rng.integers(0, max(config.num_phys_cams, 1), n)
                         .astype(np.int32)),
        "lossmult": np.ones((n, 1), np.float32),
        "rgb": np.full((n, 3), 0.5, np.float32),
        "sky_segs": np.zeros((n,), np.float32),
    }


def batch_to_device(arrays, device) -> Dict[str, torch.Tensor]:
    """Host ray arrays as tensors on `device`, 64-bit floats and ints
    narrowed to 32 bits (the data layer casts rays in float64; the JAX
    package narrows the same way when an array reaches the device)."""
    narrow = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        v = np.array(v, dtype=narrow.get(v.dtype, v.dtype))  # a writable copy
        out[k] = torch.from_numpy(v).to(device)
    return out


def make_train_step(model: UCNeRFModel, config: Config):
    """Build the train step.

    Returns ``train_step(state, batch, train_frac, generator=None,
    rand_vec=None) -> (state, stats)``.  batch is a dict of [N, ...] tensors
    on the model's device (the ``dummy_batch`` layout), N divisible by
    ``config.microbatches``.  With a ``torch.Generator`` the forward draws
    its jitter and hex patterns from it (the JAX keyed step); without one it
    is deterministic and ``rand_vec`` [N, 3] fixes the hex basis.  stats
    holds the microbatch means of the total (``loss``), of each loss term
    (``losses``) and of the per-level MSEs (``mses``), as tensors.

    The JAX package recomputes the fields in the backward
    (``remat_fields``, for a TPU's 16 GB); the port keeps the activations
    and ignores that knob.
    """
    num_micro = max(config.microbatches, 1)

    def train_step(state: TrainState, batch, train_frac, generator=None,
                   rand_vec=None):
        n = batch["origins"].shape[0]
        if n % num_micro:
            raise ValueError(f"{n} rays do not split into {num_micro} "
                             f"microbatches")
        size = n // num_micro
        params = list(state.model.parameters())
        for p in params:
            p.grad = None
        total_acc = losses_acc = stats_acc = None
        for i in range(num_micro):
            part = slice(i * size, (i + 1) * size)
            mb = {k: v[part] for k, v in batch.items()}
            renderings, ray_history = state.model(
                mb, train_frac, None if rand_vec is None else rand_vec[part],
                compute_extras=False, train=True, generator=generator)
            total, losses, stats = losses_lib.compute_all_losses(
                mb, renderings, ray_history, config)
            total.backward()
            del renderings, ray_history
            if total_acc is None:
                total_acc = total.detach()
                losses_acc = {k: v.detach() for k, v in losses.items()}
                stats_acc = {k: v.detach() for k, v in stats.items()}
            else:
                total_acc = total_acc + total.detach()
                losses_acc = {k: losses_acc[k] + v.detach()
                              for k, v in losses.items()}
                stats_acc = {k: stats_acc[k] + v.detach()
                             for k, v in stats.items()}
        inv = 1.0 / num_micro
        if num_micro > 1:
            with torch.no_grad():
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(inv)
        state.optimizer.update()
        new_state = TrainState(step=state.step + 1, model=state.model,
                               optimizer=state.optimizer)
        out = {k: v * inv for k, v in stats_acc.items()}
        out["loss"] = total_acc * inv
        out["losses"] = {k: v * inv for k, v in losses_acc.items()}
        return new_state, out

    return train_step


def make_eval_step(model: UCNeRFModel, config: Config,
                   compute_extras: bool = True, seed: int = 0):
    """Build the eval render step over one flat ray chunk.

    Returns ``eval_step(batch, train_frac, eval_camidx, rand_vec=None)``:
    batch is a dict of [N, ...] tensors on the model's device; rand_vec
    ([N, 3]) fixes the hex basis and, when None, is drawn from a
    ``torch.Generator`` on the model's device seeded with `seed` (one draw
    per sub-chunk).  The ``grid_bwd_*`` config knobs only shape a backward
    pass and are ignored, as in the JAX package.  Returns the final level's
    rendering: rgb [N, 3], depth and acc [N] and, with compute_extras, the
    ``distance_*`` statistics.
    """
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    sub = max(config.render_subchunks, 1)

    def eval_one(batch, train_frac, eval_camidx, rand_vec):
        if rand_vec is None:
            n = batch["origins"].shape[0]
            rand_vec = torch.randn((n, 3), generator=generator,
                                   device=device)
        renderings, _ = model(batch, train_frac, rand_vec,
                              compute_extras=compute_extras,
                              eval_camidx=eval_camidx)
        out = dict(renderings[-1])
        for k in ("weights", "sky_rgbs", "affine_trans", "affine_trans_sky"):
            out.pop(k, None)
        return out

    @torch.no_grad()
    def eval_step(batch, train_frac, eval_camidx, rand_vec=None):
        if sub == 1:
            return eval_one(batch, train_frac, eval_camidx, rand_vec)
        n = batch["origins"].shape[0]
        if n % sub:
            raise ValueError(f"chunk of {n} rays does not split into "
                             f"{sub} sub-chunks")
        step = n // sub
        outs = []
        for i in range(sub):
            part = slice(i * step, (i + 1) * step)
            outs.append(eval_one(
                {k: v[part] for k, v in batch.items()}, train_frac,
                eval_camidx, None if rand_vec is None else rand_vec[part]))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    eval_step.device = device
    return eval_step


def _pad_rays(arrays, multiple: int):
    """Edge-pad every [n, ...] array to a multiple of `multiple` rays."""
    n = next(iter(arrays.values())).shape[0]
    pad = -n % multiple
    if pad:
        arrays = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                  for k, v in arrays.items()}
    return arrays, pad


def render_image(eval_step, batch, config: Config, train_frac=1.0,
                 eval_camidx=0, rand_vec=None):
    """Render all rays of an image by chunking through the eval step.

    Args:
      eval_step: from make_eval_step.
      batch: dict of [H, W, ...] ray arrays (host numpy).
      eval_camidx: brightness-correction view id for this render.
      rand_vec: optional [H, W, 3] hex-basis vectors (else eval_step draws).

    Returns:
      dict of [H, W, ...] numpy arrays.
    """
    height, width = batch["origins"].shape[:2]
    num_rays = height * width
    flat = {k: np.asarray(v).reshape((num_rays,) + np.shape(v)[2:])
            for k, v in batch.items() if v is not None}
    if rand_vec is not None:
        flat["rand_vec"] = np.asarray(rand_vec, np.float32).reshape(
            num_rays, 3)

    chunk = config.render_chunk_size
    outs = []
    for i0 in range(0, num_rays, chunk):
        part, pad = _pad_rays({k: v[i0:i0 + chunk] for k, v in flat.items()},
                              max(config.render_subchunks, 1))
        tensors = batch_to_device(part, eval_step.device)
        rv = tensors.pop("rand_vec", None)
        out = eval_step(tensors, train_frac, eval_camidx, rv)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if pad:
            out = {k: v[:-pad] for k, v in out.items()}
        outs.append(out)

    rendering = {}
    for k in outs[0]:
        z = np.concatenate([o[k] for o in outs], axis=0)
        rendering[k] = z.reshape((height, width) + z.shape[1:])
    return rendering

"""UC-NeRF training losses (port of ``ucnerf_tpu/train/losses.py``).

Data (charb / mse / rawnerf), sky BCE, affine identity, interlevel,
anti-interlevel (blurred), distortion, opacity, the ref-NeRF orientation
and predicted-normal losses, and hash decay.  Each returns a scalar already
multiplied by its config weight, so the total loss is a plain sum.

Layouts follow the port's model: renderings carry rgb [N, 3], acc [N],
weights [N, S], affine_trans [N, 3, 4]; ray history levels carry sdist
[N, S+1], weights [N, S], normals and normals_pred [3, N, S] (or None) and
loss_hash_decay (a scalar).
"""

from __future__ import annotations

from typing import Dict

import torch

from ucnerf_tpu_torch.configs import Config
from ucnerf_tpu_torch.ops import mathx, stepfun
from ucnerf_tpu_torch.utils.spans import spanned


def compute_data_loss(batch, renderings, config: Config):
    """RGB reconstruction loss; returns (loss, stats) with per-level MSEs."""
    data_losses = []
    mses = []
    target = batch["rgb"][..., :3]
    lossmult = torch.broadcast_to(batch["lossmult"], target.shape)
    denom = lossmult.sum()
    for rendering in renderings:
        resid_sq = (rendering["rgb"] - target) ** 2
        mses.append((lossmult * resid_sq).sum() / denom)
        if config.data_loss_type == "mse":
            data_loss = resid_sq
        elif config.data_loss_type == "charb":
            data_loss = torch.sqrt(resid_sq + config.charb_padding**2)
        elif config.data_loss_type == "rawnerf":
            rgb_clip = torch.clamp(rendering["rgb"], max=1.0)
            resid_sq_clip = (rgb_clip - target) ** 2
            scaling_grad = 1.0 / (1e-3 + rgb_clip.detach())
            data_loss = resid_sq_clip * scaling_grad**2
        else:
            raise ValueError(config.data_loss_type)
        data_losses.append((lossmult * data_loss).sum() / denom)
    loss = (config.data_coarse_loss_mult * sum(data_losses[:-1]) +
            config.data_loss_mult * data_losses[-1])
    return loss, {"mses": torch.stack(mses)}


def sky_loss(batch, renderings, config: Config):
    """BCE pushing acc to 0 on sky pixels, 1 elsewhere."""
    total = 0.0
    target = 1.0 - batch["sky_segs"]
    for rendering in renderings:
        acc = torch.clamp(rendering["weights"].sum(dim=-1), 1e-3, 1 - 1e-3)
        bce = -(target * torch.log(acc) + (1 - target) * torch.log(1 - acc))
        total += bce.mean()
    return config.sky_weight * total


def identity_loss(renderings, config: Config):
    """L1 pull of the affine color transforms to identity."""
    affine = renderings[0]["affine_trans"]
    eye = torch.eye(4, dtype=affine.dtype, device=affine.device)[None, :3, :]
    loss = torch.abs(eye - affine)
    affine_sky = renderings[0].get("affine_trans_sky")
    if affine_sky is not None:
        loss = loss + torch.abs(eye - affine_sky)
    return config.idt_weight * loss.mean()


def interlevel_loss(ray_history, config: Config):
    """mip-NeRF 360 proposal loss."""
    c = ray_history[-1]["sdist"].detach()
    w = ray_history[-1]["weights"].detach()
    total = 0.0
    for ray_results in ray_history[:-1]:
        total += stepfun.lossfun_outer(c, w, ray_results["sdist"],
                                       ray_results["weights"]).mean()
    return config.interlevel_loss_mult * total


def anti_interlevel_loss(ray_history, config: Config):
    """Zip-NeRF anti-aliased interlevel loss."""
    c = ray_history[-1]["sdist"].detach()
    w = ray_history[-1]["weights"].detach()
    w_normalize = w / (c[..., 1:] - c[..., :-1])
    total = 0.0
    for i, ray_results in enumerate(ray_history[:-1]):
        cp = ray_results["sdist"]
        wp = ray_results["weights"]
        c_, w_ = stepfun.blur_stepfun(c, w_normalize, config.pulse_width[i])
        # Piecewise-linear PDF -> piecewise-quadratic CDF.
        area = 0.5 * (w_[..., 1:] + w_[..., :-1]) * (c_[..., 1:]
                                                     - c_[..., :-1])
        cdf = torch.cat([torch.zeros_like(area[..., :1]),
                         torch.cumsum(area, dim=-1)], dim=-1)
        cdf_interp = mathx.sorted_interp_quad(cp, c_, w_, cdf)
        w_s = torch.diff(cdf_interp, dim=-1)
        total += (torch.clamp(w_s - wp, min=0.0) ** 2
                  / (wp + 1e-5)).mean()
    return config.anti_interlevel_loss_mult * total


def distortion_loss(ray_history, config: Config):
    """mip-NeRF 360 distortion regularizer."""
    c = ray_history[-1]["sdist"]
    w = ray_history[-1]["weights"]
    return config.distortion_loss_mult * stepfun.lossfun_distortion(
        c, w).mean()


def orientation_loss(batch, ray_history, config: Config, num_levels: int):
    """ref-NeRF orientation regularizer: normals facing away from the
    camera are penalized, weighted by the level's weights."""
    total = 0.0
    for i, ray_results in enumerate(ray_history):
        w = ray_results["weights"]
        n = ray_results[config.orientation_loss_target]  # [3, R, S]
        if n is None:
            raise ValueError("Normals cannot be None for orientation loss.")
        v = -batch["viewdirs"]  # [R, 3]
        n_dot_v = torch.einsum("crs,rc->rs", n, v)
        loss = (w * torch.clamp(n_dot_v, min=0.0) ** 2).sum(dim=-1).mean()
        mult = (config.orientation_coarse_loss_mult if i < num_levels - 1
                else config.orientation_loss_mult)
        total += mult * loss
    return total


def predicted_normal_loss(ray_history, config: Config, num_levels: int):
    """ref-NeRF predicted-normal supervision: the predicted normals pulled
    to the density normals, weighted by the level's weights."""
    total = 0.0
    for i, ray_results in enumerate(ray_history):
        w = ray_results["weights"]
        n = ray_results["normals"]  # [3, R, S]
        n_pred = ray_results["normals_pred"]
        if n is None or n_pred is None:
            raise ValueError("Normals required for predicted-normal loss.")
        loss = torch.mean(
            (w * (1.0 - torch.sum(n * n_pred, dim=0))).sum(dim=-1))
        mult = (config.predicted_normal_coarse_loss_mult
                if i < num_levels - 1 else config.predicted_normal_loss_mult)
        total += mult * loss
    return total


def hash_decay_loss(ray_history, config: Config):
    """L2 decay of the hash tables."""
    total = 0.0
    for ray_results in ray_history:
        total += config.hash_decay_mults * ray_results["loss_hash_decay"]
    return total


def opacity_loss(renderings, config: Config):
    """Entropy-style opacity regularizer."""
    total = 0.0
    for rendering in renderings:
        o = rendering["acc"]
        total += config.opacity_loss_mult * (-o * torch.log(o + 1e-5)).mean()
    return total


@spanned("ucnerf.losses")
def compute_all_losses(batch, renderings, ray_history, config: Config):
    """The loss dict in the JAX package's order; returns (total, losses,
    stats)."""
    losses: Dict[str, torch.Tensor] = {}
    data_loss, stats = compute_data_loss(batch, renderings, config)
    losses["data"] = data_loss
    if config.model_sky:
        losses["sky_segments"] = sky_loss(batch, renderings, config)
    if config.brightness_correction:
        losses["identity"] = identity_loss(renderings, config)
    num_levels = config.model.num_levels
    if config.interlevel_loss_mult > 0 and num_levels > 1:
        losses["interlevel"] = interlevel_loss(ray_history, config)
    if config.anti_interlevel_loss_mult > 0 and num_levels > 1:
        losses["anti_interlevel"] = anti_interlevel_loss(ray_history, config)
    if config.distortion_loss_mult > 0:
        losses["distortion"] = distortion_loss(ray_history, config)
    if config.opacity_loss_mult > 0:
        losses["opacity"] = opacity_loss(renderings, config)
    if (config.orientation_coarse_loss_mult > 0 or
            config.orientation_loss_mult > 0):
        losses["orientation"] = orientation_loss(batch, ray_history, config,
                                                 num_levels)
    if config.hash_decay_mults > 0:
        losses["hash_decay"] = hash_decay_loss(ray_history, config)
    if (config.predicted_normal_coarse_loss_mult > 0 or
            config.predicted_normal_loss_mult > 0):
        losses["predicted_normals"] = predicted_normal_loss(
            ray_history, config, num_levels)
    total = sum(losses.values())
    return total, losses, stats

"""Coordinate warps and encodings (port of ``ucnerf_tpu/ops/coord.py``).

Ray-distance warps, the Gaussian contraction in the channel-major layout
of the model and in the reference's row-major one (``contract_mean_std``,
``track_linearize``), the sinusoidal and integrated positional encodings,
and the point contraction and its inverse (``contract``, ``inv_contract``),
which mesh extraction uses on grid points and vertices.
"""

from __future__ import annotations

import numpy as np
import torch

from ucnerf_tpu_torch.ops import mathx

EPS = mathx.EPS


def contract(x):
    """Contract points [..., 3] towards the origin (Eq 10 of mip-NeRF 360):
    identity inside the unit ball, (2 - 1/|x|) * x/|x| outside, so R^3
    maps into the ball of radius 2."""
    x_mag_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=EPS)
    return torch.where(x_mag_sq <= 1, x,
                       ((2 * torch.sqrt(x_mag_sq) - 1) / x_mag_sq) * x)


def inv_contract(z):
    """The inverse of ``contract`` on points [..., 3]."""
    z_mag_sq = torch.clamp(torch.sum(z**2, dim=-1, keepdim=True), min=EPS)
    return torch.where(
        z_mag_sq <= 1, z,
        z / torch.clamp(2 * torch.sqrt(z_mag_sq) - z_mag_sq, min=EPS))


def _cbrt(x):
    """Cube root of a positive tensor (torch has no cbrt; ``pow(., 1/3)``
    is a few ulp off it)."""
    return torch.pow(x, 1.0 / 3.0)


def contract_mean_std(x, std):
    """Row-major ``contract_mean_std_cm``: mean x [..., 3], std [...]."""
    z, std = contract_mean_std_cm(torch.movedim(x, -1, 0), std)
    return torch.movedim(z, 0, -1), std


def track_linearize(fn, mean, std, stop_grads=True):
    """Row-major ``track_linearize_cm``: mean [..., 3], std [...]."""
    if fn != "contract":
        raise NotImplementedError(fn)
    mean, std = contract_mean_std(mean, std)
    if stop_grads:
        return mean.detach(), std.detach()
    return mean, std


def contract_mean_std_cm(x, std):
    """Contract Gaussians (mean x [3, ...], isotropic std [...]) into the
    radius-2 ball (mip-NeRF 360), scaling std by det(J)^(1/3)."""
    x_mag_sq = torch.clamp(x[0] ** 2 + x[1] ** 2 + x[2] ** 2, min=EPS)
    x_mag_sqrt = torch.sqrt(x_mag_sq)
    mask = x_mag_sq <= 1
    scale = torch.where(mask, torch.ones_like(x_mag_sq),
                        (2 * x_mag_sqrt - 1) / x_mag_sq)
    z = x * scale[None]
    det_13 = (_cbrt(torch.clamp(2 * x_mag_sqrt - 1, min=EPS))
              / x_mag_sqrt) ** 2
    std = torch.where(mask, std, det_13 * std)
    return z, std


def track_linearize_cm(fn, mean, std, stop_grads=True):
    """Linearize `fn` around Gaussian (mean, std); only 'contract' exists.
    With stop_grads the warp is treated as fixed (the reference's no-grad)."""
    if fn != "contract":
        raise NotImplementedError(fn)
    mean, std = contract_mean_std_cm(mean, std)
    if stop_grads:
        return mean.detach(), std.detach()
    return mean, std


def power_transformation(x, lam):
    """Power transformation, Eq (4) of Zip-NeRF."""
    lam_1 = np.abs(lam - 1)
    return lam_1 / lam * ((x / lam_1 + 1) ** lam - 1)


def inv_power_transformation(x, lam):
    """Inverse power transformation."""
    lam_1 = np.abs(lam - 1)
    return ((x * lam / lam_1 + 1 + EPS) ** (1 / lam) - 1) * lam_1


def construct_ray_warps(fn, t_near, t_far, lam=None):
    """Bijection between metric and normalized ray distances.

    Args:
      fn: None (identity), 'piecewise', 'power_transformation', 'reciprocal',
        'log', 'exp', 'sqrt', 'square'.
      t_near/t_far: near/far plane distances (broadcastable tensors).
      lam: lambda for the power transformation.

    Returns:
      (t_to_s, s_to_t) mapping metric distance <-> normalized [0, 1].
    """
    if fn is None:
        fn_fwd = lambda x: x
        fn_inv = lambda x: x
    elif fn == "piecewise":
        fn_fwd = lambda x: torch.where(x < 1, 0.5 * x, 1 - 0.5 / x)
        fn_inv = lambda x: torch.where(x < 0.5, 2 * x, 0.5 / (1 - x))
    elif fn == "power_transformation":
        fn_fwd = lambda x: power_transformation(x * 2, lam=lam)
        fn_inv = lambda y: inv_power_transformation(y, lam=lam) / 2
    else:
        fwd_mapping = {
            "reciprocal": torch.reciprocal,
            "log": torch.log,
            "exp": torch.exp,
            "sqrt": torch.sqrt,
            "square": torch.square,
        }
        inv_mapping = {
            "reciprocal": torch.reciprocal,
            "log": torch.exp,
            "exp": torch.log,
            "sqrt": torch.square,
            "square": torch.sqrt,
        }
        fn_fwd = fwd_mapping[fn]
        fn_inv = inv_mapping[fn]

    s_near, s_far = [fn_fwd(x) for x in (t_near, t_far)]
    t_to_s = lambda t: (fn_fwd(t) - s_near) / (s_far - s_near)
    s_to_t = lambda s: fn_inv(s * s_far + (1 - s) * s_near)
    return t_to_s, s_to_t


def expected_sin(mean, var):
    """Mean of sin(x) for x ~ N(mean, var)."""
    return torch.exp(-0.5 * var) * mathx.safe_sin(mean)


def integrated_pos_enc(mean, var, min_deg, max_deg):
    """IPE: sinusoids of Gaussian coordinates mean, var [..., D]."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=mean.dtype,
                                 device=mean.device)
    shape = mean.shape[:-1] + (-1,)
    scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
    scaled_var = (var[..., None, :] * scales[:, None] ** 2).reshape(shape)
    return expected_sin(
        torch.cat([scaled_mean, scaled_mean + 0.5 * np.pi], dim=-1),
        torch.cat([scaled_var] * 2, dim=-1))


def pos_enc(x, min_deg, max_deg, append_identity=True):
    """The positional encoding of the original NeRF paper: x [..., D]."""
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    shape = x.shape[:-1] + (-1,)
    scaled_x = (x[..., None, :] * scales[:, None]).reshape(shape)
    four_feat = torch.sin(
        torch.cat([scaled_x, scaled_x + 0.5 * np.pi], dim=-1))
    if append_identity:
        return torch.cat([x, four_feat], dim=-1)
    return four_feat

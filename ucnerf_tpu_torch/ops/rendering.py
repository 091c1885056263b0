"""Volume rendering core (port of ``ucnerf_tpu/ops/rendering.py``).

Zip-NeRF's hexagonal 6-point multisampling, alpha-compositing weights and
volumetric rendering with the reference's depth clamp (depth = 300 where
acc < 0.6), in the model's channel-major layout (``cast_rays_cm``,
``volumetric_rendering_cm``) and in the reference's row-major one
(``cast_rays``, ``volumetric_rendering``), with the mip-NeRF frustum and
cylinder Gaussians (``lift_gaussian``, ``conical_frustum_to_gaussian``,
``cylinder_to_gaussian``).

The hex pattern needs one random vector per ray for the camera-plane basis.
With ``key=None`` the JAX package draws it from
``jax.random.normal(PRNGKey(0), (R, 3))``, a draw torch cannot reproduce, so
here ``rand_vec`` is always passed in: serving draws it from a seeded
``torch.Generator``, and the parity tests pass JAX's vector to both sides.
Training's random flip and rotation of the pattern (the JAX keyed branch)
are passed in the same way, as uniform draws.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ucnerf_tpu_torch.ops import mathx, stepfun

EPS = mathx.EPS

# Hexagonal phase pattern (multiples of pi/3), Zip-NeRF Sec. 3.1.
_HEX_PATTERN = (0.0, 2.0, 4.0, 3.0, 5.0, 1.0)


@functools.lru_cache(maxsize=None)
def hex_pattern(dtype, device) -> torch.Tensor:
    """``_HEX_PATTERN`` as a [6, 1, 1] tensor on `device`, made once and
    shared (see ``mathx.constant``)."""
    return torch.tensor(_HEX_PATTERN, dtype=dtype,
                        device=device).reshape(6, 1, 1)


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def lift_gaussian(d, t_mean, t_var, r_var, diag):
    """Lift a Gaussian defined along a ray to 3D coordinates."""
    mean = d[..., None, :] * t_mean[..., None]
    d_mag_sq = torch.clamp(torch.sum(d**2, dim=-1, keepdim=True), min=EPS)
    if diag:
        d_outer_diag = d**2
        null_outer_diag = 1 - d_outer_diag / d_mag_sq
        t_cov_diag = t_var[..., None] * d_outer_diag[..., None, :]
        xy_cov_diag = r_var[..., None] * null_outer_diag[..., None, :]
        return mean, t_cov_diag + xy_cov_diag
    d_outer = d[..., :, None] * d[..., None, :]
    eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
    null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
    t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
    xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
    return mean, t_cov + xy_cov


def conical_frustum_to_gaussian(d, t0, t1, base_radius, diag, stable=True):
    """Approximate a conical frustum as a Gaussian (mip-NeRF Eq. 7)."""
    if stable:
        mu = (t0 + t1) / 2
        hw = (t1 - t0) / 2
        denom = torch.clamp(3 * mu**2 + hw**2, min=EPS)
        t_mean = mu + (2 * mu * hw**2) / denom
        t_var = ((hw**2) / 3
                 - (4 / 15) * hw**4 * (12 * mu**2 - hw**2) / denom**2)
        r_var = (mu**2) / 4 + (5 / 12) * hw**2 - (4 / 15) * (hw**4) / denom
    else:
        t_mean = (3 * (t1**4 - t0**4)) / (4 * (t1**3 - t0**3))
        r_var = 3 / 20 * (t1**5 - t0**5) / (t1**3 - t0**3)
        t_mosq = 3 / 5 * (t1**5 - t0**5) / (t1**3 - t0**3)
        t_var = t_mosq - t_mean**2
    r_var = r_var * base_radius**2
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cylinder_to_gaussian(d, t0, t1, radius, diag):
    """Approximate a cylinder as a Gaussian."""
    t_mean = (t0 + t1) / 2
    r_var = radius**2 / 4
    t_var = (t1 - t0) ** 2 / 12
    return lift_gaussian(d, t_mean, t_var, r_var, diag)


def cast_rays(tdist, origins, directions, cam_dirs, radii, rand_vec,
              std_scale=0.5, flip=None, rot=None):
    """Row-major ``cast_rays_cm``: the same samples in the reference's
    layout, means [R, S, 6, 3], stds [R, S, 6], ts [R, S, 6]."""
    means, stds, t = cast_rays_cm(tdist, origins, directions, cam_dirs, radii,
                                  rand_vec, std_scale, flip, rot)
    return (means.permute(2, 3, 1, 0), stds.permute(1, 2, 0),
            t.permute(1, 2, 0))


def cast_rays_cm(tdist, origins, directions, cam_dirs, radii, rand_vec,
                 std_scale=0.5, flip=None, rot=None):
    """Hex multisampling of conical frustums, channel-major.

    Args:
      tdist: [R, S+1] fencepost distances.
      origins/directions/cam_dirs: [R, 3].
      radii: [R, 1], base radius of the cone at distance 1.
      rand_vec: [R, 3] random vector that fixes the camera-plane basis.
      std_scale: multiplier on the per-sample Gaussian std.
      flip, rot: None for the deterministic pattern (every other interval
        rotated by 30 degrees and flipped), or U[0, 1) draws [R, S] that
        flip (> 0.5 keeps) and rotate each interval's pattern, as the JAX
        keyed branch does.

    Returns:
      means [3, 6, R, S], stds [6, R, S], ts [6, R, S].
    """
    r, s1 = tdist.shape
    s = s1 - 1
    dev, dt = tdist.device, tdist.dtype
    t0 = tdist[None, :, :-1]  # [1, R, S]
    t1 = tdist[None, :, 1:]
    radii_b = radii.reshape(1, r, 1)

    t_m = (t0 + t1) / 2
    t_d = (t1 - t0) / 2

    j = torch.arange(6, dtype=dt, device=dev).reshape(6, 1, 1)
    t = t0 + t_d / (t_d**2 + 3 * t_m**2) * (
        t1**2 + 2 * t_m**2 + 3 / 7**0.5 * (2 * j / 5 - 1) *
        torch.sqrt((t_d**2 - t_m**2) ** 2 + 4 * t_m**4))  # [6, R, S]

    deg = (np.pi / 3) * hex_pattern(dt, dev)
    deg = deg.expand(6, r, s)
    if flip is not None:
        # Randomly rotate and flip the hex pattern per interval.
        deg = deg + 2 * np.pi * rot[None]
        deg = torch.where((flip > 0.5)[None], deg, np.pi * 5 / 3 - deg)
    else:
        # Rotate 30 degrees and flip every other pattern.
        mask = (torch.arange(s, device=dev) % 2 == 0)[None, None, :]
        deg = torch.where(mask, deg, deg + np.pi / 6)
        deg = torch.where(mask, deg, np.pi * 5 / 3 - deg)

    mx = radii_b * t * torch.cos(deg) / 2**0.5  # [6, R, S]
    my = radii_b * t * torch.sin(deg) / 2**0.5
    mz = t
    stds = std_scale * radii_b * t / 2**0.5

    ortho1 = _normalize(torch.linalg.cross(cam_dirs, rand_vec))  # [R, 3]
    ortho2 = _normalize(torch.linalg.cross(cam_dirs, ortho1))

    # world = o1*mx + o2*my + dir*mz + origin, per component: [3, 6, R, S].
    def comp(c):
        return (ortho1[:, c].reshape(1, r, 1) * mx
                + ortho2[:, c].reshape(1, r, 1) * my
                + directions[:, c].reshape(1, r, 1) * mz
                + origins[:, c].reshape(1, r, 1))
    means = torch.stack([comp(0), comp(1), comp(2)], dim=0)
    return means, stds, t


def compute_alpha_weights(density, tdist, dirs, opaque_background=False):
    """Alpha-compositing weights from densities: (weights, alpha, trans)."""
    t_delta = tdist[..., 1:] - tdist[..., :-1]
    delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta
    if opaque_background:
        density_delta = torch.cat([
            density_delta[..., :-1],
            torch.full_like(density_delta[..., -1:], float("inf"))
        ], dim=-1)
    alpha = 1 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat([
        torch.zeros_like(density_delta[..., :1]),
        torch.cumsum(density_delta[..., :-1], dim=-1)
    ], dim=-1))
    weights = alpha * trans
    return weights, alpha, trans


def volumetric_rendering_cm(rgbs_cm, weights, tdist, bg_rgbs, t_far,
                            compute_extras, extras=None):
    """Channel-major volumetric rendering: rgbs_cm [3, R, S], weights [R, S].

    Returns a dict with 'rgb' [R, 3], 'depth' [R], 'acc' [R] and, when
    compute_extras, the composited extras and distance statistics.  Rays
    with acc < 0.6 get depth = 300 (the reference's sky clamp)."""
    rendering = {}
    acc = weights.sum(dim=-1)
    bg_w = torch.clamp(1 - acc, min=0.0)
    rgb = (torch.einsum("rs,crs->rc", weights, rgbs_cm)
           + bg_w[:, None] * bg_rgbs)
    t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
    lo, hi = tdist[..., 0], tdist[..., -1]
    depth = torch.clamp(
        torch.nan_to_num((weights * t_mids).sum(dim=-1)
                         / torch.clamp(acc, min=EPS), nan=float("inf")),
        lo, hi)
    depth = torch.where(acc < 0.6, torch.full_like(depth, 300.0), depth)
    rendering["rgb"] = rgb
    rendering["depth"] = depth
    rendering["acc"] = acc

    if compute_extras:
        if extras is not None:
            for k, v in extras.items():
                if v is not None:
                    rendering[k] = torch.einsum("rs,crs->rc", weights, v)
        expectation = lambda x: ((weights * x).sum(dim=-1)
                                 / torch.clamp(acc, min=EPS))
        rendering["distance_mean"] = torch.clamp(
            torch.nan_to_num(torch.exp(expectation(torch.log(t_mids))),
                             nan=float("inf")),
            lo, hi)
        t_aug = torch.cat([tdist, t_far], dim=-1)
        weights_aug = torch.cat([weights, bg_w[:, None]], dim=-1)
        ps = [5, 50, 95]
        distance_percentiles = stepfun.weighted_percentile(t_aug, weights_aug,
                                                           ps)
        for i, p in enumerate(ps):
            s = "median" if p == 50 else "percentile_" + str(p)
            rendering["distance_" + s] = distance_percentiles[..., i]
    return rendering


def volumetric_rendering(rgbs, weights, tdist, bg_rgbs, t_far, compute_extras,
                         extras=None):
    """Row-major ``volumetric_rendering_cm``: rgbs [R, S, 3], extras
    [R, S, 3]; the same outputs."""
    cm = lambda v: None if v is None else v.permute(2, 0, 1)
    if extras is not None:
        extras = {k: cm(v) for k, v in extras.items()}
    return volumetric_rendering_cm(cm(rgbs), weights, tdist, bg_rgbs, t_far,
                                   compute_extras, extras)

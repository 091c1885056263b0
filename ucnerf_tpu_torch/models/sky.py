"""Sky model: a vanilla view-dependent NeRF raymarched beyond the far plane
(port of ``ucnerf_tpu/models/sky.py``).

Samples run linearly from the scene's far plane to sky_far_mult * far, the
JAX package's documented deviation from the reference's decreasing z.
Channel-major ([C, R, S] activations) throughout.
"""

from __future__ import annotations

import torch
from torch import nn

from ucnerf_tpu_torch.models.fields import DenseCM, pos_enc_width
from ucnerf_tpu_torch.ops import coord, mathx


class SkyNeRF(nn.Module):
    """Vanilla NeRF MLP: positions raw, views posenc'd.

    Channel-major: pts [3, ...], views_enc [V, ...] -> (alpha [1, ...],
    rgb [3, ...])."""

    def __init__(self, generator: torch.Generator, net_depth: int = 8,
                 net_width: int = 256, deg_view: int = 4, skips=(4,)):
        super().__init__()
        self.net_depth = net_depth
        self.deg_view = deg_view
        self.skips = tuple(skips)
        width = 3
        for i in range(net_depth):
            self.add_module(f"pts_linears_{i}",
                            DenseCM(width, net_width, generator))
            width = net_width + (3 if i in self.skips else 0)
        self.alpha_linear = DenseCM(width, 1, generator)
        self.feature_linear = DenseCM(width, net_width, generator)
        self.views_linears_0 = DenseCM(net_width + pos_enc_width(deg_view),
                                       net_width // 2, generator)
        self.rgb_linear = DenseCM(net_width // 2, 3, generator)

    def forward(self, pts, views_enc):
        h = pts
        for i in range(self.net_depth):
            h = torch.relu(getattr(self, f"pts_linears_{i}")(h))
            if i in self.skips:
                h = torch.cat([pts, h], dim=0)
        alpha = self.alpha_linear(h)
        feature = self.feature_linear(h)
        h = torch.relu(self.views_linears_0(torch.cat([feature, views_enc],
                                                      dim=0)))
        return alpha, self.rgb_linear(h)


class _CumprodNonzero(torch.autograd.Function):
    """``torch.cumprod`` along the last axis of factors none of which is 0,
    with the backward torch takes for such factors: the reversed cumulative
    sum of out * grad, divided by the factors.  Torch's own backward first
    asks the device whether any factor is 0, a wait for the device that a
    CUDA graph's capture refuses."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        return (out * grad).flip(-1).cumsum(-1).flip(-1).div(x)


def cumprod_nonzero(x):
    """Cumulative product along the last axis of x, whose entries are never
    0 (see ``_CumprodNonzero``)."""
    return _CumprodNonzero.apply(x)


def render_sky(sky_model, origins, directions, near, far, num_samples,
               viewdirs=None):
    """One-level deterministic raymarch of the sky NeRF.

    Args:
      sky_model: a SkyNeRF.
      origins/directions: [R, 3] (directions not normalized).
      near/far: [R, 1] per-ray start (the scene far plane) and end.
      num_samples: sample count (reference: 120).
      viewdirs: [R, 3] input to the view branch (the camera forward axis,
        as in the reference).

    Returns:
      dict with rgb_map [R, 3], depth_map [R], acc_map [R].
    """
    r = origins.shape[0]
    s = num_samples
    if viewdirs is None:
        viewdirs = directions
    t_vals = mathx.linspace(0.0, 1.0, s, origins.device)
    z_vals = near * (1.0 - t_vals) + far * t_vals  # [R, S]

    pts = origins.T[:, :, None] + directions.T[:, :, None] * z_vals[None]
    views_enc = coord.pos_enc(viewdirs, 0, sky_model.deg_view)  # [R, V]
    views_cm = views_enc.T[:, :, None].expand(-1, r, s)
    alpha_raw, rgb_raw = sky_model(pts, views_cm)

    # raw2outputs: relu density, 1e10 terminal interval.
    dists = torch.diff(z_vals, dim=-1)
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(directions, dim=-1, keepdim=True)
    rgb = torch.sigmoid(rgb_raw)  # [3, R, S]
    alpha = 1.0 - torch.exp(-torch.relu(alpha_raw[0]) * dists)  # [R, S]
    # Each factor is at least 1e-10.
    trans = cumprod_nonzero(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                  dim=-1))[..., :-1]
    weights = alpha * trans
    rgb_map = torch.einsum("rs,crs->rc", weights, rgb)
    depth_map = (weights * z_vals).sum(dim=-1)
    acc_map = weights.sum(dim=-1)
    return dict(rgb_map=rgb_map, depth_map=depth_map, acc_map=acc_map)

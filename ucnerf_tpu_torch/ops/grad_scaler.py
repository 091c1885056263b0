"""'Floaters no more' near-camera gradient down-scaling
(port of ``ucnerf_tpu/ops/grad_scaler.py``).

Identity in the forward pass; the backward pass multiplies the rgb/density
gradients by clamp(t_mean^2, 0, 1), suppressing updates from samples close
to the camera.
"""

from __future__ import annotations

import torch


class _ScaleGradientsByDistance(torch.autograd.Function):

    @staticmethod
    def forward(ctx, rgb, density, ray_dist):
        ctx.save_for_backward(ray_dist)
        return rgb.view_as(rgb), density.view_as(density)

    @staticmethod
    def backward(ctx, g_rgb, g_density):
        (ray_dist,) = ctx.saved_tensors
        scaling = torch.clamp(torch.square(ray_dist), 0.0, 1.0)
        return g_rgb * scaling[None], g_density * scaling, None


def scale_gradients_by_distance(rgb, density, ray_dist):
    """Returns (rgb, density) unchanged; scales their gradients by
    clamp(ray_dist^2, 0, 1) on the way back.

    Channel-major layout: rgb [3, *dims], density [*dims], ray_dist [*dims].
    """
    return _ScaleGradientsByDistance.apply(rgb, density, ray_dist)

"""In-graph differentiable per-camera extrinsic refinement
(port of ``ucnerf_tpu/models/cam_refine.py``).

A per-physical-camera se(3) delta, applied to the rays inside the training
forward, so residual rig miscalibration is optimized jointly with the
radiance field by the same Adam step.  ``pixels_to_rays`` gives
``origins = c2w[:3, 3]`` and ``directions = R_c2w @ K^{-1} @ pix``, so
left-composing a rigid delta onto the camera pose, ``c2w' = Exp(xi) @ c2w``,
transforms every ray as ``o' = R o + t, d' = R d``.

Each ray picks its camera's rotation and translation by indexing, whose
backward on the card is ``index_put_`` with accumulation, which sorts the
indices first: the deltas' gradient adds in a fixed order (``torch.gather``
would add with float atomics).
"""

from __future__ import annotations

import torch
from torch import nn


def so3_exp(w):
    """Rodrigues' formula: rotation vectors [..., 3] -> matrices [..., 3, 3].

    Uses the small-angle forms of sin(t)/t and (1-cos(t))/t^2 so gradients
    are exact at w = 0 (the init point: every delta starts at identity).
    """
    theta_sq = torch.sum(w**2, dim=-1)[..., None, None]
    small = theta_sq < 1e-8
    # Safe-where: evaluate the trig branch at theta = 1 where small, so the
    # untaken branch never divides by ~0 (f32 1/1e-24 overflows to inf and
    # poisons gradients with inf * 0 = nan).
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / safe_sq)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    hat = torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(hat.shape)
    return eye + a * hat + b * (hat @ hat)


def se3_apply(deltas, phys_cam_idx, origins, directions, cam_dirs):
    """Apply per-camera rigid deltas [C, 6] (rotvec | translation) to rays.

    Args:
      deltas: [C, 6] se(3) parameters per physical camera.
      phys_cam_idx: [N] int, which physical camera each ray belongs to.
      origins/directions/cam_dirs: [N, 3].

    Returns:
      (origins', directions', cam_dirs') with c2w' = Exp(delta) @ c2w
      semantics: o' = R o + t, d' = R d.
    """
    rot = so3_exp(deltas[:, :3])  # [C, 3, 3]
    trans = deltas[:, 3:]  # [C, 3]
    idx = phys_cam_idx.long()
    r = rot[idx]  # [N, 3, 3]
    t = trans[idx]  # [N, 3]

    def apply_r(v):
        return torch.einsum("nij,nj->ni", r, v)

    return apply_r(origins) + t, apply_r(directions), apply_r(cam_dirs)


class CameraRefinement(nn.Module):
    """Per-physical-camera se(3) delta parameters, identity at init."""

    def __init__(self, num_cams: int):
        super().__init__()
        self.se3_deltas = nn.Parameter(torch.zeros(num_cams, 6))

    def forward(self, phys_cam_idx, origins, directions, cam_dirs):
        return se3_apply(self.se3_deltas, phys_cam_idx, origins, directions,
                         cam_dirs)

"""TSDF fusion of rendered depth maps (port of ``ucnerf_tpu/extraction/tsdf.py``).

A voxel grid over the scene is updated by projecting voxel centers into each
rendered depth map, computing a truncated signed distance along the camera
ray, and averaging it in with per-voxel weights; the zero level set is
meshed afterwards (``meshing.mesh_from_tsdf``).  The grid's arrays are torch
tensors on one device, and ``integrate`` is a handful of elementwise passes
over them there.  Voxels project to the nearest pixel with ``torch.round``,
which rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class TSDFGrid:
    """Axis-aligned TSDF volume: tsdf and weight [R, R, R], color
    [R, R, R, 3] or None, float32 tensors on one device."""
    resolution: int
    radius: float
    truncation: float
    tsdf: torch.Tensor
    weight: torch.Tensor
    color: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, resolution: int, radius: float, truncation_margin=5.0,
               with_color=True, device="cuda"):
        voxel_size = 2 * radius / resolution
        shape = (resolution,) * 3
        kw = dict(dtype=torch.float32, device=device)
        return cls(
            resolution=resolution, radius=radius,
            truncation=truncation_margin * voxel_size,
            tsdf=torch.ones(shape, **kw), weight=torch.zeros(shape, **kw),
            color=torch.zeros(shape + (3,), **kw) if with_color else None)

    @property
    def voxel_size(self):
        return 2 * self.radius / self.resolution

    def voxel_centers(self):
        """[R, R, R, 3] world coordinates of the voxel centers."""
        r = self.resolution
        idx = ((torch.arange(r, dtype=torch.float32, device=self.tsdf.device)
                + 0.5) * self.voxel_size - self.radius)
        x, y, z = torch.meshgrid(idx, idx, idx, indexing="ij")
        return torch.stack([x, y, z], dim=-1)


@torch.no_grad()
def integrate(grid: TSDFGrid, depth, pose_cv, intrinsic, rgb=None):
    """Fuse one rendered depth map into the grid.

    Args:
      grid: current TSDFGrid.
      depth: [H, W] z-depth (0/inf = invalid).
      pose_cv: [4, 4] camera-to-world in OpenCV convention.
      intrinsic: [3, 3].
      rgb: optional [H, W, 3].
      All float32 tensors on the grid's device.

    Returns:
      The updated TSDFGrid (a new one; `grid` is left as it is).
    """
    h, w = depth.shape
    r = grid.resolution
    centers = grid.voxel_centers().reshape(-1, 3)

    w2c = torch.linalg.inv(pose_cv)
    cam = centers @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    pix = cam @ intrinsic.T
    z_safe = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    px = pix[:, 0] / z_safe
    py = pix[:, 1] / z_safe

    xi = torch.clamp(torch.round(px).to(torch.int32), 0, w - 1).long()
    yi = torch.clamp(torch.round(py).to(torch.int32), 0, h - 1).long()
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h) & (z > 0)
    d = depth[yi, xi]
    valid = inb & (d > 0) & torch.isfinite(d)

    sdf = d - z
    tsdf_new = torch.clamp(sdf / grid.truncation, -1.0, 1.0)
    upd = valid & (sdf > -grid.truncation)

    w_old = grid.weight.reshape(-1)
    t_old = grid.tsdf.reshape(-1)
    w_new = w_old + upd
    denom = torch.clamp(w_new, min=1.0)
    t_fused = torch.where(upd, (t_old * w_old + tsdf_new) / denom, t_old)

    out = dataclasses.replace(
        grid, tsdf=t_fused.reshape(r, r, r), weight=w_new.reshape(r, r, r))
    if grid.color is not None and rgb is not None:
        c_old = grid.color.reshape(-1, 3)
        c_obs = rgb[yi, xi]
        c_fused = torch.where(
            upd[:, None], (c_old * w_old[:, None] + c_obs) / denom[:, None],
            c_old)
        out = dataclasses.replace(out, color=c_fused.reshape(r, r, r, 3))
    return out

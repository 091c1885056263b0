"""Camera models and ray generation, host-side numpy
(a copy of ``ucnerf_tpu/data/cameras.py``'s numpy path).

This is how a render request becomes rays: pixel -> ray casting with
mip-NeRF cone radii, radial/tangential undistortion, fisheye/pano
projection and the OpenCV -> OpenGL axis flip.
"""

from __future__ import annotations

import enum

import numpy as np


class ProjectionType(enum.Enum):
    PERSPECTIVE = "perspective"
    FISHEYE = "fisheye"
    PANORAMA = "panoroma"  # (sic) matches the reference's string.


def _compute_residual_and_jacobian(x, y, xd, yd, k1=0, k2=0, k3=0, k4=0,
                                   p1=0, p2=0):
    """Residual and Jacobian of the radial+tangential distortion model."""
    r = x * x + y * y
    d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))
    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd
    d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r
    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(xd, yd, k1=0, k2=0, k3=0, k4=0, p1=0,
                                    p2=0, eps=1e-9, max_iterations=10):
    """Newton-undistort (xd, yd) -> (x, y)."""
    x = np.copy(xd)
    y = np.copy(yd)
    for _ in range(max_iterations):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _compute_residual_and_jacobian(
            x=x, y=y, xd=xd, yd=yd, k1=k1, k2=k2, k3=k3, k4=k4, p1=p1, p2=p2)
        denominator = fy_x * fx_y - fx_x * fy_y
        x_num = fx * fy_y - fy * fx_y
        y_num = fy * fx_x - fx * fy_x
        safe = np.abs(denominator) > eps
        x = x + np.where(safe, x_num / denominator, 0.0)
        y = y + np.where(safe, y_num / denominator, 0.0)
    return x, y


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params=None,
                   camtype=ProjectionType.PERSPECTIVE):
    """Pixel coordinates -> world rays with mip cone radii.

    Args:
      pix_x_int/pix_y_int: int arrays of any batch shape SH.
      pixtocams: broadcastable to SH + [3, 3] inverse intrinsics.
      camtoworlds: broadcastable to SH + [3, 4] (or [4, 4]) extrinsics,
        OpenCV-convention input; output rays are OpenGL (x right, y up,
        z backward).
      distortion_params: optional dict of k1..k4/p1/p2.
      camtype: projection model.

    Returns:
      origins, directions, viewdirs [SH, 3]; radii [SH, 1]; imageplane [SH, 2].
    """
    def pix_to_dir(x, y):
        return np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)

    # dx/dy neighbor rays give the cone radius (mip-NeRF).
    pixel_dirs_stacked = np.stack([
        pix_to_dir(pix_x_int, pix_y_int),
        pix_to_dir(pix_x_int + 1, pix_y_int),
        pix_to_dir(pix_x_int, pix_y_int + 1),
    ], axis=0)

    mat_vec_mul = lambda A, b: np.matmul(A, b[..., None])[..., 0]
    camera_dirs_stacked = mat_vec_mul(pixtocams, pixel_dirs_stacked)

    if distortion_params is not None:
        x, y = radial_and_tangential_undistort(
            camera_dirs_stacked[..., 0], camera_dirs_stacked[..., 1],
            **distortion_params)
        camera_dirs_stacked = np.stack([x, y, np.ones_like(x)], axis=-1)

    if camtype == ProjectionType.PANORAMA:
        camera_dirs_stacked = np.stack([
            np.sin(camera_dirs_stacked[..., 0]),
            camera_dirs_stacked[..., 1],
            np.cos(camera_dirs_stacked[..., 0]),
        ], axis=-1)
    elif camtype == ProjectionType.FISHEYE:
        theta = np.sqrt(
            np.sum(np.square(camera_dirs_stacked[..., :2]), axis=-1))
        theta = np.minimum(np.pi, theta)
        sin_over = np.sin(theta) / np.maximum(theta, 1e-12)
        camera_dirs_stacked = np.stack([
            camera_dirs_stacked[..., 0] * sin_over,
            camera_dirs_stacked[..., 1] * sin_over,
            np.cos(theta),
        ], axis=-1)

    # Flip from OpenCV to OpenGL coordinates.
    flip = np.diag(np.array([1.0, -1.0, -1.0])).astype(
        camera_dirs_stacked.dtype)
    camera_dirs_stacked = np.matmul(camera_dirs_stacked, flip)

    imageplane = camera_dirs_stacked[0, ..., :2]

    directions_stacked = mat_vec_mul(camtoworlds[..., :3, :3],
                                     camera_dirs_stacked)
    directions, dx, dy = (directions_stacked[0], directions_stacked[1],
                          directions_stacked[2])
    origins = np.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
    viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
    dx_norm = np.linalg.norm(dx - directions, axis=-1)
    dy_norm = np.linalg.norm(dy - directions, axis=-1)
    # Half the neighbor distance, scaled to match a pixel-wide uniform
    # distribution's std (1/sqrt(12)).
    radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / np.sqrt(12)
    return origins, directions, viewdirs, radii, imageplane


def cast_ray_batch(cameras, pixels, camtype=ProjectionType.PERSPECTIVE):
    """(cameras, pixel batch) -> ray batch dict.

    cameras: (pixtocams [M,3,3], camtoworlds [M,3,4|4,4], distortion, _).
    pixels: dict with pix_x_int, pix_y_int, cam_idx [...,1] and ray metadata.
    """
    pixtocams, camtoworlds, distortion_params, _ = cameras
    cam_idx = pixels["cam_idx"][..., 0]
    batch_index = lambda arr: arr if arr.ndim == 2 else arr[cam_idx]
    origins, directions, viewdirs, radii, imageplane = pixels_to_rays(
        pixels["pix_x_int"], pixels["pix_y_int"],
        batch_index(pixtocams), batch_index(camtoworlds),
        distortion_params=distortion_params, camtype=camtype)
    return dict(
        origins=origins,
        directions=directions,
        viewdirs=viewdirs,
        radii=radii,
        imageplane=imageplane,
        lossmult=pixels.get("lossmult"),
        near=pixels.get("near"),
        far=pixels.get("far"),
        cam_idx=pixels.get("cam_idx"),
    )


def pose_image_batch(pixtocam, camtoworld, width, height, near, far):
    """Ray batch for every pixel of one view: dict of [H, W, ...] float32
    arrays (the JAX package's ``cli/render._pose_image_batch``).

    pixtocam: [3, 3] inverse intrinsics; camtoworld: [3, 4] OpenCV pose.
    """
    x, y = np.meshgrid(np.arange(width), np.arange(height))
    origins, directions, viewdirs, radii, _ = pixels_to_rays(
        x, y, pixtocam[None], camtoworld[None, :3, :])
    scal = lambda v: np.full((height, width, 1), v, np.float32)
    return {
        "origins": origins.astype(np.float32),
        "directions": directions.astype(np.float32),
        "viewdirs": viewdirs.astype(np.float32),
        "cam_dirs": np.broadcast_to(-camtoworld[:3, 2],
                                    (height, width, 3)).astype(np.float32),
        "radii": radii.astype(np.float32),
        "near": scal(near),
        "far": scal(far),
        "cam_idx": np.zeros((height, width), np.int32),
    }

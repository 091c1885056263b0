"""Plain NumPy ray generation: pixels of posed pinhole views to mip-NeRF
rays (origins, directions, unit view directions, cone radii), and the
flat ray batches of training and of a rendered view."""

from __future__ import annotations

import numpy as np


def pixels_to_rays(px, py, pixtocams, camtoworlds):
    """Rays through pixel centres; radii from the neighbouring pixels'
    directions.  pixtocams [..., 3, 3], camtoworlds [..., 3, 4] (OpenGL)."""
    def pix(x, y):
        return np.stack([x + 0.5, y + 0.5, np.ones_like(x)], axis=-1)

    stacked = np.stack([pix(px, py), pix(px + 1, py), pix(px, py + 1)])
    cam = np.matmul(pixtocams, stacked[..., None])[..., 0]
    cam = np.matmul(cam, np.diag(np.array([1.0, -1.0, -1.0])).astype(
        cam.dtype))
    dirs = np.matmul(camtoworlds[..., :3, :3], cam[..., None])[..., 0]
    d, dx, dy = dirs[0], dirs[1], dirs[2]
    origins = np.broadcast_to(camtoworlds[..., :3, -1], d.shape)
    viewdirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    radii = (0.5 * (np.linalg.norm(dx - d, axis=-1)
                    + np.linalg.norm(dy - d, axis=-1)))[..., None] \
        * 2 / np.sqrt(12)
    return origins, d, viewdirs, radii


def train_batch(scene, rng, n, near, far):
    """n random pixels over all train views, drawn as the view index, then
    x, then y, each a ``rng.integers`` call."""
    views = len(scene.camtoworlds)
    cam = rng.integers(0, views, n)
    px = rng.integers(0, scene.width, n)
    py = rng.integers(0, scene.height, n)
    o, d, vd, radii = pixels_to_rays(px, py, scene.pixtocams[cam],
                                     scene.camtoworlds[cam][..., :3, :])
    plane = cam % scene.cameras
    return {
        "origins": o, "directions": d, "viewdirs": vd, "radii": radii,
        "cam_dirs": -scene.camtoworlds[cam][..., :3, 2],
        "near": np.full((n, 1), near), "far": np.full((n, 1), far),
        "lossmult": np.ones((n, 1)),
        "cam_idx": cam,
        "rgb": scene.textures[plane, py, px],
        "sky_segs": scene.sky[plane, py, px],
    }


def view_batch(pixtocam, pose, width, height, near, far):
    """Every pixel of one view, flat [H*W, ...], row-major."""
    x, y = np.meshgrid(np.arange(width), np.arange(height))
    o, d, vd, radii = pixels_to_rays(x.reshape(-1), y.reshape(-1),
                                     pixtocam[None], pose[None, :3, :])
    n = width * height
    return {
        "origins": o, "directions": d, "viewdirs": vd, "radii": radii,
        "cam_dirs": np.broadcast_to(-pose[:3, 2], (n, 3)),
        "near": np.full((n, 1), near), "far": np.full((n, 1), far),
        "cam_idx": np.zeros((n,), np.int64),
    }

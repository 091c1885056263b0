"""The benchmark's scene generator: a Waymo-like driving segment made from a
traffic file's parameters and the run's seed, in the layout the port's
Waymo loader (``WaymoV2Dataset``) produces.

A rig of front cameras (Waymo's ``cam_type`` 6: FRONT, FRONT_LEFT,
FRONT_RIGHT) rides a vehicle along a gently turning road, one frame per
metre.  The poses are normalised as the loader normalises them (translations
centred, unit mean radius, OpenCV axes flipped to OpenGL), every
``holdout``-th frame group is the test split, and the intrinsics are a
pinhole at the sensor's size divided by ``factor``.  Pixel values and sky
masks are cheap: one seeded texture and one sky mask a physical camera,
shared by its frames (the loader would read JPEGs and segmentations).  The
ray geometry, which decides the hash grid's lookups, is whole.

Nothing here imports the port: ``PortDataset`` (which subclasses the port's
``RayDataset``) lives in ``portbench/kinds/train.py``.
"""

from __future__ import annotations

import numpy as np

# OpenCV -> OpenGL camera axes, as the Waymo loader flips them.
_FLIP = np.diag([1.0, -1.0, -1.0, 1.0])


class PerCamera:
    """A [views, H, W, ...] array whose view v is plane v % cameras: the
    per-camera textures and sky masks, indexed as the loader's arrays are
    (``images[cam_idx, pix_y, pix_x]``) without storing a copy a view."""

    def __init__(self, planes: np.ndarray, num_views: int):
        self.planes = planes
        self.shape = (num_views,) + planes.shape[1:]

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        view = np.asarray(key[0]) % self.planes.shape[0]
        return self.planes[(view,) + tuple(key[1:])]


def _rig_poses(p):
    """OpenCV camera-to-world [frames * cameras, 4, 4] (frame-major) in
    metres, world z up."""
    frames, yaws = p["frames"], np.deg2rad(p["yaw_deg"])
    heading = np.deg2rad(p["turn_deg"]) * np.linspace(-0.5, 0.5, frames)
    step = p["metres_per_frame"]
    pos = np.zeros((frames, 3))
    pos[1:, 0] = np.cumsum(step * np.cos(heading[1:]))
    pos[1:, 1] = np.cumsum(step * np.sin(heading[1:]))
    poses = []
    for f in range(frames):
        for yaw in yaws:
            a = heading[f] + yaw
            forward = np.array([np.cos(a), np.sin(a), 0.0])
            down = np.array([0.0, 0.0, -1.0])
            right = np.cross(down, forward)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2] = right, down, forward
            c2w[:3, 3] = pos[f] + np.array([0.0, 0.0, p["mount_height_m"]])
            poses.append(c2w)
    return np.asarray(poses)


def _normalisation(poses):
    """The loader's centre and scale: translations centred, unit mean
    radius."""
    center = poses[:, :3, 3].mean(axis=0)
    scale = 1.0 / np.mean(np.linalg.norm(poses[:, :3, 3] - center, axis=-1))
    return center, scale


def _normalise(poses, center, scale):
    out = np.array(poses, np.float64)
    out[:, :3, 3] = (out[:, :3, 3] - center) * scale
    return out @ _FLIP


def _intrinsics(p):
    factor = p["factor"]
    w, h = p["sensor_width"] // factor, p["sensor_height"] // factor
    f = p["focal_px"] / factor
    k = np.array([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]])
    return k, w, h


class Scene:
    """The segment's arrays for one split.

    Attributes:
      width, height: view size.
      camtoworlds: [V, 4, 4] float32 OpenGL poses of the split's views,
        frame-major (view v is camera v % cameras).
      pixtocams: [V, 3, 3] float32 inverse intrinsics.
      cameras: physical cameras of the rig.
      textures: [cameras, H, W, 3] float32 pixel values.
      sky: [cameras, H, W] float32 sky masks (1 = sky).
    """

    def __init__(self, params: dict, seed: int, split: str = "train"):
        p = params
        self.cameras = len(p["yaw_deg"])
        k, self.width, self.height = _intrinsics(p)
        raw = _rig_poses(p)
        self.center, self.scale = _normalisation(raw)
        groups = np.arange(len(raw)) // self.cameras
        test = groups % p["holdout"] == 0
        keep = ~test if split == "train" else test
        self.camtoworlds = _normalise(raw[keep], self.center,
                                      self.scale).astype(np.float32)
        self.pixtocams = np.tile(np.linalg.inv(k)[None].astype(np.float32),
                                 (len(self.camtoworlds), 1, 1))
        self.textures, self.sky = self._pixels(p, seed)
        self.params = p

    def _pixels(self, p, seed):
        """One seeded texture of cell x cell blocks a camera, and a sky
        mask above a horizon row."""
        rng = np.random.default_rng([seed, 2])
        cell = p["texture_cell_px"]
        h, w = self.height, self.width
        coarse = rng.random((self.cameras, -(-h // cell), -(-w // cell), 3),
                            dtype=np.float32)
        tex = np.repeat(np.repeat(coarse, cell, axis=1), cell, axis=2)
        tex = np.ascontiguousarray(tex[:, :h, :w])
        rows = np.arange(h)[:, None] < int(p["horizon_frac"] * h)
        sky = np.broadcast_to(rows, (self.cameras, h, w)).astype(np.float32)
        return tex, sky

    def path_poses(self, frames: int):
        """A render path: the FRONT camera's pose at `frames` evenly spaced
        times along the segment, normalised as the views are, [frames, 3, 4]
        float32 OpenGL camera-to-world."""
        p = self.params
        t = np.linspace(0, p["frames"] - 1, frames)
        front = _rig_poses(dict(p, yaw_deg=[p["yaw_deg"][0]]))
        out = []
        for ti in t:
            i = min(int(ti), p["frames"] - 2)
            a = ti - i
            pose = front[i].copy()
            pose[:3, 3] = (1 - a) * front[i][:3, 3] + a * front[i + 1][:3, 3]
            # Heading turns slowly: the nearer frame's rotation.
            pose[:3, :3] = front[i + int(a >= 0.5)][:3, :3]
            out.append(pose)
        return _normalise(np.asarray(out), self.center,
                          self.scale)[:, :3, :4].astype(np.float32)

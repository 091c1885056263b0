"""MVS datasets: temporal-window loaders for depth estimation (a copy of
``ucnerf_tpu/models/mvs/datasets.py``, which is numpy only, importing the
port's ``configs`` and ``data`` modules).

Functional parity with the reference (``mvs/datasets/waymo.py``): each
reference frame gets a window of 6 temporal neighbors of the SAME physical
camera (offsets +-{1,2,3} x num_cams, shifted inward at sequence boundaries
with stride 3, waymo.py:76,86-92), refined pose.json world-to-cam poses, and
the fixed metric scale 200 (waymo.py:97-98).

A synthetic variant reuses ``data.datasets.SyntheticDataset`` so MVS can be
exercised end-to-end without Waymo data.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List

import numpy as np

from ucnerf_tpu_torch.data import cameras as camlib


def temporal_offsets(num_frames: int, num_cams: int) -> np.ndarray:
    """Same-camera temporal source offsets for an MVS window.

    +-{1..num_frames/2} frames of the same physical camera (waymo.py:76
    uses 6 sources; the reference demo's 3 passes sweep 6/8/10 sources,
    demo_custom.py:33-44)."""
    half = max(num_frames // 2, 1)
    return np.array([o for o in range(-half, half + 1) if o != 0],
                    np.int64) * num_cams


class WaymoMVSWindows:
    """Temporal windows over the Waymo segment for per-view depth."""

    NUM_FRAMES = 80
    SCALE = 200.0  # waymo.py:98

    def __init__(self, data_dir: str, pose_json: str, num_cams: int = 3,
                 window_stride: int = 3, num_frames: int = 6):
        sensor_type = [f"cam_{i+1}" for i in range(num_cams)]
        self.data_dir = data_dir
        self.images_path: List[str] = []
        self.poses: List[np.ndarray] = []
        self.intrinsics: List[np.ndarray] = []
        self.data_index: List[str] = []

        scene_info_path = os.path.join(data_dir, "scenario.pt")
        with open(scene_info_path, "rb") as f:
            scenario = pickle.load(f)
        cam_order = {"camera_FRONT": 0, "camera_FRONT_LEFT": 1,
                     "camera_FRONT_RIGHT": 2, "camera_SIDE_LEFT": 3,
                     "camera_SIDE_RIGHT": 4}
        intr_per_cam = [None] * 5
        for oid, odict in scenario["observers"].items():
            if odict.get("class_name") == "Camera":
                intr_per_cam[cam_order[oid]] = np.asarray(
                    odict["data"]["intr"])

        with open(pose_json) as jp:
            poses_json = json.load(jp)

        for idx in range(self.NUM_FRAMES):
            for cam_idx, cam in enumerate(sensor_type):
                rgb_path = os.path.join(data_dir, "images", cam,
                                        f"{idx:08d}.jpg")
                self.images_path.append(rgb_path)
                self.intrinsics.append(
                    np.asarray(intr_per_cam[cam_idx][idx], np.float64))
                self.data_index.append(f"{idx:08d}{cam}")
                attrs = poses_json[f"{cam}/{idx:08d}"]
                w2c = np.eye(4)
                w2c[:3, :3] = camlib.quat_xyzw_to_rotmat(
                    [attrs["q_x"], attrs["q_y"], attrs["q_z"],
                     attrs["q_w"]])
                w2c[:3, 3] = [attrs["p_x"], attrs["p_y"], attrs["p_z"]]
                self.poses.append(w2c)

        self.num_cams = num_cams
        self.window_stride = window_stride
        self.offsets = temporal_offsets(num_frames, num_cams)

    def __len__(self):
        return len(self.poses)

    def window_indices(self, index: int) -> List[int]:
        """Ref frame + 6 same-camera neighbors, shifted inward at boundaries
        (waymo.py:86-92)."""
        indices = self.offsets.copy() + index
        while indices[0] < 0:
            indices += self.window_stride
        while indices[-1] >= len(self.poses):
            indices -= self.window_stride
        assert indices[0] >= 0
        return [index] + [int(i) for i in indices if i != index]

    def __getitem__(self, index: int):
        from PIL import Image
        idxs = self.window_indices(index)
        images = np.stack([
            np.asarray(Image.open(self.images_path[i]), np.float32)
            for i in idxs])
        poses = np.stack([self.poses[i] for i in idxs]).astype(np.float32)
        intr = np.stack([self.intrinsics[i] for i in idxs]).astype(np.float32)
        return (images, poses, intr,
                [self.data_index[i] for i in idxs], self.SCALE)


class SyntheticMVSWindows:
    """MVS windows over the synthetic analytic scene (for tests/benchmarks).

    Uses world-to-cam OpenCV poses derived from the synthetic dataset and the
    exact analytic depth for supervision checks.
    """

    def __init__(self, config=None, num_views: int = 5):
        from ucnerf_tpu_torch import configs as cfglib
        from ucnerf_tpu_torch.data import datasets as dsets
        from ucnerf_tpu_torch.data import warping

        config = config or cfglib.tiny()
        ds = dsets.load_dataset("train", config)
        self.ds = ds
        n = min(num_views, ds.n_examples)
        cv = warping.GL_TO_CV
        self.images = (ds.images[:n] * 255.0).astype(np.float32)
        # world-to-cam in OpenCV convention, as the MVS stack expects.
        self.poses = np.stack([
            np.linalg.inv(ds.camtoworlds[i] @ cv) for i in range(n)
        ]).astype(np.float32)
        self.intrinsics = np.stack([
            np.linalg.inv(ds.pixtocams[i]) for i in range(n)
        ]).astype(np.float32)
        self.depths = ds.disp_images[:n]
        self.scale = 1.0

    def __len__(self):
        return len(self.images)

    def window(self, index: int = 0):
        order = [index] + [i for i in range(len(self.images)) if i != index]
        return (self.images[order], self.poses[order],
                self.intrinsics[order], self.scale)

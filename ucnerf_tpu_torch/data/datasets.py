"""Datasets: ray sampling, the Waymo-V2 loader, and a synthetic scene
(a copy of ``ucnerf_tpu/data/datasets.py``, which is numpy only, importing
the port's ``configs``, ``cameras`` and ``warping``).

Re-design of the reference data layer
(the reference's ``nerf/internal/datasets.py``): the abstract ``Dataset``
(datasets.py:213-593) becomes a host-side ``RayDataset`` that samples flat ray
batches with numpy (ray-gen on host, like the reference's "slow path",
datasets.py:445) and hands them to the device sharded; ``WaymoV2``
(datasets.py:881-1140) keeps its on-disk contract (scenario.pt poses,
pose.json refinement override, sky masks, MVS depth .npy files, center+scale
normalization, every-8th-frame-group test split).

``SyntheticDataset`` replaces "download Waymo" for tests and benchmarks: an
analytic scene (checker ground plane + sphere + direction-keyed sky) rendered
in closed form gives multi-view-consistent images, exact depth maps and sky
masks — enough to exercise every training feature including virtual-view
warping.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

from ucnerf_tpu_torch.configs import Config
from ucnerf_tpu_torch.data import cameras as camlib
from ucnerf_tpu_torch.data import warping


class DataSplit(enum.Enum):
    TRAIN = "train"
    TEST = "test"


class RayDataset:
    """Host-side ray sampler over a set of posed images.

    Subclasses populate: images [M,H,W,3] float32, camtoworlds [M,4,4]
    (OpenGL), pixtocams [M,3,3], and optionally sky_segments [M,H,W],
    disp_images [M,H,W] (metric depth, scene-scaled), virtual_poses
    [9M,4,4] + virtual_pixtocams [9M,3,3].
    """

    def __init__(self, split: DataSplit, config: Config):
        self.split = split
        self.config = config
        self.near = config.near
        self.far = config.far
        self.cam_num = 1
        self.images: Optional[np.ndarray] = None
        self.camtoworlds: Optional[np.ndarray] = None
        self.pixtocams: Optional[np.ndarray] = None
        self.sky_segments: Optional[np.ndarray] = None
        self.disp_images: Optional[np.ndarray] = None
        self.virtual_poses: Optional[np.ndarray] = None
        self.virtual_pixtocams: Optional[np.ndarray] = None
        # Per-view image names (when the loader reads files): used by the
        # spline render path's name-file keyframe selection
        # (camera_utils.py:303-350 / data/paths.create_render_spline_path).
        self.image_names: Optional[list] = None
        self.distortion_params = None
        self.camtype = camlib.ProjectionType.PERSPECTIVE
        self._load_renderings(config)
        self.n_examples = len(self.images)
        self.height, self.width = self.images.shape[1:3]

    def _load_renderings(self, config: Config):
        raise NotImplementedError

    @property
    def cameras(self):
        return (self.pixtocams, self.camtoworlds, self.distortion_params,
                None)

    def _rays_from_pixels(self, cam_idx, pix_x, pix_y):
        """Assemble the canonical flat ray-batch dict for given pixels."""
        n = cam_idx.shape[0]
        scal = lambda v: np.full((n, 1), v, np.float32)
        pixels = dict(
            pix_x_int=pix_x, pix_y_int=pix_y,
            lossmult=scal(1.0), near=scal(self.near), far=scal(self.far),
            cam_idx=cam_idx[..., None],
        )
        batch = camlib.cast_ray_batch(self.cameras, pixels, self.camtype)
        # Camera forward axis: -Z column of the OpenGL pose
        # (datasets.py:446).
        batch["cam_dirs"] = -self.camtoworlds[cam_idx][..., :3, 2]
        batch["rgb"] = self.images[cam_idx, pix_y, pix_x].astype(np.float32)
        if self.sky_segments is not None:
            batch["sky_segs"] = self.sky_segments[
                cam_idx, pix_y, pix_x].astype(np.float32)
        else:
            batch["sky_segs"] = np.zeros((n,), np.float32)
        batch["cam_idx"] = cam_idx.astype(np.int32)
        # Physical camera of each view: images are frame-major
        # (idx = frame * cam_num + cam), so view % cam_num is the rig slot.
        batch["phys_cam_idx"] = (cam_idx % self.cam_num).astype(np.int32)
        batch.pop("imageplane", None)
        return {k: v for k, v in batch.items() if v is not None}

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        """Sample a training batch of random pixels across all images.

        With virtual poses enabled, ~20% of the batch are rays cast from a
        virtual camera supervised by depth-warped real pixels
        (datasets.py:478-570).
        """
        cfg = self.config
        num_virtual = 0
        if (cfg.virtual_poses and self.split == DataSplit.TRAIN
                and self.virtual_poses is not None):
            num_virtual = batch_size // 5
        num_real = batch_size - num_virtual

        cam_idx = rng.integers(0, self.n_examples, num_real)
        pix_x = rng.integers(0, self.width, num_real)
        pix_y = rng.integers(0, self.height, num_real)
        batch = self._rays_from_pixels(cam_idx, pix_x, pix_y)

        if num_virtual:
            vbatch = self._sample_virtual(rng, num_virtual)
            if vbatch is not None:
                batch = {k: np.concatenate([batch[k], vbatch[k]], axis=0)
                         for k in batch}
            else:
                # Fall back to real rays if no valid warp was found.
                extra = self._rays_from_pixels(
                    rng.integers(0, self.n_examples, num_virtual),
                    rng.integers(0, self.width, num_virtual),
                    rng.integers(0, self.height, num_virtual))
                batch = {k: np.concatenate([batch[k], extra[k]], axis=0)
                         for k in batch}
        return batch

    def _sample_virtual(self, rng: np.random.Generator, n: int):
        """Sample virtual-supervision rays: rays cast from the virtual (src)
        camera, RGB supervision from the real (ref) image at depth-warped
        coordinates (datasets.py:507-567).

        Fast path: a precomputed correspondence pool (built once; replaces
        the reference's per-batch host-side rejection loop, which would stall
        training steps).  Falls back to rejection sampling when the pool is
        empty.
        """
        if not hasattr(self, "_warp_pool"):
            from ucnerf_tpu_torch.data import warping as warplib
            self._warp_pool = (
                warplib.precompute_correspondence_pool(self, rng)
                if self.disp_images is not None else None)
        pool = self._warp_pool
        if pool is not None:
            sel = rng.integers(0, len(pool["src_cam_idx"]), n)
            vidx = pool["src_cam_idx"][sel]
            sx, sy = pool["src_px"][sel], pool["src_py"][sel]
            ref_idx = pool["ref_idx"][sel]
            rx, ry = pool["ref_px"][sel], pool["ref_py"][sel]
            scal = lambda v: np.full((n, 1), v, np.float32)
            pixels = dict(
                pix_x_int=sx.astype(np.int64), pix_y_int=sy.astype(np.int64),
                lossmult=scal(1.0), near=scal(self.near), far=scal(self.far),
                # Per-ray camera arrays below, so index them identically.
                cam_idx=np.arange(n, dtype=np.int64)[:, None],
            )
            vcams = (self.virtual_pixtocams[vidx],
                     self.virtual_poses[vidx], self.distortion_params, None)
            batch = camlib.cast_ray_batch(vcams, pixels, self.camtype)
            batch["cam_dirs"] = (
                -self.virtual_poses[vidx][:, :3, 2]).astype(np.float32)
            batch["rgb"] = self.images[ref_idx, ry, rx].astype(np.float32)
            if self.sky_segments is not None:
                batch["sky_segs"] = self.sky_segments[
                    ref_idx, ry, rx].astype(np.float32)
            else:
                batch["sky_segs"] = np.zeros((n,), np.float32)
            batch["cam_idx"] = ref_idx.astype(np.int32)
            # Virtual views perturb a real camera; vidx // 9 is its view id.
            batch["phys_cam_idx"] = ((vidx // 9) % self.cam_num).astype(
                np.int32)
            batch.pop("imageplane", None)
            return {k: v for k, v in batch.items() if v is not None}
        for _attempt in range(8):
            vidx = int(rng.integers(0, len(self.virtual_poses)))
            real_idx = vidx // 9
            # Temporal neighbor of the same physical camera (+-1..2 frames).
            offs = int(rng.choice([-2, -1, 1, 2])) * self.cam_num
            ref_idx = int(np.clip(real_idx + offs, 0, self.n_examples - 1))
            if self.disp_images is None:
                return None
            ref_depth = self.disp_images[ref_idx]
            k_ref = np.linalg.inv(self.pixtocams[ref_idx])
            src_pose = self.virtual_poses[vidx]
            ref_pose = self.camtoworlds[ref_idx]
            # The warp math runs in OpenCV convention (z forward).
            pts_src, mask = warping.warp_image(
                ref_pose @ warping.GL_TO_CV, src_pose @ warping.GL_TO_CV,
                ref_depth, k_ref)
            valid_y, valid_x = np.nonzero(mask)
            if len(valid_y) < max(1, n // 5):
                continue
            sel = rng.integers(0, len(valid_y), n)
            ry, rx = valid_y[sel], valid_x[sel]
            # Source (virtual) pixel coordinates, rounded to ints.
            sx = np.clip(np.round(pts_src[ry, rx, 0]).astype(np.int64), 0,
                         self.width - 1)
            sy = np.clip(np.round(pts_src[ry, rx, 1]).astype(np.int64), 0,
                         self.height - 1)
            scal = lambda v: np.full((n, 1), v, np.float32)
            pixels = dict(
                pix_x_int=sx, pix_y_int=sy,
                lossmult=scal(1.0), near=scal(self.near), far=scal(self.far),
                cam_idx=np.full((n, 1), 0, np.int64),
            )
            vcams = (self.virtual_pixtocams[vidx][None],
                     self.virtual_poses[vidx][None], self.distortion_params,
                     None)
            batch = camlib.cast_ray_batch(vcams, pixels, self.camtype)
            batch["cam_dirs"] = np.broadcast_to(
                -src_pose[:3, 2], (n, 3)).astype(np.float32)
            batch["rgb"] = self.images[ref_idx, ry, rx].astype(np.float32)
            if self.sky_segments is not None:
                batch["sky_segs"] = self.sky_segments[ref_idx, ry, rx].astype(
                    np.float32)
            else:
                batch["sky_segs"] = np.zeros((n,), np.float32)
            # Supervision latent: the REF view's color correction applies.
            batch["cam_idx"] = np.full((n,), ref_idx, np.int32)
            batch["phys_cam_idx"] = np.full(
                (n,), (vidx // 9) % self.cam_num, np.int32)
            batch.pop("imageplane", None)
            return {k: v for k, v in batch.items() if v is not None}
        return None

    def image_batch(self, idx: int) -> Dict[str, np.ndarray]:
        """All rays of image `idx` as an [H, W, ...] batch for eval renders."""
        x, y = np.meshgrid(np.arange(self.width), np.arange(self.height))
        cam_idx = np.full(x.size, idx, np.int64)
        flat = self._rays_from_pixels(cam_idx, x.reshape(-1), y.reshape(-1))
        return {k: v.reshape((self.height, self.width) + v.shape[1:])
                for k, v in flat.items()}


def _lookat_cam_to_world(position, target, up=(0.0, 1.0, 0.0)):
    """OpenGL camera-to-world (x right, y up, z backward)."""
    position = np.asarray(position, np.float64)
    forward = np.asarray(target, np.float64) - position
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = position
    return c2w.astype(np.float32)


def synthetic_scene_color_and_depth(origins, directions):
    """Analytic scene: checker ground plane (y=-1), matte sphere (r=0.8 at
    origin), direction-keyed sky.  Returns (rgb [...,3], depth [...],
    sky_mask [...])."""
    o = np.asarray(origins, np.float64)
    d = np.asarray(directions, np.float64)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)

    inf = 1e9
    # Sphere |o + t d| = r.
    b = 2 * np.sum(o * dn, axis=-1)
    c = np.sum(o * o, axis=-1) - 0.8**2
    disc = b * b - 4 * c
    t_sph = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2, inf)
    t_sph = np.where(t_sph > 1e-3, t_sph, inf)
    # Ground plane y = -1.
    t_pl = np.where(np.abs(dn[..., 1]) > 1e-6,
                    (-1.0 - o[..., 1]) / dn[..., 1], inf)
    t_pl = np.where(t_pl > 1e-3, t_pl, inf)

    t = np.minimum(t_sph, t_pl)
    hit = t < inf
    p = o + dn * t[..., None]

    # Colors.  Dense multi-frequency patterns give the scene enough texture
    # for feature detection / matching / MVS to work on synthetic data.
    def blobs(u, v):
        return (0.5 * np.sin(5.3 * u) * np.sin(4.1 * v)
                + 0.3 * np.sin(9.7 * u + 1.3) * np.sin(7.9 * v + 0.7)
                + 0.2 * np.sin(14.3 * u + 2.1) * np.sin(17.1 * v + 1.9))

    stripes = 0.2 * blobs(p[..., 0] * 3, p[..., 1] * 3)
    sphere_rgb = np.clip(0.5 + 0.5 * (p / 0.8) + stripes[..., None], 0, 1)
    checker = ((np.floor(p[..., 0]) + np.floor(p[..., 2])) % 2)
    tex = blobs(p[..., 0], p[..., 2])
    plane_rgb = np.stack([
        0.2 + 0.4 * checker + 0.25 * tex,
        0.3 + 0.25 * tex,
        0.7 - 0.4 * checker - 0.25 * tex,
    ], axis=-1)
    sky_rgb = np.stack([
        0.4 + 0.3 * dn[..., 0], 0.5 + 0.3 * dn[..., 1],
        0.7 + 0.2 * dn[..., 2]], axis=-1)

    rgb = np.where((t_sph < t_pl)[..., None], sphere_rgb, plane_rgb)
    rgb = np.where(hit[..., None], rgb, sky_rgb)
    depth = np.where(hit, t, 0.0)
    return (np.clip(rgb, 0, 1).astype(np.float32),
            depth.astype(np.float32), (~hit).astype(np.float32))


class SyntheticDataset(RayDataset):
    """Procedural multi-view-consistent scene for tests and benchmarks."""

    def _load_renderings(self, config: Config):
        n_views = max(int(config.training_views), 2)
        h = getattr(config, "synthetic_height", 64)
        w = getattr(config, "synthetic_width", 96)
        rng = np.random.default_rng(42)

        focal = 0.9 * w
        k = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]],
                     np.float32)
        poses = []
        for i in range(n_views + max(n_views // 7, 1)):
            ang = 2 * np.pi * i / (n_views + 1)
            pos = np.array([3.0 * np.sin(ang), 0.6, 3.0 * np.cos(ang)])
            poses.append(_lookat_cam_to_world(pos, (0.0, 0.0, 0.0)))
        poses = np.stack(poses)

        # Train/test split mirrors llffhold-style holdout.
        idx = np.arange(len(poses))
        test_mask = idx % config.llffhold == 0
        sel = ~test_mask if self.split == DataSplit.TRAIN else test_mask
        poses = poses[sel][:n_views if self.split == DataSplit.TRAIN else None]

        images, depths, skies = [], [], []
        x, y = np.meshgrid(np.arange(w), np.arange(h))
        pixtocam = np.linalg.inv(k)
        for c2w in poses:
            origins, directions, _, _, _ = camlib.pixels_to_rays(
                x, y, pixtocam[None], c2w[None, :3, :])
            rgb, t_eucl, sky = synthetic_scene_color_and_depth(
                origins, directions)
            # Store z-depth along the camera forward axis (what MVS depth
            # maps hold and what the warp expects), not Euclidean distance.
            dn = directions / np.linalg.norm(directions, axis=-1,
                                             keepdims=True)
            forward = -c2w[:3, 2]
            z_depth = t_eucl * (dn @ forward)
            images.append(rgb)
            depths.append(np.where(t_eucl > 0, z_depth, 0.0).astype(
                np.float32))
            skies.append(sky)

        self.images = np.stack(images)
        self.disp_images = np.stack(depths)
        self.sky_segments = np.stack(skies)
        self.camtoworlds = poses
        self.pixtocams = np.tile(pixtocam[None], (len(poses), 1, 1)).astype(
            np.float32)
        self.cam_num = 1
        if config.virtual_poses and self.split == DataSplit.TRAIN:
            vposes, vk = warping.generate_virtual_poses(
                poses, np.tile(k[None], (len(poses), 1, 1)), rng)
            self.virtual_poses = vposes
            self.virtual_pixtocams = np.array(
                [np.linalg.inv(kk) for kk in vk], np.float32)


class WaymoV2Dataset(RayDataset):
    """The Waymo-100613-style loader (datasets.py:881-1140).

    On-disk contract (identical to the reference):
      data_dir/images/cam_{1,2,3}/%08d.jpg     RGB frames
      data_dir/masks/cam_{i}/%08d.npz          semantic masks (class 10 = sky)
      data_dir/scenario.pt                     pickled dict with observers'
                                               per-frame intr + c2w
      depth_dir/%08dcam_{i}.npy                MVS metric depth
      refine_name (pose.json)                  refined world-to-cam poses
    """

    NUM_FRAMES = 80
    SKY_CLASS = 10

    def _load_renderings(self, config: Config):
        from PIL import Image

        # Native sensor size.  DELIBERATE DEVIATION: the reference's WaymoV2
        # loader hardcodes width=1920/height=1280 and never applies
        # Config.factor (nerf/internal/datasets.py:896-917; the waymo.gin
        # factor=4 is dead for that loader), so the reference trains Waymo at
        # native resolution.  We honor ``factor`` as a documented knob (small
        # fixtures in tests, memory-bounded runs); ``factor=1`` reproduces the
        # reference's resolution exactly and is the default of the ``waymo``
        # presets (configs.waymo).
        native_w, native_h = getattr(self, "_size_override", (1920, 1280))
        factor = max(int(config.factor), 1)
        self.width, self.height = native_w // factor, native_h // factor
        cam_map = {1: ["cam_1"], 2: ["cam_2"], 3: ["cam_3"],
                   6: ["cam_1", "cam_2", "cam_3"],
                   7: ["cam_1", "cam_2", "cam_3", "cam_4", "cam_5"]}
        sensor_type = cam_map[config.cam_type]
        self.cam_num = len(sensor_type)

        scene_info_path = os.path.join(config.data_dir, "scenario.pt")
        with open(scene_info_path, "rb") as f:
            scenario = pickle.load(f)
        cam_order = {"camera_FRONT": 0, "camera_FRONT_LEFT": 1,
                     "camera_FRONT_RIGHT": 2, "camera_SIDE_LEFT": 3,
                     "camera_SIDE_RIGHT": 4}
        intr_per_cam = [None] * 5
        c2w_per_cam = [None] * 5
        for oid, odict in scenario["observers"].items():
            if odict.get("class_name") == "Camera":
                intr_per_cam[cam_order[oid]] = np.asarray(
                    odict["data"]["intr"])
                c2w_per_cam[cam_order[oid]] = np.asarray(odict["data"]["c2w"])

        poses_json = None
        if config.refine_name:
            with open(config.refine_name) as jp:
                poses_json = json.load(jp)

        images, depths, poses, segs, intrinsics = [], [], [], [], []
        names = []
        rng = np.random.default_rng(0)
        virtual_poses, virtual_k = [], []
        for idx in range(self.NUM_FRAMES):
            for cam_idx, cam in enumerate(sensor_type):
                names.append(f"{cam}/{idx:08d}.jpg")
                rgb_path = os.path.join(config.data_dir, "images", cam,
                                        f"{idx:08d}.jpg")
                img = Image.open(rgb_path)
                img = img.resize((self.width, self.height), Image.BILINEAR)
                images.append(np.asarray(img, np.float32) / 255.0)

                # scenario.pt intrinsics are calibrated for the NATIVE sensor
                # resolution; rescale by target/native (the reference's
                # factor handling, datasets.py:262-276) regardless of the
                # stored jpg dimensions.
                intr = np.array(intr_per_cam[cam_idx][idx], np.float64).copy()
                intr[0, :] *= self.width / native_w
                intr[1, :] *= self.height / native_h
                intrinsics.append(intr)

                if poses_json is None:
                    c2w = np.array(c2w_per_cam[cam_idx][idx], np.float64)
                else:
                    # pose.json holds world-to-cam as quaternion (x,y,z,w) +
                    # translation, keyed 'cam_i/%08d' (datasets.py:971-981).
                    attrs = poses_json[f"{cam}/{idx:08d}"]
                    w2c = np.eye(4)
                    w2c[:3, :3] = camlib.quat_xyzw_to_rotmat(
                        [attrs["q_x"], attrs["q_y"], attrs["q_z"],
                         attrs["q_w"]])
                    w2c[:3, 3] = [attrs["p_x"], attrs["p_y"], attrs["p_z"]]
                    c2w = np.linalg.inv(w2c)
                poses.append(c2w)

                if config.depth_dir:
                    dpath = os.path.join(config.depth_dir,
                                         f"{idx:08d}{cam}.npy")
                    depth = np.load(dpath).astype(np.float32).squeeze()
                    depth[depth <= 0.5] = 0.0
                    depths.append(depth)

                if config.load_sky_segments:
                    spath = os.path.join(config.data_dir, "masks", cam,
                                         f"{idx:08d}.npz")
                    seg = np.load(spath)["arr_0"].astype(np.float32).squeeze()
                    segs.append((seg == self.SKY_CLASS).astype(np.float32))

        poses = np.asarray(poses)
        intrinsics = np.asarray(intrinsics)

        # Normalize: center translations, unit mean radius; depths share the
        # scale (datasets.py:1094-1098).
        center = poses[:, :3, 3].mean(axis=0)
        poses[:, :3, 3] -= center
        scale = 1.0 / np.mean(np.linalg.norm(poses[:, :3, 3], axis=-1))
        poses[:, :3, 3] *= scale

        if config.virtual_poses:
            vposes, vk = warping.generate_virtual_poses(poses, intrinsics,
                                                        rng)
            virtual_poses, virtual_k = vposes, vk

        # Every 8th frame group is test (datasets.py:1104-1111).
        ncams = len(sensor_type)
        all_idx = np.arange(len(images))
        test_sel = all_idx % (8 * ncams) < ncams
        sel = ~test_sel if self.split == DataSplit.TRAIN else test_sel

        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        poses = poses @ flip  # OpenCV -> OpenGL.

        self.images = np.stack(images)[sel]
        self.camtoworlds = poses[sel].astype(np.float32)
        self.image_names = [n for n, s in zip(names, sel) if s]
        self.pixtocams = np.array(
            [np.linalg.inv(k) for k in intrinsics[sel]], np.float32)
        if depths:
            d = np.stack(depths) * scale
            self.disp_images = d[sel]
        if segs:
            self.sky_segments = np.stack(segs)[sel]
        if config.virtual_poses and self.split == DataSplit.TRAIN:
            vsel = np.repeat(sel, 9)
            self.virtual_poses = (np.asarray(virtual_poses) @ flip)[
                vsel].astype(np.float32)
            self.virtual_pixtocams = np.array(
                [np.linalg.inv(k) for k in np.asarray(virtual_k)[vsel]],
                np.float32)


class NuScenesDataset(WaymoV2Dataset):
    """NuScenes loader over a preprocessed Waymo-style directory.

    The reference's NuScenes path (datasets.py:596-878) requires the nuscenes
    devkit and is non-functional as shipped (datasets.py:606-610 constructs a
    set of lists, a TypeError).  This loader keeps the reference's camera
    naming, geometry (1600x900, sky class 142, 120 frames, up to 6 cameras)
    and split semantics over the same preprocessed on-disk contract as the
    Waymo loader — extract frames from the devkit once, then train from disk.
    """

    NUM_FRAMES = 120
    SKY_CLASS = 142

    def __init__(self, split, config):
        self._size_override = (1600, 900)  # NuScenes frame size
        super().__init__(split, config)


_LOADERS = {
    "synthetic": SyntheticDataset,
    "waymov2": WaymoV2Dataset,
    "nuscenes": NuScenesDataset,
}


def load_dataset(split, config: Config) -> RayDataset:
    split = DataSplit(split) if not isinstance(split, DataSplit) else split
    return _LOADERS[config.dataset_loader](split, config)

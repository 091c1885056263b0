"""Render-path generation: interpolated camera trajectories
(a copy of ``ucnerf_tpu/data/paths.py``, which is numpy and scipy).

The JAX package's equivalent of the reference's path machinery
(``camera_utils.py:133-350``): the Waymo render path re-uses one physical
camera's trajectory (reference render.py / datasets.py:1130-1140 subsample
``poses[::cam_num]``); this module adds smooth interpolation between those
keyframes (linear positions + quaternion slerp on rotations) to hit an
arbitrary frame count.
"""

from __future__ import annotations

import numpy as np


def _rotmat_to_quat(m):
    """3x3 rotation -> quaternion [x, y, z, w]."""
    t = np.trace(m)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                         (m[1, 0] - m[0, 1]) * s, 0.25 / s])
    i = np.argmax([m[0, 0], m[1, 1], m[2, 2]])
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def _quat_to_rotmat(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0, q1, t):
    d = np.clip(np.dot(q0, q1), -1, 1)
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(d)
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(
        theta)


def interpolate_poses(keyframes, num_frames):
    """Smoothly interpolate [K, 4, 4] keyframe poses to [num_frames, 4, 4]."""
    keyframes = np.asarray(keyframes, np.float64)
    k = len(keyframes)
    if k == 1:
        return np.tile(keyframes, (num_frames, 1, 1)).astype(np.float32)
    quats = [_rotmat_to_quat(p[:3, :3]) for p in keyframes]
    out = []
    for f in range(num_frames):
        u = f * (k - 1) / max(num_frames - 1, 1)
        i = min(int(u), k - 2)
        t = u - i
        pose = np.eye(4)
        pose[:3, :3] = _quat_to_rotmat(_slerp(quats[i], quats[i + 1], t))
        pose[:3, 3] = ((1 - t) * keyframes[i][:3, 3]
                       + t * keyframes[i + 1][:3, 3])
        out.append(pose)
    return np.asarray(out, np.float32)


def render_path_from_dataset(dataset, num_frames, cam_stride=None):
    """Build a render path from one physical camera's trajectory.

    Mirrors the reference's Waymo path (poses[::cam_num], datasets.py:1130),
    then interpolates to `num_frames`.
    """
    stride = cam_stride or dataset.cam_num
    keyframes = dataset.camtoworlds[::stride]
    return interpolate_poses(keyframes, num_frames)


# ---------------------------------------------------------------------------
# Reference-parity path generators (camera_utils.py:133-350): forward-facing
# spiral, orbiting ellipse, and B-spline keyframe interpolation.  All are
# host-side numpy — path generation is a one-off per render job, never on the
# device hot path.
# ---------------------------------------------------------------------------


def _normalize(v):
    return v / np.linalg.norm(v)


def viewmatrix(lookdir, up, position):
    """[3, 4] camera-to-world with +z = normalized lookdir (camera_utils.py:104)."""
    z = _normalize(lookdir)
    x = _normalize(np.cross(up, z))
    y = _normalize(np.cross(z, x))
    return np.stack([x, y, z, position], axis=1)


def average_pose(poses):
    """Mean-position/z/up lookat pose of [N, 3, 4] poses (camera_utils.py:95)."""
    return viewmatrix(poses[:, :3, 2].mean(0), poses[:, :3, 1].mean(0),
                      poses[:, :3, 3].mean(0))


def focus_point(poses):
    """Least-squares nearest point to all camera focal axes (camera_utils.py:118)."""
    d = poses[:, :3, 2:3]
    m = np.eye(3) - d @ np.transpose(d, (0, 2, 1))
    mtm = np.transpose(m, (0, 2, 1)) @ m
    return np.linalg.solve(mtm.mean(0), (mtm @ poses[:, :3, 3:4]).mean(0))[:, 0]


def generate_spiral_path(poses, bounds, n_frames=120, n_rots=2, zrate=0.5):
    """Forward-facing spiral around the average pose (camera_utils.py:133-158).

    poses: [N, 3, 4] cam-to-world; bounds: per-view (near, far) array.  The
    focus depth is the reference's disparity-space blend of stretched
    near/far bounds; radii are the 90th percentile of |positions|.
    """
    near, far = bounds.min() * 0.9, bounds.max() * 5.0
    focal = 1.0 / ((1.0 - 0.75) / near + 0.75 / far)
    radii = np.concatenate(
        [np.percentile(np.abs(poses[:, :3, 3]), 90, axis=0), [1.0]])
    cam2world = average_pose(poses)
    up = poses[:, :3, 1].mean(0)
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames,
                             endpoint=False):
        t = radii * np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
        position = cam2world @ t
        lookat = cam2world @ np.array([0, 0, -focal, 1.0])
        out.append(viewmatrix(position - lookat, up, position))
    return np.stack(out).astype(np.float32)


def _invert_cdf_np(u, t, w):
    """Deterministic inverse-CDF: sample t at quantiles u of step weights w."""
    w = w / np.maximum(w.sum(), np.finfo(np.float32).eps)
    cw = np.concatenate([[0.0], np.minimum(1.0, np.cumsum(w))])
    cw[-1] = 1.0
    return np.interp(u, cw, t)


def generate_ellipse_path(poses, n_frames=120, const_speed=True,
                          z_variation=0.0, z_phase=0.0):
    """Elliptical orbit about the scene focus point (camera_utils.py:200-244).

    The xy ellipse spans the 90th-percentile spread of camera positions
    around the focus point; optional z variation follows the 10th-90th
    percentile height band.  With const_speed, thetas are resampled by
    inverse-CDF over segment lengths so frame speed is near-constant
    (reference uses stepfun.sample_np on log-lengths; softmax of log-lengths
    is length-proportional weighting, reproduced here directly).
    """
    center = focus_point(poses)
    offset = np.array([center[0], center[1], 0.0])
    sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
    low, high = -sc + offset, sc + offset
    z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

    def positions_at(theta):
        return np.stack([
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation * (z_low[2] + (z_high - z_low)[2] *
                           (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ], axis=-1)

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
    positions = positions_at(theta)
    if const_speed:
        lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
        u = np.linspace(0, 1.0 - np.finfo(np.float32).eps, n_frames + 1)
        theta = _invert_cdf_np(u, theta, lengths)
        positions = positions_at(theta)
    positions = positions[:-1]

    avg_up = _normalize(poses[:, :3, 1].mean(0))
    ind = int(np.argmax(np.abs(avg_up)))
    up = np.eye(3)[ind] * np.sign(avg_up[ind])
    return np.stack([viewmatrix(p - center, up, p)
                     for p in positions]).astype(np.float32)


def generate_interpolated_path(poses, n_interp, spline_degree=5,
                               smoothness=0.03, rot_weight=0.1):
    """Smooth B-spline through keyframe poses (camera_utils.py:247-291).

    Each pose becomes a (position, lookat-point, up-point) triple; the
    triples are splined jointly (scipy splprep) and converted back, which
    interpolates rotation implicitly with `rot_weight` distance scaling.
    Returns [n_interp * (K - 1), 3, 4].
    """
    import scipy.interpolate

    poses = np.asarray(poses, np.float64)
    pos = poses[:, :3, 3]
    points = np.stack([pos,
                       pos - rot_weight * poses[:, :3, 2],
                       pos + rot_weight * poses[:, :3, 1]], axis=1)
    k = min(spline_degree, points.shape[0] - 1)
    tck, _ = scipy.interpolate.splprep(points.reshape(len(points), -1).T,
                                       k=k, s=smoothness)
    u = np.linspace(0, 1, n_interp * (points.shape[0] - 1), endpoint=False)
    new_points = np.array(scipy.interpolate.splev(u, tck)).T.reshape(
        -1, 3, 3)
    return np.stack([
        viewmatrix(p - l, u_ - p, p) for p, l, u_ in new_points
    ]).astype(np.float32)


def interpolate_1d(x, n_interp, spline_degree=5, smoothness=20.0):
    """Spline-smooth a 1-D signal to n_interp * (len-1) samples
    (camera_utils.py:294-300; used for per-frame exposure)."""
    import scipy.interpolate

    t = np.linspace(0, 1, len(x), endpoint=True)
    tck = scipy.interpolate.splrep(t, x, s=smoothness,
                                   k=min(spline_degree, len(x) - 1))
    u = np.linspace(0, 1, n_interp * (len(x) - 1), endpoint=False)
    return scipy.interpolate.splev(u, tck)


def create_render_spline_path(keyframe_names, image_names, poses,
                              exposures=None, n_interp=30, spline_degree=5,
                              smoothness=0.03):
    """Spline path through dataset poses selected by image name
    (camera_utils.py:303-350).

    keyframe_names: iterable of image names, a directory of images, or a
    text file listing names (one per line).  Returns (spline_indices,
    render_poses, render_exposures-or-None).
    """
    import os
    if isinstance(keyframe_names, str):
        if os.path.isdir(keyframe_names):
            keyframe_names = sorted(os.listdir(keyframe_names))
        else:
            with open(keyframe_names) as fp:
                keyframe_names = fp.read().splitlines()
    keyset = set(keyframe_names)
    spline_indices = np.array(
        [i for i, n in enumerate(image_names) if n in keyset])
    if len(spline_indices) < 2:
        raise ValueError(
            f"need >= 2 keyframes matching dataset images, got "
            f"{len(spline_indices)}")
    render_poses = generate_interpolated_path(
        poses[spline_indices], n_interp=n_interp,
        spline_degree=spline_degree, smoothness=smoothness, rot_weight=0.1)
    render_exposures = None
    if exposures is not None:
        log_exp = np.log(np.asarray(exposures)[spline_indices])
        render_exposures = np.exp(
            interpolate_1d(log_exp, n_interp, spline_degree=5,
                           smoothness=20.0))
    return spline_indices, render_poses, render_exposures


def generate_render_path(path_type, dataset, config):
    """Dispatch on --path-type: keyframe (Waymo default) | spiral | ellipse
    | spline."""
    poses = np.asarray(dataset.camtoworlds)[:, :3, :4]
    n = config.render_path_frames
    if path_type == "keyframe":
        return render_path_from_dataset(dataset, n)
    if path_type == "spiral":
        bounds = np.array([config.near, config.far], np.float32)
        return generate_spiral_path(poses, bounds, n_frames=n)
    if path_type == "ellipse":
        return generate_ellipse_path(
            poses, n_frames=n, z_variation=config.render_path_z_variation,
            z_phase=config.render_path_z_phase)
    if path_type == "spline":
        names = getattr(dataset, "image_names", None)
        if config.render_spline_keyframes_file and names:
            n_interp = max(1, n // max(config.render_spline_keyframes, 1))
            _, render_poses, _ = create_render_spline_path(
                config.render_spline_keyframes_file, names, poses,
                n_interp=n_interp,
                spline_degree=config.render_spline_degree,
                smoothness=config.render_spline_smoothness)
            return render_poses
        stride = max(1, len(poses) // max(config.render_spline_keyframes, 2))
        keyframes = poses[::stride]
        n_interp = max(1, n // max(len(keyframes) - 1, 1))
        return generate_interpolated_path(
            keyframes, n_interp=n_interp,
            spline_degree=config.render_spline_degree,
            smoothness=config.render_spline_smoothness)
    raise ValueError(f"unknown path type {path_type!r}")

"""Spatiotemporally-constrained multi-camera pose refinement (STPR)
(port of ``ucnerf_tpu/pose/pipeline.py``).

End-to-end port of the reference pipeline
(``pose_refinement/stpr/scripts/mvs/all_cams_sfm.py:53-94``):

  1. keypoints + descriptors on every image (SuperPoint in the reference;
     weights-free Harris/patch fallback here — features.py),
  2. exhaustive cross-camera x temporal matching with geometric
     verification (prepare_all_data_for_mvs.py:140-220),
  3. track building + multi-view triangulation with fixed initial poses
     (colmap point_triangulator, exe/sfm.cc:339),
  4. rig bundle adjustment with the UC-NeRF ``fix_trans_refine_rot`` option
     (native C++ LM solver, see rigba/),
  5. metric scale restoration from odometry path length
     (pose_scale_correct.py:20-74),
  6. ``pose.json`` export keyed ``cam_i/%08d`` with world-to-cam quaternions
     (all_cams_sfm.py:90-92, consumed by nerf/internal/datasets.py:971-981).

Stages 1 and 2 run on ``device`` (the detector and the matcher); the rest is
numpy and the native rig BA on the host, copied from the JAX package.  The
result also carries ``stats``: the seconds of each stage and the counts.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np

from ucnerf_tpu_torch.data.paths import _quat_to_rotmat, _rotmat_to_quat
from ucnerf_tpu_torch.pose import features, matching, rigba


def _rotmat_to_quat_wxyz(m):
    q = _rotmat_to_quat(m)  # [x, y, z, w]
    return np.array([q[3], q[0], q[1], q[2]])


def _quat_wxyz_to_rotmat(q):
    return _quat_to_rotmat(np.array([q[1], q[2], q[3], q[0]]))


def decompose_rig(w2c, num_frames, num_cams, ref_cam=0):
    """Initial rig decomposition from per-image world-to-cam poses.

    rig_s = w2c of the ref camera at snapshot s; rel_c = mean over snapshots
    of w2c_{s,c} @ inv(rig_s) (COLMAP ComputeCameraRigPoses,
    bundle_adjustment.cc:1129-1160).
    """
    w2c = np.asarray(w2c, np.float64).reshape(num_frames, num_cams, 4, 4)
    rig = w2c[:, ref_cam]
    rel = np.zeros((num_cams, 4, 4))
    for c in range(num_cams):
        quats = []
        trans = []
        for s in range(num_frames):
            m = w2c[s, c] @ np.linalg.inv(rig[s])
            quats.append(_rotmat_to_quat_wxyz(m[:3, :3]))
            trans.append(m[:3, 3])
        quats = np.asarray(quats)
        # Align hemispheres, then normalized mean (adequate for the small
        # spreads of a rigid rig).
        quats = np.where((quats @ quats[0])[:, None] < 0, -quats, quats)
        qm = quats.mean(0)
        qm /= np.linalg.norm(qm)
        rel[c] = np.eye(4)
        rel[c][:3, :3] = _quat_wxyz_to_rotmat(qm)
        rel[c][:3, 3] = np.mean(trans, 0)
    return rig, rel


def refine_poses(images_gray, w2c_init, intrinsics, num_frames, num_cams,
                 *, max_keypoints=1024, match_ratio=0.8, epipolar_px=4.0,
                 tri_max_error=4.0, ba_iterations=40, huber_px=4.0,
                 fix_trans_refine_rot=True, detector=None,
                 superpoint_path=None, verbose=False, device="cuda"):
    """Run the full STPR refinement.

    Args:
      images_gray: [N, H, W] float grayscale images, N = frames * cams,
        frame-major ordering (frame 0 cams 0..C-1, frame 1 ...).
      w2c_init: [N, 4, 4] initial world-to-cam (OpenCV convention).
      intrinsics: [N, 3, 3].
      detector: optional callable(gray) -> (kps [K,2], descs [K,D]);
        defaults to the Harris/patch detector on `device`.
      superpoint_path: optional path to the npz written by
        tools/convert_superpoint_weights.py — uses the learned SuperPoint
        detector (the reference's default, SuperPointDetectors.py:14-64),
        its network on `device`.
      device: where the detector and the matcher compute.

    Returns:
      dict with refined w2c [N, 4, 4], points [P, 3], cost, scale,
      num_points, and stats: ``seconds`` of each stage (detect, match,
      verify, tracks, triangulate, ba, scale) and the counts of keypoints,
      matched and verified pairs, matches, tracks and observations.
    """
    n = len(images_gray)
    if n != num_frames * num_cams:
        raise ValueError(f"{n} images for {num_frames} frames x {num_cams} "
                         f"cameras")
    if detector is None and superpoint_path is not None:
        net = features.load_superpoint_params(superpoint_path, device)
        detector = lambda g: features.superpoint_detect_and_describe(
            net, g, max_keypoints=max_keypoints)
    detector = detector or (
        lambda g: features.detect_and_describe(g, max_keypoints, device))
    seconds = {}
    clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        now = time.perf_counter()
        seconds[stage] = now - clock
        clock = now

    # 1. Features.
    kps, descs = [], []
    for img in images_gray:
        k, d = detector(img)
        kps.append(np.asarray(k))
        descs.append(np.asarray(d))
    lap("detect")
    if verbose:
        print(f"stpr: {sum(len(k) for k in kps)} keypoints over {n} images")

    # 2. Exhaustive spatiotemporal matching (all pairs — this is what couples
    # cameras across space AND time, prepare_all_data_for_mvs.py:172-220),
    # then each pair's geometric verification, in (i, j) order.
    raw = matching.exhaustive_match(descs, ratio=match_ratio, device=device)
    lap("match")
    ks = [np.linalg.inv(np.linalg.inv(k)) for k in intrinsics]  # ensure np
    all_matches = {}
    for (i, j), m in raw.items():
        m = matching.epipolar_filter(kps[i], kps[j], m, ks[i], ks[j],
                                     w2c_init[i], w2c_init[j],
                                     threshold=epipolar_px)
        if len(m) >= 8:
            all_matches[(i, j)] = m
    lap("verify")
    if verbose:
        print(f"stpr: {len(all_matches)} verified pairs, "
              f"{sum(len(m) for m in all_matches.values())} matches")

    # 3. Tracks.
    tracks = matching.build_tracks(all_matches, min_track_len=2)
    if verbose:
        print(f"stpr: {len(tracks)} tracks")

    obs_s, obs_c, obs_p, obs_xy = [], [], [], []
    for p_idx, track in enumerate(tracks):
        for img_idx, kp_idx in track:
            obs_s.append(img_idx // num_cams)
            obs_c.append(img_idx % num_cams)
            obs_p.append(p_idx)
            obs_xy.append(kps[img_idx][kp_idx].astype(np.float64) + 0.5)
    obs_s = np.asarray(obs_s, np.int32)
    obs_c = np.asarray(obs_c, np.int32)
    obs_p = np.asarray(obs_p, np.int32)
    obs_xy = np.asarray(obs_xy, np.float64).reshape(-1, 2)
    lap("tracks")

    # 4. Rig decomposition + triangulation with fixed poses.
    rig, rel = decompose_rig(w2c_init, num_frames, num_cams)
    rig_q = np.stack([_rotmat_to_quat_wxyz(m[:3, :3]) for m in rig])
    rig_t = rig[:, :3, 3].copy()
    rel_q = np.stack([_rotmat_to_quat_wxyz(m[:3, :3]) for m in rel])
    rel_t = rel[:, :3, 3].copy()
    intr4 = np.stack([[intrinsics[c][0, 0], intrinsics[c][1, 1],
                       intrinsics[c][0, 2], intrinsics[c][1, 2]]
                      for c in range(num_cams)])

    pts, valid = rigba.triangulate(len(tracks), obs_s, obs_c, obs_p, obs_xy,
                                   rig_q, rig_t, rel_q, rel_t, intr4,
                                   max_error=tri_max_error)
    keep = valid[obs_p]
    remap = -np.ones(len(tracks), np.int32)
    remap[valid] = np.arange(valid.sum())
    obs_s, obs_c = obs_s[keep], obs_c[keep]
    obs_p = remap[obs_p[keep]]
    obs_xy = obs_xy[keep]
    pts = pts[valid]
    lap("triangulate")
    stats = dict(seconds=seconds, keypoints=sum(len(k) for k in kps),
                 matched_pairs=len(raw), verified_pairs=len(all_matches),
                 matches=sum(len(m) for m in all_matches.values()),
                 tracks=len(tracks), observations=len(obs_xy))
    if verbose:
        print(f"stpr: {len(pts)} triangulated points, {len(obs_xy)} obs")
    if len(pts) == 0:
        return dict(w2c=np.asarray(w2c_init), points=pts, cost=np.inf,
                    num_points=0, stats=stats)

    # 5. Rig bundle adjustment (UC-NeRF mode: relative translations fixed,
    # relative rotations refined; bundle_adjustment.cc:1055-1061).
    rig_q, rig_t, rel_q, rel_t, pts, cost = rigba.solve(
        rig_q, rig_t, rel_q, rel_t, pts, intr4, obs_s, obs_c, obs_p, obs_xy,
        fix_rel_trans=fix_trans_refine_rot, fix_rel_rot=False,
        ref_camera=0, max_iterations=ba_iterations, huber_delta=huber_px,
        verbose=verbose)
    lap("ba")

    # 6. Metric scale: ratio of odometry path length to refined path length
    # over the ref-camera trajectory (pose_scale_correct.py:55-62).
    def path_len(ts_, qs_):
        centers = np.stack([
            -_quat_wxyz_to_rotmat(q).T @ t for q, t in zip(qs_, ts_)])
        return np.linalg.norm(np.diff(centers, axis=0), axis=1).sum(), centers

    rig0_q = np.stack([_rotmat_to_quat_wxyz(m[:3, :3]) for m in rig])
    ref_len, _ = path_len(rig[:, :3, 3], rig0_q)
    new_len, _ = path_len(rig_t, rig_q)
    scale = ref_len / max(new_len, 1e-12)
    rig_t *= scale
    pts *= scale

    # Recompose per-image world-to-cam.
    w2c_out = np.zeros((n, 4, 4))
    for s in range(num_frames):
        rig_m = np.eye(4)
        rig_m[:3, :3] = _quat_wxyz_to_rotmat(rig_q[s])
        rig_m[:3, 3] = rig_t[s]
        for c in range(num_cams):
            rel_m = np.eye(4)
            rel_m[:3, :3] = _quat_wxyz_to_rotmat(rel_q[c])
            rel_m[:3, 3] = rel_t[c]
            w2c_out[s * num_cams + c] = rel_m @ rig_m
    lap("scale")
    return dict(w2c=w2c_out, points=pts, cost=cost, scale=scale,
                num_points=len(pts), stats=stats)


def write_pose_json(path, w2c, num_frames, num_cams,
                    cam_names: Optional[List[str]] = None):
    """Write pose.json in the reference's schema: ``{"cam_i/%08d": {q_x, q_y,
    q_z, q_w, p_x, p_y, p_z}}`` with world-to-cam quaternions in scipy xyzw
    order (consumed by datasets.py:971-981)."""
    cam_names = cam_names or [f"cam_{c+1}" for c in range(num_cams)]
    out = {}
    for s in range(num_frames):
        for c in range(num_cams):
            m = np.asarray(w2c[s * num_cams + c])
            q = _rotmat_to_quat_wxyz(m[:3, :3])  # w, x, y, z
            out[f"{cam_names[c]}/{s:08d}"] = {
                "q_x": float(q[1]), "q_y": float(q[2]), "q_z": float(q[3]),
                "q_w": float(q[0]),
                "p_x": float(m[0, 3]), "p_y": float(m[1, 3]),
                "p_z": float(m[2, 3]),
            }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    return out

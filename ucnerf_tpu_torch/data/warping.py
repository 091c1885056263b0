"""Virtual-view synthesis: pose perturbations + depth-guided image warping
(a copy of ``ucnerf_tpu/data/warping.py``'s numpy functions, with
``warp_image_jax`` as ``warp_image_torch``).

UC-NeRF's virtual warping supervision (reference
``train_utils.py:19-98`` and ``datasets.py:983-1063``): each real camera gets
9 perturbed virtual poses (vertical shifts, up/down/left/right rotations,
stereo left/right shifts, forward/backward shifts); depth-guided warping maps
ref-view pixels into a virtual (src) view to build pixel correspondences, and
20%% of each training batch are virtual rays supervised by the warped real
pixels.

``warp_image`` is the host-side numpy version used by the data loader's
rejection sampling; ``warp_image_torch`` is its twin on tensors, intended for
device-side correspondence precomputation.
"""

from __future__ import annotations

import numpy as np

# Right-multiplying an OpenGL camera-to-world (x right, y up, z backward) by
# this flips it to OpenCV (x right, y down, z forward) and vice versa.  The
# warp math below assumes OpenCV poses and z-depth along +z_cv.
GL_TO_CV = np.diag([1.0, -1.0, -1.0, 1.0])


def generate_virtual_poses(poses, intrinsics, rng: np.random.Generator):
    """9 perturbed virtual cameras per real camera (datasets.py:983-1063).

    Args:
      poses: [M, 4, 4] camera-to-world (convention-agnostic: perturbations
        act in camera-local axes).
      intrinsics: [M, 3, 3].
      rng: numpy Generator for the random perturbation magnitudes.

    Returns:
      (virtual_poses [9M, 4, 4], virtual_intrinsics [9M, 3, 3]).
    """
    out_poses, out_k = [], []

    def translate(pose, vec):
        t = np.eye(4, dtype=np.float64)
        t[:3, 3] = vec
        return pose @ t

    def rot_x(pose, deg):
        r = np.radians(deg)
        m = np.array([[1, 0, 0],
                      [0, np.cos(r), -np.sin(r)],
                      [0, np.sin(r), np.cos(r)]])
        p = pose.copy()
        p[:3, :3] = p[:3, :3] @ m
        return p

    def rot_y(pose, deg):
        r = np.radians(deg)
        m = np.array([[np.cos(r), 0, -np.sin(r)],
                      [0, 1, 0],
                      [np.sin(r), 0, np.cos(r)]])
        p = pose.copy()
        p[:3, :3] = p[:3, :3] @ m
        return p

    for pose, k in zip(np.asarray(poses, np.float64), intrinsics):
        u = lambda lo, hi: float(rng.uniform(lo, hi))
        perturbed = [
            translate(pose, [0, u(0.25, 0.75), 0]),      # shift up
            translate(pose, [0, -u(0.25, 0.75), 0]),     # shift down
            rot_x(pose, -u(0, 20)),                      # rotate down
            rot_y(pose, -u(10, 30)),                     # rotate right
            rot_y(pose, u(10, 30)),                      # rotate left
            translate(pose, [u(0.3, 0.6), 0, 0]),        # stereo right
            translate(pose, [-u(0.3, 0.6), 0, 0]),       # stereo left
            translate(pose, [0, 0, u(0.1, 0.6)]),        # forward
            translate(pose, [0, 0, -u(0.1, 0.6)]),       # backward
        ]
        out_poses.extend(perturbed)
        out_k.extend([np.array(k, np.float64)] * 9)
    return np.asarray(out_poses), np.asarray(out_k)


def warp_image(ref_pose, src_pose, ref_depth, intrinsic):
    """Project ref-view pixels (with depth) into the src view.

    Numpy port of the reference's depth warp (train_utils.py:19-55):
    unproject ref pixels with their depth, transform by
    inv(src_pose) @ ref_pose, reproject with the shared intrinsics.

    Args:
      ref_pose/src_pose: [4, 4] camera-to-world.
      ref_depth: [H, W] metric depth in the ref view (0 = invalid).
      intrinsic: [3, 3].

    Returns:
      pts_in_src: [H, W, 2] pixel coordinates in the src view.
      mask: [H, W] bool, valid (depth > 0 and inside the src image).
    """
    ref_depth = np.asarray(ref_depth, np.float32)
    ht, wd = ref_depth.shape
    fx, fy = intrinsic[0][0], intrinsic[1][1]
    cx, cy = intrinsic[0][2], intrinsic[1][2]

    y, x = np.meshgrid(np.arange(ht, dtype=np.float32),
                       np.arange(wd, dtype=np.float32), indexing="ij")
    pts_norm = np.stack([(x - cx) / fx, (y - cy) / fy, np.ones_like(x)],
                        axis=-1)
    pts_3d = pts_norm * ref_depth[..., None]

    rel = np.linalg.inv(src_pose) @ ref_pose
    pts_src = pts_3d.reshape(-1, 3) @ rel[:3, :3].T + rel[:3, 3]
    depth_src = pts_src[:, 2].reshape(ht, wd)
    pts_src = pts_src / np.where(
        np.abs(pts_src[:, 2:]) > 1e-9, pts_src[:, 2:], 1e-9)
    pix = pts_src @ np.asarray(intrinsic, np.float32).T
    pix = pix.reshape(ht, wd, 3)[..., :2]

    mask = (ref_depth > 0)
    mask &= (pix[..., 0] >= 0) & (pix[..., 0] < wd - 0.5)
    mask &= (pix[..., 1] >= 0) & (pix[..., 1] < ht - 0.5)
    mask &= depth_src > 0
    return pix.astype(np.float32), mask


def warp_depth(ref_pose, src_pose, ref_depth, intrinsic):
    """Forward-splat the ref depth into the src view (train_utils.py:58-98).

    Returns [H, W] depth in the src view (0 where nothing lands)."""
    pix, mask = warp_image(ref_pose, src_pose, ref_depth, intrinsic)
    ht, wd = ref_depth.shape
    # Recompute src-frame depth for the splat values.
    fx, fy = intrinsic[0][0], intrinsic[1][1]
    cx, cy = intrinsic[0][2], intrinsic[1][2]
    y, x = np.meshgrid(np.arange(ht, dtype=np.float32),
                       np.arange(wd, dtype=np.float32), indexing="ij")
    pts_norm = np.stack([(x - cx) / fx, (y - cy) / fy, np.ones_like(x)],
                        axis=-1)
    pts_3d = pts_norm * np.asarray(ref_depth, np.float32)[..., None]
    rel = np.linalg.inv(src_pose) @ ref_pose
    z_src = (pts_3d.reshape(-1, 3) @ rel[:3, :3].T + rel[:3, 3])[:, 2]
    z_src = z_src.reshape(ht, wd)

    depth_out = np.zeros_like(z_src)
    xy = np.round(pix[mask]).astype(np.int64)
    xy[:, 0] = np.clip(xy[:, 0], 0, wd - 1)
    xy[:, 1] = np.clip(xy[:, 1], 0, ht - 1)
    depth_out[xy[:, 1], xy[:, 0]] = z_src[mask]
    return depth_out


def precompute_correspondence_pool(dataset, rng, pool_per_pair=1024,
                                   max_pairs=None, neighbors_per_view=3):
    """Precompute a pool of (virtual-ray pixel, real supervision) pairs.

    The reference rejects-and-retries warps inside every batch
    (datasets.py:507-529), a host-side loop that stalls the training step.
    This builds the valid-correspondence tables once up front (SURVEY.md §7);
    sampling a batch then reduces to indexing the pool.

    Each virtual view is paired with `neighbors_per_view` DISTINCT temporal
    neighbors (sampled without replacement from the reference's +-{1,2}
    frame offsets, datasets.py:512-517) so the pool preserves most of the
    per-batch re-draw's supervision diversity instead of freezing one
    neighbor per virtual view.

    Returns a dict of flat arrays:
      src_cam_idx [N] (index into dataset.virtual_poses),
      src_px/src_py [N] (virtual-view pixel),
      ref_idx [N], ref_px/ref_py [N] (real view + pixel for supervision).
    """
    out = {k: [] for k in ("src_cam_idx", "src_px", "src_py", "ref_idx",
                           "ref_px", "ref_py")}
    n_virtual = len(dataset.virtual_poses)
    pairs = 0
    all_offsets = np.array([-2, -1, 1, 2])
    for vidx in range(n_virtual):
        real_idx = vidx // 9
        n_nb = min(neighbors_per_view, len(all_offsets))
        offsets = rng.choice(all_offsets, size=n_nb, replace=False)
        ref_seen = set()
        for offs in offsets:
            ref_idx = int(np.clip(real_idx + int(offs) * dataset.cam_num, 0,
                                  dataset.n_examples - 1))
            if ref_idx in ref_seen:  # clipping can collapse offsets
                continue
            ref_seen.add(ref_idx)
            k_ref = np.linalg.inv(dataset.pixtocams[ref_idx])
            pix, mask = warp_image(
                dataset.camtoworlds[ref_idx] @ GL_TO_CV,
                dataset.virtual_poses[vidx] @ GL_TO_CV,
                dataset.disp_images[ref_idx], k_ref)
            ys, xs = np.nonzero(mask)
            if len(ys) < 32:
                continue
            sel = rng.integers(0, len(ys), min(pool_per_pair, len(ys)))
            ry, rx = ys[sel], xs[sel]
            sx = np.clip(np.round(pix[ry, rx, 0]).astype(np.int32), 0,
                         dataset.width - 1)
            sy = np.clip(np.round(pix[ry, rx, 1]).astype(np.int32), 0,
                         dataset.height - 1)
            out["src_cam_idx"].append(np.full(len(sel), vidx, np.int32))
            out["src_px"].append(sx)
            out["src_py"].append(sy)
            out["ref_idx"].append(np.full(len(sel), ref_idx, np.int32))
            out["ref_px"].append(rx.astype(np.int32))
            out["ref_py"].append(ry.astype(np.int32))
            pairs += 1
            if max_pairs and pairs >= max_pairs:
                break
        if max_pairs and pairs >= max_pairs:
            break
    if pairs == 0:
        return None
    return {k: np.concatenate(v) for k, v in out.items()}


def warp_image_torch(ref_pose, src_pose, ref_depth, intrinsic):
    """Twin of warp_image on float32 tensors (all on one device), for
    device-side correspondence tables.  Returns (pix [H, W, 2], mask
    [H, W] bool)."""
    import torch

    ht, wd = ref_depth.shape
    fx, fy = intrinsic[0, 0], intrinsic[1, 1]
    cx, cy = intrinsic[0, 2], intrinsic[1, 2]
    y, x = torch.meshgrid(
        torch.arange(ht, dtype=torch.float32, device=ref_depth.device),
        torch.arange(wd, dtype=torch.float32, device=ref_depth.device),
        indexing="ij")
    pts_norm = torch.stack([(x - cx) / fx, (y - cy) / fy,
                            torch.ones_like(x)], dim=-1)
    pts_3d = pts_norm * ref_depth[..., None]
    rel = torch.linalg.inv(src_pose) @ ref_pose
    pts_src = pts_3d.reshape(-1, 3) @ rel[:3, :3].T + rel[:3, 3]
    depth_src = pts_src[:, 2].reshape(ht, wd)
    z = torch.where(pts_src[:, 2:].abs() > 1e-9, pts_src[:, 2:],
                    torch.full_like(pts_src[:, 2:], 1e-9))
    pix = (pts_src / z) @ intrinsic.T
    pix = pix.reshape(ht, wd, 3)[..., :2]
    mask = ((ref_depth > 0)
            & (pix[..., 0] >= 0) & (pix[..., 0] < wd - 0.5)
            & (pix[..., 1] >= 0) & (pix[..., 1] < ht - 0.5)
            & (depth_src > 0))
    return pix, mask

"""MVS pipelines: sequence loss, per-view post-processing, multires and
geometric fusion (port of ``ucnerf_tpu/models/mvs/pipelines.py``).

Functional parity with the reference pipelines:
- ``sequence_loss`` (``mvs/loss.py:5-41``): gamma-decayed L1 blend of
  disparity and clipped depth errors over GRU iterations.
- ``postprocess_disp`` (``mvs/inference.py:52-58``): disp<0 -> 1e6,
  depth>50 -> 0.
- ``multires_fusion`` (``mvs/multires.py:16-40``): keep the 1x prediction
  where it agrees with the 0.5x prediction within 2%, else fall back.
- ``adaptive_geometric_fusion`` (``mvs/fusion.py:39-342``): cross-view
  reprojection consistency masking (D2HC-RMVSNet style), on the tensors'
  device.

``resize`` is ``jax.image.resize`` for its "bilinear" and "nearest" methods:
the bilinear resize is a product with one weight matrix per resized axis
(the triangle kernel, widened by the inverse scale when downsampling, as
JAX's antialiasing does), which gives JAX's weights by construction and a
backward that adds in a fixed order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _resize_weights(m: int, n: int) -> torch.Tensor:
    """JAX's [m, n] weights for resizing an axis of m samples to n
    (``jax._src.image.scale.compute_weight_mat``, triangle kernel,
    antialias on), in f32 as JAX computes them."""
    inv_scale = 1.0 / (n / m)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(m, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    weights = torch.clamp(1 - x.abs(), min=0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _nearest_indices(m: int, n: int) -> torch.Tensor:
    """JAX's nearest source index of each of n outputs from m inputs."""
    offsets = (torch.arange(n, dtype=torch.float32) + 0.5) * m / n
    return torch.floor(offsets).long()


def resize(x: torch.Tensor, shape, method: str = "bilinear") -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` for "bilinear" (antialiased)
    and "nearest"; every axis whose size differs is resized."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match {x.shape}")
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m == n:
            continue
        if method == "nearest":
            x = x.index_select(d, _nearest_indices(m, n).to(x.device))
        elif method == "bilinear":
            wmat = _resize_weights(m, n).to(device=x.device, dtype=x.dtype)
            x = torch.movedim(torch.movedim(x, d, -1) @ wmat, -1, d)
        else:
            raise NotImplementedError(method)
    return x


def bilinear_resize(img, shape):
    """Bilinear resize [H, W] -> shape."""
    return resize(img, tuple(shape), "bilinear")


def sequence_loss(disp_est: Sequence[torch.Tensor], disp_gt,
                  gradual_weight=0.5, gamma=0.9, depthloss_threshold=100.0,
                  depth_cut=1e-3):
    """Gamma-decayed sequence loss over GRU iterations (loss.py:5-41).

    disp_est: list of [h, w] per-iteration estimates (feature res).
    disp_gt: [H, W] ground-truth inverse depth (0 = invalid).
    """
    n = len(disp_est)
    ht, wd = disp_gt.shape
    valid = (disp_gt > 0).to(disp_gt.dtype)
    gt_depth = 1.0 / torch.clamp(disp_gt, min=depth_cut)
    total = 0.0
    for i, est in enumerate(disp_est):
        est = bilinear_resize(est, (ht, wd))
        w_i = gamma ** (n - i - 1)
        loss_disp = (est - disp_gt).abs()
        loss_depth = (1.0 / torch.clamp(est, min=depth_cut) - gt_depth).abs()
        loss_depth = torch.clamp(loss_depth, max=depthloss_threshold) / 3.6e5
        i_loss = (gradual_weight * loss_depth
                  + (1 - gradual_weight) * loss_disp)
        total = total + w_i * (valid * i_loss).mean()
        total = total + 0.01 * w_i * i_loss.mean()

    est_last = bilinear_resize(disp_est[-1].detach(), (ht, wd))
    epe = (1.0 / torch.clamp(est_last, min=depth_cut) - gt_depth).abs()
    denom = torch.clamp(valid.sum(), min=1.0)
    metrics = {
        "mean_depth_error": (epe * valid).sum() / denom,
        "less3": ((epe < 3) * valid).sum() / denom,
        "less10": ((epe < 10) * valid).sum() / denom,
        "less25": ((epe < 25) * valid).sum() / denom,
    }
    return total, metrics


def postprocess_disp(disp, max_depth=50.0):
    """Reference post-processing (inference.py:52-58): negative disparities
    become far (1e6), depths beyond max_depth become invalid (0)."""
    disp = torch.where(disp < 0, 1e6, disp)
    depth = torch.where(disp == 0, 0.0, 1.0 / disp)
    return torch.where(depth > max_depth, 0.0, depth)


def multires_fusion(depth_half, depth_full, th=0.02):
    """Cross-resolution consistency (multires.py:16-40): keep the full-res
    depth where |half - full| < th * half, else use the half-res depth."""
    depth_half = np.asarray(depth_half)
    depth_full = np.asarray(depth_full)
    if depth_half.shape != depth_full.shape:
        depth_half = resize(torch.from_numpy(depth_half), depth_full.shape,
                            "bilinear").numpy()
    mask = np.abs(depth_half - depth_full) < th * depth_half
    return np.where(mask, depth_full, depth_half)


def _pixel_grid(h, w, device):
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")


def _corner(v, size):
    """floor(v) clipped to [0, size - 1] as an index (a NaN reads 0)."""
    return torch.nan_to_num(torch.floor(v)).clamp(0, size - 1).long()


def reproject(depth_ref, pose_ref, pose_src, k_ref, k_src, depth_src):
    """Project ref pixels into src, sample src depth, project back.

    Returns (reprojected depth in ref frame, roundtrip pixel coords in ref).
    Used by geometric consistency (fusion.py:109-220 semantics).
    """
    h, w = depth_ref.shape
    y, x = _pixel_grid(h, w, depth_ref.device)
    k_ref_inv = torch.linalg.inv(k_ref)
    rel = pose_src @ torch.linalg.inv(pose_ref)  # world2cam convention

    pts = torch.stack([x, y, torch.ones_like(x)], 0).reshape(3, -1)
    cam_ref = k_ref_inv @ pts * depth_ref.reshape(1, -1)
    cam_src = rel[:3, :3] @ cam_ref + rel[:3, 3:]
    z_src = cam_src[2]
    pix_src = k_src @ (cam_src / torch.where(z_src.abs() > 1e-9, z_src, 1e-9))
    xs = pix_src[0].reshape(h, w)
    ys = pix_src[1].reshape(h, w)

    # Sample the src depth at those coords (bilinear, zeros outside — the
    # reference's bilinear_sampler, fusion.py:66-67).
    x0 = _corner(xs, w)
    y0 = _corner(ys, h)
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = (xs - x0).clamp(0.0, 1.0)
    fy = (ys - y0).clamp(0.0, 1.0)
    d_src = ((1 - fy) * ((1 - fx) * depth_src[y0, x0]
                         + fx * depth_src[y0, x1])
             + fy * ((1 - fx) * depth_src[y1, x0]
                     + fx * depth_src[y1, x1]))
    inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    d_src = torch.where(inb, d_src, 0.0)

    # Back-project the src sample into ref.
    rel_inv = pose_ref @ torch.linalg.inv(pose_src)
    cam_src2 = torch.linalg.inv(k_src) @ pix_src * d_src.reshape(1, -1)
    cam_ref2 = rel_inv[:3, :3] @ cam_src2 + rel_inv[:3, 3:]
    z_ref2 = cam_ref2[2].reshape(h, w)
    pix_ref2 = k_ref @ (cam_ref2 / torch.where(
        cam_ref2[2].abs() > 1e-9, cam_ref2[2], 1e-9))
    x2 = pix_ref2[0].reshape(h, w)
    y2 = pix_ref2[1].reshape(h, w)
    return z_ref2, (x2, y2)


def geometric_consistency_mask(depth_ref, pose_ref, k_ref, src_views,
                               pix_th=1.0, depth_th=0.01, min_views=2):
    """Mask ref depths consistent across enough source views
    (fusion.py:109-240 semantics with fixed thresholds).

    src_views: list of (depth_src, pose_src, k_src).
    Returns (mask [H, W], fused depth = mean of consistent reprojections).
    """
    h, w = depth_ref.shape
    y, x = _pixel_grid(h, w, depth_ref.device)
    count = torch.zeros((h, w), device=depth_ref.device)
    depth_sum = depth_ref
    for depth_src, pose_src, k_src in src_views:
        z2, (x2, y2) = reproject(depth_ref, pose_ref, pose_src, k_ref, k_src,
                                 depth_src)
        dist = torch.sqrt((x2 - x) ** 2 + (y2 - y) ** 2)
        rel_err = (z2 - depth_ref).abs() / torch.clamp(depth_ref, min=1e-9)
        ok = (dist < pix_th) & (rel_err < depth_th) & (depth_ref > 0) & (
            z2 > 0)
        count = count + ok
        depth_sum = depth_sum + torch.where(ok, z2, 0.0)
    mask = (count >= min_views) & (depth_ref > 0)
    fused = torch.where(mask, depth_sum / (count + 1), 0.0)
    return mask, fused


def dynamic_consistency_masks(depth_ref, pose_ref, k_ref, src_views, thre):
    """D2HC-RMVSNet dynamic consistency check (fusion.py:85-105, 229-260).

    For each source view and each strictness level i in [2, 10], a pixel is
    i-consistent when its roundtrip reprojection error is below
    (i / (10^thre * 4)) pixels AND its relative depth error is below
    (i / (10^thre * 1300)).  A pixel survives when, for some i < n (n = 1 +
    num sources), at least i sources agree at level i — a permissive
    threshold must be corroborated by more views.

    Returns (mask [H, W] bool, fused depth [H, W]) where fused depth is the
    mean of the ref depth and the strictest-level-consistent reprojections
    (fusion.py:260: (sum reproj + ref) / (count + 1)).
    """
    thre1 = 10.0**thre * 4.0
    thre2 = 10.0**thre * 1300.0
    h, w = depth_ref.shape
    dev = depth_ref.device
    y, x = _pixel_grid(h, w, dev)
    n = 1 + len(src_views)

    level_sums = [torch.zeros((h, w), dtype=torch.int32, device=dev)
                  for _ in range(2, 11)]
    strict_sum = torch.zeros((h, w), dtype=torch.int32, device=dev)
    reproj_sum = torch.zeros((h, w), device=dev)
    for depth_src, pose_src, k_src in src_views:
        z2, (x2, y2) = reproject(depth_ref, pose_ref, pose_src, k_ref, k_src,
                                 depth_src)
        dist = torch.sqrt((x2 - x) ** 2 + (y2 - y) ** 2)
        rel_err = (z2 - depth_ref).abs() / torch.clamp(depth_ref, min=1e-9)
        strict = None
        for i in range(2, 11):
            ok = (dist < i / thre1) & (rel_err < i / thre2)
            level_sums[i - 2] = level_sums[i - 2] + ok.int()
            strict = ok  # i == 10 survives the loop (fusion.py:100-103)
        strict_sum = strict_sum + strict.int()
        # The reference zeroes reprojections by the LAST (i=10) per-src mask
        # before accumulating (fusion.py:103).
        reproj_sum = reproj_sum + torch.where(strict, z2, 0.0)

    # geo_mask_sum >= n is unsatisfiable (n = n_src + 1 > n_src); kept for
    # parity with fusion.py:256 — the dynamic OR below does the real work.
    mask = strict_sum >= n
    for i in range(2, n):
        mask = mask | (level_sums[i - 2] >= i)
    mask = mask & (depth_ref > 0)
    fused = (reproj_sum + depth_ref) / (strict_sum.to(depth_ref.dtype) + 1.0)
    return mask, fused


def adaptive_geometric_fusion(depths, poses, intrinsics, pairs, glb=0.25,
                              tot_iter=10, log_fn=None):
    """Adaptive-threshold geometric fusion (fusion.py:109-342).

    Bisects the log10 threshold over [-2, 2] for `tot_iter` rounds so the
    mean surviving-pixel fraction approaches `glb` (default 0.25,
    fusion.py:115), then returns the final masks and fused depths.

    Args:
      depths: [N, H, W] per-view depth maps (world-to-cam convention poses).
      poses: [N, 4, 4] world-to-cam extrinsics.
      intrinsics: [N, 3, 3].
      pairs: list of (ref_idx, [src_idx, ...]) view adjacency.
      glb: target mean mask fraction.

    Arrays are taken as f32 tensors; the masks and reprojections run on the
    device of `depths` where it is a tensor, else on the CPU.

    Returns:
      dict ref_idx -> (mask [H, W] bool numpy, fused_depth [H, W] numpy,
      threshold) for the final iteration.
    """
    depths = torch.as_tensor(depths, dtype=torch.float32)
    poses = torch.as_tensor(poses, dtype=torch.float32, device=depths.device)
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                 device=depths.device)

    thre_left, thre_right = -2.0, 2.0
    results = {}
    for it in range(tot_iter):
        thre = (thre_left + thre_right) / 2
        fracs = []
        results = {}
        for ref, srcs in pairs:
            src_views = [(depths[s], poses[s], intrinsics[s]) for s in srcs]
            mask, fused = dynamic_consistency_masks(
                depths[ref], poses[ref], intrinsics[ref], src_views, thre)
            fracs.append(float(mask.float().mean()))
            results[ref] = (mask, fused, thre)
        mean_frac = float(np.mean(fracs))
        if log_fn is not None:
            log_fn(f"fusion iter {it}: thre=10^{thre:.3f} "
                   f"mask_frac={mean_frac:.3f}")
        # More pixels surviving than the budget -> tighten (higher thre
        # divides the tolerances down); fusion.py:303-306.
        if mean_frac >= glb:
            thre_left = thre
        else:
            thre_right = thre
    return {ref: (mask.cpu().numpy(), fused.cpu().numpy(), thre)
            for ref, (mask, fused, thre) in results.items()}


def fused_point_cloud(results, images, poses, intrinsics):
    """Unproject masked fused depths to a colored world-space point cloud
    (fusion.py:285-297).

    Args:
      results: dict ref_idx -> (mask, fused_depth, thre) from
        adaptive_geometric_fusion.
      images: [N, H, W, 3] float in [0, 1].
      poses: [N, 4, 4] world-to-cam.
      intrinsics: [N, 3, 3].

    Returns:
      (xyz [M, 3] float32, rgb [M, 3] float32 in [0, 1]).
    """
    xyzs, rgbs = [], []
    for ref, (mask, fused, _) in sorted(results.items()):
        yy, xx = np.nonzero(mask)
        if len(yy) == 0:
            continue
        d = fused[yy, xx]
        pix = np.stack([xx, yy, np.ones_like(xx)], 0).astype(np.float64)
        cam = np.linalg.inv(np.asarray(intrinsics[ref])) @ (pix * d)
        cam_h = np.concatenate([cam, np.ones_like(cam[:1])], 0)
        world = (np.linalg.inv(np.asarray(poses[ref])) @ cam_h)[:3]
        xyzs.append(world.T.astype(np.float32))
        rgbs.append(np.asarray(images[ref])[yy, xx].astype(np.float32))
    if not xyzs:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    return np.concatenate(xyzs), np.concatenate(rgbs)

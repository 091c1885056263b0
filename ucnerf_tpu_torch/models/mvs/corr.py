"""Plane-sweep correlation volume for CER-MVS (port of
``ucnerf_tpu/models/mvs/corr.py``).

The reference samples its volume with a CUDA kernel
(``mvs/alt_cuda_corr/correlation_kernel.cu`` driven by
``mvs/core/corr.py:45-158``); the JAX package, and this port, express the
per-pixel, per-hypothesis dot product between reference features and
bilinearly sampled source features as gathers and a reduction over the
feature axis, with the JAX package's arithmetic:
  1. ``projective_transform``: plane-sweep warp of the ref pixel grid at D
     inverse-depth hypotheses into each source view.
  2. ``build_corr_volume``: bilinear-sample source features there and dot
     with ref features -> [num, H, W, D] per-view cost volumes (/ 64, as the
     reference divides both maps by 8), a few hypotheses at a time.
  3. ``corr_pyramid``: average pooling over D (corr.py:95-99).
  4. ``lookup``: per-pixel radius-r linear sampling along D around the
     current disparity (corr.py:102-147).

Every gather is ``take_rows`` on a flattened tensor, whose backward adds
in a fixed order on either device, so a training step repeats bit for
bit.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

# Elements of the sampled [d, H, W, C] source features held at once while a
# volume is built (128 MiB of f32): at 480x320 features of 64 channels that
# is 3 hypotheses a pass; at training crops all of them.
CORR_CHUNK_ELEMS = 1 << 25


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.src_shape = src.shape
        return src[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.src_shape)
        if grad.is_cuda:
            out.index_put_((idx,), grad, accumulate=True)
        else:
            out.index_add_(0, idx.reshape(-1),
                           grad.reshape((-1,) + tuple(ctx.src_shape[1:])))
        return out, None


def take_rows(src, idx):
    """``src[idx]`` (rows of `src` at the int64 indices `idx`, any shape)
    with a backward that adds each row's updates in a fixed order: on the
    card ``index_put_`` with accumulation, which sorts the indices first; on
    the CPU ``index_add_``, a serial loop.  Autograd's own backward of
    indexing is ``index_put_`` on both, and on the CPU that adds with atomics
    across threads; ``torch.gather``'s backward does so on the card."""
    return _TakeRows.apply(src, idx)


def _homogeneous(mat3):
    out = torch.zeros((4, 4), dtype=mat3.dtype, device=mat3.device)
    out[:3, :3] = mat3
    out[3, 3] = 1.0
    return out


def projective_transform(poses, intrinsics, disps, ref_idx, src_idx):
    """Warp ref-view pixels at given inverse depths into a source view.

    Args:
      poses: [V, 4, 4] world-to-cam (Ps[:, jj] @ Ps[:, ii]^-1 maps ref cam
        -> src cam).
      intrinsics: [V, 3, 3].
      disps: [D, H, W] inverse-depth hypotheses in the ref view.
      ref_idx/src_idx: ints.

    Returns:
      coords [D, H, W, 2] pixel coordinates in the src view.
    """
    k_src = _homogeneous(intrinsics[src_idx])
    k_ref_inv = _homogeneous(torch.linalg.inv(intrinsics[ref_idx]))
    pij = k_src @ poses[src_idx] @ torch.linalg.inv(poses[ref_idx]) @ k_ref_inv

    _, h, w = disps.shape
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=disps.device),
        torch.arange(w, dtype=torch.float32, device=disps.device),
        indexing="ij")
    # Homogeneous [x, y, 1, disp] (projective_ops.py:5-13).
    x1 = pij[0, 0] * x + pij[0, 1] * y + pij[0, 2] + pij[0, 3] * disps
    y1 = pij[1, 0] * x + pij[1, 1] * y + pij[1, 2] + pij[1, 3] * disps
    z1 = pij[2, 0] * x + pij[2, 1] * y + pij[2, 2] + pij[2, 3] * disps
    z1 = torch.where(z1.abs() > 1e-12, z1, 1e-12)
    coords = torch.stack([x1 / z1, y1 / z1], dim=-1)
    return coords.clamp(-1e4, 1e4)


def bilinear_sample_nhwc(img, coords):
    """Sample img [H, W, C] at coords [..., 2] (x, y), zero padding."""
    h, w, c = img.shape
    flat = img.reshape(h * w, c)
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.long()
    y0i = y0.long()

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        vals = take_rows(flat, idx)  # [..., C]
        return torch.where(valid[..., None], vals, 0.0)

    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    return v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11


def build_corr_volume(fmaps, poses, intrinsics, disps, src_indices,
                      ref_idx=0):
    """Per-source-view cost volumes.

    Args:
      fmaps: [V, H, W, C] feature maps (1/4 or 1/8 res).
      poses/intrinsics: [V, 4, 4] / [V, 3, 3] at feature resolution.
      disps: [D, H, W] inverse-depth hypotheses for the ref view.
      src_indices: list of source view ids.

    Returns:
      corr [num_src, H, W, D].
    """
    fref = fmaps[ref_idx] / 8.0  # [H, W, C]
    h, w, c = fref.shape
    step = max(1, CORR_CHUNK_ELEMS // (h * w * c))
    vols = []
    for j in src_indices:
        coords = projective_transform(poses, intrinsics, disps, ref_idx, j)
        fsrc = fmaps[j] / 8.0
        corr = [(bilinear_sample_nhwc(fsrc, coords[d:d + step]) * fref).sum(-1)
                for d in range(0, coords.shape[0], step)]  # [d, H, W] each
        vols.append(torch.cat(corr, 0).permute(1, 2, 0))  # [H, W, D]
    return torch.stack(vols, 0)


def corr_pyramid(corr, num_levels=3) -> List[torch.Tensor]:
    """Average-pool the hypothesis axis into a pyramid (corr.py:95-99)."""
    pyr = [corr]
    for _ in range(num_levels - 1):
        d = corr.shape[-1] // 2
        corr = 0.5 * (corr[..., 0:2 * d:2] + corr[..., 1:2 * d:2])
        pyr.append(corr)
    return pyr


def _linear_sample_lastdim(vol, x):
    """Linearly sample vol [..., D] at positions x (broadcastable to
    [..., K]) -> [..., K].

    1-D twin of the reference's bilinear_sampler1 (y fixed at 0), zero
    padding outside [0, D-1]."""
    d = vol.shape[-1]
    flat = vol.reshape(-1)
    base = torch.arange(flat.numel() // d, device=vol.device).view(
        vol.shape[:-1] + (1,)) * d
    x0 = torch.floor(x)
    fx = x - x0
    x0i = x0.long()

    def tap(xi):
        valid = (xi >= 0) & (xi < d)
        vals = take_rows(flat, base + xi.clamp(0, d - 1))
        return torch.where(valid, vals, 0.0)

    return tap(x0i) * (1 - fx) + tap(x0i + 1) * fx


def lookup(pyramid: Sequence[torch.Tensor], disp, disps_origin, incre,
           n_incre, radius=5):
    """Sample the pyramid around the current disparity (corr.py:102-147).

    Args:
      pyramid: list of [num, H, W, D_l] volumes.
      disp: [H, W] current inverse-depth estimate.
      disps_origin: [H, W] center of the hypothesis slab.
      incre: hypothesis spacing.
      n_incre: number of hypotheses at level 0.
      radius: half window.

    Returns:
      features [num, H, W, num_levels * (2*radius+1)].
    """
    center = torch.clamp((disp - disps_origin) / incre + n_incre // 2,
                         min=0.0)
    dx = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=disp.device)
    outs = []
    for i, vol in enumerate(pyramid):
        x = center[None, :, :, None] / (2**i) + dx  # [1, H, W, K]
        outs.append(_linear_sample_lastdim(vol, x))
    return torch.cat(outs, dim=-1)

"""Image metrics: PSNR, SSIM, color transfer, sRGB (numpy, no deps; a copy
of ``ucnerf_tpu/utils/image.py``).

Functional parity with the reference
(its ``nerf/internal/image.py``): mse/psnr conversions, sRGB
curves (image.py:31-58), area downsample (image.py:61-69), the quadratic
affine color-correction used for "cc" eval metrics (image.py:71-111), and a
``MetricHarness`` (image.py:114-133).  The reference's skimage SSIM
(grayscale, 7x7 uniform-or-gaussian window) is re-implemented here with the
standard Wang et al. gaussian-window formulation.  LPIPS needs pretrained VGG
weights, which the repository does not hold: given a weights file, the
harness adds it (``utils/lpips.py``); without one it reports PSNR and SSIM.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

EPS = float(np.finfo(np.float32).eps)


def mse_to_psnr(mse):
    return -10.0 / np.log(10.0) * np.log(mse)


def psnr_to_mse(psnr):
    return np.exp(-0.1 * np.log(10.0) * psnr)


def ssim_to_dssim(ssim):
    return (1 - ssim) / 2


def dssim_to_ssim(dssim):
    return 1 - 2 * dssim


def linear_to_srgb(linear, eps=EPS):
    srgb0 = 323 / 25 * linear
    srgb1 = (211 * np.maximum(eps, linear) ** (5 / 12) - 11) / 200
    return np.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb, eps=EPS):
    linear0 = 25 / 323 * srgb
    linear1 = np.maximum(eps, (200 * srgb + 11) / 211) ** (12 / 5)
    return np.where(srgb <= 0.04045, linear0, linear1)


def downsample(img, factor):
    """Area downsample (factor must divide height and width)."""
    sh = img.shape
    if sh[0] % factor or sh[1] % factor:
        raise ValueError(f"factor {factor} does not divide {sh[:2]}")
    img = img.reshape((sh[0] // factor, factor, sh[1] // factor, factor)
                      + sh[2:])
    return img.mean(axis=(1, 3))


def color_correct(img, ref, num_iters=5, eps=0.5 / 255):
    """Fit a per-channel quadratic color warp of img onto ref
    (image.py:71-111), ignoring clipped pixels, iterating as the clipped set
    changes."""
    if img.shape[-1] != ref.shape[-1]:
        raise ValueError("channel mismatch")
    num_channels = img.shape[-1]
    img_mat = np.asarray(img, np.float64).reshape(-1, num_channels)
    ref_mat = np.asarray(ref, np.float64).reshape(-1, num_channels)
    is_unclipped = lambda z: (z >= eps) & (z <= 1 - eps)
    mask0 = is_unclipped(img_mat)
    for _ in range(num_iters):
        a_mat = []
        for c in range(num_channels):
            a_mat.append(img_mat[:, c:c + 1] * img_mat[:, c:])
        a_mat.append(img_mat)
        a_mat.append(np.ones_like(img_mat[:, :1]))
        a_mat = np.concatenate(a_mat, axis=-1)
        warp = []
        for c in range(num_channels):
            b = ref_mat[:, c]
            mask = mask0[:, c] & is_unclipped(img_mat[:, c]) & is_unclipped(b)
            ma = np.where(mask[:, None], a_mat, 0)
            mb = np.where(mask, b, 0)
            w = np.linalg.lstsq(ma, mb, rcond=-1)[0]
            assert np.all(np.isfinite(w))
            warp.append(w)
        warp = np.stack(warp, axis=-1)
        img_mat = np.clip(a_mat @ warp, 0, 1)
    return img_mat.reshape(img.shape)


def _gaussian_kernel1d(sigma=1.5, radius=5):
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2d_separable(img, k):
    """Valid-mode separable 2D filtering."""
    r = len(k) // 2
    # Horizontal then vertical, 'valid' boundary.
    out = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 1, img)
    out = np.apply_along_axis(
        lambda m: np.convolve(m, k, mode="valid"), 0, out)
    return out


def ssim(img0, img1, max_val=1.0, filter_sigma=1.5, filter_size=11, k1=0.01,
         k2=0.03):
    """SSIM with a gaussian window (Wang et al. 2004), grayscale or per-chan.

    Matches skimage's gaussian_weights=True formulation; the reference calls
    skimage on grayscale uint8 (image.py:122-127).
    """
    img0 = np.asarray(img0, np.float64)
    img1 = np.asarray(img1, np.float64)
    if img0.ndim == 3:
        return np.mean([ssim(img0[..., c], img1[..., c], max_val,
                             filter_sigma, filter_size, k1, k2)
                        for c in range(img0.shape[-1])])
    k = _gaussian_kernel1d(filter_sigma, filter_size // 2)
    mu0 = _filter2d_separable(img0, k)
    mu1 = _filter2d_separable(img1, k)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _filter2d_separable(img0 * img0, k) - mu00
    s11 = _filter2d_separable(img1 * img1, k) - mu11
    s01 = _filter2d_separable(img0 * img1, k) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = (((2 * mu01 + c1) * (2 * s01 + c2)) /
                ((mu00 + mu11 + c1) * (s00 + s11 + c2)))
    return float(ssim_map.mean())


def rgb_to_gray(rgb):
    """ITU-R 601 luma (what cv2.cvtColor RGB2GRAY uses)."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2])


class MetricHarness:
    """PSNR + SSIM (+ LPIPS when a VGG weights file is available)."""

    def __init__(self, lpips_weights: Optional[str] = None):
        self._lpips = None
        if lpips_weights is not None:
            from ucnerf_tpu_torch.utils import lpips as lpips_lib
            self._lpips = lpips_lib.LPIPS.from_file(lpips_weights)

    def __call__(self, rgb_pred, rgb_gt, name_fn=lambda s: s,
                 quantize=True):
        if quantize:
            # Evaluate on 8-bit images like the reference (image.py:117-118).
            rgb_pred = np.round(
                np.clip(rgb_pred, 0, 1) * 255).astype(np.uint8) / 255.0
            rgb_gt = np.round(
                np.clip(rgb_gt, 0, 1) * 255).astype(np.uint8) / 255.0
        mse = float(np.mean((rgb_pred - rgb_gt) ** 2))
        psnr = float(mse_to_psnr(max(mse, 1e-12)))
        s = ssim(rgb_to_gray(rgb_pred), rgb_to_gray(rgb_gt))
        out = {name_fn("psnr"): psnr, name_fn("ssim"): s}
        if self._lpips is not None:
            out[name_fn("lpips")] = self._lpips(rgb_pred, rgb_gt)
        return out

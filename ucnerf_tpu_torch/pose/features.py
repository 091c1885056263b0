"""Keypoint detection + description for the pose-refinement pipeline
(port of ``ucnerf_tpu/pose/features.py``).

Two interchangeable detectors, as in the JAX package:

- ``SuperPointNet``: the SuperPoint architecture (VGG encoder, 65-way
  detector head with pixel-shuffle decoding, 256-d descriptor head), usable
  when a weights file is supplied (``load_superpoint_params``; the npz of
  ``tools/convert_superpoint_weights.py`` crosses through ``convert``).
- ``harris_keypoints`` + ``patch_descriptors``: the weights-free classical
  detector (Harris corners + normalized-patch descriptors) that the pipeline
  uses by default.

Every function that computes takes ``device`` (default ``"cuda"``): the
tensors work there, and keypoints and descriptors come back as numpy.

The Harris response is the JAX package's sequence of shifted adds, term by
term in its order (no convolution, which would re-associate the sums), and
divides by tensors on the working device (the card turns a division by a
host scalar into a multiplication by its reciprocal): the card, the CPU and
the JAX package compute the same response map bit for bit, so no keypoint
moves across the top-k boundary.  The top-k is a stable descending sort,
which keeps XLA's tie order (equal responses, lowest index first).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ucnerf_tpu_torch import convert

# (name, kernel hw, cin, cout), tools/convert_superpoint_weights.py.
_LAYERS = (
    ("conv1a", 3, 1, 64), ("conv1b", 3, 64, 64),
    ("conv2a", 3, 64, 64), ("conv2b", 3, 64, 64),
    ("conv3a", 3, 64, 128), ("conv3b", 3, 128, 128),
    ("conv4a", 3, 128, 128), ("conv4b", 3, 128, 128),
    ("convPa", 3, 128, 256), ("convPb", 1, 256, 65),
    ("convDa", 3, 128, 256), ("convDb", 1, 256, 256),
)


class SuperPointNet(nn.Module):
    """SuperPoint (DeTone et al. 2018): shared VGG encoder, detector +
    descriptor heads.  Takes the JAX package's NHWC layout: grayscale
    [N, H, W, 1] in [0, 1]; returns semi [N, H/8, W/8, 65] and unit
    descriptors [N, H/8, W/8, 256].  Without trained weights its parameters
    are drawn from a CPU generator seeded with `seed` (He-normal kernels,
    zero biases)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        for name, k, cin, cout in _LAYERS:
            conv = nn.Conv2d(cin, cout, k, padding=k // 2)
            with torch.no_grad():
                conv.weight.normal_(0.0, math.sqrt(2.0 / (k * k * cin)),
                                    generator=gen)
                conv.bias.zero_()
            self.add_module(name, conv)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for block in ("1", "2", "3"):
            x = F.relu(getattr(self, f"conv{block}a")(x))
            x = F.relu(getattr(self, f"conv{block}b")(x))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.conv4a(x))
        x = F.relu(self.conv4b(x))
        # Detector head: 65 = 8x8 cells + dustbin.
        semi = self.convPb(F.relu(self.convPa(x)))
        desc = self.convDb(F.relu(self.convDa(x)))
        desc = desc / torch.clamp(torch.linalg.vector_norm(
            desc, dim=1, keepdim=True), min=1e-8)
        return semi.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def superpoint_scores(semi):
    """Decode the 65-channel cell logits [N, h, w, 65] into a full-res
    heatmap [N, 8h, 8w] (pixel-shuffle of the 64 non-dustbin channels)."""
    prob = torch.softmax(semi, dim=-1)[..., :64]
    n, h, w, _ = prob.shape
    prob = prob.reshape(n, h, w, 8, 8)
    return prob.permute(0, 1, 3, 2, 4).reshape(n, h * 8, w * 8)


def load_superpoint_params(path, device="cuda") -> SuperPointNet:
    """A ``SuperPointNet`` on `device` holding the weights of the npz
    written by tools/convert_superpoint_weights.py."""
    net = SuperPointNet()
    net.load_state_dict(convert.superpoint_params_from_npz(path), strict=True)
    return net.to(device).eval()


def _max_pool_same(x, radius):
    """Max over a (2r+1)^2 window, 'same' padding with -inf
    (superpoint.py:8-11)."""
    return F.max_pool2d(x[:, None], 2 * radius + 1, stride=1,
                        padding=radius)[:, 0]


def simple_nms(scores, nms_radius=4):
    """The reference's two-round suppression NMS (superpoint.py:5-21) on
    [N, H, W] scores: keep window maxima, zero everything else."""
    zeros = torch.zeros_like(scores)
    max_mask = scores == _max_pool_same(scores, nms_radius)
    for _ in range(2):
        supp_mask = _max_pool_same(max_mask.to(scores.dtype), nms_radius) > 0
        supp_scores = torch.where(supp_mask, zeros, scores)
        new_max_mask = supp_scores == _max_pool_same(supp_scores, nms_radius)
        max_mask = max_mask | (new_max_mask & ~supp_mask)
    return torch.where(max_mask, scores, zeros)


def _sample_descriptors(keypoints_xy, desc_coarse, s=8):
    """Bilinear-sample the coarse [h, w, C] descriptor map (numpy) at
    full-res keypoint (x, y) coords, L2-normalized (superpoint.py:35-46
    semantics, align_corners=True).  Numpy, as in the JAX package."""
    h, w, _ = desc_coarse.shape
    kp = np.asarray(keypoints_xy, np.float32) - s / 2 + 0.5
    gx = (kp[:, 0] / (w * s - s / 2 - 0.5)) * 2 - 1
    gy = (kp[:, 1] / (h * s - s / 2 - 0.5)) * 2 - 1
    # align_corners=True grid coords.
    fx = np.clip((gx + 1) / 2 * (w - 1), 0, w - 1)
    fy = np.clip((gy + 1) / 2 * (h - 1), 0, h - 1)
    x0 = np.clip(np.floor(fx).astype(np.int32), 0, w - 1)
    y0 = np.clip(np.floor(fy).astype(np.int32), 0, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    dm = np.asarray(desc_coarse)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    d = (dm[y0, x0] * (1 - wx) * (1 - wy) + dm[y0, x1] * wx * (1 - wy)
         + dm[y1, x0] * (1 - wx) * wy + dm[y1, x1] * wx * wy)
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    return (d / np.maximum(n, 1e-8)).astype(np.float32)


@torch.no_grad()
def superpoint_detect_and_describe(net, gray, max_keypoints=1024,
                                   nms_radius=4, keypoint_threshold=0.005,
                                   border=4):
    """SuperPoint keypoints + descriptors for one grayscale image [H, W] in
    [0, 1], with `net` (a ``SuperPointNet``) on the device it lies on.
    Returns ([K, 2] (x, y) int coords, [K, 256] unit descriptors),
    replicating the reference's decode path (superpoint.py:104-151): softmax
    heatmap, simple_nms, threshold, border removal, top-k, bilinear
    descriptor sampling.  The network and the NMS run on the device; the
    selection and sampling on the host, as in the JAX package."""
    device = next(net.parameters()).device
    gray = torch.as_tensor(np.asarray(gray, np.float32), device=device)
    h_full, w_full = gray.shape
    semi, desc = net(gray[None, :, :, None])
    scores = simple_nms(superpoint_scores(semi), nms_radius)[0]
    scores = scores[:h_full, :w_full].cpu().numpy()
    ys, xs = np.nonzero(scores > keypoint_threshold)
    vals = scores[ys, xs]
    keep = ((xs >= border) & (xs < w_full - border)
            & (ys >= border) & (ys < h_full - border))
    xs, ys, vals = xs[keep], ys[keep], vals[keep]
    if len(vals) > max_keypoints:
        order = np.argsort(-vals)[:max_keypoints]
        xs, ys = xs[order], ys[order]
    kps = np.stack([xs, ys], -1).astype(np.int32)
    descs = _sample_descriptors(kps, desc[0].cpu().numpy())
    return kps, descs


def _sobel(img):
    """Sobel gradients of [H, W] as the JAX package's nine shifted
    multiply-adds, zero taps included, in its order."""
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32) / 8
    ky = kx.T
    h, w = img.shape
    pad = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]

    def conv(k):
        out = torch.zeros_like(img)
        for dy in range(3):
            for dx in range(3):
                out = out + float(k[dy, dx]) * pad[dy:dy + h, dx:dx + w]
        return out
    return conv(kx), conv(ky)


def _box_blur(img, r=2):
    """Separable (2r+1) box mean with edge padding, rows then columns."""
    out = img
    size = torch.tensor(2.0 * r + 1, device=img.device)
    for axis in (0, 1):
        pads = (0, 0, r, r) if axis == 0 else (r, r, 0, 0)
        p = F.pad(out[None, None], pads, mode="replicate")[0, 0]
        acc = torch.zeros_like(out)
        for d in range(2 * r + 1):
            acc = acc + (p[d:d + out.shape[0]] if axis == 0
                         else p[:, d:d + out.shape[1]])
        out = acc / size
    return out


def harris_response(gray, k=0.04, device="cuda"):
    """Harris corner response of a grayscale image [H, W] (numpy or a
    tensor), as a float32 tensor on `device`."""
    gray = torch.as_tensor(np.asarray(gray, np.float32), device=device)
    ix, iy = _sobel(gray)
    sxx = _box_blur(ix * ix)
    syy = _box_blur(iy * iy)
    sxy = _box_blur(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def harris_keypoints(gray, max_keypoints=1024, nms_radius=3, border=8,
                     device="cuda"):
    """Top-K Harris corners with local-maximum NMS.  Returns [K, 2] (x, y)
    int32 numpy, strongest first."""
    resp = harris_response(gray, device=device)
    h, w = resp.shape
    # NMS: keep local maxima (>= every neighbour) over a (2r+1)^2 window.
    r = nms_radius
    p = F.pad(resp, (r, r, r, r), value=-math.inf)
    local_max = torch.ones_like(resp, dtype=torch.bool)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            if dy == r and dx == r:
                continue
            local_max &= resp >= p[dy:dy + h, dx:dx + w]
    resp = torch.where(local_max, resp, -math.inf)
    # Suppress borders.
    mask = torch.zeros((h, w), dtype=torch.bool, device=resp.device)
    mask[border:h - border, border:w - border] = True
    resp = torch.where(mask, resp, -math.inf)
    flat = resp.reshape(-1)
    k = min(max_keypoints, flat.shape[0])
    # jax.lax.top_k's order: descending, equal values lowest index first.
    scores, idx = torch.sort(flat, descending=True, stable=True)
    scores, idx = scores[:k], idx[:k]
    keep = scores > -math.inf
    kps = torch.stack([idx % w, idx // w], -1)[keep]
    return kps.cpu().numpy().astype(np.int32)


def _pairwise_sum(p):
    """Row sums of [K, n] in numpy's pairwise order for float32 (blocks of
    at most 128 summed by 8 strided accumulators, longer rows split in
    halves), so that a patch's mean is the bits numpy's ``mean`` gives."""
    n = p.shape[1]
    if n < 8:
        res = torch.zeros_like(p[:, 0])
        for i in range(n):
            res = res + p[:, i]
        return res
    if n <= 128:
        r = p[:, :8]
        for i in range(8, n - n % 8, 8):
            r = r + p[:, i:i + 8]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + (
            (r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for i in range(n - n % 8, n):
            res = res + p[:, i]
        return res
    half = n // 2
    half -= half % 8
    return _pairwise_sum(p[:, :half]) + _pairwise_sum(p[:, half:])


def patch_descriptors(gray, keypoints, patch=11, device="cuda"):
    """Normalized image patches as descriptors: [K, patch*patch] float32
    numpy, unit norm (zero for a flat patch).  One gather of every
    keypoint's patch from the edge-padded image, where the JAX package
    loops over keypoints in numpy.  The mean is numpy's, bit for bit: in a
    nearly flat patch the norm that follows amplifies its last bit."""
    gray = torch.as_tensor(np.asarray(gray, np.float32), device=device)
    r = patch // 2
    padded = F.pad(gray[None, None], (r, r, r, r), mode="replicate")[0, 0]
    kps = torch.as_tensor(np.asarray(keypoints, np.int64).reshape(-1, 2),
                          device=device)
    offs = torch.arange(patch, device=device)
    rows = kps[:, 1, None, None] + offs[None, :, None]
    cols = kps[:, 0, None, None] + offs[None, None, :]
    p = padded[rows, cols].reshape(len(kps), patch * patch)
    count = torch.tensor(float(patch * patch), device=device)
    p = p - (_pairwise_sum(p) / count)[:, None]
    n = torch.linalg.vector_norm(p, dim=1, keepdim=True)
    descs = torch.where(n > 1e-8, p / torch.where(n > 1e-8, n, 1.0), p)
    return descs.cpu().numpy()


def detect_and_describe(gray, max_keypoints=1024, device="cuda"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Weights-free detector+descriptor used by the default pipeline."""
    kps = harris_keypoints(gray, max_keypoints=max_keypoints, device=device)
    descs = patch_descriptors(gray, kps, device=device)
    return kps, descs

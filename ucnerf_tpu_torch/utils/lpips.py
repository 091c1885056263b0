"""LPIPS perceptual distance, VGG-16 variant (port of ``ucnerf_tpu/utils/lpips.py``).

The architecture of the reference's LPIPS (VGG-16 features at relu1_2 ..
relu5_3, unit-normalized channels, 1x1 linear heads, spatial mean) with
``F.conv2d`` and ``F.max_pool2d``.  The pretrained weights are not vendored;
they are read from the ``.npz`` that ``tools/convert_lpips_weights.py``
writes for the JAX package:

  vgg/conv{i}_{j}/kernel [kh, kw, cin, cout], .../bias [cout],
  lin{k}/kernel [1, 1, c_k, 1]  (k = 0..4)

The HWIO kernels become torch's OIHW on load.  The metric runs on the CPU,
beside the harness's other host metrics.  Without weights
``LPIPS.from_file`` returns None and the metric harness reports no LPIPS.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

_VGG_CFG = [  # (stage, convs, channels)
    (1, 2, 64), (2, 2, 128), (3, 3, 256), (4, 3, 512), (5, 3, 512)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class LPIPS:
    """Callable LPIPS(img0, img1) over [H, W, 3] float images in [0, 1]."""

    def __init__(self, weights: dict):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
        self.convs = []  # per stage: [(weight OIHW, bias)]
        for stage, convs, _ in _VGG_CFG:
            self.convs.append([
                (t(np.transpose(weights[f"vgg/conv{stage}_{j}/kernel"],
                                (3, 2, 0, 1))),
                 t(weights[f"vgg/conv{stage}_{j}/bias"]))
                for j in range(1, convs + 1)])
        self.lins = [t(np.reshape(weights[f"lin{k}/kernel"], -1))
                     for k in range(len(_VGG_CFG))]

    @classmethod
    def from_file(cls, path: str) -> Optional["LPIPS"]:
        try:
            data = np.load(path)
        except (OSError, ValueError):
            return None
        return cls({k: np.asarray(data[k]) for k in data.files})

    def _features(self, x):
        """x [1, 3, H, W] -> the five tapped activations."""
        feats = []
        h = x
        for stage, layers in enumerate(self.convs, start=1):
            for weight, bias in layers:
                h = torch.relu(F.conv2d(h, weight, bias, padding=1))
            feats.append(h)
            if stage < len(self.convs):
                h = F.max_pool2d(h, 2, 2)
        return feats

    @torch.no_grad()
    def __call__(self, img0, img1) -> float:
        def prep(im):
            x = torch.from_numpy(np.asarray(im, np.float32)) * 2 - 1
            x = (x - torch.from_numpy(_SHIFT)) / torch.from_numpy(_SCALE)
            return x.permute(2, 0, 1)[None]

        total = 0.0
        for a, b, lin in zip(self._features(prep(img0)),
                             self._features(prep(img1)), self.lins):
            a = a / torch.clamp(torch.linalg.vector_norm(
                a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(
                b, dim=1, keepdim=True), min=1e-10)
            d = torch.einsum("nchw,c->nhw", (a - b) ** 2, lin)
            total = total + d.mean()
        return float(total)

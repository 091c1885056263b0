"""CER-MVS: cascaded recurrent multi-view-stereo depth (port of
``ucnerf_tpu/models/mvs/raft.py``).

Functional parity with the reference ``RAFT`` (``mvs/core/raft.py:13-109``):
instance-norm feature encoder + no-norm context encoder at 1/4 ("HR") or 1/8
("LR") resolution, a 2-stage cascade of depth-hypothesis slabs ((64 hyp,
spacing 1/400/64, 8 iters), (auto=44 hyp, spacing 1/400/320, 8 iters)), each
stage building a plane-sweep correlation pyramid and running ConvGRU
refinement of the inverse-depth map.  Full f32, as the JAX package runs it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ucnerf_tpu_torch.models.mvs.corr import (build_corr_volume,
                                              corr_pyramid, lookup)
from ucnerf_tpu_torch.models.mvs.extractor import BasicEncoder, init_convs
from ucnerf_tpu_torch.models.mvs.update import UpdateBlock


class RAFTMVS(nn.Module):
    """Reference-view inverse-depth estimation from a temporal window.

    The parameters are drawn on the CPU from `seed` (``init_convs``)."""

    def __init__(self,
                 cascade: Tuple[Tuple[int, int, int], ...] = (
                     (64, 64, 8), (-1, 320, 8)),
                 encoder_type: str = "HR", dim_fmap: int = 64,
                 dim_net: int = 64, dim_inp: int = 64, num_levels: int = 3,
                 radius: int = 5, seed: int = 0):
        super().__init__()
        self.cascade = tuple(tuple(c) for c in cascade)
        self.encoder_type = encoder_type
        self.dim_net = dim_net
        self.num_levels = num_levels
        self.radius = radius
        self.fnet = BasicEncoder(output_dim=dim_fmap, norm_fn="instance",
                                 encoder_type=encoder_type)
        self.cnet = BasicEncoder(output_dim=dim_net + dim_inp,
                                 norm_fn="none", encoder_type=encoder_type)
        self.update_block = UpdateBlock(
            num_stages=len(self.cascade), dim_net=dim_net, dim_inp=dim_inp,
            num_levels=num_levels, radius=radius)
        init_convs(self, seed)

    def forward(self, images, poses, intrinsics, scale=None,
                return_predictions=False):
        """Estimate the ref view's inverse depth.

        Args:
          images: [V, H, W, 3] uint8-range floats; view 0 is the reference.
          poses: [V, 4, 4] world-to-cam.
          intrinsics: [V, 3, 3] at full image resolution.
          scale: optional scalar multiplying pose translations on entry and
            the output disparity on exit (raft.py:35,106-108).

        Returns:
          disp [h, w] inverse depth at feature resolution (1/4 or 1/8), and
          with ``return_predictions`` also the list of per-iteration
          estimates (unscaled, for the sequence loss).
        """
        if scale is not None:
            poses = poses.clone()
            poses[:, :3, 3] = poses[:, :3, 3] * scale
        factor = 8 if self.encoder_type == "LR" else 4
        intrinsics = intrinsics.clone()
        intrinsics[:, :2] = intrinsics[:, :2] / float(factor)
        images = images * (2.0 / 255.0) - 1.0

        v, ht, wd = images.shape[0], images.shape[1], images.shape[2]
        h, w = ht // factor, wd // factor
        src = tuple(range(1, v))

        net_inp = self.cnet(images[:1])[0]  # [h, w, net+inp]
        net = torch.tanh(net_inp[..., :self.dim_net])
        inp = F.relu(net_inp[..., self.dim_net:])
        fmaps = self.fnet(images)  # [V, h, w, C]

        disp = torch.zeros((h, w), dtype=images.dtype, device=images.device)
        predictions = []
        for stage, (n_incre, incre_div, n_iters) in enumerate(self.cascade):
            if n_incre == -1:
                n_incre = (2 * self.radius + 1) * 2 ** (self.num_levels - 1)
            incre = 0.0025 / incre_div

            # Hypothesis slab center: stage 0 shifts away from zero
            # (corr.py:58-62); later stages center on the estimate.
            if stage == 0:
                disps_origin = torch.clamp(disp, min=n_incre // 2 * incre)
            else:
                disps_origin = disp
            disps_origin = disps_origin.detach()
            hyp = (torch.arange(n_incre, device=disp.device)
                   - n_incre // 2).to(disp.dtype) * incre
            disps = hyp[:, None, None] + disps_origin[None]  # [D, h, w]

            corr = build_corr_volume(fmaps, poses, intrinsics, disps, src)
            pyramid = corr_pyramid(corr, self.num_levels)

            for _ in range(n_iters):
                disp = disp.detach()
                corr_frames = lookup(pyramid, disp, disps_origin, incre,
                                     n_incre, self.radius)
                net, delta = self.update_block(net, inp, disp, corr_frames,
                                               stage)
                disp = disp + delta
                predictions.append(disp)

        if scale is not None:
            disp = disp * scale
        if return_predictions:
            # Per-iteration estimates for the sequence loss (raft.py:104).
            return disp, predictions
        return disp

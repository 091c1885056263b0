"""CER-MVS recurrent update block (port of
``ucnerf_tpu/models/mvs/update.py``).

Functional parity with the reference (``mvs/core/update.py``): a ConvGRU
over a hidden state fed with (context, 7x7 disparity-difference encoding
x100, encoded correlation features), emitting a 0.01-scaled disparity delta
per cascade stage (update.py:29-120).  Weight sharing follows the reference
defaults: correlation encoder and GRU shared across stages, per-stage delta
heads.  ``UpdateBlock`` takes and returns the JAX package's HWC layout; its
convolutions run NCHW.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from ucnerf_tpu_torch.models.mvs.extractor import conv2d, init_convs


def _nchw(x):  # [H, W, C] -> [1, C, H, W]
    return x.permute(2, 0, 1)[None]


class ConvGRU(nn.Module):
    def __init__(self, h_planes: int, in_planes: int, kernel: int = 3):
        super().__init__()
        self.convz = conv2d(h_planes + in_planes, h_planes, kernel)
        self.convr = conv2d(h_planes + in_planes, h_planes, kernel)
        self.convq = conv2d(h_planes + in_planes, h_planes, kernel)

    def forward(self, net, inp):  # [N, C, H, W]
        net_inp = torch.cat([net, inp], dim=1)
        z = torch.sigmoid(self.convz(net_inp))
        r = torch.sigmoid(self.convr(net_inp))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1)))
        return (1 - z) * net + z * q


def disp_encoding(disp, size=7):
    """7x7 neighborhood differences of the disparity (update.py:83-88).

    disp [N, H, W, 1] -> [N, H, W, size*size] of (neighbor - center), the
    neighbors in row-major patch order with zero padding.
    """
    n, h, w, _ = disp.shape
    patches = F.unfold(disp.permute(0, 3, 1, 2), size, padding=size // 2)
    return patches.view(n, size * size, h, w).permute(0, 2, 3, 1) - disp


class UpdateBlock(nn.Module):
    """Shared-weights GRU update over per-view correlation features."""

    def __init__(self, num_stages: int = 2, dim_net: int = 64,
                 dim_inp: int = 64, dim0_corr: int = 64, dim1_corr: int = 64,
                 dim0_delta: int = 256, num_levels: int = 3, radius: int = 5,
                 size_disp_enc: int = 7,
                 aggregation: Tuple[str, ...] = ("mean",), seed: int = 0):
        super().__init__()
        self.size_disp_enc = size_disp_enc
        self.aggregation = aggregation
        dim_corr = num_levels * (2 * radius + 1) * len(aggregation)
        # Correlation encoder (shared across stages, update.py:60-66).
        self.corr_encoder_0 = conv2d(dim_corr, dim0_corr, 1)
        self.corr_encoder_1 = conv2d(dim0_corr, dim1_corr, 3)
        self.gru = ConvGRU(dim_net, dim_inp + size_disp_enc**2 + dim1_corr)
        # Per-stage delta heads (share_delta=False, update.py:67-71).
        for stage in range(num_stages):
            setattr(self, f"delta{stage}_0", conv2d(dim_net, dim0_delta, 3))
            setattr(self, f"delta{stage}_1", conv2d(dim0_delta, 1, 3))
        init_convs(self, seed)

    def forward(self, net, inp, disp, corr_frames, stage: int):
        """One GRU step.

        Args:
          net: [H, W, dim_net] hidden state.
          inp: [H, W, dim_inp] context features.
          disp: [H, W] current disparity.
          corr_frames: [num, H, W, F] per-source-view correlation lookups.
          stage: cascade stage index (selects the delta head).

        Returns:
          (net [H, W, dim_net], delta [H, W]).
        """
        disp_enc = 100.0 * disp_encoding(disp[None, ..., None],
                                         self.size_disp_enc)[0]
        parts = []
        if "mean" in self.aggregation:
            parts.append(corr_frames.mean(dim=0))
        if "max" in self.aggregation:
            parts.append(corr_frames.amax(dim=0))
        if "std" in self.aggregation:
            parts.append(corr_frames.std(dim=0, unbiased=False))
        corr = _nchw(torch.cat(parts, dim=-1))

        c = F.relu(self.corr_encoder_0(corr))
        c = F.relu(self.corr_encoder_1(c))
        gru_inp = torch.cat([_nchw(inp), _nchw(disp_enc), c], dim=1)
        net = self.gru(_nchw(net), gru_inp)

        d = F.relu(getattr(self, f"delta{stage}_0")(net))
        d = getattr(self, f"delta{stage}_1")(d)
        return net[0].permute(1, 2, 0), 0.01 * d[0, 0]

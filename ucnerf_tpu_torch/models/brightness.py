"""Layer-based color (brightness) correction
(port of ``ucnerf_tpu/models/brightness.py``).

Each training view owns a small latent code; a shared MLP decodes it into a
3x4 affine color transform applied to the rendered RGB, with a second latent
set for the sky layer.
"""

from __future__ import annotations

import torch
from torch import nn

from ucnerf_tpu_torch.models.fields import DenseCM


class BrightnessMLP(nn.Module):
    """Latent [N, n_dim] -> affine params [N, 12]."""

    def __init__(self, generator: torch.Generator, n_dim: int = 4,
                 net_depth: int = 3, net_width: int = 256):
        super().__init__()
        self.net_depth = net_depth
        width = n_dim
        for i in range(net_depth):
            self.add_module(f"pts_linears_{i}", DenseCM(
                width, net_width, generator, torch_bias=True))
            width = net_width
        # Zero kernel, identity-affine bias [I | 0]: starts as a no-op.
        self.output_linear = DenseCM(width, 12, generator)
        with torch.no_grad():
            self.output_linear.weight.zero_()
            self.output_linear.bias.copy_(torch.tensor(
                [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0], dtype=torch.float32))

    def forward(self, x):
        h = x.T  # channel-major [n_dim, N]
        for i in range(self.net_depth):
            h = torch.relu(getattr(self, f"pts_linears_{i}")(h))
        return self.output_linear(h).T


class BrightnessCorrection(nn.Module):
    """Per-view latent -> 3x4 affine color transform (+ sky variant)."""

    def __init__(self, generator: torch.Generator, n_views: int,
                 model_sky: bool = False, n_dim: int = 4, net_depth: int = 3,
                 net_width: int = 256):
        super().__init__()
        self.model_sky = model_sky
        self.latent_code = nn.Parameter(torch.zeros(n_views, n_dim))
        if model_sky:
            self.sky_latent_code = nn.Parameter(torch.zeros(n_views, 4))
        self.brightness_mlp = BrightnessMLP(generator, n_dim=n_dim,
                                            net_depth=net_depth,
                                            net_width=net_width)

    def forward(self, indices):
        """indices: [N] int per-ray view ids -> ([N, 3, 4], [N, 3, 4] or
        None).  Out-of-range ids clamp to the first/last view, as the JAX
        package's ``take(..., mode="clip")`` does."""
        idx = indices.long().clamp(0, self.latent_code.shape[0] - 1)
        n = idx.shape[0]
        affine = self.brightness_mlp(self.latent_code[idx]).reshape(n, 3, 4)
        if self.model_sky:
            affine_sky = self.brightness_mlp(
                self.sky_latent_code[idx]).reshape(n, 3, 4)
            return affine, affine_sky
        return affine, None


def apply_affine(affine, rgb):
    """rgb' = A[:, :3] @ rgb + A[:, 3]; affine [N, 3, 4], rgb [N, 3]."""
    return (torch.einsum("nij,nj->ni", affine[:, :, :3], rgb)
            + affine[:, :, 3])

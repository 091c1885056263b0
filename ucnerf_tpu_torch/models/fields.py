"""Field MLPs: hash-grid density + view-dependent color
(port of ``ucnerf_tpu/models/fields.py``).

Channel-major like the JAX package: every large activation is [features, N].
Submodules carry the JAX parameter tree's names (``density_hidden``,
``lin_second_stage_0``, ...), so ``convert.params_from_jax`` is a rename of
``kernel`` to ``weight``.  Only the ``disable_density_normals=True`` path
(both Waymo presets) is ported; the options off that path raise.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ucnerf_tpu_torch.configs import MLPConfig
from ucnerf_tpu_torch.ops import coord, hashgrid


class DenseCM(nn.Module):
    """Dense layer over channel-major activations: [in, ...] -> [out, ...].

    ``weight`` is [out, in] (torch's layout; the JAX kernel is [in, out]).
    Init follows the JAX package: weight U(-b, b) with b = sqrt(3 * scale /
    fan_in) (scale 1/3 is torch.nn.Linear's default, 2 is kaiming-uniform),
    bias zero or U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with ``torch_bias``.
    """

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator, init_scale: float = 1 / 3,
                 torch_bias: bool = False):
        super().__init__()
        bound = math.sqrt(3 * init_scale / in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features)
                                   .uniform_(-bound, bound,
                                             generator=generator))
        bias = torch.zeros(out_features)
        if torch_bias:
            b = 1 / math.sqrt(in_features)
            bias.uniform_(-b, b, generator=generator)
        self.bias = nn.Parameter(bias)

    def forward(self, x):
        y = torch.matmul(self.weight, x.reshape(x.shape[0], -1))
        y = y + self.bias[:, None]
        return y.reshape((self.weight.shape[0],) + x.shape[1:])


def pos_enc_width(deg: int) -> int:
    """Width of ``pos_enc(x, 0, deg, append_identity=True)`` for 3-D x."""
    return 3 + 3 * 2 * deg


class ZipMLP(nn.Module):
    """Density + color field over hash-grid features (channel-major)."""

    def __init__(self, config: MLPConfig, generator: torch.Generator):
        super().__init__()
        cfg = config
        if not cfg.disable_density_normals or cfg.enable_pred_normals:
            raise NotImplementedError("density/predicted normals are not "
                                      "ported yet")
        if cfg.num_glo_features > 0 or cfg.scale_featurization:
            raise NotImplementedError("GLO and scale featurization are not "
                                      "ported yet")
        if cfg.compute_dtype is not None:
            raise NotImplementedError("bf16 field matmuls are not ported yet")
        self.config = cfg
        self.grid_spec = hashgrid.HashGridSpec(
            input_dim=3,
            num_levels=cfg.grid_num_levels,
            level_dim=cfg.grid_level_dim,
            base_resolution=cfg.grid_base_resolution,
            desired_resolution=cfg.grid_desired_resolution,
            log2_hashmap_size=cfg.grid_log2_hashmap_size,
            init_std=cfg.grid_init_std,
        )
        self.table = nn.Parameter(hashgrid.init_table(self.grid_spec,
                                                      generator))
        self.density_hidden = DenseCM(self.grid_spec.output_dim, 64,
                                      generator)
        out_width = 1 if cfg.disable_rgb else cfg.bottleneck_width
        self.density_out = DenseCM(64, out_width, generator)
        if not cfg.disable_rgb:
            inputs = cfg.bottleneck_width + pos_enc_width(cfg.deg_view)
            width = inputs
            for i in range(cfg.net_depth_viewdirs):
                self.add_module(f"lin_second_stage_{i}", DenseCM(
                    width, cfg.net_width_viewdirs, generator, init_scale=2.0))
                width = cfg.net_width_viewdirs
                if i == cfg.skip_layer_dir:
                    width += inputs
            self.rgb_layer = DenseCM(width, cfg.num_rgb_channels, generator)

    def encode_features(self, means, stds):
        """Warp, hash-encode, erf-downweight and hex-average (channel-major).

        Args:
          means: [3, 6, R, S] multisample means (6 hex points).
          stds: [6, R, S] multisample stds.

        Returns:
          features [F, M] (M = R*S) and the contracted means [3, R, S].
        """
        cfg = self.config
        _, _, r, s = means.shape
        m = r * s
        if cfg.warp_fn is not None:
            means, stds = coord.track_linearize_cm(
                cfg.warp_fn, means, stds, stop_grads=not cfg.contract_grads)
            bound = 2.0  # contract() maps into the radius-2 ball.
            means = means / bound
            stds = stds / bound
        x01 = (means.reshape(3, 6, m) + 1.0) / 2.0
        if cfg.hex_single_query:
            x01 = x01.mean(dim=1, keepdim=True)  # [3, 1, M]
        feats, _ = hashgrid.encode_hex_cm(
            x01, stds.reshape(6, m), self.table, self.grid_spec,
            gather_bf16=cfg.grid_bf16_gather,
            bwd_dense_sample=cfg.grid_bwd_dense_sample,
            bwd_value_dtype=cfg.grid_bwd_value_dtype)
        return feats, means.mean(dim=1)

    def predict_density(self, means, stds):
        """Features -> raw density and bottleneck.

        Returns raw_density [R, S] (before ``density_bias`` and the
        softplus), the bottleneck x [W, M] and the contracted means
        [3, R, S]."""
        _, _, r, s = means.shape
        feats, means_contract = self.encode_features(means, stds)
        x = self.density_out(torch.relu(self.density_hidden(feats)))
        return x[0].reshape(r, s), x, means_contract

    def forward(self, means, stds, viewdirs=None, train=False):
        """Evaluate the field.

        Args:
          means: [3, 6, R, S] multisample Gaussian means (channel-major).
          stds: [6, R, S] multisample stds.
          viewdirs: [R, 3] per-ray view directions.
          train: training forward.  The density and bottleneck noise of the
            JAX package's keyed training forward are not ported (0 in every
            preset); asking for them raises.

        Returns:
          dict with density [R, S], rgb [3, R, S], coord [3, R, S] and
          normals/normals_pred None.
        """
        cfg = self.config
        if train and (cfg.density_noise > 0 or cfg.bottleneck_noise > 0):
            raise NotImplementedError("density/bottleneck noise is not "
                                      "ported yet")
        _, _, r, s = means.shape
        m = r * s
        raw_density, x, means_contract = self.predict_density(means, stds)
        density = nn.functional.softplus(raw_density + cfg.density_bias)

        if cfg.disable_rgb:
            rgb = torch.zeros((3, r, s), dtype=density.dtype,
                              device=density.device)
        else:
            # View direction encoding, per ray then broadcast over samples.
            dir_enc = coord.pos_enc(viewdirs, min_deg=0,
                                    max_deg=cfg.deg_view)  # [R, D]
            dir_enc_cm = dir_enc.T[:, :, None].expand(-1, r, s).reshape(-1, m)
            h = torch.cat([x, dir_enc_cm], dim=0)
            inputs = h
            for i in range(cfg.net_depth_viewdirs):
                h = torch.relu(getattr(self, f"lin_second_stage_{i}")(h))
                if i == cfg.skip_layer_dir:
                    h = torch.cat([h, inputs], dim=0)
            rgb = torch.sigmoid(cfg.rgb_premultiplier * self.rgb_layer(h)
                                + cfg.rgb_bias)
            rgb = rgb * (1 + 2 * cfg.rgb_padding) - cfg.rgb_padding
            rgb = rgb.reshape(3, r, s)

        return dict(coord=means_contract, density=density, rgb=rgb,
                    normals=None, normals_pred=None)

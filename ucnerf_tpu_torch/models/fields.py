"""Field MLPs: hash-grid density + view-dependent color
(port of ``ucnerf_tpu/models/fields.py``).

Channel-major like the JAX package: every large activation is [features, N].
Submodules carry the JAX parameter tree's names (``density_hidden``,
``lin_second_stage_0``, ``normal_layer``, ``lin_glo_0``, ...), so
``convert.params_from_jax`` is a rename of ``kernel`` to ``weight``.

Every option of the JAX field is here: density normals (the gradient of the
raw density w.r.t. the sample means, taken with ``torch.autograd.grad``;
in training with ``create_graph``, so that the normals' losses reach the
tables through the encoder's differentiable backward), predicted normals,
the GLO layers, scale featurization, bf16 field matmuls
(``compute_dtype``) and the training forward's density and bottleneck
noise, drawn from the caller's ``torch.Generator`` or passed in.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ucnerf_tpu_torch.configs import MLPConfig
from ucnerf_tpu_torch.ops import coord, hashgrid
from ucnerf_tpu_torch.utils.spans import spanned


class DenseCM(nn.Module):
    """Dense layer over channel-major activations: [in, ...] -> [out, ...].

    ``weight`` is [out, in] (torch's layout; the JAX kernel is [in, out]).
    Init follows the JAX package: weight U(-b, b) with b = sqrt(3 * scale /
    fan_in) (scale 1/3 is torch.nn.Linear's default, 2 is kaiming-uniform),
    bias zero or U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with ``torch_bias``.

    ``compute_dtype='bfloat16'`` is the JAX package's bf16 matmul: weight
    and input rounded to bf16, products summed in f32 and an f32 output
    (bias added in f32); in the backward each cast rounds its cotangent to
    bf16, as JAX's does.  The product of the bf16-rounded values is taken in
    f32 (each product of two bf16 values is exact in f32), the same on every
    device; a bf16 GEMM with a bf16 output would be another function.
    """

    def __init__(self, in_features: int, out_features: int,
                 generator: torch.Generator, init_scale: float = 1 / 3,
                 torch_bias: bool = False, compute_dtype=None):
        super().__init__()
        if compute_dtype not in (None, "bfloat16"):
            raise ValueError(f"compute_dtype must be None or 'bfloat16', got "
                             f"{compute_dtype!r}")
        self.compute_dtype = compute_dtype
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
        weight = self.weight
        if self.compute_dtype is not None:
            weight = _bf16_round(weight)
            x = _bf16_round(x)
        y = torch.matmul(weight, x.reshape(x.shape[0], -1))
        y = y + self.bias[:, None]
        return y.reshape((self.weight.shape[0],) + x.shape[1:])


def _bf16_round(x):
    """x rounded to bf16 and widened back; the backward rounds the
    cotangent to bf16 the same way."""
    return x.to(torch.bfloat16).to(x.dtype)


def _l2_normalize_cm(x, eps=1e-12):
    """Normalize over the leading (channel) axis."""
    return x / torch.sqrt(torch.clamp(torch.sum(x**2, dim=0, keepdim=True),
                                      min=eps))


def pos_enc_width(deg: int) -> int:
    """Width of ``pos_enc(x, 0, deg, append_identity=True)`` for 3-D x."""
    return 3 + 3 * 2 * deg


class ZipMLP(nn.Module):
    """Density + color field over hash-grid features (channel-major).

    ``with_glo`` says that a ``glo_vec`` will be passed: only then, and with
    ``num_glo_features > 0``, are the GLO layers built.  The JAX tree holds
    them only where a ``glo_vec`` reached the field at init, and the JAX
    ``UCNeRFModel`` never passes one, so the model builds its fields without
    them and loads a JAX tree of any config strictly.
    """

    def __init__(self, config: MLPConfig, generator: torch.Generator,
                 with_glo: bool = False):
        super().__init__()
        cfg = config
        self.config = cfg
        self.with_glo = with_glo and cfg.num_glo_features > 0
        cdt = cfg.compute_dtype
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
        feat_dim = self.grid_spec.output_dim
        if cfg.scale_featurization:
            feat_dim += self.grid_spec.num_levels
        self.density_hidden = DenseCM(feat_dim, 64, generator,
                                      compute_dtype=cdt)
        out_width = 1 if cfg.disable_rgb else cfg.bottleneck_width
        self.density_out = DenseCM(64, out_width, generator,
                                   compute_dtype=cdt)
        if cfg.enable_pred_normals:
            self.normal_layer = DenseCM(out_width, 3, generator)
        if not cfg.disable_rgb:
            if self.with_glo:
                width = cfg.num_glo_features
                for i in range(cfg.net_depth_glo):
                    last = i == cfg.net_depth_glo - 1
                    out = cfg.bottleneck_width * 2 if last else \
                        cfg.net_width_glo
                    self.add_module(f"lin_glo_{i}",
                                    DenseCM(width, out, generator))
                    width = out
            inputs = cfg.bottleneck_width + pos_enc_width(cfg.deg_view)
            width = inputs
            for i in range(cfg.net_depth_viewdirs):
                self.add_module(f"lin_second_stage_{i}", DenseCM(
                    width, cfg.net_width_viewdirs, generator, init_scale=2.0,
                    compute_dtype=cdt))
                width = cfg.net_width_viewdirs
                if i == cfg.skip_layer_dir:
                    width += inputs
            self.rgb_layer = DenseCM(width, cfg.num_rgb_channels, generator,
                                     compute_dtype=cdt)

    @spanned("ucnerf.encode")
    def encode_features(self, means, stds, inner_grad_first=False):
        """Warp, hash-encode, erf-downweight and hex-average (channel-major).

        Args:
          means: [3, 6, R, S] multisample means (6 hex points).
          stds: [6, R, S] multisample stds.
          inner_grad_first: the first backward through the encoder is the
            density normals' gradient w.r.t. the means
            (``hashgrid.encode_hex_cm``).

        Returns:
          features [F, M] (M = R*S; with scale featurization the L
          featurized erf weights follow the L*C grid features) and the
          contracted means [3, R, S].
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
        feats, wmeans = hashgrid.encode_hex_cm(
            x01, stds.reshape(6, m), self.table, self.grid_spec,
            gather_bf16=cfg.grid_bf16_gather,
            bwd_dense_sample=cfg.grid_bwd_dense_sample,
            bwd_value_dtype=cfg.grid_bwd_value_dtype,
            inner_grad_first=inner_grad_first)
        if cfg.scale_featurization:
            vl2mean = hashgrid.level_sq_means(self.table.detach(),
                                              self.grid_spec)
            featurized_w = ((2 * wmeans - 1)
                            * torch.sqrt(cfg.grid_init_std**2
                                         + vl2mean)[:, None])
            feats = torch.cat([feats, featurized_w], dim=0)
        return feats, means.mean(dim=1)

    def predict_density(self, means, stds, density_noise=None,
                        inner_grad_first=False):
        """Features -> raw density and bottleneck.

        Returns raw_density [R, S] (before ``density_bias`` and the
        softplus, plus ``density_noise`` x `density_noise` [R, S] when
        given), the bottleneck x [W, M] and the contracted means
        [3, R, S]."""
        _, _, r, s = means.shape
        feats, means_contract = self.encode_features(means, stds,
                                                     inner_grad_first)
        x = self.density_out(torch.relu(self.density_hidden(feats)))
        raw_density = x[0].reshape(r, s)
        if density_noise is not None:
            raw_density = raw_density + self.config.density_noise * \
                density_noise
        return raw_density, x, means_contract

    def _density_and_normals(self, means, stds, density_noise):
        """predict_density and the density normals -normalize(d raw_density
        / d means), averaged over the hex points: [3, R, S].

        One forward; the gradient w.r.t. the means (a leaf copy where they
        carry no gradient of their own) comes from ``torch.autograd.grad``,
        the encoder's first backward (``inner_grad_first``), which computes
        the corner weights' gradient alone.  In grad mode the
        gradient keeps its graph (``create_graph``), for the normals'
        losses; under no_grad (renders) it is taken under a local
        ``enable_grad`` and everything returned is detached.  Where the
        contraction stops gradients (``contract_grads`` off), the density
        does not depend on the means and the normals are zero, as in the
        JAX package.
        """
        train = torch.is_grad_enabled()
        with torch.enable_grad():
            mn = means if train and means.requires_grad else \
                means.detach().requires_grad_()
            raw_density, x, means_contract = self.predict_density(
                mn, stds, density_noise, inner_grad_first=True)
            grad, = torch.autograd.grad(raw_density.sum(), mn,
                                        create_graph=train,
                                        allow_unused=True)
        if grad is None:
            grad = torch.zeros_like(means)
        normals = -_l2_normalize_cm(grad.mean(dim=1))
        if not train:
            raw_density, x, means_contract, normals = (
                t.detach() for t in (raw_density, x, means_contract,
                                     normals))
        return raw_density, x, means_contract, normals

    def forward(self, means, stds, viewdirs=None, glo_vec=None,
                generator=None, noise=None):
        """Evaluate the field.

        Args:
          means: [3, 6, R, S] multisample Gaussian means (channel-major).
          stds: [6, R, S] multisample stds.
          viewdirs: [R, 3] per-ray view directions.
          glo_vec: optional [R, num_glo_features] appearance codes, for a
            field built ``with_glo`` (the JAX model never passes one).
          generator: the keyed training forward's torch.Generator: the
            density and bottleneck noise (where their scales are > 0) are
            standard normals drawn from it, density first.
          noise: instead of a generator, dict of the standard-normal draws
            ``density`` [R, S] and ``bottleneck`` [W, M] (the tests pass
            JAX's).

        Returns:
          dict with density [R, S], rgb [3, R, S], coord [3, R, S],
          grad_pred and normals/normals_pred [3, R, S] or None.
        """
        cfg = self.config
        _, _, r, s = means.shape
        m = r * s
        if generator is not None and noise is not None:
            raise ValueError("pass at most one of generator and noise")
        noise = dict(noise or {})
        if generator is not None:
            dev = means.device
            if cfg.density_noise > 0:
                noise["density"] = torch.randn((r, s), generator=generator,
                                               device=dev)
            if cfg.bottleneck_noise > 0 and not cfg.disable_rgb:
                noise["bottleneck"] = torch.randn(
                    (cfg.bottleneck_width, m), generator=generator,
                    device=dev)
        density_noise = noise.get("density") if cfg.density_noise > 0 \
            else None

        if cfg.disable_density_normals:
            raw_density, x, means_contract = self.predict_density(
                means, stds, density_noise)
            normals = None
        else:
            raw_density, x, means_contract, normals = \
                self._density_and_normals(means, stds, density_noise)

        if cfg.enable_pred_normals:
            grad_pred = self.normal_layer(x).reshape(3, r, s)
            normals_pred = -_l2_normalize_cm(grad_pred)
        else:
            grad_pred = normals_pred = None

        density = nn.functional.softplus(raw_density + cfg.density_bias)

        if cfg.disable_rgb:
            rgb = torch.zeros((3, r, s), dtype=density.dtype,
                              device=density.device)
        else:
            bottleneck = x  # [W, M]
            if cfg.bottleneck_noise > 0 and "bottleneck" in noise:
                bottleneck = bottleneck + cfg.bottleneck_noise * \
                    noise["bottleneck"]
            if glo_vec is not None and cfg.num_glo_features > 0:
                if not self.with_glo:
                    raise ValueError("glo_vec passed to a field built "
                                     "without with_glo")
                g = glo_vec.T  # [G, R]
                for i in range(cfg.net_depth_glo):
                    g = getattr(self, f"lin_glo_{i}")(g)
                    if i != cfg.net_depth_glo - 1:
                        g = torch.relu(g)
                scale, shift = torch.chunk(g, 2, dim=0)  # [W, R] each
                b3 = bottleneck.reshape(-1, r, s)
                b3 = b3 * torch.exp(scale)[:, :, None] + shift[:, :, None]
                bottleneck = b3.reshape(-1, m)
            # View direction encoding, per ray then broadcast over samples.
            dir_enc = coord.pos_enc(viewdirs, min_deg=0,
                                    max_deg=cfg.deg_view)  # [R, D]
            dir_enc_cm = dir_enc.T[:, :, None].expand(-1, r, s).reshape(-1, m)
            h = torch.cat([bottleneck, dir_enc_cm], dim=0)
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
                    grad_pred=grad_pred, normals=normals,
                    normals_pred=normals_pred)

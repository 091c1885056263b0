"""The UC-NeRF model (port of ``ucnerf_tpu/models/model.py``).

Zip-NeRF proposal hierarchy + sky NeRF + per-view affine color correction.
The forward is deterministic (the JAX ``__call__`` with ``key=None``) unless
a ``torch.Generator`` is given, from which it draws what the JAX keyed
forward draws: the per-level sampling jitter, the hex pattern's flip,
rotation and basis vector, the fields' noise and a random background.  Submodules carry the JAX parameter tree's names
(``nerf_mlp``, ``prop_mlp_0``, ``skynerf``, ``cam_refine``,
``brightness_corr``).

The JAX package wraps the fields in ``jax.checkpoint`` (``remat_fields``),
for the TPU's 16 GB: the port keeps the activations and never recomputes
in the backward, so it ignores ``remat_fields``.

Ray batch convention (flat tensors, [N, ...]): origins, directions,
viewdirs, cam_dirs [N, 3]; radii, near, far [N, 1]; cam_idx [N] int; with
``optimize_cameras``, phys_cam_idx [N] int, the physical camera whose se(3)
delta (``cam_refine``) moves the ray.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ucnerf_tpu_torch.configs import Config
from ucnerf_tpu_torch.models.brightness import BrightnessCorrection, apply_affine
from ucnerf_tpu_torch.models.cam_refine import CameraRefinement
from ucnerf_tpu_torch.models.fields import ZipMLP
from ucnerf_tpu_torch.models.sky import SkyNeRF, render_sky
from ucnerf_tpu_torch.ops import (coord, grad_scaler, hashgrid, rendering,
                                  stepfun)
from ucnerf_tpu_torch.utils.spans import spanned


class UCNeRFModel(nn.Module):
    """Proposal-hierarchy NeRF with UC-NeRF extensions."""

    def __init__(self, config: Config, generator: torch.Generator):
        super().__init__()
        self.config = config
        mcfg = config.model
        nerf_cfg, prop_cfg = config.nerf_mlp, config.prop_mlp
        if config.contract_origin_grads:
            nerf_cfg = dataclasses.replace(nerf_cfg, contract_grads=True)
            prop_cfg = dataclasses.replace(prop_cfg, contract_grads=True)
        # Creation order fixes which random numbers each parameter gets.
        self.nerf_mlp = ZipMLP(nerf_cfg, generator)
        self.num_prop = mcfg.num_levels - 1
        for i in range(self.num_prop):
            self.add_module(f"prop_mlp_{i}", ZipMLP(
                prop_cfg.with_grid(mcfg.prop_desired_grid_size[i]),
                generator))
        if config.model_sky:
            self.skynerf = SkyNeRF(generator, net_depth=mcfg.sky_net_depth,
                                   net_width=mcfg.sky_net_width,
                                   deg_view=mcfg.sky_deg_view)
        if config.optimize_cameras:
            # Zeros: draws nothing from the generator.
            self.cam_refine = CameraRefinement(config.num_phys_cams)
        if config.brightness_correction:
            self.brightness_corr = BrightnessCorrection(
                generator, n_views=config.training_views,
                model_sky=config.model_sky,
                n_dim=mcfg.brightness_latent_dim,
                net_depth=mcfg.brightness_net_depth,
                net_width=mcfg.brightness_net_width)

    @spanned("ucnerf.forward")
    def forward(self, batch, train_frac, rand_vec=None, compute_extras=False,
                eval_camidx=None, train=False, generator=None, bg_draw=None):
        """Render a flat ray batch.

        Args:
          batch: dict of ray tensors (see module docstring).
          train_frac: float in [0, 1], fraction of training complete.
          rand_vec: [N, 3] random vector fixing each ray's hex basis at every
            level (the JAX package draws it from PRNGKey(0) when
            ``key=None``; see ops/rendering.py).  Required without a
            generator, refused with one.
          compute_extras: compute distance statistics.
          eval_camidx: optional int, the brightness-correction view id for
            every ray.
          train: training forward (adds ``loss_hash_decay`` to each level of
            the ray history).
          generator: optional torch.Generator on the batch's device; the
            random draws of the JAX keyed forward come from it: first, with
            a random ``bg_intensity_range``, the background colour; then per
            level the sampling jitter, the hex flip and rotation, the hex
            basis and the field's density and bottleneck noise (where their
            scales are > 0).
          bg_draw: optional U[0, 1) draws [N, 3] for a random
            ``bg_intensity_range`` in the generator's place (the tests pass
            JAX's).

        Returns:
          (renderings, ray_history): one dict per sampling level each.
        """
        cfg = self.config
        mcfg = cfg.model
        near, far = batch["near"], batch["far"]
        n, dev = near.shape[0], near.device
        if (generator is None) == (rand_vec is None):
            raise ValueError("pass exactly one of rand_vec and generator")
        # The background colour: constant, the range's mean without a
        # generator, or one [N, 3] draw shared by every level (the JAX
        # keyed forward draws it from one key, keys[-1]).
        lo_bg, hi_bg = mcfg.bg_intensity_range
        bg_rgbs = lo_bg if lo_bg == hi_bg else (lo_bg + hi_bg) / 2
        if bg_draw is not None:
            bg_rgbs = lo_bg + (hi_bg - lo_bg) * bg_draw
        elif generator is not None and lo_bg != hi_bg:
            bg_rgbs = lo_bg + (hi_bg - lo_bg) * torch.rand(
                (n, 3), generator=generator, device=dev)

        if cfg.optimize_cameras and "phys_cam_idx" in batch:
            # Per-camera se(3) refinement of the rays (models/cam_refine.py),
            # equivalent to regenerating them from Exp(delta) @ c2w.
            o2, d2, cd2 = self.cam_refine(
                batch["phys_cam_idx"], batch["origins"],
                batch["directions"], batch["cam_dirs"])
            vd2 = d2 / torch.linalg.vector_norm(d2, dim=-1, keepdim=True)
            batch = dict(batch, origins=o2, directions=d2, cam_dirs=cd2,
                         viewdirs=vd2)

        _, s_to_t = coord.construct_ray_warps(
            mcfg.raydist_fn, near, far, mcfg.power_lambda)
        if mcfg.near_anneal_rate is None:
            init_s_near = 0.0
        else:
            init_s_near = float(np.clip(
                1 - train_frac / mcfg.near_anneal_rate, 0,
                mcfg.near_anneal_init))
        init_s_far = 1.0
        sdist = torch.cat([torch.full_like(near, init_s_near),
                           torch.full_like(far, init_s_far)], dim=-1)
        weights = torch.ones_like(near)
        prod_num_samples = 1

        ray_history = []
        renderings = []
        for i_level in range(mcfg.num_levels):
            is_prop = i_level < self.num_prop
            num_samples = (mcfg.num_prop_samples if is_prop
                           else mcfg.num_nerf_samples)
            dilation = (mcfg.dilation_bias + mcfg.dilation_multiplier *
                        (init_s_far - init_s_near) / prod_num_samples)
            prod_num_samples *= num_samples

            use_dilation = mcfg.dilation_bias > 0 or mcfg.dilation_multiplier > 0
            if i_level > 0 and use_dilation:
                sdist, weights = stepfun.max_dilate_weights(
                    sdist, weights, dilation,
                    domain=(init_s_near, init_s_far), renormalize=True)
                sdist = sdist[..., 1:-1]
                weights = weights[..., 1:-1]

            if mcfg.anneal_slope > 0:
                # Schlick's bias function.
                s = mcfg.anneal_slope
                anneal = (s * train_frac) / ((s - 1) * train_frac + 1)
            else:
                anneal = 1.0
            logits_resample = torch.where(
                sdist[..., 1:] > sdist[..., :-1],
                anneal * torch.log(weights + mcfg.resample_padding),
                torch.full_like(weights, -float("inf")))
            jitter = None
            if generator is not None:
                d = 1 if mcfg.single_jitter else num_samples
                jitter = torch.rand((n, d), generator=generator, device=dev)
            sdist = stepfun.sample_intervals(
                sdist, logits_resample, num_samples,
                domain=(init_s_near, init_s_far), jitter=jitter)
            if mcfg.stop_level_grad:
                sdist = sdist.detach()
            tdist = s_to_t(sdist)

            # Channel-major: means [3, 6, R, S], stds/ts [6, R, S].
            flip = rot = None
            basis = rand_vec
            if generator is not None:
                flip, rot = (torch.rand((n, num_samples), generator=generator,
                                        device=dev) for _ in range(2))
                basis = torch.randn((n, 3), generator=generator, device=dev)
            means, stds, ts = rendering.cast_rays_cm(
                tdist, batch["origins"], batch["directions"],
                batch["cam_dirs"], batch["radii"], basis,
                std_scale=mcfg.std_scale, flip=flip, rot=rot)
            mlp = getattr(self, f"prop_mlp_{i_level}") if is_prop \
                else self.nerf_mlp
            ray_results = mlp(
                means, stds,
                viewdirs=batch["viewdirs"] if mcfg.use_viewdirs else None,
                generator=generator)
            del means, stds

            if cfg.brightness_correction:
                rgb_s, density_s = grad_scaler.scale_gradients_by_distance(
                    ray_results["rgb"], ray_results["density"],
                    ts.mean(dim=0))
                ray_results = dict(ray_results, rgb=rgb_s, density=density_s)

            weights = rendering.compute_alpha_weights(
                ray_results["density"], tdist, batch["directions"],
                opaque_background=mcfg.opaque_background)[0]

            level_render = rendering.volumetric_rendering_cm(
                ray_results["rgb"], weights, tdist, bg_rgbs, far,
                compute_extras,
                extras={k: v for k, v in ray_results.items()
                        if k.startswith("normals")})
            level_render["weights"] = weights
            if train:
                # Hash decay: per-level mean of squared embeddings.
                ray_results["loss_hash_decay"] = hashgrid.hash_decay_means(
                    mlp.table, mlp.grid_spec).mean()
            renderings.append(level_render)
            ray_results["sdist"] = sdist
            ray_results["weights"] = weights
            if is_prop and mlp.config.disable_rgb:
                ray_results["rgb"] = None
            ray_history.append(ray_results)

        # Sky layer beyond the far plane, composited with (1 - acc) after
        # the per-view color correction.
        if cfg.model_sky:
            sky_far = (far[0, 0].detach() * mcfg.sky_far_mult).expand_as(far)
            sky_rgb = render_sky(
                self.skynerf, batch["origins"], batch["directions"], far,
                sky_far, mcfg.sky_num_samples,
                viewdirs=batch["cam_dirs"])["rgb_map"]
            for r in renderings:
                r["sky_rgbs"] = sky_rgb

        final_acc = renderings[-1]["weights"].sum(dim=-1, keepdim=True)
        if cfg.brightness_correction:
            if eval_camidx is None:
                camera_idxs = batch["cam_idx"].reshape(-1)
            else:
                camera_idxs = torch.full((n,), int(eval_camidx),
                                         dtype=torch.long, device=dev)
            affine, affine_sky = self.brightness_corr(camera_idxs)
            for r in renderings:
                rgb_cc = apply_affine(affine, r["rgb"])
                if cfg.model_sky:
                    rgb_cc = rgb_cc + (1.0 - final_acc) * apply_affine(
                        affine_sky, r["sky_rgbs"])
                r["rgb"] = rgb_cc
                r["affine_trans"] = affine
                if cfg.model_sky:
                    r["affine_trans_sky"] = affine_sky
        elif cfg.model_sky:
            for r in renderings:
                r["rgb"] = r["rgb"] + (1.0 - final_acc) * r["sky_rgbs"]
        return renderings, ray_history

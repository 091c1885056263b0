"""Roofline accounting: FLOPs and HBM bytes of a train step or a render, and
the scoreboard of utilizations derived from a measured time (the port's
counterpart of ``ucnerf_tpu/utils/roofline.py``).

Two byte models:
- the ops' count (``cost``): every aten op's tensor operands and outputs
  once, through ``ops.traffic.ByteCounter``, the hand-written kernels by
  their own byte models; the analogue of XLA's "bytes accessed", an
  optimistic floor for the scattered reads;
- a hand model of the hash encoder's gather traffic (``gather_model``):
  the lookups a step makes, from the config's sampling geometry, at ideal
  row bytes and at the granularity the card reads scattered rows in, one
  32-byte sector a lookup.

FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s: matrix products
and convolutions; elementwise work is not counted.

Peaks are NVIDIA's datasheet figures for the H100 SXM5 80 GB at its 700 W
limit: 989.4 TFLOP/s dense bf16 on the tensor cores, 66.9 TFLOP/s float32
on the CUDA cores (the port's f32 step runs with TF32 off), 3.35 TB/s HBM3.
A card set to a lower power limit runs below them.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ucnerf_tpu_torch.ops.traffic import ByteCounter
from ucnerf_tpu_torch.train import losses

PEAK_FLOPS = 989.4e12
PEAK_FLOPS_F32 = 66.9e12
PEAK_BW = 3.35e12
# The card reads scattered rows in 32-byte sectors: one sector a lookup of
# a 16-byte row (PERF.md: scattered reads are bound by sectors in flight).
# The TPU model's 4 KiB (8, 128) tile is what XLA's gather reads there.
SECTOR_BYTES = 32


def gather_model(cfg, batch_size=None):
    """Hash-encode lookups of one train step (or of `batch_size` rays) from
    the config: for each sampling level, rays x samples x hex points (1
    with ``hex_single_query``) x grid levels x 8 corners; their bytes at
    the row size and at one sector each."""
    batch_size = batch_size or cfg.batch_size
    mcfg = cfg.model
    lookups = 0
    ideal = 0
    for level in range(mcfg.num_levels):
        is_prop = level < mcfg.num_levels - 1
        n_samples = (mcfg.num_prop_samples if is_prop
                     else mcfg.num_nerf_samples)
        mlp = cfg.prop_mlp if is_prop else cfg.nerf_mlp
        if is_prop:
            mlp = mlp.with_grid(mcfg.prop_desired_grid_size[level])
        hex_n = 1 if mlp.hex_single_query else 6
        n = batch_size * n_samples * hex_n * mlp.grid_num_levels * 8
        lookups += n
        ideal += n * mlp.grid_level_dim * 4
    return dict(lookups=lookups, ideal_bytes=ideal,
                sector_bytes=lookups * SECTOR_BYTES)


def cost(fn):
    """(flops, bytes, kernel bytes by wrapper) of running fn() once, counted
    by op."""
    with FlopCounterMode(display=False) as flops, ByteCounter() as nbytes:
        fn()
    return (float(flops.get_total_flops()), float(nbytes.bytes),
            dict(nbytes.kernels))


def train_step_cost(cfg, model, state, batch, generator=None):
    """(flops, bytes, kernel bytes by wrapper) of one train step of `cfg`:
    one microbatch's forward, losses and backward, times
    ``cfg.microbatches``, plus the optimizer's update.  It runs them for
    real, so the state takes one step (on the first microbatch's gradient).
    `generator` draws the keyed forward's randomness (a fresh one seeded 0
    by default)."""
    num_micro = max(cfg.microbatches, 1)
    n = batch["origins"].shape[0] // num_micro
    mb = {k: v[:n] for k, v in batch.items()}
    if generator is None:
        generator = torch.Generator(device=batch["origins"].device)
        generator.manual_seed(0)
    model.zero_grad(set_to_none=True)

    def grad():
        renderings, history = model(mb, 0.5, None, compute_extras=False,
                                    train=True, generator=generator)
        total, _, _ = losses.compute_all_losses(mb, renderings, history, cfg)
        total.backward()

    g_flops, g_bytes, kernels = cost(grad)
    u_flops, u_bytes, _ = cost(state.optimizer.update)
    model.zero_grad(set_to_none=True)
    return (g_flops * num_micro + u_flops, g_bytes * num_micro + u_bytes,
            {k: v * num_micro for k, v in kernels.items()})


def metrics(dt, flops, bytes_, gm=None):
    """Scoreboard for one measured time dt (s) of work of `flops` and
    `bytes_`: the shares of the bf16 and f32 peaks and of the bandwidth,
    and, with a ``gather_model`` `gm`, the gather's sector traffic."""
    out = {
        "mfu": flops / dt / PEAK_FLOPS,
        "f32_share": flops / dt / PEAK_FLOPS_F32,
        "hbm_util": bytes_ / dt / PEAK_BW,
    }
    if gm is not None:
        out["hbm_util_gather_sector"] = gm["sector_bytes"] / dt / PEAK_BW
        out["gather_lookups_per_step"] = gm["lookups"]
    return out

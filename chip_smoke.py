#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ucnerf_tpu_torch``) on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--out results.json]

Phases:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ucnerf_tpu_torch/csrc/, all in parallel;
  3. kernel phase: hold each kernel against its plain PyTorch version at the
     shapes the main paths give it (K4's two entry points at a render
     chunk's proposal level: ``take_cm`` bitwise, and the fused
     ``take_wsum_cm`` within 8 ulp of the summed magnitudes and bitwise
     ``take_cm`` for one-hot weights; K1's two entry points, K2 and K3 at
     one training microbatch of each grid, with a skewed row of 1e5
     updates: the fused ``scatter_add_wsum_cm``, which the f32 step
     launches, bitwise ``segment_sum_cm`` on the torch-formed w*g; K3's
     fused ``scatter_add_wsum_packed_cm``, which the bf16 step launches,
     bitwise the planar K3 on the torch-formed, bf16-rounded w*g; the planar K3 bitwise K1 on the bf16-rounded
     updates; the run-starts pass bitwise searchsorted; K5, which no path
     calls, at the NeRF grid's hashed stream in 1 and 24 chunks and on a
     small stream of corner cases), check that the scatters are bitwise
     deterministic, and time kernel, prep, plain version and the nearest
     PyTorch call, with the walk lengths;
  4. render phase: render 2 views of 480x320 through ``render_image`` with
     the canonical Waymo model (``configs.waymo()``, full width, random
     weights from a seed), count the kernel launches of that run, check the
     outputs, render the first view again through the same eval step
     (bitwise equal), and match a 64-ray chunk against the same model on
     the CPU; then the real-index phase: K4's two entry points held and
     timed on the corner indices and weights that one render chunk hands to
     a proposal level and to a NeRF level (neighbouring samples share rows
     there; the kernel phase's uniform stream is the worst case);
  5. gradient check: one 64-ray training microbatch on the card against
     the same model on the CPU (plain versions of every kernel); then the
     real-stream phase: K1's fused entry, K3's fused entry and K2 held,
     timed and their walk lengths read on what one training microbatch's
     f32 backward hands them at each grid;
  6. training phase: one warm-up and 5 timed steps of
     ``configs.waymo(lr_delay_steps=0)`` (15000 rays in 10 microbatches,
     Adam) on a fixed batch drawn from the two views; check the losses, the
     updates, the table gradients and the launches: 20 K1 (all through the
     fused entry, so no [C, 8 N L] values are built), 20 K2, 160 K4 and 40
     run-starts passes a step;
  7. bf16 training phase: the same model from the same initial state with
     ``grid_bwd_value_dtype='bfloat16'`` on both fields, one warm-up and 2
     timed steps; K3 takes K1's place (20 K3, all through its fused entry,
     so no [C, 8 N L] values and no [C/2, M] packed words are built; 20 K2,
     160 K4 and no K1 launch a step), and the first step's table gradients
     stay within 1 % relative L2 of the f32 phase's;
  8. repeatability phase: for each backward, two runs of 2 steps from the
     same initial parameters, a fresh Adam state, the same batch and one
     generator seed; every parameter, every Adam moment and the losses
     bitwise equal;
  9. CLI phase: ``ucnerf_tpu_torch.cli.train`` in-process on the synthetic
     scene (``--preset synthetic_quality`` with the bf16 backward): 30
     steps, a test render, checkpoints, then a second call that resumes at
     step 30 and ends at 40;
  10. serving phase, on the CLI phase's step-40 checkpoint, each entry
     point in-process with its launches counted from 0 (K4 only, all
     through the fused entry): ``cli.eval`` on every test view with the ray
     histograms (finite metric dumps; view 0's PSNR bitwise this phase's
     own ``render_image`` + ``MetricHarness``), ``cli.render`` of an
     8-frame path (and a second call that skips all 8), ``cli.tsdf`` at
     256^3 over 8 training views and ``cli.extract`` at 256^3 (PLY meshes
     with faces); an extract density chunk and the mesh's vertex colors on
     the card against a CPU copy of the model; K4's two entry points held
     and timed on the corner indices one extract chunk hands a NeRF level;
  11. print the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``
     as the last line.

Any failure raises and exits non-zero; without a CUDA device the script
fails before printing any result.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peak DRAM bandwidth (bytes/s) for the bound.
HBM_BYTES_PER_S = 3.35e12
# One proposal level of a 15000-ray chunk: 128 samples x 6 hex x 8 corners.
CHUNK = 15000
PROP_M = CHUNK * 128 * 6 * 8
HASHED_ROWS = 2**21
# Render request: Waymo's front camera at factor 4 (configs.waymo docstring).
VIEW_W, VIEW_H, FOCAL = 480, 320, 2055.0 / 4
# GPU-vs-CPU tolerance on the 64-ray render: f32 throughout, TF32 off; the
# two devices differ in summation order and transcendental ulps only.
RENDER_ATOL = 1e-3
RENDER_RTOL = 1e-3
# Scatter kernels against their plain versions in float64: f32 sums in
# another order (rtol), and cancellation in random-signed sums (atol, as a
# fraction of the largest output).
SCATTER_RTOL = 1e-5
SCATTER_ATOL_FRAC = 1e-6
# One row of each scatter input takes this many updates: the skew of a
# coarse level, where one cell near the cameras holds most first samples.
SKEW = 100_000
# The fused gather adds its 8 products in corner order and the plain version
# in torch's reduction order: two f32 sums of the same 8 terms differ by at
# most 7 roundings each, held here to 8 ulp (2^-23) of sum_k |w_k * row_k|.
WSUM_ULPS = 8
# Training: rays per step, timed steps of the f32 and the bf16 phase.
TRAIN_RAYS = 15000
TRAIN_STEPS = 5
BF16_STEPS = 2
# The bf16 backward rounds each hashed-level update once (RNE, at most 2^-9
# relative, 1.1e-3 rms): its first step's table gradients are held to 1 %
# relative L2 of the f32 backward's.
BF16_GRAD_REL_L2 = 1e-2
# The keys of K3's fused-entry calls summed over the grids.
K3_FUSED_SUMS = ("torch_sequence_ms", "formation_ms", "pack_ms", "planar_ms",
                 "fused_k1_ms", "bound_with_records_ms")
# The repeatability phase: steps of each of its two runs, and their
# generator's seed.
REPEAT_STEPS = 2
REPEAT_SEED = 7
# K5 is held at the chunk counts the JAX package's record names: unchunked,
# and its best configuration.
K5_CHUNKS = (1, 24)
# The CLI phase: steps of the first call, of the resumed call, and the
# checkpoint interval.
CLI_STEPS = (30, 40)
CLI_CHECKPOINT_EVERY = 20
CLI_PRINT_EVERY = 10
# The serving phase: frames of the render path (Config.render_path_frames,
# cut from 120), training views fused by cli.tsdf (cut from all 35), the
# grid resolution of cli.extract and cli.tsdf (the CLIs' default), the
# density iso level of cli.extract, and the grid points and vertices of the
# extract field's GPU-vs-CPU check (held to the render check's tolerance).
# After 40 steps the field's density is still near its initial
# softplus(density_bias) = 0.313 everywhere (0.302 to 0.313 over the 256^3
# grid on the H100): the iso level sits inside that range, where the
# CLI's default of 20 (for a trained scene) meshes nothing.
SERVE_FRAMES = 8
SERVE_TSDF_VIEWS = 8
EXTRACT_RES = 256
EXTRACT_ISO = 0.31
FIELD_CHECK_POINTS = 8192
# GPU-vs-CPU tolerance on the 64-ray gradient check (TF32 off): loss terms
# agree to summation order (rtol 1e-4); gradients are sums over samples with
# cancellation and pass through the resampling, so rtol 1e-3 and an atol of
# 1e-5 x max|grad| of each tensor.
GRAD_LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
GRAD_ATOL_FRAC = 1e-5
# A hash table's gradient is a sum of trilinear weights x feature grads at
# the sample positions.  Past the first level the positions come out of the
# proposal resampling, where the devices differ by up to ~2e-6 of the unit
# cube (the render check's distances agree to ~1e-6 relative).  At grid
# resolution R that moves a weight by up to 3 R x 2e-6 (3 axes), ~5e-2 at
# R = 8193; and a dense level's bf16-rounded frac can round the other way,
# one bf16 step (2^-7) of a weight.  The tables, and the first dense layer,
# whose weight gradient multiplies the features interpolated at those
# positions, are held to that bound.
POS_ERR = 2e-6


def table_atol_frac(spec):
    return max(3 * max(spec.cuda_resolutions) * POS_ERR, 2.0**-7)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def gpu_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, torch, warmup=3, reps=10):
    """Median device time of fn() in ms, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def wsum_library(torch, table, idx, w):
    """The torch sequence the fused gather replaces, from library calls:
    index_select, the product with the weights, the sum over corners."""
    rows = torch.index_select(table, 1, idx.reshape(-1))
    return (rows.view(table.shape[0], *idx.shape) * w[None]).sum(dim=1)


def check_wsum(torch, gather, table, idx, w, label):
    """take_wsum_cm against its plain version, with bf16 off and on.
    Returns the max abs error and the max error in ulp of sum |w * row|."""
    worst_abs = worst_ulp = 0.0
    for bf16 in (False, True):
        got = gather.take_wsum_cm(table, idx, w, bf16=bf16)
        want = gather.take_wsum_cm_plain(table, idx, w, bf16=bf16)
        mag = (gather.take_cm_plain(table, idx, bf16=bf16).abs()
               * w[None].abs()).sum(dim=1)
        torch.cuda.synchronize()
        err = (got - want).abs()
        ulp = float((err / mag.clamp_min(1e-30)).max()) / 2.0**-23
        check(bool((err <= WSUM_ULPS * 2.0**-23 * mag).all()),
              f"take_wsum_cm {label} (bf16={bf16}): {ulp:.2f} ulp of "
              f"sum|w*row| from its plain version (limit {WSUM_ULPS})")
        worst_abs = max(worst_abs, float(err.max()))
        worst_ulp = max(worst_ulp, ulp)
        del got, want, mag, err
    return worst_abs, worst_ulp


def check_one_hot(torch, gather, table, idx, gen, label):
    """With one weight 1 and seven 0 the fused gather is take_cm, bitwise."""
    n = idx.shape[1]
    pick = torch.randint(0, 8, (1, n), generator=gen, device=idx.device)
    w = torch.zeros(idx.shape, device=idx.device).scatter_(0, pick, 1.0)
    for bf16 in (False, True):
        check(torch.equal(
            gather.take_wsum_cm(table, idx, w, bf16=bf16),
            gather.take_cm(table, idx.gather(0, pick)[0].contiguous(),
                           bf16=bf16)),
            f"take_wsum_cm {label} (bf16={bf16}) with one-hot weights "
            f"differs from take_cm")


def k4_times(torch, gather, table, idx, w):
    """Times of both entry points on idx [8, N] (take_cm on its M = 8 N
    indices), of their plain versions and library calls, and the bounds."""
    c = table.shape[0]
    flat = idx.reshape(-1)
    m, n = flat.numel(), idx.shape[1]
    touched = int(torch.unique(flat[(flat >= 0)
                                    & (flat < table.shape[1])]).numel())
    take = {
        "M": m, "rows": table.shape[1], "rows_touched": touched,
        "ms": time_ms(lambda: gather.take_cm(table, flat), torch),
        "interleave_ms": time_ms(lambda: gather.interleave_cm(table), torch),
        "plain_ms": time_ms(lambda: gather.take_cm_plain(table, flat), torch),
        "library_ms": time_ms(lambda: torch.index_select(table, 1, flat),
                              torch),
        "bound_ms": (4 * m + 4 * c * m + 4 * c * touched)
        / HBM_BYTES_PER_S * 1e3}
    wsum = {
        "N": n, "rows": table.shape[1], "rows_touched": touched,
        "ms": time_ms(lambda: gather.take_wsum_cm(table, idx, w), torch),
        "plain_ms": time_ms(lambda: gather.take_wsum_cm_plain(table, idx, w),
                            torch),
        "library_ms": time_ms(lambda: wsum_library(torch, table, idx, w),
                              torch),
        "bound_ms": (8 * (4 + 4) * n + 4 * c * n + 4 * c * touched)
        / HBM_BYTES_PER_S * 1e3}
    return take, wsum


def print_k4(label, take, wsum):
    print(f"[kernel] take_cm {label} M={take['M']} rows={take['rows']} "
          f"({take['rows_touched']} touched): {take['ms']:.4f} ms (of which "
          f"interleave {take['interleave_ms']:.4f}; plain "
          f"{take['plain_ms']:.4f}, index_select {take['library_ms']:.4f}, "
          f"bound {take['bound_ms']:.4f})", flush=True)
    print(f"[kernel] take_wsum_cm {label} N={wsum['N']}: {wsum['ms']:.4f} ms "
          f"(plain {wsum['plain_ms']:.4f}, index_select + multiply + sum "
          f"{wsum['library_ms']:.4f}, bound {wsum['bound_ms']:.4f})",
          flush=True)


def kernel_phase(torch, gather):
    """K4 (hash-grid gather), both entry points, at one proposal level's
    real shape on a uniform stream."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((4, HASHED_ROWS), generator=gen, device=dev)
    idx = torch.randint(0, HASHED_ROWS, (PROP_M,), generator=gen,
                        device=dev, dtype=torch.int32)

    # Sentinels (indices >= rows) mixed in: the result must be 0 there.
    sent = idx.clone()
    pos = torch.randint(0, PROP_M, (PROP_M // 97,), generator=gen,
                        device=dev)
    sent[pos] = HASHED_ROWS + (pos % 1000).to(torch.int32)
    sent[:3] = torch.tensor([HASHED_ROWS, HASHED_ROWS + 1, 2**31 - 1],
                            dtype=torch.int32, device=dev)
    max_err = 0.0
    for stream in (sent, idx):
        for bf16 in (False, True):
            got = gather.take_cm(table, stream, bf16=bf16)
            want = gather.take_cm_plain(table, stream, bf16=bf16)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.equal(got, want),
                  f"take_cm (bf16={bf16}) differs from its plain version, "
                  f"max abs err {err}")
            max_err = max(max_err, err)
            del got, want
    check(bool((gather.take_cm(table, sent)[:, :3] == 0).all()),
          "sentinel indices must give zeros")
    # A stream whose length and start rule out the 16-byte path.
    odd = sent[1:PROP_M // 8 - 2]
    check(torch.equal(gather.take_cm(table, odd.contiguous()),
                      gather.take_cm_plain(table, odd)),
          "take_cm on an odd-length stream differs from its plain version")

    # The fused entry on the same streams as [8, N] corners of N points,
    # with weights in [0, 1) as trilinear weights are.
    idx8, sent8 = idx.view(8, -1), sent.view(8, -1)
    w = torch.rand(idx8.shape, generator=gen, device=dev)
    wsum_err, wsum_ulp = check_wsum(torch, gather, table, sent8, w,
                                    "with sentinels")
    all_sent = torch.full((8, 4), HASHED_ROWS, dtype=torch.int32, device=dev)
    check(bool((gather.take_wsum_cm(table, all_sent, w[:, :4].contiguous())
                == 0).all()),
          "a point whose corners are all sentinels must give zeros")
    check_one_hot(torch, gather, table, sent8, gen, "with sentinels")
    odd8, oddw = sent8[:, :100003].contiguous(), w[:, :100003].contiguous()
    err, ulp = check_wsum(torch, gather, table, odd8, oddw, "odd length")
    wsum_err, wsum_ulp = max(wsum_err, err), max(wsum_ulp, ulp)

    # A column slice of a larger table (how the encoder calls both).
    big = torch.randn((4, 3 * HASHED_ROWS), generator=gen, device=dev)
    part = big[:, HASHED_ROWS:2 * HASHED_ROWS]
    sub = idx[:1 << 22]
    check(torch.equal(gather.take_cm(part, sub),
                      gather.take_cm_plain(part, sub)),
          "take_cm on a column slice differs from its plain version")
    sub8 = sub.view(8, -1)
    err, ulp = check_wsum(torch, gather, part, sub8, w[:, :sub8.shape[1]]
                          .contiguous(), "column slice")
    wsum_err, wsum_ulp = max(wsum_err, err), max(wsum_ulp, ulp)
    check_one_hot(torch, gather, part, sub8, gen, "column slice")
    del big, part, sent, sent8, odd, odd8, oddw

    take, wsum = k4_times(torch, gather, table, idx8, w)
    print_k4("uniform", take, wsum)
    # The same at a NeRF level of the chunk and at the two levels of a
    # training microbatch (1500 rays), where the interleave of the level's
    # 2^21 rows, which does not shrink with the stream, weighs most.
    smaller = []
    for label, div in (("nerf level", 4), ("microbatch proposal level", 10),
                       ("microbatch nerf level", 40)):
        n = idx8.shape[1] // div
        t, ws = k4_times(torch, gather, table, idx8[:, :n].contiguous(),
                         w[:, :n].contiguous())
        print_k4(f"uniform, {label}", t, ws)
        smaller.append({"shape": label, "take_cm": t, "take_wsum_cm": ws})
    print(f"[kernel] take_wsum_cm max abs err {wsum_err:.3g}, "
          f"{wsum_ulp:.2f} ulp of sum|w*row| (limit {WSUM_ULPS})",
          flush=True)
    wsum.update(max_abs_err=wsum_err, max_err_ulp_of_sum_abs=wsum_ulp,
                bound_by="bytes")
    return dict(
        take,
        name="take_cm / take_wsum_cm (hash-grid gather, K4; the second "
             "entry point fuses the 8-corner weighted sum)",
        route="cuda",
        source="ucnerf_tpu_torch/csrc/gather.cu",
        replaces="ucnerf_tpu/ops/gather.py:129",
        max_abs_err=max_err,
        bound_by="bytes",
        shape={"C": 4, "rows": HASHED_ROWS, "M": PROP_M},
        take_wsum_cm=wsum, smaller_shapes=smaller)


def grid_specs(configs, hashgrid):
    """The hash-grid specs and points per level of one training microbatch
    of configs.waymo(): (name, spec, rays * samples * 6 hex points)."""
    cfg = configs.waymo()
    rays = cfg.batch_size // cfg.microbatches
    out = []
    for name, mlp, samples in (
            ("proposal", cfg.prop_mlp.with_grid(
                cfg.model.prop_desired_grid_size[0]),
             cfg.model.num_prop_samples),
            ("nerf", cfg.nerf_mlp, cfg.model.num_nerf_samples)):
        spec = hashgrid.HashGridSpec(
            num_levels=mlp.grid_num_levels, level_dim=mlp.grid_level_dim,
            base_resolution=mlp.grid_base_resolution,
            desired_resolution=mlp.grid_desired_resolution,
            log2_hashmap_size=mlp.grid_log2_hashmap_size)
        out.append((name, spec, rays * samples * 6))
    return out


def check_scatter(torch, label, run, want64):
    """run() twice (bitwise equal), then against the float64 plain
    version.  Returns the max abs error."""
    got = run().clone()
    again = run()
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"{label}: two launches differ")
    err = (got.double() - want64).abs()
    scale = float(want64.abs().max())
    tol = SCATTER_RTOL * want64.abs() + SCATTER_ATOL_FRAC * scale
    check(bool((err <= tol).all()),
          f"{label}: max abs err {float(err.max())} vs float64 plain "
          f"(rtol {SCATTER_RTOL}, atol {SCATTER_ATOL_FRAC} x {scale})")
    return float(err.max())


def dense_walks(torch, starts, level_offsets, strides):
    """Each dense row's K2 walk: the sum of its 8 corner runs."""
    runs = (starts[1:] - starts[:-1]).long()
    walks = torch.zeros_like(runs)
    for l, s in enumerate(strides):
        lo, hi = level_offsets[l], level_offsets[l + 1]
        for k in range(8):
            off = (k & 1) + ((k >> 1) & 1) * s + ((k >> 2) & 1) * s * s
            if off < hi - lo:
                walks[lo + off:hi] += runs[lo:hi - off]
    return walks


def walk_stats(torch, walks, tiers):
    """Percentiles of the rows' walk lengths, and the share of rows and of
    the walked updates that each tier (thread, warp, block) takes."""
    srt = torch.sort(walks.long()).values
    n = srt.numel()
    pct = {f"p{q:g}": int(srt[min(n - 1, int(q / 100 * (n - 1)))])
           for q in (50, 90, 99, 99.9)}
    thread, warp = tiers
    total = max(int(srt.sum()), 1)
    share = {}
    for tier, sel in (("thread", srt <= thread),
                      ("warp", (srt > thread) & (srt <= warp)),
                      ("block", srt > warp)):
        share[tier] = {"rows": float(sel.float().mean()),
                       "walk": int(srt[sel].sum()) / total}
    return dict(pct, max=int(srt[-1]), mean=float(srt.double().mean()),
                rows=n, tiers=share)


def fmt_walks(st):
    return (f"walks p50/p90/p99/p99.9/max {st['p50']}/{st['p90']}/"
            f"{st['p99']}/{st['p99.9']}/{st['max']} (mean {st['mean']:.2f}), "
            f"rows by tier thread/warp/block "
            f"{st['tiers']['thread']['rows']:.4f}/"
            f"{st['tiers']['warp']['rows']:.4f}/"
            f"{st['tiers']['block']['rows']:.4f}")


def check_run_starts(torch, scatter):
    """run_starts against searchsorted, bitwise, where the big streams do not
    reach: no keys, long gaps (filled by a warp), keys on the first and last
    rows, one key."""
    dev = torch.device("cuda")
    rows = 1 << 20
    for keys in ([], [0], [rows - 1], [5, 5, 100_000, 100_001, rows - 1],
                 list(range(0, rows, 33)), [7] * 1000 + [70_000] * 3):
        k = torch.tensor(keys, dtype=torch.int32, device=dev)
        check(torch.equal(scatter.run_starts(k, rows),
                          scatter.run_starts_plain(k, rows)),
              f"run_starts differs from searchsorted on {len(keys)} keys")


def scatter_phase(torch, scatter, hashgrid, configs):
    """K1, K2 and K3 at the shapes of one training microbatch of each grid,
    and K5 at the NeRF grid's hashed stream."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    c = 4
    check_run_starts(torch, scatter)
    k1, k1p, k2, k3, k3p = ({"ms": 0.0, "prep_ms": 0.0, "plain_ms": 0.0,
                             "library_ms": 0.0, "bound_ms": 0.0,
                             "max_abs_err": 0.0, "per_call": []}
                            for _ in range(5))
    k1.update(torch_sequence_ms=0.0, run_starts_ms=0.0, searchsorted_ms=0.0)
    k3.update({k: 0.0 for k in K3_FUSED_SUMS})
    k3p.update(pack_ms=0.0, pack_bound_ms=0.0)
    for name, spec, hm in grid_specs(configs, hashgrid):
        nd = spec.dense_prefix
        dense_rows = spec.offsets[nd]
        # K1: 8 corner updates per point in each hashed level's row range.
        hashed_rows = spec.table_rows - dense_rows
        idx = torch.cat([torch.randint(
            spec.offsets[l] - dense_rows, spec.offsets[l + 1] - dense_rows,
            (8 * hm,), generator=gen, device=dev, dtype=torch.int32)
            for l in range(nd, spec.num_levels)])
        idx[:SKEW] = idx[0]
        m = idx.numel()
        values = torch.randn((c, m), generator=gen, device=dev)
        out = torch.empty((c, hashed_rows), device=dev)
        perm, starts = scatter.sort_rows(idx, hashed_rows)
        want64 = scatter.scatter_add_cm_plain(values.double(), idx,
                                              hashed_rows)
        # The wrapper as the training step calls it (sort, runs and launch,
        # into a given buffer), then the launch alone on a prepared sort,
        # which is what the times below split.
        err = max(
            check_scatter(torch, f"K1 {name} (wrapper)",
                          lambda: scatter.scatter_add_cm(
                              values, idx, hashed_rows, out=out), want64),
            check_scatter(torch, f"K1 {name}",
                          lambda: scatter.segment_sum_cm(values, perm, starts,
                                                         out), want64))
        del want64
        idx64 = idx.long()
        call = {
            "grid": name, "M": m, "rows": hashed_rows,
            "ms": time_ms(lambda: scatter.segment_sum_cm(values, perm,
                                                         starts, out), torch),
            "prep_ms": time_ms(lambda: scatter.sort_rows(idx, hashed_rows),
                               torch),
            "plain_ms": time_ms(lambda: scatter.scatter_add_cm_plain(
                values, idx, hashed_rows, out), torch),
            "library_ms": time_ms(lambda: out.zero_().index_add_(
                1, idx64, values), torch),
            "bound_ms": (m * (8 + 4 * c) + (hashed_rows + 1) * 4
                         + hashed_rows * 4 * c) / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err}
        # K1's fused entry on the same keys, as the f32 step launches it:
        # per-level feature grads and corner weights in [0, 1).
        lh = spec.num_levels - nd
        g = torch.randn((lh, c, hm), generator=gen, device=dev)
        w = torch.rand((lh, 8, hm), generator=gen, device=dev)
        callw = wsum_call(torch, scatter, f"K1 fused {name}", g, w, idx,
                          hashed_rows)
        callw["grid"] = name
        # K3's fused entry on the same updates, as the bf16 step launches it.
        callf = wsum_packed_call(torch, scatter, f"K3 fused {name}", g, w,
                                 idx, hashed_rows, callw["ms"])
        callf["grid"] = name
        del g, w
        # K3 on the same stream: the updates rounded to bf16 and packed.
        rounded = values.to(torch.bfloat16).float()
        packed = scatter.pack_bf16_pairs(values)
        check(torch.equal(scatter.unpack_bf16_pairs(packed), rounded),
              f"K3 {name}: pack -> unpack differs from the bf16 rounding")
        want64 = scatter.scatter_add_cm_plain(rounded.double(), idx,
                                              hashed_rows)
        errp = max(
            check_scatter(torch, f"K3 {name} (wrapper)",
                          lambda: scatter.scatter_add_packed_cm(
                              values, idx, hashed_rows, out=out), want64),
            check_scatter(torch, f"K3 {name} (wrapper, new buffer)",
                          lambda: scatter.scatter_add_packed_cm(
                              values, idx, hashed_rows), want64),
            check_scatter(torch, f"K3 {name}",
                          lambda: scatter.packed_sum_cm(packed, perm, starts,
                                                        out), want64))
        del want64
        # The same walk in the same order: K3 is K1 on the rounded updates,
        # bit for bit.
        check(torch.equal(
            scatter.packed_sum_cm(packed, perm, starts, out),
            scatter.segment_sum_cm(rounded, perm, starts,
                                   torch.empty_like(out))),
            f"K3 {name}: differs from K1 on the bf16-rounded updates")
        callp = {
            "grid": name, "M": m, "rows": hashed_rows,
            "ms": time_ms(lambda: scatter.packed_sum_cm(packed, perm, starts,
                                                        out), torch),
            "pack_ms": time_ms(lambda: scatter.pack_bf16_pairs(values),
                               torch),
            "prep_ms": time_ms(lambda: scatter.sort_rows(idx, hashed_rows),
                               torch),
            "plain_ms": time_ms(lambda: scatter.scatter_add_packed_cm_plain(
                values, idx, hashed_rows, out), torch),
            "library_ms": time_ms(lambda: out.zero_().index_add_(
                1, idx64, rounded), torch),
            "bound_ms": (m * (8 + 2 * c) + (hashed_rows + 1) * 4
                         + hashed_rows * 4 * c) / HBM_BYTES_PER_S * 1e3,
            "pack_bound_ms": m * (4 * c + 2 * c) / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": errp}
        del rounded, packed
        if name == "nerf":
            k5 = chunked_phase(torch, scatter, values, idx, hashed_rows,
                               perm, starts, call)
        del values, out, perm, starts, idx, idx64
        # K2: one sample per point in a random cell of each dense level.
        bases = []
        for l in range(nd):
            r, s = spec.cuda_resolutions[l], spec.dense_strides[l]
            xyz = torch.randint(0, r, (3, hm), generator=gen, device=dev)
            bases.append(xyz[0] + xyz[1] * s + xyz[2] * s * s
                         + spec.offsets[l])
        base = torch.cat(bases).to(torch.int32)
        base[:SKEW] = base[0]
        md = base.numel()
        g = torch.randn((c, md), generator=gen, device=dev)
        fr = torch.rand((3, md), generator=gen, device=dev)
        calld = dense_call(torch, scatter, f"K2 {name}", g, fr, base,
                           spec.offsets[:nd + 1], spec.dense_strides, hm)
        calld["grid"] = name
        del g, fr, base
        add_calls(((k1, callw), (k1p, call), (k2, calld), (k3, callf),
                   (k3p, callp)))
        print_scatter(f"K1 fused {name}", callw)
        print_packed(f"K3 fused {name}", callf)
        for label, rec in (("K1", call), ("K2", calld), ("K3", callp)):
            print_scatter(f"{label} {name}", rec)
    torch.cuda.empty_cache()
    k1.update(name="scatter_add_wsum_cm / scatter_add_cm (hashed-level "
              "table gradient, K1; the fused entry, which the f32 step "
              "launches, forms w*g in the kernel)",
              route="cuda", source="ucnerf_tpu_torch/csrc/scatter.cu",
              replaces="ucnerf_tpu/ops/scatter.py:127", bound_by="bytes",
              scatter_add_cm=k1p)
    k2.update(name="scatter_add_dense_cm (dense-level table gradient, K2)",
              route="cuda", source="ucnerf_tpu_torch/csrc/scatter.cu",
              replaces="ucnerf_tpu/ops/scatter.py:604", bound_by="bytes")
    k3.update(name="scatter_add_wsum_packed_cm / scatter_add_packed_cm "
              "(bf16-packed hashed-level table gradient, K3; the fused "
              "entry, which the bf16 step launches, forms, rounds and packs "
              "w*g in the kernel)", route="cuda",
              source="ucnerf_tpu_torch/csrc/scatter.cu",
              replaces="ucnerf_tpu/ops/scatter.py:406", bound_by="bytes",
              scatter_add_packed_cm=k3p)
    return k1, k2, k3, k5


def wsum_call(torch, scatter, label, g, w, keys, rows):
    """K1's fused entry on (g, w, keys): through its wrapper and its launch
    half against the float64 plain version, bitwise across launches and
    against K1 on the torch-formed w*g; times, bound and walk lengths."""
    out = torch.empty((g.shape[1], rows), device=g.device)
    perm, starts = scatter.sort_rows(keys, rows)
    want64 = scatter.scatter_add_wsum_cm_plain(g.double(), w.double(), keys,
                                               rows)
    err = max(
        check_scatter(torch, f"{label} (wrapper)",
                      lambda: scatter.scatter_add_wsum_cm(g, w, keys, rows,
                                                          out=out), want64),
        check_scatter(torch, label,
                      lambda: scatter.wsum_sum_cm(g, w, perm, starts, out),
                      want64))
    del want64
    rec = wsum_times(torch, scatter, g, w, keys, perm, starts, out)
    rec.update(max_abs_err=err, walks=walk_stats(
        torch, starts[1:] - starts[:-1], scatter.RUN_TIERS))
    return rec


def wsum_packed_call(torch, scatter, label, g, w, keys, rows, fused_k1_ms):
    """K3's fused entry on (g, w, keys): through its wrapper and its launch
    half against the float64 sum of the torch-rounded updates, bitwise
    across launches and against K3 on the torch-formed, rounded updates;
    times beside the torch sequence it replaces (formation, pack, K3),
    index_add_ and the fused K1 entry (`fused_k1_ms`, timed on the same
    inputs), and its bound."""
    levels, c, n = g.shape
    m = keys.numel()
    out = torch.empty((c, rows), device=g.device)
    perm, starts = scatter.sort_rows(keys, rows)
    formed = scatter._wsum_values(g, w)
    packed = scatter.pack_bf16_pairs(formed)
    rounded = scatter.unpack_bf16_pairs(packed)
    want64 = scatter.scatter_add_cm_plain(rounded.double(), keys, rows)
    err = max(
        check_scatter(torch, f"{label} (wrapper)",
                      lambda: scatter.scatter_add_wsum_packed_cm(
                          g, w, keys, rows, out=out), want64),
        check_scatter(torch, label,
                      lambda: scatter.wsum_packed_sum_cm(g, w, perm, starts,
                                                         out), want64))
    del want64
    check(torch.equal(scatter.wsum_packed_sum_cm(g, w, perm, starts, out),
                      scatter.packed_sum_cm(packed, perm, starts,
                                            torch.empty_like(out))),
          f"{label}: differs from K3 on the torch-formed, rounded updates")
    keys64 = keys.long()
    words = m * c // 2
    bound = (m * (8 + 4) + levels * n * 4 * c + (rows + 1) * 4
             + rows * 4 * c) / HBM_BYTES_PER_S * 1e3
    rec = {"M": m, "rows": rows,
           "ms": time_ms(lambda: scatter.wsum_packed_sum_cm(
               g, w, perm, starts, out), torch),
           "prep_ms": time_ms(lambda: scatter.sort_rows(keys, rows), torch),
           "plain_ms": time_ms(lambda: scatter.scatter_add_wsum_packed_cm_plain(
               g, w, keys, rows, out), torch),
           "library_ms": time_ms(lambda: out.zero_().index_add_(
               1, keys64, rounded), torch),
           "torch_sequence_ms": time_ms(lambda: scatter.packed_sum_cm(
               scatter.pack_bf16_pairs(scatter._wsum_values(g, w)), perm,
               starts, out), torch),
           "formation_ms": time_ms(lambda: scatter._wsum_values(g, w), torch),
           "pack_ms": time_ms(lambda: scatter.pack_bf16_pairs(formed), torch),
           "planar_ms": time_ms(lambda: scatter.packed_sum_cm(
               packed, perm, starts, out), torch),
           "fused_k1_ms": fused_k1_ms,
           # The same inputs and output as K1's fused entry.
           "bound_ms": bound,
           # Plus the records' round trip: written and read once.
           "bound_with_records_ms": bound
           + 2 * words * 4 / HBM_BYTES_PER_S * 1e3,
           "max_abs_err": err}
    del formed, packed, rounded, keys64
    return rec


def print_packed(label, rec):
    print(f"[kernel] {label} M={rec['M']} rows={rec['rows']}: "
          f"{rec['ms']:.4f} ms (prep {rec['prep_ms']:.4f}; formation + pack "
          f"+ K3 {rec['torch_sequence_ms']:.4f} = {rec['formation_ms']:.4f} + "
          f"{rec['pack_ms']:.4f} + {rec['planar_ms']:.4f}; fused K1 "
          f"{rec['fused_k1_ms']:.4f}; plain {rec['plain_ms']:.4f}, "
          f"index_add_ {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f}"
          f" ({rec['bound_with_records_ms']:.4f} with the records)), max abs "
          f"err {rec['max_abs_err']:.3g}", flush=True)


def dense_call(torch, scatter, label, g, fr, base, level_offsets, strides,
               level_len):
    """K2 on (g, fr, base): through its wrapper and its launch half against
    the float64 plain version, bitwise across launches; times against
    index_add_ over the corner-expanded updates, bound and walk lengths."""
    c, md = g.shape
    rows = level_offsets[-1]
    out = torch.empty((c, rows), device=g.device)
    kw = dict(level_len=level_len, strides=strides)
    perm, starts = scatter.sort_rows(base, rows)
    want64 = scatter.scatter_add_dense_cm_plain(g.double(), fr, base, rows,
                                                **kw)
    err = max(
        check_scatter(torch, f"{label} (wrapper)",
                      lambda: scatter.scatter_add_dense_cm(
                          g, fr, base, rows, out=out,
                          level_offsets=level_offsets, **kw), want64),
        check_scatter(torch, label,
                      lambda: scatter.dense_sum_cm(
                          g, fr, perm, starts, level_offsets, strides, out),
                      want64))
    del want64
    # The library yardstick: index_add_ over the corner-expanded updates.
    frb = fr.to(torch.bfloat16).float()
    vals8, idx8 = [], []
    for l, s in enumerate(strides):
        sl = slice(l * level_len, (l + 1) * level_len)
        for corner in range(8):
            off = ((corner & 1) + ((corner >> 1) & 1) * s
                   + ((corner >> 2) & 1) * s * s)
            vals8.append(scatter._dense_weights(frb[:, sl], corner)
                         * g[:, sl])
            idx8.append(base[sl].long() + off)
    vals8, idx8 = torch.cat(vals8, dim=1), torch.cat(idx8)
    rec = {
        "M": md, "rows": rows,
        "ms": time_ms(lambda: scatter.dense_sum_cm(
            g, fr, perm, starts, level_offsets, strides, out), torch),
        "prep_ms": time_ms(lambda: scatter.sort_rows(base, rows), torch),
        "plain_ms": time_ms(lambda: scatter.scatter_add_dense_cm_plain(
            g, fr, base, rows, out=out, **kw), torch),
        "library_ms": time_ms(lambda: out.zero_().index_add_(
            1, idx8, vals8), torch),
        "bound_ms": (md * (8 + 12 + 4 * c) + (rows + 1) * 4
                     + rows * 4 * c) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": err,
        "walks": walk_stats(torch, dense_walks(torch, starts, level_offsets,
                                               strides),
                            scatter.DENSE_TIERS)}
    del vals8, idx8, frb
    return rec


def wsum_times(torch, scatter, g, w, keys, perm, starts, out):
    """Times of K1's fused entry on a prepared sort, of its prep (stable sort
    and run starts, and each apart, beside searchsorted), of the torch
    sequence it replaces (multiply, transpose copy, K1), of its plain
    version and of index_add_ on the formed updates; and its bound.  Checks
    that it is K1 on the torch-formed w*g, bit for bit."""
    formed = scatter._wsum_values(g, w)
    check(torch.equal(scatter.wsum_sum_cm(g, w, perm, starts, out),
                      scatter.segment_sum_cm(formed, perm, starts,
                                             torch.empty_like(out))),
          "K1's fused entry differs from K1 on the torch-formed w*g")
    levels, c, n = g.shape
    m, rows = keys.numel(), out.shape[1]
    sorted_keys = torch.sort(keys, stable=True).values
    check(torch.equal(scatter.run_starts(sorted_keys, rows), starts),
          "run_starts differs from the prepared starts")
    check(torch.equal(scatter.run_starts_plain(sorted_keys, rows), starts),
          "run_starts differs from searchsorted")
    keys64 = keys.long()
    rec = {
        "M": m, "rows": rows,
        "ms": time_ms(lambda: scatter.wsum_sum_cm(g, w, perm, starts, out),
                      torch),
        "prep_ms": time_ms(lambda: scatter.sort_rows(keys, rows), torch),
        "sort_ms": time_ms(lambda: torch.sort(keys, stable=True), torch),
        "run_starts_ms": time_ms(lambda: scatter.run_starts(sorted_keys,
                                                            rows), torch),
        "searchsorted_ms": time_ms(lambda: scatter.run_starts_plain(
            sorted_keys, rows), torch),
        "torch_sequence_ms": time_ms(lambda: scatter.segment_sum_cm(
            scatter._wsum_values(g, w), perm, starts, out), torch),
        "plain_ms": time_ms(lambda: scatter.scatter_add_wsum_cm_plain(
            g, w, keys, rows, out), torch),
        "library_ms": time_ms(lambda: out.zero_().index_add_(1, keys64,
                                                             formed), torch),
        # perm and weight per update, the grads once, run starts, output.
        "bound_ms": (m * (8 + 4) + levels * n * 4 * c + (rows + 1) * 4
                     + rows * 4 * c) / HBM_BYTES_PER_S * 1e3}
    del formed, keys64
    return rec


def add_calls(pairs):
    """Adds each call's times into its kernel's totals over the grids."""
    summed = dict.fromkeys(("ms", "prep_ms", "plain_ms", "library_ms",
                            "bound_ms", "pack_ms", "pack_bound_ms",
                            "torch_sequence_ms", "run_starts_ms",
                            "searchsorted_ms", *K3_FUSED_SUMS))
    for entry, rec in pairs:
        entry["per_call"].append(rec)
        for k in summed:
            if k in rec and k in entry:
                entry[k] += rec[k]
        entry["max_abs_err"] = max(entry["max_abs_err"], rec["max_abs_err"])


def print_scatter(label, rec):
    extra = ""
    if "pack_ms" in rec:
        extra = (f"pack {rec['pack_ms']:.4f} (bound "
                 f"{rec['pack_bound_ms']:.4f}), ")
    if "torch_sequence_ms" in rec:
        extra = (f"multiply + transpose copy + K1 "
                 f"{rec['torch_sequence_ms']:.4f}, sort "
                 f"{rec['sort_ms']:.4f} + run starts "
                 f"{rec['run_starts_ms']:.4f} (searchsorted "
                 f"{rec['searchsorted_ms']:.4f}), ")
    print(f"[kernel] {label} M={rec['M']} rows={rec['rows']}: "
          f"{rec['ms']:.4f} ms ({extra}prep {rec['prep_ms']:.4f}, "
          f"plain {rec['plain_ms']:.4f}, index_add_ "
          f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f}), "
          f"max abs err {rec['max_abs_err']:.3g}"
          + (f"; {fmt_walks(rec['walks'])}" if "walks" in rec else ""),
          flush=True)


def chunked_corner_cases(torch, scatter):
    """K5 where the big stream does not reach: every channel count it takes,
    a last tile that is not full, and in one tile several rows, two of them
    on a tile edge, whose runs in a chunk pass the one-thread limit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    rows, hot = 2500, torch.tensor([1020, 1023, 1024, 1500, 2047, 2499],
                                   device=dev)
    for c in (1, 2, 3, 4, 8):
        for chunks in (1, 3, 24):
            m = chunks * 20000
            idx = torch.randint(0, rows, (m,), generator=gen, device=dev)
            pick = torch.randint(0, 2 * hot.numel(), (m,), generator=gen,
                                 device=dev)
            idx = torch.where(pick < hot.numel(),
                              hot[pick.clamp_max(hot.numel() - 1)], idx)
            idx = idx.to(torch.int32)
            runs = torch.bincount(idx[:m // chunks].long(), minlength=rows)
            check(int((runs > scatter.LONG_RUN).sum()) >= hot.numel(),
                  "K5 corner case: the hot rows' runs are not long")
            values = torch.randn((c, m), generator=gen, device=dev)
            check_scatter(
                torch, f"K5 corner case C={c} G={chunks}",
                lambda: scatter.scatter_add_chunked_cm(
                    values, idx, rows, num_chunks=chunks),
                scatter.scatter_add_chunked_cm_plain(values.double(), idx,
                                                     rows))


def chunked_phase(torch, scatter, values, idx, rows, perm, starts, k1_call):
    """K5 on a stream K1 was just held at: against the float64 plain
    version, bitwise across two launches, and against K1's result, at each
    chunk count; its times beside K1's on the same stream."""
    chunked_corner_cases(torch, scatter)
    c, m = values.shape
    want64 = scatter.scatter_add_chunked_cm_plain(values.double(), idx, rows)
    k1_out = scatter.segment_sum_cm(
        values, perm, starts, torch.empty((c, rows), device=values.device))
    out = torch.empty((c, rows), device=values.device)
    idx64 = idx.long()
    plain_ms = time_ms(lambda: scatter.scatter_add_chunked_cm_plain(
        values, idx, rows), torch)
    library_ms = time_ms(lambda: out.zero_().index_add_(1, idx64, values),
                         torch)
    calls = []
    for chunks in K5_CHUNKS:
        keys, cperm = scatter.sort_chunks(idx, chunks)
        err = max(
            check_scatter(torch, f"K5 G={chunks} (wrapper)",
                          lambda: scatter.scatter_add_chunked_cm(
                              values, idx, rows, num_chunks=chunks), want64),
            check_scatter(torch, f"K5 G={chunks}",
                          lambda: scatter.chunked_sum_cm(values, keys, cperm,
                                                         chunks, out),
                          want64))
        diff = (out - k1_out).abs()
        tol = SCATTER_RTOL * k1_out.abs() + SCATTER_ATOL_FRAC * float(
            k1_out.abs().max())
        check(bool((diff <= tol).all()),
              f"K5 G={chunks} differs from K1 by {float(diff.max())}")
        rec = {
            "num_chunks": chunks, "M": m, "rows": rows,
            "ms": time_ms(lambda: scatter.chunked_sum_cm(
                values, keys, cperm, chunks, out), torch, reps=5),
            "prep_ms": time_ms(lambda: scatter.sort_chunks(idx, chunks),
                               torch),
            "k1_ms": k1_call["ms"], "k1_prep_ms": k1_call["prep_ms"],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": (m * (4 + 8 + 4 * c) + rows * 4 * c)
            / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "max_abs_diff_from_k1": float(diff.max())}
        calls.append(rec)
        print(f"[kernel] K5 G={chunks} M={m} rows={rows}: {rec['ms']:.4f} ms "
              f"(prep {rec['prep_ms']:.4f}; K1 on the same stream "
              f"{rec['k1_ms']:.4f} + prep {rec['k1_prep_ms']:.4f}; plain "
              f"{plain_ms:.4f}, index_add_ {library_ms:.4f}, bound "
              f"{rec['bound_ms']:.4f}), max abs err {err:.3g}", flush=True)
        del keys, cperm
    # scatter_add_partial_cm has no kernel of its own: K1 per sub-chunk.
    part = scatter.scatter_add_partial_cm(values, idx, rows, num_chunks=2)
    diff = (part.double() - want64).abs()
    tol = SCATTER_RTOL * want64.abs() + SCATTER_ATOL_FRAC * float(
        want64.abs().max())
    check(bool((diff <= tol).all()),
          f"scatter_add_partial_cm: max abs err {float(diff.max())}")
    del part, diff, tol
    # The line's numbers are those of the last chunk count (24, the JAX
    # package's best configuration); every count is under per_call.
    k5 = dict(calls[-1], per_call=calls)
    k5.update(name="scatter_add_chunked_cm (chunk-local sorts, K5; no "
              "caller on any path)", route="cuda",
              source="ucnerf_tpu_torch/csrc/scatter_chunked.cu",
              replaces="ucnerf_tpu/ops/scatter.py:816", bound_by="bytes")
    return k5


def waymo_views(cameras, cfg):
    """Two 480x320 views (Waymo front camera at factor 4)."""
    width, height = VIEW_W, VIEW_H
    k = np.array([[FOCAL, 0, width / 2], [0, FOCAL, height / 2], [0, 0, 1]])
    pixtocam = np.linalg.inv(k)
    views = []
    for yaw, tx in ((0.0, 0.0), (0.3, 0.2)):
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pose = np.concatenate([rot, [[tx], [0.0], [0.0]]], axis=1)
        views.append(cameras.pose_image_batch(pixtocam, pose, width, height,
                                              cfg.near, cfg.far))
    return views


def slice_phase(torch, gather, scatter, configs, cameras, step):
    cfg = configs.waymo()
    model = step.init_model(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".table"):
                p.normal_(0.0, 0.1, generator=gen)
            elif "output_linear" in name or "latent_code" in name:
                # Zero-initialised leaves: random, so that every parameter
                # shapes the render and gets a gradient.
                p.normal_(0.0, 0.3, generator=gen)
    eval_step = step.make_eval_step(model, cfg, seed=0)
    views = waymo_views(cameras, cfg)
    num_rays = [v["origins"].shape[0] * v["origins"].shape[1] for v in views]
    chunks = sum(-(-n // cfg.render_chunk_size) for n in num_rays)

    # One warm-up chunk (cuBLAS handles, the allocator's pools, the kernel
    # library's load) before the counts are set to 0 and the clock starts.
    warm = {k: torch.from_numpy(np.array(
        v.reshape((-1,) + v.shape[2:])[:cfg.render_chunk_size])).cuda()
        for k, v in views[0].items()}
    eval_step(warm, 1.0, 0)
    del warm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(gather, scatter)
    outs, secs = [], []
    for v in views:
        t0 = time.perf_counter()
        outs.append(step.render_image(eval_step, v, cfg, eval_camidx=0))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    by_kernel = read_launches(gather, scatter)
    check_fused_entry(gather, "render")
    launches = by_kernel["K4"]
    peak = torch.cuda.max_memory_allocated()
    # A render is a function of the weights and the rays: the first view
    # again, after the second, through the same eval step.
    again = step.render_image(eval_step, views[0], cfg, eval_camidx=0)
    differ = [k for k in outs[0] if not np.array_equal(outs[0][k], again[k])]
    check(not differ, f"a second render of one view differs in {differ}")
    del again

    levels = cfg.nerf_mlp.grid_num_levels + sum(
        cfg.prop_mlp.with_grid(g).grid_num_levels
        for g in cfg.model.prop_desired_grid_size[:cfg.model.num_levels - 1])
    check(launches == levels * chunks,
          f"K4 launched {launches} times, expected {levels} per chunk "
          f"x {chunks} chunks")
    check(all(n == 0 for k, n in by_kernel.items() if k != "K4"),
          f"a render launched a backward kernel: {by_kernel}")
    for out in outs:
        check(out["rgb"].shape == (VIEW_H, VIEW_W, 3),
              f"rgb {out['rgb'].shape}")
        for k in ("depth", "acc", "distance_mean", "distance_median"):
            check(out[k].shape == (VIEW_H, VIEW_W), f"{k} {out[k].shape}")
        for k, val in out.items():
            check(np.isfinite(val).all(), f"{k} has non-finite values")
    print(f"[slice] waymo render {len(views)}x{VIEW_W}x{VIEW_H}, "
          f"chunk {cfg.render_chunk_size}, "
          f"render_subchunks {cfg.render_subchunks}: "
          f"{[round(s, 3) for s in secs]} s, rays/s "
          f"{[round(n / s, 1) for n, s in zip(num_rays, secs)]}, "
          f"K4 (take_wsum_cm) launches {launches} ({levels}/chunk x "
          f"{chunks}), "
          f"peak {peak / 2**30:.2f} GiB; view 0 rendered again: bitwise "
          f"equal", flush=True)

    # 64-ray chunk: the card (kernels) against the CPU (plain versions).
    stride = VIEW_W * VIEW_H // 64
    flat = {k: np.ascontiguousarray(v.reshape((-1,) + v.shape[2:])[::stride])
            for k, v in views[0].items()}
    rand_vec = np.random.default_rng(3).normal(size=(64, 3)).astype(
        np.float32)
    cpu_model = copy.deepcopy(model).cpu()
    cpu_step = step.make_eval_step(cpu_model, cfg, seed=0)
    results = []
    for ev, dev in ((eval_step, "cuda"), (cpu_step, "cpu")):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in flat.items()}
        out = ev(batch, 1.0, 0, torch.from_numpy(rand_vec).to(dev))
        results.append({k: v.cpu().numpy() for k, v in out.items()})
    gpu, cpu = results
    errs = {}
    for k in cpu:
        a, b = gpu[k], cpu[k]
        ok = np.ones(a.shape, bool)
        if k == "depth":  # the acc < 0.6 clamp is a step: skip rays at it.
            ok = np.abs(cpu["acc"] - 0.6) > 1e-3
        errs[k] = float(np.abs(a - b)[ok].max())
        check(np.allclose(a[ok], b[ok], rtol=RENDER_RTOL, atol=RENDER_ATOL),
              f"GPU vs CPU {k}: max abs err {errs[k]}")
    print(f"[slice] 64-ray GPU vs CPU max abs err {errs} "
          f"(atol {RENDER_ATOL}, rtol {RENDER_RTOL})", flush=True)
    res = {"rays_per_s": [n / s for n, s in zip(num_rays, secs)],
           "seconds": secs, "chunks": chunks, "launches": by_kernel,
           "launches_per_chunk": levels, "peak_bytes": peak,
           "render_subchunks": cfg.render_subchunks,
           "second_render_bitwise_equal": True,
           "gpu_vs_cpu_max_abs_err": errs}
    return res, eval_step, views, cfg, model


def record_k4_calls(torch, gather, hashgrid, run):
    """(table, idx, w) of every fused K4 call the encoder makes in run(),
    each launched as usual."""
    recorded = []

    def recorder(table, idx, w, bf16=False):
        recorded.append((table.detach(), idx, w))
        return gather.take_wsum_cm(table, idx, w, bf16=bf16)

    # The encoder reaches the kernels through its module's `gather` name.
    hashgrid.gather = types.SimpleNamespace(take_cm=gather.take_cm,
                                            take_wsum_cm=recorder)
    try:
        run()
    finally:
        hashgrid.gather = gather
    torch.cuda.synchronize()
    return recorded


def most_rows(torch, calls):
    """The recorded call whose indices touch the most rows."""
    return max(calls, key=lambda t: int(torch.unique(t[1]).numel()))


def hold_k4(torch, gather, table, idx, w, gen, label, print_label):
    """K4's two entry points held against their plain versions on recorded
    indices and weights (take_cm bitwise, take_wsum_cm within WSUM_ULPS and
    bitwise take_cm for one-hot weights), then timed."""
    check(torch.equal(gather.take_cm(table, idx),
                      gather.take_cm_plain(table, idx)),
          f"take_cm on the {label}'s indices differs from its plain version")
    err, ulp = check_wsum(torch, gather, table, idx, w, label)
    check_one_hot(torch, gather, table, idx, gen, label)
    take, wsum = k4_times(torch, gather, table, idx, w)
    print_k4(print_label, take, wsum)
    wsum.update(max_abs_err=err, max_err_ulp_of_sum_abs=ulp)
    return take, wsum


def real_index_phase(torch, gather, hashgrid, eval_step, view, cfg, model,
                     k4):
    """K4's two entry points on the corner indices and weights of one render
    chunk: those of the proposal level and of the NeRF level with the most
    rows touched.  Recorded from the encoder's own calls.  Then the
    interleave of each grid's table, level by level and in one pass."""
    batch = {k: torch.from_numpy(np.array(
        v.reshape((-1,) + v.shape[2:])[:cfg.render_chunk_size])).cuda()
        for k, v in view.items()}
    recorded = record_k4_calls(torch, gather, hashgrid,
                               lambda: eval_step(batch, 1.0, 0))
    by_n = {}
    for table, idx, w in recorded:
        by_n.setdefault(idx.shape[1], []).append((table, idx, w))
    check(len(by_n) == 2, f"a render chunk's K4 launches have point counts "
          f"{sorted(by_n)}; expected the proposal's and the NeRF field's")
    del recorded
    gen = torch.Generator(device="cuda").manual_seed(10)
    calls = []
    for grid, n in zip(("nerf", "proposal"), sorted(by_n)):
        take, wsum = hold_k4(torch, gather, *most_rows(torch, by_n[n]), gen,
                             f"{grid} level", f"real {grid} level")
        calls.append({"grid": grid, "take_cm": take, "take_wsum_cm": wsum})
    k4["real_indices"] = calls
    # What the other placement of the interleave would cost: the wrappers
    # interleave a level's slice on every launch; once per encode would be
    # one pass over the whole table, handed to the level launches.
    k4["interleave_per_encode"] = []
    for name, module in model.named_modules():
        if not hasattr(module, "grid_spec"):
            continue
        table, offs = module.table.detach(), module.grid_spec.offsets
        rec = {"grid": name, "rows": table.shape[1], "levels": len(offs) - 1,
               "per_level_ms": sum(
                   time_ms(lambda: gather.interleave_cm(table[:, lo:hi]),
                           torch) for lo, hi in zip(offs[:-1], offs[1:])),
               "whole_table_ms": time_ms(
                   lambda: gather.interleave_cm(table), torch)}
        print(f"[kernel] interleave of {name}'s table ({rec['rows']} rows): "
              f"{rec['per_level_ms']:.4f} ms as {rec['levels']} level "
              f"slices, {rec['whole_table_ms']:.4f} ms as one pass",
              flush=True)
        k4["interleave_per_encode"].append(rec)


def real_stream_phase(torch, scatter, hashgrid, losses_lib, model, cfg,
                      batch, k1, k2, k3):
    """K1's fused entry, K3's fused entry and K2 on what the f32 backward of
    one training microbatch hands them, for each grid: the feature grads,
    corner weights and keys of the hashed levels (K3's fused entry takes the
    same inputs in the bf16 backward), and the feature grads, fractional
    coords and corner-0 rows of the dense levels.  Recorded from the
    encoder's own calls; the uniform stream of the kernel phase is the
    worst case for the reads, not for the skew, so the walk lengths are
    reported too."""
    wsum, dense = {}, {}

    def wsum_recorder(g, w, keys, num_rows, out=None):
        wsum.setdefault(num_rows, (g.clone(), w.clone(), keys.clone()))
        return scatter.scatter_add_wsum_cm(g, w, keys, num_rows, out=out)

    def dense_recorder(gvals, fracs, base_idx, num_rows, **kw):
        dense.setdefault(gvals.shape[1], (
            gvals.clone(), fracs.clone(), base_idx.clone(),
            tuple(kw["level_offsets"]), tuple(kw["strides"]),
            kw["level_len"]))
        return scatter.scatter_add_dense_cm(gvals, fracs, base_idx, num_rows,
                                            **kw)

    n = cfg.batch_size // cfg.microbatches
    part = {k: v[:n] for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(12)
    # The encoder reaches the kernels through its module's `scatter` name.
    hashgrid.scatter = types.SimpleNamespace(
        scatter_add_wsum_cm=wsum_recorder,
        scatter_add_dense_cm=dense_recorder,
        scatter_add_wsum_packed_cm=scatter.scatter_add_wsum_packed_cm)
    try:
        renderings, history = model(part, 0.5, None, compute_extras=False,
                                    train=True, generator=gen)
        total, _, _ = losses_lib.compute_all_losses(part, renderings,
                                                    history, cfg)
        total.backward()
        del renderings, history, total
    finally:
        hashgrid.scatter = scatter
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    check(len(wsum) == 2 and len(dense) == 2,
          f"one microbatch's backward gave the fused K1 entry {len(wsum)} "
          f"and K2 {len(dense)} distinct calls; expected one per grid")
    res = {"K1": [], "K2": [], "K3": []}
    # The proposal grid's hashed region is the smaller, its dense stream the
    # longer (128 samples a ray against the NeRF field's 32).
    for grid, rows in zip(("proposal", "nerf"), sorted(wsum)):
        g, w, keys = wsum.pop(rows)
        rec = wsum_call(torch, scatter, f"K1 fused real {grid}", g, w, keys,
                        rows)
        rec["grid"] = grid
        print_scatter(f"K1 fused real {grid}", rec)
        res["K1"].append(rec)
        recp = wsum_packed_call(torch, scatter, f"K3 fused real {grid}", g, w,
                                keys, rows, rec["ms"])
        recp["grid"] = grid
        print_packed(f"K3 fused real {grid}", recp)
        res["K3"].append(recp)
        del g, w, keys
    for grid, md in zip(("nerf", "proposal"), sorted(dense)):
        g, fr, base, offsets, strides, level_len = dense.pop(md)
        rec = dense_call(torch, scatter, f"K2 real {grid}", g, fr, base,
                         offsets, strides, level_len)
        rec["grid"] = grid
        print_scatter(f"K2 real {grid}", rec)
        res["K2"].append(rec)
        del g, fr, base
    torch.cuda.empty_cache()
    k1["real_stream"], k2["real_stream"] = res["K1"], res["K2"]
    k3["real_stream"] = res["K3"]


def train_batch(views, cfg, n, seed):
    """n rays drawn without replacement from the views, with targets made
    with numpy: a smooth colour of the view direction, sky where it points
    up, lossmult 1 and random training-view ids."""
    rng = np.random.default_rng(seed)
    flat = {k: np.concatenate([v[k].reshape((-1,) + v[k].shape[2:])
                               for v in views]) for k in views[0]}
    pick = np.sort(rng.choice(flat["origins"].shape[0], n, replace=False))
    batch = {k: np.ascontiguousarray(v[pick]) for k, v in flat.items()}
    d = batch["viewdirs"]
    batch["rgb"] = np.clip(0.5 + 0.4 * d, 0, 1).astype(np.float32)
    batch["sky_segs"] = (d[:, 1] < -0.15).astype(np.float32)
    batch["lossmult"] = np.ones((n, 1), np.float32)
    batch["cam_idx"] = rng.integers(0, cfg.training_views, n).astype(np.int32)
    return batch


def reset_launches(gather, scatter):
    gather.take_cm.launches = 0
    gather.take_wsum_cm.launches = 0
    scatter.scatter_add_cm.launches = 0
    scatter.scatter_add_wsum_cm.launches = 0
    scatter.scatter_add_dense_cm.launches = 0
    scatter.scatter_add_packed_cm.launches = 0
    scatter.scatter_add_wsum_packed_cm.launches = 0
    scatter.scatter_add_chunked_cm.launches = 0
    scatter.run_starts.launches = 0


def read_launches(gather, scatter):
    """Launches by kernel; K1, K3 and K4 are each one kernel family with two
    entry points, also counted apart; "starts" is the run-starts pass that
    every sort of K1, K2 and K3 ends with."""
    return {"K1": (scatter.scatter_add_cm.launches
                   + scatter.scatter_add_wsum_cm.launches),
            "K1_fused": scatter.scatter_add_wsum_cm.launches,
            "K1_plain": scatter.scatter_add_cm.launches,
            "K2": scatter.scatter_add_dense_cm.launches,
            "K3": (scatter.scatter_add_packed_cm.launches
                   + scatter.scatter_add_wsum_packed_cm.launches),
            "K3_fused": scatter.scatter_add_wsum_packed_cm.launches,
            "K3_planar": scatter.scatter_add_packed_cm.launches,
            "K4": gather.take_cm.launches + gather.take_wsum_cm.launches,
            "K5": scatter.scatter_add_chunked_cm.launches,
            "starts": scatter.run_starts.launches}


# K4's launches on the main paths by entry point, summed over the paths.
K4_BY_ENTRY = {"take_cm": 0, "take_wsum_cm": 0}


def check_fused_entry(gather, label):
    """No sample position carries a gradient on the paths driven here, so
    every K4 launch is the fused entry and none keeps the gathered rows.
    Called once per path, right after the path's launches are read."""
    check(gather.take_cm.launches == 0 and gather.take_wsum_cm.launches > 0,
          f"{label}: take_cm launched {gather.take_cm.launches} times and "
          f"take_wsum_cm {gather.take_wsum_cm.launches}; expected every K4 "
          f"launch to be take_wsum_cm")
    K4_BY_ENTRY["take_cm"] += gather.take_cm.launches
    K4_BY_ENTRY["take_wsum_cm"] += gather.take_wsum_cm.launches


def train_phase(torch, gather, scatter, step, state_lib, model, cfg, batch,
                steps, label):
    """A training slice at full width: one warm-up and `steps` timed steps
    of `cfg` on `model`.  The hashed levels' table gradient goes through K3
    when the config asks for the bf16 backward, else through K1.  Returns
    the results and the table gradients of the first (warm-up) step."""
    bf16 = cfg.nerf_mlp.grid_bwd_value_dtype == "bfloat16"
    check(bf16 == (cfg.prop_mlp.grid_bwd_value_dtype == "bfloat16"),
          "the two fields disagree on grid_bwd_value_dtype")
    state = state_lib.create_train_state(cfg, model)
    train_step = step.make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    state, _ = train_step(state, batch, 0.5, generator=gen)  # warm-up
    torch.cuda.synchronize()
    # Kept on the host, so that the step's peak memory is the step's own.
    first_grads = {n: p.grad.detach().cpu()
                   for n, p in model.named_parameters()
                   if n.endswith(".table")}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats()
    reset_launches(gather, scatter)
    secs, totals, terms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, stats = train_step(state, batch, 0.5, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        totals.append(float(stats["loss"]))
        terms.append({k: float(v) for k, v in stats["losses"].items()})
    launches = read_launches(gather, scatter)
    check_fused_entry(gather, f"train {label}")
    peak = torch.cuda.max_memory_allocated()

    for i, (total, t) in enumerate(zip(totals, terms)):
        check(np.isfinite(total) and all(np.isfinite(v) for v in t.values()),
              f"{label} step {i + 1}: non-finite loss {total} {t}")
    check(totals[-1] < totals[0],
          f"{label}: loss did not fall: step 1 {totals[0]}, step {steps} "
          f"{totals[-1]}")
    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(before[n], p.detach())]
    check(not unchanged, f"{label}: parameters not updated: {unchanged}")
    no_grad = [n for n, p in model.named_parameters()
               if n.endswith(".table") and not bool(p.grad.abs().max() > 0)]
    check(not no_grad, f"{label}: tables with a zero gradient: {no_grad}")
    # Per microbatch: one proposal and one NeRF field, each with a hashed and
    # a dense part of the table gradient.  K1 and K3 launch only through
    # their fused entries, so no [C, 8 N L] values tensor and no [C/2, M]
    # packed words are built (K1_plain and K3_planar 0).
    hashed = 2 * cfg.microbatches
    per_step = {"K1": 0 if bf16 else hashed,
                "K1_fused": 0 if bf16 else hashed, "K1_plain": 0,
                "K2": 2 * cfg.microbatches, "K3": hashed if bf16 else 0,
                "K3_fused": hashed if bf16 else 0, "K3_planar": 0,
                "K4": 16 * cfg.microbatches, "K5": 0,
                "starts": hashed + 2 * cfg.microbatches}
    for k, n in per_step.items():
        check(launches[k] == n * steps,
              f"{label}: {k} launched {launches[k]} times in {steps} steps, "
              f"expected {n} per step")
    med = float(np.median(secs))
    print(f"[train {label}] waymo {TRAIN_RAYS} rays x {steps} steps "
          f"({cfg.microbatches} microbatches): step s "
          f"{[round(x, 4) for x in secs]}, train rays/s "
          f"{TRAIN_RAYS / med:.1f}, peak {peak} B ({peak / 2**30:.2f} GiB), "
          f"loss {[round(x, 5) for x in totals]}, launches {launches}",
          flush=True)
    print(f"[train {label}] loss terms step 1 {terms[0]}, step {steps} "
          f"{terms[-1]}", flush=True)
    res = {"rays_per_s": TRAIN_RAYS / med, "step_seconds": secs,
           "peak_bytes": peak, "totals": totals, "terms": terms,
           "launches": launches, "launches_per_step": per_step,
           "microbatches": cfg.microbatches}
    return res, first_grads


def with_bf16_backward(cfg):
    """cfg with grid_bwd_value_dtype='bfloat16' on both fields (what the
    CLI's two -b bindings set)."""
    return dataclasses.replace(
        cfg,
        nerf_mlp=dataclasses.replace(cfg.nerf_mlp,
                                     grid_bwd_value_dtype="bfloat16"),
        prop_mlp=dataclasses.replace(cfg.prop_mlp,
                                     grid_bwd_value_dtype="bfloat16"))


def compare_first_grads(f32_grads, bf16_grads, hashed_from):
    """The bf16 backward's first-step table gradients against the f32
    backward's, from the same initial state and the same draws: over the
    whole table, and over the hashed levels alone (rows from
    hashed_from[name] on), which are the ones K3 fills."""
    rel = {}
    for name, want in f32_grads.items():
        got = bf16_grads[name]
        lo = hashed_from[name]
        rel[name] = {
            "table": float((got - want).norm() / want.norm()),
            "hashed_levels": float((got[:, lo:] - want[:, lo:]).norm()
                                   / want[:, lo:].norm())}
        # K2 fills the dense levels either way.
        dense_equal = bool((got[:, :lo] == want[:, :lo]).all())
        for part, v in rel[name].items():
            check(v <= BF16_GRAD_REL_L2,
                  f"bf16 backward: {name} {part} gradient rel L2 {v} from "
                  f"the f32 backward's (limit {BF16_GRAD_REL_L2})")
        check(rel[name]["hashed_levels"] > 0,
              f"bf16 backward: {name} hashed levels bitwise equal to the "
              f"f32 backward's, so nothing was rounded")
        rel[name]["dense_levels_bitwise_equal"] = dense_equal
    print(f"[train bf16] first-step table gradients vs the f32 backward: "
          f"rel L2 {rel} (limit {BF16_GRAD_REL_L2})", flush=True)
    return rel


def repeat_phase(torch, step, state_lib, cfgs, initial, batch):
    """The port's counterpart of the JAX package's determinism check: for
    each backward, two runs of REPEAT_STEPS steps, each from the `initial`
    parameters with a fresh Adam state, on the same batch with a generator
    seeded REPEAT_SEED.  Every parameter, every Adam moment and the losses
    must be bitwise equal."""
    res = {}
    dev = batch["origins"].device
    for label, cfg in cfgs:
        runs = []
        for _ in range(2):
            model = step.init_model(cfg, seed=0, device=dev)
            model.load_state_dict(initial, strict=True)
            state = state_lib.create_train_state(cfg, model)
            train_step = step.make_train_step(model, cfg)
            gen = torch.Generator(device=dev).manual_seed(REPEAT_SEED)
            losses = []
            for _ in range(REPEAT_STEPS):
                state, stats = train_step(state, batch, 0.5, generator=gen)
                losses.append(stats["loss"].detach().clone())
            tensors = {f"param {n}": p.detach().clone()
                       for n, p in model.named_parameters()}
            names = dict(enumerate(n for n, _ in model.named_parameters()))
            for i, s in state.optimizer.adam.state_dict()["state"].items():
                for k, v in s.items():
                    tensors[f"adam {names[i]} {k}"] = torch.as_tensor(
                        v).clone()
            tensors.update({f"loss step {i + 1}": v
                            for i, v in enumerate(losses)})
            runs.append(tensors)
            del model, state, train_step
        first, second = runs
        check(set(first) == set(second), f"repeat {label}: the two runs hold "
              f"different tensors")
        moments = sum(k.startswith("adam ") and not k.endswith(" step")
                      for k in first)
        check(moments == 2 * sum(k.startswith("param ") for k in first),
              f"repeat {label}: {moments} Adam moments for "
              f"{sum(k.startswith('param ') for k in first)} parameters")
        differ = [k for k in first if not torch.equal(first[k], second[k])]
        res[label] = {"tensors": len(first), "adam_moments": moments,
                      "steps": REPEAT_STEPS, "seed": REPEAT_SEED,
                      "differ": differ,
                      "losses": [float(first[f"loss step {i + 1}"])
                                 for i in range(REPEAT_STEPS)]}
        print(f"[repeat {label}] two runs of {REPEAT_STEPS} steps from one "
              f"state and generator seed {REPEAT_SEED}: {len(first)} tensors "
              f"({moments} Adam moments), "
              + (f"differ in {differ}" if differ else "all bitwise equal")
              + f"; losses {res[label]['losses']}", flush=True)
        del runs, first, second
    differ = {label: r["differ"] for label, r in res.items() if r["differ"]}
    check(not differ, f"repeat: the two runs differ in {differ}")
    return res


def steady_windows(logged, start, render_every):
    """The logged steps whose window is a steady-state rate: it holds a full
    CLI_PRINT_EVERY steps, none of them the call's first, and no test render
    or save (the loop does those after a step's log line, so they fall into
    the window that follows)."""
    steady, prev = [], start
    for s in sorted(logged):
        events = [e for e in range(max(prev, start + 1), s)
                  if e % render_every == 0 or e % CLI_CHECKPOINT_EVERY == 0]
        if s - prev == CLI_PRINT_EVERY and prev > start and not events:
            steady.append(s)
        prev = s
    return steady


def cli_phase(torch, gather, scatter, cli_train, batch_size, exp):
    """The training entry point in-process on the synthetic scene, with the
    bf16 backward: train, test render, checkpoints, then resume, in the
    experiment folder `exp` (the serving phase goes on from its last
    checkpoint).  Two rates come out: the one the CLI logs, over the steady
    windows alone (`steady_windows`), and steps x batch_size over the
    seconds of each whole call, with its set-up, test render and saves."""
    first, second = CLI_STEPS
    argv = ["--preset", "synthetic_quality",
            "-b", 'NerfMLP.grid_bwd_value_dtype = "bfloat16"',
            "-b", 'PropMLP.grid_bwd_value_dtype = "bfloat16"',
            "-b", f"Config.exp_name = {exp!r}",
            "-b", f"Config.print_every = {CLI_PRINT_EVERY}",
            "-b", f"Config.train_render_every = {first}",
            "-b", f"Config.checkpoint_every = {CLI_CHECKPOINT_EVERY}",
            "-b", "Config.lr_delay_steps = 0"]
    log_path = os.path.join(exp, "log_train.txt")
    microbatches, levels = 2, 16  # of the preset; 6 proposal + 10 NeRF levels
    results = []
    offset = 0
    for max_steps, start in ((first, 0), (second, first)):
        reset_launches(gather, scatter)
        t0 = time.perf_counter()
        cli_train.main(argv + ["--max-steps", str(max_steps)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches(gather, scatter)
        check_fused_entry(gather, f"CLI --max-steps {max_steps}")
        with open(log_path) as f:
            f.seek(offset)
            log = f.read()
            offset = f.tell()
        steps = max_steps - start
        lines = {int(a): (float(b), float(c), float(d)) for a, b, c, d in
                 re.findall(r"step (\d+)/\d+: loss=(\S+) psnr=(\S+) "
                            r"(\d+) rays/s", log)}
        check(max(lines) == max_steps and min(lines) == start + 1,
              f"CLI logged steps {sorted(lines)}, expected {start + 1} "
              f"to {max_steps}")
        check(all(np.isfinite(v).all() for v in lines.values()),
              f"CLI: non-finite log values {lines}")
        check(("resumed from step %d" % start in log) == bool(start),
              f"CLI: resume line wrong for a start at step {start}")
        kept = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        # checkpoints_total_limit is 1 in the preset: only the final
        # save is left, the one at step 20 was pruned.
        check(kept == [str(max_steps)],
              f"CLI: checkpoints {kept}, expected [{max_steps}]")
        check(launches["K3"] == steps * microbatches * 2
              and launches["K3_fused"] == launches["K3"]
              and launches["K3_planar"] == 0
              and launches["K2"] == steps * microbatches * 2
              and launches["starts"] == steps * microbatches * 4
              and launches["K1"] == 0,
              f"CLI: launches {launches} in {steps} steps of "
              f"{microbatches} microbatches")
        steady = {k: lines[k][2]
                  for k in steady_windows(lines, start, first)}
        results.append({"max_steps": max_steps, "seconds": secs,
                        "launches": launches, "log": lines,
                        "steady_window_rays_per_s": steady,
                        "call_rays_per_s": steps * batch_size / secs})
        print(f"[cli] --max-steps {max_steps} from step {start}: "
              f"{secs:.1f} s, {steps * batch_size / secs:.1f} rays/s "
              f"over the whole call (set-up, render and saves "
              f"included), launches {launches}, logged rays/s of the "
              f"steady windows (ending at these steps) {steady}, of "
              f"every window (first steps, render and saves included) "
              f"{ {k: v[2] for k, v in lines.items()} }, loss "
              f"{ {k: v[0] for k, v in lines.items()} }, checkpoints "
              f"{kept}", flush=True)
        if not start:
            check(lines[max_steps][0] < lines[1][0],
                  f"CLI: loss {lines[max_steps][0]} at step {max_steps} "
                  f"not below {lines[1][0]} at step 1")
            render = re.search(r"test render \d+: psnr=(\S+) "
                               r"ssim=(\S+) \((\S+)s\)", log)
            check(render is not None
                  and np.isfinite(float(render.group(1))),
                  "CLI: no test render with a finite PSNR in the log")
            chunks = (launches["K4"] - steps * microbatches * levels)
            check(chunks > 0 and chunks % levels == 0,
                  f"CLI: K4 launched {launches['K4']} times; the test "
                  f"render's share {chunks} is no multiple of {levels}")
            results[-1].update(test_psnr=float(render.group(1)),
                               test_ssim=float(render.group(2)),
                               render_seconds=float(render.group(3)))
            print(f"[cli] test render psnr {render.group(1)} ssim "
                  f"{render.group(2)} in {render.group(3)} s "
                  f"({chunks // levels} chunks)", flush=True)
    return results


def serving_cli(torch, gather, scatter, label, main, argv):
    """One serving or extraction CLI in-process, its launches counted from
    0 just before it: K4 only, all through the fused entry, and no backward
    kernel.  Returns (seconds, launches)."""
    reset_launches(gather, scatter)
    t0 = time.perf_counter()
    main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(gather, scatter)
    check_fused_entry(gather, label)
    check(launches["K4"] > 0 and all(
        n == 0 for k, n in launches.items() if not k.startswith("K4")),
          f"{label}: launches {launches}; expected K4 alone")
    return secs, launches


def ply_header(path):
    """(vertex count, face count, header length) of a binary PLY."""
    with open(path, "rb") as f:
        head = f.read(1024)
    end = head.index(b"end_header\n") + len(b"end_header\n")
    counts = dict(re.findall(rb"element (\w+) (\d+)", head[:end]))
    return int(counts[b"vertex"]), int(counts[b"face"]), end


def read_ply_vertices(path, n):
    """The first n vertices (xyz, rgb) of a PLY that write_ply wrote with
    colors."""
    n_v, _, end = ply_header(path)
    rec = np.fromfile(path, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
                      count=min(n, n_v), offset=end)
    return rec["xyz"], rec["rgb"]


def serving_phase(torch, gather, scatter, hashgrid, configs, step, exp, k4):
    """The serving and extraction entry points in-process on the CLI
    phase's step-40 checkpoint of ``synthetic_quality`` (the canonical
    architecture at full width): cli.eval on every test view, cli.render
    of a SERVE_FRAMES-frame path (and a second call that renders nothing),
    cli.tsdf at 256^3 over SERVE_TSDF_VIEWS training views and cli.extract
    at 256^3.  Each CLI's launches are counted from 0 just before it.
    Checks what each writes; holds eval's first PSNR bitwise against this
    phase's own render, an extract density chunk and vertex colors against
    a CPU copy of the model, and K4 on the indices one extract chunk hands
    a NeRF level."""
    from ucnerf_tpu_torch.cli import eval as cli_eval
    from ucnerf_tpu_torch.cli import extract as cli_extract
    from ucnerf_tpu_torch.cli import render as cli_render
    from ucnerf_tpu_torch.cli import tsdf as cli_tsdf
    from ucnerf_tpu_torch.data import datasets
    from ucnerf_tpu_torch.ops import coord
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.utils import image as image_lib

    ckpt_step = CLI_STEPS[-1]
    binding = f"Config.exp_name = {exp!r}"
    argv = ["--preset", "synthetic_quality", "-b", binding]
    cfg = configs.load_config("synthetic_quality", [binding])
    test = datasets.load_dataset("test", cfg)
    view_rays = test.width * test.height
    res, paths = {}, {}

    # cli.eval on every test view, with the ray histograms.
    secs, paths["cli_eval"] = serving_cli(
        torch, gather, scatter, "cli eval", cli_eval.main,
        argv + ["--ray-histograms"])
    metrics = {}
    for key in ("psnr", "ssim", "psnr_cc", "ssim_cc"):
        with open(os.path.join(exp, f"{key}_{ckpt_step}.txt")) as f:
            metrics[key] = [float(v) for v in f.read().split()]
        check(len(metrics[key]) == test.n_examples
              and np.isfinite(metrics[key]).all(),
              f"cli eval: {key}_{ckpt_step}.txt holds {metrics[key]}")
    preds = set(os.listdir(os.path.join(exp, "test_preds")))
    want = {f"{t}_{i:03d}.png" for t in ("color", "depth", "acc")
            for i in range(test.n_examples)}
    want |= {"ray_colors_000.png", "ray_weights_000.png"}
    check(want <= preds, f"cli eval: missing {sorted(want - preds)}")
    with open(os.path.join(exp, "log_eval.txt")) as f:
        logged = [float(r) for r in re.findall(r"\((\d+) rays/s\)", f.read())]
    # The first view again, through a model of this phase's own.
    model = step.init_model(cfg, seed=0, device="cuda")
    check(ckpt_lib.restore_model(exp, model) == ckpt_step,
          "the CLI phase's checkpoint is not at its last step")
    batch = test.image_batch(0)
    rendering = step.render_image(
        step.make_eval_step(model, cfg), batch, cfg, train_frac=1.0,
        eval_camidx=cli_eval._eval_camidx(cfg, 0, test.cam_num))
    psnr = image_lib.MetricHarness()(
        np.clip(rendering["rgb"], 0, 1), batch["rgb"],
        quantize=cfg.eval_quantize_metrics)["psnr"]
    check(psnr == metrics["psnr"][0],
          f"cli eval: view 0 PSNR {metrics['psnr'][0]!r}, the phase's own "
          f"render of it {psnr!r}")
    res["cli_eval"] = {
        "seconds": secs, "views": test.n_examples,
        "rays_per_s": test.n_examples * view_rays / secs,
        "logged_rays_per_s": logged, "metrics": metrics}
    print(f"[serve] cli.eval: {test.n_examples} views of {test.width}x"
          f"{test.height} in {secs:.2f} s, "
          f"{res['cli_eval']['rays_per_s']:.1f} rays/s over the call "
          f"(logged per view {logged}); psnr {metrics['psnr']}, ssim "
          f"{metrics['ssim']}, psnr_cc {metrics['psnr_cc']}; view 0's PSNR "
          f"bitwise the phase's own render; launches {paths['cli_eval']}",
          flush=True)

    # cli.render: SERVE_FRAMES frames of the keyframe path, then again.
    render_argv = argv + ["-b", f"Config.render_path_frames = {SERVE_FRAMES}"]
    secs, paths["cli_render"] = serving_cli(
        torch, gather, scatter, "cli render", cli_render.main, render_argv)
    out_dir = os.path.join(exp, "render", f"path_renders_step_{ckpt_step}")
    frames = sorted(os.listdir(out_dir))
    check(frames == sorted(f"{t}_{i:03d}.png" for t in ("color", "depth",
                                                        "acc")
                           for i in range(SERVE_FRAMES)),
          f"cli render wrote {frames}")
    log_path = os.path.join(exp, "log_render.txt")
    before = os.path.getsize(log_path)
    reset_launches(gather, scatter)
    cli_render.main(render_argv)
    with open(log_path) as f:
        f.seek(before)
        skipped = f.read().count("already exists, skipping")
    check(skipped == SERVE_FRAMES
          and read_launches(gather, scatter)["K4"] == 0,
          f"cli render again: {skipped} frames skipped, K4 launched "
          f"{read_launches(gather, scatter)['K4']} times")
    res["cli_render"] = {"seconds": secs, "frames": SERVE_FRAMES,
                         "rays_per_s": SERVE_FRAMES * view_rays / secs}
    print(f"[serve] cli.render: {SERVE_FRAMES} frames of {test.width}x"
          f"{test.height} in {secs:.2f} s, "
          f"{res['cli_render']['rays_per_s']:.1f} rays/s over the call; a "
          f"second call skipped all {SERVE_FRAMES}; launches "
          f"{paths['cli_render']}", flush=True)

    # cli.tsdf at 256^3 over the first SERVE_TSDF_VIEWS training views.
    tsdf_ply = os.path.join(exp, "tsdf.ply")
    secs, paths["cli_tsdf"] = serving_cli(
        torch, gather, scatter, "cli tsdf", cli_tsdf.main,
        argv + ["--resolution", str(EXTRACT_RES), "--max-views",
                str(SERVE_TSDF_VIEWS), "--out", tsdf_ply])
    n_v, n_f, _ = ply_header(tsdf_ply)
    check(n_f > 0, f"cli tsdf: a mesh of {n_v} vertices and {n_f} faces")
    res["cli_tsdf"] = {"seconds": secs, "views": SERVE_TSDF_VIEWS,
                       "vertices": n_v, "faces": n_f}
    print(f"[serve] cli.tsdf: {SERVE_TSDF_VIEWS} views into {EXTRACT_RES}^3 "
          f"in {secs:.2f} s: {n_v} vertices, {n_f} faces; launches "
          f"{paths['cli_tsdf']}", flush=True)

    # cli.extract at 256^3.
    mesh_ply = os.path.join(exp, "mesh.ply")
    secs, paths["cli_extract"] = serving_cli(
        torch, gather, scatter, "cli extract", cli_extract.main,
        argv + ["--resolution", str(EXTRACT_RES), "--iso-density",
                str(EXTRACT_ISO), "--out", mesh_ply])
    with open(os.path.join(exp, "log_extract.txt")) as f:
        log = f.read()
    check(os.path.exists(mesh_ply),
          f"cli extract wrote no mesh at --iso-density {EXTRACT_ISO}: "
          f"{re.findall(r'density range: .*', log)}")
    n_v, n_f, _ = ply_header(mesh_ply)
    check(n_f > 0, f"cli extract: a mesh of {n_v} vertices and {n_f} faces")
    points = EXTRACT_RES**3
    chunks = -(-points // cli_extract.POINT_CHUNK)
    res["cli_extract"] = {
        "seconds": secs, "resolution": EXTRACT_RES, "iso": EXTRACT_ISO,
        "points_per_s": points / secs, "vertices": n_v, "faces": n_f,
        "density_range": re.findall(r"density range: (.*)", log)}
    print(f"[serve] cli.extract: {EXTRACT_RES}^3 = {points} points in "
          f"{chunks} chunks, in {secs:.2f} s ({points / secs:.1f} points/s "
          f"over the call), iso {EXTRACT_ISO}, "
          f"{res['cli_extract']['density_range']}: {n_v} vertices, {n_f} "
          f"faces; launches {paths['cli_extract']}", flush=True)

    # One extract chunk and vertex colors: the card against a CPU copy of
    # the model (plain versions of the kernels), on the same world points.
    cpu_model = copy.deepcopy(model).cpu()
    lin = cli_extract.grid_axis(EXTRACT_RES, 2.0)
    i0 = (EXTRACT_RES // 2) * EXTRACT_RES**2  # the slice through the origin
    pts = coord.inv_contract(cli_extract.grid_points(
        lin, i0, i0 + FIELD_CHECK_POINTS, "cpu"))
    verts, rgb_u8 = read_ply_vertices(mesh_ply, FIELD_CHECK_POINTS)
    verts = torch.from_numpy(np.ascontiguousarray(verts))
    errs = {}
    for name, fn, x in (("density", cli_extract.density_of_world, pts),
                        ("vertex_rgb", cli_extract.color_of_world, verts)):
        gpu = fn(model, x.cuda()).cpu().numpy()
        cpu = fn(cpu_model, x).numpy()
        errs[name] = float(np.abs(gpu - cpu).max())
        check(np.isfinite(gpu).all() and np.allclose(
            gpu, cpu, rtol=RENDER_RTOL, atol=RENDER_ATOL),
              f"extract {name} on {len(x)} points: GPU vs CPU max abs err "
              f"{errs[name]}")
        if name == "vertex_rgb":
            # What the CLI wrote is the field's color, quantized.
            ply_err = int(np.abs((np.clip(gpu, 0, 1) * 255).astype(np.int64)
                                 - rgb_u8).max())
            check(ply_err <= 1, f"extract: PLY colors {ply_err} levels off "
                  f"the field's")
    res["cli_extract"]["gpu_vs_cpu_max_abs_err"] = errs
    print(f"[serve] extract field on the card vs the CPU: "
          f"{FIELD_CHECK_POINTS} grid points and {len(verts)} vertices, max "
          f"abs err {errs} (atol {RENDER_ATOL}, rtol {RENDER_RTOL})",
          flush=True)
    del cpu_model

    # K4 on the corner indices and weights one extract chunk (the one
    # through the origin) hands each NeRF level, recorded from the
    # encoder's own calls; held and timed at the level with most rows
    # touched.
    c0 = i0 // cli_extract.POINT_CHUNK * cli_extract.POINT_CHUNK
    chunk_pts = coord.inv_contract(cli_extract.grid_points(
        lin, c0, c0 + cli_extract.POINT_CHUNK, "cuda"))
    recorded = record_k4_calls(
        torch, gather, hashgrid,
        lambda: cli_extract.density_of_world(model, chunk_pts))
    check(len(recorded) == cfg.nerf_mlp.grid_num_levels
          and all(i.shape == (8, 6 * cli_extract.POINT_CHUNK)
                  for _, i, _ in recorded),
          f"an extract chunk's K4 calls: {[i.shape for _, i, _ in recorded]}")
    take, wsum = hold_k4(torch, gather, *most_rows(torch, recorded),
                         torch.Generator(device="cuda").manual_seed(11),
                         "extract level", "extract NeRF level")
    del recorded
    k4["extract_indices"] = {"points": cli_extract.POINT_CHUNK,
                             "take_cm": take, "take_wsum_cm": wsum}
    del model, chunk_pts
    torch.cuda.empty_cache()
    return res, paths


def grad_check_phase(torch, losses_lib, model, cfg, batch):
    """One 64-ray microbatch, generator=None and a given rand_vec: the card
    (kernels) against a CPU copy of the model (plain versions)."""
    n = 64
    part = {k: v[:n].cpu() for k, v in batch.items()}
    rand_vec = torch.from_numpy(
        np.random.default_rng(8).normal(size=(n, 3)).astype(np.float32))
    model.zero_grad(set_to_none=True)
    cpu_model = copy.deepcopy(model).cpu()
    results = []
    for m, dev in ((model, "cuda"), (cpu_model, "cpu")):
        b = {k: v.to(dev) for k, v in part.items()}
        renderings, history = m(b, 0.5, rand_vec.to(dev), train=True)
        total, losses, _ = losses_lib.compute_all_losses(b, renderings,
                                                         history, cfg)
        total.backward()
        results.append((dict({k: float(v.detach())
                              for k, v in losses.items()},
                             total=float(total.detach())),
                        {k: p.grad.cpu() for k, p in m.named_parameters()}))
    (loss_g, grad_g), (loss_c, grad_c) = results
    for k, v in loss_c.items():
        check(np.isclose(loss_g[k], v, rtol=GRAD_LOSS_RTOL, atol=0),
              f"GPU vs CPU loss {k}: {loss_g[k]} vs {v}")
    modules = dict(model.named_modules())
    worst, bad = {}, []
    for k, want in grad_c.items():
        got = grad_g[k]
        scale = float(want.abs().max())
        err = (got - want).abs()
        worst[k] = float(err.max()) / max(scale, 1e-30)
        frac = GRAD_ATOL_FRAC
        field, _, leaf = k.partition(".")
        if leaf in ("table", "density_hidden.weight"):
            spec = modules[field].grid_spec
            frac = table_atol_frac(spec)
        if leaf == "table":
            by_level = [float(err[:, lo:hi].max()) / scale for lo, hi in
                        zip(spec.offsets[:-1], spec.offsets[1:])]
            print(f"[grad] {k}: err/max|grad| by level "
                  f"{[f'{e:.2g}' for e in by_level]} (dense prefix "
                  f"{spec.dense_prefix}), rel L2 err "
                  f"{float((got - want).norm() / want.norm()):.3g}, "
                  f"tolerance {frac:.3g} x max|grad|", flush=True)
        if bool((err > GRAD_RTOL * want.abs() + frac * scale).any()):
            bad.append(f"{k} (err/max|grad| {worst[k]:.3g})")
    zero = [k for k, v in grad_c.items() if not bool(v.abs().max() > 0)]
    top = max(worst, key=worst.get)
    print(f"[grad] 64-ray GPU vs CPU: losses {loss_g} vs {loss_c}; worst "
          f"gradient err/max|grad| {worst[top]:.3g} ({top}); tolerance rtol "
          f"{GRAD_RTOL}, atol {GRAD_ATOL_FRAC} x max|grad| (tables and "
          f"density_hidden.weight as above); zero gradients {zero}",
          flush=True)
    check(not bad, f"GPU vs CPU gradients out of tolerance: {bad}")
    check(not zero, f"zero gradients: {zero}")
    model.zero_grad(set_to_none=True)
    return {"losses_gpu": loss_g, "losses_cpu": loss_c,
            "worst_grad_err_frac": worst[top], "worst_grad": top}


def profile_train_step(torch, model, cfg, batch, step, state_lib, path):
    """Device time by kernel over one training step (torch.profiler); the
    table goes to `path`."""
    from torch.profiler import ProfilerActivity, profile
    state = state_lib.create_train_state(cfg, model)
    train_step = step.make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(9)
    train_step(state, batch, 0.5, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, 0.5, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    bf16 = cfg.nerf_mlp.grid_bwd_value_dtype == "bfloat16"
    # Kernels by the template argument or name that marks them: K1's fused
    # entry (its walks and the grads' interleave), K2 (walks and the two
    # record passes), K3 (the planar walk; the fused entry's walk and its
    # record pass), the prep of all three (the stable sort and the run
    # starts), K4.
    write_profile(torch, prof, wall_us, path,
                  f"one training step of {batch['origins'].shape[0]} rays"
                  + (" (bf16 backward)" if bf16 else ""),
                  {"K1": ("WeightedRows", "interleave_grads_kernel"),
                   "K2": ("DenseWalk", "dense_pack_kernel",
                          "gather_records_kernel"),
                   "K3": ("Bf16Pairs", "Bf16Records",
                          "form_records_kernel"),
                   "prep": ("RadixSort", "run_starts_kernel"),
                   "K4": ("take_wsum_kernel", "take_kernel",
                          "interleave_kernel<")})


def write_profile(torch, prof, wall_us, path, what, names):
    """Device kernels of a profile by time, with the device's busy share of
    the wall time and, for each label of `names`, the sum over the kernels
    whose names hold one of its patterns."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))
    device_us = sum(dev_us(e) for e in events)
    named = {label: sum(dev_us(e) for e in events
                        if any(p in e.key for p in patterns))
             for label, patterns in names.items()}
    top = sorted(events, key=dev_us, reverse=True)[:40]
    with open(path, "w") as f:
        f.write(f"{what}: wall {wall_us:.1f} us, device {device_us:.1f} us, "
                + ", ".join(f"{n} {v:.1f} us" for n, v in named.items())
                + "\n")
        for e in top:
            f.write(f"{dev_us(e):14.1f} us {e.count:7d}x  {e.key[:110]}\n")
    print(f"[profile] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{device_us / 1e3:.3f} ms ({device_us / wall_us:.3f}), "
          + ", ".join(f"{n} {v / 1e3:.3f} ms" for n, v in named.items())
          + f"; table in {path}", flush=True)


def profile_chunk(torch, eval_step, view, cfg, path):
    """Device time by kernel over one render chunk (torch.profiler), and the
    device's busy share of the chunk's wall time; the table goes to `path`."""
    from torch.profiler import ProfilerActivity, profile
    batch = {k: torch.from_numpy(np.array(
        v.reshape((-1,) + v.shape[2:])[:cfg.render_chunk_size])).cuda()
        for k, v in view.items()}
    eval_step(batch, 1.0, 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_step(batch, 1.0, 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    write_profile(torch, prof, wall_us, path,
                  f"one chunk of {cfg.render_chunk_size} rays",
                  {"take_wsum_kernel": ("take_wsum_kernel",),
                   "take_kernel": ("take_kernel",),
                   "interleave_kernel": ("interleave_kernel<",)})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--profile", help="also profile one render chunk "
                        "and write its kernel table here")
    parser.add_argument("--profile-train", help="also profile one training "
                        "step with each backward and write the kernel tables "
                        "here (f32) and beside it with '.bf16' before the "
                        "extension")
    args = parser.parse_args(argv)

    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, ROOT)
    from ucnerf_tpu_torch import configs
    from ucnerf_tpu_torch.cli import train as cli_train
    from ucnerf_tpu_torch.data import cameras
    from ucnerf_tpu_torch.ops import build, gather, hashgrid, scatter
    from ucnerf_tpu_torch.train import losses as losses_lib
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"[gpu] {card}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    secs = build.build(verbose=True)
    print(f"[build] kernels {list(build.SOURCES)} built in {secs:.1f} s",
          flush=True)

    k4 = kernel_phase(torch, gather)
    k1, k2, k3, k5 = scatter_phase(torch, scatter, hashgrid, configs)
    slice_res, eval_step, views, cfg, model = slice_phase(
        torch, gather, scatter, configs, cameras, step)
    real_index_phase(torch, gather, hashgrid, eval_step, views[0], cfg, model,
                     k4)
    if args.profile:
        profile_chunk(torch, eval_step, views[0], cfg, args.profile)
    del eval_step
    train_cfg = configs.waymo(lr_delay_steps=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(views, train_cfg, TRAIN_RAYS, seed=4).items()}
    grad_res = grad_check_phase(torch, losses_lib, model, train_cfg, batch)
    real_stream_phase(torch, scatter, hashgrid, losses_lib, model, train_cfg,
                      batch, k1, k2, k3)
    initial = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    train_res, f32_grads = train_phase(
        torch, gather, scatter, step, state_lib, model, train_cfg, batch,
        TRAIN_STEPS, "f32")
    if args.profile_train:
        profile_train_step(torch, model, train_cfg, batch, step, state_lib,
                           args.profile_train)
    del model

    # The same model from the same initial state, with the bf16 backward.
    bf16_cfg = with_bf16_backward(train_cfg)
    bf16_model = step.init_model(bf16_cfg, seed=0, device="cuda")
    bf16_model.load_state_dict(initial, strict=True)
    bf16_res, bf16_grads = train_phase(
        torch, gather, scatter, step, state_lib, bf16_model, bf16_cfg, batch,
        BF16_STEPS, "bf16")
    hashed_from = {
        f"{name}.table": m.grid_spec.offsets[m.grid_spec.dense_prefix]
        for name, m in bf16_model.named_modules() if hasattr(m, "grid_spec")}
    bf16_res["first_step_table_grad_rel_l2"] = compare_first_grads(
        f32_grads, bf16_grads, hashed_from)
    del f32_grads, bf16_grads
    if args.profile_train:
        root, ext = os.path.splitext(args.profile_train)
        profile_train_step(torch, bf16_model, bf16_cfg, batch, step,
                           state_lib, f"{root}.bf16{ext}")
    del bf16_model
    torch.cuda.empty_cache()
    repeat_res = repeat_phase(torch, step, state_lib,
                              (("f32", train_cfg), ("bf16", bf16_cfg)),
                              initial, batch)
    del initial, batch
    torch.cuda.empty_cache()

    # The training CLI's experiment folder stays until the serving phase
    # has run on its last checkpoint.
    exp = tempfile.mkdtemp(prefix="ucnerf_cli_")
    try:
        cli_res = cli_phase(torch, gather, scatter, cli_train,
                            configs.synthetic_quality().batch_size, exp)
        check(cli_res[0]["steady_window_rays_per_s"],
              "CLI: no steady log window in the first call")
        torch.cuda.empty_cache()
        serve_res, serve_paths = serving_phase(
            torch, gather, scatter, hashgrid, configs, step, exp, k4)
    finally:
        shutil.rmtree(exp, ignore_errors=True)

    # Launches of each main path, counted from 0 just before it.
    paths = {"render": slice_res["launches"],
             "train_f32": train_res["launches"],
             "train_bf16": bf16_res["launches"],
             "cli_train": cli_res[0]["launches"],
             "cli_resume": cli_res[1]["launches"], **serve_paths}
    for entry, key in ((k4, "K4"), (k1, "K1"), (k2, "K2"), (k3, "K3"),
                       (k5, "K5")):
        entry["launches_by_path"] = {p: n[key] for p, n in paths.items()
                                     if n.get(key)}
        entry["launches"] = sum(entry["launches_by_path"].values())
        # K5 has no caller on any path in either package: the kernel phase
        # holds it, and a launch counted on a path would be a mistake.
        check((entry["launches"] > 0) == (key != "K5"),
              f"{key} was launched {entry['launches']} times on the main "
              f"paths: {entry['launches_by_path']}")
    # check_fused_entry held on every path that each K4 launch was the fused
    # entry; take_cm is launched where sample positions need a gradient, and
    # here by the kernel and real-index phases.
    check(sum(K4_BY_ENTRY.values()) == k4["launches"],
          f"K4's launches by entry {K4_BY_ENTRY} do not add up to "
          f"{k4['launches']}")
    k4["launches_by_entry"] = dict(K4_BY_ENTRY)
    k4["take_wsum_cm"].update(
        name="take_wsum_cm (K4's fused entry: gather + 8-corner weighted "
             "sum)", route=k4["route"], source=k4["source"],
        replaces=k4["replaces"], launches=k4["launches"])
    # K1 launches on the paths only through its fused entry: no path builds
    # the [C, 8 N L] values.  Every sort of K1, K2 and K3 ends with the run
    # starts pass, held against searchsorted in the kernel phase.
    k1["launches_by_entry"] = {
        "scatter_add_wsum_cm": sum(n["K1_fused"] for n in paths.values()),
        "scatter_add_cm": sum(n["K1_plain"] for n in paths.values())}
    check(k1["launches_by_entry"]["scatter_add_cm"] == 0,
          f"K1's plain entry was launched on a path: {k1['launches_by_entry']}")
    # K3 likewise only through its fused entry: no path builds the [C/2, M]
    # packed words.
    k3["launches_by_entry"] = {
        "scatter_add_wsum_packed_cm": sum(n["K3_fused"]
                                          for n in paths.values()),
        "scatter_add_packed_cm": sum(n["K3_planar"] for n in paths.values())}
    check(k3["launches_by_entry"]["scatter_add_packed_cm"] == 0,
          f"the planar K3 was launched on a path: {k3['launches_by_entry']}")
    k1["run_starts_launches_by_path"] = {p: n["starts"]
                                         for p, n in paths.items()}
    check(all(n["starts"] == n["K1"] + n["K2"] + n["K3"]
              for n in paths.values()),
          f"run starts launches differ from the scatters' sorts: {paths}")
    k4["launches_per_chunk"] = slice_res["launches_per_chunk"]
    for entry, key in ((k4, "K4"), (k1, "K1"), (k2, "K2")):
        entry["launches_per_step"] = train_res["launches_per_step"][key]
    k3["launches_per_step"] = bf16_res["launches_per_step"]["K3"]

    kernels = {"kernels": [k4, k1, k2, k3, k5]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "render": slice_res, "train": train_res,
                       "train_bf16": bf16_res, "repeat": repeat_res,
                       "cli": cli_res, "serve": serve_res,
                       "grad_check": grad_res}, f, indent=1)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

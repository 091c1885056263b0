#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ucnerf_tpu_torch``) on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--out results.json]

Phases:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ucnerf_tpu_torch/csrc/, and the rig bundle
     adjuster's host library (g++), all in parallel;
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
  3a. hash-corner phase: ``tests/test_card_hash_corners.py`` run by
     pytest as a gate: the corner kernel (``csrc/hash_corners.cu``) bitwise
     its plain version at a render chunk's proposal and NeRF fields and at
     an odd count, for both grids, with its device time against its byte
     bound, and the encoder's launches (one per training call, one per level
     without grad); the render and training phases count its launches too;
  3b. train-graph phase: ``tests/test_card_train_graph.py`` run by pytest
     as a gate: the train step replayed from a CUDA graph bitwise the eager
     step (losses, gradients, parameters, Adam moments; the kernels a
     replay runs, counted on the card from a profiler trace) at
     ``configs.waymo()``, ``configs.waymo_tpu()`` and with camera
     refinement, at a reduced batch;
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
     run-starts passes a step, counted by the kernel wrappers in the
     warm-up, which runs eagerly, and on the card (from a profiler trace)
     in one step more after the timed ones; the first timed step captures
     the microbatch loop's CUDA graph and every later step replays it, so
     the wrappers, which count the launches their Python issues, see none
     of a replay's (as in the bf16, flagship, camera and field phases; the
     rig and CLI phases check the wrappers' counts over the eager calls and
     the captures);
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
  8a. flagship phase: the JAX package's flagship preset
     ``configs.waymo_tpu()`` (single-query hex lookups: one per sample at
     the mean of its 6 hex points; 15 microbatches of 1000 rays) from the
     render phase's weights: the two views rendered as in phase 4 (16
     ``take_wsum_cm`` a chunk, no ``take_cm``; bitwise again; a 64-ray chunk
     against the CPU); K4 held and timed on a single-query render chunk's
     proposal and NeRF level indices; a 64-ray microbatch's losses and
     gradients on the card against the CPU and float64, unkeyed and keyed;
     K1's and K3's fused entries and K2 held and timed on one 1000-ray
     microbatch's f32 backward; one warm-up and 5 timed f32 steps (a step:
     240 ``take_wsum_cm``, 30 fused K1, 30 K2, 60 run starts) and 2 bf16
     steps (30 fused K3 in K1's place; the first step's table gradients
     within 1 % relative L2 of the f32 ones) on the training batch; 3 f32
     steps at 10 microbatches beside the preset's 15; the repeatability
     check for each backward; the roofline scoreboard
     (``utils/roofline.py``) of the renders and f32 steps of ``waymo()``
     and ``waymo_tpu()``;
  8b. data-parallel phase (``parallel/mesh.py``), each rank a process of
     its own (this script with ``--dp-worker``), every rank on the one card:
     a group of one over NCCL, whose 2 keyed f32 steps must equal the same
     steps without a group bitwise (the all-reduce timed by CUDA events);
     two ranks over gloo, each on 7500 of the batch's 15000 rays, for each
     backward: the launches per rank a step asserted (160 ``take_wsum_cm``,
     20 fused K1 or fused K3, 20 K2, 40 run starts), every parameter and
     Adam moment bitwise equal across the ranks after each step and across
     two runs of 2 steps (sha256 of their bytes); one fixed-basis step's
     losses and reduced gradients against one process on the 15000 rays
     at the gradient check's tolerances; rays/s and peak memory per rank
     (two ranks sharing one card: no measure of scaling); on a machine
     with several cards, the same with a rank on each card over NCCL
     (skipped, and said so, on one card); then
     ``cli.train --multihost`` at two ranks on the CLI phase's scene (10
     steps with a test render and a checkpoint, a resume to 12: one log,
     one checkpoint set) and ``cli.eval`` of its checkpoint at two ranks
     against one process (PSNR and SSIM of 2 views, view 0's 8-bit image);
  8c. camera-refinement phase: ``configs.waymo()`` with
     ``optimize_cameras`` and ``contract_origin_grads`` from the same
     initial weights and batch (each ray's view its physical camera), the
     se(3) deltas at 0: one warm-up (the deltas' gradient finite and
     nonzero in the rotation and the translation half) and 3 timed steps,
     every K4 launch ``take_cm`` (160 a step; the sample positions need a
     gradient, so the rows are kept), fused K1 20, K2 20, run starts 40;
     ``take_cm`` held bitwise and timed at one microbatch's real indices
     beside ``index_select``, and the weights' gradient einsum timed; a
     64-ray microbatch's gradients, the deltas included, against the CPU;
     two runs of 2 steps bitwise equal;
  8c'. rig phase (``ucnerf_tpu_torch/tools/cam_refine_quality.py``'s
     under-calibrated rig): ``configs.synthetic_quality()`` with
     single-query lookups on both fields, camera 1 of two rig slots
     perturbed by 1 degree and 0.045: the tool's off arm for 3 steps
     (every K4 launch ``take_wsum_cm``; no deltas, so the residual stays
     the injected error), then its composed arm (camera refinement,
     ``contract_origin_grads``, virtual warping) for RIG_STEPS steps (32
     ``take_cm``, 4 fused K1, 4 K2 and 8 run starts a step), the residual
     rotation and translation cut by at least RIG_CUT; then a batch whose
     virtual fifth comes from the correspondence pool, a 64-ray microbatch
     of 52 real and 12 virtual rays with random weights and the deltas
     near 1e-3 on the card, the CPU and float64 (as the flagship phase
     checks), and ``take_cm`` held bitwise and timed at the indices of the
     microbatch that holds the virtual fifth;
  8d. normals phase: ``configs.waymo()`` with density and predicted
     normals on both fields, ``contract_origin_grads`` and the ref-NeRF
     weights of the orientation and predicted-normal losses (the preset's
     learning-rate delay kept), from the same initial weights and batch: a
     64-ray microbatch on the card, on the CPU and on a float64 CPU copy,
     once with a given hex basis and once keyed by a seeded generator
     whose draws the CPU copies replay (each loss term and gradient entry
     of the card within 4x the CPU's error against float64, plus the
     camera phase's tolerance; each table's gradient within 4x the CPU's
     relative L2 error, plus 1e-5), one warm-up and 3 timed steps with the
     launches a microbatch asserted (16 ``take_cm``, 16 ``take_wsum_cm``
     for the double backward's d/d g, 4 fused K1: the table gradient's 2
     and the double backward's d/d table over each whole table, 2 K2, no
     plain K1), a 480x320 render with the normals composited (16
     ``take_cm`` a chunk and nothing else) and a 64-ray chunk of it whose
     normals and predicted normals are held against the CPU and float64
     as the gradients are, two runs of 2 steps bitwise equal, and the
     double backward's ``take_wsum_cm`` and fused K1 held against their
     plain versions and timed on one microbatch's real inputs;
  8e. options phase: ``configs.waymo()`` with bf16 field matmuls, scale
     featurization, density and bottleneck noise, a random background and
     the interlevel loss (exercise values, no published preset; the
     preset's learning-rate delay kept): the float64 check (its keyed pass
     carries the noise and background draws), 3 timed steps (launches as
     the f32 phase), two runs of 2 steps bitwise equal (the interlevel
     loss's ``inner_outer`` backward included), and the bf16 layer timed beside the f32 one;
  8f. encoder check: ``hashgrid.encode`` forward and table gradient at
     2^20 points through the canonical 10-level NeRF grid against float64
     plain versions, with its launches (10 ``take_cm``, K1's plain entry
     once: its one caller); K1's plain entry held bitwise across launches
     and timed on the updates it was handed;
  9. CLI phase: ``ucnerf_tpu_torch.cli.train`` in-process on the synthetic
     scene (``--preset synthetic_quality`` with the bf16 backward): 30
     steps, a test render, checkpoints (the last two kept), then a second
     call that resumes at step 30 and ends at 40;
  9a. checkpoint-step phase: ``ucnerf_tpu_torch/tools/eval_ckpt_step.py``
     on the older kept checkpoint (step 30), its launches counted from 0
     (K4's fused entry alone, 16 a render chunk), its PSNR and SSIM of 2
     test views equal to ``cli.eval``'s on a folder that holds step 30
     alone;
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
  10a. jax_import phase: checkpoints of the JAX package on the card.  The
     committed fixture (tests/fixtures/, written by tests/torch_jax_fixture.py
     with JAX on the CPU: the tiny preset's orbax state after 2 steps,
     exported by tools/export_jax_checkpoint.py) imported by
     ``cli.import_jax`` on the card, its 64 eval rays rendered through
     ``make_eval_step`` (K4's fused entry) against JAX's CPU render, and one
     f32 ``make_train_step`` (K1's fused entry, K2, K4) whose parameters and
     Adam moments are held against JAX's next state, entry by entry, within
     the bound the gradient tolerance gives through Adam; then the full-width
     round trip of the CLI phase's step-40 checkpoint (87.3 M parameters):
     ``convert.state_to_export``, ``cli.import_jax`` into a fresh folder,
     every parameter, moment and count bitwise the source's, ``cli.eval`` of
     both folders with bitwise-equal metrics, ``cli.train`` resumed for 2
     steps from each (K3's fused entry, K2, K4) with bitwise-equal final
     ``state.pt`` files; the export's size and seconds printed;
  11. MVS phase: the CER-MVS depth estimator's entry points in-process,
     ``cli.mvs_train`` and ``cli.mvs_depth``, with the launches of each
     counted from 0 (no hand-written kernel lies on either path): the tiny
     cascade's quality recipe through ``ucnerf_tpu_torch/tools/mvs_quality.py``
     (600 steps at a 64x96 crop, then per-view, multires and geo-fused
     abs-rel and the fused points of the random-init and trained weights,
     printed; the per-view median of the trained cascade below the random
     init's); 20
     full-width training steps; full-width depth of 3 reference views with 6
     sources each on the synthetic scene at 1920x1280, rescales 0.5 and 1.0
     and ``--fuse``, twice (every ``.npy`` bitwise equal); each pass's
     forward split by CUDA events into encoders, correlation build, lookups
     and update block, with its peak memory (the reference demo's rescale-2.0
     pass at 10 sources too); the full-width cascade's first estimate, and
     the tiny cascade's sequence loss and every gradient at its init, on the
     card against the CPU; two runs of 2 full-width steps bitwise equal, and
     the steps timed with cuDNN's deterministic algorithms and without;
  12. pose phase: STPR pose refinement (``ucnerf_tpu_torch.pose``), no
     hand-written kernel on its path: tests/test_full_chain.py's rig
     (160x96, 8 frames x 3 cameras, cameras 2 and 3 yawed by 1.2 and -1.0
     degrees) rendered in memory, on the card against the CPU (Harris
     keypoints equal, match sets equal with the ratios near the threshold
     counted, refined w2c within 1e-9, the rig error at least halved,
     ``pose.json`` written and read back with json); the rig at the Waymo
     front camera's 1920x1280 with 1024 keypoints and 10 frames (cut from
     80): each stage's seconds, the counts, the rig error before and after;
     SuperPoint with seeded random weights at 1920x1280 (forward time, peak
     memory) and on a 320x240 crop against the CPU (NMS bitwise);
  13. print the ``kernels`` JSON line, then ``{"ok": true, "device": ...}``
     as the last line.

Any failure raises and exits non-zero; without a CUDA device the script
fails before printing any result.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

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
# The data-parallel phase: keyed steps of each run, the entry points' steps
# (first call, resumed call; cut from the CLI phase's 30 and 40), the views
# its cli.eval renders, and how far those views' PSNR and SSIM at two ranks
# may lie from one process's (relative): renders that agree within
# RENDER_ATOL move a PSNR near 20 dB by up to ~4e-3 relative, and the two
# differ in f32 rounding alone.
DP_STEPS = 2
DP_CLI_STEPS = (10, 12)
DP_EVAL_VIEWS = 2
DP_RENDER_ROWS = 64  # 480 x 64 rays: chunks of 15000, 15000 and 720
DP_METRIC_RTOL = 1e-3
# The camera-refinement phase: timed steps after its warm-up.
CAM_STEPS = 3
# The flagship phase: f32 steps timed at 10 microbatches beside the
# preset's 15 (a measurement; the preset is unchanged).
M10_STEPS = 3
# K5 is held at the chunk counts the JAX package's record names: unchunked,
# and its best configuration.
K5_CHUNKS = (1, 24)
# The CLI phase: steps of the first call, of the resumed call, and the
# checkpoint interval.
CLI_STEPS = (30, 40)
CLI_CHECKPOINT_EVERY = 20
# The CLI keeps its last two checkpoints: after each call, those steps.
CLI_KEEP = 2
CLI_SAVES = {30: (20, 30), 40: (30, 40)}
# The checkpoint-step phase scores the older one on these test views.
CKPT_STEP_VIEWS = (0, 1)
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


def bound_ms(nbytes):
    """The ms that nbytes take at the card's peak HBM rate
    (``utils/roofline.py``'s ``PEAK_BW``, the H100 SXM's 3.35 TB/s)."""
    from ucnerf_tpu_torch.utils import roofline
    return nbytes / roofline.PEAK_BW * 1e3


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
    touched = gather.rows_touched(table, flat)
    take = {
        "M": m, "rows": table.shape[1], "rows_touched": touched,
        "ms": time_ms(lambda: gather.take_cm(table, flat), torch),
        "interleave_ms": time_ms(lambda: gather.interleave_cm(table), torch),
        "plain_ms": time_ms(lambda: gather.take_cm_plain(table, flat), torch),
        "library_ms": time_ms(lambda: torch.index_select(table, 1, flat),
                              torch),
        "bound_ms": bound_ms(gather.take_cm_bytes(c, m, touched))}
    wsum = {
        "N": n, "rows": table.shape[1], "rows_touched": touched,
        "ms": time_ms(lambda: gather.take_wsum_cm(table, idx, w), torch),
        "plain_ms": time_ms(lambda: gather.take_wsum_cm_plain(table, idx, w),
                            torch),
        "library_ms": time_ms(lambda: wsum_library(torch, table, idx, w),
                              torch),
        "bound_ms": bound_ms(gather.take_wsum_cm_bytes(c, n, touched))}
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


def card_tests_phase(name, tag):
    """The card tests of ``tests/test_card_<name>.py``, run by pytest in a
    process of their own (``--noconftest``: the tests' conftest sets JAX
    up); returns the lines they print under ``[tag]``."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p",
           "no:cacheprovider", "-q", "-s", "-rs",
           os.path.join("tests", f"test_card_{name}.py")]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(f"[{tag}]")]
    for ln in lines:
        print(ln, flush=True)
    summary = out.stdout.strip().splitlines()[-1] if out.stdout.strip() \
        else ""
    check(out.returncode == 0 and "skipped" not in summary,
          f"the {name} card tests failed ({out.returncode}): "
          f"{out.stdout[-3000:]}{out.stderr[-2000:]}")
    print(f"[{tag}] card tests: {summary}", flush=True)
    return {"summary": summary, "lines": lines}


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
            "bound_ms": bound_ms(scatter.segment_sum_bytes(m, c,
                                                           hashed_rows)),
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
            "bound_ms": bound_ms(scatter.packed_sum_bytes(m, c,
                                                          hashed_rows)),
            "pack_bound_ms": bound_ms(m * (4 * c + 2 * c)),
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
    bound = bound_ms(scatter.wsum_sum_bytes(m, levels, n, c, rows))
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
           "bound_with_records_ms": bound + bound_ms(2 * words * 4),
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
        "bound_ms": bound_ms(scatter.dense_sum_bytes(md, c, rows)),
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
        "bound_ms": bound_ms(scatter.wsum_sum_bytes(m, levels, n, c, rows))}
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
            "bound_ms": bound_ms(scatter.chunked_sum_bytes(m, c, rows)),
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


def randomize_weights(torch, model, seed):
    """The tables, and the zero-initialised leaves at random, so that every
    parameter shapes the render and gets a gradient."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".table"):
                p.normal_(0.0, 0.1, generator=gen)
            elif "output_linear" in name or "latent_code" in name:
                p.normal_(0.0, 0.3, generator=gen)


def slice_phase(torch, gather, scatter, configs, cameras, step):
    cfg = configs.waymo()
    model = step.init_model(cfg, seed=0, device="cuda")
    randomize_weights(torch, model, 2)
    views = waymo_views(cameras, cfg)
    res, eval_step = render_phase(torch, gather, scatter, step, cfg, model,
                                  views, "waymo")
    return res, eval_step, views, cfg, model


def render_phase(torch, gather, scatter, step, cfg, model, views, label):
    """The two views through ``render_image`` with the launches counted,
    the first view again (bitwise equal) and a 64-ray chunk against the
    same model on the CPU.  Returns the results and the eval step."""
    eval_step = step.make_eval_step(model, cfg, seed=0)
    num_rays = [v["origins"].shape[0] * v["origins"].shape[1] for v in views]
    chunks = sum(-(-n // cfg.render_chunk_size) for n in num_rays)

    # One warm-up chunk (cuBLAS handles, the allocator's pools, the kernel
    # library's load) before the counts are set to 0 and the clock starts.
    warm = {k: torch.from_numpy(np.array(
        v.reshape((-1,) + v.shape[2:])[:cfg.render_chunk_size])).cuda()
        for k, v in views[0].items()}
    eval_step(warm, 1.0, 0)
    del warm

    from ucnerf_tpu_torch.ops import hashgrid
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(gather, scatter)
    corners_from = hashgrid.hash_corners.launches
    outs, secs = [], []
    for v in views:
        t0 = time.perf_counter()
        outs.append(step.render_image(eval_step, v, cfg, eval_camidx=0))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    by_kernel = read_launches(gather, scatter)
    corners = hashgrid.hash_corners.launches - corners_from
    check_fused_entry(gather, f"render {label}")
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
    # Without grad the corner kernel launches once per level, before its
    # K4 launch.
    check(corners == levels * chunks,
          f"the hash-corner kernel launched {corners} times, expected "
          f"{levels} per chunk x {chunks} chunks")
    check(all(n == 0 for k, n in by_kernel.items()
              if not k.startswith("K4")),
          f"a render launched a backward kernel: {by_kernel}")
    for out in outs:
        check(out["rgb"].shape == (VIEW_H, VIEW_W, 3),
              f"rgb {out['rgb'].shape}")
        for k in ("depth", "acc", "distance_mean", "distance_median"):
            check(out[k].shape == (VIEW_H, VIEW_W), f"{k} {out[k].shape}")
        for k, val in out.items():
            check(np.isfinite(val).all(), f"{k} has non-finite values")
    print(f"[slice] {label} render {len(views)}x{VIEW_W}x{VIEW_H}, "
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
    print(f"[slice] {label} 64-ray GPU vs CPU max abs err {errs} "
          f"(atol {RENDER_ATOL}, rtol {RENDER_RTOL})", flush=True)
    res = {"rays_per_s": [n / s for n, s in zip(num_rays, secs)],
           "seconds": secs, "chunks": chunks, "launches": by_kernel,
           "launches_per_chunk": levels, "corner_launches": corners,
           "peak_bytes": peak,
           "render_subchunks": cfg.render_subchunks,
           "second_render_bitwise_equal": True,
           "gpu_vs_cpu_max_abs_err": errs}
    return res, eval_step


def record_k4_calls(torch, gather, hashgrid, run, entry="take_wsum_cm"):
    """The arguments of every call the encoder makes to K4's `entry` in
    run(), each launched as usual: (table, idx, w) of the fused entry,
    (table, idx) of take_cm."""
    recorded = []
    launch = getattr(gather, entry)

    def recorder(table, *args, bf16=False):
        recorded.append((table.detach(),) + args)
        return launch(table, *args, bf16=bf16)

    # The encoder reaches the kernels through its module's `gather` name.
    hashgrid.gather = types.SimpleNamespace(
        **{"take_cm": gather.take_cm, "take_wsum_cm": gather.take_wsum_cm,
           entry: recorder})
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


def real_index_phase(torch, gather, hashgrid, eval_step, view, cfg):
    """K4's two entry points on the corner indices and weights of one render
    chunk: those of the proposal level and of the NeRF level with the most
    rows touched.  Recorded from the encoder's own calls."""
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
    return calls


def interleave_times(torch, gather, model):
    """What the other placement of the interleave would cost: the wrappers
    interleave a level's slice on every launch; once per encode would be
    one pass over the whole table, handed to the level launches."""
    res = []
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
        res.append(rec)
    return res


def real_stream_phase(torch, scatter, hashgrid, losses_lib, model, cfg,
                      batch):
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
    return res


def train_batch(views, cfg, n, seed):
    """n rays drawn without replacement from the views, with targets made
    with numpy: a smooth colour of the view direction, sky where it points
    up, lossmult 1 and random training-view ids; each ray's view is its
    physical camera (phys_cam_idx, read only with optimize_cameras)."""
    rng = np.random.default_rng(seed)
    flat = {k: np.concatenate([v[k].reshape((-1,) + v[k].shape[2:])
                               for v in views]) for k in views[0]}
    flat["phys_cam_idx"] = np.concatenate([
        np.full(v["origins"].shape[0] * v["origins"].shape[1], i, np.int32)
        for i, v in enumerate(views)])
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
    entry points, also counted apart (K4's as K4_take and K4_wsum);
    "starts" is the run-starts pass that every sort of K1, K2 and K3 ends
    with."""
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
            "K4_take": gather.take_cm.launches,
            "K4_wsum": gather.take_wsum_cm.launches,
            "K5": scatter.scatter_add_chunked_cm.launches,
            "starts": scatter.run_starts.launches}


def device_launches(fn):
    """fn() with the hand-written kernels the card ran counted from a
    profiler trace by their names (``tests/card_launches.py``), a CUDA
    graph's replays included: (fn's result, the counts as
    ``read_launches`` gives them, the corner kernel's count)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import card_launches
    out, counts = card_launches.on_device(fn)
    ran = types.SimpleNamespace(**{
        k: types.SimpleNamespace(launches=n) for k, n in counts.items()})
    return out, read_launches(ran, ran), counts["hash_corners"]


@contextlib.contextmanager
def made_train_steps(step):
    """The train steps that ``step.make_train_step`` makes inside the
    block (a list, filled as they are made): their ``captures`` and
    ``replays`` say how many calls ran from a CUDA graph, whose launches
    the kernel wrappers do not count."""
    made, make = [], step.make_train_step

    def recording(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    step.make_train_step = recording
    try:
        yield made
    finally:
        step.make_train_step = make


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
    of `cfg` on `model`, then one step more with the kernels it runs
    counted on the card.  The hashed levels' table gradient goes through
    K3 when the config asks for the bf16 backward, else through K1.  The
    warm-up runs eagerly, its launches counted by the kernel wrappers; the
    first timed step captures the graph of the microbatch loop, and every
    step after the warm-up replays it.  Returns the results and the table
    gradients of the first (warm-up) step."""
    bf16 = cfg.nerf_mlp.grid_bwd_value_dtype == "bfloat16"
    check(bf16 == (cfg.prop_mlp.grid_bwd_value_dtype == "bfloat16"),
          "the two fields disagree on grid_bwd_value_dtype")
    from ucnerf_tpu_torch.ops import hashgrid
    state = state_lib.create_train_state(cfg, model)
    train_step = step.make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    reset_launches(gather, scatter)
    corners_from = hashgrid.hash_corners.launches
    state, _ = train_step(state, batch, 0.5, generator=gen)  # warm-up
    torch.cuda.synchronize()
    eager = read_launches(gather, scatter)
    eager_corners = hashgrid.hash_corners.launches - corners_from
    check_fused_entry(gather, f"train {label}")
    # Kept on the host, so that the step's peak memory is the step's own.
    first_grads = {n: p.grad.detach().cpu()
                   for n, p in model.named_parameters()
                   if n.endswith(".table")}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats()
    secs, totals, terms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, stats = train_step(state, batch, 0.5, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        totals.append(float(stats["loss"]))
        terms.append({k: float(v) for k, v in stats["losses"].items()})
    peak = torch.cuda.max_memory_allocated()
    (state, _), launches, corners = device_launches(
        lambda: train_step(state, batch, 0.5, generator=gen))
    check(train_step.captures == 1 and train_step.replays == steps + 1,
          f"{label}: {train_step.captures} graph captures and "
          f"{train_step.replays} replays in {steps + 1} steps after the "
          f"warm-up, expected 1 and {steps + 1}")
    # One corner launch per encode call, over all of its levels: a
    # proposal and a NeRF field a microbatch.
    check(eager_corners == corners == 2 * cfg.microbatches,
          f"{label}: the hash-corner kernel launched {eager_corners} times "
          f"in the eager step and {corners} in a replayed one, expected "
          f"{2 * cfg.microbatches}")

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
    want = {"K1": 0 if bf16 else hashed,
            "K1_fused": 0 if bf16 else hashed, "K1_plain": 0,
            "K2": 2 * cfg.microbatches, "K3": hashed if bf16 else 0,
            "K3_fused": hashed if bf16 else 0, "K3_planar": 0,
            "K4": 16 * cfg.microbatches, "K5": 0,
            "starts": hashed + 2 * cfg.microbatches}
    check_step_launches(label, want, eager, launches)
    med = float(np.median(secs))
    print(f"[train {label}] waymo {TRAIN_RAYS} rays x {steps} steps "
          f"({cfg.microbatches} microbatches): step s "
          f"{[round(x, 4) for x in secs]}, train rays/s "
          f"{TRAIN_RAYS / med:.1f}, peak {peak} B ({peak / 2**30:.2f} GiB), "
          f"loss {[round(x, 5) for x in totals]}, launches of a replayed "
          f"step on the card {launches}", flush=True)
    print(f"[train {label}] loss terms step 1 {terms[0]}, step {steps} "
          f"{terms[-1]}", flush=True)
    res = {"rays_per_s": TRAIN_RAYS / med, "step_seconds": secs,
           "peak_bytes": peak, "totals": totals, "terms": terms,
           "launches": launches, "launches_per_step": launches,
           "launches_eager_step": eager,
           "graph": {"captures": train_step.captures,
                     "replays": train_step.replays},
           "corner_launches_per_step": corners,
           "microbatches": cfg.microbatches}
    return res, first_grads


def check_step_launches(label, want, eager, replayed):
    """A step's launches by kernel: `eager`, those the kernel wrappers
    counted over an eager step, and `replayed`, those the card ran in a
    replayed step (``device_launches``), each equal to `want`."""
    for k, n in want.items():
        check(eager[k] == n and replayed[k] == n,
              f"{label}: {k} launched {eager[k]} times in the eager step "
              f"and {replayed[k]} on the card in a replayed step, expected "
              f"{n}")


def with_bf16_backward(cfg):
    """cfg with grid_bwd_value_dtype='bfloat16' on both fields (what the
    CLI's two -b bindings set)."""
    return with_mlps(cfg, grid_bwd_value_dtype="bfloat16")


def compare_first_grads(f32_grads, bf16_grads, hashed_from, label="bf16"):
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
    print(f"[train {label}] first-step table gradients vs the f32 backward: "
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
            # Adam numbers the parameters group by group (the camera deltas
            # make a second group).
            by_id = {id(p): n for n, p in model.named_parameters()}
            names = dict(enumerate(
                by_id[id(p)] for g in state.optimizer.adam.param_groups
                for p in g["params"]))
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


def step_roofline(torch, roofline, state_lib, cfg, model, batch, train_res,
                  label):
    """The roofline scoreboard of a timed f32 training path: its FLOPs and
    bytes counted by op on one microbatch (``roofline.train_step_cost``,
    which steps the model once more), over the median step time."""
    state = state_lib.create_train_state(cfg, model)
    flops, nbytes, kernels = roofline.train_step_cost(cfg, model, state,
                                                      batch)
    want = {"take_wsum_cm", "scatter_add_dense_cm", "scatter_add_wsum_cm"}
    check(set(kernels) == want, f"{label} roofline: kernels counted "
          f"{sorted(kernels)}, expected {sorted(want)}")
    dt = float(np.median(train_res["step_seconds"]))
    res = dict(roofline.metrics(dt, flops, nbytes,
                                roofline.gather_model(cfg)),
               flops=flops, bytes=nbytes, kernel_bytes=kernels, seconds=dt)
    print(f"[roofline] {label} step: {res}", flush=True)
    torch.cuda.empty_cache()
    return res


def render_roofline(torch, roofline, eval_step, view, cfg, render_res,
                    label):
    """The roofline scoreboard of a render: one chunk's FLOPs and bytes
    counted by op, over the chunk's share of the measured render time."""
    rays = cfg.render_chunk_size
    batch = {k: torch.from_numpy(np.array(
        v.reshape((-1,) + v.shape[2:])[:rays])).cuda()
        for k, v in view.items()}
    flops, nbytes, kernels = roofline.cost(lambda: eval_step(batch, 1.0, 0))
    check(set(kernels) == {"take_wsum_cm"}, f"{label} roofline: kernels "
          f"counted {sorted(kernels)}")
    dt = rays / float(np.median(render_res["rays_per_s"]))
    res = dict(roofline.metrics(dt, flops, nbytes,
                                roofline.gather_model(cfg, rays)),
               flops=flops, bytes=nbytes, kernel_bytes=kernels, seconds=dt,
               rays=rays)
    print(f"[roofline] {label} render chunk: {res}", flush=True)
    return res


def flagship_phase(torch, gather, scatter, hashgrid, step, state_lib,
                   losses_lib, roofline, configs, views, initial, batch, k4,
                   k1, k2, k3, profile=None):
    """``configs.waymo_tpu()``, the JAX package's flagship preset, on the
    card from the render phase's weights (``initial``) and the training
    batch; the single-query figures go into the kernels' records."""
    cfg = configs.waymo_tpu(lr_delay_steps=0)
    model = step.init_model(cfg, seed=0, device="cuda")
    model.load_state_dict(initial, strict=True)
    res = {}
    res["render"], eval_step = render_phase(
        torch, gather, scatter, step, cfg, model, views, "waymo_tpu")
    check(res["render"]["launches_per_chunk"] == 16,
          f"waymo_tpu render: {res['render']['launches_per_chunk']} K4 "
          f"launches a chunk, expected 16")
    k4["real_indices_single_query"] = real_index_phase(
        torch, gather, hashgrid, eval_step, views[0], cfg)
    res["render"]["roofline"] = render_roofline(
        torch, roofline, eval_step, views[0], cfg, res["render"],
        "waymo_tpu")
    del eval_step
    torch.cuda.empty_cache()
    res["grad_check"] = grad_check_f64(torch, losses_lib, model, cfg, batch,
                                       "waymo_tpu grad")
    streams = real_stream_phase(torch, scatter, hashgrid, losses_lib, model,
                                cfg, batch)
    for entry, key in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        entry["real_stream_single_query"] = streams[key]

    res["train_f32"], f32_grads = train_phase(
        torch, gather, scatter, step, state_lib, model, cfg, batch,
        TRAIN_STEPS, "waymo_tpu f32")
    res["train_f32"]["roofline"] = step_roofline(
        torch, roofline, state_lib, cfg, model, batch, res["train_f32"],
        "waymo_tpu f32")
    if profile:
        profile_train_step(torch, model, cfg, batch, step, state_lib, profile)
    del model
    torch.cuda.empty_cache()

    bf16_cfg = with_bf16_backward(cfg)
    bf16_model = step.init_model(bf16_cfg, seed=0, device="cuda")
    bf16_model.load_state_dict(initial, strict=True)
    res["train_bf16"], bf16_grads = train_phase(
        torch, gather, scatter, step, state_lib, bf16_model, bf16_cfg, batch,
        BF16_STEPS, "waymo_tpu bf16")
    hashed_from = {
        f"{name}.table": m.grid_spec.offsets[m.grid_spec.dense_prefix]
        for name, m in bf16_model.named_modules() if hasattr(m, "grid_spec")}
    res["train_bf16"]["first_step_table_grad_rel_l2"] = compare_first_grads(
        f32_grads, bf16_grads, hashed_from, "waymo_tpu bf16")
    del f32_grads, bf16_grads, bf16_model
    torch.cuda.empty_cache()

    # The v5e's choice of 15 microbatches against waymo()'s 10, on the card.
    m10_cfg = dataclasses.replace(cfg, microbatches=10)
    m10_model = step.init_model(m10_cfg, seed=0, device="cuda")
    m10_model.load_state_dict(initial, strict=True)
    res["train_f32_m10"], _ = train_phase(
        torch, gather, scatter, step, state_lib, m10_model, m10_cfg, batch,
        M10_STEPS, "waymo_tpu f32 m10")
    del m10_model
    torch.cuda.empty_cache()
    print(f"[waymo_tpu] f32 train rays/s at 15 microbatches "
          f"{res['train_f32']['rays_per_s']:.1f}, at 10 "
          f"{res['train_f32_m10']['rays_per_s']:.1f}", flush=True)

    res["repeat"] = repeat_phase(
        torch, step, state_lib,
        (("waymo_tpu f32", cfg), ("waymo_tpu bf16", bf16_cfg)), initial,
        batch)
    torch.cuda.empty_cache()
    return res


def cam_config(configs):
    """configs.waymo() with in-graph camera refinement: the se(3) deltas of
    its 3 physical cameras and, through contract_origin_grads, gradients to
    the sample positions (the only path on which K4 launches take_cm)."""
    return configs.waymo(lr_delay_steps=0, optimize_cameras=True,
                         contract_origin_grads=True)


def check_take_entry(gather, label):
    """The camera-refinement path: the sample positions carry a gradient, so
    every K4 launch is take_cm, whose gathered rows the corner weights'
    gradient needs, and none is the fused entry.  Called right after the
    path's launches are read."""
    check(gather.take_cm.launches > 0 and gather.take_wsum_cm.launches == 0,
          f"{label}: take_cm launched {gather.take_cm.launches} times and "
          f"take_wsum_cm {gather.take_wsum_cm.launches}; expected every K4 "
          f"launch to be take_cm")
    K4_BY_ENTRY["take_cm"] += gather.take_cm.launches
    K4_BY_ENTRY["take_wsum_cm"] += gather.take_wsum_cm.launches


def take_real_step(torch, gather, hashgrid, losses_lib, model, cfg, batch,
                   label="cam"):
    """K4's take_cm on the corner indices one camera-refinement microbatch
    (batch's first) hands a proposal level and a NeRF level (those
    touching the most rows): bitwise its plain version, timed beside
    index_select; and the corner weights' gradient, the einsum over the
    rows take_cm keeps, timed."""
    n = cfg.batch_size // cfg.microbatches
    part = {k: v[:n] for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(13)

    def run():
        renderings, history = model(part, 0.5, None, compute_extras=False,
                                    train=True, generator=gen)
        total, _, _ = losses_lib.compute_all_losses(part, renderings,
                                                    history, cfg)
        total.backward()

    recorded = record_k4_calls(torch, gather, hashgrid, run, "take_cm")
    model.zero_grad(set_to_none=True)
    by_n = {}
    for table, idx in recorded:
        by_n.setdefault(idx.shape[1], []).append((table, idx))
    check(len(by_n) == 2, f"a camera microbatch's take_cm calls have point "
          f"counts {sorted(by_n)}; expected the proposal's and the NeRF "
          f"field's")
    del recorded
    calls = []
    for grid, npts in zip(("nerf", "proposal"), sorted(by_n)):
        table, idx = most_rows(torch, by_n[npts])
        c, flat = table.shape[0], idx.reshape(-1)
        got = gather.take_cm(table, idx)
        check(torch.equal(got, gather.take_cm_plain(table, idx)),
              f"take_cm on the camera step's {grid} indices differs from "
              f"its plain version")
        touched = gather.rows_touched(table, flat)
        m = flat.numel()
        g = torch.randn((c, npts), generator=gen, device="cuda")
        rec = {"grid": grid, "M": m, "rows": table.shape[1],
               "rows_touched": touched,
               "ms": time_ms(lambda: gather.take_cm(table, idx), torch),
               "plain_ms": time_ms(lambda: gather.take_cm_plain(table, idx),
                                   torch),
               "library_ms": time_ms(
                   lambda: torch.index_select(table, 1, flat), torch),
               "bound_ms": bound_ms(gather.take_cm_bytes(c, m, touched)),
               "d_w_einsum_ms": time_ms(
                   lambda: torch.einsum("chs,cs->hs", got, g), torch),
               # rows and feature grads read once, the weights' grad
               # written once.
               "d_w_einsum_bound_ms": bound_ms(4 * c * m + 4 * c * npts
                                               + 4 * m),
               "max_abs_err": 0.0}
        print(f"[{label}] take_cm at a camera step's {grid} level M={m} "
              f"rows={rec['rows']} ({touched} touched): {rec['ms']:.4f} ms "
              f"(plain {rec['plain_ms']:.4f}, index_select "
              f"{rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f}), "
              f"bitwise its plain version; the weights' gradient einsum "
              f"{rec['d_w_einsum_ms']:.4f} ms (bound "
              f"{rec['d_w_einsum_bound_ms']:.4f})", flush=True)
        calls.append(rec)
        del got, g
    torch.cuda.empty_cache()
    return calls


def cam_train_phase(torch, gather, scatter, hashgrid, step, state_lib,
                    losses_lib, cfg, batch, initial, profile=None):
    """Training with camera refinement at full width: the 64-ray gradient
    check against the CPU on the f32 phase's initial weights with seeded
    deltas of ~1e-3 (so3_exp's trig branch), the deltas included; then,
    from those weights and the deltas at 0 on the f32 phase's batch, one
    warm-up (eager) and CAM_STEPS timed steps, then one step more with
    the kernels it runs counted on the card (the later steps replayed from
    the step's graph).  Every K4 launch is take_cm (16 a microbatch);
    fused K1 20, K2 20 and 40 run starts a step as in the f32 phase, in
    the eager step and in a replayed one.  Then take_cm held and timed at
    one microbatch's real indices, and with `profile` one step's kernel
    table written there."""
    model = step.init_model(cfg, seed=0, device="cuda")
    missing, unexpected = model.load_state_dict(initial, strict=False)
    check(missing == ["cam_refine.se3_deltas"] and not unexpected,
          f"camera model: missing {missing}, unexpected {unexpected}")
    deltas = model.cam_refine.se3_deltas
    with torch.no_grad():
        deltas.normal_(0.0, 1e-3, generator=torch.Generator(
            device="cuda").manual_seed(14))
    grad = grad_check_phase(torch, losses_lib, model, cfg, batch)
    check("cam_refine.se3_deltas" in grad["checked"],
          "the gradient check did not hold the camera deltas")
    with torch.no_grad():
        deltas.zero_()
    state = state_lib.create_train_state(cfg, model)
    train_step = step.make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    reset_launches(gather, scatter)
    state, _ = train_step(state, batch, 0.5, generator=gen)  # warm-up
    torch.cuda.synchronize()
    eager = read_launches(gather, scatter)
    check_take_entry(gather, "train camera refinement")
    d = model.cam_refine.se3_deltas.grad.detach().cpu()
    check(bool(torch.isfinite(d).all()) and bool(d[:, :3].abs().max() > 0)
          and bool(d[:, 3:].abs().max() > 0),
          f"camera deltas' first gradient {d.tolist()}: expected finite and "
          f"nonzero in the rotation and the translation half")

    torch.cuda.reset_peak_memory_stats()
    secs, totals = [], []
    for _ in range(CAM_STEPS):
        t0 = time.perf_counter()
        state, stats = train_step(state, batch, 0.5, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        totals.append(float(stats["loss"]))
    peak = torch.cuda.max_memory_allocated()
    (state, _), launches, _ = device_launches(
        lambda: train_step(state, batch, 0.5, generator=gen))
    check(train_step.captures == 1
          and train_step.replays == CAM_STEPS + 1,
          f"camera steps: {train_step.captures} graph captures and "
          f"{train_step.replays} replays in {CAM_STEPS + 1} steps after the "
          f"warm-up, expected 1 and {CAM_STEPS + 1}")
    check(all(np.isfinite(totals)), f"camera steps: losses {totals}")
    deltas = model.cam_refine.se3_deltas.detach().cpu()
    check(bool(deltas.abs().max() > 0), "camera deltas did not move")
    check_step_launches("camera steps", step_launches(cfg), eager, launches)
    med = float(np.median(secs))
    print(f"[cam] waymo + optimize_cameras + contract_origin_grads "
          f"{TRAIN_RAYS} rays x {CAM_STEPS} steps ({cfg.microbatches} "
          f"microbatches): step s {[round(x, 4) for x in secs]}, train "
          f"rays/s {TRAIN_RAYS / med:.1f}, peak {peak} B "
          f"({peak / 2**30:.2f} GiB), loss {[round(x, 5) for x in totals]}, "
          f"launches of a replayed step on the card {launches} (K4 all "
          f"take_cm), deltas after {CAM_STEPS + 2} steps "
          f"{deltas.tolist()}", flush=True)
    real = take_real_step(torch, gather, hashgrid, losses_lib, model, cfg,
                          batch)
    if profile:
        profile_train_step(torch, model, cfg, batch, step, state_lib, profile)
    del state, train_step, model
    torch.cuda.empty_cache()
    return {"rays_per_s": TRAIN_RAYS / med, "step_seconds": secs,
            "peak_bytes": peak, "totals": totals, "launches": launches,
            "launches_per_step": launches, "launches_eager_step": eager,
            "first_delta_grad": d.tolist(), "deltas": deltas.tolist(),
            "take_cm_real_step": real, "grad_check": grad}


def step_launches(cfg):
    """Launches a step of the f32 backward on `cfg` by kernel: a proposal
    and a NeRF field a microbatch (16 levels), each with a hashed part
    (fused K1) and a dense part (K2) of its table gradient, each sort
    ending with the run starts."""
    hashed = 2 * cfg.microbatches
    return {"K1": hashed, "K1_fused": hashed, "K1_plain": 0,
            "K2": 2 * cfg.microbatches, "K3": 0, "K3_fused": 0,
            "K3_planar": 0, "K4": 16 * cfg.microbatches, "K5": 0,
            "starts": hashed + 2 * cfg.microbatches}


# The rig phase: tools/cam_refine_quality.py's under-calibrated rig at full
# width, configs.synthetic_quality() with single-query lookups on both
# fields as QUALITY_r04.md ran it: two rig slots, camera 1 perturbed by
# RIG_ROT_DEG about the tool's axis and by RIG_TRANS (norm 0.045).  The off
# arm takes RIG_OFF_STEPS steps; the composed arm (camera refinement,
# contract_origin_grads, virtual warping) RIG_STEPS, its schedule's length
# as in the tool (the learning rate's delay of 300 steps not reached).
RIG_BINDINGS = ("NerfMLP.hex_single_query = True",
                "PropMLP.hex_single_query = True")
RIG_ROT_DEG = 1.0
RIG_TRANS = (0.03, -0.03, 0.015)
RIG_OFF_STEPS = 3
RIG_STEPS = 150
# The cut (injected / residual) of the rotation and the translation that
# the composed arm's RIG_STEPS steps must reach.  Two runs of the tool at
# --steps 150 on the H100 left 0.9587288 deg / 0.0394450 of the injected
# 1 deg / 0.045 (bitwise the same twice; cuts 1.0430 / 1.1408): the
# learning rate's delay holds the deltas back.  With a margin of 2 on the
# error removed, at least half of it must go: residuals at most 0.97936 deg
# / 0.042222.
RIG_CUT = (1.0210, 1.0658)
# The gradient check's 64 rays: real and virtual rays of one composed
# batch drawn from a stream of its own (after the training, whose first
# batch built the correspondence pool from the tool's stream).
RIG_CHECK_RAYS = (52, 12)
RIG_CHECK_SEED = 99


def check_virtual_fifth(arm, batch, label):
    """`batch`'s last fifth comes from the correspondence pool of the
    virtual views, not from the fall-back to real rays: its rays leave the
    virtual cameras' centres, some of them away from every real one, and
    the rest leave real cameras."""
    pool = arm.train._warp_pool
    check(pool is not None and len(pool["src_cam_idx"]) > 0,
          f"{label}: no correspondence pool")
    n = len(batch["origins"])
    nv = n // 5

    def dist(origins, poses):
        return np.abs(origins[:, None] - poses[None, :, :3, 3]).max(
            -1).min(-1)

    virtual = batch["origins"][n - nv:]
    check(dist(virtual, arm.train.virtual_poses).max() < 1e-5
          and dist(virtual, arm.train.camtoworlds).max() > 1e-3
          and dist(batch["origins"][:n - nv],
                   arm.train.camtoworlds).max() < 1e-5,
          f"{label}: the batch's last {nv} rays are not virtual rays")
    return {"pool_size": int(len(pool["src_cam_idx"])),
            "virtual_rays": nv}


def rig_arm(torch, gather, scatter, step, tool, arm, steps, delta, label):
    """`steps` of the tool's training on `arm`, its launches counted from
    0 by the kernel wrappers; the launches a step checked over the calls
    whose Python issued them: the eager calls and the captures (a capture
    issues each launch once, into the graph, and runs its first replay;
    a replay issues nothing)."""
    reset_launches(gather, scatter)
    t0 = time.perf_counter()
    with made_train_steps(step) as made:
        stats = tool.train(arm, steps, log_every=max(steps // 3, 1),
                           delta=delta)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(gather, scatter)
    loss = float(stats["loss"])
    check(np.isfinite(loss), f"{label}: loss {loss}")
    check(len(made) == 1, f"{label}: {len(made)} train steps made")
    issued = steps - made[0].replays + made[0].captures
    per_step = step_launches(arm.cfg)
    for k, n in per_step.items():
        check(launches[k] == n * issued,
              f"{label}: {k} launched {launches[k]} times in {issued} "
              f"eager calls and captures, expected {n} per step")
    return {"steps": steps, "seconds": secs, "steps_per_s": steps / secs,
            "rays_per_s": steps * arm.cfg.batch_size / secs,
            "train_loss": loss, "launches": launches,
            "launches_per_step": per_step,
            "graph": {"captures": made[0].captures,
                      "replays": made[0].replays}}


def rig_phase(torch, gather, scatter, hashgrid, configs, step, losses_lib):
    """The rig phase: the tool's off arm for RIG_OFF_STEPS steps (every K4
    launch the fused entry; no camera deltas, so the residual stays the
    injected error), then its composed arm for RIG_STEPS steps (every K4
    launch take_cm) from the tool's own init and batch stream, the residual
    rig error cut by RIG_CUT.  Then, on the arm's init with weights made
    random and deltas seeded near 1e-3 (so3_exp's trig branch), a 64-ray
    microbatch of real and virtual rays from a batch whose virtual fifth comes from the
    correspondence pool: losses and gradients on the card, a CPU copy and
    a float64 CPU copy (grad_check_pass: single-query lookups carry more
    f32 rounding than the camera phase's tolerances allow either device);
    and K4's take_cm held bitwise and timed at the indices of the
    microbatch that holds the virtual fifth."""
    from ucnerf_tpu_torch.tools import cam_refine_quality as tool

    t_phase = time.perf_counter()
    cfg = configs.load_config("synthetic_quality", RIG_BINDINGS)
    composed = dataclasses.replace(cfg, virtual_poses=True)
    delta = tool._rigid(RIG_ROT_DEG, list(RIG_TRANS))
    rot0, tr0 = RIG_ROT_DEG, float(np.linalg.norm(RIG_TRANS))
    res = {"bindings": list(RIG_BINDINGS), "injected_rot_deg": rot0,
           "injected_trans": tr0}

    off = tool.setup(cfg, delta, RIG_OFF_STEPS, optimize=False,
                     device="cuda")
    check(getattr(off.model, "cam_refine", None) is None,
          "rig off: the model has camera deltas")
    res["off"] = rig_arm(torch, gather, scatter, step, tool, off,
                         RIG_OFF_STEPS, None, "rig off")
    check_fused_entry(gather, "rig off")
    rot, tr = map(float, tool.residual_error(np.zeros((2, 6), np.float32),
                                             delta))
    check(abs(rot - rot0) < 1e-5 and abs(tr - tr0) < 1e-7,
          f"rig off: residual {rot} deg / {tr}, injected {rot0} / {tr0}")
    res["off"].update(residual_rot_deg=rot, residual_trans=tr)
    del off
    torch.cuda.empty_cache()

    arm = tool.setup(composed, delta, RIG_STEPS, optimize=True,
                     origin_grads=True, device="cuda")
    # The checks below start from the init (after training, the field
    # turns opaque under random tables and the sky NeRF gets no gradient).
    init = {k: v.clone() for k, v in arm.model.state_dict().items()}
    res["composed"] = rig_arm(torch, gather, scatter, step, tool, arm,
                              RIG_STEPS, delta, "rig composed")
    check_take_entry(gather, "rig composed")
    se3 = tool.se3_deltas(arm)
    rot, tr = map(float, tool.residual_error(se3, delta))
    res["composed"].update(residual_rot_deg=rot, residual_trans=tr,
                           cut=[rot0 / rot, tr0 / tr],
                           se3_deltas=se3.tolist())

    sample = arm.train.sample_batch(np.random.default_rng(RIG_CHECK_SEED),
                                    composed.batch_size)
    res["virtual"] = check_virtual_fifth(arm, sample, "rig")
    n_real, n_virtual = RIG_CHECK_RAYS
    nv = res["virtual"]["virtual_rays"]
    part = step.batch_to_device(
        {k: np.concatenate([v[:n_real], v[len(v) - nv:][:n_virtual]])
         for k, v in sample.items()}, "cuda")
    arm.model.load_state_dict(init)
    del init
    randomize_weights(torch, arm.model, 2)
    with torch.no_grad():
        arm.model.cam_refine.se3_deltas.normal_(
            0.0, 1e-3, generator=torch.Generator(device="cuda").manual_seed(
                14))
    res["grad_check"] = grad_check_pass(torch, losses_lib, arm.model,
                                        arm.cfg, part, "rig", keyed=False)
    n = composed.batch_size // composed.microbatches
    res["take_cm_real_step"] = take_real_step(
        torch, gather, hashgrid, losses_lib, arm.model, arm.cfg,
        {k: v[n:] for k, v in step.batch_to_device(sample, "cuda").items()},
        label="rig")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[rig] synthetic_quality + single query, camera 1 off by "
          f"{rot0} deg / {tr0:.4f}: off {RIG_OFF_STEPS} steps "
          f"{res['off']['steps_per_s']:.2f} steps/s, loss "
          f"{res['off']['train_loss']:.5f}, launches "
          f"{res['off']['launches']}; composed {RIG_STEPS} steps "
          f"{res['composed']['steps_per_s']:.2f} steps/s, loss "
          f"{res['composed']['train_loss']:.5f}, residual {rot!r} deg / "
          f"{tr!r} (cut {rot0 / rot:.4f}x / {tr0 / tr:.4f}x, required "
          f"{RIG_CUT[0]}x / {RIG_CUT[1]}x), launches "
          f"{res['composed']['launches']} (K4 all take_cm); virtual fifth "
          f"{nv} rays from a pool of {res['virtual']['pool_size']}; phase "
          f"{res['seconds']:.1f} s", flush=True)
    check(rot0 / rot >= RIG_CUT[0] and tr0 / tr >= RIG_CUT[1],
          f"rig composed: residual {rot} deg / {tr} after {RIG_STEPS} "
          f"steps cuts the injected {rot0} / {tr0} by {rot0 / rot:.4f}x / "
          f"{tr0 / tr:.4f}x, less than {RIG_CUT}")
    paths = {"rig_off": res["off"]["launches"],
             "rig_composed": res["composed"]["launches"]}
    del arm, part, sample
    torch.cuda.empty_cache()
    return res, paths


# The normals and options phases: timed steps after a warm-up.
NORMALS_STEPS = 3
OPTIONS_STEPS = 3
# The reference encoder's check: points a call (extract's query size)
# through the canonical NeRF grid.
ENCODE_POINTS = 2**20
# The card against the CPU where the field's normals or bf16 matmuls are
# on: both devices run f32, and the normals (normalized gradients of the
# density: table differences across a cell times the grid resolution)
# amplify rounding ~100x, as the bf16 roundings amplify a value at a
# rounding midpoint.  On the CPU, f32 against float64 already misses the
# camera phase's tolerances (the normals microbatch: the NeRF table by
# 3.1e-3 x max|grad|, density_hidden by 1.1e-3, the predicted-normal loss
# by 2e-4 relative).  So each side is held against a float64 CPU run: the card's
# error in every loss term and every gradient entry may be at most
# F64_FACTOR x the CPU's largest error in that tensor, plus the camera
# phase's tolerance (GRAD_LOSS_RTOL; GRAD_RTOL with GRAD_ATOL_FRAC x
# max|grad|, the tables and density_hidden.weight table_atol_frac).  A
# leaf's error comes from the few samples whose normal is ill-conditioned
# (a short gradient), so two f32 summation orders put it a few times apart:
# the NeRF field's density_hidden.bias is 1.56e-3 x max|grad| off on the
# H100 and 5.6e-4 on the CPU.
F64_FACTOR = 4.0
# A ReLU kink: where a ReLU-fed unit's pre-activation lies within rounding
# of 0, the card and float64 can put it on opposite sides, and the ReLU
# passes that sample's gradient on one side only: that unit's weight row and
# bias take the whole of the sample's contribution on one side and none on
# the other (tests/test_torch_grad_draws.py shows the same between JAX and
# the port).  The flagship's 64-ray microbatch has one past the tolerance (on
# the H100: the NeRF field's lin_second_stage_1 unit 1, whose weight row and
# bias were 1.9e-4 x max|grad| off, 2.4e-7 on the CPU).  So the CPU copies
# take the card's branch there (replay_relu_branch): where a unit's
# pre-activation has the other sign than the card's and both lie within
# KINK_FRAC of the unit's largest |value| in the copy, the copy's
# pre-activation is replaced by the card's, its gradient passing unchanged.
# No tolerance grows; a unit may have at most KINK_CAP such samples in a
# pass, and more fail the check.  The ReLU-fed layers of the fields, by the
# last part of their names:
RELU_FED = ("density_hidden", "lin_second_stage_")
KINK_FRAC = 1e-4
KINK_CAP = 2


def with_mlps(cfg, **mlp):
    """cfg with `mlp` set on both fields (what -b 'NerfMLP.x = ...' and
    -b 'PropMLP.x = ...' set)."""
    return dataclasses.replace(
        cfg, nerf_mlp=dataclasses.replace(cfg.nerf_mlp, **mlp),
        prop_mlp=dataclasses.replace(cfg.prop_mlp, **mlp))


def normals_config(configs):
    """configs.waymo() with density and predicted normals on both fields
    (the JAX losses walk every level and raise on a missing normal),
    contract_origin_grads (without it the JAX package's density normals are
    zero: its contraction stops their gradient), and the ref-NeRF weights
    of the orientation and predicted-normal losses.  The preset's learning
    rate delay stays: at the full rate from step 0 the first steps drive
    the field into a degenerate state (total loss 9.7, the orientation
    term 0), and the timed steps, the double backward's recorded inputs
    and the render would come from it."""
    cfg = configs.waymo(contract_origin_grads=True,
                        orientation_loss_mult=0.1,
                        orientation_coarse_loss_mult=0.01,
                        predicted_normal_loss_mult=3e-4,
                        predicted_normal_coarse_loss_mult=3e-5)
    return with_mlps(cfg, disable_density_normals=False,
                     enable_pred_normals=True)


def options_config(configs):
    """configs.waymo() with the field's remaining options on, at exercise
    values (no published preset sets them): bf16 matmuls in both fields,
    scale featurization in the NeRF field, density and bottleneck noise, a
    random background colour and the interlevel loss.  The preset's
    learning-rate delay stays, as in normals_config (at the full rate the
    first step sends the total loss to 8.8)."""
    cfg = configs.waymo(interlevel_loss_mult=1.0)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bg_intensity_range=(0.0, 1.0)))
    cfg = with_mlps(cfg, compute_dtype="bfloat16", density_noise=1.0,
                    bottleneck_noise=0.1)
    return dataclasses.replace(cfg, nerf_mlp=dataclasses.replace(
        cfg.nerf_mlp, scale_featurization=True))


@contextlib.contextmanager
def shared_draws(torch, draws, dtype):
    """Within, ``torch.rand`` and ``torch.randn`` record their draws in
    `draws` while it is empty and hand them back in order, on the asked
    device and in `dtype`, once it is not: the model's keyed draws
    (jitter, hex flip, rotation and basis, the fields' noise, the
    background) are then the card's on the CPU copies too."""
    real = {"rand": torch.rand, "randn": torch.randn}
    replay = list(draws)

    def make(name):
        def draw(*size, generator=None, device=None, **kwargs):
            if not replay:
                out = real[name](*size, generator=generator, device=device,
                                 **kwargs)
                draws.append(out.detach().cpu())
                return out
            out = replay.pop(0)
            shape = size[0] if len(size) == 1 and not isinstance(
                size[0], int) else size
            check(tuple(out.shape) == tuple(shape),
                  f"replayed {name} draw {tuple(out.shape)} for {shape}")
            return out.to(device, dtype)
        return draw

    torch.rand, torch.randn = make("rand"), make("randn")
    try:
        yield
    finally:
        torch.rand, torch.randn = real["rand"], real["randn"]
        check(not replay, f"{len(replay)} recorded draws not replayed")


def grad_check_f64(torch, losses_lib, model, cfg, batch, label):
    """One 64-ray microbatch on the card, on a CPU copy and on a float64
    CPU copy, twice: with generator=None and a given rand_vec, and keyed by
    a seeded generator whose draws are the card's on all three
    (shared_draws).  Every loss term and gradient entry of the card within
    F64_FACTOR x the CPU's largest error of that tensor against float64,
    plus the camera phase's tolerance; and each hash table's gradient
    within F64_FACTOR x the CPU's relative L2 error against float64, plus
    GRAD_ATOL_FRAC.  Both CPU copies take the card's branch at the ReLU
    kinks (replay_relu_branch), at most KINK_CAP samples a unit."""
    return {"unkeyed": grad_check_pass(torch, losses_lib, model, cfg, batch,
                                       label, keyed=False),
            "keyed": grad_check_pass(torch, losses_lib, model, cfg, batch,
                                     f"{label} keyed", keyed=True)}


def relu_fed(model):
    """The fields' ReLU-fed layers of `model`, by name."""
    return [(name, module) for name, module in model.named_modules()
            if name.rpartition(".")[2].startswith(RELU_FED)]


def record_relu_pre(torch, model, record):
    """Hooks that record each ReLU-fed layer's pre-activation, a call at a
    time, in record[name] (float64, on the CPU)."""
    def hook(name):
        def forward(module, args, out):
            record.setdefault(name, []).append(
                out.detach().to("cpu", torch.float64))
        return forward
    return [module.register_forward_hook(hook(name))
            for name, module in relu_fed(model)]


def replay_relu_branch(torch, model, card, kinks):
    """Hooks that put the copy `model` on the card's side of every ReLU
    kink: where a ReLU-fed unit's pre-activation and the card's (card[name],
    a call at a time, as record_relu_pre recorded them) have opposite signs
    and both lie within KINK_FRAC of the unit's largest |value| in the copy,
    the card's value replaces the copy's, the gradient passing unchanged.
    kinks[name] counts the replaced samples by unit over the calls."""
    calls = {}

    def hook(name):
        def forward(module, args, out):
            i = calls[name] = calls.get(name, -1) + 1
            check(i < len(card[name]),
                  f"{name}: call {i + 1} on the copy, {len(card[name])} on "
                  f"the card")
            a = out.detach().reshape(out.shape[0], -1)
            b = card[name][i].to(out.device, out.dtype)
            check(b.numel() == a.numel(),
                  f"{name} call {i}: pre-activation {tuple(out.shape)}, "
                  f"{tuple(b.shape)} on the card")
            b = b.reshape(a.shape)
            near = torch.maximum(a.abs(), b.abs()) <= KINK_FRAC * a.abs().amax(
                dim=1, keepdim=True)
            flip = ((a > 0) != (b > 0)) & near
            n = flip.sum(dim=1).cpu()
            kinks[name] = n if name not in kinks else kinks[name] + n
            if not bool(flip.any()):
                return out
            return out + torch.where(flip, b - a, 0).reshape(out.shape)
        return forward
    return [module.register_forward_hook(hook(name))
            for name, module in relu_fed(model)]


def grad_check_pass(torch, losses_lib, model, cfg, batch, label, keyed):
    n = 64
    part = {k: v[:n].cpu() for k, v in batch.items()}
    rand_vec = torch.from_numpy(
        np.random.default_rng(8).normal(size=(n, 3)).astype(np.float32))
    model.zero_grad(set_to_none=True)
    card = batch["origins"].device
    results, draws, pre, kinks = [], [], {}, {}
    for dev, dt in ((card, torch.float32), ("cpu", torch.float32),
                    ("cpu", torch.float64)):
        m = model if dev is card else copy.deepcopy(model).to(dev, dt)
        hooks = (record_relu_pre(torch, m, pre) if dev is card else
                 replay_relu_branch(torch, m, pre, kinks.setdefault(
                     "cpu" if dt == torch.float32 else "float64", {})))
        b = {k: v.to(dev, dt) if v.is_floating_point() else v.to(dev)
             for k, v in part.items()}
        if keyed:
            gen = torch.Generator(device=dev).manual_seed(9)
            with shared_draws(torch, draws, dt):
                renderings, history = m(b, 0.5, None, train=True,
                                        generator=gen)
        else:
            renderings, history = m(b, 0.5, rand_vec.to(dev, dt),
                                    train=True)
        total, losses, _ = losses_lib.compute_all_losses(b, renderings,
                                                         history, cfg)
        total.backward()
        for h in hooks:
            h.remove()
        results.append((dict({k: float(v.detach())
                              for k, v in losses.items()},
                             total=float(total.detach())),
                        {k: p.grad.detach().to("cpu", torch.float64)
                         for k, p in m.named_parameters()}))
        del renderings, history, total, losses
        if m is not model:
            del m
    (loss_g, grad_g), (loss_c, grad_c), (loss_64, grad_64) = results
    del pre
    kinked = {pass_: {layer: {int(u): int(n[u])
                              for u in torch.nonzero(n)[:, 0]}
                      for layer, n in by_layer.items() if bool(n.any())}
              for pass_, by_layer in kinks.items()}
    over = {pass_: {layer: units for layer, units in by_layer.items()
                    if max(units.values()) > KINK_CAP}
            for pass_, by_layer in kinked.items()}
    over = {k: v for k, v in over.items() if v}
    model.zero_grad(set_to_none=True)
    bad, worst, tables = [], {}, {}
    for k, exact in loss_64.items():
        lim = F64_FACTOR * abs(loss_c[k] - exact) + GRAD_LOSS_RTOL * abs(exact)
        if abs(loss_g[k] - exact) > lim:
            bad.append(f"loss {k}: card {loss_g[k]}, cpu {loss_c[k]}, "
                       f"float64 {exact}")
    modules = dict(model.named_modules())
    for k, exact in grad_64.items():
        scale = float(exact.abs().max())
        field, _, leaf = k.partition(".")
        frac = GRAD_ATOL_FRAC
        if leaf in ("table", "density_hidden.weight"):
            frac = table_atol_frac(modules[field].grid_spec)
        err_c = float((grad_c[k] - exact).abs().max())
        err_g = (grad_g[k] - exact).abs()
        worst[k] = (float(err_g.max()) / max(scale, 1e-30),
                    err_c / max(scale, 1e-30))
        lim = F64_FACTOR * err_c + GRAD_RTOL * exact.abs() + frac * scale
        if bool((err_g > lim).any()):
            bad.append(f"{k} (card err/max {worst[k][0]:.3g}, cpu "
                       f"{worst[k][1]:.3g})")
        if leaf == "table":
            norm = max(float(exact.norm()), 1e-30)
            rel = (float((grad_g[k] - exact).norm()) / norm,
                   float((grad_c[k] - exact).norm()) / norm)
            tables[k] = rel
            if rel[0] > F64_FACTOR * rel[1] + GRAD_ATOL_FRAC:
                bad.append(f"{k} relative L2 err: card {rel[0]:.3g}, cpu "
                           f"{rel[1]:.3g}")
    zero = [k for k, v in grad_64.items() if not bool(v.abs().max() > 0)]
    top = max(worst, key=lambda k: worst[k][0])
    print(f"[{label}] 64-ray card / CPU / float64 CPU: losses {loss_g} / "
          f"{loss_c} / {loss_64}; worst gradient err/max|grad| against "
          f"float64: card {worst[top][0]:.3g}, CPU {worst[top][1]:.3g} "
          f"({top}); limit {F64_FACTOR} x the CPU's error + rtol "
          f"{GRAD_RTOL} + {GRAD_ATOL_FRAC} x max|grad| (tables and "
          f"density_hidden.weight table_atol_frac); tables' relative L2 "
          f"err card / CPU {tables} (limit {F64_FACTOR} x the CPU's + "
          f"{GRAD_ATOL_FRAC}); {len(draws)} shared draws; zero gradients "
          f"{zero}; ReLU kinks taken on the card's side (by pass, layer, "
          f"unit: samples; at most {KINK_CAP} a unit) {kinked}", flush=True)
    check(not over, f"{label}: more than {KINK_CAP} ReLU kinks in a unit "
          f"against the card: {over}")
    check(not bad, f"{label}: card against float64 out of tolerance: {bad}")
    check(not zero, f"{label}: zero gradients: {zero}")
    return {"losses_card": loss_g, "losses_cpu": loss_c,
            "losses_float64": loss_64, "worst_grad": top,
            "worst_grad_err_frac_card": worst[top][0],
            "worst_grad_err_frac_cpu": worst[top][1],
            "table_rel_l2_card_cpu": tables, "shared_draws": len(draws),
            "relu_kinks": kinked}


def record_double_backward(torch, gather, scatter, hashgrid, losses_lib,
                           model, cfg, batch):
    """The calls that one normals microbatch's backward makes to K4's fused
    entry and to K1's fused entry over a whole table (keys of every level:
    the double backward's d/d table; the ordinary table gradient's fused K1
    covers the hashed levels alone), each launched as usual."""
    n = cfg.batch_size // cfg.microbatches
    part = {k: v[:n] for k, v in batch.items()}
    gen = torch.Generator(device="cuda").manual_seed(15)
    k1_calls = []
    rows_of = {m.grid_spec.table_rows for m in model.modules()
               if hasattr(m, "grid_spec")}

    def wsum_recorder(g, w, keys, num_rows, out=None):
        if num_rows in rows_of:
            k1_calls.append((g.detach().clone(), w.detach().clone(),
                             keys.clone(), num_rows))
        return scatter.scatter_add_wsum_cm(g, w, keys, num_rows, out=out)

    def run():
        renderings, history = model(part, 0.5, None, compute_extras=False,
                                    train=True, generator=gen)
        total, _, _ = losses_lib.compute_all_losses(part, renderings,
                                                    history, cfg)
        total.backward()

    hashgrid.scatter = types.SimpleNamespace(
        scatter_add_wsum_cm=wsum_recorder,
        scatter_add_dense_cm=scatter.scatter_add_dense_cm,
        scatter_add_wsum_packed_cm=scatter.scatter_add_wsum_packed_cm,
        scatter_add_cm=scatter.scatter_add_cm)
    try:
        k4_calls = record_k4_calls(torch, gather, hashgrid, run)
    finally:
        hashgrid.scatter = scatter
    model.zero_grad(set_to_none=True)
    return k4_calls, k1_calls


def hold_double_backward(torch, gather, scatter, hashgrid, losses_lib, model,
                         cfg, batch):
    """K4's fused entry and K1's fused entry on what the double backward of
    one normals microbatch hands them (the weights' cotangent in the place
    of the weights), held against their plain versions and timed: K4 at the
    proposal and NeRF level touching the most rows, K1 over each grid's
    whole table."""
    k4_calls, k1_calls = record_double_backward(
        torch, gather, scatter, hashgrid, losses_lib, model, cfg, batch)
    levels = sum(m.grid_spec.num_levels for m in model.modules()
                 if hasattr(m, "grid_spec"))
    check(len(k4_calls) == levels and len(k1_calls) == 2,
          f"one normals microbatch's double backward made {len(k4_calls)} "
          f"take_wsum_cm and {len(k1_calls)} whole-table fused K1 calls; "
          f"expected {levels} and 2")
    by_n = {}
    for table, idx, w in k4_calls:
        by_n.setdefault(idx.shape[1], []).append((table, idx, w))
    gen = torch.Generator(device="cuda").manual_seed(16)
    res = {"K4": [], "K1": []}
    for grid, npts in zip(("nerf", "proposal"), sorted(by_n)):
        take, wsum = hold_k4(torch, gather, *most_rows(torch, by_n[npts]),
                             gen, f"double backward {grid} level",
                             f"double backward {grid} level")
        res["K4"].append({"grid": grid, "take_cm": take,
                          "take_wsum_cm": wsum})
    del k4_calls, by_n
    for grid, (g, w, keys, rows) in zip(
            ("proposal", "nerf"), sorted(k1_calls, key=lambda c: c[3])):
        rec = wsum_call(torch, scatter, f"K1 fused double backward {grid}",
                        g, w, keys, rows)
        rec["grid"] = grid
        print_scatter(f"K1 fused double backward {grid}", rec)
        res["K1"].append(rec)
    del k1_calls
    torch.cuda.empty_cache()
    return res


def field_phase(torch, gather, scatter, hashgrid, step, state_lib,
                losses_lib, cfg, batch, model, steps, label, per_mb,
                views=None, profile=None):
    """A training path of the field's options at full width: the 64-ray
    check against float64 (grad_check_f64), one warm-up (eager, its
    launches counted by the kernel wrappers) and `steps` timed steps, then
    one step more, replayed from the step's graph, with the kernels it
    runs counted on the card (per_mb: launches by kernel per microbatch);
    two runs of 2 steps bitwise equal; with `views`, one 480x320 render of
    the first view with its launches counted; with `profile`, one step's
    kernel table written there."""
    initial = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    grad = grad_check_f64(torch, losses_lib, model, cfg, batch, label)
    state = state_lib.create_train_state(cfg, model)
    train_step = step.make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    reset_launches(gather, scatter)
    state, _ = train_step(state, batch, 0.5, generator=gen)  # warm-up
    torch.cuda.synchronize()
    eager = read_launches(gather, scatter)
    K4_BY_ENTRY["take_cm"] += gather.take_cm.launches
    K4_BY_ENTRY["take_wsum_cm"] += gather.take_wsum_cm.launches
    torch.cuda.reset_peak_memory_stats()
    secs, totals, terms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, stats = train_step(state, batch, 0.5, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        totals.append(float(stats["loss"]))
        terms.append({k: float(v) for k, v in stats["losses"].items()})
    peak = torch.cuda.max_memory_allocated()
    (state, _), launches, _ = device_launches(
        lambda: train_step(state, batch, 0.5, generator=gen))
    check(train_step.captures == 1 and train_step.replays == steps + 1,
          f"{label}: {train_step.captures} graph captures and "
          f"{train_step.replays} replays in {steps + 1} steps after the "
          f"warm-up, expected 1 and {steps + 1}")
    for i, (total, t) in enumerate(zip(totals, terms)):
        check(np.isfinite(total) and all(np.isfinite(v) for v in t.values()),
              f"{label} step {i + 1}: non-finite loss {total} {t}")
    per_step = {k: n * cfg.microbatches for k, n in per_mb.items()}
    check_step_launches(label, per_step, eager, launches)
    med = float(np.median(secs))
    print(f"[{label}] {TRAIN_RAYS} rays x {steps} steps ({cfg.microbatches} "
          f"microbatches): step s {[round(x, 4) for x in secs]}, train "
          f"rays/s {TRAIN_RAYS / med:.1f}, peak {peak} B "
          f"({peak / 2**30:.2f} GiB), loss {[round(x, 5) for x in totals]}, "
          f"launches of a replayed step on the card {launches}; loss terms "
          f"step {steps} {terms[-1]}", flush=True)
    res = {"rays_per_s": TRAIN_RAYS / med, "step_seconds": secs,
           "peak_bytes": peak, "totals": totals, "terms": terms,
           "launches": launches, "launches_per_step": launches,
           "launches_eager_step": eager, "grad_check": grad}
    if profile:
        profile_train_step(torch, model, cfg, batch, step, state_lib, profile)
    if views is not None:
        res["render"] = normals_render(torch, gather, scatter, step, model,
                                       cfg, views[0])
    del state, train_step
    torch.cuda.empty_cache()
    res["repeat"] = repeat_phase(torch, step, state_lib, ((label, cfg),),
                                 initial, batch)
    return res


def normals_render(torch, gather, scatter, step, model, cfg, view):
    """One 480x320 render of a normals model through render_image, with the
    launches counted from 0: the normals' gradient is taken inside the eval
    step's no_grad, so every K4 launch keeps its rows (take_cm, 16 a chunk)
    and no scatter runs.  Then a 64-ray chunk of the view through the eval
    step on the card, on a CPU copy and on a float64 CPU copy: the
    composited normals and predicted normals of the card within F64_FACTOR
    x the CPU's largest error against float64, plus the render check's
    tolerance (RENDER_ATOL, RENDER_RTOL)."""
    eval_step = step.make_eval_step(model, cfg, seed=0)
    chunks = -(-VIEW_W * VIEW_H // cfg.render_chunk_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(gather, scatter)
    t0 = time.perf_counter()
    out = step.render_image(eval_step, view, cfg, eval_camidx=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(gather, scatter)
    peak = torch.cuda.max_memory_allocated()
    K4_BY_ENTRY["take_cm"] += gather.take_cm.launches
    K4_BY_ENTRY["take_wsum_cm"] += gather.take_wsum_cm.launches
    check(launches["K4_take"] == 16 * chunks and launches["K4_wsum"] == 0
          and all(launches[k] == 0 for k in ("K1", "K2", "K3", "K5",
                                             "starts")),
          f"normals render: launches {launches}; expected {16 * chunks} "
          f"take_cm and nothing else")
    # A composite of unit vectors is no longer than the weights' sum.
    for k in ("normals", "normals_pred"):
        check(out[k].shape == (VIEW_H, VIEW_W, 3), f"{k} {out[k].shape}")
        norm = np.linalg.norm(out[k], axis=-1)
        check(bool((norm <= out["acc"] + 1e-4).all()) and norm.max() > 0,
              f"rendered {k}: |n| in [{norm.min()}, {norm.max()}], longer "
              f"than acc at {int((norm > out['acc'] + 1e-4).sum())} pixels")
    for k, v in out.items():
        check(np.isfinite(v).all(), f"normals render: {k} not finite")
    rate = VIEW_W * VIEW_H / secs
    take_per_chunk = launches["K4_take"] / chunks
    length = float(np.mean(np.linalg.norm(out["normals"], axis=-1)
                           / np.maximum(out["acc"], 1e-6)))
    print(f"[normals] render {VIEW_W}x{VIEW_H} with the normals composited: "
          f"{secs:.3f} s, {rate:.1f} rays/s, peak {peak / 2**30:.2f} GiB, "
          f"launches {launches} (K4 all take_cm, {take_per_chunk} a chunk "
          f"x {chunks} chunks); mean |normals| / acc {length:.4f}",
          flush=True)

    stride = VIEW_W * VIEW_H // 64
    flat = {k: np.ascontiguousarray(v.reshape((-1,) + v.shape[2:])[::stride])
            for k, v in view.items()}
    rand_vec = torch.from_numpy(
        np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32))
    results = []
    for dev, dt in (("cuda", torch.float32), ("cpu", torch.float32),
                    ("cpu", torch.float64)):
        ev = eval_step if dev == "cuda" else step.make_eval_step(
            copy.deepcopy(model).to(dev, dt), cfg, seed=0)
        b = {k: torch.from_numpy(v).to(dev) for k, v in flat.items()}
        b = {k: v.to(dt) if v.is_floating_point() else v
             for k, v in b.items()}
        res = ev(b, 1.0, 0, rand_vec.to(dev, dt))
        results.append({k: res[k].to("cpu", torch.float64).numpy()
                        for k in ("normals", "normals_pred", "acc")})
        del ev
    card_r, cpu_r, f64_r = results
    errs = {}
    for k in ("normals", "normals_pred"):
        err_c = float(np.abs(cpu_r[k] - f64_r[k]).max())
        err_g = np.abs(card_r[k] - f64_r[k])
        lim = F64_FACTOR * err_c + RENDER_ATOL + RENDER_RTOL * np.abs(f64_r[k])
        errs[k] = {"card": float(err_g.max()), "cpu": err_c}
        check(bool((err_g <= lim).all()),
              f"normals render chunk: {k} card vs float64 max abs err "
              f"{errs[k]['card']}, the CPU's {err_c}")
        check(float(np.abs(f64_r[k]).max()) > 0.1,
              f"normals render chunk: {k} max |.| "
              f"{float(np.abs(f64_r[k]).max())} in float64")
    print(f"[normals] 64-ray render chunk card / CPU against float64: max "
          f"abs err {errs} (limit {F64_FACTOR} x the CPU's + atol "
          f"{RENDER_ATOL} + rtol {RENDER_RTOL})", flush=True)
    return {"seconds": secs, "rays_per_s": rate, "peak_bytes": peak,
            "launches": launches, "chunks": chunks,
            "take_cm_per_chunk": take_per_chunk, "chunk_vs_float64": errs}


def dense_bf16_times(torch, model, cfg):
    """The bf16 field matmul (DenseCM with compute_dtype='bfloat16': the
    bf16-rounded weight and input multiplied in f32, an f32 output) against
    the f32 layer, forward + backward of the NeRF field's first view-
    direction layer at one microbatch's samples."""
    layer = model.nerf_mlp.lin_second_stage_0
    m = cfg.batch_size // cfg.microbatches * cfg.model.num_nerf_samples
    x = torch.randn((layer.weight.shape[1], m), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(17),
                    requires_grad=True)
    g = torch.randn((layer.weight.shape[0], m), device="cuda")
    f32 = copy.deepcopy(layer)
    f32.compute_dtype = None

    def run(mod):
        x.grad = None
        mod.zero_grad(set_to_none=True)
        mod(x).backward(g)

    rec = {"shape": [layer.weight.shape[0], layer.weight.shape[1], m],
           "bf16_ms": time_ms(lambda: run(layer), torch),
           "f32_ms": time_ms(lambda: run(f32), torch)}
    print(f"[options] bf16 field matmul (bf16-rounded operands multiplied in "
          f"f32, f32 output) {rec['shape']} forward + backward: "
          f"{rec['bf16_ms']:.4f} ms, the f32 layer {rec['f32_ms']:.4f} ms",
          flush=True)
    return rec


def encode_check(torch, gather, scatter, hashgrid, configs, k1):
    """The reference encoder (hashgrid.encode) forward and table gradient
    at ENCODE_POINTS points through the canonical 10-level NeRF grid, with
    the launches counted from 0 (10 take_cm, one K1 plain entry), held
    against float64 plain versions on the card; K1's plain entry held and
    timed on the updates it was handed."""
    cfg = configs.waymo()
    spec = hashgrid.HashGridSpec(
        num_levels=cfg.nerf_mlp.grid_num_levels,
        level_dim=cfg.nerf_mlp.grid_level_dim,
        base_resolution=cfg.nerf_mlp.grid_base_resolution,
        desired_resolution=cfg.nerf_mlp.grid_desired_resolution,
        log2_hashmap_size=cfg.nerf_mlp.grid_log2_hashmap_size)
    gen = torch.Generator(device="cuda").manual_seed(18)
    table = (0.1 * torch.randn((spec.level_dim, spec.table_rows),
                               generator=gen, device="cuda")
             ).requires_grad_()
    x = torch.rand((ENCODE_POINTS, 3), generator=gen,
                   device="cuda") * 2.2 - 1.1  # some outside the cube
    probe = torch.randn((ENCODE_POINTS, spec.num_levels, spec.level_dim),
                        generator=gen, device="cuda")
    recorded = []

    def k1_recorder(values, idx, num_rows, out=None):
        recorded.append((values.detach().clone(), idx.clone(), num_rows))
        return scatter.scatter_add_cm(values, idx, num_rows, out)

    torch.cuda.synchronize()
    reset_launches(gather, scatter)
    t0 = time.perf_counter()
    feats = hashgrid.encode(x, table, spec)
    (feats * probe).sum().backward()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(gather, scatter)
    K4_BY_ENTRY["take_cm"] += gather.take_cm.launches
    K4_BY_ENTRY["take_wsum_cm"] += gather.take_wsum_cm.launches
    expect = {"K4_take": spec.num_levels, "K4_wsum": 0, "K1_plain": 1,
              "K1_fused": 0, "K2": 0, "K3": 0, "K5": 0, "starts": 1}
    check(all(launches[k] == n for k, n in expect.items()),
          f"encode: launches {launches}, expected {expect}")

    # Float64 plain versions of the same lookups and table gradient.
    x01 = (x + 1.0) / 2.0
    oob = ((x01 < 0) | (x01 > 1)).any(dim=-1)
    x01 = torch.clamp(x01, 0.0, 1.0).T[:, None]
    t64 = table.detach().double()
    want = []
    keys, values = [], []
    for level in range(spec.num_levels):
        idx, w, _ = hashgrid._level_corners(spec, level, x01)
        lo, hi = spec.offsets[level], spec.offsets[level + 1]
        rows = gather.take_cm_plain(t64[:, lo:hi], idx[:, 0])
        acc = (rows * w[:, 0].double()[None]).sum(dim=1)
        want.append(torch.where(oob[None], 0.0, acc).T)
        g = torch.where(oob[:, None], 0.0, probe[:, level].double()).T
        values.append((w[:, 0].double()[None] * g[:, None]).reshape(
            spec.level_dim, -1))
        keys.append((idx[:, 0] + lo).reshape(-1).long())
    want = torch.stack(want, dim=1)
    feat_err = float((feats.detach().double() - want).abs().max())
    check(feat_err <= 1e-5 * float(want.abs().max()),
          f"encode features: max err {feat_err} against float64")
    grad64 = torch.zeros_like(t64).index_add_(1, torch.cat(keys),
                                              torch.cat(values, dim=1))
    del keys, values, want
    err = (table.grad.double() - grad64).abs()
    scale = float(grad64.abs().max())
    check(bool((err <= SCATTER_RTOL * grad64.abs()
                + SCATTER_ATOL_FRAC * scale).all()),
          f"encode table gradient: max err {float(err.max())} against "
          f"float64 (max |grad| {scale})")
    grad_err = float(err.max())
    del grad64, err

    # K1's plain entry on the updates the backward handed it.
    hashgrid.scatter = types.SimpleNamespace(scatter_add_cm=k1_recorder)
    try:
        table.grad = None
        feats = hashgrid.encode(x, table, spec)
        (feats * probe).sum().backward()
    finally:
        hashgrid.scatter = scatter
    values, idx, rows = recorded[0]
    del feats, recorded
    out = scatter.scatter_add_cm(values, idx, rows)
    check(torch.equal(out, table.grad), "K1's plain entry on the recorded "
          "updates differs from the encoder's table gradient")
    check(torch.equal(out, scatter.scatter_add_cm(values, idx, rows)),
          "K1's plain entry is not bitwise repeatable")
    perm, starts = scatter.sort_rows(idx, rows)
    c, m = values.shape
    idx64 = idx.long()
    rec = {"M": m, "rows": rows, "points": ENCODE_POINTS,
           "levels": spec.num_levels, "seconds_forward_backward": secs,
           "ms": time_ms(lambda: scatter.scatter_add_cm(values, idx, rows,
                                                        out=out), torch),
           "launch_ms": time_ms(lambda: scatter.segment_sum_cm(
               values, perm, starts, out), torch),
           "prep_ms": time_ms(lambda: scatter.sort_rows(idx, rows), torch),
           "plain_ms": time_ms(lambda: scatter.scatter_add_cm_plain(
               values, idx, rows, out), torch),
           "library_ms": time_ms(lambda: out.zero_().index_add_(
               1, idx64, values), torch),
           # values and keys read once, the table gradient written once.
           "bound_ms": bound_ms(4 * c * m + 4 * m + 4 * c * rows),
           "bound_by": "bytes", "max_abs_err": grad_err,
           "feature_max_abs_err": feat_err, "launches": launches}
    print(f"[encode] hashgrid.encode at {ENCODE_POINTS} points x "
          f"{spec.num_levels} levels: forward + backward {secs:.3f} s, "
          f"launches {launches}; features max err {feat_err:.3g}, table "
          f"gradient max err {grad_err:.3g} against float64 plain versions; "
          f"K1 plain entry M={m} rows={rows}: {rec['ms']:.4f} ms (launch "
          f"half {rec['launch_ms']:.4f}, prep {rec['prep_ms']:.4f}, plain "
          f"{rec['plain_ms']:.4f}, index_add_ {rec['library_ms']:.4f}, "
          f"bound {rec['bound_ms']:.4f}), bitwise repeatable", flush=True)
    k1["encode"] = rec
    del values, idx, idx64, out, perm, starts, table, x, probe
    torch.cuda.empty_cache()
    return launches


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


def cli_argv(exp):
    """The CLI phase's flags (all but --max-steps), in folder `exp`."""
    return ["--preset", "synthetic_quality",
            "-b", 'NerfMLP.grid_bwd_value_dtype = "bfloat16"',
            "-b", 'PropMLP.grid_bwd_value_dtype = "bfloat16"',
            "-b", f"Config.exp_name = {exp!r}",
            "-b", f"Config.print_every = {CLI_PRINT_EVERY}",
            "-b", f"Config.train_render_every = {CLI_STEPS[0]}",
            "-b", f"Config.checkpoint_every = {CLI_CHECKPOINT_EVERY}",
            "-b", f"Config.checkpoints_total_limit = {CLI_KEEP}",
            "-b", "Config.lr_delay_steps = 0"]


def cli_phase(torch, gather, scatter, cli_train, batch_size, exp):
    """The training entry point in-process on the synthetic scene, with the
    bf16 backward: train, test render, checkpoints, then resume, in the
    experiment folder `exp` (the serving phase goes on from its last
    checkpoint).  Two rates come out: the one the CLI logs, over the steady
    windows alone (`steady_windows`), and steps x batch_size over the
    seconds of each whole call, with its set-up, test render and saves."""
    from ucnerf_tpu_torch.train import step
    first, second = CLI_STEPS
    argv = cli_argv(exp)
    log_path = os.path.join(exp, "log_train.txt")
    microbatches, levels = 2, 16  # of the preset; 6 proposal + 10 NeRF levels
    results = []
    offset = 0
    for max_steps, start in ((first, 0), (second, first)):
        reset_launches(gather, scatter)
        t0 = time.perf_counter()
        with made_train_steps(step) as made:
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
        # The kernel wrappers count the launches of the eager calls and
        # the captures (each of which also runs the graph's first replay).
        check(len(made) == 1, f"CLI: {len(made)} train steps made")
        issued = steps - made[0].replays + made[0].captures
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
        kept = sorted(os.listdir(os.path.join(exp, "checkpoints")), key=int)
        # The last CLI_KEEP saves are left (20 and 30, then 30 and 40).
        want = [str(v) for v in CLI_SAVES[max_steps]]
        check(kept == want, f"CLI: checkpoints {kept}, expected {want}")
        check(launches["K3"] == issued * microbatches * 2
              and launches["K3_fused"] == launches["K3"]
              and launches["K3_planar"] == 0
              and launches["K2"] == issued * microbatches * 2
              and launches["starts"] == issued * microbatches * 4
              and launches["K1"] == 0,
              f"CLI: launches {launches} in {issued} eager calls and "
              f"captures (of {steps} steps), of {microbatches} "
              f"microbatches")
        steady = {k: lines[k][2]
                  for k in steady_windows(lines, start, first)}
        results.append({"max_steps": max_steps, "seconds": secs,
                        "launches": launches, "log": lines,
                        "graph": {"captures": made[0].captures,
                                  "replays": made[0].replays},
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
            chunks = (launches["K4"] - issued * microbatches * levels)
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


def ckpt_step_phase(torch, gather, scatter, configs, exp):
    """``ucnerf_tpu_torch/tools/eval_ckpt_step.py`` in-process on the CLI
    phase's older retained checkpoint (step 30, kept beside 40), its
    launches counted from 0 (K4 alone, all ``take_wsum_cm``, 16 a render
    chunk); its PSNR and SSIM of CKPT_STEP_VIEWS equal to those of
    ``cli.eval`` on a folder that holds only that step."""
    from ucnerf_tpu_torch.cli import eval as cli_eval
    from ucnerf_tpu_torch.data import datasets
    from ucnerf_tpu_torch.tools import eval_ckpt_step

    older = CLI_SAVES[CLI_STEPS[-1]][0]
    binding = f"Config.exp_name = {exp!r}"
    cfg = configs.load_config("synthetic_quality", [binding])
    test = datasets.load_dataset("test", cfg)
    chunks = -(-test.width * test.height // cfg.render_chunk_size)
    views = [str(v) for v in CKPT_STEP_VIEWS]
    reset_launches(gather, scatter)
    t0 = time.perf_counter()
    step, scores = eval_ckpt_step.main(
        ["--preset", "synthetic_quality", "-b", binding, "--step",
         str(older), "--indices", *views])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches(gather, scatter)
    check_fused_entry(gather, "eval_ckpt_step")
    want = 16 * chunks * len(views)
    check(step == older and launches["K4"] == want and all(
        n == 0 for k, n in launches.items() if not k.startswith("K4")),
          f"eval_ckpt_step: step {step}, launches {launches}; expected "
          f"{want} K4 ({len(views)} views of {chunks} chunks) alone")

    # cli.eval on a folder that holds step `older` alone.
    only = tempfile.mkdtemp(prefix="ucnerf_ckpt_step_")
    try:
        shutil.copytree(os.path.join(exp, "checkpoints", str(older)),
                        os.path.join(only, "checkpoints", str(older)))
        eval_secs, eval_launches = serving_cli(
            torch, gather, scatter, "eval_ckpt_step cli eval", cli_eval.main,
            ["--preset", "synthetic_quality", "-b",
             f"Config.exp_name = {only!r}", "--limit", str(len(views))])
        metrics = {}
        for key in ("psnr", "ssim"):
            with open(os.path.join(only, f"{key}_{older}.txt")) as f:
                metrics[key] = [float(v) for v in f.read().split()]
    finally:
        shutil.rmtree(only, ignore_errors=True)
    got = {key: [float(scores[int(v)][key]) for v in views]
           for key in ("psnr", "ssim")}
    check(got == metrics, f"eval_ckpt_step at step {older}: {got}; cli.eval "
                          f"on a folder of that step alone: {metrics}")
    res = {"step": older, "views": len(views), "seconds": secs,
           "cli_eval_seconds": eval_secs, "metrics": got}
    print(f"[ckpt_step] eval_ckpt_step on step {older} (kept beside "
          f"{CLI_STEPS[-1]}): psnr {got['psnr']}, ssim {got['ssim']} in "
          f"{secs:.2f} s, equal to cli.eval on a folder of that step alone "
          f"({eval_secs:.2f} s); launches {launches}", flush=True)
    return res, {"eval_ckpt_step": launches,
                 "eval_ckpt_step_cli_eval": eval_launches}


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


# The jax_import phase: checkpoints of the JAX package on the card.  The
# fixture (tests/fixtures/, written by tests/torch_jax_fixture.py with JAX on
# the CPU: a tiny-preset train state after 2 steps, its eval rays and JAX's
# render of them, a training batch with JAX's gradient and next state) goes
# through cli.import_jax; the full-width round trip starts from the CLI
# phase's checkpoint.  The cli.train steps resumed from each folder of the
# round trip:
JAX_RESUME_STEPS = 2
# The fixture's render and step against JAX's CPU values: the CPU tests'
# tolerances (tests/test_torch_jax_checkpoint.py: the render rtol 1e-4,
# atol 1e-5; gradients rtol 1e-4 with 1e-5 x max|grad|, 2e-5 for the
# tables, plus F64_FACTOR x the port's own f32 error against float64 on the
# step's batch) plus this script's card-vs-CPU headroom (RENDER_RTOL and
# RENDER_ATOL; GRAD_RTOL with grad_atol_frac), the gradient tolerance
# carried through the clips and Adam by torch_jax_fixture.adam_step_bound.
JAX_RENDER_RTOL = 1e-4 + RENDER_RTOL
JAX_RENDER_ATOL = 1e-5 + RENDER_ATOL
JAX_GRAD_RTOL = 1e-4 + GRAD_RTOL
JAX_GRAD_ATOL_FRAC = {"table": 2e-5, "other": 1e-5}


def jax_fixture_module():
    """tests/torch_jax_fixture.py: its paths and its numpy and torch
    helpers (it imports numpy alone at its top; nothing here calls its JAX
    functions)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_jax_fixture
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                            "ucnerf_tpu")]
    check(not loaded, f"the JAX side was imported: {loaded}")
    return torch_jax_fixture


def port_name(key):
    """An export path as the port's parameter name."""
    *path, leaf = key.split("/")
    return ".".join(path + ["weight" if leaf == "kernel" else leaf])


def jax_fixture_phase(torch, gather, scatter, configs, step, state_lib,
                      folder):
    """The JAX fixture on the card: cli.import_jax with its default device
    (nothing launched), then the fixture's 64 eval rays through
    make_eval_step (K4's fused entry) against JAX's CPU render, and one f32
    make_train_step on its training batch with generator=None and
    microbatches=1 (K1's fused entry, K2, K4) whose parameters and Adam
    moments are held entry by entry against JAX's next state within the
    bound the gradient tolerance gives."""
    from ucnerf_tpu_torch import convert
    from ucnerf_tpu_torch.cli import import_jax
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib

    fx = jax_fixture_module()
    with np.load(fx.EXPECT) as data:
        expect = {k: data[k] for k in data.files}
    before = convert.load_export(fx.EXPORT, "nerf")
    bindings = [str(b) for b in expect["bindings"]]
    exp = os.path.join(folder, "fixture")
    argv = ["--tiny", "-b", f"Config.exp_name = {exp!r}"]
    for b in bindings:
        argv += ["-b", b]
    reset_launches(gather, scatter)
    t0 = time.perf_counter()
    import_jax.main(argv + ["--export", fx.EXPORT])
    import_secs = time.perf_counter() - t0
    launches = read_launches(gather, scatter)
    check(not any(launches.values()), f"import: launches {launches}")
    cfg = configs.load_config("tiny", bindings)
    check(cfg.microbatches == 1, "the fixture's step is one microbatch")
    model = step.init_model(cfg, seed=0, device="cuda")
    state, at = ckpt_lib.restore_checkpoint(
        exp, state_lib.create_train_state(cfg, model))
    check(at == fx.STEPS and state.optimizer.count == fx.STEPS
          and state.step == fx.STEPS,
          f"the imported fixture restores at step {at}")
    res, paths = {"import_seconds": import_secs}, {}

    def part(prefix):
        return {k[len(prefix):]: torch.from_numpy(v).cuda()
                for k, v in expect.items() if k.startswith(prefix)}

    # The render: 64 rays with JAX's key=None hex basis.
    reset_launches(gather, scatter)
    with torch.no_grad():
        out = step.make_eval_step(model, cfg)(
            part("eval/batch/"), 1.0, 0,
            torch.from_numpy(expect["eval/rand_vec"]).cuda())
    torch.cuda.synchronize()
    paths["jax_import_render"] = read_launches(gather, scatter)
    check_fused_entry(gather, "jax fixture render")
    errs = {}
    for key, want in expect.items():
        if key.startswith("eval/out/"):
            name = key[len("eval/out/"):]
            got = out[name].cpu().numpy()
            errs[name] = float(np.abs(got - want).max())
            check(np.allclose(got, want, rtol=JAX_RENDER_RTOL,
                              atol=JAX_RENDER_ATOL),
                  f"jax fixture render {name}: max abs err {errs[name]}")
    res["render_max_abs_err"] = errs
    n_params = sum(v.size for k, v in before.items()
                   if k.startswith("params/"))
    print(f"[jax_import] fixture ({n_params} parameters) imported in "
          f"{import_secs:.2f} s; 64-ray render on the card vs JAX on the "
          f"CPU: max abs err {errs} (rtol {JAX_RENDER_RTOL}, atol "
          f"{JAX_RENDER_ATOL}); launches {paths['jax_import_render']}",
          flush=True)

    # One f32 step with generator=None on the training batch.
    batch, rand_vec = part("train/batch/"), torch.from_numpy(
        expect["train/rand_vec"])
    f32_err = fx.f32_grad_error(model, cfg, batch, rand_vec)
    modules = dict(model.named_modules())

    def grad_tol(key, g):
        kind = "table" if key.endswith("table") else "other"
        frac = JAX_GRAD_ATOL_FRAC[kind] + grad_atol_frac(modules,
                                                         port_name(key))
        return (JAX_GRAD_RTOL * np.abs(g) + frac * np.abs(g).max()
                + fx.F64_FACTOR * f32_err[key])

    # The card takes JAX's side of every ReLU kink, as the CPU test does.
    kinks = {}
    hooks = fx.jax_relu_branch(model, expect, kinks)
    reset_launches(gather, scatter)
    new_state, _ = step.make_train_step(model, cfg)(
        state, batch, float(expect["train_frac"]), rand_vec=rand_vec.cuda())
    torch.cuda.synchronize()
    launches = paths["jax_import_step"] = read_launches(gather, scatter)
    for h in hooks:
        h.remove()
    for name, n in kinks.items():
        check(int(n.max()) <= fx.KINK_CAP,
              f"jax fixture step: {name} kinks by unit {n.tolist()}")
    kinks = {name: int(n.sum()) for name, n in kinks.items()}
    check_fused_entry(gather, "jax fixture step")
    check(launches["K1_fused"] > 0 and launches["K1_plain"] == 0
          and launches["K2"] > 0 and launches["K3"] == 0,
          f"jax fixture step: launches {launches}")
    got = convert.export_arrays(new_state)
    after = {k[len("next/"):]: v for k, v in expect.items()
             if k.startswith("next/")}
    grads = {k[len("grads/"):]: v for k, v in expect.items()
             if k.startswith("grads/")}
    bound = fx.adam_step_bound(cfg, grads, grad_tol, before, after)
    worst = {}
    for key, b in bound.items():
        err = np.abs(got[key].astype(np.float64) - after[key])
        worst[key] = float((err / b).max())
        check((err <= b).all(), f"jax fixture step {key}: "
              f"{int((err > b).sum())} entries beyond the bound, max "
              f"err/bound {worst[key]:.3g}")
    for key in ("adam/count", "schedule/count", "step"):
        check(int(got[key]) == int(after[key]),
              f"jax fixture step {key}: {int(got[key])}, JAX "
              f"{int(after[key])}")
    top = max(worst, key=worst.get)
    res.update(step_launches=launches, worst_err_over_bound=worst[top],
               worst=top, kinks=kinks)
    print(f"[jax_import] fixture step on the card vs JAX's next state: "
          f"every parameter and moment within its bound, worst err/bound "
          f"{worst[top]:.3g} ({top}); JAX's ReLU branch taken at {kinks} "
          f"samples; step {int(got['step'])}; launches {launches}",
          flush=True)
    del model, state, new_state
    return res, paths


def load_state_file(torch, exp, at):
    path = os.path.join(exp, "checkpoints", str(at), "state.pt")
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return torch.load(path, map_location="cpu", weights_only=True), digest


def same_state(torch, a, b, learning_rates=True):
    """Whether two loaded state.pt payloads hold bitwise-equal parameters,
    Adam moments and counts, the step and the schedule's count (and the
    param groups' learning rates)."""
    if (a["step"], a["count"]) != (b["step"], b["count"]):
        return False
    if a["model"].keys() != b["model"].keys() or not all(
            torch.equal(v, b["model"][k]) for k, v in a["model"].items()):
        return False
    sa, sb = a["adam"]["state"], b["adam"]["state"]
    groups = [{k: v for k, v in g.items() if learning_rates or k != "lr"}
              for g in a["adam"]["param_groups"]]
    return (sa.keys() == sb.keys()
            and all(sa[i].keys() == sb[i].keys() and all(
                sa[i][k].dtype == sb[i][k].dtype
                and torch.equal(sa[i][k], sb[i][k]) for k in sa[i])
                for i in sa)
            and groups == [{k: v for k, v in g.items()
                            if learning_rates or k != "lr"}
                           for g in b["adam"]["param_groups"]])


def jax_roundtrip_phase(torch, gather, scatter, configs, step, state_lib,
                        cli_train, src, folder):
    """The full-width round trip on the CLI phase's last checkpoint in
    `src` (synthetic_quality, the canonical architecture): its state written
    by convert.state_to_export and imported by cli.import_jax into a fresh
    folder, every parameter, moment and count bitwise the source's; cli.eval
    of both folders with bitwise-equal metrics; cli.train resumed for
    JAX_RESUME_STEPS steps from each (the bf16 backward: K3's fused entry,
    K2, K4), the final state.pt files bitwise equal."""
    from ucnerf_tpu_torch import convert
    from ucnerf_tpu_torch.cli import eval as cli_eval
    from ucnerf_tpu_torch.cli import import_jax
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib

    at = ckpt_lib.latest_checkpoint_step(src)
    check(at == CLI_STEPS[-1], f"the CLI phase's last checkpoint is {at}")
    argv = cli_argv(src)
    cfg = configs.load_config(
        "synthetic_quality", [v for k, v in zip(argv, argv[1:]) if k == "-b"])
    model = step.init_model(cfg, seed=0, device="cuda")
    state, _ = ckpt_lib.restore_checkpoint(
        src, state_lib.create_train_state(cfg, model))
    n_params = sum(p.numel() for p in model.parameters())
    export = os.path.join(folder, "scene.npz")
    t0 = time.perf_counter()
    convert.state_to_export(state, export)
    export_secs = time.perf_counter() - t0
    size = os.path.getsize(export)
    del model, state
    torch.cuda.empty_cache()

    imported = os.path.join(folder, "imported")
    reset_launches(gather, scatter)
    t0 = time.perf_counter()
    import_jax.main(cli_argv(imported) + ["--export", export])
    torch.cuda.synchronize()
    import_secs = time.perf_counter() - t0
    launches = read_launches(gather, scatter)
    check(not any(launches.values()), f"import: launches {launches}")
    os.remove(export)
    a, _ = load_state_file(torch, src, at)
    b, _ = load_state_file(torch, imported, at)
    # The learning rate in the param groups is the schedule's at the last
    # update, for the import's max_steps (the preset's; the CLI phase's
    # --max-steps set the source's): the next update sets it anew.
    check(same_state(torch, a, b, learning_rates=False),
          "the imported checkpoint differs from its source")
    del a, b
    res = {"parameters": n_params, "export_bytes": size,
           "export_seconds": export_secs, "import_seconds": import_secs}
    print(f"[jax_import] full width: {n_params} parameters, export "
          f"{size} bytes written in {export_secs:.2f} s, imported by "
          f"cli.import_jax in {import_secs:.2f} s; every parameter, Adam "
          f"moment and count bitwise the source's", flush=True)

    paths, metrics, digests, payloads = {}, {}, {}, {}
    for label, exp in (("source", src), ("imported", imported)):
        secs, paths[f"jax_import_cli_eval_{label}"] = serving_cli(
            torch, gather, scatter, f"jax_import cli eval {label}",
            cli_eval.main, cli_argv(exp))
        metrics[label] = {}
        for key in ("psnr", "ssim", "psnr_cc", "ssim_cc"):
            with open(os.path.join(exp, f"{key}_{at}.txt")) as f:
                metrics[label][key] = f.read()
        res[f"cli_eval_{label}_seconds"] = secs
    check(metrics["source"] == metrics["imported"],
          f"cli.eval metrics differ: {metrics}")
    end = at + JAX_RESUME_STEPS
    for label, exp in (("source", src), ("imported", imported)):
        reset_launches(gather, scatter)
        t0 = time.perf_counter()
        cli_train.main(cli_argv(exp) + ["--max-steps", str(end)])
        torch.cuda.synchronize()
        res[f"resume_{label}_seconds"] = time.perf_counter() - t0
        launches = paths[f"jax_import_cli_resume_{label}"] = read_launches(
            gather, scatter)
        check_fused_entry(gather, f"jax_import resume {label}")
        with open(os.path.join(exp, "log_train.txt")) as f:
            log = f.read()
        micro = 2 * JAX_RESUME_STEPS  # 2 microbatches a step
        check(f"resumed from step {at}" in log
              and ckpt_lib.latest_checkpoint_step(exp) == end
              and launches["K3_fused"] == launches["K3"] == 2 * micro
              and launches["K2"] == 2 * micro and launches["K1"] == 0
              and launches["K4"] == 16 * micro,
              f"jax_import resume {label}: launches {launches}")
        payloads[label], digests[label] = load_state_file(torch, exp, end)
    check(same_state(torch, payloads["source"], payloads["imported"])
          and digests["source"] == digests["imported"],
          f"the resumed state.pt files differ: {digests}")
    res.update(metrics=metrics["source"], resumed_sha256=digests["source"])
    print(f"[jax_import] cli.eval of both folders: metrics bitwise equal "
          f"(psnr {metrics['source']['psnr'].split()}), "
          f"{res['cli_eval_source_seconds']:.2f} / "
          f"{res['cli_eval_imported_seconds']:.2f} s; cli.train resumed "
          f"{JAX_RESUME_STEPS} steps from each in "
          f"{res['resume_source_seconds']:.2f} / "
          f"{res['resume_imported_seconds']:.2f} s: state.pt at step {end} "
          f"bitwise equal (sha256 {digests['source'][:16]}); launches "
          f"{ {k: v for k, v in paths.items()} }", flush=True)
    return res, paths


def jax_import_phase(torch, gather, scatter, configs, step, state_lib,
                     cli_train, src):
    """Both halves of the jax_import phase in a temporary folder, which is
    removed after them (it holds two full-width checkpoints)."""
    folder = tempfile.mkdtemp(prefix="ucnerf_jax_import_")
    t0 = time.perf_counter()
    try:
        fixture, paths = jax_fixture_phase(torch, gather, scatter, configs,
                                           step, state_lib, folder)
        torch.cuda.empty_cache()
        full, more = jax_roundtrip_phase(torch, gather, scatter, configs,
                                         step, state_lib, cli_train, src,
                                         folder)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    paths.update(more)
    secs = time.perf_counter() - t0
    print(f"[jax_import] phase: {secs:.1f} s", flush=True)
    return {"fixture": fixture, "full_width": full, "seconds": secs}, paths


def grad_atol_frac(modules, name):
    """The atol, as a fraction of max|grad|, of gradient `name` in the
    card-vs-CPU checks: GRAD_ATOL_FRAC, or table_atol_frac for the tables
    and density_hidden.weight, whose values move with the sample
    positions."""
    field, _, leaf = name.partition(".")
    if leaf in ("table", "density_hidden.weight"):
        return table_atol_frac(modules[field].grid_spec)
    if name == "cam_refine.se3_deltas":
        # A sum of d loss / d position over the samples: each term is a
        # table's difference across a cell of the finest grid, where a
        # position moved by POS_ERR can fall into the next cell.
        return table_atol_frac(modules["nerf_mlp"].grid_spec)
    return GRAD_ATOL_FRAC


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
        frac = grad_atol_frac(modules, k)
        field, _, leaf = k.partition(".")
        if leaf == "table":
            spec = modules[field].grid_spec
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
            "worst_grad_err_frac": worst[top], "worst_grad": top,
            "checked": sorted(grad_c)}


def profile_train_step(torch, model, cfg, batch, step, state_lib, path):
    """Device time by kernel over one training step (torch.profiler), as
    the train step runs it once its shapes repeat: replayed from its CUDA
    graph (the first call runs eagerly, the second captures the graph);
    the table goes to `path`."""
    from torch.profiler import ProfilerActivity, profile
    state = state_lib.create_train_state(cfg, model)
    train_step = step.make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for _ in range(2):
        train_step(state, batch, 0.5, generator=gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch, 0.5, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kind = ("bf16 backward" if cfg.nerf_mlp.grid_bwd_value_dtype == "bfloat16"
            else "camera refinement" if cfg.optimize_cameras
            else "normals" if not cfg.nerf_mlp.disable_density_normals
            else "options" if cfg.nerf_mlp.compute_dtype
            else "waymo_tpu" if cfg.nerf_mlp.hex_single_query else None)
    # Kernels by the template argument or name that marks them: K1's fused
    # entry (its walks and the grads' interleave), K2 (walks and the two
    # record passes), K3 (the planar walk; the fused entry's walk and its
    # record pass), the prep of all three (the stable sort and the run
    # starts), K4.
    write_profile(torch, prof, wall_us, path,
                  f"one training step of {batch['origins'].shape[0]} rays"
                  + (f" ({kind})" if kind else ""),
                  {"K1": ("WeightedRows", "interleave_grads_kernel"),
                   "K2": ("DenseWalk", "dense_pack_kernel",
                          "gather_records_kernel"),
                   "K3": ("Bf16Pairs", "Bf16Records",
                          "form_records_kernel"),
                   "prep": ("RadixSort", "run_starts_kernel"),
                   "K4": ("take_wsum_kernel", "take_kernel",
                          "interleave_kernel<"),
                   "gemv": ("gemv",)})


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


# The MVS phase.  The tiny cascade's quality recipe (QUALITY_r04.md:8-10,
# `mvs_train --tiny --steps 600 --crop 64 96`, scored as tools/mvs_quality.py
# scores it); full-width training steps at the CLI's default crop and
# learning rate; the steps timed with cuDNN's deterministic algorithms and
# without; the synthetic windows of the full-width depth: the Waymo sensor's
# 1920x1280, on a 24-view ring ~14.4 deg apart (tests/test_mvs.py's dense
# fixture: a 6-view ring barely overlaps), three reference views with 6 ring
# neighbours each (as WaymoMVSWindows' 6 temporal sources), and the reference
# demo's last pass (rescale 2.0 at 10 sources, demo_custom.py:33-44); the
# card-vs-CPU window.
MVS_TINY_STEPS = 600
MVS_CROP = (64, 96)
MVS_STEPS = 20
MVS_LR = 2e-4
MVS_TIMED_STEPS = 5
MVS_SIZE = (1280, 1920)
MVS_RING = 24
MVS_REFS = (3, 4, 5)
MVS_SOURCES = 6
MVS_DEMO = (2.0, 10, 5)  # rescale, sources, reference view
MVS_CHECK_SIZE = (128, 192)
# Card against CPU (TF32 off).  The full-width cascade's first estimate
# (encoders, the stage-0 volume, one lookup and one update) at rtol 1e-4 with
# an atol of 1e-5 x max|disp|: convolutions summed in another order.  Its
# later estimates are not held: an untrained cascade's recurrence amplifies
# rounding about threefold an iteration (the lookup reads the volume at
# (disp-origin)/incre, 1.3e5 hypotheses per unit of disparity in stage 1), so
# no f32 run pins down a final disparity; the growth is recorded.  The tiny
# cascade's sequence loss and gradients at its seed-0 init on the training
# crop are held against a float64 run on the CPU, beside the CPU's own f32
# run: the gradients of this loss are ill-conditioned in f32 (the depth
# term's 1/disp, five instance norms' backward), and the CPU's f32 gradients
# already miss the float64 ones by up to ~3e-3 relative L2 in a leaf.  The
# card's loss at rtol 1e-5 of the float64 one; each gradient leaf at 1e-2
# relative L2, but for the biases an instance norm follows, whose gradient is
# 0 but for rounding: those at an atol of 1e-6 x the largest gradient of any
# leaf.
MVS_DISP_RTOL = 1e-4
MVS_DISP_ATOL_FRAC = 1e-5
MVS_LOSS_RTOL = 1e-5
MVS_GRAD_REL_L2 = 1e-2
MVS_GRAD_FLOOR_FRAC = 1e-6


class RingWindows:
    """cli.mvs_depth's windows over the synthetic ring: reference view
    refs[index] first, then its `sources` nearest ring neighbours."""

    def __init__(self, win, refs, sources):
        self.win, self.refs, self.sources = win, tuple(refs), sources

    def __len__(self):
        return len(self.refs)

    def __getitem__(self, index):
        ref, half = self.refs[index], self.sources // 2
        idxs = [ref] + [ref + o for o in range(-half, half + 1) if o != 0]
        return (self.win.images[idxs], self.win.poses[idxs],
                self.win.intrinsics[idxs], [f"view{i:02d}" for i in idxs],
                self.win.scale)


def mvs_cli(torch, fn, *args):
    """An MVS entry point in-process, its standard output kept: returns
    (result, seconds, log lines)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0, buf.getvalue().splitlines()


def mvs_log_rate(lines):
    """Steps/s between the second and the last progress line of
    cli.mvs_train ("step N: ... (T s)"), past the first step's set-up."""
    pts = [(int(m.group(1)), float(m.group(2))) for m in
           (re.match(r"step (\d+): .*\(([\d.]+)s\)$", s) for s in lines) if m]
    (s0, t0), (s1, t1) = pts[1], pts[-1]
    return (s1 - s0) / (t1 - t0) if t1 > t0 else float("nan")


def mvs_grads(torch, model, batch):
    """(loss, {name: gradient}) of one sequence-loss step of `model`."""
    from ucnerf_tpu_torch.models.mvs import pipelines

    model.zero_grad(set_to_none=True)
    _, preds = model(*batch[:3], return_predictions=True)
    loss, _ = pipelines.sequence_loss(preds, batch[3], gradual_weight=0.5)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().cpu().numpy()
                         for n, p in model.named_parameters()}


def mvs_card_vs_cpu(torch, mvs_depth, mvs_train, mvs_data, configs,
                    full_ckpt, device):
    """The full-width weights on a 3-view window of MVS_CHECK_SIZE, and the
    tiny cascade's sequence loss and gradients at its init on the training
    crop, on the card and on the CPU."""
    from ucnerf_tpu_torch.cli import common

    h, w = MVS_CHECK_SIZE
    win = mvs_data.SyntheticMVSWindows(
        config=configs.tiny(training_views=MVS_RING, synthetic_height=h,
                            synthetic_width=w), num_views=3)
    images, poses, intr, scale = win.window(1)
    preds = []
    for dev in (device, torch.device("cpu")):
        model = mvs_depth.load_model(full_ckpt, "HR", dev)
        with torch.no_grad(), common.deterministic_cudnn():
            _, out = model(*(torch.from_numpy(a).to(dev) for a in
                             (images, poses, intr)), scale=scale,
                           return_predictions=True)
        preds.append([p.cpu().numpy() for p in out])
    errs = [float(np.abs(g - c).max()) for g, c in zip(*preds)]
    first_g, first_c = preds[0][0], preds[1][0]
    top_disp = float(np.abs(first_c).max())
    check(np.allclose(first_g, first_c, rtol=MVS_DISP_RTOL,
                      atol=MVS_DISP_ATOL_FRAC * top_disp),
          f"MVS: the full-width cascade's first estimate on the card vs the "
          f"CPU: max abs err {errs[0]} (max |disp| {top_disp})")

    train_win = mvs_data.SyntheticMVSWindows(num_views=5)
    out = {}
    for label, dev, dtype in (("card", device, torch.float32),
                              ("cpu", torch.device("cpu"), torch.float32),
                              ("f64", torch.device("cpu"), torch.float64)):
        model = mvs_train.build_model(tiny=True).to(dev, dtype)
        batch = [t.to(dtype) for t in mvs_train.crop_batch(
            train_win, 0, MVS_CROP, dev)]
        with common.deterministic_cudnn():
            out[label] = mvs_grads(torch, model, batch)
    loss_64, grads_64 = out["f64"]
    loss_g = out["card"][0]
    check(abs(loss_g - loss_64) <= MVS_LOSS_RTOL * abs(loss_64),
          f"MVS: tiny sequence loss {loss_g} on the card, {loss_64} in "
          f"float64")
    top = max(float(np.abs(g).max()) for g in grads_64.values())
    worst = {}
    for label in ("card", "cpu"):
        grads = out[label][1]
        worst[label] = 0.0
        for name, want in grads_64.items():
            got = grads[name]
            if np.abs(want).max() < MVS_GRAD_FLOOR_FRAC * top:
                check(label == "cpu" or np.abs(got - want).max()
                      <= MVS_GRAD_FLOOR_FRAC * top,
                      f"MVS: tiny gradient {name} on the card: max abs err "
                      f"{np.abs(got - want).max()} (a zero gradient)")
                continue
            rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
            worst[label] = max(worst[label], rel)
            check(label == "cpu" or rel <= MVS_GRAD_REL_L2,
                  f"MVS: tiny gradient {name} on the card: {rel} relative "
                  f"L2 from float64")
    loss_c = out["cpu"][0]
    res = {"window": [3, h, w], "first_disp_max_abs_err": errs[0],
           "first_disp_max_abs": top_disp,
           "disp_max_abs_err_by_iteration": errs,
           "final_disp_max_abs": float(np.abs(preds[1][-1]).max()),
           "tiny_loss_card_cpu_f64": [loss_g, loss_c, loss_64],
           "tiny_grad_worst_rel_l2_from_f64": worst,
           "tiny_grad_leaves": len(grads_64)}
    print(f"[mvs] card vs CPU: full-width first estimate max abs err "
          f"{errs[0]:.3g} of {top_disp:.3g} (iteration errors "
          + " ".join(f"{e:.2g}" for e in errs)
          + f"); tiny loss card {loss_g:.8g}, CPU {loss_c:.8g}, float64 "
          f"{loss_64:.8g}; {len(grads_64)} gradients, worst relative L2 from "
          f"float64 {worst['card']:.3g} on the card, {worst['cpu']:.3g} on "
          f"the CPU", flush=True)
    return res


def mvs_train_state(torch, mvs_train, state, deterministic):
    """A full-width model and its train step from `state` (a fresh Adam);
    cuDNN's deterministic flag set as asked until the caller restores
    it."""
    model = mvs_train.build_model(tiny=False).cuda()
    model.load_state_dict(state)
    torch.backends.cudnn.deterministic = deterministic
    return model, mvs_train.make_train_step(model, MVS_LR, 0.5)


def mvs_repeat_and_cost(torch, mvs_train, state, batch):
    """Two runs of 2 full-width steps from `state` on `batch` with the
    deterministic algorithms: every parameter, Adam moment and loss bitwise
    equal.  Then MVS_TIMED_STEPS steps timed with them and without, in the
    order on, off, off, on: median ms a step of each."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.benchmark = False
    try:
        runs = []
        for _ in range(2):
            model, (step, adam) = mvs_train_state(torch, mvs_train, state,
                                                  True)
            losses = [float(step(*batch)[0]) for _ in range(2)]
            tensors = {}
            for name, p in model.named_parameters():
                tensors[name] = p.detach().clone()
                for key in ("exp_avg", "exp_avg_sq"):
                    tensors[f"{name}.{key}"] = adam.state[p][key].clone()
            runs.append((losses, tensors))
        (la, ta), (lb, tb) = runs
        diff = [n for n in ta if not torch.equal(ta[n], tb[n])]
        check(la == lb and not diff,
              f"MVS: two runs of 2 full-width steps differ: losses {la} / "
              f"{lb}, tensors {diff[:5]}")
        n_tensors = len(ta)
        del runs, ta, tb
        times = {True: [], False: []}
        for det in (True, False, False, True):
            _, (step, _) = mvs_train_state(torch, mvs_train, state, det)
            step(*batch)  # warm-up
            torch.cuda.synchronize()
            for _ in range(MVS_TIMED_STEPS):
                t0 = time.perf_counter()
                step(*batch)
                torch.cuda.synchronize()
                times[det].append((time.perf_counter() - t0) * 1e3)
    finally:
        cudnn.deterministic, cudnn.benchmark = prev
    res = {"repeat_tensors_bitwise": n_tensors, "repeat_losses": la,
           "step_ms_deterministic": float(np.median(times[True])),
           "step_ms_default": float(np.median(times[False])),
           "step_ms_deterministic_all": times[True],
           "step_ms_default_all": times[False]}
    print(f"[mvs] repeatability: 2 full-width steps twice, {n_tensors} "
          f"parameters and Adam moments and the losses bitwise equal; a "
          f"step {res['step_ms_deterministic']:.1f} ms with cuDNN's "
          f"deterministic algorithms, {res['step_ms_default']:.1f} ms "
          f"without", flush=True)
    return res


class SectionTimer:
    """CUDA-event spans by section name, summed after a synchronize."""

    def __init__(self, torch):
        self.torch, self.spans = torch, {}

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.spans.setdefault(name, []).append((start, end))
            return out
        return timed

    def totals(self):
        self.torch.cuda.synchronize()
        return {name: sum(s.elapsed_time(e) for s, e in spans)
                for name, spans in self.spans.items()}


def mvs_breakdown(torch, mvs_depth, raft, model, win, passes):
    """For each pass (label, rescale, sources, reference view): one
    full-width forward after a warm-up, its device time split by CUDA
    events into the encoders, the correlation build (volumes and pyramid),
    the lookups and the update block (the GRU and its heads), and its peak
    memory (weights and the pass's inputs included)."""
    from ucnerf_tpu_torch.cli import common

    out = {}
    names = ("build_corr_volume", "corr_pyramid", "lookup")
    originals = {n: getattr(raft, n) for n in names}
    for label, rescale, sources, ref in passes:
        images, poses, intr, _, scale = RingWindows(win, (ref,), sources)[0]
        imgs, k = mvs_depth.rescaled(torch.from_numpy(images).cuda(), intr,
                                     rescale)
        args = (imgs, torch.from_numpy(poses).cuda(),
                torch.from_numpy(k).cuda())
        with torch.no_grad(), common.deterministic_cudnn():
            model(*args, scale=scale)  # warm-up
            timer = SectionTimer(torch)
            try:
                raft.build_corr_volume = timer.wrap(
                    "corr_build", originals["build_corr_volume"])
                raft.corr_pyramid = timer.wrap("corr_build",
                                               originals["corr_pyramid"])
                raft.lookup = timer.wrap("lookup", originals["lookup"])
                for sub, name in ((model.fnet, "encoders"),
                                  (model.cnet, "encoders"),
                                  (model.update_block, "gru")):
                    sub.forward = timer.wrap(name, type(sub).forward.__get__(
                        sub))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                timer.wrap("total", model)(*args, scale=scale)
                totals = timer.totals()
                peak = torch.cuda.max_memory_allocated()
            finally:
                for n, fn in originals.items():
                    setattr(raft, n, fn)
                for sub in (model.fnet, model.cnet, model.update_block):
                    sub.__dict__.pop("forward", None)
        total = totals.pop("total")
        rec = {"rescale": rescale, "sources": sources,
               "input": list(imgs.shape), "total_ms": total,
               "section_ms": totals,
               "share": {k: v / total for k, v in totals.items()},
               "other_share": 1 - sum(totals.values()) / total,
               "peak_bytes": int(peak)}
        out[label] = rec
        print(f"[mvs] {label}: {list(imgs.shape)} x {sources} sources, "
              f"forward {total:.1f} ms: " + ", ".join(
                  f"{k} {v:.1f} ms ({v / total:.0%})"
                  for k, v in totals.items())
              + f"; peak {peak} B ({peak / 2**30:.2f} GiB)", flush=True)
        del imgs, args
        torch.cuda.empty_cache()
    return out


def mvs_phase(torch, gather, scatter):
    """The CER-MVS entry points on the card (see the module docstring):
    returns the results and the launches of K1-K5 on each path."""
    from ucnerf_tpu_torch import configs
    from ucnerf_tpu_torch.cli import mvs_depth, mvs_train
    from ucnerf_tpu_torch.models.mvs import datasets as mvs_data
    from ucnerf_tpu_torch.models.mvs import raft
    from ucnerf_tpu_torch.tools import mvs_quality

    device = torch.device("cuda")
    res, paths = {}, {}
    tmp = tempfile.mkdtemp(prefix="ucnerf_mvs_")
    try:
        full_ckpt = os.path.join(tmp, "full.pt")
        # 1. The tiny cascade's quality recipe: the port of
        # tools/mvs_quality.py (training through cli.mvs_train, then every
        # stage of the pipeline on the random-init and the trained weights).
        reset_launches(gather, scatter)
        quality, secs, lines = mvs_cli(
            torch, mvs_quality.main,
            ["--steps", str(MVS_TINY_STEPS), "--crop", *map(str, MVS_CROP)])
        paths["mvs_quality"] = read_launches(gather, scatter)
        losses = quality["losses"]
        check(np.isfinite(losses).all() and min(losses[-3:]) < losses[0],
              f"MVS: tiny training did not learn: {losses[:3]} ... "
              f"{losses[-3:]}")
        score = {label.lower(): {"stages": stages, "points": points}
                 for label, (stages, points) in quality["scores"].items()}
        trained, initial = score["trained"], score["random-init"]
        check(trained["stages"]["per-view"][1]
              < initial["stages"]["per-view"][1]
              and all(np.isfinite(v).all() for v in
                      trained["stages"].values())
              and trained["points"] > 0,
              f"MVS: the trained tiny cascade's stages {trained} against "
              f"the random init's {initial}")
        win = mvs_data.SyntheticMVSWindows(num_views=5)
        res["tiny"] = {"steps": MVS_TINY_STEPS, "seconds": secs,
                       "steps_per_s": MVS_TINY_STEPS / secs,
                       "log_steps_per_s": mvs_log_rate(lines),
                       "loss_first": losses[0], "loss_last": losses[-1],
                       "mean_median_valid_abs_rel": score}
        table = [s for s in lines if s.lstrip().startswith(
            ("random-init", "TRAINED"))]
        print(f"[mvs] tiny (tools/mvs_quality.py's port): {MVS_TINY_STEPS} "
              f"steps and the scoring in {secs:.1f} s "
              f"({res['tiny']['log_steps_per_s']:.1f} steps/s logged), loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; per-view median abs-rel "
              f"{trained['stages']['per-view'][1]:.4f} trained, "
              f"{initial['stages']['per-view'][1]:.4f} random init; fused "
              f"points {trained['points']} / {initial['points']}", flush=True)
        for row in table:
            print(f"[mvs] {row}", flush=True)

        # 2. Full-width training steps at the CLI's default crop.
        losses, secs, lines = mvs_cli(
            torch, mvs_train.main,
            ["--steps", str(MVS_STEPS), "--lr", str(MVS_LR), "--out",
             full_ckpt])
        paths["mvs_train"] = read_launches(gather, scatter)
        check(np.isfinite(losses).all(),
              f"MVS: full-width training losses {losses}")
        res["train"] = {"steps": MVS_STEPS, "crop": list(MVS_CROP),
                        "seconds": secs, "steps_per_s": MVS_STEPS / secs,
                        "log_steps_per_s": mvs_log_rate(lines),
                        "losses": losses}
        print(f"[mvs] full-width training: {MVS_STEPS} steps in {secs:.2f} s"
              f" ({res['train']['log_steps_per_s']:.2f} steps/s logged), "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}", flush=True)

        # 3. Full-width depth, twice, on the synthetic ring at sensor size.
        t0 = time.perf_counter()
        h, w = MVS_SIZE
        ring = mvs_data.SyntheticMVSWindows(
            config=configs.tiny(training_views=MVS_RING, synthetic_height=h,
                                synthetic_width=w),
            num_views=MVS_DEMO[2] + MVS_DEMO[1] // 2 + 1)
        res["windows_build_s"] = time.perf_counter() - t0
        windows = {MVS_SOURCES: RingWindows(ring, MVS_REFS, MVS_SOURCES)}
        outs, runs = [], []
        reset_launches(gather, scatter)
        torch.cuda.reset_peak_memory_stats()
        for call in range(2):
            out = os.path.join(tmp, f"depth{call}")
            args = mvs_depth.parse_args(
                ["--data-dir", "synthetic", "--pose-json", "none",
                 "--output", out, "--ckpt", full_ckpt, "--fuse"])
            runs.append(mvs_cli(torch, mvs_depth.run, args, windows,
                                device))
            outs.append(out)
        paths["mvs_depth"] = read_launches(gather, scatter)
        peak = torch.cuda.max_memory_allocated()
        names = [f"view{i:02d}" for i in MVS_REFS]
        for name in names:
            d = np.load(os.path.join(outs[0], f"{name}.npy"))
            check(d.shape == MVS_SIZE and d.dtype == np.float32
                  and np.isfinite(d).all() and (d >= 0).all(),
                  f"MVS: {name}.npy {d.shape} {d.dtype}, finite "
                  f"{np.isfinite(d).all()}, min {d.min()}")
            check(os.path.exists(os.path.join(outs[0], "mask",
                                              f"{name}.npy")),
                  f"MVS: no mask for {name}")
        files = sorted(os.path.relpath(os.path.join(r, f), outs[0])
                       for r, _, fs in os.walk(outs[0]) for f in fs
                       if f.endswith(".npy"))
        check(len(files) == 2 * len(names), f"MVS: wrote {files}")
        same = all(np.array_equal(np.load(os.path.join(outs[0], f)),
                                  np.load(os.path.join(outs[1], f)))
                   for f in files)
        check(same, "MVS: two mvs_depth calls wrote different .npy files")
        (view_secs, points), secs, lines = runs[0]
        n_v, n_f, _ = ply_header(os.path.join(outs[0], "result.ply"))
        check(n_v == points and n_f == 0,
              f"MVS: result.ply holds {n_v} vertices, {n_f} faces; the CLI "
              f"fused {points} points")
        per_rescale = {}
        for _, rescale, s in view_secs:
            per_rescale.setdefault(str(rescale), []).append(s)
        res["depth"] = {"size": list(MVS_SIZE), "refs": len(MVS_REFS),
                        "sources": MVS_SOURCES, "call_seconds":
                        [r[1] for r in runs], "per_view_seconds":
                        per_rescale, "second_call_per_view_seconds":
                        [s for _, _, s in runs[1][0][0]], "points": points,
                        "peak_bytes": int(peak), "npy_bitwise": same,
                        "fusion_log": [s for s in lines
                                       if s.startswith("fusion iter")][-1:]}
        print(f"[mvs] depth at {w}x{h}, {len(MVS_REFS)} views x rescales "
              f"0.5 and 1.0 + fusion: per view " + ", ".join(
                  f"{k}: {min(v):.3f}-{max(v):.3f} s"
                  for k, v in per_rescale.items())
              + f"; calls {runs[0][1]:.1f} / {runs[1][1]:.1f} s; {points} "
              f"fused points; .npy bitwise across the two calls; peak "
              f"{peak} B", flush=True)

        # The time shares and peaks of each pass, the demo's last included.
        model = mvs_depth.load_model(full_ckpt, "HR", device)
        res["breakdown"] = mvs_breakdown(
            torch, mvs_depth, raft, model, ring,
            (("rescale_0.5", 0.5, MVS_SOURCES, MVS_REFS[0]),
             ("rescale_1.0", 1.0, MVS_SOURCES, MVS_REFS[0]),
             ("demo_rescale_2.0", MVS_DEMO[0], MVS_DEMO[1], MVS_DEMO[2])))
        del model, ring, windows
        torch.cuda.empty_cache()

        # 4. Card against CPU.
        res["card_vs_cpu"] = mvs_card_vs_cpu(
            torch, mvs_depth, mvs_train, mvs_data, configs, full_ckpt,
            device)

        # 5. Repeatability, and the deterministic algorithms' cost.
        state = torch.load(full_ckpt, map_location="cpu",
                           weights_only=True)["state_dict"]
        batch = mvs_train.crop_batch(win, 0, MVS_CROP, device)
        res["repeat"] = mvs_repeat_and_cost(torch, mvs_train, state, batch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 6. No kernel of the NeRF paths runs on the MVS paths.
    for label, launches in paths.items():
        check(all(n == 0 for n in launches.values()),
              f"{label}: launches {launches}; the MVS paths run no "
              f"hand-written kernel")
    res["launches"] = paths
    return res, paths


# The pose phase.  The rig of tests/test_full_chain.py: 3 cameras, the
# second and third yawed by 5 and -5 degrees and offset by 0.3 m, on an
# orbit of the synthetic scene, 0.08 rad a frame; the rig's miscalibration
# yaws them by another 1.2 and -1.0 degrees.  POSE_SMALL is that test's
# scene (width, height, focal, frames); POSE_FULL the Waymo front camera's
# sensor and focal, 10 frames (cut from WaymoV2Dataset.NUM_FRAMES = 80).
# The refinement's pixel thresholds are the test's at focal 130 and scale
# with the focal, so that they hold the same angles.
POSE_REL = ((0.0, 0.0), (5.0, 0.3), (-5.0, -0.3))
POSE_PERT = (0.0, 1.2, -1.0)
POSE_SMALL = (160, 96, 130.0, 8)
POSE_FULL = (1920, 1280, 2055.0, 10)
POSE_KEYPOINTS = {"small": 400, "full": 1024}
POSE_PX = dict(epipolar_px=8.0, tri_max_error=25.0, huber_px=2.0)
POSE_BA_ITERATIONS = 40
# The card's refined w2c against the CPU run's (the same keypoints, matches
# and tracks, so the same rig BA inputs).
POSE_W2C_ATOL = 1e-9
# A mutual match whose ratio lies within this of the threshold is reported.
POSE_RATIO_MARGIN = 1e-4
# SuperPoint: the full sensor for the forward's time and memory, a crop for
# the card against the CPU (TF32 off: convolutions summed in other orders).
SP_CROP = (240, 320)
SP_RTOL, SP_ATOL = 1e-4, 1e-5


def rot_y(deg):
    r = np.radians(deg)
    m = np.eye(4)
    m[:3, :3] = [[np.cos(r), 0, np.sin(r)], [0, 1, 0],
                 [-np.sin(r), 0, np.cos(r)]]
    return m


def pose_scene(cameras, datasets, warping, width, height, focal, frames):
    """Grayscale images [N, H, W] of the rig over the synthetic scene
    (rendered on the host, a thread each), the true and the perturbed
    world-to-cam [N, 4, 4], the intrinsics and the true relative poses."""
    k = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    rel_true, rel_pert = [], []
    for (yaw, tx), pert in zip(POSE_REL, POSE_PERT):
        m = rot_y(yaw)
        m[:3, 3] = [tx, 0.0, 0.0]
        rel_true.append(m)
        rel_pert.append(rot_y(pert) @ m)
    w2c_true, w2c_pert = [], []
    for s in range(frames):
        ang = 0.08 * s
        pos = np.array([2.5 * np.sin(ang), 0.4, 2.5 * np.cos(ang)])
        c2w_gl = datasets._lookat_cam_to_world(pos, (0.0, 0.0, 0.0))
        w2c_rig = np.linalg.inv(c2w_gl @ warping.GL_TO_CV)
        for rt, rp in zip(rel_true, rel_pert):
            w2c_true.append(rt @ w2c_rig)
            w2c_pert.append(rp @ w2c_rig)
    x, y = np.meshgrid(np.arange(width), np.arange(height))
    pixtocam = np.linalg.inv(k)

    def render(w2c):
        c2w_gl = np.linalg.inv(w2c) @ warping.GL_TO_CV
        origins, dirs, _, _, _ = cameras.pixels_to_rays(
            x, y, pixtocam[None], c2w_gl[None, :3, :])
        rgb, _, _ = datasets.synthetic_scene_color_and_depth(origins, dirs)
        return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                + 0.114 * rgb[..., 2])

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        gray = np.stack(list(pool.map(render, w2c_true)))
    return (gray, np.stack(w2c_true), np.stack(w2c_pert),
            np.stack([k] * len(gray)), rel_true)


def rel_rot_err_deg(w2c, cam, rel_true):
    """Mean angle of camera `cam`'s rig-relative rotation from the truth."""
    cams = len(rel_true)
    errs = []
    for s in range(len(w2c) // cams):
        rel = w2c[s * cams + cam] @ np.linalg.inv(w2c[s * cams])
        dr = rel[:3, :3] @ rel_true[cam][:3, :3].T
        errs.append(np.degrees(np.arccos(np.clip((np.trace(dr) - 1) / 2,
                                                 -1, 1))))
    return float(np.mean(errs))


def ratio_margins(torch, descs, ratio):
    """The distance from `ratio` of every mutual nearest neighbour's worse
    ratio, over all image pairs, in float64 on the CPU."""
    margins = []
    for i in range(len(descs)):
        for j in range(i + 1, len(descs)):
            sim = (torch.from_numpy(descs[i]).double()
                   @ torch.from_numpy(descs[j]).double().T)
            top12, nn12 = sim.topk(2, dim=1)
            top21, nn21 = sim.T.topk(2, dim=1)
            r12 = (torch.sqrt(torch.clamp(2 - 2 * top12, min=0.0))
                   .unbind(1))
            r21 = (torch.sqrt(torch.clamp(2 - 2 * top21, min=0.0))
                   .unbind(1))
            ratio12 = r12[0] / (r12[1] + 1e-8)
            ratio21 = r21[0] / (r21[1] + 1e-8)
            ids = torch.arange(sim.shape[0])
            mutual = nn21[nn12[:, 0], 0] == ids
            worse = torch.maximum(ratio12, ratio21[nn12[:, 0]])[mutual]
            margins.append((worse - ratio).abs())
    return torch.cat(margins)


def rounded(errs):
    """{camera: (before, after)} rounded to 4 decimals, for printing."""
    return {c: (round(b, 4), round(a, 4)) for c, (b, a) in errs.items()}


def pose_json_check(pipeline, paths, w2c, frames, cams):
    """Write pose.json, read it back with json, and hold its quaternions
    and positions against w2c.  Returns the largest rotation error."""
    with tempfile.TemporaryDirectory(prefix="ucnerf_pose_") as tmp:
        path = os.path.join(tmp, "sparse", "0", "pose.json")
        written = pipeline.write_pose_json(path, w2c, frames, cams)
        with open(path) as f:
            back = json.load(f)
    check(back == written and len(back) == frames * cams,
          f"pose.json read back differs from what was written "
          f"({len(back)} entries)")
    worst = 0.0
    for s in range(frames):
        for c in range(cams):
            a = back[f"cam_{c + 1}/{s:08d}"]
            m = w2c[s * cams + c]
            check([a["p_x"], a["p_y"], a["p_z"]] == m[:3, 3].tolist(),
                  f"pose.json cam_{c + 1}/{s:08d}: position differs")
            r = paths._quat_to_rotmat(np.array([a["q_x"], a["q_y"],
                                                a["q_z"], a["q_w"]]))
            worst = max(worst, float(np.abs(r - m[:3, :3]).max()))
    check(worst <= POSE_W2C_ATOL, f"pose.json rotations differ from w2c by "
          f"{worst}")
    return worst


def pose_small(torch, cameras, datasets, warping, paths, features, matching,
               pipeline):
    """The small rig on the card against the CPU: Harris keypoints equal,
    match sets equal, refined w2c within POSE_W2C_ATOL, the rig error at
    least halved, pose.json round trip."""
    width, height, focal, frames = POSE_SMALL
    gray, _, w2c_pert, intr, rel_true = pose_scene(
        cameras, datasets, warping, width, height, focal, frames)
    cams = len(POSE_REL)
    kp = POSE_KEYPOINTS["small"]
    resp_equal = sum(torch.equal(
        features.harris_response(g, device="cuda").cpu(),
        features.harris_response(g, device="cpu")) for g in gray)
    feats = {}
    for dev in ("cpu", "cuda"):
        feats[dev] = [features.detect_and_describe(g, kp, device=dev)
                      for g in gray]
    kp_equal = sum(np.array_equal(a[0], b[0])
                   for a, b in zip(feats["cpu"], feats["cuda"]))
    check(kp_equal == len(gray), f"Harris keypoints: {kp_equal} of "
          f"{len(gray)} images equal on the card and the CPU")
    desc_err = max(float(np.abs(a[1] - b[1]).max())
                   for a, b in zip(feats["cpu"], feats["cuda"]))
    descs = [d for _, d in feats["cpu"]]
    m_cpu = matching.exhaustive_match(descs, device="cpu")
    m_gpu = matching.exhaustive_match(descs, device="cuda")
    margins = ratio_margins(torch, descs, 0.8)
    near = int((margins < POSE_RATIO_MARGIN).sum())
    differ = [p for p in set(m_cpu) | set(m_gpu)
              if p not in m_cpu or p not in m_gpu
              or not np.array_equal(m_cpu[p], m_gpu[p])]
    print(f"[pose] small rig {width}x{height}, {frames} frames x {cams} "
          f"cameras: Harris response bitwise on {resp_equal} of {len(gray)} "
          f"images, keypoints equal on all; descriptors max abs diff "
          f"{desc_err:.3g}; matches of {len(m_cpu)} pairs, "
          f"{len(differ)} pairs differ; {near} mutual matches within "
          f"{POSE_RATIO_MARGIN} of the ratio 0.8 (closest "
          f"{float(margins.min()):.3g})", flush=True)
    check(not differ, f"match sets differ between the card and the CPU in "
          f"pairs {sorted(differ)[:10]}")
    kw = dict(max_keypoints=kp, ba_iterations=POSE_BA_ITERATIONS, **POSE_PX)
    out = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        out[dev] = pipeline.refine_poses(gray, w2c_pert.copy(), intr, frames,
                                         cams, device=dev, **kw)
        out[dev]["wall_s"] = time.perf_counter() - t0
    w2c = out["cuda"]["w2c"]
    w2c_err = float(np.abs(w2c - out["cpu"]["w2c"]).max())
    check(w2c_err <= POSE_W2C_ATOL, f"refined w2c on the card differs from "
          f"the CPU run's by {w2c_err} (limit {POSE_W2C_ATOL})")
    errs = {}
    for cam in range(1, cams):
        before = rel_rot_err_deg(w2c_pert, cam, rel_true)
        after = rel_rot_err_deg(w2c, cam, rel_true)
        errs[cam] = (before, after)
        check(after < 0.5 * before, f"small rig camera {cam}: relative "
              f"rotation error {before:.4f} -> {after:.4f} deg, not halved")
    json_err = pose_json_check(pipeline, paths, w2c, frames, cams)
    print(f"[pose] small rig refined on the card in "
          f"{out['cuda']['wall_s']:.2f} s (CPU {out['cpu']['wall_s']:.2f} s), "
          f"{out['cuda']['num_points']} points; w2c within {w2c_err:.3g} of "
          f"the CPU run's; relative rotation error (deg) before -> after "
          f"{rounded(errs)}; pose.json read back, rotations within "
          f"{json_err:.3g}",
          flush=True)
    return {"size": [width, height], "frames": frames,
            "harris_response_bitwise": resp_equal,
            "keypoints_equal": kp_equal, "descriptor_max_abs_diff": desc_err,
            "matched_pairs": len(m_cpu), "near_threshold": near,
            "closest_ratio_margin": float(margins.min()),
            "w2c_max_abs_diff": w2c_err, "rel_rot_err_deg": errs,
            "seconds": {d: out[d]["wall_s"] for d in out},
            "stats": out["cuda"]["stats"], "pose_json_rot_err": json_err}


def pose_full(torch, cameras, datasets, warping, pipeline):
    """The rig at the Waymo front camera's size: stage seconds, counts, the
    rig error before and after (after below before).  Also returns the
    first image, for SuperPoint."""
    width, height, focal, frames = POSE_FULL
    t0 = time.perf_counter()
    gray, _, w2c_pert, intr, rel_true = pose_scene(
        cameras, datasets, warping, width, height, focal, frames)
    render_s = time.perf_counter() - t0
    cams = len(POSE_REL)
    px = {k: v * focal / POSE_SMALL[2] for k, v in POSE_PX.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipeline.refine_poses(gray, w2c_pert.copy(), intr, frames, cams,
                                max_keypoints=POSE_KEYPOINTS["full"],
                                ba_iterations=POSE_BA_ITERATIONS,
                                device="cuda", **px)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    stats = out["stats"]
    check(out["num_points"] > 0, f"full-width rig: no point triangulated "
          f"({stats})")
    errs = {}
    for cam in range(1, cams):
        before = rel_rot_err_deg(w2c_pert, cam, rel_true)
        after = rel_rot_err_deg(out["w2c"], cam, rel_true)
        errs[cam] = (before, after)
        check(after < before, f"full-width rig camera {cam}: relative "
              f"rotation error {before:.4f} -> {after:.4f} deg, not reduced")
    secs = {k: round(v, 4) for k, v in stats["seconds"].items()}
    print(f"[pose] full-width rig {width}x{height}, {frames} frames (cut "
          f"from 80) x {cams} cameras, {POSE_KEYPOINTS['full']} keypoints, "
          f"thresholds {px}: images rendered on the host in {render_s:.1f} "
          f"s; refine_poses {wall:.2f} s, stages {secs}; keypoints "
          f"{stats['keypoints']}, pairs matched {stats['matched_pairs']} / "
          f"verified {stats['verified_pairs']}, matches {stats['matches']}, "
          f"tracks {stats['tracks']}, observations {stats['observations']}, "
          f"points {out['num_points']}; peak {peak} B "
          f"({peak / 2**30:.2f} GiB); relative rotation error (deg) before "
          f"-> after {rounded(errs)}", flush=True)
    return {"size": [width, height], "frames": frames,
            "cut_from_frames": 80, "thresholds_px": px,
            "render_seconds": render_s, "seconds": wall, "stats": stats,
            "points": out["num_points"], "peak_bytes": peak,
            "rel_rot_err_deg": errs}, gray[0]


def superpoint_check(torch, features, gray):
    """SuperPoint with seeded random weights: forward time and peak memory
    at the full sensor size; a crop on the card against the CPU (semi and
    desc within SP_RTOL / SP_ATOL, the NMS bitwise on the same scores)."""
    net = features.SuperPointNet(seed=0).cuda().eval()
    x = torch.from_numpy(np.ascontiguousarray(gray[None, :, :, None])).cuda()
    with torch.no_grad():
        net(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: net(x), torch, warmup=1, reps=5)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        kps, _ = features.superpoint_detect_and_describe(net, gray)
        detect_s = time.perf_counter() - t0
        h, w = SP_CROP
        crop = x[:, :h, :w].contiguous()
        cpu = copy.deepcopy(net).cpu()
        semi_g, desc_g = (t.cpu() for t in net(crop))
        semi_c, desc_c = cpu(crop.cpu())
        scores = features.superpoint_scores(semi_c)
        nms_c = features.simple_nms(scores)
        nms_g = features.simple_nms(scores.cuda()).cpu()
    errs = {k: float((a - b).abs().max()) for k, a, b in
            (("semi", semi_g, semi_c), ("desc", desc_g, desc_c))}
    check(torch.allclose(semi_g, semi_c, rtol=SP_RTOL, atol=SP_ATOL)
          and torch.allclose(desc_g, desc_c, rtol=SP_RTOL, atol=SP_ATOL),
          f"SuperPoint on the card vs the CPU: max abs err {errs} (rtol "
          f"{SP_RTOL}, atol {SP_ATOL})")
    check(torch.equal(nms_g, nms_c), "simple_nms on the card differs from "
          "the CPU's on the same scores")
    print(f"[pose] SuperPoint (seeded random weights) at "
          f"{gray.shape[1]}x{gray.shape[0]}: forward {ms:.2f} ms, peak "
          f"{peak} B ({peak / 2**30:.2f} GiB), detect-and-describe "
          f"{detect_s:.3f} s ({len(kps)} keypoints); {w}x{h} crop card vs "
          f"CPU max abs err {errs}, NMS bitwise", flush=True)
    return {"forward_ms": ms, "peak_bytes": peak, "detect_seconds": detect_s,
            "keypoints": len(kps), "crop_max_abs_err": errs}


def pose_phase(torch, gather, scatter):
    """STPR pose refinement (``ucnerf_tpu_torch.pose``), its launches
    counted from 0 (no hand-written kernel lies on the path): the small rig
    on the card against the CPU, the full-width rig, SuperPoint."""
    from ucnerf_tpu_torch.data import cameras, datasets, paths, warping
    from ucnerf_tpu_torch.pose import features, matching, pipeline

    reset_launches(gather, scatter)
    small = pose_small(torch, cameras, datasets, warping, paths, features,
                       matching, pipeline)
    full, gray = pose_full(torch, cameras, datasets, warping, pipeline)
    launches = read_launches(gather, scatter)
    check(not any(launches.values()), f"pose: kernel launches {launches}; "
          f"expected none")
    sp = superpoint_check(torch, features, gray)
    return {"small": small, "full": full, "superpoint": sp}, {
        "pose": launches}


def tensor_digest(tensors):
    """sha256 of the tensors' bytes, in order: equal digests mean bitwise
    equal tensors."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().data)
    return h.hexdigest()


def state_digest(model, optimizer):
    """Digest of every parameter and every Adam moment (in parameter
    order)."""
    adam = optimizer.adam.state
    return tensor_digest(
        [p for p in model.parameters()]
        + [adam[p][k] for p in model.parameters()
           for k in ("exp_avg", "exp_avg_sq") if p in adam])


def launch_ranks(cmd, world, folder, timeout):
    """Run `cmd` as `world` ranks on this host through ``torchrun
    --standalone``, its output in <folder>/torchrun.log.  Fails, with the end
    of that log, if a rank exits non-zero (torchrun then stops the others)
    or the launch outlasts `timeout` seconds (torchrun is then stopped, and
    stops its ranks)."""
    path = os.path.join(folder, "torchrun.log")
    with open(path, "w") as log, subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", "--no-python", *cmd],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT) as proc:
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()  # torchrun stops its ranks on SIGTERM
            rc = proc.wait()
    if rc:
        with open(path) as f:
            check(False, f"{' '.join(cmd[:4])}... as {world} ranks exited "
                  f"{rc}:\n{f.read()[-12000:]}")


def dp_launch(folder, name, world, spec, timeout):
    """chip_smoke.py --dp-worker as `world` ranks on spec (a dict, written
    to <folder>/<name>/spec.json with the rank folder and a file
    rendezvous); returns each rank's JSON result and the seconds taken."""
    work = os.path.join(folder, name)
    os.makedirs(work)
    spec = dict(spec, out=work,
                init="file://" + os.path.join(work, "rendezvous"))
    path = os.path.join(work, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    launch_ranks([sys.executable, os.path.abspath(__file__), "--dp-worker",
                  path], world, work, timeout)
    secs = time.perf_counter() - t0
    results = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results, secs


def dp_worker(spec_path):
    """One rank of the data-parallel phase (``--dp-worker``): the mode in
    the spec runs, and the rank's results go to <out>/rank<r>.json."""
    import torch
    sys.path.insert(0, ROOT)
    from ucnerf_tpu_torch.ops import gather, scatter

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    if spec["mode"] == "cli":
        res = dp_cli_rank(torch, gather, scatter, spec)
    else:
        res = dp_step_rank(torch, gather, scatter, spec)
    res["rank"] = rank
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def dp_cli_rank(torch, gather, scatter, spec):
    """An entry point in-process on this rank (it joins the group itself),
    its launches counted from 0 just before it."""
    import importlib
    main = importlib.import_module(spec["module"]).main
    reset_launches(gather, scatter)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    main(spec["argv"] + ["--dist-init-method", spec["init"]])
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0,
            "launches": read_launches(gather, scatter),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def dp_step_rank(torch, gather, scatter, spec):
    """The train step of the spec's preset on this rank's slice of the
    phase's batch, through the group: in mode "nccl1" (a group of one over
    NCCL) two keyed f32 steps through the group and two without one; in
    modes "gloo" (every rank on card 0) and "cards" (a rank on each card,
    NCCL) one fixed-basis f32 step (its reduced gradients kept) and, for
    each backward, two runs of DP_STEPS keyed steps, each step's state
    digested, timed and its launches counted."""
    from ucnerf_tpu_torch import configs
    from ucnerf_tpu_torch.cli import train as cli_train
    from ucnerf_tpu_torch.parallel import mesh
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step

    # "cards": a rank on each card; otherwise every rank on card 0.
    device = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                          if spec["mode"] == "cards" else 0)
    backend = "gloo" if spec["mode"] == "gloo" else "nccl"
    group = mesh.initialize_multihost(backend, device, spec["init"])
    rank, world = mesh.rank(group), mesh.world_size(group)
    inputs = torch.load(spec["inputs"], map_location="cpu", weights_only=True)
    n = inputs["batch"]["origins"].shape[0]
    lo, hi = mesh.process_slice(n)
    local = {k: v[lo:hi].to(device) for k, v in inputs["batch"].items()}
    f32 = getattr(configs, spec["preset"])(lr_delay_steps=0)
    cfgs = {"f32": f32, "bf16": with_bf16_backward(f32)}

    # The all-reduce of each step, timed by CUDA events and the host clock.
    reduces = []
    all_reduce_grads = mesh.all_reduce_grads

    def timed_reduce(params, group=None):
        params = list(params)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        all_reduce_grads(params, group)
        end.record()
        end.synchronize()
        reduces.append({"ms": start.elapsed_time(end),
                        "host_ms": 1e3 * (time.perf_counter() - t0),
                        "bytes": sum(p.numel() * p.element_size()
                                     for p in params)})

    mesh.all_reduce_grads = timed_reduce

    models = {}

    def fresh(label, g):
        """The backward's model (built once) at the initial parameters,
        with a fresh Adam state."""
        cfg = cfgs[label]
        if label not in models:
            models[label] = step.init_model(cfg, seed=0, device=device)
        model = models[label]
        model.load_state_dict(inputs["initial"], strict=True)
        model.zero_grad(set_to_none=True)
        state = state_lib.create_train_state(cfg, model)
        return model, state, step.make_train_step(model, cfg, g)

    def keyed_run(label, g):
        model, state, train_step = fresh(label, g)
        gen = torch.Generator(device=device)
        out = {"digests": [], "losses": [], "seconds": [], "launches": []}
        for i in range(1, DP_STEPS + 1):
            gen.manual_seed(cli_train._step_seed(5678, i, rank))
            reset_launches(gather, scatter)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, stats = train_step(state, local, 0.5, generator=gen)
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["launches"].append(read_launches(gather, scatter))
            out["losses"].append(float(stats["loss"]))
            out["digests"].append(state_digest(model, state.optimizer))
        return out

    res = {"world": world, "backend": torch.distributed.get_backend(group),
           "rays": hi - lo,
           "shares": step.microbatch_shares(
               n, world, f32.microbatches)[rank].tolist()}
    if spec["mode"] == "nccl1":
        res["group"] = keyed_run("f32", group)
        res["none"] = keyed_run("f32", None)
        res["all_reduce"] = reduces
        mesh.shutdown()
        return res

    # One fixed-basis step: the reduced gradients, read where the optimizer
    # starts (after the all-reduce, before the clean and the clips).
    model, state, train_step = fresh("f32", group)
    reduced = {}
    update = state.optimizer.update

    def keep_then_update():
        reduced.update({k: p.grad.detach().cpu()
                        for k, p in model.named_parameters()})
        update()

    state.optimizer.update = keep_then_update
    _, stats = train_step(state, local, 0.5,
                          rand_vec=inputs["rand_vec"][lo:hi].to(device))
    res["fixed"] = {"loss": float(stats["loss"]),
                    "losses": {k: float(v)
                               for k, v in stats["losses"].items()},
                    "grad_digest": tensor_digest(reduced.values())}
    if rank == 0:
        torch.save(reduced, os.path.join(spec["out"], "reduced_grads.pt"))
    del model, state, train_step, reduced

    torch.cuda.reset_peak_memory_stats()
    for label in cfgs:
        res[label] = [keyed_run(label, group) for _ in range(2)]
        torch.cuda.empty_cache()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["all_reduce"] = reduces
    if spec.get("render"):
        # render_image with the group: each chunk split over the ranks.
        model, _, _ = fresh("f32", group)
        eval_step = step.make_eval_step(model, f32)
        image = {k: v.numpy() for k, v in inputs["image"].items()}
        reset_launches(gather, scatter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step.render_image(eval_step, image, f32, eval_camidx=0,
                                group=group)
        torch.cuda.synchronize()
        res["render"] = {"seconds": time.perf_counter() - t0,
                         "launches": read_launches(gather, scatter)}
        if rank == 0:
            np.savez(os.path.join(spec["out"], "render.npz"), **out)
    mesh.shutdown()
    return res


def dp_phase(torch, gather, scatter, configs, step, state_lib, cfg, initial,
             batch, view):
    """Data parallelism on the one card (every rank on cuda:0), each rank a
    process of its own (``--dp-worker``):
    1. a group of one over NCCL: DP_STEPS keyed f32 steps through the group
       bitwise equal to the same steps without one (every parameter and
       Adam moment), the all-reduce timed;
    2. two ranks over gloo, each on its 7500 of the batch's 15000 rays:
       per-rank launches a step, the two ranks bitwise equal after every
       step, two runs of DP_STEPS steps bitwise equal, for each backward;
       one fixed-basis step's loss and reduced gradients against one
       process on all 15000 rays, at the card-vs-CPU check's tolerances;
    2a. three ranks over gloo on ``configs.waymo_tpu()``, 5000 rays each:
       every 1000-ray global microbatch split 334/333/333
       (``step.microbatch_shares``), with the checks of 2; then
       ``render_image`` with the group on DP_RENDER_ROWS rows of `view`
       against one process;
    2b. where the machine has several cards, a rank on each card over
       NCCL, with the checks of 2 and the rate of one card beside it,
       whatever the split (8 cards take shares of 187 and 188);
    2c. ``tools/scaling_bench.py`` at the tiny preset, ranks 1 and 2, weak
       and strong: its JSON line, and one gradient all-reduce of exactly
       the parameters' bytes a step;
    3. the entry points at two ranks over gloo on the CLI phase's scene:
       cli.train --multihost (DP_CLI_STEPS: a test render, a checkpoint,
       a resume) and cli.eval of its checkpoint against a one-process
       cli.eval (view PSNRs and images).
    Returns (results, launch paths of rank 0)."""
    from ucnerf_tpu_torch.cli import eval as cli_eval

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ucnerf_dp_")
    res, paths = {}, {}
    try:
        rand_vec = torch.from_numpy(np.random.default_rng(11).normal(
            size=(batch["origins"].shape[0], 3)).astype(np.float32))
        inputs = os.path.join(tmp, "inputs.pt")
        image = {k: np.ascontiguousarray(v[:DP_RENDER_ROWS])
                 for k, v in view.items()}
        torch.save({"initial": initial, "rand_vec": rand_vec,
                    "batch": {k: v.cpu() for k, v in batch.items()},
                    "image": {k: torch.from_numpy(v)
                              for k, v in image.items()}}, inputs)

        # 1. A group of one over NCCL.
        (one,), secs = dp_launch(tmp, "nccl1", 1, {
            "mode": "nccl1", "preset": "waymo", "inputs": inputs}, 300)
        differ = [i + 1 for i, (a, b) in enumerate(zip(
            one["group"]["digests"], one["none"]["digests"])) if a != b]
        check(one["backend"] == "nccl" and not differ
              and one["group"]["losses"] == one["none"]["losses"],
              f"dp nccl world 1: steps {differ} differ from the steps "
              f"without a group; losses {one['group']['losses']} vs "
              f"{one['none']['losses']}")
        red = one["all_reduce"]
        res["nccl_world1"] = {"seconds": secs, "all_reduce": red,
                              "losses": one["group"]["losses"],
                              "bitwise_no_group": True}
        print(f"[dp nccl] world 1 through NCCL: {DP_STEPS} f32 steps of "
              f"{one['rays']} rays bitwise equal to the same steps without a "
              f"group (every parameter and Adam moment); all-reduce of "
              f"{red[0]['bytes']} B a step: "
              f"{[round(r['ms'], 3) for r in red]} ms by CUDA events, "
              f"{[round(r['host_ms'], 3) for r in red]} ms host "
              f"({secs:.1f} s with the process start)", flush=True)

        # 2. Two ranks over gloo on one card.
        ranks, secs = dp_launch(tmp, "gloo2", 2, {
            "mode": "gloo", "preset": "waymo", "inputs": inputs}, 600)
        res["gloo_world2"], gloo_paths = dp_check_ranks(
            torch, step, state_lib, cfg, initial, batch, rand_vec, ranks,
            secs, "gloo", os.path.join(tmp, "gloo2", "reduced_grads.pt"))
        paths.update({f"dp_train_{k}": v for k, v in gloo_paths.items()})

        # 2a. Three ranks over gloo on one card, the flagship preset.
        tpu_cfg = configs.waymo_tpu(lr_delay_steps=0)
        ranks, secs = dp_launch(tmp, "gloo3_tpu", 3, {
            "mode": "gloo", "preset": "waymo_tpu", "inputs": inputs,
            "render": True}, 900)
        res["gloo_world3_waymo_tpu"], tpu_paths = dp_check_ranks(
            torch, step, state_lib, tpu_cfg, initial, batch, rand_vec, ranks,
            secs, "gloo waymo_tpu",
            os.path.join(tmp, "gloo3_tpu", "reduced_grads.pt"))
        paths.update({f"dp_tpu_train_{k}": v for k, v in tpu_paths.items()})
        res["gloo_world3_waymo_tpu"]["render"] = dp_render_check(
            torch, step, tpu_cfg, initial, image, ranks,
            os.path.join(tmp, "gloo3_tpu", "render.npz"))
        paths["dp_tpu_render"] = ranks[0]["render"]["launches"]

        # 2b. A rank on each card over NCCL, where the machine has several.
        cards = torch.cuda.device_count()
        n = batch["origins"].shape[0]
        if cards > 1:
            ranks, secs = dp_launch(tmp, "cards", cards, {
                "mode": "cards", "preset": "waymo", "inputs": inputs}, 600)
            one_card = [s for run in ("group", "none")
                        for s in one[run]["seconds"]]
            res["nccl_cards"], cards_paths = dp_check_ranks(
                torch, step, state_lib, cfg, initial, batch, rand_vec, ranks,
                secs, f"nccl {cards} cards",
                os.path.join(tmp, "cards", "reduced_grads.pt"))
            res["nccl_cards"]["one_card_rays_per_s"] = \
                n / float(np.median(one_card))
            print(f"[dp nccl {cards} cards] one process on one card, the "
                  f"same {n} rays: "
                  f"{res['nccl_cards']['one_card_rays_per_s']:.1f} rays/s "
                  f"(median of {len(one_card)} f32 steps)", flush=True)
            paths.update({f"dp_cards_train_{k}": v
                          for k, v in cards_paths.items()})
        else:
            print("[dp nccl cards] not run: one card; NCCL with a rank on "
                  "each of several cards is unverified on this machine",
                  flush=True)

        # 2c. The scaling tool's card path, at the tiny preset.
        res["scaling_tiny"] = dp_scaling_check(torch, tmp)

        # 3. The entry points at two ranks.
        res["cli"], cli_paths = dp_cli_phase(torch, gather, scatter, configs,
                                             cli_eval, tmp)
        paths.update(cli_paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"[dp] phase took {res['seconds']:.1f} s", flush=True)
    return res, paths


def dp_render_check(torch, step, cfg, initial, image, ranks, path):
    """The ranks' ``render_image`` with the group against one process's on
    the same rays (RENDER_RTOL, RENDER_ATOL: the chunks' slices are
    rendered at other batch sizes, whose arithmetic rounds otherwise), and
    each rank's launches: 16 ``take_wsum_cm`` a chunk, nothing else."""
    model = step.init_model(cfg, seed=0, device="cuda")
    model.load_state_dict(initial, strict=True)
    want = step.render_image(step.make_eval_step(model, cfg), image, cfg,
                             eval_camidx=0)
    del model
    got = dict(np.load(path))
    height, width = image["origins"].shape[:2]
    errs = {}
    for k, w in want.items():
        check(got[k].shape == w.shape == (height, width) + w.shape[2:]
              and np.isfinite(got[k]).all(), f"dp render {k}: shape "
              f"{got[k].shape}, want {w.shape}")
        errs[k] = float(np.abs(got[k] - w).max())
        check(np.allclose(got[k], w, rtol=RENDER_RTOL, atol=RENDER_ATOL),
              f"dp render at {len(ranks)} ranks vs one process: {k} max abs "
              f"err {errs[k]}")
    chunks = -(-height * width // cfg.render_chunk_size)
    for r, rr in enumerate(ranks):
        n = rr["render"]["launches"]
        check(n["K4"] == n["K4_wsum"] == 16 * chunks and all(
            v == 0 for k, v in n.items() if k not in ("K4", "K4_wsum")),
            f"dp render rank {r}: launches {n}, expected {16 * chunks} "
            f"take_wsum_cm alone")
    secs = [rr["render"]["seconds"] for rr in ranks]
    print(f"[dp render] render_image of {width}x{height} ({chunks} chunks) "
          f"at {len(ranks)} gloo ranks on one card vs one process: max abs "
          f"err {errs} (rtol {RENDER_RTOL}, atol {RENDER_ATOL}); "
          f"{16 * chunks} take_wsum_cm a rank; {max(secs):.2f} s",
          flush=True)
    return {"max_abs_err": errs, "seconds": secs,
            "launches": [rr["render"]["launches"] for rr in ranks]}


def dp_scaling_check(torch, tmp):
    """``ucnerf_tpu_torch.tools.scaling_bench`` at the tiny preset, ranks 1
    and 2, weak and strong, on this machine's cards (one card: gloo, marked
    wiring only): every point's fields, and each step's collectives one
    gradient all-reduce of exactly the parameters' bytes and one small
    all-reduce of the stats."""
    out = os.path.join(tmp, "scaling_tiny.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ucnerf_tpu_torch.tools.scaling_bench",
         "--preset", "tiny", "--ranks", "1,2", "--steps", "3",
         "--out", out, "--timeout", "300"],
        cwd=ROOT, capture_output=True, text=True, timeout=660)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"scaling_bench exited {proc.returncode}:\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    with open(out) as f:
        line = json.load(f)
    rows = line["sweep"]
    check(line["audit_ok"]
          and line["device"] == torch.cuda.get_device_name(0)
          and [(r["mode"], r["ranks"]) for r in rows]
          == [("weak", 1), ("strong", 1), ("weak", 2), ("strong", 2)]
          and all(r["all_reduce_bytes"] == r["param_bytes"]
                  and r["collectives_per_step"][0]["bytes"] == r["param_bytes"]
                  and len(r["collectives_per_step"]) == 2
                  and r["rays_per_sec"] > 0
                  and all(b and b > 0 for b in r["peak_bytes_per_rank"])
                  for r in rows),
          f"scaling_bench's line: {line}")
    print(f"[dp scaling] tools/scaling_bench.py --preset tiny --ranks 1,2 on "
          f"{line['card']} ({line['backend']}"
          + (", wiring only" if line["wiring_only"] else "") + "): "
          + "; ".join(f"{r['mode']} {r['ranks']}: {r['rays_per_sec']:.1f} "
                      f"rays/s, all-reduce {r['all_reduce_ms']:.3f} ms of "
                      f"{r['step_ms']:.2f} ({r['all_reduce_bytes']} B), peak "
                      f"{r['peak_bytes_per_rank']} B" for r in rows)
          + f"; collectives a step {rows[-1]['collectives_per_step']}; "
          f"{secs:.1f} s", flush=True)
    return dict(line, seconds=secs)


def dp_check_ranks(torch, step, state_lib, cfg, initial, batch, rand_vec,
                   ranks, secs, tag, grads_path):
    """Checks and numbers of a data-parallel launch in mode "gloo" or
    "cards" of `cfg`'s preset: for each backward, every rank's launches a
    step (those of a one-process step, a microbatch for each share it
    holds), the ranks bitwise equal after every step and the two runs
    bitwise equal; the ranks' fixed-basis losses and reduced gradients
    equal, and rank 0's against one process (dp_fixed_check).  Returns
    (results, rank 0's launches over a run, by backward)."""
    world = len(ranks)
    n = batch["origins"].shape[0]
    shares = step.microbatch_shares(n, world, cfg.microbatches)
    check([rr["shares"] for rr in ranks] == shares.tolist(),
          f"dp {tag}: the ranks' shares {[rr['shares'] for rr in ranks]}")

    def per_step(m):
        """A rank's launches a step, with m non-empty shares."""
        return {
            "f32": {"K1": 2 * m, "K1_fused": 2 * m, "K1_plain": 0,
                    "K2": 2 * m, "K3": 0, "K4": 16 * m, "K4_take": 0,
                    "K4_wsum": 16 * m, "K5": 0, "starts": 4 * m},
            "bf16": {"K1": 0, "K2": 2 * m, "K3": 2 * m, "K3_fused": 2 * m,
                     "K3_planar": 0, "K4": 16 * m, "K4_take": 0,
                     "K4_wsum": 16 * m, "K5": 0, "starts": 4 * m}}

    wants = [per_step(int((row > 0).sum())) for row in shares]
    shared = "sharing one card" if tag.startswith("gloo") else \
        "one card each"
    split = (f"{ranks[0]['rays']} rays each" if shares.min() == shares.max()
             else f"{ranks[0]['rays']} rays each in shares of "
                  f"{sorted(set(shares.ravel().tolist()))} of every "
                  f"{n // cfg.microbatches}-ray microbatch")
    out, paths = {"seconds": secs, "per_step_launches": wants[0],
                  "shares": shares.tolist()}, {}
    for label in ("f32", "bf16"):
        for r, rr in enumerate(ranks):
            want = wants[r][label]
            for run in rr[label]:
                for i, got in enumerate(run["launches"]):
                    bad = {k: got[k] for k, v in want.items() if got[k] != v}
                    check(not bad, f"dp {tag} rank {r} {label} step "
                          f"{i + 1}: launches {bad}, expected {want}")
        across_ranks = [(r, run, i + 1) for r in range(1, world)
                        for run in range(2) for i in range(DP_STEPS)
                        if ranks[r][label][run]["digests"][i]
                        != ranks[0][label][run]["digests"][i]]
        across_runs = [(r, i + 1) for r, rr in enumerate(ranks)
                       for i in range(DP_STEPS)
                       if rr[label][0]["digests"][i]
                       != rr[label][1]["digests"][i]]
        check(not across_ranks, f"dp {tag} {label}: ranks differ from rank "
              f"0 after (rank, run, step) {across_ranks}")
        check(not across_runs, f"dp {tag} {label}: the two runs differ at "
              f"(rank, step) {across_runs}")
        losses = [rr[label][run]["losses"] for rr in ranks for run in (0, 1)]
        check(all(x == losses[0] for x in losses),
              f"dp {tag} {label}: losses {losses}")
        secs_step = [s for rr in ranks for run in rr[label]
                     for s in run["seconds"]]
        rate = n / float(np.median(secs_step))
        out[label] = {"losses": losses[0], "step_seconds": secs_step,
                      "rays_per_s": rate,
                      "launches_per_step_rank0":
                          ranks[0][label][0]["launches"][0]}
        paths[label] = {k: sum(s[k] for s in ranks[0][label][0]["launches"])
                        for k in ranks[0][label][0]["launches"][0]}
        print(f"[dp {tag} {label}] {world} ranks ({shared}), "
              f"{split}: launches per rank a step "
              f"{ranks[0][label][0]['launches'][0]}; parameters and Adam "
              f"moments bitwise equal across the ranks after each step and "
              f"across two runs of {DP_STEPS} steps; losses {losses[0]}; "
              f"step s {[round(s, 4) for s in secs_step]}, {rate:.1f} rays/s "
              f"of the global batch"
              + (" (ranks sharing one card: says nothing of scaling)"
                 if tag.startswith("gloo") else ""), flush=True)
    fixed = [rr["fixed"] for rr in ranks]
    check(all(f == fixed[0] for f in fixed), f"dp {tag}: the ranks' "
          f"fixed-basis losses or reduced gradients differ: {fixed}")
    red = ranks[0]["all_reduce"]
    out.update(peak_bytes_per_rank=[rr["peak_bytes"] for rr in ranks],
               all_reduce=red,
               fixed=dp_fixed_check(torch, step, state_lib, cfg, initial,
                                    batch, rand_vec, fixed[0], grads_path,
                                    tag, world))
    print(f"[dp {tag}] all-reduce of {red[0]['bytes']} B a step"
          + (" through host memory" if tag.startswith("gloo") else "")
          + f": median {float(np.median([r['ms'] for r in red])):.3f} ms by "
          f"CUDA events, {float(np.median([r['host_ms'] for r in red])):.3f} "
          f"ms host; peak per rank {[rr['peak_bytes'] for rr in ranks]} B; "
          f"{secs:.1f} s with the process starts", flush=True)
    return out, paths


def dp_fixed_check(torch, step, state_lib, cfg, initial, batch, rand_vec,
                   fixed, grads_path, tag, world):
    """The one-process reference of the fixed-basis step: the loss terms at
    GRAD_LOSS_RTOL and each reduced gradient of rank 0 at the card-vs-CPU
    check's tolerances (GRAD_RTOL and grad_atol_frac of max|grad|)."""
    model = step.init_model(cfg, seed=0, device="cuda")
    model.load_state_dict(initial, strict=True)
    state = state_lib.create_train_state(cfg, model)
    want = {}
    update = state.optimizer.update

    def keep_then_update():
        want.update({k: p.grad.detach().cpu()
                     for k, p in model.named_parameters()})
        update()

    state.optimizer.update = keep_then_update
    _, stats = step.make_train_step(model, cfg)(
        state, batch, 0.5, rand_vec=rand_vec.cuda())
    losses = dict({k: float(v) for k, v in stats["losses"].items()},
                  total=float(stats["loss"]))
    got_losses = dict(fixed["losses"], total=fixed["loss"])
    for k, v in losses.items():
        check(np.isclose(got_losses[k], v, rtol=GRAD_LOSS_RTOL, atol=0),
              f"dp {tag} vs one process: loss {k} {got_losses[k]} vs {v}")
    got = torch.load(grads_path, weights_only=True)
    modules = dict(model.named_modules())
    worst, bad = {}, []
    for k, w in want.items():
        scale = float(w.abs().max())
        err = (got[k] - w).abs()
        frac = grad_atol_frac(modules, k)
        worst[k] = float(err.max()) / max(scale, 1e-30)
        if bool((err > GRAD_RTOL * w.abs() + frac * scale).any()):
            bad.append(f"{k} (err/max|grad| {worst[k]:.3g}, atol "
                       f"{frac:.3g})")
    top = sorted(worst, key=worst.get, reverse=True)[:5]
    n = batch["origins"].shape[0]
    print(f"[dp {tag}] fixed-basis step, {world} ranks x {n // world} rays "
          f"vs one process on the {n}: losses {got_losses} vs {losses}; "
          f"largest "
          f"gradient misses (err/max|grad|) "
          f"{ {k: float(f'{worst[k]:.3g}') for k in top} }; tolerance rtol "
          f"{GRAD_RTOL} + {GRAD_ATOL_FRAC} x max|grad| (tables and "
          f"density_hidden.weight: table_atol_frac)", flush=True)
    check(not bad, f"dp {tag} vs one process: reduced gradients out of "
          f"tolerance: {bad}")
    del model, state
    torch.cuda.empty_cache()
    return {"losses": got_losses, "losses_one_process": losses,
            "worst_grad_err_frac": {k: worst[k] for k in top}}


def read_png_u8(path):
    """The pixels of a PNG that ``vis.encode_png_u8`` wrote (one IDAT chunk,
    filter type 0 on every scanline)."""
    with open(path, "rb") as f:
        data = f.read()
    w, h = struct.unpack(">II", data[16:24])
    idat = data.index(b"IDAT")
    size = struct.unpack(">I", data[idat - 4:idat])[0]
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + size]),
                        np.uint8).reshape(h, -1)
    check(not raw[:, 0].any(), f"{path}: a scanline filter other than 0")
    return raw[:, 1:].reshape(h, w, -1)


def dp_cli_phase(torch, gather, scatter, configs, cli_eval, tmp):
    """cli.train --multihost at two ranks over gloo on the CLI phase's scene
    (DP_CLI_STEPS), then cli.eval of its checkpoint at two ranks against a
    one-process cli.eval of the same checkpoint."""
    first, second = DP_CLI_STEPS
    exp = os.path.join(tmp, "exp")
    gloo = ["--device", "cuda:0", "--dist-backend", "gloo"]
    argv = ["--preset", "synthetic_quality", "--multihost", *gloo,
            "-b", 'NerfMLP.grid_bwd_value_dtype = "bfloat16"',
            "-b", 'PropMLP.grid_bwd_value_dtype = "bfloat16"',
            "-b", f"Config.exp_name = {exp!r}",
            "-b", "Config.print_every = 2",
            "-b", f"Config.train_render_every = {first}",
            "-b", f"Config.checkpoint_every = {first}",
            "-b", "Config.lr_delay_steps = 0"]
    microbatches, levels = 2, 16
    res, paths = {}, {}
    for max_steps, start in ((first, 0), (second, first)):
        name = f"dp_cli_train_{max_steps}"
        ranks, secs = dp_launch(tmp, name, 2, {
            "mode": "cli", "module": "ucnerf_tpu_torch.cli.train",
            "argv": argv + ["--max-steps", str(max_steps)]}, 300)
        steps = max_steps - start
        for r, rr in enumerate(ranks):
            n = rr["launches"]
            check(n["K3"] == n["K3_fused"] == steps * microbatches * 2
                  and n["K2"] == steps * microbatches * 2 and n["K1"] == 0
                  and n["K4_take"] == 0
                  and n["starts"] == steps * microbatches * 4
                  and n["K4"] >= steps * microbatches * levels,
                  f"dp cli.train rank {r}: launches {n} in {steps} steps")
        written = sorted(os.listdir(exp))
        kept = sorted(os.listdir(os.path.join(exp, "checkpoints")))
        # TensorBoard's files, where tensorboardX is installed: one a call.
        check([f for f in written if not f.startswith("events.")]
              == ["checkpoints", "log_train.txt"] and kept == [str(max_steps)]
              and sum(f.startswith("events.") for f in written)
              <= (2 if start else 1),
              f"dp cli.train: the experiment folder holds {written}, "
              f"checkpoints {kept}")
        with open(os.path.join(exp, "log_train.txt")) as f:
            log = f.read()
        lines = {int(a): float(b) for a, b in
                 re.findall(r"step (\d+)/\d+: loss=(\S+)", log)}
        check(max(lines) == max_steps
              and ("resumed from step %d" % start in log) == bool(start)
              and log.count("(rank 0 of 2, gloo)") == (2 if start else 1),
              f"dp cli.train: logged steps {sorted(lines)}, resume and "
              f"rank lines wrong for a start at step {start}")
        render = re.findall(r"test render \d+: psnr=(\S+) ssim=(\S+)", log)
        check(len(render) == 1 and np.isfinite(float(render[0][0])),
              f"dp cli.train: test renders {render}")
        res[name] = {"seconds": secs, "launches": [rr["launches"]
                                                   for rr in ranks],
                     "loss": lines, "test_psnr": float(render[0][0])}
        paths[name] = ranks[0]["launches"]
        print(f"[dp cli] cli.train --multihost at 2 ranks (gloo, one card) "
              f"--max-steps {max_steps} from step {start}: {secs:.1f} s with "
              f"the process starts; logged loss {lines}; test render psnr "
              f"{render[0][0]}; one log and checkpoints {kept}; launches per "
              f"rank {[rr['launches'] for rr in ranks]}", flush=True)

    # cli.eval at two ranks, and in this process on a copy of the folder.
    one = os.path.join(tmp, "exp_one")
    shutil.copytree(exp, one)
    eval_argv = ["--preset", "synthetic_quality", "--limit",
                 str(DP_EVAL_VIEWS)]
    ranks, secs = dp_launch(tmp, "dp_cli_eval", 2, {
        "mode": "cli", "module": "ucnerf_tpu_torch.cli.eval",
        "argv": eval_argv + gloo + ["-b", f"Config.exp_name = {exp!r}"]}, 300)
    # Not a path of the kernels line: the serving phase counts cli.eval.
    cli_eval.main(eval_argv + ["-b", f"Config.exp_name = {one!r}"])
    for r, rr in enumerate(ranks):
        n = rr["launches"]
        check(n["K4"] > 0 and n["K4_take"] == 0 and all(
            v == 0 for k, v in n.items() if not k.startswith("K4")),
            f"dp cli.eval rank {r}: launches {n}; expected K4 alone")
    metrics = {}
    for key in ("psnr", "ssim"):
        vals = []
        for folder in (exp, one):
            with open(os.path.join(folder, f"{key}_{second}.txt")) as f:
                vals.append([float(v) for v in f.read().split()])
        metrics[key] = vals
        check(len(vals[0]) == DP_EVAL_VIEWS and np.allclose(
            vals[0], vals[1], rtol=DP_METRIC_RTOL, atol=0),
            f"dp cli.eval: {key} at 2 ranks {vals[0]}, at 1 {vals[1]}")
    images = [read_png_u8(os.path.join(folder, "test_preds",
                                       "color_000.png"))
              for folder in (exp, one)]
    diff = np.abs(images[0].astype(int) - images[1].astype(int))
    check(images[0].shape == images[1].shape and diff.max() <= 1,
          f"dp cli.eval: view 0's image at 2 ranks and at 1 differ by up "
          f"to {diff.max()} of 255")
    res["dp_cli_eval"] = {
        "seconds": secs, "launches": [rr["launches"] for rr in ranks],
        "metrics_two_one": metrics,
        "view0_u8_max_diff": int(diff.max()),
        "view0_u8_pixels_differing": int((diff > 0).sum())}
    paths["dp_cli_eval"] = ranks[0]["launches"]
    print(f"[dp cli] cli.eval at 2 ranks (gloo) vs 1 on the step-{second} "
          f"checkpoint, {DP_EVAL_VIEWS} views: psnr {metrics['psnr'][0]} vs "
          f"{metrics['psnr'][1]}, ssim {metrics['ssim'][0]} vs "
          f"{metrics['ssim'][1]} (rtol {DP_METRIC_RTOL}); view 0's 8-bit "
          f"image differs by at most {diff.max()} in "
          f"{int((diff > 0).sum())} values; launches per rank "
          f"{[rr['launches'] for rr in ranks]}; {secs:.1f} s", flush=True)
    return res, paths


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--profile", help="also profile one render chunk "
                        "and write its kernel table here")
    parser.add_argument("--dp-worker", metavar="SPEC",
                        help="run one rank of the data-parallel phase "
                             "(started by this script)")
    parser.add_argument("--profile-train", help="also profile one training "
                        "step with each backward, one of the flagship "
                        "preset, one with camera refinement, one with "
                        "normals and one with the options, and write the "
                        "kernel tables here (f32) and beside it with "
                        "'.bf16', '.tpu', '.cam', '.normals' and '.options' "
                        "before the extension")
    args = parser.parse_args(argv)
    if args.dp_worker:
        return dp_worker(args.dp_worker)

    t_start = time.perf_counter()
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
    from ucnerf_tpu_torch.utils import roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"[gpu] {card}", flush=True)
    print(f"[peaks] H100 SXM5 80 GB datasheet at 700 W (utils/roofline.py): "
          f"bf16 dense {roofline.PEAK_FLOPS:.4g} FLOP/s, float32 "
          f"{roofline.PEAK_FLOPS_F32:.4g} FLOP/s, HBM "
          f"{roofline.PEAK_BW:.4g} B/s; this card: {card}", flush=True)
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    libs = build.SOURCES + build.HOST_SOURCES
    secs = build.build(libs, verbose=True)
    print(f"[build] kernels {list(build.SOURCES)} and the host library "
          f"{list(build.HOST_SOURCES)} built in {secs:.1f} s", flush=True)

    k4 = kernel_phase(torch, gather)
    corners_res = card_tests_phase("hash_corners", "hash_corners")
    graph_res = card_tests_phase("train_graph", "train_graph")
    k1, k2, k3, k5 = scatter_phase(torch, scatter, hashgrid, configs)
    slice_res, eval_step, views, cfg, model = slice_phase(
        torch, gather, scatter, configs, cameras, step)
    k4["real_indices"] = real_index_phase(torch, gather, hashgrid, eval_step,
                                          views[0], cfg)
    k4["interleave_per_encode"] = interleave_times(torch, gather, model)
    slice_res["roofline"] = render_roofline(torch, roofline, eval_step,
                                            views[0], cfg, slice_res, "waymo")
    if args.profile:
        profile_chunk(torch, eval_step, views[0], cfg, args.profile)
    del eval_step
    train_cfg = configs.waymo(lr_delay_steps=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(views, train_cfg, TRAIN_RAYS, seed=4).items()}
    grad_res = grad_check_phase(torch, losses_lib, model, train_cfg, batch)
    streams = real_stream_phase(torch, scatter, hashgrid, losses_lib, model,
                                train_cfg, batch)
    k1["real_stream"], k2["real_stream"] = streams["K1"], streams["K2"]
    k3["real_stream"] = streams["K3"]
    initial = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    train_res, f32_grads = train_phase(
        torch, gather, scatter, step, state_lib, model, train_cfg, batch,
        TRAIN_STEPS, "f32")
    train_res["roofline"] = step_roofline(torch, roofline, state_lib,
                                          train_cfg, model, batch, train_res,
                                          "waymo f32")
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
    torch.cuda.empty_cache()
    tpu_res = flagship_phase(
        torch, gather, scatter, hashgrid, step, state_lib, losses_lib,
        roofline, configs, views, initial, batch, k4, k1, k2, k3,
        profile="{0}.tpu{1}".format(*os.path.splitext(args.profile_train))
        if args.profile_train else None)
    dp_res, dp_paths = dp_phase(torch, gather, scatter, configs, step,
                                state_lib, train_cfg, initial, batch,
                                views[0])
    # Every K4 launch of the data-parallel paths (rank 0's) is the fused
    # entry, as on the one-process training and serving paths.
    for label, n in dp_paths.items():
        check(n["K4_take"] == 0 and n["K4_wsum"] > 0,
              f"{label}: K4 launches {n}; expected the fused entry alone")
        K4_BY_ENTRY["take_wsum_cm"] += n["K4_wsum"]
    torch.cuda.empty_cache()

    # Camera refinement from the same initial weights and batch, the deltas
    # at 0: the path on which K4 launches take_cm.
    cam_cfg = cam_config(configs)
    cam_res = cam_train_phase(
        torch, gather, scatter, hashgrid, step, state_lib, losses_lib,
        cam_cfg, batch, initial,
        profile="{0}.cam{1}".format(*os.path.splitext(args.profile_train))
        if args.profile_train else None)
    initial["cam_refine.se3_deltas"] = torch.zeros(cam_cfg.num_phys_cams, 6)
    repeat_res.update(repeat_phase(torch, step, state_lib,
                                   (("camera", cam_cfg),), initial, batch))
    del initial["cam_refine.se3_deltas"]
    torch.cuda.empty_cache()

    # The under-calibrated rig of tools/cam_refine_quality.py at full width:
    # camera refinement with single-query lookups and virtual warping.
    rig_res, rig_paths = rig_phase(torch, gather, scatter, hashgrid, configs,
                                   step, losses_lib)

    # Density and predicted normals with their losses, from the same initial
    # weights (the normal layers from the seed) and batch: the second
    # derivative through the hash grid.
    norm_cfg = normals_config(configs)
    norm_model = step.init_model(norm_cfg, seed=0, device="cuda")
    missing, unexpected = norm_model.load_state_dict(initial, strict=False)
    check(sorted(missing) == sorted(
        f"{f}.normal_layer.{p}" for f in ("nerf_mlp", "prop_mlp_0")
        for p in ("weight", "bias")) and not unexpected,
        f"normals model: missing {missing}, unexpected {unexpected}")
    norm_res = field_phase(
        torch, gather, scatter, hashgrid, step, state_lib, losses_lib,
        norm_cfg, batch, norm_model, NORMALS_STEPS, "normals",
        {"K4": 32, "K4_take": 16, "K4_wsum": 16, "K1": 4, "K1_fused": 4,
         "K1_plain": 0, "K2": 2, "K3": 0, "K3_fused": 0, "K3_planar": 0,
         "K5": 0, "starts": 6}, views=views,
        profile="{0}.normals{1}".format(*os.path.splitext(args.profile_train))
        if args.profile_train else None)
    norm_res["double_backward"] = hold_double_backward(
        torch, gather, scatter, hashgrid, losses_lib, norm_model, norm_cfg,
        batch)
    del norm_model
    torch.cuda.empty_cache()

    # The remaining options (bf16 matmuls, scale featurization, noise, a
    # random background, the interlevel loss) from the same initial weights
    # but the NeRF field's first layer, which scale featurization widens
    # (from the seed).
    opt_cfg = options_config(configs)
    opt_model = step.init_model(opt_cfg, seed=0, device="cuda")
    widened = "nerf_mlp.density_hidden.weight"
    missing, unexpected = opt_model.load_state_dict(
        {k: v for k, v in initial.items() if k != widened}, strict=False)
    check(missing == [widened] and not unexpected,
          f"options model: missing {missing}, unexpected {unexpected}")
    opt_res = field_phase(
        torch, gather, scatter, hashgrid, step, state_lib, losses_lib,
        opt_cfg, batch, opt_model, OPTIONS_STEPS, "options",
        {"K4": 16, "K4_take": 0, "K4_wsum": 16, "K1": 2, "K1_fused": 2,
         "K1_plain": 0, "K2": 2, "K3": 0, "K3_fused": 0, "K3_planar": 0,
         "K5": 0, "starts": 4},
        profile="{0}.options{1}".format(*os.path.splitext(args.profile_train))
        if args.profile_train else None)
    opt_res["bf16_matmul"] = dense_bf16_times(torch, opt_model, opt_cfg)
    del opt_model, initial, batch
    torch.cuda.empty_cache()
    encode_launches = encode_check(torch, gather, scatter, hashgrid, configs,
                                   k1)
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
        step_res, step_paths = ckpt_step_phase(torch, gather, scatter,
                                               configs, exp)
        serve_res, serve_paths = serving_phase(
            torch, gather, scatter, hashgrid, configs, step, exp, k4)
        torch.cuda.empty_cache()
        jax_res, jax_paths = jax_import_phase(
            torch, gather, scatter, configs, step, state_lib, cli_train, exp)
    finally:
        shutil.rmtree(exp, ignore_errors=True)
    torch.cuda.empty_cache()
    mvs_res, mvs_paths = mvs_phase(torch, gather, scatter)
    torch.cuda.empty_cache()
    pose_res, pose_paths = pose_phase(torch, gather, scatter)

    # Launches of each main path, counted from 0 just before it.
    paths = {"render": slice_res["launches"],
             "train_f32": train_res["launches"],
             "train_bf16": bf16_res["launches"],
             "render_waymo_tpu": tpu_res["render"]["launches"],
             "train_waymo_tpu_f32": tpu_res["train_f32"]["launches"],
             "train_waymo_tpu_bf16": tpu_res["train_bf16"]["launches"],
             "train_waymo_tpu_f32_m10": tpu_res["train_f32_m10"]["launches"],
             "train_cam": cam_res["launches"], **rig_paths,
             "train_normals": norm_res["launches"],
             "render_normals": norm_res["render"]["launches"],
             "train_options": opt_res["launches"],
             "encode": encode_launches,
             "cli_train": cli_res[0]["launches"],
             "cli_resume": cli_res[1]["launches"], **step_paths,
             **serve_paths,
             **jax_paths,
             **mvs_paths, **pose_paths, **dp_paths}
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
    # check_fused_entry held on every path but the camera-refinement ones
    # that each K4 launch was the fused entry, and check_take_entry on those
    # paths that each was take_cm: take_cm is launched where the sample
    # positions need a gradient (and by the kernel and real-index phases,
    # which are not paths).
    check(sum(K4_BY_ENTRY.values()) == k4["launches"],
          f"K4's launches by entry {K4_BY_ENTRY} do not add up to "
          f"{k4['launches']}")
    take_paths = ("train_cam", "rig_composed", "train_normals",
                  "render_normals", "encode")
    check(K4_BY_ENTRY["take_cm"] == sum(paths[p]["K4_take"]
                                        for p in take_paths)
          and all(paths[p]["K4_take"] > 0 for p in take_paths)
          and all(n.get("K4_take", 0) == 0 for p, n in paths.items()
                  if p not in take_paths),
          f"take_cm launched {K4_BY_ENTRY['take_cm']} times on the paths; "
          f"expected it on {take_paths} alone: "
          f"{ {p: n.get('K4_take') for p, n in paths.items()} }")
    k4["launches_by_entry"] = dict(K4_BY_ENTRY)
    k4["take_wsum_cm"].update(
        name="take_wsum_cm (K4's fused entry: gather + 8-corner weighted "
             "sum)", route=k4["route"], source=k4["source"],
        replaces=k4["replaces"], launches=K4_BY_ENTRY["take_wsum_cm"])
    k4["take_cm_real_step"] = cam_res["take_cm_real_step"]
    # K1 launches on the paths only through its fused entry: no path builds
    # the [C, 8 N L] values.  Every sort of K1, K2 and K3 ends with the run
    # starts pass, held against searchsorted in the kernel phase.
    k1["launches_by_entry"] = {
        "scatter_add_wsum_cm": sum(n["K1_fused"] for n in paths.values()),
        "scatter_add_cm": sum(n["K1_plain"] for n in paths.values())}
    # K1's plain entry has one caller, the reference encoder's backward.
    check(k1["launches_by_entry"]["scatter_add_cm"]
          == paths["encode"]["K1_plain"] == 1,
          f"K1's plain entry launched on the paths "
          f"{ {p: n.get('K1_plain') for p, n in paths.items()} }; expected "
          f"once, on the encoder's path alone")
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
        entry["launches_per_camera_step"] = cam_res["launches_per_step"][key]
    k3["launches_per_step"] = bf16_res["launches_per_step"]["K3"]
    # The flagship's step (15 microbatches) and render chunk.
    for entry, key, label in ((k4, "K4", "train_f32"), (k1, "K1", "train_f32"),
                              (k2, "K2", "train_f32"),
                              (k3, "K3", "train_bf16")):
        entry["launches_per_waymo_tpu_step"] = \
            tpu_res[label]["launches_per_step"][key]
    k4["launches_per_waymo_tpu_chunk"] = \
        tpu_res["render"]["launches_per_chunk"]
    # Per rank of the two-rank data-parallel step (7500 rays a rank).
    dp_step = {label: dp_res["gloo_world2"][label]["launches_per_step_rank0"]
               for label in ("f32", "bf16")}
    # And of the three-rank flagship step (shares of 333 and 334 rays).
    dp_tpu = {label: dp_res["gloo_world3_waymo_tpu"][label][
        "launches_per_step_rank0"] for label in ("f32", "bf16")}
    for entry, key, label in ((k4, "K4", "f32"), (k1, "K1", "f32"),
                              (k2, "K2", "f32"), (k3, "K3", "bf16")):
        entry["launches_per_dp_step_per_rank"] = dp_step[label][key]
        entry["launches_per_waymo_tpu_dp_step_per_rank"] = dp_tpu[label][key]
    # The normals step's new roles: K4's two entries and K1's fused entry
    # twice (the table gradient and the double backward's d/d table).
    k4["launches_per_normals_step"] = {
        "take_cm": norm_res["launches_per_step"]["K4_take"],
        "take_wsum_cm": norm_res["launches_per_step"]["K4_wsum"]}
    k4["launches_per_normals_render_chunk"] = \
        norm_res["render"]["take_cm_per_chunk"]
    k4["double_backward"] = norm_res["double_backward"]["K4"]
    k1["launches_per_normals_step"] = norm_res["launches_per_step"]["K1"]
    k1["double_backward"] = norm_res["double_backward"]["K1"]
    k2["launches_per_normals_step"] = norm_res["launches_per_step"]["K2"]

    kernels = {"kernels": [k4, k1, k2, k3, k5]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "render": slice_res, "train": train_res,
                       "train_bf16": bf16_res, "train_cam": cam_res,
                       "rig": rig_res,
                       "train_normals": norm_res, "train_options": opt_res,
                       "repeat": repeat_res, "waymo_tpu": tpu_res,
                       "dp": dp_res, "cli": cli_res,
                       "ckpt_step": step_res,
                       "serve": serve_res, "jax_import": jax_res,
                       "grad_check": grad_res,
                       "mvs": mvs_res, "pose": pose_res,
                       "hash_corners": corners_res,
                       "train_graph": graph_res}, f, indent=1)
    print(f"[time] the whole smoke, the kernels' build included: "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

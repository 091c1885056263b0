#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ucnerf_tpu_torch``) on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--out results.json]

Phases:
  1. print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from ucnerf_tpu_torch/csrc/, all in parallel;
  3. kernel phase: hold each kernel against its plain PyTorch version at the
     shapes the main paths give it (K4 at a render chunk's proposal level;
     K1 and K2 at one training microbatch of each grid, with a skewed row
     of 1e5 updates), check that the scatters are bitwise deterministic, and
     time kernel, plain version and the nearest single PyTorch call;
  4. render phase: render 2 views of 480x320 through ``render_image`` with
     the canonical Waymo model (``configs.waymo()``, full width, random
     weights from a seed), count the kernel launches of that run, check the
     outputs, and match a 64-ray chunk against the same model on the CPU;
  5. gradient check: one 64-ray training microbatch on the card against
     the same model on the CPU (plain versions of every kernel);
  6. training phase: one warm-up and 5 timed steps of
     ``configs.waymo(lr_delay_steps=0)`` (15000 rays in 10 microbatches,
     Adam) on a fixed batch drawn from the two views; check the losses, the
     updates, the table gradients and the launches of K1, K2 and K4;
  7. print the ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` as
     the last line.

Any failure raises and exits non-zero; without a CUDA device the script
fails before printing any result.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

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
# Training: rays per step, timed steps.
TRAIN_RAYS = 15000
TRAIN_STEPS = 5
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


def kernel_phase(torch, gather):
    """K4 (hash-grid gather) at one proposal level's real shape."""
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

    # A column slice of a larger table (how the encoder calls it).
    big = torch.randn((4, 3 * HASHED_ROWS), generator=gen, device=dev)
    part = big[:, HASHED_ROWS:2 * HASHED_ROWS]
    sub = idx[:1 << 22]
    check(torch.equal(gather.take_cm(part, sub),
                      gather.take_cm_plain(part, sub)),
          "take_cm on a column slice differs from its plain version")
    del big, part, sent

    ms = time_ms(lambda: gather.take_cm(table, idx), torch)
    plain_ms = time_ms(lambda: gather.take_cm_plain(table, idx), torch)
    library_ms = time_ms(lambda: torch.index_select(table, 1, idx), torch)
    rows_touched = int(torch.unique(idx).numel())
    nbytes = 4 * PROP_M + 4 * 4 * PROP_M + 4 * 4 * rows_touched
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[kernel] take_cm M={PROP_M} rows={HASHED_ROWS}: {ms:.4f} ms "
          f"(plain {plain_ms:.4f}, index_select {library_ms:.4f}, "
          f"bound {bound_ms:.4f} ms from {nbytes} B)", flush=True)
    return {
        "name": "take_cm (hash-grid gather, K4)",
        "route": "cuda",
        "source": "ucnerf_tpu_torch/csrc/gather.cu",
        "replaces": "ucnerf_tpu/ops/gather.py:129",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
        "shape": {"C": 4, "rows": HASHED_ROWS, "M": PROP_M},
    }


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


def scatter_phase(torch, scatter, hashgrid, configs):
    """K1 and K2 at the shapes of one training microbatch of each grid."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    c = 4
    k1, k2 = ({"ms": 0.0, "prep_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "max_abs_err": 0.0, "per_call": []}
              for _ in range(2))
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
        err = check_scatter(
            torch, f"K1 {name}",
            lambda: scatter.segment_sum_cm(values, perm, starts, out),
            scatter.scatter_add_cm_plain(values.double(), idx, hashed_rows))
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
        outd = torch.empty((c, dense_rows), device=dev)
        kw = dict(level_len=hm, strides=spec.dense_strides)
        perm, starts = scatter.sort_rows(base, dense_rows)
        errd = check_scatter(
            torch, f"K2 {name}",
            lambda: scatter.dense_sum_cm(g, fr, perm, starts,
                                         spec.offsets[:nd + 1],
                                         spec.dense_strides, outd),
            scatter.scatter_add_dense_cm_plain(g.double(), fr, base,
                                               dense_rows, **kw))
        # The library yardstick: index_add_ over the corner-expanded updates.
        frb = fr.to(torch.bfloat16).float()
        vals8, idx8 = [], []
        for l, s in enumerate(spec.dense_strides):
            sl = slice(l * hm, (l + 1) * hm)
            for corner in range(8):
                off = ((corner & 1) + ((corner >> 1) & 1) * s
                       + ((corner >> 2) & 1) * s * s)
                vals8.append(scatter._dense_weights(frb[:, sl], corner)
                             * g[:, sl])
                idx8.append(base[sl].long() + off)
        vals8, idx8 = torch.cat(vals8, dim=1), torch.cat(idx8)
        calld = {
            "grid": name, "M": md, "rows": dense_rows,
            "ms": time_ms(lambda: scatter.dense_sum_cm(
                g, fr, perm, starts, spec.offsets[:nd + 1],
                spec.dense_strides, outd), torch),
            "prep_ms": time_ms(lambda: scatter.sort_rows(base, dense_rows),
                               torch),
            "plain_ms": time_ms(lambda: scatter.scatter_add_dense_cm_plain(
                g, fr, base, dense_rows, out=outd, **kw), torch),
            "library_ms": time_ms(lambda: outd.zero_().index_add_(
                1, idx8, vals8), torch),
            "bound_ms": (md * (8 + 12 + 4 * c) + (dense_rows + 1) * 4
                         + dense_rows * 4 * c) / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": errd}
        del g, fr, outd, perm, starts, base, vals8, idx8, frb
        for entry, rec in ((k1, call), (k2, calld)):
            entry["per_call"].append(rec)
            for k in ("ms", "prep_ms", "plain_ms", "library_ms", "bound_ms"):
                entry[k] += rec[k]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       rec["max_abs_err"])
        for label, rec in (("K1", call), ("K2", calld)):
            print(f"[kernel] {label} {name} M={rec['M']} rows={rec['rows']}: "
                  f"{rec['ms']:.4f} ms (prep {rec['prep_ms']:.4f}, plain "
                  f"{rec['plain_ms']:.4f}, index_add_ {rec['library_ms']:.4f}"
                  f", bound {rec['bound_ms']:.4f}), max abs err "
                  f"{rec['max_abs_err']:.3g}", flush=True)
    torch.cuda.empty_cache()
    k1.update(name="scatter_add_cm (hashed-level table gradient, K1)",
              route="cuda", source="ucnerf_tpu_torch/csrc/scatter.cu",
              replaces="ucnerf_tpu/ops/scatter.py:127", bound_by="bytes")
    k2.update(name="scatter_add_dense_cm (dense-level table gradient, K2)",
              route="cuda", source="ucnerf_tpu_torch/csrc/scatter.cu",
              replaces="ucnerf_tpu/ops/scatter.py:604", bound_by="bytes")
    return k1, k2


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


def slice_phase(torch, gather, configs, cameras, step):
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
    gather.take_cm.launches = 0
    outs, secs = [], []
    for v in views:
        t0 = time.perf_counter()
        outs.append(step.render_image(eval_step, v, cfg, eval_camidx=0))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = gather.take_cm.launches
    peak = torch.cuda.max_memory_allocated()

    levels = cfg.nerf_mlp.grid_num_levels + sum(
        cfg.prop_mlp.with_grid(g).grid_num_levels
        for g in cfg.model.prop_desired_grid_size[:cfg.model.num_levels - 1])
    check(launches == levels * chunks,
          f"take_cm launched {launches} times, expected {levels} per chunk "
          f"x {chunks} chunks")
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
          f"take_cm launches {launches} ({levels}/chunk x {chunks}), "
          f"peak {peak / 2**30:.2f} GiB", flush=True)

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
           "seconds": secs, "chunks": chunks, "launches": launches,
           "launches_per_chunk": levels, "peak_bytes": peak,
           "render_subchunks": cfg.render_subchunks,
           "gpu_vs_cpu_max_abs_err": errs}
    return res, eval_step, views, cfg, model


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


def train_phase(torch, gather, scatter, step, state_lib, model, cfg,
                batch):
    """The training slice: 5 timed steps of configs.waymo() at full width."""
    state = state_lib.create_train_state(cfg, model)
    train_step = step.make_train_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    state, _ = train_step(state, batch, 0.5, generator=gen)  # warm-up
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats()
    gather.take_cm.launches = 0
    scatter.scatter_add_cm.launches = 0
    scatter.scatter_add_dense_cm.launches = 0
    secs, totals, terms = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, stats = train_step(state, batch, 0.5, generator=gen)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        totals.append(float(stats["loss"]))
        terms.append({k: float(v) for k, v in stats["losses"].items()})
    launches = {"K1": scatter.scatter_add_cm.launches,
                "K2": scatter.scatter_add_dense_cm.launches,
                "K4": gather.take_cm.launches}
    peak = torch.cuda.max_memory_allocated()

    for i, (total, t) in enumerate(zip(totals, terms)):
        check(np.isfinite(total) and all(np.isfinite(v) for v in t.values()),
              f"step {i + 1}: non-finite loss {total} {t}")
    check(totals[-1] < totals[0],
          f"loss did not fall: step 1 {totals[0]}, step {TRAIN_STEPS} "
          f"{totals[-1]}")
    unchanged = [n for n, p in model.named_parameters()
                 if torch.equal(before[n], p.detach())]
    check(not unchanged, f"parameters not updated: {unchanged}")
    no_grad = [n for n, p in model.named_parameters()
               if n.endswith(".table") and not bool(p.grad.abs().max() > 0)]
    check(not no_grad, f"tables with a zero gradient: {no_grad}")
    per_step = {"K1": 2 * cfg.microbatches, "K2": 2 * cfg.microbatches,
                "K4": 16 * cfg.microbatches}
    for k, n in per_step.items():
        check(launches[k] == n * TRAIN_STEPS,
              f"{k} launched {launches[k]} times in {TRAIN_STEPS} steps, "
              f"expected {n} per step")
    med = float(np.median(secs))
    print(f"[train] waymo {TRAIN_RAYS} rays x {TRAIN_STEPS} steps "
          f"({cfg.microbatches} microbatches): step s "
          f"{[round(x, 4) for x in secs]}, train rays/s "
          f"{TRAIN_RAYS / med:.1f}, peak {peak / 2**30:.2f} GiB, loss "
          f"{[round(x, 5) for x in totals]}, launches {launches}",
          flush=True)
    print(f"[train] loss terms step 1 {terms[0]}, step {TRAIN_STEPS} "
          f"{terms[-1]}", flush=True)
    return {"rays_per_s": TRAIN_RAYS / med, "step_seconds": secs,
            "peak_bytes": peak, "totals": totals, "terms": terms,
            "launches": launches, "launches_per_step": per_step,
            "microbatches": cfg.microbatches}


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
    write_profile(torch, prof, wall_us, path,
                  f"one training step of {batch['origins'].shape[0]} rays",
                  ("rows_kernel", "long_rows_kernel", "RadixSort",
                   "searchsorted", "take_cm_kernel"))


def write_profile(torch, prof, wall_us, path, what, names):
    """Device kernels of a profile by time, with the listed kernels' sums
    and the device's busy share of the wall time."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))
    device_us = sum(dev_us(e) for e in events)
    named = {n: sum(dev_us(e) for e in events if n in e.key) for n in names}
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
                  ("take_cm_kernel",))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the results as JSON here")
    parser.add_argument("--profile", help="also profile one render chunk "
                        "and write its kernel table here")
    parser.add_argument("--profile-train", help="also profile one training "
                        "step and write its kernel table here")
    args = parser.parse_args(argv)

    import torch
    check(torch.cuda.is_available(), "no CUDA device")
    sys.path.insert(0, ROOT)
    from ucnerf_tpu_torch import configs
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
    k1, k2 = scatter_phase(torch, scatter, hashgrid, configs)
    slice_res, eval_step, views, cfg, model = slice_phase(
        torch, gather, configs, cameras, step)
    if args.profile:
        profile_chunk(torch, eval_step, views[0], cfg, args.profile)
    del eval_step
    train_cfg = configs.waymo(lr_delay_steps=0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             train_batch(views, train_cfg, TRAIN_RAYS, seed=4).items()}
    grad_res = grad_check_phase(torch, losses_lib, model, train_cfg, batch)
    train_res = train_phase(torch, gather, scatter, step, state_lib, model,
                            train_cfg, batch)
    print(f"[train] peak memory {train_res['peak_bytes']} B "
          f"({train_res['peak_bytes'] / 2**30:.2f} GiB)", flush=True)
    if args.profile_train:
        profile_train_step(torch, model, train_cfg, batch, step, state_lib,
                           args.profile_train)

    k4["launches_render"] = slice_res["launches"]
    k4["launches_per_chunk"] = slice_res["launches_per_chunk"]
    k4["launches_train"] = train_res["launches"]["K4"]
    k4["launches_per_step"] = train_res["launches_per_step"]["K4"]
    k4["launches"] = k4["launches_render"] + k4["launches_train"]
    for entry, key in ((k1, "K1"), (k2, "K2")):
        entry["launches"] = train_res["launches"][key]
        entry["launches_per_step"] = train_res["launches_per_step"][key]

    kernels = {"kernels": [k4, k1, k2]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "render": slice_res, "train": train_res,
                       "grad_check": grad_res}, f, indent=1)
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

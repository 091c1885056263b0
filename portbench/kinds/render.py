"""The ``render`` kind: ``cli.render``'s loop on the port.

Set-up makes the segment's path, the parameters from the seed (widened, so
that every parameter shapes the render), the port's model and eval step,
and renders one view to warm up every chunk shape.  The window renders
whole views along the path, from a start frame drawn from the seed, each
as ``cli.render`` does (the view's rays on the host, then
``step.render_image``), until ``seconds`` have passed; the rate is all rays
of the finished views over their whole time.  A traced run profiles
``trace_units`` views after ``trace_after`` views of the window.

Once the window has closed and the port's state is freed, the reference
renders ``check_views`` of the window's views, drawn from the seed, and
``check.render_numbers`` compares them with what the window produced.
"""

from __future__ import annotations


import numpy as np

from portbench import check, scene as scene_lib, weights
from portbench.kinds.common import (Result, port_model, run_window,
                                    to_device)
from portbench.reference import rays as ref_rays
from portbench.reference import steps as ref_steps


def view_batch(scene, pose, cfg):
    """A path frame's rays as ``cli.render`` makes them: every pixel with
    the first view's intrinsics, and the keys a dataset batch carries."""
    from ucnerf_tpu_torch.data import cameras
    h, w = scene.height, scene.width
    batch = cameras.pose_image_batch(scene.pixtocams[0], pose, w, h,
                                     cfg["near"], cfg["far"])
    batch["lossmult"] = np.ones((h, w, 1), np.float32)
    batch["sky_segs"] = np.zeros((h, w), np.float32)
    batch["rgb"] = np.zeros((h, w, 3), np.float32)
    return batch


def reference_views(cell, scene, path, frames, precision=None):
    """The reference's renders of path `frames`, one dict of flat arrays
    a frame."""
    cfg = cell.cfg
    params = weights.make(cfg, cell.seed, cell.device, widen=True)
    out = []
    for f in frames:
        rays = to_device(ref_rays.view_batch(
            scene.pixtocams[0], path[f], scene.width, scene.height,
            cfg["near"], cfg["far"]), cell.device)
        out.append(ref_steps.render(params, cfg, rays, precision=precision))
    return out


def flat(rendering):
    return {k: np.asarray(rendering[k]).reshape(
        (-1,) + np.shape(rendering[k])[2:]) for k in ref_steps.OUTPUTS}


def run(cell) -> Result:
    from ucnerf_tpu_torch.train import step as step_lib
    cfg, tr = cell.cfg, cell.traffic
    cell.stage("imports")
    scene = scene_lib.Scene(tr["scene"], cell.seed, "test")
    path = scene.path_poses(tr["path_frames"])
    cell.stage("scene")
    params = weights.make(cfg, cell.seed, cell.device, widen=True)
    model = port_model(cell.config, params, cell.device)
    del params
    cell.stage("model")
    eval_step = step_lib.make_eval_step(model, cell.config)
    rays = scene.width * scene.height
    chunks = -(-rays // cfg["render_chunk_size"])
    start = int(np.random.default_rng((cell.seed, 4)).integers(len(path)))

    def render(i):
        batch = view_batch(scene, path[(start + i) % len(path)], cfg)
        return step_lib.render_image(eval_step, batch, cell.config,
                                     train_frac=1.0, eval_camidx=0)
    render(-1)
    cell.sync()
    cell.stage("warm-up view")
    setup_peak = cell.peak_bytes()
    cell.mark_setup_done()

    cell.reset_peak()
    outputs = []
    win = run_window(cell, lambda i, traced: outputs.append(flat(render(i))),
                     tr["trace_after"], tr["trace_units"])
    window_peak = cell.peak_bytes()
    cell.note_intervals("view", win.stamps)
    peak = max(setup_peak, window_peak)
    failed = sum(1 for o in outputs
                 if not all(np.isfinite(o[k]).all() for k in ("rgb", "acc")))
    del model, eval_step
    cell.free()

    n = win.units
    pick = np.random.default_rng((cell.seed, 5)).choice(
        n, size=min(tr["check_views"], n), replace=False)
    frames = [(start + int(i)) % len(path) for i in pick]
    ref = reference_views(cell, scene, path, frames)
    numbers = check.render_numbers([outputs[int(i)] for i in pick], ref)
    lim = check.limits(cell.name)
    ok, checks = check.judge(numbers, lim)
    cell.note("read, not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items() if k not in lim))
    res = Result(correct=ok and failed == 0, attempted=n, failed=failed,
                 end_to_end={"render_rays_per_s": rays * n / win.seconds,
                             "peak_mem_gib": window_peak / 2**30},
                 checks=checks, memory_peak_bytes=peak)
    if win.trace is not None:
        untraced = n - tr["trace_units"]
        res.trace, res.units, res.unit_rays = (win.trace, tr["trace_units"],
                                               rays)
        res.unit_s = ((win.seconds - win.traced_s) / untraced if untraced
                      else None)
        res.chunks_per_unit = chunks
    return res

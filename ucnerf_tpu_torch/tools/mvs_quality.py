"""MVS depth quality: the trained tiny cascade against the analytic depth
(port of ``tools/mvs_quality.py``).

Stages, as the JAX tool runs them (``cli/mvs_depth.py`` at the synthetic
scene's scale):
  1. train the tiny cascade on ``SyntheticMVSWindows`` through
     ``cli.mvs_train`` (the entry point users run);
  2. per view: cascade inference at rescales (0.5, 1.0) ->
     ``postprocess_disp`` -> nearest upsampling -> ``multires_fusion``;
  3. adaptive-threshold geometric fusion across views
     (``adaptive_geometric_fusion``) -> ``fused_point_cloud``;
  4. abs-rel depth error (mean / median over the valid pixels) against
     the analytic depth at every stage, for the random-init and the
     trained weights, and the fused point count.

The initial weights are drawn from ``--seed`` (``cli.mvs_train
--seed``), or read from ``--init``, an MVS export of
``tools/export_jax_checkpoint.py --mvs``: with the JAX CLI's initial
weights exported, the port and the JAX tool train from the same point.
``--device`` is cuda unless the CPU is asked for; without a card the tool
raises.  The tool runs in full f32, as the JAX tool does on the CPU: on the
card it turns TF32 off for its run (cuDNN's convolutions take it by
default, and the trained cascade's scores move with it: seed 0's per-view
median abs-rel 0.0586 with TF32 against 0.0522 without on the H100).
``--json`` also writes the table and the training losses.

Usage:
  python -m ucnerf_tpu_torch.tools.mvs_quality --steps 600
  python -m ucnerf_tpu_torch.tools.mvs_quality --device cpu --steps 10 \\
      --init mvs_init.npz
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

STAGES = ("per-view", "multires", "geo-fused")
RESCALES = (0.5, 1.0)


def abs_rel(pred, gt):
    """(mean, median, valid share) of |pred - gt| / gt where both are
    positive; NaN means and 0 share where no pixel is."""
    valid = (pred > 0) & (gt > 0)
    if valid.sum() == 0:
        return float("nan"), float("nan"), 0.0
    r = np.abs(pred[valid] - gt[valid]) / gt[valid]
    return float(r.mean()), float(np.median(r)), float(valid.mean())


def eval_windows(crop, eval_crop, views):
    """The JAX tool's windows: the tiny preset's synthetic scene rendered
    at the larger of the two crops, `views` views."""
    from ucnerf_tpu_torch import configs
    from ucnerf_tpu_torch.models.mvs.datasets import SyntheticMVSWindows

    scene = configs.tiny(synthetic_height=max(crop[0], eval_crop[0]),
                         synthetic_width=max(crop[1], eval_crop[1]))
    return SyntheticMVSWindows(config=scene, num_views=views)


def view_depths(model, win, eval_crop, device):
    """Stage 2 for every view of `win`: ([N, H, W] depth of the rescale 1.0
    pass, [N, H, W] multires fusion of the two passes), both at
    `eval_crop`, as numpy."""
    import torch

    from ucnerf_tpu_torch.cli import common
    from ucnerf_tpu_torch.cli.mvs_depth import rescaled
    from ucnerf_tpu_torch.models.mvs.pipelines import (multires_fusion,
                                                       postprocess_disp,
                                                       resize)

    ech, ecw = eval_crop

    def to_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    per_view, fused = [], []
    with torch.no_grad(), common.deterministic_cudnn():
        for index in range(len(win)):
            images, poses, intr, scale = win.window(index)
            images = images[:, :ech, :ecw]
            passes = []
            for rescale in RESCALES:
                imgs, k = rescaled(to_device(images), intr, rescale)
                disp = model(imgs, to_device(poses), to_device(k),
                             scale=scale)
                depth = postprocess_disp(disp)
                if tuple(depth.shape) != (ech, ecw):
                    depth = resize(depth, (ech, ecw), "nearest")
                passes.append(depth.cpu().numpy())
            per_view.append(passes[-1])
            fused.append(multires_fusion(passes[0], passes[-1]))
    return np.stack(per_view), np.stack(fused)


def geo_fusion(fused, win, device):
    """Stage 3: each view against its two ring neighbours
    (``adaptive_geometric_fusion``, glb 0.25, on `device`): the masked
    fused depths [N, H, W] and the fused points [M, 3]."""
    import torch

    from ucnerf_tpu_torch.models.mvs.pipelines import (
        adaptive_geometric_fusion, fused_point_cloud)

    n = len(win)
    pairs = [(i, [(i - 1) % n, (i + 1) % n]) for i in range(n)]
    results = adaptive_geometric_fusion(
        torch.from_numpy(np.ascontiguousarray(fused, np.float32)).to(device),
        win.poses[:n], win.intrinsics[:n], pairs, glb=0.25)
    masked = np.stack([np.where(results[i][0], results[i][1], 0.0)
                       for i in range(n)])
    xyz, _ = fused_point_cloud(results, win.images[:n] / 255.0,
                               win.poses[:n], win.intrinsics[:n])
    return masked, xyz


def pipeline(model, win, eval_crop, device):
    """Stages 2-4 of `model`: ({stage: (mean, median, valid share)},
    fused point count, {stage: [N, H, W] depths})."""
    ech, ecw = eval_crop
    per_view, fused = view_depths(model, win, eval_crop, device)
    masked, xyz = geo_fusion(fused, win, device)
    depths = dict(zip(STAGES, (per_view, fused, masked)))
    gts = np.stack([win.depths[i][:ech, :ecw] for i in range(len(win))])
    return ({s: abs_rel(d, gts) for s, d in depths.items()}, len(xyz),
            depths)


def table_lines(scores):
    """The JAX tool's printed table of {label: (stages, points)}."""
    lines = ["          stage            mean-absrel  median-absrel  "
             "valid-frac"]
    for label, (stages, npts) in scores.items():
        for stage, m in stages.items():
            lines.append(f"{label:>12} {stage:<12} {m[0]:11.4f}  "
                         f"{m[1]:13.4f}  {m[2]:9.3f}")
        lines.append(f"{label:>12} fused points: {npts}")
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--crop", type=int, nargs=2, default=(64, 96))
    parser.add_argument("--eval-crop", type=int, nargs=2, default=None,
                        help="run stages 2-3 at this crop (defaults to "
                             "--crop)")
    parser.add_argument("--views", type=int, default=5)
    init = parser.add_mutually_exclusive_group()
    init.add_argument("--seed", type=int, default=0,
                      help="seed of the initial weights")
    init.add_argument("--init", default=None,
                      help="initial weights: an MVS export (.npz) of "
                           "tools/export_jax_checkpoint.py --mvs")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda | cpu)")
    parser.add_argument("--json", default=None,
                        help="also write the scores and losses here")
    args = parser.parse_args(argv)

    from ucnerf_tpu_torch.cli import common

    device = common.resolve_device(args.device)
    with common.no_tf32():
        return _run(args, device)


def _run(args, device):
    """The tool's stages with the parsed flags `args` on `device`."""
    import torch

    from ucnerf_tpu_torch.cli import mvs_train

    crop = tuple(args.crop)
    eval_crop = tuple(args.eval_crop or args.crop)
    win = eval_windows(crop, eval_crop, args.views)
    start = (["--init", args.init] if args.init
             else ["--seed", str(args.seed)])

    # --- 1. train through the CLI entry point ---------------------------
    with tempfile.TemporaryDirectory(prefix="mvs_quality_") as tmp:
        ckpt = os.path.join(tmp, "mvs.pt")
        losses = mvs_train.main(
            ["--tiny", "--steps", str(args.steps), "--crop", *map(str, crop),
             "--out", ckpt, "--device", str(device)] + start)
        state = torch.load(ckpt, map_location="cpu",
                           weights_only=True)["state_dict"]
    print(f"\ntraining: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {args.steps} steps")
    initial = mvs_train.build_model(True, args.seed, args.init)
    trained = mvs_train.build_model(True, args.seed, args.init)
    trained.load_state_dict(state)

    scores, depths = {}, {}
    for label, model in (("random-init", initial), ("TRAINED", trained)):
        stages, npts, depths[label] = pipeline(model.to(device).eval(), win,
                                               eval_crop, device)
        scores[label] = (stages, npts)
    print()
    print("\n".join(table_lines(scores)), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"flags": vars(args),
                       "device": str(device), "losses": losses,
                       "scores": {label: {"stages": stages, "points": npts}
                                  for label, (stages, npts)
                                  in scores.items()}}, f, indent=1)
    return {"losses": losses, "scores": scores, "depths": depths}


if __name__ == "__main__":
    main()

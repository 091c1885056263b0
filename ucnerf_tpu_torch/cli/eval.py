"""Evaluation CLI (port of ``ucnerf_tpu/cli/eval.py``): render the test
split, compute PSNR/SSIM (+cc variants).

Renders every test image with ``train/step.render_image``, computes the
metrics plus their color-corrected variants (an affine fit of the
prediction onto the ground truth, ``utils/image.color_correct``), writes
per-image outputs under ``<exp>/test_preds/`` and one ``<metric>_<step>.txt``
per metric, and can poll for new checkpoints like the reference's follower
mode (``Config.eval_only_once = False``).  Under torchrun with
``WORLD_SIZE > 1`` the ranks join one process group and split every image's
chunks between them (``step.render_image`` with the group, the JAX CLI's
mesh over every device); rank 0 picks the checkpoint, computes the metrics
and writes every file.

Usage:
  python -m ucnerf_tpu_torch.cli.eval --preset waymo \
      -b "Config.exp_name = '...'"
  python -m ucnerf_tpu_torch.cli.eval --tiny --device cpu
  torchrun --nproc-per-node 8 -m ucnerf_tpu_torch.cli.eval --preset waymo \
      -b "Config.exp_name = '...'"   # one rank per card
"""

from __future__ import annotations

import os
import time

import numpy as np

# Rays of the first test image that --ray-histograms runs the model on.
HISTOGRAM_RAYS = 64


def main(argv=None):
    from ucnerf_tpu_torch.cli import common

    parser = common.make_parser(__doc__)
    parser.add_argument("--limit", type=int, default=None,
                        help="evaluate at most N test images")
    parser.add_argument("--ray-histograms", action="store_true",
                        help="save per-level ray color/weight histogram "
                             "panels for the first test image "
                             "(vis.py:193-221)")
    common.add_device_arg(parser)
    common.add_dist_args(parser)
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)

    from ucnerf_tpu_torch.parallel import mesh

    device, group = common.join_processes(args, mesh.launched())
    exp, logger = common.setup_experiment(config, "eval")
    common.log_processes(device, group, logger)
    main_process = mesh.is_main_process()

    from ucnerf_tpu_torch.data import datasets
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.train import step as step_lib
    from ucnerf_tpu_torch.utils import image as image_lib

    test_dataset = datasets.load_dataset("test", config)
    model = step_lib.init_model(config, seed=0, device=device)

    last_step = -1
    while True:
        # Cheap poll first: a restore reads the whole checkpoint.  Rank 0
        # picks the step, so that every rank restores the same one.
        latest = mesh.broadcast_object(ckpt_lib.latest_checkpoint_step(exp),
                                       group)
        step = latest or 0
        if step == last_step:
            if config.eval_only_once:
                break
            time.sleep(10)
            continue
        if latest is not None:
            ckpt_lib.restore_model(exp, model, latest)
        last_step = step
        logger.info("evaluating checkpoint step %d", step)

        eval_step = step_lib.make_eval_step(model, config)
        harness = image_lib.MetricHarness()

        n = test_dataset.n_examples
        if args.limit:
            n = min(n, args.limit)
        all_metrics = []
        out_dir = os.path.join(exp, "test_preds")
        os.makedirs(out_dir, exist_ok=True)
        for idx in range(n):
            img_batch = test_dataset.image_batch(idx)
            camidx = _eval_camidx(config, idx, test_dataset.cam_num)
            t0 = time.perf_counter()
            rendering = step_lib.render_image(
                eval_step, img_batch, config, train_frac=1.0,
                eval_camidx=camidx, group=group)
            dt = time.perf_counter() - t0
            if not main_process:
                continue
            gt = img_batch["rgb"]
            pred = np.clip(rendering["rgb"], 0, 1)
            metrics = harness(pred, gt,
                              quantize=config.eval_quantize_metrics)
            pred_cc = image_lib.color_correct(pred, gt)
            metrics.update(harness(pred_cc, gt, name_fn=lambda s: s + "_cc",
                                   quantize=config.eval_quantize_metrics))
            rays_per_sec = gt.shape[0] * gt.shape[1] / dt
            logger.info(
                "image %d/%d: psnr=%.3f ssim=%.4f psnr_cc=%.3f (%.0f rays/s)",
                idx, n, metrics["psnr"], metrics["ssim"], metrics["psnr_cc"],
                rays_per_sec)
            all_metrics.append(metrics)
            if config.eval_save_output:
                save_panels(out_dir, f"{idx:03d}", pred, rendering)
            if args.ray_histograms and idx == 0:
                _save_ray_histograms(model, img_batch, camidx, out_dir, idx)

        if all_metrics and config.eval_save_output:
            for key in all_metrics[0]:
                vals = [m[key] for m in all_metrics]
                path = os.path.join(exp, f"{key}_{step}.txt")
                with open(path, "w") as f:
                    f.write("\n".join(str(v) for v in vals) + "\n")
                logger.info("mean %s = %.4f", key, float(np.mean(vals)))
        if config.eval_only_once:
            break
    if group is not None:
        mesh.barrier(group)
        mesh.shutdown()


def save_panels(out_dir, tag, pred, rendering):
    """color_<tag>.png, and the depth and acc panels of a rendering."""
    from ucnerf_tpu_torch.utils import vis as vis_lib

    vis_lib.save_image_u8(os.path.join(out_dir, f"color_{tag}.png"), pred)
    panels = vis_lib.visualize_suite(rendering)
    for name in ("depth", "acc"):
        if name in panels:
            vis_lib.save_image_u8(
                os.path.join(out_dir, f"{name}_{tag}.png"), panels[name])


def _save_ray_histograms(model, img_batch, camidx, out_dir, idx):
    """Per-level ray histograms of the image's first rays: the model runs on
    them directly, so that the per-level step functions are at hand.  Their
    hex basis is ``step.hex_basis(0, rays)``, the eval step's own for a
    chunk of that size (the JAX package's PRNGKey(0) draw)."""
    import torch

    from ucnerf_tpu_torch.train import step as step_lib
    from ucnerf_tpu_torch.utils import vis as vis_lib

    device = next(model.parameters()).device
    flat = {k: np.asarray(v).reshape((-1,) + np.shape(v)[2:])[:HISTOGRAM_RAYS]
            for k, v in img_batch.items()}
    batch = step_lib.batch_to_device(flat, device)
    rand_vec = step_lib.hex_basis(0, batch["origins"].shape[0]).to(device)
    with torch.no_grad():
        _, ray_history = model(batch, 1.0, rand_vec, compute_extras=False,
                               eval_camidx=camidx)
    host = [{k: v.cpu().numpy() if torch.is_tensor(v) else v
             for k, v in h.items()} for h in ray_history]
    for name, img in vis_lib.visualize_ray_histograms(host).items():
        vis_lib.save_image_u8(os.path.join(out_dir, f"{name}_{idx:03d}.png"),
                              img)


def _eval_camidx(config, test_idx, cam_num):
    """Map a test image to a training-view latent id for the brightness
    correction (the reference's remap (idx//3)*21+idx%3: test group g sits
    before 7 train frame-groups of `cam_num` cams each)."""
    cam_num = max(cam_num, 1)
    group = test_idx // cam_num
    cam = test_idx % cam_num
    return min(group * 7 * cam_num + cam, config.training_views - 1)


if __name__ == "__main__":
    main()

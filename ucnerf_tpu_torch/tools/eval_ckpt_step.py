"""Evaluate ONE checkpoint step on selected test images (port of
``tools/eval_ckpt_step.py``).

``cli.eval`` restores the newest checkpoint, as the JAX CLI does.  To score
an older retained step (keep-N leaves several on disk), for an A/B at a
matched training step, this tool stages the requested step into a scratch
folder where it is the newest, restores it there as ``cli.eval`` does
(``train/checkpoints.restore_model``), renders the requested test views
with ``train/step.render_image`` and prints the JAX tool's line for each:
``step N image i: psnr=... ssim=...``.  ``--device`` is cuda unless the
CPU is asked for; on the card the render runs K4's fused entry,
``take_wsum_cm``, 16 launches a chunk.

Usage:
  python -m ucnerf_tpu_torch.tools.eval_ckpt_step --preset \\
      synthetic_quality --step 3000 --indices 2 \\
      -b "Config.exp_name = 'runs/ab_flagship'"
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np


def main(argv=None):
    from ucnerf_tpu_torch.cli import common

    parser = common.make_parser(__doc__)
    parser.add_argument("--step", type=int, required=True)
    parser.add_argument("--indices", type=int, nargs="+", default=[0])
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)
    device = common.resolve_device(args.device)

    from ucnerf_tpu_torch.cli.eval import _eval_camidx
    from ucnerf_tpu_torch.data import datasets
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.train import step as step_lib
    from ucnerf_tpu_torch.utils import image as image_lib

    src = os.path.join(os.path.abspath(config.exp_name), "checkpoints",
                       str(args.step))
    if not os.path.isdir(src):
        raise SystemExit(f"no checkpoint at step {args.step} under "
                         f"{config.exp_name} (keep-N may have pruned it)")

    test_dataset = datasets.load_dataset("test", config)
    model = step_lib.init_model(config, seed=0, device=device)
    with tempfile.TemporaryDirectory() as scratch:
        # Staged so that the requested step is the newest.
        shutil.copytree(src, os.path.join(scratch, "checkpoints",
                                          str(args.step)))
        step = ckpt_lib.restore_model(scratch, model)
    assert step == args.step, (step, args.step)

    eval_step = step_lib.make_eval_step(model, config)
    harness = image_lib.MetricHarness()
    scores = {}
    for idx in args.indices:
        img_batch = test_dataset.image_batch(idx)
        rendering = step_lib.render_image(
            eval_step, img_batch, config, train_frac=1.0,
            eval_camidx=_eval_camidx(config, idx, test_dataset.cam_num))
        pred = np.clip(rendering["rgb"], 0, 1)
        metrics = harness(pred, img_batch["rgb"],
                          quantize=config.eval_quantize_metrics)
        scores[idx] = metrics
        print(f"step {step} image {idx}: psnr={metrics['psnr']:.3f} "
              f"ssim={metrics['ssim']:.4f}", flush=True)
    return step, scores


if __name__ == "__main__":
    main()

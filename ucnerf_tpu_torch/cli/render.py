"""Render CLI (port of ``ucnerf_tpu/cli/render.py``): novel-view path
renders -> image frames + videos.

Interpolates a camera path from the dataset trajectory
(``data/paths.generate_render_path``), renders color/depth/acc frames with
``train/step.render_image`` (skipping frames that already exist, so a
re-run resumes), and assembles mp4 videos when imageio and an ffmpeg
backend are installed; otherwise it logs that and leaves the frames.

Usage:
  python -m ucnerf_tpu_torch.cli.render --preset waymo \
      -b "Config.exp_name = '...'"
  python -m ucnerf_tpu_torch.cli.render --tiny --device cpu
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def main(argv=None):
    from ucnerf_tpu_torch.cli import common

    parser = common.make_parser(__doc__)
    parser.add_argument(
        "--path-type", default=None,
        choices=["keyframe", "spiral", "ellipse", "spline"],
        help="render trajectory generator (default: Config.render_path_type)")
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)
    if args.path_type is not None:
        config = dataclasses.replace(config, render_path_type=args.path_type)
    exp, logger = common.setup_experiment(config, "render")
    device = common.resolve_device(args.device, logger)

    from ucnerf_tpu_torch.cli.eval import save_panels
    from ucnerf_tpu_torch.data import datasets, paths
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.train import step as step_lib

    dataset = datasets.load_dataset("test", config)
    model = step_lib.init_model(config, seed=0, device=device)
    step = ckpt_lib.restore_model(exp, model)
    logger.info("rendering checkpoint at step %d", step)

    eval_step = step_lib.make_eval_step(model, config)
    path_poses = paths.generate_render_path(config.render_path_type, dataset,
                                            config)
    logger.info("path type %s: %d frames", config.render_path_type,
                len(path_poses))

    out_dir = os.path.join(exp, "render", f"path_renders_step_{step}")
    os.makedirs(out_dir, exist_ok=True)
    zpad = max(3, len(str(len(path_poses) - 1)))

    for idx, pose in enumerate(path_poses):
        idx_str = str(idx).zfill(zpad)
        if os.path.exists(os.path.join(out_dir, f"color_{idx_str}.png")):
            logger.info("frame %d already exists, skipping", idx)
            continue
        rendering = step_lib.render_image(
            eval_step, _pose_image_batch(dataset, pose, config), config,
            train_frac=1.0, eval_camidx=0)
        save_panels(out_dir, idx_str, np.clip(rendering["rgb"], 0, 1),
                    rendering)
        logger.info("rendered frame %d/%d", idx + 1, len(path_poses))

    _write_videos(out_dir, exp, len(path_poses), zpad, config, logger)


def _pose_image_batch(dataset, pose, config):
    """Ray batch for every pixel of a novel pose, with the first view's
    intrinsics."""
    from ucnerf_tpu_torch.data import cameras

    h, w = dataset.height, dataset.width
    batch = cameras.pose_image_batch(dataset.pixtocams[0], pose, w, h,
                                     config.near, config.far)
    batch["lossmult"] = np.ones((h, w, 1), np.float32)
    batch["sky_segs"] = np.zeros((h, w), np.float32)
    batch["rgb"] = np.zeros((h, w, 3), np.float32)
    return batch


def _write_videos(out_dir, exp, num_frames, zpad, config, logger):
    try:
        import imageio
        for tag in ("color", "depth", "acc"):
            f0 = os.path.join(out_dir, f"{tag}_{'0'.zfill(zpad)}.png")
            if not os.path.exists(f0):
                continue
            video_file = os.path.join(exp, "render", f"{tag}.mp4")
            with imageio.get_writer(video_file,
                                    fps=config.render_video_fps) as wr:
                for idx in range(num_frames):
                    p = os.path.join(
                        out_dir, f"{tag}_{str(idx).zfill(zpad)}.png")
                    if os.path.exists(p):
                        wr.append_data(imageio.imread(p))
            logger.info("wrote %s", video_file)
    except Exception as e:  # imageio or its ffmpeg backend may be absent
        logger.info("video assembly skipped (%s); frames are in %s", e,
                    out_dir)


if __name__ == "__main__":
    main()

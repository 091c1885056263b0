"""TSDF-fusion mesh CLI (port of ``ucnerf_tpu/cli/tsdf.py``): render
training-view depths, fuse them, mesh the result.

Renders the depth of every training view with ``train/step.render_image``,
converts it to z-depth, integrates each view into a TSDF voxel grid on the
device (``extraction/tsdf.py``), and meshes the zero level set with vertex
colors (``extraction/meshing.mesh_from_tsdf``).

Usage:
  python -m ucnerf_tpu_torch.cli.tsdf --preset waymo \
      -b "Config.exp_name = '...'"
  python -m ucnerf_tpu_torch.cli.tsdf --tiny --device cpu --resolution 48
"""

from __future__ import annotations

import os

import numpy as np

# Rendered depths at or beyond this are the sky clamp: no surface there.
SKY_DEPTH = 299.0


def z_depth(rendering, img_batch, c2w_cv):
    """The rendering's depth (distance along the unnormalized ray direction)
    as camera z-depth [H, W], 0 where it hit the sky clamp."""
    depth = np.where(rendering["depth"] >= SKY_DEPTH, 0.0,
                     rendering["depth"])
    w2c_r = np.linalg.inv(c2w_cv)[:3, :3]
    return depth * (img_batch["directions"] @ w2c_r.T[:, 2])


def main(argv=None):
    from ucnerf_tpu_torch.cli import common

    parser = common.make_parser(__doc__)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--radius", type=float, default=2.0)
    parser.add_argument("--truncation-margin", type=float, default=5.0)
    parser.add_argument("--max-views", type=int, default=None)
    parser.add_argument("--out", default=None)
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)
    exp, logger = common.setup_experiment(config, "tsdf")
    device = common.resolve_device(args.device, logger)

    import torch

    from ucnerf_tpu_torch.data import datasets, warping
    from ucnerf_tpu_torch.extraction import meshing, tsdf
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.train import step as step_lib

    dataset = datasets.load_dataset("train", config)
    model = step_lib.init_model(config, seed=0, device=device)
    step = ckpt_lib.restore_model(exp, model)
    logger.info("TSDF from checkpoint step %d", step)

    eval_step = step_lib.make_eval_step(model, config)
    grid = tsdf.TSDFGrid.create(args.resolution, args.radius,
                                args.truncation_margin, with_color=True,
                                device=device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)

    n_views = dataset.n_examples
    if args.max_views:
        n_views = min(n_views, args.max_views)
    for idx in range(n_views):
        img_batch = dataset.image_batch(idx)
        rendering = step_lib.render_image(eval_step, img_batch, config,
                                          train_frac=1.0, eval_camidx=idx)
        c2w_cv = dataset.camtoworlds[idx] @ warping.GL_TO_CV
        k = np.linalg.inv(dataset.pixtocams[idx])
        grid = tsdf.integrate(grid, f32(z_depth(rendering, img_batch, c2w_cv)),
                              f32(c2w_cv), f32(k), rgb=f32(rendering["rgb"]))
        logger.info("integrated view %d/%d", idx + 1, n_views)

    verts, faces, colors = meshing.mesh_from_tsdf(grid, min_weight=1.0)
    logger.info("mesh: %d vertices, %d faces", len(verts), len(faces))
    out_path = args.out or os.path.join(exp, f"tsdf_mesh_{step}.ply")
    meshing.write_ply(out_path, verts, faces, colors)
    logger.info("wrote %s", out_path)


if __name__ == "__main__":
    main()

"""The JAX side of the MVS-quality tests, and the like-for-like comparison
of ``tools/mvs_quality.py`` (JAX) with ``ucnerf_tpu_torch.tools.mvs_quality``
from the same initial weights.

``jax_init`` draws the tiny cascade's weights as the JAX ``cli.mvs_train``
draws them (``PRNGKey(0)`` on the first training window), ``export_mvs``
writes a tree through ``tools/export_jax_checkpoint.py --mvs`` (the npz
that ``--init`` of the port's tool reads), and ``jax_pipeline`` is stages
2-4 of the JAX tool, line for line, on a given tree.

``python tests/torch_mvs_quality_fixture.py --steps 600`` (from the
repository root, on the CPU) trains the tiny cascade with the JAX CLI and
with the port's CLI from JAX's initial weights, and prints for each the
loss every 100 steps and the JAX tool's table; then the port's pipeline on
the JAX-trained weights, which parts a difference of the pipelines from a
difference of the training runs.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_init(crop=(64, 96)):
    """The JAX ``cli.mvs_train --tiny`` initial tree ({"params": ...}),
    numpy leaves."""
    import jax
    import jax.numpy as jnp

    from ucnerf_tpu.models.mvs.datasets import SyntheticMVSWindows
    from ucnerf_tpu.models.mvs.raft import RAFTMVS
    from ucnerf_tpu_torch.cli.mvs_train import TINY

    ch, cw = crop
    images, poses, intr, _ = SyntheticMVSWindows(num_views=5).window(0)
    params = RAFTMVS(**TINY).init(jax.random.PRNGKey(0),
                                  jnp.asarray(images[:, :ch, :cw]),
                                  jnp.asarray(poses), jnp.asarray(intr))
    return jax.tree.map(np.asarray, params)


def export_mvs(params, folder, name="mvs"):
    """`params` written as ``cli.mvs_train --out`` writes them, then
    exported to ``folder/<name>.npz``: its path."""
    from flax.serialization import to_bytes

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import export_jax_checkpoint as exporter

    msgpack = os.path.join(folder, f"{name}.msgpack")
    with open(msgpack, "wb") as f:
        f.write(to_bytes(params))
    npz = os.path.join(folder, f"{name}.npz")
    exporter.main(["--mvs", msgpack, "-o", npz])
    return npz


def jax_train(steps, crop, folder):
    """The JAX CLI's tiny training from its own init: (losses, trained
    tree)."""
    from flax.serialization import from_bytes

    from ucnerf_tpu.cli import mvs_train

    out = os.path.join(folder, "trained.msgpack")
    losses = mvs_train.main(["--tiny", "--steps", str(steps), "--crop",
                             *map(str, crop), "--out", out])
    with open(out, "rb") as f:
        trained = from_bytes(jax_init(crop), f.read())
    return losses, trained


def jax_pipeline(params, crop=(64, 96), eval_crop=None, views=5):
    """Stages 2-4 of tools/mvs_quality.py on `params`: ({stage: (mean,
    median, valid share)}, fused point count, {stage: [N, H, W] depths})."""
    import jax
    import jax.numpy as jnp

    from ucnerf_tpu import configs as cfglib
    from ucnerf_tpu.models.mvs.datasets import SyntheticMVSWindows
    from ucnerf_tpu.models.mvs.pipelines import (adaptive_geometric_fusion,
                                                 fused_point_cloud,
                                                 multires_fusion,
                                                 postprocess_disp)
    from ucnerf_tpu.models.mvs.raft import RAFTMVS
    from ucnerf_tpu_torch.cli.mvs_train import TINY

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from mvs_quality import abs_rel

    ch, cw = crop
    ech, ecw = eval_crop or crop
    scene_cfg = cfglib.tiny(synthetic_height=max(ch, ech),
                            synthetic_width=max(cw, ecw))
    win = SyntheticMVSWindows(config=scene_cfg, num_views=views)
    model = RAFTMVS(**TINY)
    run = jax.jit(lambda p, im, po, k, s: model.apply(p, im, po, k, scale=s))

    per_view, fused_depths = [], []
    for index in range(len(win)):
        images, poses, intr, scale = win.window(index)
        images = images[:, :ech, :ecw]
        pass_depths = []
        for rescale in (0.5, 1.0):
            if rescale != 1.0:
                h = int(ech * rescale) // 8 * 8
                w = int(ecw * rescale) // 8 * 8
                imgs = np.asarray(jax.image.resize(
                    jnp.asarray(images), (images.shape[0], h, w, 3),
                    "bilinear"))
                k = intr.copy()
                k[:, 0] *= w / ecw
                k[:, 1] *= h / ech
            else:
                imgs, k = images, intr
            disp = run(params, jnp.asarray(imgs), jnp.asarray(poses),
                       jnp.asarray(k), jnp.float32(scale))
            depth = np.asarray(postprocess_disp(disp))
            if depth.shape != (ech, ecw):
                depth = np.asarray(jax.image.resize(
                    jnp.asarray(depth), (ech, ecw), "nearest"))
            pass_depths.append(depth)
        per_view.append(pass_depths[-1])
        fused_depths.append(multires_fusion(pass_depths[0], pass_depths[-1]))

    gts = np.stack([win.depths[i][:ech, :ecw] for i in range(len(win))])
    n = len(win)
    pairs = [(i, [(i - 1) % n, (i + 1) % n]) for i in range(n)]
    results = adaptive_geometric_fusion(
        np.stack(fused_depths), win.poses[:n], win.intrinsics[:n], pairs,
        glb=0.25)
    masked = np.stack([np.where(results[i][0], results[i][1], 0.0)
                       for i in range(n)])
    xyz, _ = fused_point_cloud(results, win.images[:n] / 255.0,
                               win.poses[:n], win.intrinsics[:n])
    depths = {"per-view": np.stack(per_view),
              "multires": np.stack(fused_depths), "geo-fused": masked}
    return ({s: abs_rel(d, gts) for s, d in depths.items()}, len(xyz),
            depths)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--crop", type=int, nargs=2, default=(64, 96))
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from ucnerf_tpu_torch.cli import mvs_train as port_train
    from ucnerf_tpu_torch.tools import mvs_quality

    crop = tuple(args.crop)
    with tempfile.TemporaryDirectory() as tmp:
        init = export_mvs(jax_init(crop), tmp, "init")
        jax_losses, trained = jax_train(args.steps, crop, tmp)
        trained_npz = export_mvs(trained, tmp, "trained")
        scores = {"JAX init": jax_pipeline(jax_init(crop), crop)[:2],
                  "JAX trained": jax_pipeline(trained, crop)[:2]}
        port = mvs_quality.main(["--steps", str(args.steps), "--crop",
                                 *map(str, crop), "--init", init,
                                 "--device", "cpu"])
        scores["port init"] = port["scores"]["random-init"]
        scores["port trained"] = port["scores"]["TRAINED"]
        model = port_train.build_model(True, init=trained_npz).eval()
        scores["port pipe on JAX trained"] = mvs_quality.pipeline(
            model, mvs_quality.eval_windows(crop, crop, 5), crop, "cpu")[:2]
    print(f"\nloss every 100 steps from the same initial weights "
          f"({args.steps} steps, crop {crop}):")
    for i in list(range(0, args.steps, 100)) + [args.steps - 1]:
        a, b = jax_losses[i], port["losses"][i]
        print(f"  step {i:4d}: JAX {a:.5f}  port {b:.5f}  "
              f"rel {abs(a - b) / abs(a):.2e}")
    print()
    print("\n".join(mvs_quality.table_lines(scores)))


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()

"""MVS training CLI: RAFT-MVS with the gamma-decayed sequence loss (port of
``ucnerf_tpu/cli/mvs_train.py``).

The reference's MVS trainer (``mvs/train.py:37-141``): per-window forward
through the cascade collecting per-iteration disparity predictions, sequence
loss against ground-truth inverse depth (loss.py:5-41), Adam with gradient
clipping (optax's ``chain(clip_by_global_norm(1.0), adam(lr))``, in its
order).  The reference trains on BlendedMVS; without that dataset this
trains on the synthetic scene's exact analytic depths
(``models/mvs/datasets.SyntheticMVSWindows``), cropped.  cuDNN runs its
deterministic algorithms, so a step repeats bit for bit.

Usage:
  python -m ucnerf_tpu_torch.cli.mvs_train --steps 200 --out mvs.pt \
      [--tiny] [--device cpu] [--seed N | --init mvs.npz]

``--out`` writes a ``torch.save`` file: the model's ``state_dict`` and the
flags that built it (``cli.mvs_depth --ckpt`` reads it).  The weights are
drawn from ``--seed``, or start from ``--init``, an MVS export of
``tools/export_jax_checkpoint.py --mvs`` (the JAX CLI's initial weights,
say, so that both packages train from the same point).  A JAX CLI's
flax msgpack file reaches ``cli.mvs_depth`` through
``tools/export_jax_checkpoint.py --mvs``.
"""

from __future__ import annotations

import argparse
import logging
import time

# The --tiny cascade: 2 stages of 2 iterations, 16-channel maps, 2 levels.
TINY = dict(cascade=((8, 64, 2), (-1, 320, 2)), dim_fmap=16, dim_net=16,
            dim_inp=16, num_levels=2, radius=2)


def build_model(tiny: bool, seed: int = 0, init=None):
    """RAFTMVS at full width, or the --tiny cascade, drawn from `seed`, or
    loaded strictly from the MVS export at `init` when given."""
    from ucnerf_tpu_torch.models.mvs.raft import RAFTMVS

    model = RAFTMVS(**(TINY if tiny else {}), seed=seed)
    if init is not None:
        from ucnerf_tpu_torch import convert

        model.load_state_dict(convert.mvs_params_from_export(
            convert.load_export(init, "mvs")), strict=True)
    return model


def crop_batch(win, idx, crop, device):
    """Training batch `idx` on `device`: the window of view idx % len(win)
    cropped to `crop` (H, W) from the top left, and its ground-truth
    inverse depth (0 where the scene has no depth)."""
    import numpy as np
    import torch

    ch, cw = crop
    images, poses, intr, _ = win.window(idx % len(win))
    images = images[:, :ch, :cw]
    gt_depth = win.depths[idx % len(win)][:ch, :cw]
    gt_disp = np.where(gt_depth > 0, 1.0 / np.maximum(gt_depth, 1e-6), 0.0)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (images, poses, intr, gt_disp))


def make_train_step(model, lr: float, gradual_weight: float):
    """(train_step, adam): ``train_step(images, poses, intr, gt_disp)``
    takes one step of the sequence loss on `model` and returns (loss,
    metrics).  The gradients are clipped to a global norm of 1.0 as optax
    does, then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root)
    updates the parameters."""
    import torch

    from ucnerf_tpu_torch.models.mvs.pipelines import sequence_loss
    from ucnerf_tpu_torch.train.state import clip_by_global_norm_

    params = list(model.parameters())
    adam = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def train_step(images, poses, intr, gt_disp):
        adam.zero_grad(set_to_none=False)
        _, preds = model(images, poses, intr, return_predictions=True)
        loss, metrics = sequence_loss(preds, gt_disp,
                                      gradual_weight=gradual_weight)
        loss.backward()
        clip_by_global_norm_([p.grad for p in params], 1.0)
        adam.step()
        return loss.detach(), metrics

    return train_step, adam


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--gradual-weight", type=float, default=0.5)
    parser.add_argument("--crop", type=int, nargs=2, default=(64, 96))
    parser.add_argument("--out", default=None)
    parser.add_argument("--tiny", action="store_true")
    init = parser.add_mutually_exclusive_group()
    init.add_argument("--seed", type=int, default=0,
                      help="seed of the initial weights")
    init.add_argument("--init", default=None,
                      help="initial weights: an MVS export (.npz) of "
                           "tools/export_jax_checkpoint.py --mvs")
    from ucnerf_tpu_torch.cli import common

    common.add_device_arg(parser)
    args = parser.parse_args(argv)

    import torch

    from ucnerf_tpu_torch.models.mvs.datasets import SyntheticMVSWindows

    device = common.resolve_device(args.device,
                                   logging.getLogger("ucnerf_tpu_torch"))
    model = build_model(args.tiny, args.seed, args.init).to(device)
    win = SyntheticMVSWindows(num_views=5)
    train_step, _ = make_train_step(model, args.lr, args.gradual_weight)
    t0 = time.time()
    losses = []
    with common.deterministic_cudnn():
        for step in range(args.steps):
            loss, metrics = train_step(*crop_batch(win, step, args.crop,
                                                   device))
            losses.append(float(loss))
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step}: loss={float(loss):.5f} "
                      f"mde={float(metrics['mean_depth_error']):.4f} "
                      f"({time.time() - t0:.1f}s)", flush=True)

    if args.out:
        torch.save({"state_dict": {k: v.detach().cpu() for k, v in
                                   model.state_dict().items()},
                    "flags": vars(args)}, args.out)
        print(f"wrote {args.out}")
    return losses


if __name__ == "__main__":
    main()

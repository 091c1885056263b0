"""MVS depth CLI: per-view depth estimation + multires/geometric fusion
(port of ``ucnerf_tpu/cli/mvs_depth.py``).

The reference's MVS orchestration (``mvs/demo_custom.py:13-69``): run the
RAFT-MVS cascade over every reference view's temporal window at multiple
rescales, post-process (inference.py:52-58), fuse across resolutions
(multires.py:16-40), and write the per-view ``.npy`` depth maps the NeRF
trainer consumes (nerf/internal/datasets.py:950).

Checkpoint: a ``torch.save`` file written by ``cli.mvs_train --out``, or
(``.npz``) the export of a JAX ``cli.mvs_train --out`` msgpack file that
``tools/export_jax_checkpoint.py --mvs`` writes; either loads strictly into
the full-width model.  The reference ships train_BlendedMVS.pth as a
missing blob, so without ``--ckpt`` the model is a random init from seed 0.

Usage:
  python -m ucnerf_tpu_torch.cli.mvs_depth --data-dir /path/segment \
      --pose-json /path/pose.json --output /path/depths \
      [--ckpt mvs.pt | --ckpt mvs.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's flags; ``num_frames`` comes back paired 1:1 with
    ``rescales``."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--pose-json", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--num-cams", type=int, default=3)
    parser.add_argument("--rescales", type=float, nargs="+",
                        default=[0.5, 1.0])
    parser.add_argument("--num-frames", type=int, nargs="+", default=None,
                        help="temporal source count per pass, paired with "
                             "--rescales (reference demo runs (0.5, 6), "
                             "(1, 8), (2, 10); demo_custom.py:33-44). "
                             "Defaults to 6 for every pass.")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--encoder-type", default="HR")
    parser.add_argument("--fuse", action="store_true",
                        help="adaptive-threshold geometric fusion across "
                             "views: masked depths + fused result.ply "
                             "(fusion.py:109-342)")
    parser.add_argument("--fuse-glb", type=float, default=0.25,
                        help="target surviving-pixel fraction for the "
                             "adaptive threshold search")
    from ucnerf_tpu_torch.cli import common

    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    args.num_frames = args.num_frames or [6] * len(args.rescales)
    if len(args.num_frames) != len(args.rescales):
        parser.error("--num-frames must pair 1:1 with --rescales")
    if len(set(zip(args.rescales, args.num_frames))) != len(args.rescales):
        parser.error("duplicate (rescale, num-frames) pass: each pass must "
                     "be distinct or it would fuse with itself")
    return args


def load_model(ckpt, encoder_type, device):
    """RAFTMVS from a ``cli.mvs_train --out`` file or a JAX MVS export
    (``.npz``), else drawn from seed 0, on `device` in eval mode."""
    import torch

    from ucnerf_tpu_torch import convert
    from ucnerf_tpu_torch.models.mvs.raft import RAFTMVS

    model = RAFTMVS(encoder_type=encoder_type, seed=0)
    if ckpt is not None and str(ckpt).endswith(".npz"):
        model.load_state_dict(convert.mvs_params_from_export(
            convert.load_export(ckpt, "mvs")), strict=True)
    elif ckpt is not None:
        state = torch.load(ckpt, map_location="cpu", weights_only=True)
        model.load_state_dict(state["state_dict"])
    return model.to(device).eval()


def rescaled(images, intr, rescale):
    """A pass's input: images [V, H, W, 3] (a tensor) resized by `rescale`
    to multiples of 8 (antialiased bilinear, as ``jax.image.resize``) and
    the intrinsics [V, 3, 3] scaled to match."""
    from ucnerf_tpu_torch.models.mvs.pipelines import resize

    k = intr.copy()
    if rescale == 1.0:
        return images, k
    v, ht, wd, _ = images.shape
    h = int(ht * rescale) // 8 * 8
    w = int(wd * rescale) // 8 * 8
    k[:, 0] *= w / wd
    k[:, 1] *= h / ht
    return resize(images, (v, h, w, 3), "bilinear"), k


def run(args, windows, device):
    """The per-window loop over `windows` (num_frames -> windows: an object
    with ``__len__`` whose ``__getitem__(index)`` returns (images [V, H, W,
    3] uint8-range floats, world-to-cam poses [V, 4, 4], intrinsics [V, 3,
    3], names, scale) for reference view `index`, view 0 first).  Writes
    the ``.npy`` depth maps, and with ``args.fuse`` the masks and
    ``result.ply``.  Returns the per-view seconds as (name, rescale,
    seconds) and the fused point count (None without ``--fuse``)."""
    import torch

    from ucnerf_tpu_torch.cli import common
    from ucnerf_tpu_torch.extraction.meshing import write_ply
    from ucnerf_tpu_torch.models.mvs.pipelines import (
        adaptive_geometric_fusion, fused_point_cloud, multires_fusion,
        postprocess_disp, resize)

    ds = windows[args.num_frames[-1]]  # final pass drives fusion bookkeeping
    os.makedirs(args.output, exist_ok=True)
    model = load_model(args.ckpt, args.encoder_type, device)

    def to_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n = len(ds) if args.limit is None else min(len(ds), args.limit)
    # Per-ref-view records for optional cross-view fusion.
    ref_imgs, ref_poses, ref_ks, ref_depths = [], [], [], []
    name_to_index, pair_names, view_seconds = {}, [], []
    with torch.no_grad(), common.deterministic_cudnn():
        for index in range(n):
            # Keyed by pass index: duplicate rescale values (e.g. two passes
            # at 1.0 with different --num-frames) must stay distinct passes.
            pass_depths = []
            for rescale, nf in zip(args.rescales, args.num_frames):
                images, poses, intr, names, scale = windows[nf][index]
                imgs, k = rescaled(to_device(images), intr, rescale)
                t0 = time.time()
                disp = model(imgs, to_device(poses), to_device(k),
                             scale=scale)
                depth = postprocess_disp(disp)
                # RAFT predicts at 1/4 ("HR") or 1/8 feature resolution
                # (raft.py:49-52); the NeRF loader consumes depth at image
                # resolution without resizing (datasets.py:1066-1073, the
                # resize is commented out upstream — their npy files were
                # pre-upsampled offline).  Emit loader-ready files directly.
                full_hw = (images.shape[1], images.shape[2])
                if tuple(depth.shape) != full_hw:
                    depth = resize(depth, full_hw, "nearest")
                depth = depth.cpu().numpy()
                secs = time.time() - t0
                print(f"{names[0]} rescale={rescale}: per view time "
                      f"{secs:.2f}s", flush=True)
                view_seconds.append((names[0], rescale, secs))
                pass_depths.append(depth)

            if len(pass_depths) >= 2:
                fused = multires_fusion(pass_depths[0], pass_depths[-1])
            else:
                fused = pass_depths[0]
            np.save(os.path.join(args.output, f"{names[0]}.npy"),
                    fused.astype(np.float32))
            if args.fuse:
                name_to_index[names[0]] = index
                pair_names.append((names[0], list(names[1:])))
                ref_imgs.append(np.asarray(images[0]) / 255.0)
                ref_poses.append(np.asarray(poses[0]))
                ref_ks.append(np.asarray(intr[0]))
                ref_depths.append(np.asarray(fused, np.float32))
    print(f"wrote {n} depth maps to {args.output}")
    if not args.fuse:
        return view_seconds, None

    pairs = [(name_to_index[r], [name_to_index[s] for s in srcs
                                 if s in name_to_index])
             for r, srcs in pair_names]
    pairs = [(r, s) for r, s in pairs if s]
    results = adaptive_geometric_fusion(
        torch.from_numpy(np.stack(ref_depths)).to(device),
        np.stack(ref_poses), np.stack(ref_ks), pairs, glb=args.fuse_glb,
        log_fn=print)
    os.makedirs(os.path.join(args.output, "mask"), exist_ok=True)
    idx_to_name = {v: k for k, v in name_to_index.items()}
    for ref, (mask, fused_d, _) in sorted(results.items()):
        name = idx_to_name[ref]
        masked = np.where(mask, fused_d, 0.0).astype(np.float32)
        np.save(os.path.join(args.output, f"{name}.npy"), masked)
        np.save(os.path.join(args.output, "mask", f"{name}.npy"), mask)
    xyz, rgb = fused_point_cloud(results, np.stack(ref_imgs),
                                 np.stack(ref_poses), np.stack(ref_ks))
    ply_path = os.path.join(args.output, "result.ply")
    write_ply(ply_path, xyz, np.zeros((0, 3), np.int32), colors=rgb)
    print(f"fused point cloud: {len(xyz)} points -> {ply_path}")
    return view_seconds, len(xyz)


def main(argv=None):
    args = parse_args(argv)
    from ucnerf_tpu_torch.cli import common
    from ucnerf_tpu_torch.models.mvs.datasets import WaymoMVSWindows

    device = common.resolve_device(args.device,
                                   logging.getLogger("ucnerf_tpu_torch"))
    windows = {nf: WaymoMVSWindows(args.data_dir, args.pose_json,
                                   num_cams=args.num_cams, num_frames=nf)
               for nf in sorted(set(args.num_frames))}
    run(args, windows, device)


if __name__ == "__main__":
    main()

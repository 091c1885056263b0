"""Mesh extraction CLI (port of ``ucnerf_tpu/cli/extract.py``): density
isosurface -> colored PLY.

Samples the NeRF field's density on a dense grid in CONTRACTED space (better
far-field coverage), meshes the isosurface with surface nets, maps the
vertices back to world space with the inverse contraction, clips them to a
world radius, and bakes vertex colors by querying the field's
view-dependent color with the downward axis as view direction.

The field is queried in chunks of ``POINT_CHUNK`` points.  (The JAX CLI
takes ``(1 << 18) // res`` x-slices a call, which for any resolution up to
512 is the whole volume in one call: at 256^3, 16.8 M points, whose corner
indices alone would take 6.4 GB a level.  Every point is computed on its
own, so the chunking changes the volume only by the rounding of the
field's matmuls, which block by the number of points.)

Usage:
  python -m ucnerf_tpu_torch.cli.extract --preset waymo \
      -b "Config.exp_name = '...'"
  python -m ucnerf_tpu_torch.cli.extract --tiny --device cpu --resolution 48
"""

from __future__ import annotations

import os

import numpy as np
import torch

# Points of one field query: 2^20 points are 6.3 M hash-grid lookups a
# level, ~0.5 GB of corner indices and weights.
POINT_CHUNK = 1 << 20
# Multisample std of every query point, and the view direction of the
# vertex colors (downward).
QUERY_STD = 1e-3
VIEW_DIR = (0.0, -1.0, 0.0)


def _field_inputs(pts_world):
    """Extract's field inputs for points [N, 3]: all 6 hex means at the
    point, means [3, 6, N, 1] and stds [6, N, 1]."""
    n = pts_world.shape[0]
    means = pts_world.T[:, None, :, None].expand(3, 6, n, 1)
    stds = torch.full((6, n, 1), QUERY_STD, dtype=torch.float32,
                      device=pts_world.device)
    return means, stds


@torch.no_grad()
def density_of_world(model, pts_world):
    """Density of the NeRF field at world points [N, 3] -> [N]."""
    mlp = model.nerf_mlp
    raw, _, _ = mlp.predict_density(*_field_inputs(pts_world))
    return torch.nn.functional.softplus(raw + mlp.config.density_bias)[:, 0]


@torch.no_grad()
def color_of_world(model, pts_world):
    """The NeRF field's color at world points [N, 3], seen along VIEW_DIR
    -> [N, 3]."""
    viewdirs = torch.tensor(VIEW_DIR, dtype=torch.float32,
                            device=pts_world.device).expand(
                                pts_world.shape[0], 3)
    out = model.nerf_mlp(*_field_inputs(pts_world), viewdirs=viewdirs)
    return out["rgb"][:, :, 0].T


def grid_axis(res, r_c):
    """Cell-centre coordinates of one axis of the [-r_c, r_c]^3 grid."""
    return (np.arange(res) + 0.5) / res * 2 * r_c - r_c


def grid_points(lin, i0, i1, device):
    """Contracted-space points i0..i1-1 of the grid (x slowest, z fastest)
    as float32 [i1 - i0, 3] on `device`."""
    res = len(lin)
    axis = torch.from_numpy(lin.astype(np.float32)).to(device)
    i = torch.arange(i0, i1, device=device)
    return torch.stack([axis[i // (res * res)], axis[(i // res) % res],
                        axis[i % res]], dim=1)


def density_volume(model, res, r_c, chunk=POINT_CHUNK):
    """The field's density at every cell centre of the contracted grid
    [-r_c, r_c]^3, as a float32 numpy [res, res, res]."""
    from ucnerf_tpu_torch.ops import coord

    device = next(model.parameters()).device
    lin = grid_axis(res, r_c)
    vol = np.empty(res**3, np.float32)
    for i0 in range(0, res**3, chunk):
        i1 = min(i0 + chunk, res**3)
        pts_w = coord.inv_contract(grid_points(lin, i0, i1, device))
        vol[i0:i1] = density_of_world(model, pts_w).cpu().numpy()
    return vol.reshape(res, res, res)


def mesh_of_volume(vol, iso_density, r_c, max_world_radius, device):
    """Surface nets on the density's iso level, the vertices taken to world
    space and clipped to `max_world_radius`: (verts_w [V, 3], faces
    [F, 3] int32), both numpy."""
    from ucnerf_tpu_torch.extraction import meshing
    from ucnerf_tpu_torch.ops import coord

    res = vol.shape[0]
    verts_c, faces = meshing.surface_nets(
        -(vol - iso_density),  # negative inside (density > iso)
        origin=(-r_c + r_c / res,) * 3, voxel_size=2 * r_c / res)
    if len(verts_c) == 0:
        return verts_c, faces
    verts_w = coord.inv_contract(
        torch.from_numpy(verts_c).to(device)).cpu().numpy()
    keep = np.linalg.norm(verts_w, axis=-1) < max_world_radius
    remap = -np.ones(len(verts_w), np.int64)
    remap[keep] = np.arange(keep.sum())
    faces = faces[keep[faces].all(axis=1)]
    return verts_w[keep], remap[faces].astype(np.int32)


def vertex_colors(model, verts_w, chunk=POINT_CHUNK):
    device = next(model.parameters()).device
    colors = np.empty((len(verts_w), 3), np.float32)
    for i0 in range(0, len(verts_w), chunk):
        pts = torch.from_numpy(verts_w[i0:i0 + chunk]).to(device)
        colors[i0:i0 + chunk] = color_of_world(model, pts).cpu().numpy()
    return colors


def main(argv=None):
    from ucnerf_tpu_torch.cli import common

    parser = common.make_parser(__doc__)
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--iso-density", type=float, default=20.0,
                        help="density isosurface level "
                             "(Config.isosurface_threshold in the ref)")
    parser.add_argument("--mesh-radius", type=float, default=1.0,
                        help="half-extent in contracted space (x2 = full)")
    parser.add_argument("--max-world-radius", type=float, default=10.0)
    parser.add_argument("--out", default=None)
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)
    exp, logger = common.setup_experiment(config, "extract")
    device = common.resolve_device(args.device, logger)

    from ucnerf_tpu_torch.extraction import meshing
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.train import step as step_lib

    model = step_lib.init_model(config, seed=0, device=device)
    step = ckpt_lib.restore_model(exp, model)
    logger.info("extracting from checkpoint step %d", step)

    res = args.resolution
    r_c = args.mesh_radius * 2.0  # contracted-space half extent
    logger.info("sampling %d^3 grid in contracted space", res)
    vol = density_volume(model, res, r_c)
    logger.info("density range: %.3f .. %.3f", vol.min(), vol.max())
    verts_w, faces = mesh_of_volume(vol, args.iso_density, r_c,
                                    args.max_world_radius, device)
    logger.info("mesh: %d vertices, %d faces", len(verts_w), len(faces))
    if len(verts_w) == 0:
        logger.info("empty mesh; nothing to write")
        return

    colors = vertex_colors(model, verts_w)
    out_path = args.out or os.path.join(exp, f"mesh_{step}.ply")
    meshing.write_ply(out_path, verts_w, faces, colors)
    logger.info("wrote %s", out_path)


if __name__ == "__main__":
    main()

"""Mesh extraction in the port against the JAX package: the copied surface
nets and PLY writer (``ucnerf_tpu_torch/extraction/meshing.py``), the torch
TSDF fusion (``extraction/tsdf.py``), the point contraction and its inverse
(``ops/coord.py``), and the field queries of the extract CLI
(``ZipMLP.predict_density`` and the field's color at extract's inputs).

Tolerances:
- meshing: bitwise (the same numpy on the same inputs);
- ``contract`` / ``inv_contract``: rtol 1e-6, atol 1e-7 (a few f32 ops);
- TSDF fusion: weights bitwise and tsdf / color within atol 1e-5 on all
  but at most ``TSDF_FLIPS`` voxels of the 32^3 grid.  A voxel projects to
  its nearest pixel with a round-half-to-even on both sides, but the
  projection (a 3x3 inverse and two small matmuls in f32) differs by an
  ulp or so between the libraries, and a voxel whose pixel coordinate
  lies within that of a .5 tie may read the neighbouring pixel's depth;
- the extract field queries: rtol 1e-4, atol 1e-5, the JAX field reaching
  its Pallas gather in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.extraction import meshing as jmeshing
from ucnerf_tpu.extraction import tsdf as jtsdf
from ucnerf_tpu.ops import coord as jcoord
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu.train import step as jstep
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.cli import extract as textract
from ucnerf_tpu_torch.extraction import meshing as tmeshing
from ucnerf_tpu_torch.extraction import tsdf as ttsdf
from ucnerf_tpu_torch.ops import coord as tcoord
from ucnerf_tpu_torch.train import step as tstep

torch.set_num_threads(2)

TSDF_ATOL = 1e-5
TSDF_FLIPS = 8
FIELD_TOL = dict(rtol=1e-4, atol=1e-5)


def _sphere_sdf(n=32, r=0.6):
    idx = (np.arange(n) + 0.5) / n * 2 - 1
    x, y, z = np.meshgrid(idx, idx, idx, indexing="ij")
    return np.sqrt(x**2 + y**2 + z**2) - r


@pytest.mark.parametrize("case", ["plain", "level", "mask", "empty"])
def test_surface_nets_matches_jax_package(rng, case):
    n = 24
    sdf = _sphere_sdf(n) + rng.normal(0, 0.01, (n, n, n))
    kw = dict(origin=(-1 + 1 / n,) * 3, voxel_size=2 / n)
    if case == "level":
        kw["level"] = 0.1
    elif case == "mask":
        kw["mask"] = rng.uniform(0, 1, sdf.shape) > 0.1
    elif case == "empty":
        sdf = np.abs(sdf) + 1.0
    got = tmeshing.surface_nets(sdf, **kw)
    want = jmeshing.surface_nets(sdf, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert (len(got[0]) > 100) == (case != "empty")


@pytest.mark.parametrize("with_colors", [True, False])
def test_write_ply_is_bytewise_the_jax_packages(rng, tmp_path, with_colors):
    verts, faces = tmeshing.surface_nets(_sphere_sdf(12), voxel_size=0.1)
    colors = (rng.uniform(-0.1, 1.1, verts.shape).astype(np.float32)
              if with_colors else None)
    tmeshing.write_ply(tmp_path / "port.ply", verts, faces, colors)
    jmeshing.write_ply(tmp_path / "jax.ply", verts, faces, colors)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()


@pytest.mark.parametrize("fn", ["contract", "inv_contract"])
def test_contract_matches_jax_package(rng, fn):
    x = np.concatenate([rng.normal(0, 0.4, (200, 3)),
                        rng.normal(0, 30, (200, 3)),
                        rng.uniform(-1.99, 1.99, (200, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    if fn == "inv_contract":  # inside the radius-2 ball
        x = x / np.maximum(1.0, np.linalg.norm(x, axis=-1,
                                               keepdims=True) / 1.99)
    got = getattr(tcoord, fn)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jcoord, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    back = {"contract": tcoord.inv_contract,
            "inv_contract": tcoord.contract}[fn](torch.from_numpy(got))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-3, atol=1e-5)


def _sphere_views(n_views=6, h=24, w=32, f=30.0, r_sph=0.5):
    """Analytic z-depth maps of a sphere from OpenCV cameras on a ring,
    with a smooth color."""
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    views = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.array([2 * np.sin(ang), 0.3, 2 * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross([0, 1, 0], fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, pos
        y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        dirs = np.stack([(x + 0.5 - w / 2) / f, (y + 0.5 - h / 2) / f,
                         np.ones_like(x, np.float64)], -1) @ c2w[:3, :3].T
        dn = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
        b = 2 * (dn @ pos)
        disc = b**2 - 4 * (pos @ pos - r_sph**2)
        t_hit = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / 2,
                         0.0)
        depth = np.where(t_hit > 0, t_hit * (dn @ fwd), 0.0)
        rgb = np.clip(0.5 + 0.5 * dn, 0, 1)
        views.append(tuple(a.astype(np.float32) for a in (depth, c2w, k, rgb)))
    return views


def test_tsdf_integrate_matches_jax_package():
    res = 32
    grid_t = ttsdf.TSDFGrid.create(res, 1.0, truncation_margin=3.0,
                                   device="cpu")
    grid_j = jtsdf.TSDFGrid.create(res, 1.0, truncation_margin=3.0)
    assert grid_t.truncation == grid_j.truncation
    np.testing.assert_array_equal(grid_t.voxel_centers().numpy(),
                                  np.asarray(grid_j.voxel_centers()))
    for depth, c2w, k, rgb in _sphere_views():
        grid_t = ttsdf.integrate(grid_t, *(torch.from_numpy(a) for a in
                                           (depth, c2w, k)),
                                 rgb=torch.from_numpy(rgb))
        grid_j = jtsdf.integrate_jit(grid_j, *(jnp.asarray(a) for a in
                                               (depth, c2w, k)),
                                     rgb=jnp.asarray(rgb))
    weight = np.asarray(grid_j.weight)
    assert weight.max() >= 3  # several views fused into the same voxels
    np.testing.assert_array_equal(grid_t.weight.numpy(), weight)
    for name in ("tsdf", "color"):
        got = getattr(grid_t, name).numpy()
        want = np.asarray(getattr(grid_j, name))
        off = np.abs(got - want) > TSDF_ATOL
        if name == "color":
            off = off.any(axis=-1)
        assert off.sum() <= TSDF_FLIPS, (name, int(off.sum()))
    # Both fused grids mesh to the sphere.
    verts, faces, colors = tmeshing.mesh_from_tsdf(grid_t, min_weight=1.0)
    assert len(faces) > 100 and colors.shape == verts.shape
    np.testing.assert_allclose(np.median(np.linalg.norm(verts, axis=-1)),
                               0.5, atol=0.08)


def test_mesh_from_tsdf_matches_jax_package(rng):
    """The same grid arrays, as tensors and as jax arrays: bitwise."""
    res = 16
    tsdf = rng.uniform(-1, 1, (res,) * 3).astype(np.float32)
    weight = rng.integers(0, 3, (res,) * 3).astype(np.float32)
    color = rng.uniform(0, 1, (res,) * 3 + (3,)).astype(np.float32)
    grid_t = dataclasses.replace(
        ttsdf.TSDFGrid.create(res, 1.5, device="cpu"),
        tsdf=torch.from_numpy(tsdf), weight=torch.from_numpy(weight),
        color=torch.from_numpy(color))
    grid_j = jtsdf.TSDFGrid.create(res, 1.5).replace(
        tsdf=jnp.asarray(tsdf), weight=jnp.asarray(weight),
        color=jnp.asarray(color))
    got = tmeshing.mesh_from_tsdf(grid_t, min_weight=1.0)
    want = jmeshing.mesh_from_tsdf(grid_j, min_weight=1.0)
    assert len(got[1]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _jax_field(model, params, pts, what):
    """The JAX extract CLI's density / color queries (cli/extract.py)."""
    n = pts.shape[0]
    means = jnp.broadcast_to(jnp.asarray(pts.T, jnp.float32)[:, None, :,
                                                               None],
                             (3, 6, n, 1))
    stds = jnp.full((6, n, 1), 1e-3)
    if what == "density":
        def run(mdl, mn, sd):
            raw, _, _ = mdl.nerf_mlp.predict_density(mn, sd)
            return jax.nn.softplus(raw + mdl.nerf_mlp.config.density_bias)
        return np.asarray(model.apply({"params": params}, means, stds,
                                      method=run))[:, 0]
    viewdirs = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))

    def run(mdl, mn, sd, vd):
        return mdl.nerf_mlp(None, mn, sd, viewdirs=vd)["rgb"][:, :, 0].T
    return np.asarray(model.apply({"params": params}, means, stds, viewdirs,
                                  method=run))


def test_extract_field_queries_match_jax_package(rng, monkeypatch):
    monkeypatch.setattr(jhash, "GATHER_IMPL", "pallas_interpret")
    cfg_j, cfg_t = jconfigs.tiny(), tconfigs.tiny()
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))

    def fill(path, x):  # tables of scale 0.5, so the field varies
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        x = np.asarray(x)
        if name.endswith("table"):
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        return x
    params = jax.tree_util.tree_map_with_path(fill, params)
    model_t = tstep.init_model(cfg_t, seed=0, device="cpu")
    model_t.load_state_dict(
        convert.params_from_jax(jax.tree.map(np.asarray, params)),
        strict=True)

    # Extract's grid points (a 12^3 lattice of the contracted [-2, 2]^3
    # box, as the CLI takes them to world space) and points near the
    # origin, where the vertices lie.
    lin = textract.grid_axis(12, 2.0)
    pts_c = textract.grid_points(lin, 0, 12**3, "cpu")
    pts = torch.cat([tcoord.inv_contract(pts_c),
                     torch.from_numpy(rng.normal(0, 0.5, (200, 3))
                                      .astype(np.float32))])
    np.testing.assert_array_equal(
        pts_c.numpy(), np.stack(np.meshgrid(lin, lin, lin, indexing="ij"),
                                -1).reshape(-1, 3).astype(np.float32))
    dens = textract.density_of_world(model_t, pts).numpy()
    cols = textract.color_of_world(model_t, pts).numpy()
    assert dens.shape == (len(pts),) and cols.shape == (len(pts), 3)
    np.testing.assert_allclose(dens, _jax_field(model_j, params, pts.numpy(),
                                                "density"), **FIELD_TOL)
    np.testing.assert_allclose(cols, _jax_field(model_j, params, pts.numpy(),
                                                "color"), **FIELD_TOL)
    assert np.ptp(dens) > 0.05 and np.ptp(cols) > 0.05
    # predict_density is forward's density before the bias and softplus.
    means, stds = textract._field_inputs(pts)
    raw, x, means_c = model_t.nerf_mlp.predict_density(means, stds)
    out = model_t.nerf_mlp(means, stds, viewdirs=torch.zeros(len(pts), 3))
    torch.testing.assert_close(
        torch.nn.functional.softplus(raw + cfg_t.nerf_mlp.density_bias),
        out["density"], rtol=0, atol=0)
    torch.testing.assert_close(means_c, out["coord"], rtol=0, atol=0)
    assert x.shape == (cfg_t.nerf_mlp.bottleneck_width, len(pts))

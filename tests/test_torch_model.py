"""The port's render path as a whole (``make_eval_step`` + ``render_image``
of ``ucnerf_tpu_torch``) against the JAX package's eval step, on the same
parameters carried across by ``convert.params_from_jax``.

The JAX side runs with ``key=None``, so its hex basis comes from
``jax.random.normal(PRNGKey(0), (rays, 3))`` per (sub-)chunk; the test draws
that vector here and hands it to the port.  JAX runs its default gather
(``tests/test_gather.py`` ties it to the Pallas gather).

Tolerance rtol 1e-4, atol 1e-5 in f32: the same formulas in another
summation order, carried through two sampling levels, the sky NeRF and the
color correction (measured agreement is ~1e-6).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.train import step as jstep
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.data import cameras as tcameras
from ucnerf_tpu_torch.train import step as tstep

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)


def _randomize(params, rng):
    """Give the tables and the zero-initialised leaves (brightness
    output_linear, latent codes) values of scale ~0.1-1, so that every
    parameter shapes the render."""
    def fill(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        x = np.asarray(x)
        if name.endswith("table"):
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        if "output_linear" in name or "latent_code" in name:
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fill, params)


def _views(config, height, width):
    focal = 0.9 * width
    k = np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]])
    pose = np.concatenate([np.eye(3), [[0.1], [0.2], [-0.3]]], axis=1)
    return tcameras.pose_image_batch(np.linalg.inv(k), pose, width, height,
                                     config.near, config.far)


def _jax_rand_vec(config, num_rays):
    """The per-ray hex-basis vectors the JAX eval step draws with key=None:
    one normal(PRNGKey(0), (sub_rays, 3)) draw per sub-chunk."""
    sub = max(config.render_subchunks, 1)
    parts = []
    for i0 in range(0, num_rays, config.render_chunk_size):
        n = min(config.render_chunk_size, num_rays - i0)
        per_sub = -(-n // sub)
        draw = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (per_sub, 3), jnp.float32))
        parts.append(np.tile(draw, (sub, 1))[:n])
    return np.concatenate(parts)


CASES = {
    # Exact 6-point hex, one chunk.
    "exact_hex": dict(),
    # Single-query hex with bf16 gathers, several chunks, sub-chunks with
    # padding, and the backward-only knobs set (the eval step ignores them).
    "single_query_chunks": dict(
        render_chunk_size=40, render_subchunks=2,
        mlp=dict(hex_single_query=True, grid_bf16_gather=True,
                 grid_bwd_dense_sample=True)),
}


def _configs(case):
    over = dict(CASES[case])
    mlp = over.pop("mlp", {})
    out = []
    for lib in (jconfigs, tconfigs):
        cfg = lib.tiny(**over)
        out.append(dataclasses.replace(
            cfg, nerf_mlp=dataclasses.replace(cfg.nerf_mlp, **mlp),
            prop_mlp=dataclasses.replace(cfg.prop_mlp, **mlp)))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_image_matches_jax(rng, case):
    cfg_j, cfg_t = _configs(case)
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))
    params = _randomize(params, rng)

    model_t = tstep.init_model(cfg_t, seed=0, device="cpu")
    model_t.load_state_dict(
        convert.params_from_jax(jax.tree.map(np.asarray, params)),
        strict=True)

    height, width = 7, 9
    batch = _views(cfg_t, height, width)
    want = jstep.render_image(jstep.make_eval_step(model_j, cfg_j), params,
                              batch, cfg_j, eval_camidx=2)
    rand_vec = _jax_rand_vec(cfg_j, height * width).reshape(height, width, 3)
    got = tstep.render_image(tstep.make_eval_step(model_t, cfg_t), batch,
                             cfg_t, eval_camidx=2, rand_vec=rand_vec)

    keys = {"rgb", "depth", "acc", "distance_mean", "distance_median",
            "distance_percentile_5", "distance_percentile_95"}
    assert set(got) == set(want) == keys
    for k in keys:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                   **TOL)
    # Non-vacuous: the color correction and the field shape the output.
    assert np.ptp(got["rgb"]) > 0.05 and np.ptp(got["depth"]) > 0.05


def test_params_from_jax_transposes_dense_kernels():
    tree = {"a": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "bias": np.zeros(3, np.float32)},
            "table": np.ones((4, 5), np.float32)}
    sd = convert.params_from_jax(tree)
    assert set(sd) == {"a.weight", "a.bias", "table"}
    np.testing.assert_array_equal(sd["a.weight"].numpy(), tree["a"]["kernel"].T)
    assert sd["table"].shape == (4, 5)


def test_eval_step_draws_seeded_rand_vec():
    cfg = tconfigs.tiny()
    model = tstep.init_model(cfg, seed=1, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             tstep.dummy_batch(cfg, 24).items()}
    outs = [tstep.make_eval_step(model, cfg, seed=5)(batch, 1.0, 0)
            for _ in range(2)]
    for k in outs[0]:
        assert torch.isfinite(outs[0][k]).all(), k
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=0)


def test_eval_step_is_a_function_of_the_weights_and_rays():
    """One eval step renders a chunk twice, with another chunk of the same
    size in between, bitwise equal, with and without sub-chunks: its hex
    basis is drawn anew from (seed, rays) on every call."""
    for sub in (1, 2):
        cfg = tconfigs.tiny(render_subchunks=sub)
        model = tstep.init_model(cfg, seed=1, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in
                 tstep.dummy_batch(cfg, 48).items()}
        first = {k: v[:24] for k, v in batch.items()}
        other = {k: v[24:] for k, v in batch.items()}
        eval_step = tstep.make_eval_step(model, cfg, seed=5)
        want = eval_step(first, 1.0, 0)
        between = eval_step(other, 1.0, 0)
        got = eval_step(first, 1.0, 0)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
        assert not torch.equal(between["rgb"], want["rgb"])
        # The basis is the one drawn from (seed, rays of the (sub-)chunk).
        rand_vec = torch.cat([tstep.hex_basis(5, 24 // sub)] * sub)
        given = eval_step(first, 1.0, 0, rand_vec)
        for k in want:
            torch.testing.assert_close(given[k], want[k], rtol=0, atol=0)


def test_render_image_twice_is_bitwise_equal():
    """render_image of one view twice through one eval step, over several
    chunks, a padded last chunk and sub-chunks."""
    cfg = tconfigs.tiny(render_chunk_size=40, render_subchunks=2)
    model = tstep.init_model(cfg, seed=2, device="cpu")
    eval_step = tstep.make_eval_step(model, cfg)
    view = _views(cfg, 7, 9)
    first = tstep.render_image(eval_step, view, cfg, eval_camidx=1)
    second = tstep.render_image(eval_step, view, cfg, eval_camidx=1)
    assert set(first) == set(second)
    for k in first:
        assert np.isfinite(first[k]).all(), k
        np.testing.assert_array_equal(first[k], second[k], err_msg=k)


def test_dummy_batch_matches_jax():
    cfg = tconfigs.tiny()
    got = tstep.dummy_batch(cfg, 16)
    want = jstep.dummy_batch(jconfigs.tiny(), 16)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_camera_refinement_is_refused(tmp_path):
    """Camera refinement is ported: the model holds zero deltas, a row for
    each physical camera.  What stays refused is a dataset with more
    physical cameras than Config.num_phys_cams, whose rays would index past
    the deltas: cli.train raises before it builds the model."""
    from ucnerf_tpu_torch.cli import train as cli_train

    model = tstep.init_model(tconfigs.tiny(optimize_cameras=True),
                             device="cpu")
    deltas = model.cam_refine.se3_deltas
    assert deltas.shape == (3, 6) and not deltas.any()
    with pytest.raises(ValueError, match="num_phys_cams"):
        cli_train.main([
            "--tiny", "--device", "cpu", "--max-steps", "1",
            "-b", f"Config.exp_name = {str(tmp_path / 'exp')!r}",
            "-b", "Config.optimize_cameras = True",
            "-b", "Config.num_phys_cams = 0"])


def test_port_imports_no_jax():
    """Every module of the port imports without jax or ucnerf_tpu."""
    code = """
import importlib, pkgutil, sys
import ucnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ucnerf_tpu_torch.__path__,
                                               "ucnerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 50, names
assert {"ucnerf_tpu_torch.ops.scatter", "ucnerf_tpu_torch.train.losses",
        "ucnerf_tpu_torch.train.state", "ucnerf_tpu_torch.train.checkpoints",
        "ucnerf_tpu_torch.data.datasets", "ucnerf_tpu_torch.data.warping",
        "ucnerf_tpu_torch.data.paths", "ucnerf_tpu_torch.utils.image",
        "ucnerf_tpu_torch.utils.vis", "ucnerf_tpu_torch.utils.lpips",
        "ucnerf_tpu_torch.extraction", "ucnerf_tpu_torch.extraction.meshing",
        "ucnerf_tpu_torch.extraction.tsdf", "ucnerf_tpu_torch.cli.common",
        "ucnerf_tpu_torch.cli.eval", "ucnerf_tpu_torch.cli.render",
        "ucnerf_tpu_torch.cli.extract", "ucnerf_tpu_torch.cli.tsdf",
        "ucnerf_tpu_torch.cli.train", "ucnerf_tpu_torch.cli.mvs_train",
        "ucnerf_tpu_torch.cli.mvs_depth", "ucnerf_tpu_torch.cli.import_jax",
        "ucnerf_tpu_torch.models.mvs",
        "ucnerf_tpu_torch.models.mvs.datasets",
        "ucnerf_tpu_torch.models.mvs.extractor",
        "ucnerf_tpu_torch.models.mvs.corr",
        "ucnerf_tpu_torch.models.mvs.update",
        "ucnerf_tpu_torch.models.mvs.raft",
        "ucnerf_tpu_torch.models.mvs.pipelines",
        "ucnerf_tpu_torch.models.cam_refine", "ucnerf_tpu_torch.pose",
        "ucnerf_tpu_torch.pose.colmap_io", "ucnerf_tpu_torch.pose.features",
        "ucnerf_tpu_torch.pose.matching", "ucnerf_tpu_torch.pose.pipeline",
        "ucnerf_tpu_torch.pose.rigba", "ucnerf_tpu_torch.parallel",
        "ucnerf_tpu_torch.parallel.mesh", "ucnerf_tpu_torch.ops.traffic",
        "ucnerf_tpu_torch.utils.roofline", "ucnerf_tpu_torch.tools",
        "ucnerf_tpu_torch.tools.cam_refine_quality",
        "ucnerf_tpu_torch.tools.scaling_bench",
        "ucnerf_tpu_torch.tools.mvs_quality",
        "ucnerf_tpu_torch.tools.eval_ckpt_step"} <= set(names), names
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "ucnerf_tpu" or m.startswith("ucnerf_tpu.")]
assert not bad, bad
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")

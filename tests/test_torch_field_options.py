"""The port's field options (``models/fields.py`` ``ZipMLP``) against the
JAX package's ``ZipMLP`` on the CPU, one option at a time: the GLO layers
with an explicit ``glo_vec``, scale featurization, bf16 field matmuls
(``compute_dtype``), the density and bottleneck noise (JAX's draws passed
in), predicted normals, and density normals with the contraction's
gradients on (the second derivative through the hash grid) and off (zero
normals, as in the JAX package); and the random background colour of the
model.

Inputs: seeded numpy means spread over the contracted unit cube, the
tiny preset's NeRF field with 2^12-row hash maps, random tables.  Each case
compares the outputs and the gradients of a probe loss sum(out * probe)
over every output, w.r.t. every parameter.

Tolerances (outputs rtol 1e-5 with atol 1e-6 x max|out|; gradients rtol
1e-4 with atol 1e-5 x max|grad| of each leaf): the same f32 formulas in
other summation orders, except
- bf16 matmuls: both sides round the same f32 values to bf16, so a value
  within an ulp of a rounding midpoint can round the other way on one side
  (2^-8 of that term); the outputs and the gradients take an atol of
  2^-8 x max.
- predicted normals: -grad_pred / |grad_pred| carries grad_pred's error
  over its length, which is short for some samples: the outputs take an
  atol of 1e-5 x max (measured 4.5e-6 where |grad_pred| is a few % of its
  largest).
- density normals: they are normalized gradients of the density, sums of
  table differences across a cell scaled by the grid resolution, whose f32
  cancellation leaves ~100x the forward's relative error in the unit
  vectors (measured 2.6e-5 against 3.5e-5 for either side from a float64
  run of the port); every quantity they reach takes an atol of 1e-3 x
  max.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.models import fields as jfields
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu.train import losses as jlosses
from ucnerf_tpu.train import step as jstep
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.models import fields as tfields
from ucnerf_tpu_torch.models import model as tmodel
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep

import test_torch_train as tt

torch.set_num_threads(2)

R, S = 12, 5
OUTS = ("density", "rgb", "normals", "normals_pred", "grad_pred", "coord")


def _mlp_config(lib, **over):
    cfg = lib.tiny().nerf_mlp
    return dataclasses.replace(cfg, grid_log2_hashmap_size=12, **over)


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    centre = rng.uniform(-2.5, 2.5, (3, 1, R, S)).astype(np.float32)
    means = (centre + 0.02 * rng.normal(size=(3, 6, R, S))).astype(
        np.float32)
    stds = rng.uniform(0.005, 0.05, (6, R, S)).astype(np.float32)
    vd = rng.normal(size=(R, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    glo = rng.normal(size=(R, 4)).astype(np.float32)
    return rng, means, stds, vd, glo


def _randomize(params, rng):
    def fill(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if name.endswith("table"):
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(fill, params)


def _case(option):
    """Outputs and probe-loss gradients of both sides for one option."""
    over = {
        "glo": dict(num_glo_features=4),
        "scale_featurization": dict(scale_featurization=True),
        "bf16": dict(compute_dtype="bfloat16"),
        "noise": dict(density_noise=1.0, bottleneck_noise=0.1),
        "pred_normals": dict(enable_pred_normals=True),
        "density_normals": dict(disable_density_normals=False,
                                enable_pred_normals=True,
                                contract_grads=True),
    }[option]
    cfg_j, cfg_t = (_mlp_config(lib, **over) for lib in (jconfigs, tconfigs))
    rng, means, stds, vd, glo = _inputs()
    glo_vec = glo if option == "glo" else None
    mlp_j = jfields.ZipMLP(cfg_j)
    params = mlp_j.init(jax.random.PRNGKey(0), None, jnp.asarray(means),
                        jnp.asarray(stds), viewdirs=jnp.asarray(vd),
                        glo_vec=None if glo_vec is None
                        else jnp.asarray(glo_vec))["params"]
    params = _randomize(params, rng)
    key = jax.random.PRNGKey(5) if option == "noise" else None
    noise = None
    if key is not None:
        k_d, k_b = jax.random.split(key, 2)
        noise = {"density": np.asarray(jax.random.normal(k_d, (R, S))),
                 "bottleneck": np.asarray(jax.random.normal(
                     k_b, (cfg_j.bottleneck_width, R * S)))}
    out_j = mlp_j.apply({"params": params}, key, jnp.asarray(means),
                        jnp.asarray(stds), viewdirs=jnp.asarray(vd),
                        glo_vec=None if glo_vec is None
                        else jnp.asarray(glo_vec))
    names = [k for k in OUTS if out_j.get(k) is not None]
    probes = {k: rng.normal(size=out_j[k].shape).astype(np.float32)
              for k in names}

    def loss_j(p):
        out = mlp_j.apply({"params": p}, key, jnp.asarray(means),
                          jnp.asarray(stds), viewdirs=jnp.asarray(vd),
                          glo_vec=None if glo_vec is None
                          else jnp.asarray(glo_vec))
        return sum(jnp.sum(out[k] * probes[k]) for k in names)

    grads_j = jax.tree.map(np.asarray, jax.grad(loss_j)(params))

    mlp_t = tfields.ZipMLP(cfg_t, torch.Generator().manual_seed(0),
                           with_glo=option == "glo")
    mlp_t.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    out_t = mlp_t(torch.from_numpy(means), torch.from_numpy(stds),
                  viewdirs=torch.from_numpy(vd),
                  glo_vec=None if glo_vec is None
                  else torch.from_numpy(glo_vec),
                  noise=None if noise is None
                  else {k: torch.from_numpy(np.array(v))
                        for k, v in noise.items()})
    assert [k for k in OUTS if out_t.get(k) is not None] == names
    sum((out_t[k] * torch.from_numpy(probes[k])).sum()
        for k in names).backward()
    grads_t = convert.params_to_jax(
        {k: p.grad for k, p in mlp_t.named_parameters()})
    return dict(out_j={k: np.asarray(out_j[k]) for k in names},
                out_t={k: out_t[k].detach().numpy() for k in names},
                grads_j=grads_j, grads_t=grads_t, cfg=cfg_t)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


OPTIONS = ("glo", "scale_featurization", "bf16", "noise", "pred_normals",
           "density_normals")
# (outputs, gradients) atol as a fraction of max|.|.
ATOL = {"bf16": (2.0**-8, 2.0**-8), "pred_normals": (1e-5, 1e-5),
        "density_normals": (1e-3, 1e-3)}


@pytest.mark.parametrize("option", OPTIONS)
def test_zipmlp_option_matches_jax(option):
    case = _case(option)
    frac, grad_frac = ATOL.get(option, (1e-6, 1e-5))
    for k, want in case["out_j"].items():
        got = case["out_t"][k]
        assert got.shape == want.shape, k
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=frac * float(np.abs(want).max()),
            err_msg=k)
    want = dict(_leaves(case["grads_j"]))
    got = dict(_leaves(case["grads_t"]))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=grad_frac * scale,
                                   err_msg=name)
    if option == "glo":
        assert "lin_glo_1" in case["grads_t"]
    if option == "density_normals":
        n = case["out_t"]["normals"]
        np.testing.assert_allclose(np.linalg.norm(n, axis=0), 1.0, rtol=1e-5)


def with_mlps(cfg, **mlp):
    """cfg with `mlp` set on both fields."""
    return dataclasses.replace(
        cfg, nerf_mlp=dataclasses.replace(cfg.nerf_mlp, **mlp),
        prop_mlp=dataclasses.replace(cfg.prop_mlp, **mlp))


def run_step(cfg_j, cfg_t, seed=7, impl="auto", params_first=True):
    """One tiny-preset step on both sides from seeded draws: JAX
    ``value_and_grad`` of its train loss (key=None, the scatters through
    ``SCATTER_IMPL=impl``) and the port's ``train_step`` (generator=None,
    JAX's hex basis).  `params_first` draws the parameters before the batch
    (test_torch_train's order), else after (test_torch_cam_refine's)."""
    rng = np.random.default_rng(seed)
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))
    if params_first:
        params = tt._randomize(params, rng)
        batch = tt._batch(cfg_t, rng)
    else:
        batch = tt._batch(cfg_t, rng)
        params = tt._randomize(params, rng)

    def loss_fn(p, b):
        renderings, ray_history = model_j.apply(
            {"params": p}, None, b, 0.5, compute_extras=False, train=True)
        total, losses, _ = jlosses.compute_all_losses(b, renderings,
                                                      ray_history, cfg_j)
        return total, losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "SCATTER_IMPL", impl)
        (total_j, losses_j), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                params, jax.tree.map(jnp.asarray, batch))
    model_t = tstep.init_model(cfg_t, seed=0, device="cpu")
    model_t.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    rand_vec = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (tt.RAYS, 3), jnp.float32))
    state = tstate.create_train_state(cfg_t, model_t)
    tb = {k: tt._t(v) for k, v in batch.items()}
    _, stats = tstep.make_train_step(model_t, cfg_t)(
        state, tb, 0.5, rand_vec=tt._t(rand_vec))
    grads_t = convert.params_to_jax(
        {k: p.grad for k, p in model_t.named_parameters()})
    return dict(cfg=cfg_t, params=params, batch=batch, rand_vec=rand_vec,
                total_j=float(total_j), losses_j=losses_j, stats=stats,
                grads_j=dict(tt._leaves(jax.tree.map(np.asarray, grads_j))),
                grads_t=dict(tt._leaves(grads_t)), model_j=model_j)


def check_step(case, atol_frac, names=None):
    """Every loss term at rtol 1e-4 and every gradient at rtol 1e-4 with
    an atol of atol_frac x max|grad| of its leaf."""
    losses_j = case["losses_j"]
    assert set(case["stats"]["losses"]) == set(losses_j)
    if names is not None:
        assert set(names) <= set(losses_j)
    for k, v in case["stats"]["losses"].items():
        np.testing.assert_allclose(float(v), float(losses_j[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(case["stats"]["loss"]), case["total_j"],
                               rtol=1e-4)
    want, got = case["grads_j"], case["grads_t"]
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol_frac * scale,
                                   err_msg=name)


def _options_configs():
    """The tiny preset with every remaining option of the field on: bf16
    matmuls in both fields, scale featurization in the NeRF field, the
    noise scales (which a key=None step does not draw), a random background
    (the range's mean at key=None) and the interlevel loss."""
    out = []
    for lib in (jconfigs, tconfigs):
        cfg = tt._train_config(lib, interlevel_loss_mult=1.0)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           bg_intensity_range=(0.0, 1.0)))
        cfg = with_mlps(cfg, compute_dtype="bfloat16", density_noise=1.0,
                           bottleneck_noise=0.1)
        out.append(dataclasses.replace(cfg, nerf_mlp=dataclasses.replace(
            cfg.nerf_mlp, scale_featurization=True)))
    return out


def test_options_step_matches_jax():
    """The tiny step with the options on against jax.value_and_grad (the
    Pallas scatters in interpret mode): every loss term, the interlevel
    loss included, and every gradient at the bf16 atol."""
    case = run_step(*_options_configs(), impl="pallas_interpret")
    check_step(case, 2.0**-8, names=("interlevel",))


def test_random_background_is_one_draw_for_every_level(monkeypatch):
    """With a generator, a random bg_intensity_range draws one [N, 3]
    colour inside the range and composites it behind every level (the JAX
    keyed forward's one key, keys[-1]); a given draw takes its place; with
    no generator the background is the range's mean, as the JAX key=None
    forward's."""
    cfg = _options_configs()[1]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bg_intensity_range=(0.25, 0.75)))
    model = tstep.init_model(cfg, seed=0, device="cpu")
    b = {k: tt._t(v) for k, v in tstep.dummy_batch(cfg, tt.RAYS).items()}
    seen = []
    render = tmodel.rendering.volumetric_rendering_cm

    def spy(rgbs, weights, tdist, bg_rgbs, *args, **kwargs):
        seen.append(bg_rgbs)
        return render(rgbs, weights, tdist, bg_rgbs, *args, **kwargs)

    monkeypatch.setattr(tmodel.rendering, "volumetric_rendering_cm", spy)
    draw = torch.rand((tt.RAYS, 3), generator=torch.Generator()
                      .manual_seed(4))
    with torch.no_grad():
        model(b, 0.5, train=True,
              generator=torch.Generator().manual_seed(4))
        keyed = seen[:]
        seen.clear()
        model(b, 0.5, train=True, generator=torch.Generator(),
              bg_draw=draw)
        given = seen[:]
        seen.clear()
        model(b, 0.5, rand_vec=torch.ones(tt.RAYS, 3))
    levels = cfg.model.num_levels
    assert len(keyed) == len(given) == len(seen) == levels
    assert keyed[0].shape == (tt.RAYS, 3)
    assert all(k is keyed[0] for k in keyed)
    assert 0.25 <= float(keyed[0].min()) and float(keyed[0].max()) < 0.75
    # The generator's first draw is the background.
    assert torch.equal(keyed[0], 0.25 + 0.5 * draw)
    assert all(torch.equal(g, 0.25 + 0.5 * draw) for g in given)
    assert seen == [0.5] * levels

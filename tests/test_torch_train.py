"""The port's training slice against the JAX package: one train step of the
tiny preset (losses and every parameter gradient), microbatch accumulation,
the optimizer against optax's chain, the keyed (random) ops with JAX's own
draws passed in, and the training losses' building blocks.

Tolerances:
- whole step: every loss term at rtol 1e-4; every gradient at rtol 1e-4
  with an atol of 1e-5 x max|grad| of that leaf (2e-5 for the tables).
  Both sides run the same f32 formulas in other summation orders through
  two sampling levels, the sky NeRF and the colour correction, and the
  gradient sums cancel: the dense leaves differ by up to 5.4e-6 x max|grad|
  (the sky NeRF, through 1 - exp(-x) at small x).  The JAX table gradient
  runs the Pallas scatters in interpret mode, whose two-bf16 split of each
  update (~1.5e-5 relative) moves the tables by up to 8.6e-6 x max|grad|;
  both sides round the dense levels' fractional coords to bf16.
- bf16 backward (``grid_bwd_value_dtype='bfloat16'``, K3): the same step
  with every hashed-level update rounded once to bf16 on both sides.  The
  updates ``w * g`` are formed in f32 on each side first, where they differ
  in the last bits, so a term can round to the other bf16 neighbour (2^-8 of
  the term): at most 0.05 % of the entries of a table's hashed levels may
  miss the f32 step's tolerance (measured: 0.008 % and 0.0004 %), each by
  no more than 2^-8 x max|grad|.  Against the f32 backward's gradient more
  than that miss it (measured: 0.9 % and 0.1 %); the dense levels do not
  round and keep the f32 step's tolerance.
- ops: rtol 1e-5, atol 1e-6 (same formulas, f32 ulps).
- optimizer: rtol 1e-6, atol 1e-8 (a millionth of a full step of lr_init
  0.01, for the zero-initialised leaves, which are sums of steps): the same
  chain, but torch's Adam divides by sqrt(v) / sqrt(1 - b2^t) where optax
  takes sqrt(v / (1 - b2^t)), and the port's schedule runs in float64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.ops import grad_scaler as jgs
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu.ops import mathx as jmathx
from ucnerf_tpu.ops import rendering as jrendering
from ucnerf_tpu.ops import stepfun as jstepfun
from ucnerf_tpu.train import losses as jlosses
from ucnerf_tpu.train import state as jstate
from ucnerf_tpu.train import step as jstep
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.ops import grad_scaler as tgs
from ucnerf_tpu_torch.ops import hashgrid as thash
from ucnerf_tpu_torch.ops import mathx as tmathx
from ucnerf_tpu_torch.ops import rendering as trendering
from ucnerf_tpu_torch.ops import stepfun as tstepfun
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)
RAYS = 32


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _train_config(lib, value_dtype=None, mlp_over=None, **over):
    """The tiny preset with 2^16-row hash maps and the dense-level backward
    (K2) on both fields; `value_dtype` sets ``grid_bwd_value_dtype`` and
    `mlp_over` other fields of both MLP configs."""
    cfg = lib.tiny(**over)
    mlp = dict(grid_log2_hashmap_size=16, grid_bwd_dense_sample=True,
               grid_bwd_value_dtype=value_dtype)
    mlp.update(mlp_over or {})
    return dataclasses.replace(
        cfg, nerf_mlp=dataclasses.replace(cfg.nerf_mlp, **mlp),
        prop_mlp=dataclasses.replace(cfg.prop_mlp, **mlp))


def _randomize(params, rng):
    """Tables and the zero-initialised leaves (brightness output layer,
    latent codes) at scale ~0.1-1, so every parameter shapes the loss."""
    def fill(path, x):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        x = np.asarray(x)
        if name.endswith("table"):
            return rng.normal(0, 0.5, x.shape).astype(np.float32)
        if "output_linear" in name or "latent_code" in name:
            return rng.normal(0, 0.3, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(fill, params)


def _batch(cfg, rng, rays=RAYS):
    """dummy_batch with varied targets (colours and sky pixels)."""
    b = tstep.dummy_batch(cfg, rays)
    b["rgb"] = rng.uniform(0, 1, (rays, 3)).astype(np.float32)
    b["sky_segs"] = (rng.uniform(size=rays) < 0.3).astype(np.float32)
    return b


def _step_case(value_dtype=None, **mlp_over):
    """One tiny-preset step on both sides: JAX ``value_and_grad`` of its
    train loss under ``jax.jit`` with the Pallas scatters in interpret mode
    (key=None), and the port's ``train_step`` with ``microbatches=1`` on the
    same parameters, batch and hex basis (generator=None)."""
    rng = np.random.default_rng(7)
    cfg_j, cfg_t = (_train_config(lib, value_dtype, mlp_over)
                    for lib in (jconfigs, tconfigs))
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))
    params = _randomize(params, rng)
    batch = _batch(cfg_t, rng)
    train_frac = 0.5

    def loss_fn(p, b):
        renderings, ray_history = model_j.apply(
            {"params": p}, None, b, train_frac, compute_extras=False,
            train=True)
        total, losses, _ = jlosses.compute_all_losses(b, renderings,
                                                      ray_history, cfg_j)
        return total, losses

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "SCATTER_IMPL", "pallas_interpret")
        (total_j, losses_j), grads_j = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(
                params, jax.tree.map(jnp.asarray, batch))
    grads_j = jax.tree.map(np.asarray, grads_j)

    model_t = tstep.init_model(cfg_t, seed=0, device="cpu")
    model_t.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    rand_vec = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (RAYS, 3), jnp.float32))
    state = tstate.create_train_state(cfg_t, model_t)
    tb = {k: _t(v) for k, v in batch.items()}
    _, stats = tstep.make_train_step(model_t, cfg_t)(
        state, tb, train_frac, rand_vec=_t(rand_vec))
    grads_t = convert.params_to_jax(
        {k: p.grad for k, p in model_t.named_parameters()})
    return dict(cfg=cfg_t, params=params, batch=batch, rand_vec=rand_vec,
                total_j=float(total_j), losses_j=losses_j, grads_j=grads_j,
                stats=stats, grads_t=grads_t)


@pytest.fixture(scope="module")
def step_case():
    """``_step_case``, computed once for the module (~20 s, mostly the JAX
    side's compile)."""
    return _step_case()


@pytest.fixture(scope="module")
def step_case_bf16():
    """The same step with ``grid_bwd_value_dtype='bfloat16'`` on both
    fields (the JAX side through the packed Pallas scatter)."""
    return _step_case("bfloat16")


def _check_losses(step_case):
    cfg = step_case["cfg"]
    for mlp in (cfg.nerf_mlp,
                cfg.prop_mlp.with_grid(cfg.model.prop_desired_grid_size[0])):
        spec = thash.HashGridSpec(
            num_levels=mlp.grid_num_levels, level_dim=mlp.grid_level_dim,
            base_resolution=mlp.grid_base_resolution,
            desired_resolution=mlp.grid_desired_resolution,
            log2_hashmap_size=mlp.grid_log2_hashmap_size)
        assert 1 <= spec.dense_prefix < spec.num_levels
    stats, losses_j = step_case["stats"], step_case["losses_j"]
    assert set(stats["losses"]) == set(losses_j) == {
        "data", "sky_segments", "identity", "anti_interlevel", "distortion",
        "hash_decay"}
    for k, v in stats["losses"].items():
        np.testing.assert_allclose(float(v), float(losses_j[k]), rtol=1e-4,
                                   err_msg=k)
        assert float(v) > 0, k
    np.testing.assert_allclose(float(stats["loss"]), step_case["total_j"],
                               rtol=1e-4)


def test_train_step_losses_match_jax(step_case):
    _check_losses(step_case)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_train_step_grads_match_jax(step_case):
    _check_grads(step_case)


def _check_grads(step_case):
    want = dict(_leaves(step_case["grads_j"]))
    got = dict(_leaves(step_case["grads_t"]))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        assert scale > 0, name
        atol = (2e-5 if name.endswith("table") else 1e-5) * scale
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=name)


def test_glo_config_loads_a_jax_tree_strictly():
    """With ``num_glo_features > 0`` the JAX model's tree has no GLO layers
    (no ``glo_vec`` reaches its fields), and neither has the port's."""
    cfgs = [dataclasses.replace(lib.tiny(), nerf_mlp=dataclasses.replace(
        lib.tiny().nerf_mlp, num_glo_features=4))
        for lib in (jconfigs, tconfigs)]
    _, params = jstep.init_model(cfgs[0], jax.random.PRNGKey(0))
    model = tstep.init_model(cfgs[1], seed=0, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    assert not [k for k in model.state_dict() if "glo" in k]


def test_glo_config_step_matches_jax():
    """The whole step at ``num_glo_features=4`` on both fields, at the f32
    step's tolerances (the strict load is inside ``_step_case``)."""
    case = _step_case(num_glo_features=4)
    assert case["cfg"].nerf_mlp.num_glo_features == 4
    _check_losses(case)
    _check_grads(case)


def _table_misses(got, want):
    """Share of the entries outside the f32 step's tolerance for tables;
    none may be off by more than 2^-8 x max|grad|."""
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert float(err.max()) <= 2.0**-8 * scale
    return float((err > 1e-4 * np.abs(want) + 2e-5 * scale).mean())


def _hashed_from(cfg, name):
    """First row of the hashed levels of the table of field `name`."""
    mlp = cfg.nerf_mlp if name.startswith("nerf") else cfg.prop_mlp.with_grid(
        cfg.model.prop_desired_grid_size[0])
    spec = thash.HashGridSpec(
        num_levels=mlp.grid_num_levels, level_dim=mlp.grid_level_dim,
        base_resolution=mlp.grid_base_resolution,
        desired_resolution=mlp.grid_desired_resolution,
        log2_hashmap_size=mlp.grid_log2_hashmap_size)
    return spec.offsets[spec.dense_prefix]


def test_bf16_train_step_matches_jax(step_case, step_case_bf16):
    """Losses, every dense gradient at the f32 step's tolerance, and the
    tables up to rare bf16 roundings that fell the other way; against the
    f32 backward's tables the comparison fails."""
    assert step_case_bf16["cfg"].nerf_mlp.grid_bwd_value_dtype == "bfloat16"
    assert step_case_bf16["cfg"].prop_mlp.grid_bwd_value_dtype == "bfloat16"
    _check_losses(step_case_bf16)
    want = dict(_leaves(step_case_bf16["grads_j"]))
    got = dict(_leaves(step_case_bf16["grads_t"]))
    f32 = dict(_leaves(step_case["grads_j"]))
    assert set(got) == set(want)
    tables = [name for name in got if name.endswith("table")]
    assert len(tables) == 2
    for name, g in got.items():
        w = want[name]
        if name in tables:
            lo = _hashed_from(step_case_bf16["cfg"], name)
            assert _table_misses(g[:, lo:], w[:, lo:]) <= 5e-4, name
            assert _table_misses(g[:, lo:], f32[name][:, lo:]) > 5e-4, name
            np.testing.assert_allclose(
                g[:, :lo], w[:, :lo], rtol=1e-4,
                atol=2e-5 * float(np.abs(w).max()), err_msg=name)
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=1e-5 * float(np.abs(w).max()),
                err_msg=name)


def check_eval_ignores_knobs(case, cfgs, monkeypatch):
    """Models of `cfgs`, which differ in backward knobs alone, render the
    case's batch under no_grad without reaching any scatter, and bitwise
    alike."""
    def boom(*args, **kwargs):
        raise AssertionError("a scatter ran in the eval step")
    for name in ("scatter_add_cm", "scatter_add_wsum_cm",
                 "scatter_add_dense_cm", "scatter_add_packed_cm",
                 "scatter_add_wsum_packed_cm"):
        monkeypatch.setattr(thash.scatter, name, boom)
    outs = []
    for cfg in cfgs:
        model = tstep.init_model(cfg, seed=0, device="cpu")
        model.load_state_dict(convert.params_from_jax(
            jax.tree.map(np.asarray, case["params"])), strict=True)
        batch = {k: _t(v) for k, v in case["batch"].items()}
        outs.append(tstep.make_eval_step(model, cfg)(
            batch, 1.0, 0, _t(case["rand_vec"])))
    for out in outs[1:]:
        for k, v in outs[0].items():
            assert torch.isfinite(v).all(), k
            assert torch.equal(v, out[k]), k


def test_eval_step_ignores_the_backward_knobs(step_case_bf16, monkeypatch):
    """A model built with the bf16 backward renders under no_grad without
    reaching any scatter, and as the f32-backward model renders."""
    check_eval_ignores_knobs(
        step_case_bf16, [_train_config(tconfigs, value_dtype)
                         for value_dtype in ("bfloat16", None)], monkeypatch)


def port_step(cfg, params, batch, rand_vec, microbatches):
    """The port's step of `cfg` at `microbatches` from the JAX `params`:
    (gradients by JAX leaf name, total loss)."""
    cfg = dataclasses.replace(cfg, microbatches=microbatches)
    model = tstep.init_model(cfg, seed=0, device="cpu")
    model.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    state = tstate.create_train_state(cfg, model)
    tb = {k: _t(v) for k, v in batch.items()}
    new_state, stats = tstep.make_train_step(model, cfg)(
        state, tb, 0.5, rand_vec=_t(rand_vec))
    assert new_state.step == 1 and state.optimizer.count == 1
    return (dict(_leaves(convert.params_to_jax(
        {k: p.grad for k, p in model.named_parameters()}))),
        float(stats["loss"]))


def check_accumulated(got, want):
    """A step's (gradients, loss) at several microbatches against one."""
    for name, g in want[0].items():
        np.testing.assert_allclose(got[0][name], g, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g).max()),
                                   err_msg=name)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_microbatches_accumulate_the_full_batch_gradient(step_case):
    """microbatches=2 gives the microbatches=1 gradient (every loss is a
    ray mean or independent of the rays)."""
    check_accumulated(
        port_step(step_case["cfg"], step_case["params"], step_case["batch"],
                  step_case["rand_vec"], 2),
        (dict(_leaves(step_case["grads_t"])),
         float(step_case["stats"]["loss"])))


@pytest.mark.parametrize("clip", [False, True])
def test_optimizer_matches_optax(clip):
    """Three updates from the same gradients, NaN and +-Inf mixed in, with
    the delayed warm-up, and once with value and norm clipping."""
    over = dict(lr_delay_steps=5)
    if clip:
        over.update(grad_max_norm=1.0, grad_max_val=0.05)
    cfg_j, cfg_t = jconfigs.tiny(**over), tconfigs.tiny(**over)
    model = tstep.init_model(cfg_t, seed=0, device="cpu")
    opt = tstate.create_optimizer(cfg_t, model.parameters())
    params = convert.params_to_jax(model.state_dict())
    tx = jstate.create_optimizer(cfg_j)
    opt_state = tx.init(params)
    tx_update = jax.jit(tx.update)
    rng = np.random.default_rng(3)
    names = [k for k, _ in model.named_parameters()]
    for _ in range(3):
        grads = {}
        for name, p in model.named_parameters():
            g = rng.normal(0, 0.1, p.shape).astype(np.float32)
            flat = g.reshape(-1)
            flat[rng.integers(0, flat.size, 3)] = [np.nan, np.inf, -np.inf]
            grads[name] = g
            p.grad = _t(g.copy())
        opt.update()
        updates, opt_state = tx_update(
            convert.params_to_jax({k: _t(v) for k, v in grads.items()}),
            opt_state, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params,
                              updates)
    got = dict(_leaves(convert.params_to_jax(model.state_dict())))
    for name, want in _leaves(params):
        np.testing.assert_allclose(got[name], want, rtol=1e-6, atol=1e-8,
                                   err_msg=name)
    assert opt.count == 3 and len(names) == len(got)


def test_learning_rate_schedule_matches_jax():
    for step in (0, 1, 3, 5, 100, 29999, 30000, 40000):
        for delay in (0, 5000):
            want = jmathx.learning_rate_decay(step, 0.01, 0.001, 30000,
                                              delay, 1e-8)
            got = tmathx.learning_rate_decay(step, 0.01, 0.001, 30000,
                                             delay, 1e-8)
            np.testing.assert_allclose(got, float(want), rtol=1e-6)


def _sorted_t(rng, rays, n):
    return np.sort(rng.uniform(0, 1, (rays, n)), axis=-1).astype(np.float32)


@pytest.mark.parametrize("single_jitter", [True, False])
def test_keyed_sample_with_jax_draw(rng, single_jitter):
    t = _sorted_t(rng, 5, 9)
    logits = rng.normal(size=(5, 8)).astype(np.float32)
    logits[:, 3] = -np.inf
    key = jax.random.PRNGKey(4)
    n = 12
    draw = np.asarray(jax.random.uniform(
        key, (5, 1 if single_jitter else n)))
    _close(tstepfun.sample(_t(t), _t(logits), n, jitter=_t(draw)),
           jstepfun.sample(key, jnp.asarray(t), jnp.asarray(logits), n,
                           single_jitter=single_jitter))
    _close(tstepfun.sample_intervals(_t(t), _t(logits), n, domain=(0.0, 1.0),
                                     jitter=_t(draw)),
           jstepfun.sample_intervals(key, jnp.asarray(t), jnp.asarray(logits),
                                     n, single_jitter=single_jitter,
                                     domain=(0.0, 1.0)))


def test_keyed_cast_rays_cm_with_jax_draws(rng):
    r, s = 6, 9
    d = rng.normal(size=(r, 3)).astype(np.float32)
    cam = d + 0.1 * rng.normal(size=(r, 3)).astype(np.float32)
    cam /= np.linalg.norm(cam, axis=-1, keepdims=True)
    rays = dict(origins=rng.normal(size=(r, 3)).astype(np.float32),
                directions=d, cam_dirs=cam,
                radii=rng.uniform(1e-3, 1e-2, (r, 1)).astype(np.float32))
    tdist = np.sort(rng.uniform(0.2, 6.0, (r, s + 1)), -1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    key_flip, key_rot, key_basis = jax.random.split(key, 3)
    flip = np.asarray(jax.random.uniform(key_flip, (r, s)))
    rot = np.asarray(jax.random.uniform(key_rot, (r, s)))
    basis = np.asarray(jax.random.normal(key_basis, (r, 3), jnp.float32))
    names = ("origins", "directions", "cam_dirs", "radii")
    got = trendering.cast_rays_cm(_t(tdist), *(_t(rays[k]) for k in names),
                                  _t(basis), std_scale=0.5, flip=_t(flip),
                                  rot=_t(rot))
    want = jrendering.cast_rays_cm(key, jnp.asarray(tdist),
                                   *(jnp.asarray(rays[k]) for k in names),
                                   std_scale=0.5)
    assert (flip > 0.5).any() and (flip <= 0.5).any()
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)


def _step_fn(rng, rays, n):
    t = _sorted_t(rng, rays, n + 1)
    w = rng.dirichlet(np.ones(n), rays).astype(np.float32)
    return t, w


def test_lossfun_outer_and_distortion(rng):
    t, w = _step_fn(rng, 5, 12)
    t_env, w_env = _step_fn(rng, 5, 7)
    wt = _t(w_env).requires_grad_()
    got = tstepfun.lossfun_outer(_t(t), _t(w), _t(t_env), wt)
    want, vjp = jax.vjp(lambda we: jstepfun.lossfun_outer(
        jnp.asarray(t), jnp.asarray(w), jnp.asarray(t_env), we),
        jnp.asarray(w_env))
    _close(got, want)
    got.sum().backward()
    _close(wt.grad, vjp(jnp.ones_like(want))[0])

    tt, ww = _t(t).requires_grad_(), _t(w).requires_grad_()
    got = tstepfun.lossfun_distortion(tt, ww)
    want, vjp = jax.vjp(jstepfun.lossfun_distortion, jnp.asarray(t),
                        jnp.asarray(w))
    _close(got, want)
    got.sum().backward()
    gt, gw = vjp(jnp.ones_like(want))
    _close(tt.grad, gt, rtol=1e-5, atol=1e-5)
    _close(ww.grad, gw)


def test_blur_stepfun_and_sorted_interp_quad(rng):
    t, w = _step_fn(rng, 4, 10)
    t[:, 4] = t[:, 3]  # a zero-width bin: tied knots in the sort
    y = w / np.maximum(np.diff(t, axis=-1), 1e-3)
    xr_t, yr_t = tstepfun.blur_stepfun(_t(t), _t(y), 0.03)
    xr_j, yr_j = jstepfun.blur_stepfun(jnp.asarray(t), jnp.asarray(y), 0.03)
    _close(xr_t, xr_j)
    _close(yr_t, yr_j, rtol=1e-5, atol=1e-4)

    xr, yr = np.asarray(xr_j), np.asarray(yr_j)
    area = 0.5 * (yr[..., 1:] + yr[..., :-1]) * np.diff(xr, axis=-1)
    cdf = np.concatenate([np.zeros((4, 1)), np.cumsum(area, -1)],
                         -1).astype(np.float32)
    x = np.concatenate([_sorted_t(rng, 4, 15), xr[:, ::5]], -1)
    x = np.sort(x, -1).astype(np.float32)
    fpdf = _t(yr).requires_grad_()
    got = tmathx.sorted_interp_quad(_t(x), _t(xr), fpdf, _t(cdf))
    want, vjp = jax.vjp(lambda p: jmathx.sorted_interp_quad(
        jnp.asarray(x), jnp.asarray(xr), p, jnp.asarray(cdf)),
        jnp.asarray(yr))
    _close(got, want)
    got.sum().backward()
    _close(fpdf.grad, vjp(jnp.ones_like(want))[0])


def test_grad_scaler_backward_matches_custom_vjp(rng):
    rgb = rng.normal(size=(3, 5, 7)).astype(np.float32)
    density = rng.normal(size=(5, 7)).astype(np.float32)
    dist = rng.uniform(0, 2, (5, 7)).astype(np.float32)
    g_rgb = rng.normal(size=rgb.shape).astype(np.float32)
    g_den = rng.normal(size=density.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jgs.scale_gradients_by_distance(
        a, b, jnp.asarray(dist)), jnp.asarray(rgb), jnp.asarray(density))
    want_rgb, want_den = vjp((jnp.asarray(g_rgb), jnp.asarray(g_den)))
    ta, tb = _t(rgb).requires_grad_(), _t(density).requires_grad_()
    outs = tgs.scale_gradients_by_distance(ta, tb, _t(dist))
    torch.autograd.backward(outs, (_t(g_rgb), _t(g_den)))
    _close(ta.grad, want_rgb)
    _close(tb.grad, want_den)


def test_random_training_forward_is_sorted_and_finite():
    """With a seeded generator: intervals sorted and inside the sampling
    domain, every loss finite, and the same seed gives the same step."""
    cfg = _train_config(tconfigs, microbatches=2)
    b = {k: _t(v) for k, v in tstep.dummy_batch(cfg, RAYS).items()}
    totals = []
    for _ in range(2):
        model = tstep.init_model(cfg, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(11)
        renderings, history = model(b, 0.5, train=True, generator=gen)
        for level in history:
            sdist = level["sdist"]
            assert (sdist[..., 1:] >= sdist[..., :-1]).all()
            assert sdist.min() >= 0 and sdist.max() <= 1
        total, losses, _ = tstep.losses_lib.compute_all_losses(
            b, renderings, history, cfg)
        assert all(torch.isfinite(v) for v in losses.values())
        state = tstate.create_train_state(cfg, model)
        _, stats = tstep.make_train_step(model, cfg)(
            state, b, 0.5, generator=gen)
        totals.append(float(stats["loss"]))
        assert np.isfinite(totals[-1])
    assert totals[0] == totals[1]
    with pytest.raises(ValueError):
        model(b, 0.5, rand_vec=torch.zeros((RAYS, 3)), train=True,
              generator=torch.Generator())

"""The port's camera refinement (``models/cam_refine.py``, the model's
``optimize_cameras`` path, the camera param group of ``train/state.py`` and
its checkpoints) against the JAX package, on the CPU.

Tolerances:
- ``so3_exp`` / ``se3_apply`` values and gradients: rtol 1e-5, atol 1e-6
  (the same f32 formulas; sin, cos and sqrt in other libraries).
- the tiny model's loss and gradients, ``se3_deltas`` included: the train
  step's tolerances of tests/test_torch_train.py (losses rtol 1e-4,
  gradients rtol 1e-4 with atol 1e-5 x max|grad|, 2e-5 for the tables),
  on that test's draws (seed 7), except that at most 0.05 % of a table's
  entries may miss it, each by no more than 2^-8 x max|grad| (the rule of
  that file's bf16 test, ``_table_misses``).  With nonzero deltas the rays
  are rotated through two libraries' sin and cos, so sample positions
  differ by ulps, and a dense level's bf16-rounded fractional coordinate
  can round to the other neighbour: one bf16 step of a corner weight.
  Measured: 5 of 687,744 NeRF-table entries, 3.8e-5 x max|grad|.  The
  plain step does the same on other draws, with or without camera
  refinement: with seed 11 and no sky NeRF, 304 NeRF-table entries miss
  by up to 2.5e-3 x max|grad| and 15 entries of ``density_hidden.weight``
  by up to 2.0e-3 (an open item in the ROADMAP's Queue C).
  With ``contract_origin_grads`` on the sample positions carry a gradient:
  the hash encoder gathers the corner rows (K4's ``take_cm``) and the
  weights' gradient is an einsum over them, which the JAX side's autodiff
  of its gather gives.
- ``cam_lr_mult``: the optimizer test's rtol 1e-6, atol 1e-8.
- pose recovery through an analytic renderer (test_cam_refine.py's
  north-star): a 5x cut of both halves of the rig error; each of the
  first 10 Adam updates against optax's from the same state at rtol 1e-4,
  atol 1e-4 x lr (the test's docstring says why).
- three training steps: losses at rtol 1e-4 and the camera deltas at rtol
  1e-3 (Adam's first steps are ~lr x sign(g) for each entry, so a delta
  moves by the same amount on both sides while its gradient is well above
  rounding).  The other parameters are not compared after a step: a table
  entry whose gradient is at rounding level moves by +-lr either way.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.models import cam_refine as jcam
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu.train import losses as jlosses
from ucnerf_tpu.train import state as jstate
from ucnerf_tpu.train import step as jstep
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.models import cam_refine as tcam
from ucnerf_tpu_torch.train import checkpoints as tckpt
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep

import test_torch_train as tt

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def test_so3_exp_values_and_gradient_at_zero(rng):
    w = rng.normal(0, 1.0, (32, 3)).astype(np.float32)
    w[0] = 0
    w[1] = [1e-6, 0, 0]  # the small-angle branch
    want = np.asarray(jcam.so3_exp(jnp.asarray(w)))
    got = tcam.so3_exp(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[0], np.eye(3, dtype=np.float32))

    probe = rng.normal(size=(3, 3)).astype(np.float32)
    for w0 in (np.zeros(3, np.float32), w[1], w[5]):
        gj = np.asarray(jax.grad(lambda v: jnp.sum(
            jcam.so3_exp(v) * probe))(jnp.asarray(w0)))
        wt = torch.from_numpy(w0.copy()).requires_grad_()
        (tcam.so3_exp(wt) * torch.from_numpy(probe)).sum().backward()
        assert torch.isfinite(wt.grad).all()
        np.testing.assert_allclose(wt.grad.numpy(), gj, **TOL)


def test_se3_apply_values_and_gradients(rng):
    n, cams = 40, 3
    deltas = (0.1 * rng.normal(size=(cams, 6))).astype(np.float32)
    deltas[2] = 0  # one camera at the init point
    idx = rng.integers(0, cams, n).astype(np.int32)
    rays = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    probes = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]

    def loss_j(d):
        outs = jcam.se3_apply(d, jnp.asarray(idx), *map(jnp.asarray, rays))
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes)), outs

    (_, outs_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(
        jnp.asarray(deltas))
    dt = torch.from_numpy(deltas.copy()).requires_grad_()
    outs_t = tcam.se3_apply(dt, torch.from_numpy(idx),
                            *map(torch.from_numpy, rays))
    sum((o * torch.from_numpy(p)).sum()
        for o, p in zip(outs_t, probes)).backward()
    for o_t, o_j in zip(outs_t, outs_j):
        np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                                   **TOL)
    np.testing.assert_allclose(dt.grad.numpy(), np.asarray(g_j), **TOL)
    # Identity at init: the rays pass through unchanged.
    zero = tcam.se3_apply(torch.zeros(cams, 6), torch.from_numpy(idx),
                          *map(torch.from_numpy, rays))
    for z, r in zip(zero, rays):
        np.testing.assert_array_equal(z.numpy(), r)


def _cam_config(lib, contract, model_sky=True):
    return tt._train_config(lib, optimize_cameras=True, num_phys_cams=3,
                            contract_origin_grads=contract,
                            model_sky=model_sky)


def _cam_case(contract):
    """One tiny-preset step with camera refinement on both sides, as
    test_torch_train._step_case and on its draws; with
    contract_origin_grads on, the camera deltas start away from 0
    (so3_exp's trig branch)."""
    rng = np.random.default_rng(7)
    cfg_j, cfg_t = (_cam_config(lib, contract) for lib in (jconfigs,
                                                            tconfigs))
    batch = tt._batch(cfg_t, rng)
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))
    params = tt._randomize(params, rng)
    if contract:
        params = dict(params, cam_refine={"se3_deltas": jnp.asarray(
            0.02 * rng.normal(size=(3, 6)), jnp.float32)})
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
    model_t = tstep.init_model(cfg_t, seed=0, device="cpu")
    model_t.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    rand_vec = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                            (tt.RAYS, 3), jnp.float32))
    state = tstate.create_train_state(cfg_t, model_t)
    _, stats = tstep.make_train_step(model_t, cfg_t)(
        state, {k: tt._t(v) for k, v in batch.items()}, train_frac,
        rand_vec=tt._t(rand_vec))
    grads_t = convert.params_to_jax(
        {k: p.grad for k, p in model_t.named_parameters()})
    return dict(total_j=float(total_j), losses_j=losses_j, stats=stats,
                grads_j=jax.tree.map(np.asarray, grads_j), grads_t=grads_t)


@pytest.fixture(scope="module", params=[False, True],
                ids=["contract_off", "contract_on"])
def cam_case(request):
    return request.param, _cam_case(request.param)


def test_cam_step_matches_jax(cam_case):
    """The loss terms and every gradient, the camera deltas included."""
    contract, case = cam_case
    for k, v in case["stats"]["losses"].items():
        np.testing.assert_allclose(float(v), float(case["losses_j"][k]),
                                   rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(case["stats"]["loss"]),
                               case["total_j"], rtol=1e-4)
    want = dict(tt._leaves(case["grads_j"]))
    got = dict(tt._leaves(case["grads_t"]))
    assert set(got) == set(want) and "cam_refine/se3_deltas" in got
    for name, g in got.items():
        w = want[name]
        scale = float(np.abs(w).max())
        assert scale > 0, name
        if name.endswith("table"):
            assert tt._table_misses(g, w) <= 5e-4, name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=name)
    d = got["cam_refine/se3_deltas"]
    assert np.isfinite(d).all() and np.abs(d).min() > 0


@pytest.mark.parametrize("contract", [False, True])
def test_contract_origin_grads_unlocks_translation(contract):
    """As test_cam_refine.py has it, without the sky NeRF (which reads the
    ray origins): with the no-grad contraction the translation half of the
    deltas gets exactly zero gradient, with contract_origin_grads a nonzero
    one; the rotation half a nonzero one either way."""
    cfg = dataclasses.replace(_cam_config(tconfigs, contract),
                              model_sky=False)
    model = tstep.init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    batch = {k: tt._t(v) for k, v in tt._batch(cfg, rng).items()}
    state = tstate.create_train_state(cfg, model)
    gen = torch.Generator().manual_seed(1)
    tstep.make_train_step(model, cfg)(state, batch, 0.5, generator=gen)
    # The gradient is left on the parameters by the step (scaled by
    # 1/microbatches), before the update consumed it.
    d = model.cam_refine.se3_deltas.grad
    assert torch.isfinite(d).all() and d[:, :3].abs().max() > 0
    if contract:
        assert d[:, 3:].abs().max() > 0
    else:
        assert not d[:, 3:].any()


@pytest.mark.parametrize("cam_lr_mult", [0.02, 1.0])
def test_cam_lr_mult_matches_optax(cam_lr_mult):
    """Three updates of a tiny model with camera refinement from the same
    gradients: the port's two Adam param groups against the JAX chain's
    ``cam_scale`` (inserted only for a multiplier other than 1)."""
    over = dict(lr_delay_steps=5, optimize_cameras=True,
                cam_lr_mult=cam_lr_mult)
    cfg_j, cfg_t = jconfigs.tiny(**over), tconfigs.tiny(**over)
    model = tstep.init_model(cfg_t, seed=0, device="cpu")
    state = tstate.create_train_state(cfg_t, model)
    opt = state.optimizer
    assert [len(g["params"]) for g in opt.adam.param_groups][1:] == [1]
    params = convert.params_to_jax(model.state_dict())
    tx = jstate.create_optimizer(cfg_j)
    opt_state = tx.init(params)
    tx_update = jax.jit(tx.update)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = {}
        for name, p in model.named_parameters():
            g = rng.normal(0, 0.1, p.shape).astype(np.float32)
            grads[name] = g
            p.grad = tt._t(g.copy())
        opt.update()
        updates, opt_state = tx_update(
            convert.params_to_jax({k: tt._t(v) for k, v in grads.items()}),
            opt_state, params)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params,
                              updates)
    got = dict(tt._leaves(convert.params_to_jax(model.state_dict())))
    for name, want in tt._leaves(params):
        np.testing.assert_allclose(got[name], want, rtol=1e-6, atol=1e-8,
                                   err_msg=name)
    moved = np.abs(got["cam_refine/se3_deltas"]).max()
    assert 0 < moved <= 3 * cfg_t.lr_init * cam_lr_mult


def test_three_cam_steps_match_jax():
    """Three tiny-preset steps with camera refinement and
    contract_origin_grads (key=None on the JAX side, its hex basis handed to
    the port): the losses and the camera deltas."""
    rng = np.random.default_rng(13)
    cfg_j, cfg_t = (_cam_config(lib, True) for lib in (jconfigs, tconfigs))
    cfg_j = dataclasses.replace(cfg_j, lr_delay_steps=0)
    cfg_t = dataclasses.replace(cfg_t, lr_delay_steps=0)
    batch = tt._batch(cfg_t, rng)
    model_j, params = jstep.init_model(cfg_j, jax.random.PRNGKey(0))
    params = tt._randomize(params, rng)
    model_t = tstep.init_model(cfg_t, seed=0, device="cpu")
    model_t.load_state_dict(convert.params_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    rand_vec = tt._t(np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (tt.RAYS, 3), jnp.float32)))

    state_j = jstate.create_train_state(cfg_j, params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhash, "SCATTER_IMPL", "pallas_interpret")
        step_j = jstep.make_train_step(model_j, cfg_j)
        losses_j = []
        for _ in range(3):
            state_j, stats = step_j(state_j, jax.tree.map(jnp.asarray, batch),
                                    None, 0.5)
            losses_j.append(float(stats["loss"]))
    state_t = tstate.create_train_state(cfg_t, model_t)
    step_t = tstep.make_train_step(model_t, cfg_t)
    tb = {k: tt._t(v) for k, v in batch.items()}
    losses_t = []
    for _ in range(3):
        state_t, stats = step_t(state_t, tb, 0.5, rand_vec=rand_vec)
        losses_t.append(float(stats["loss"]))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    want = np.asarray(state_j.params["cam_refine"]["se3_deltas"])
    got = model_t.cam_refine.se3_deltas.detach().numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())


def _cam_state(cfg):
    model = tstep.init_model(cfg, seed=0, device="cpu")
    return tstate.create_train_state(cfg, model)


def _run(state, cfg, batch, start, stop):
    """Steps start+1 .. stop, each with its draws from a generator seeded
    from the step, as cli/train.py seeds them."""
    train_step = tstep.make_train_step(state.model, cfg)
    gen = torch.Generator()
    for step in range(start + 1, stop + 1):
        gen.manual_seed(1000 + step)
        state, _ = train_step(state, batch, 0.5, generator=gen)
    return state


def _all_tensors(state):
    out = {f"param {k}": v.detach().clone()
           for k, v in state.model.named_parameters()}
    sd = state.optimizer.adam.state_dict()
    for i, s in sd["state"].items():
        for k, v in s.items():
            out[f"adam {i} {k}"] = torch.as_tensor(v).clone()
    out["lrs"] = torch.tensor([g["lr"] for g in sd["param_groups"]])
    out["count"] = torch.tensor(state.optimizer.count)
    return out


def test_resume_is_exact_with_camera_groups(tmp_path):
    """2 steps, a checkpoint, a restore into a fresh run and 2 more steps
    equal 4 uninterrupted steps bit for bit, the camera param group's Adam
    state and learning rate included; a checkpoint with camera refinement
    does not restore into a run without it."""
    cfg = tconfigs.tiny(optimize_cameras=True, contract_origin_grads=True,
                        microbatches=2)
    batch = {k: tt._t(v) for k, v in tstep.dummy_batch(cfg, 64).items()}
    batch["rgb"] = tt._t(np.random.default_rng(1).uniform(
        0, 1, (64, 3)).astype(np.float32))
    whole = _all_tensors(_run(_cam_state(cfg), cfg, batch, 0, 4))

    tckpt.save_checkpoint(str(tmp_path),
                          _run(_cam_state(cfg), cfg, batch, 0, 2), step=2)
    resumed, step = tckpt.restore_checkpoint(str(tmp_path), _cam_state(cfg))
    assert step == 2 and len(resumed.optimizer.adam.param_groups) == 2
    got = _all_tensors(_run(resumed, cfg, batch, 2, 4))
    assert set(got) == set(whole)
    assert "param cam_refine.se3_deltas" in got
    assert float(got["lrs"][1]) == pytest.approx(float(got["lrs"][0])
                                                 * cfg.cam_lr_mult)
    differ = [k for k in whole if not torch.equal(got[k], whole[k])]
    assert not differ, differ
    assert got["param cam_refine.se3_deltas"].abs().max() > 0

    off = dataclasses.replace(cfg, optimize_cameras=False)
    with pytest.raises(ValueError, match="optimize_cameras"):
        tckpt.restore_checkpoint(str(tmp_path), _cam_state(off))


def test_cli_train_with_camera_refinement_resumes_bitwise(tmp_path):
    """``cli.train -b "Config.optimize_cameras = True"`` (with
    contract_origin_grads): 6 straight steps against 3 + resume + 3, the
    step-6 checkpoints bitwise equal, the camera group's included."""
    import test_torch_cli as tc

    extra = ["-b", "Config.optimize_cameras = True",
             "-b", "Config.contract_origin_grads = True"]
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    log = tc._run(straight, *extra)
    assert "step 6/6" in log and "resumed" not in log
    os.makedirs(os.path.join(resumed, "checkpoints"))
    shutil.copytree(os.path.join(straight, "checkpoints", "3"),
                    os.path.join(resumed, "checkpoints", "3"))
    assert "resumed from step 3" in tc._run(resumed, *extra)
    want, got = tc._load(straight, 6), tc._load(resumed, 6)
    assert len(got["adam"]["param_groups"]) == 2
    assert got["model"]["cam_refine.se3_deltas"].abs().max() > 0
    a, b = tc._flat(want), tc._flat(got)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _plane_color(origins, dn):
    """The analytic renderer of test_cam_refine.py's pose-recovery test in
    torch: an infinite ground plane (y = -1) with a smooth multi-scale
    texture, so the photometric objective has a wide basin."""
    o, d = origins, dn
    t = (-1.0 - o[..., 1]) / torch.where(d[..., 1].abs() > 1e-6, d[..., 1],
                                         torch.full_like(d[..., 1], 1e-6))
    p = o + d * t[..., None]
    u, v = p[..., 0], p[..., 2]

    def tex(u, v):
        return (0.6 * torch.sin(0.9 * u) * torch.sin(0.7 * v)
                + 0.3 * torch.sin(2.3 * u + 1.0) * torch.sin(1.9 * v + 0.5)
                + 0.15 * torch.sin(5.1 * u + 2.0) * torch.sin(4.3 * v + 1.2))

    return torch.stack([0.5 + 0.4 * tex(u, v),
                        0.5 + 0.4 * tex(u + 3, v + 1),
                        0.5 + 0.4 * tex(u - 2, v + 4)], dim=-1)


def _recover_camera(steps, jax_after_torch=False):
    """Run the port's camera recovery for `steps` Adam steps, holding each
    of the first 10 updates against optax's from the same deltas and
    moments (see test_perturbed_camera_recovers); returns the pose errors
    (rotation, translation) before and after.

    optax gets copies of the port's moments: on the CPU ``jnp.asarray`` of
    a tensor's ``.numpy()`` shares the tensor's memory, and torch's
    ``opt.step()`` updates the moments in place, so a JAX step that ran
    late would read the next step's moments.  With `jax_after_torch` the
    JAX step is dispatched only after ``opt.step()``, the order a loaded
    machine can give the asynchronous dispatch."""
    import optax
    from scipy.spatial.transform import Rotation

    import test_cam_refine as jtest
    from ucnerf_tpu_torch.data import cameras as tcameras

    c2w = np.eye(4)
    c2w[:3, :3] = Rotation.from_euler("xyz", [-0.5, 0.3, 0.0]).as_matrix()
    c2w[:3, 3] = [0.5, 1.5, 2.0]
    k = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    pixtocam = np.linalg.inv(k)
    x, y = np.meshgrid(np.arange(128), np.arange(96))
    x, y = x.reshape(-1), y.reshape(-1)

    o_true, d_true, _, _, _ = tcameras.pixels_to_rays(
        x, y, pixtocam[None], c2w[None, :3, :])
    dn_true = d_true / np.linalg.norm(d_true, axis=-1, keepdims=True)
    target = _plane_color(*(tt._t(v.astype(np.float32))
                            for v in (o_true, dn_true)))
    np.testing.assert_allclose(
        target.numpy(), np.asarray(jtest._plane_color_jnp(
            jnp.asarray(o_true, jnp.float32),
            jnp.asarray(dn_true, jnp.float32))), **TOL)

    xi_true = np.array([0.03, -0.05, 0.02, 0.08, -0.06, 0.04], np.float32)
    delta = np.eye(4)
    delta[:3, :3] = Rotation.from_rotvec(xi_true[:3]).as_matrix()
    delta[:3, 3] = xi_true[3:]
    c2w_bad = delta @ c2w
    o_bad, d_bad, _, _, _ = tcameras.pixels_to_rays(
        x, y, pixtocam[None], c2w_bad[None, :3, :])
    o_bad, d_bad = (v.astype(np.float32) for v in (o_bad, d_bad))
    cd_bad = np.broadcast_to(-c2w_bad[:3, 2], d_bad.shape).astype(np.float32)
    idx = np.zeros(len(x), np.int32)

    def pose_error(deltas):
        """Residual rigid error of Exp(delta) @ c2w_bad against c2w."""
        fix = np.eye(4)
        fix[:3, :3] = tcam.so3_exp(tt._t(deltas[0, :3])).numpy()
        fix[:3, 3] = deltas[0, 3:]
        resid = np.linalg.inv(c2w) @ fix @ c2w_bad
        ang = np.linalg.norm(Rotation.from_matrix(resid[:3, :3]).as_rotvec())
        return ang, np.linalg.norm(resid[:3, 3])

    rays_t = [tt._t(v) for v in (o_bad, d_bad, cd_bad)]
    idx_t = tt._t(idx)

    def loss_t(deltas):
        o2, d2, _ = tcam.se3_apply(deltas, idx_t, *rays_t)
        pred = _plane_color(o2, d2 / torch.linalg.norm(d2, dim=-1,
                                                       keepdim=True))
        return torch.mean((pred - target) ** 2)

    rays_j = [jnp.asarray(v) for v in (o_bad, d_bad, cd_bad)]
    target_j = jnp.asarray(target.numpy().copy())

    def loss_j(deltas):
        o2, d2, _ = jcam.se3_apply(deltas, jnp.asarray(idx), *rays_j)
        pred = jtest._plane_color_jnp(
            o2, d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True))
        return jnp.mean((pred - target_j) ** 2)

    lr = 3e-3
    tx = optax.adam(lr)
    step_j = jax.jit(lambda dl, st: jtest._adam_step(loss_j, tx, dl, st))
    deltas = torch.zeros((1, 6), requires_grad=True)
    opt = torch.optim.Adam([deltas], lr=lr)
    err0 = pose_error(np.zeros((1, 6), np.float32))
    for i in range(steps):
        before = deltas.detach().numpy().copy()
        if i < 10:
            # optax's Adam from copies of the port's deltas and moments.
            opt_state = tx.init(jnp.asarray(before))
            if i:
                adam = opt.state[deltas]
                opt_state = (opt_state[0]._replace(
                    count=jnp.asarray(i, jnp.int32),
                    mu=jnp.asarray(adam["exp_avg"].numpy().copy()),
                    nu=jnp.asarray(adam["exp_avg_sq"].numpy().copy())),
                    *opt_state[1:])
            if not jax_after_torch:
                after_j = jax.block_until_ready(
                    step_j(jnp.asarray(before), opt_state)[0])
        opt.zero_grad()
        loss_t(deltas).backward()
        opt.step()
        if i < 10:
            if jax_after_torch:
                after_j = step_j(jnp.asarray(before), opt_state)[0]
            got = deltas.detach().numpy() - before
            want = np.asarray(after_j) - before
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * lr,
                                       err_msg=f"update {i + 1}")
    return err0, pose_error(deltas.detach().numpy())


def test_perturbed_camera_recovers():
    """test_cam_refine.py's north-star on the port: the true camera looks
    down at the textured plane, the rays come from a pose perturbed by a
    rigid delta, and photometric optimization of the port's ``se3_apply``
    deltas with ``torch.optim.Adam`` (lr 3e-3, 300 steps) cuts both the
    rotation and the translation error by at least 5x.  Each of the first
    10 updates equals optax's Adam on the JAX package's same loss, taken
    from the port's deltas and moments, within rtol 1e-4 and an atol of
    1e-4 x lr (measured: 1.1e-5 x lr; the gradients differ in f32 rounding
    only).  The two trajectories are not compared: an entry whose
    gradient changes sign (the third and fifth here) amplifies that
    rounding about twofold an update, to 6e-3 x lr by the tenth."""
    (err0_rot, err0_tr), (err_rot, err_tr) = _recover_camera(300)
    assert err0_rot / max(err_rot, 1e-9) > 5, (err0_rot, err_rot)
    assert err0_tr / max(err_tr, 1e-9) > 5, (err0_tr, err_tr)


def test_adam_parity_survives_a_late_jax_step():
    """The first 10 updates of test_perturbed_camera_recovers with optax's
    step dispatched after torch's ``opt.step()``, the order in which that
    test once failed under load (all 6 entries off by up to 32 % at some
    update): optax must read the moments as they were before the step,
    not torch's in-place update of them."""
    _recover_camera(10, jax_after_torch=True)

"""The port's reference-layout ops against the JAX package on the CPU:
``mathx`` (``fast_erf``, ``safe_sin``, ``safe_cos``), ``coord``
(``expected_sin``, ``integrated_pos_enc``, the row-major
``contract_mean_std`` and ``track_linearize``), ``rendering`` (the
row-major ``lift_gaussian``, ``conical_frustum_to_gaussian``,
``cylinder_to_gaussian``, ``cast_rays`` and ``volumetric_rendering``),
``geopoly`` (a copy), ``ref_utils``, ``hashgrid``'s reference encoder
(``encode`` / ``encode_level``, forward and table gradient, whose backward
is K1's plain entry), ``tv_loss`` and ``level_sq_means``, and
``stepfun.inner_outer``'s repeatable backward.

Tolerances: rtol 1e-5 with atol 1e-6 (the same f32 formulas; sin, cos,
exp and sqrt from other libraries), except where stated: safe_sin/cos of
arguments up to 1e4 (the remainder of a large f32 argument is exact on both
sides; the sine of it agrees to atol 1e-5), the contraction's std (torch
has no cbrt: ``pow(., 1/3)`` is a few ulp off, rtol 1e-5), the unstable
frustum formula (atol 1e-3: it cancels in f32 on both sides), the
integrated directional encoding at deg 5 (held against float64, as stated
in its test), the encoder's
table gradient (sums of up to 8 corner updates a row in another order:
atol 1e-6 x max|grad|) and geopoly (numpy on both sides: bitwise).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu.ops import coord as jcoord
from ucnerf_tpu.ops import geopoly as jgeopoly
from ucnerf_tpu.ops import hashgrid as jhash
from ucnerf_tpu.ops import mathx as jmathx
from ucnerf_tpu.ops import ref_utils as jref
from ucnerf_tpu.ops import rendering as jrendering
from ucnerf_tpu.ops import stepfun as jstepfun
from ucnerf_tpu_torch.ops import coord as tcoord
from ucnerf_tpu_torch.ops import geopoly as tgeopoly
from ucnerf_tpu_torch.ops import hashgrid as thash
from ucnerf_tpu_torch.ops import mathx as tmathx
from ucnerf_tpu_torch.ops import ref_utils as tref
from ucnerf_tpu_torch.ops import rendering as trendering
from ucnerf_tpu_torch.ops import stepfun as tstepfun

import test_hashgrid

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _grad_t(fn, *xs):
    """fn(*xs) and the gradient of sum(fn * probe) w.r.t. each x."""
    ts = [_t(x).requires_grad_() for x in xs]
    out = fn(*ts)
    probe = torch.from_numpy(np.random.default_rng(1).normal(
        size=out.shape).astype(np.float32))
    (out * probe).sum().backward()
    return out, [t.grad for t in ts], probe.numpy()


def _grad_j(fn, probe, *xs):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in xs))
    return out, vjp(jnp.asarray(probe))


def test_mathx_fast_erf_and_safe_trig(rng):
    x = rng.normal(0, 2, 200).astype(np.float32)
    _close(tmathx.fast_erf(_t(x)), jmathx.fast_erf(jnp.asarray(x)))
    big = np.concatenate([x, rng.uniform(-1e4, 1e4, 200).astype(np.float32),
                          np.float32([100 * np.pi, -400.0, 314.16])])
    for name in ("safe_sin", "safe_cos"):
        _close(getattr(tmathx, name)(_t(big)),
               getattr(jmathx, name)(jnp.asarray(big)), rtol=1e-5,
               atol=1e-5)


def test_coord_ipe_and_expected_sin(rng):
    mean = rng.normal(size=(5, 7, 3)).astype(np.float32)
    var = rng.uniform(0, 0.5, (5, 7, 3)).astype(np.float32)
    _close(tcoord.expected_sin(_t(mean), _t(var)),
           jcoord.expected_sin(jnp.asarray(mean), jnp.asarray(var)))
    got, grads, probe = _grad_t(
        lambda m, v: tcoord.integrated_pos_enc(m, v, 0, 4), mean, var)
    want, gj = _grad_j(lambda m, v: jcoord.integrated_pos_enc(m, v, 0, 4),
                       probe, mean, var)
    _close(got, want)
    for g, w in zip(grads, gj):
        _close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stop_grads", [True, False])
def test_coord_row_major_contraction(rng, stop_grads):
    x = (rng.normal(size=(40, 3)) * rng.uniform(0.1, 5, (40, 1))).astype(
        np.float32)
    std = rng.uniform(0.01, 0.2, 40).astype(np.float32)
    zt, st = tcoord.contract_mean_std(_t(x), _t(std))
    zj, sj = jcoord.contract_mean_std(jnp.asarray(x), jnp.asarray(std))
    _close(zt, zj)
    _close(st, sj)
    # The channel-major twin on the same points.
    zc, sc = tcoord.contract_mean_std_cm(_t(x.T), _t(std))
    _close(zc.T, zt)
    _close(sc, st)
    xt = _t(x).requires_grad_()
    mean, s = tcoord.track_linearize("contract", xt, _t(std),
                                     stop_grads=stop_grads)
    assert mean.requires_grad == (not stop_grads)
    if not stop_grads:
        (mean.sum() + s.sum()).backward()
        gj = jax.grad(lambda v: sum(jnp.sum(a) for a in jcoord.track_linearize(
            "contract", v, jnp.asarray(std), stop_grads=False)))(
                jnp.asarray(x))
        _close(xt.grad, gj, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        tcoord.track_linearize("other", xt, _t(std))


@pytest.mark.parametrize("diag", [True, False])
def test_rendering_gaussians(rng, diag):
    d = rng.normal(size=(6, 3)).astype(np.float32)
    t = np.sort(rng.uniform(0.5, 5, (6, 9)), -1).astype(np.float32)
    t0, t1 = t[:, :-1], t[:, 1:]
    radius = rng.uniform(1e-3, 1e-2, (6, 1)).astype(np.float32)
    for stable in (True, False):
        got = trendering.conical_frustum_to_gaussian(
            _t(d), _t(t0), _t(t1), _t(radius), diag, stable=stable)
        want = jrendering.conical_frustum_to_gaussian(
            jnp.asarray(d), jnp.asarray(t0), jnp.asarray(t1),
            jnp.asarray(radius), diag, stable=stable)
        for g, w in zip(got, want):
            # The unstable formula cancels in t1^k - t0^k and in
            # t_mosq - t_mean^2: f32 on both sides.
            _close(g, w, rtol=1e-5, atol=1e-6 if stable else 1e-3)
    got = trendering.cylinder_to_gaussian(_t(d), _t(t0), _t(t1),
                                          _t(radius), diag)
    want = jrendering.cylinder_to_gaussian(jnp.asarray(d), jnp.asarray(t0),
                                           jnp.asarray(t1),
                                           jnp.asarray(radius), diag)
    for g, w in zip(got, want):
        _close(g, w)


def _rays(rng, r):
    d = rng.normal(size=(r, 3)).astype(np.float32)
    cam = d + 0.1 * rng.normal(size=(r, 3)).astype(np.float32)
    cam /= np.linalg.norm(cam, axis=-1, keepdims=True)
    return dict(origins=rng.normal(size=(r, 3)).astype(np.float32),
                directions=d, cam_dirs=cam,
                radii=rng.uniform(1e-3, 1e-2, (r, 1)).astype(np.float32))


@pytest.mark.parametrize("keyed", [False, True])
def test_rendering_cast_rays_row_major(rng, keyed):
    """cast_rays against the JAX function (its key=None pattern, or its
    keyed draws passed in), and its layout against cast_rays_cm."""
    r, s = 5, 8
    rays = _rays(rng, r)
    tdist = np.sort(rng.uniform(0.2, 6.0, (r, s + 1)), -1).astype(np.float32)
    names = ("origins", "directions", "cam_dirs", "radii")
    if keyed:
        key = jax.random.PRNGKey(9)
        kf, kr, kb = jax.random.split(key, 3)
        flip = np.asarray(jax.random.uniform(kf, (r, s)))
        rot = np.asarray(jax.random.uniform(kr, (r, s)))
        basis = np.asarray(jax.random.normal(kb, (r, 3), jnp.float32))
        extra = dict(flip=_t(flip), rot=_t(rot))
    else:
        key = None
        basis = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (r, 3),
                                             jnp.float32))
        extra = {}
    got = trendering.cast_rays(_t(tdist), *(_t(rays[k]) for k in names),
                               _t(basis), std_scale=0.5, **extra)
    want = jrendering.cast_rays(key, jnp.asarray(tdist),
                                *(jnp.asarray(rays[k]) for k in names),
                                std_scale=0.5)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)
    cm = trendering.cast_rays_cm(_t(tdist), *(_t(rays[k]) for k in names),
                                 _t(basis), std_scale=0.5, **extra)
    _close(got[0], cm[0].permute(2, 3, 1, 0), rtol=1e-5, atol=1e-5)
    _close(got[1], cm[1].permute(1, 2, 0))


@pytest.mark.parametrize("bg", ["constant", "per_ray"])
def test_rendering_volumetric_row_major(rng, bg):
    """volumetric_rendering with the extras and every distance statistic,
    against the JAX function and the channel-major twin; a per-ray [R, 3]
    background is a random bg_intensity_range's draw."""
    r, s = 6, 10
    rgbs = rng.uniform(0, 1, (r, s, 3)).astype(np.float32)
    normals = rng.normal(size=(r, s, 3)).astype(np.float32)
    w = rng.dirichlet(np.ones(s + 1), r)[:, :s].astype(np.float32)
    w[0] *= 0.3  # a ray with acc < 0.6 (depth clamp)
    tdist = np.sort(rng.uniform(0.2, 6.0, (r, s + 1)), -1).astype(np.float32)
    far = np.full((r, 1), 8.0, np.float32)
    bg_rgbs = (np.float32(0.5) if bg == "constant"
               else rng.uniform(0, 1, (r, 3)).astype(np.float32))
    got = trendering.volumetric_rendering(
        _t(rgbs), _t(w), _t(tdist), _t(bg_rgbs), _t(far), True,
        extras={"normals": _t(normals), "none": None})
    want = jrendering.volumetric_rendering(
        jnp.asarray(rgbs), jnp.asarray(w), jnp.asarray(tdist),
        jnp.asarray(bg_rgbs), jnp.asarray(far), True,
        extras={"normals": jnp.asarray(normals), "none": None})
    cm = trendering.volumetric_rendering_cm(
        _t(rgbs.transpose(2, 0, 1)), _t(w), _t(tdist), _t(bg_rgbs), _t(far),
        True, extras={"normals": _t(normals.transpose(2, 0, 1))})
    assert set(got) == set(want) == set(cm)
    for k in want:
        _close(got[k], want[k], rtol=1e-5, atol=1e-5)
        _close(cm[k], got[k], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,v", [("icosahedron", 2), ("octahedron", 3)])
def test_geopoly_is_the_jax_packages(shape, v):
    for sym in (True, False):
        np.testing.assert_array_equal(
            tgeopoly.generate_basis(shape, v, remove_symmetries=sym),
            jgeopoly.generate_basis(shape, v, remove_symmetries=sym))
    with pytest.raises(ValueError):
        tgeopoly.generate_basis("cube", 1)


def test_ref_utils(rng):
    v = rng.normal(size=(20, 3)).astype(np.float32)
    n = rng.normal(size=(20, 3)).astype(np.float32)
    n_unit = n / np.linalg.norm(n, axis=-1, keepdims=True)
    _close(tref.reflect(_t(v), _t(n_unit)),
           jref.reflect(jnp.asarray(v), jnp.asarray(n_unit)))
    _close(tref.l2_normalize(_t(n)), jref.l2_normalize(jnp.asarray(n)))
    _close(tref.l2_normalize(torch.zeros(2, 3)),
           jref.l2_normalize(jnp.zeros((2, 3))))
    w = rng.uniform(0, 1, 20).astype(np.float32)
    m2 = tref.l2_normalize(_t(n + 0.3 * v))
    _close(tref.compute_weighted_mae(_t(w), _t(n_unit), m2),
           jref.compute_weighted_mae(jnp.asarray(w), jnp.asarray(n_unit),
                                     jnp.asarray(m2.numpy().copy())), rtol=1e-5,
           atol=1e-4)
    kappa = rng.uniform(0, 1, (20, 1)).astype(np.float32)
    for deg in (1, 3, 4):
        got, grads, probe = _grad_t(tref.generate_ide_fn(deg), n_unit, kappa)
        want, gj = _grad_j(jref.generate_ide_fn(deg), probe, n_unit, kappa)
        _close(got, want, rtol=1e-5, atol=1e-5)
        for g, w_ in zip(grads, gj):
            _close(g, w_, rtol=1e-4, atol=1e-4)
        _close(tref.generate_dir_enc_fn(deg)(_t(n_unit)),
               jref.generate_dir_enc_fn(deg)(jnp.asarray(n_unit)),
               rtol=1e-5, atol=1e-5)
    # deg 5 sums z^16-order terms with alternating coefficients ~1e5: both
    # f32 sides land ~1e-4 to 1e-2 off a float64 evaluation.  The port's
    # error is held to at most twice the JAX package's plus 1e-6.
    ide64 = tref.generate_ide_fn(5)(_t(n_unit).double(),
                                    _t(kappa).double()).numpy()
    err_t = np.abs(tref.generate_ide_fn(5)(_t(n_unit), _t(kappa)).numpy()
                   - ide64).max()
    err_j = np.abs(np.asarray(jref.generate_ide_fn(5)(
        jnp.asarray(n_unit), jnp.asarray(kappa))) - ide64).max()
    assert err_t <= 2 * err_j + 1e-6
    with pytest.raises(ValueError):
        tref.generate_ide_fn(6)


def _spec():
    return thash.HashGridSpec(num_levels=4, level_dim=4, base_resolution=8,
                              desired_resolution=64, log2_hashmap_size=10)


def _jspec():
    return jhash.HashGridSpec(**dataclasses.asdict(_spec()))


def test_reference_encoder_matches_jax(rng):
    """encode / encode_level forward, the table gradient (one launch of
    K1's plain entry on a card, index_add_ here) and the points'
    gradient."""
    spec = _spec()
    table = rng.normal(0, 0.5, (spec.level_dim, spec.table_rows)).astype(
        np.float32)
    x = rng.uniform(-1.1, 1.1, (7, 9, 3)).astype(np.float32)  # some OOB
    got, (g_x, g_table), probe = _grad_t(
        lambda xx, tb: thash.encode(xx, tb, spec), x, table)
    want, (w_x, w_table) = _grad_j(
        lambda xx, tb: jhash.encode(xx, tb, _jspec()), probe, x, table)
    assert got.shape == (7, 9, spec.num_levels, spec.level_dim)
    _close(got, want)
    scale = float(np.abs(np.asarray(w_table)).max())
    _close(g_table, w_table, rtol=1e-5, atol=1e-6 * scale)
    _close(g_x, w_x, rtol=1e-4, atol=1e-4)
    assert np.asarray(w_table).any()
    x01 = ((x + 1) / 2).reshape(-1, 3)
    for level in range(spec.num_levels):
        _close(thash.encode_level(_t(x01), _t(table), spec, level),
               jhash.encode_level(jnp.asarray(x01), jnp.asarray(table),
                                  _jspec(), level))


def test_reference_encoder_backward_is_k1_plain(rng, monkeypatch):
    """The table gradient is one call of scatter.scatter_add_cm over every
    level's corner updates, and the lookups are one take_cm a level."""
    spec = _spec()
    calls = {"scatter": [], "take": 0}
    scatter_add_cm, take_cm = thash.scatter.scatter_add_cm, \
        thash.gather.take_cm

    def scatter_spy(values, idx, num_rows, out=None):
        calls["scatter"].append(values.shape)
        return scatter_add_cm(values, idx, num_rows, out)

    def take_spy(*args, **kwargs):
        calls["take"] += 1
        return take_cm(*args, **kwargs)

    monkeypatch.setattr(thash.scatter, "scatter_add_cm", scatter_spy)
    monkeypatch.setattr(thash.gather, "take_cm", take_spy)
    table = _t(rng.normal(size=(spec.level_dim, spec.table_rows)).astype(
        np.float32)).requires_grad_()
    x = _t(rng.uniform(-1, 1, (50, 3)).astype(np.float32))
    thash.encode(x, table, spec).sum().backward()
    assert calls["take"] == spec.num_levels
    assert calls["scatter"] == [(spec.level_dim, spec.num_levels * 8 * 50)]


def test_tv_loss_and_level_sq_means(rng):
    """tv_loss's value and table gradient against the JAX function and the
    CUDA kernel's anchor update (tests/test_hashgrid.py's oracle);
    level_sq_means against the JAX function."""
    spec = test_hashgrid.small_spec()
    tspec = thash.HashGridSpec(**dataclasses.asdict(spec))
    table = np.asarray(jhash.init_table(jax.random.PRNGKey(11), spec)) * 100
    x = rng.uniform(-1.2, 1.2, (24, 3)).astype(np.float32)
    want, gj = jax.value_and_grad(lambda tb: jhash.tv_loss(
        tb, spec, x=jnp.asarray(x), weight=1e-3))(jnp.asarray(table))
    tt_ = _t(table).requires_grad_()
    got = thash.tv_loss(tt_, tspec, x=_t(x), weight=1e-3)
    got.backward()
    _close(got.detach(), want, rtol=1e-5, atol=0)
    _close(tt_.grad, gj, rtol=1e-5, atol=1e-12)
    oracle = test_hashgrid._oracle_tv_grad(x, jnp.asarray(table), spec,
                                           weight=1e-3)
    np.testing.assert_allclose(tt_.grad.numpy(), oracle, rtol=2e-4,
                               atol=1e-10)
    loss = thash.tv_loss(_t(table), tspec, num_points=256,
                         generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(loss)
    with pytest.raises(ValueError):
        thash.tv_loss(_t(table), tspec)
    _close(thash.level_sq_means(_t(table), tspec),
           jhash.level_sq_means(jnp.asarray(table), spec), rtol=1e-5, atol=0)


def test_inner_outer_backward_matches_jax_and_repeats(rng):
    """stepfun.inner_outer (the interlevel loss's lookup) with its one-hot
    backward: values and gradient against the JAX function, and two
    backward passes bitwise equal."""
    t0 = np.sort(rng.uniform(0, 1, (6, 33)), -1).astype(np.float32)
    t1 = np.sort(rng.uniform(0, 1, (6, 129)), -1).astype(np.float32)
    t1[:, 0], t1[:, -1] = 0.0, 1.0
    y1 = rng.dirichlet(np.ones(128), 6).astype(np.float32)
    grads = []
    for _ in range(2):
        yt = _t(y1).requires_grad_()
        inner, outer = tstepfun.inner_outer(_t(t0), _t(t1), yt)
        (inner.sum() + 2 * outer.sum()).backward()
        grads.append(yt.grad)
    (inner_j, outer_j), vjp = jax.vjp(
        lambda y: jstepfun.inner_outer(jnp.asarray(t0), jnp.asarray(t1), y),
        jnp.asarray(y1))
    _close(inner, inner_j)
    _close(outer, outer_j)
    gj = vjp((jnp.ones_like(inner_j), 2 * jnp.ones_like(outer_j)))[0]
    _close(grads[0], gj, rtol=1e-5, atol=1e-5)
    assert torch.equal(grads[0], grads[1])

"""The port's step-function, coordinate, rendering and gradient-scaling ops
(``ucnerf_tpu_torch/ops``) against the JAX package's, on the same numpy
inputs.

Tolerances: the two sides run the same f32 formulas, so they differ only in
summation order and transcendental ulps (rtol 1e-5, atol 1e-6).  Index
results (searchsorted) must agree exactly, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ucnerf_tpu.ops import coord as jcoord
from ucnerf_tpu.ops import grad_scaler as jgs
from ucnerf_tpu.ops import mathx as jmathx
from ucnerf_tpu.ops import rendering as jrendering
from ucnerf_tpu.ops import stepfun as jstepfun
from ucnerf_tpu_torch.ops import coord as tcoord
from ucnerf_tpu_torch.ops import grad_scaler as tgs
from ucnerf_tpu_torch.ops import mathx as tmathx
from ucnerf_tpu_torch.ops import rendering as trendering
from ucnerf_tpu_torch.ops import stepfun as tstepfun

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _sorted_t(rng, rays, n, ties=True):
    t = np.sort(rng.uniform(0, 1, (rays, n)), axis=-1)
    if ties:  # repeated fenceposts: zero-width bins
        t[:, n // 3] = t[:, n // 3 - 1]
        t[:, 1] = t[:, 0]
    return t.astype(np.float32)


def test_searchsorted_ties_and_clamping(rng):
    a = _sorted_t(rng, 5, 12)
    v = np.concatenate([a[:, ::2],                      # exact ties
                        rng.uniform(-0.5, 1.5, (5, 9)),  # out of range
                        rng.uniform(0, 1, (5, 7))], axis=-1).astype(np.float32)
    lo_t, hi_t = tstepfun.searchsorted(_t(a), _t(v))
    lo_j, hi_j = jstepfun.searchsorted(jnp.asarray(a), jnp.asarray(v))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


def test_sorted_interp_ties_and_clamping(rng):
    xp = _sorted_t(rng, 4, 10)
    fp = np.cumsum(rng.uniform(0, 1, (4, 10)), -1).astype(np.float32)
    x = np.concatenate([xp[:, ::3], rng.uniform(-1, 2, (4, 20))],
                       axis=-1).astype(np.float32)
    _close(tmathx.sorted_interp(_t(x), _t(xp), _t(fp)),
           jmathx.sorted_interp(jnp.asarray(x), jnp.asarray(xp),
                                jnp.asarray(fp)))


def test_pdf_weight_roundtrip_and_integrate(rng):
    t = _sorted_t(rng, 6, 17)
    w = rng.dirichlet(np.ones(16), 6).astype(np.float32)
    _close(tstepfun.weight_to_pdf(_t(t), _t(w)),
           jstepfun.weight_to_pdf(jnp.asarray(t), jnp.asarray(w)), rtol=1e-5,
           atol=1e-3)  # zero-width bins divide by EPS
    p = rng.uniform(0, 2, (6, 16)).astype(np.float32)
    _close(tstepfun.pdf_to_weight(_t(t), _t(p)),
           jstepfun.pdf_to_weight(jnp.asarray(t), jnp.asarray(p)))
    _close(tstepfun.integrate_weights(_t(w)),
           jstepfun.integrate_weights(jnp.asarray(w)))


@pytest.mark.parametrize("renormalize", [False, True])
def test_max_dilate_weights(rng, renormalize):
    t = _sorted_t(rng, 5, 17, ties=False)
    w = rng.dirichlet(np.ones(16), 5).astype(np.float32)
    got = tstepfun.max_dilate_weights(_t(t), _t(w), 0.03, domain=(0.0, 1.0),
                                      renormalize=renormalize)
    want = jstepfun.max_dilate_weights(jnp.asarray(t), jnp.asarray(w), 0.03,
                                       domain=(0.0, 1.0),
                                       renormalize=renormalize)
    for g, wnt in zip(got, want):
        _close(g, wnt)


def test_invert_cdf_and_sample(rng):
    t = _sorted_t(rng, 4, 9)
    logits = rng.normal(size=(4, 8)).astype(np.float32)
    logits[:, 2] = -np.inf  # masked bin, as the proposal loop makes
    u = np.sort(rng.uniform(0, 1, (4, 11)), -1).astype(np.float32)
    _close(tstepfun.invert_cdf(_t(u), _t(t), _t(logits)),
           jstepfun.invert_cdf(jnp.asarray(u), jnp.asarray(t),
                               jnp.asarray(logits)))
    for center in (False, True):
        _close(tstepfun.sample(_t(t), _t(logits), 13,
                               deterministic_center=center),
               jstepfun.sample(None, jnp.asarray(t), jnp.asarray(logits), 13,
                               deterministic_center=center))


def test_linspace_matches_jnp():
    """Same formula as jnp.linspace; XLA may reassociate the product by the
    constant stop, which moves a few entries by one ulp."""
    for start, stop, num in ((0.0, 1.0 - tmathx.EPS, 32),
                             (1 / 256, 1 - 1 / 256 - tmathx.EPS, 128),
                             (0.0, 1.0, 120)):
        got = tmathx.linspace(start, stop, num).numpy()
        want = np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)
        assert got[0] == want[0] and got[-1] == want[-1]


def test_sample_intervals(rng):
    t = _sorted_t(rng, 6, 9)
    logits = rng.normal(size=(6, 8)).astype(np.float32)
    got = tstepfun.sample_intervals(_t(t), _t(logits), 16, domain=(0.0, 1.0))
    want = jstepfun.sample_intervals(None, jnp.asarray(t),
                                     jnp.asarray(logits), 16,
                                     domain=(0.0, 1.0))
    _close(got, want)
    with pytest.raises(ValueError):
        tstepfun.sample_intervals(_t(t), _t(logits), 1)


def test_weighted_percentile(rng):
    t = _sorted_t(rng, 5, 11)
    w = rng.dirichlet(np.ones(10), 5).astype(np.float32)
    ps = [5, 50, 95]
    _close(tstepfun.weighted_percentile(_t(t), _t(w), ps),
           jstepfun.weighted_percentile(jnp.asarray(t), jnp.asarray(w), ps))


@pytest.mark.parametrize("fn,lam", [
    (None, None), ("piecewise", None), ("power_transformation", -1.5),
    ("reciprocal", None), ("log", None), ("sqrt", None)])
def test_construct_ray_warps(rng, fn, lam):
    near = rng.uniform(0.1, 0.5, (7, 1)).astype(np.float32)
    far = rng.uniform(2.0, 8.0, (7, 1)).astype(np.float32)
    s = np.sort(rng.uniform(0, 1, (7, 9)), -1).astype(np.float32)
    t_to_s, s_to_t = tcoord.construct_ray_warps(fn, _t(near), _t(far), lam)
    jt_to_s, js_to_t = jcoord.construct_ray_warps(
        fn, jnp.asarray(near), jnp.asarray(far), lam)
    tt = s_to_t(_t(s))
    _close(tt, js_to_t(jnp.asarray(s)), rtol=2e-5, atol=1e-5)
    _close(t_to_s(tt), jt_to_s(jnp.asarray(tt.numpy().copy())), rtol=2e-5,
           atol=1e-5)


@pytest.mark.parametrize("stop_grads", [True, False])
def test_contract_mean_std_cm(rng, stop_grads):
    x = (rng.normal(size=(3, 6, 5, 7)) * 3).astype(np.float32)
    x[:, 0, 0, 0] = 0.0  # |x| clamped at EPS
    std = rng.uniform(0.01, 0.2, (6, 5, 7)).astype(np.float32)
    xt = _t(x).requires_grad_()
    z, s = tcoord.track_linearize_cm("contract", xt, _t(std),
                                     stop_grads=stop_grads)
    zj, sj = jcoord.track_linearize_cm("contract", jnp.asarray(x),
                                       jnp.asarray(std), stop_grads=stop_grads)
    _close(z.detach(), zj)
    _close(s.detach(), sj, rtol=3e-6, atol=1e-7)  # pow(., 1/3) vs cbrt
    assert z.requires_grad == (not stop_grads)


def test_pos_enc(rng):
    x = rng.normal(size=(9, 3)).astype(np.float32)
    for ident in (True, False):
        _close(tcoord.pos_enc(_t(x), 0, 4, append_identity=ident),
               jcoord.pos_enc(jnp.asarray(x), 0, 4, append_identity=ident),
               rtol=1e-5, atol=2e-6)


def _rays(rng, r):
    d = rng.normal(size=(r, 3)).astype(np.float32)
    cam = (d + 0.1 * rng.normal(size=(r, 3))).astype(np.float32)
    return dict(origins=rng.normal(size=(r, 3)).astype(np.float32),
                directions=d,
                cam_dirs=cam / np.linalg.norm(cam, axis=-1, keepdims=True),
                radii=rng.uniform(1e-3, 1e-2, (r, 1)).astype(np.float32))


def test_cast_rays_cm_with_rand_vec(rng):
    r, s = 6, 9
    rays = _rays(rng, r)
    tdist = np.sort(rng.uniform(0.2, 6.0, (r, s + 1)), -1).astype(np.float32)
    rand_vec = rng.normal(size=(r, 3)).astype(np.float32)
    got = trendering.cast_rays_cm(_t(tdist), *(_t(rays[k]) for k in (
        "origins", "directions", "cam_dirs", "radii")), _t(rand_vec),
        std_scale=0.5)
    want = jrendering.cast_rays_cm(None, jnp.asarray(tdist), *(
        jnp.asarray(rays[k]) for k in ("origins", "directions", "cam_dirs",
                                       "radii")), std_scale=0.5,
        rand_vec=jnp.asarray(rand_vec))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("opaque", [False, True])
def test_compute_alpha_weights(rng, opaque):
    r, s = 5, 12
    density = rng.uniform(0, 3, (r, s)).astype(np.float32)
    tdist = np.sort(rng.uniform(0, 4, (r, s + 1)), -1).astype(np.float32)
    dirs = rng.normal(size=(r, 3)).astype(np.float32)
    got = trendering.compute_alpha_weights(_t(density), _t(tdist), _t(dirs),
                                           opaque_background=opaque)
    want = jrendering.compute_alpha_weights(
        jnp.asarray(density), jnp.asarray(tdist), jnp.asarray(dirs),
        opaque_background=opaque)
    for g, w in zip(got, want):
        _close(g, w)


def test_volumetric_rendering_cm_with_depth_clamp(rng):
    r, s = 8, 10
    tdist = np.sort(rng.uniform(0.1, 7, (r, s + 1)), -1).astype(np.float32)
    w = rng.dirichlet(np.ones(s), r).astype(np.float32)
    w *= rng.uniform(0.2, 1.0, (r, 1)).astype(np.float32)  # some acc < 0.6
    w[0] *= 0.0
    rgbs = rng.uniform(0, 1, (3, r, s)).astype(np.float32)
    far = np.full((r, 1), 8.0, np.float32)
    got = trendering.volumetric_rendering_cm(_t(rgbs), _t(w), _t(tdist), 0.5,
                                             _t(far), compute_extras=True)
    want = jrendering.volumetric_rendering_cm(
        jnp.asarray(rgbs), jnp.asarray(w), jnp.asarray(tdist), 0.5,
        jnp.asarray(far), compute_extras=True)
    assert set(got) == set(want)
    acc = got["acc"].numpy()
    assert (acc < 0.6).any() and (acc >= 0.6).any()
    np.testing.assert_array_equal(got["depth"].numpy()[acc < 0.6], 300.0)
    for k in want:
        _close(got[k], want[k], rtol=1e-5, atol=2e-6)


def test_scale_gradients_by_distance(rng):
    rgb = rng.normal(size=(3, 4, 5)).astype(np.float32)
    density = rng.normal(size=(4, 5)).astype(np.float32)
    dist = rng.uniform(0, 2, (4, 5)).astype(np.float32)
    coef_rgb = rng.normal(size=rgb.shape).astype(np.float32)
    coef_d = rng.normal(size=density.shape).astype(np.float32)

    def jloss(a, b):
        a2, b2 = jgs.scale_gradients_by_distance(a, b, jnp.asarray(dist))
        return (a2 * coef_rgb).sum() + (b2 * coef_d).sum()

    ja, jb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(rgb),
                                             jnp.asarray(density))
    ta, tb = _t(rgb).requires_grad_(), _t(density).requires_grad_()
    a2, b2 = tgs.scale_gradients_by_distance(ta, tb, _t(dist))
    np.testing.assert_array_equal(a2.detach().numpy(), rgb)
    np.testing.assert_array_equal(b2.detach().numpy(), density)
    ((a2 * _t(coef_rgb)).sum() + (b2 * _t(coef_d)).sum()).backward()
    _close(ta.grad, ja)
    _close(tb.grad, jb)

"""The port's visualization module (``ucnerf_tpu_torch/utils/vis.py``) and
``stepfun.resample`` against the JAX package's.

Tolerances:
- the turbo LUT, ``visualize_cmap`` and ``visualize_suite``: bitwise (the
  same numpy on the same inputs; the LUT is a constant held against
  matplotlib's ``turbo``);
- ``stepfun.resample``: rtol 1e-5, atol 1e-6.  Its outputs are differences
  of interpolated running sums, and torch's CPU ``cumsum`` adds in another
  order than XLA's: both sides lie within 8e-7 of the float64 result on
  running sums of up to 16, and the ``use_avg`` quotient by the interval
  width lifts that to ~3e-5 of the float64 result on each side, ~7e-6
  between them;
- ``visualize_rays`` and ``visualize_ray_histograms``, which go through it:
  atol 5e-5 on values in [0, 1] (1/80 of an 8-bit level), and the red null
  color on the same bins;
- ``save_image_u8``: the PNG decoded with Pillow equals, bitwise, the JAX
  function's Pillow-written file decoded the same way.
"""

import matplotlib
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ucnerf_tpu.ops import stepfun as jstepfun
from ucnerf_tpu.utils import vis as jvis
from ucnerf_tpu_torch.ops import stepfun as tstepfun
from ucnerf_tpu_torch.utils import vis as tvis

torch.set_num_threads(2)

RAYS_ATOL = 5e-5


def test_turbo_lut_is_matplotlibs():
    want = np.asarray(matplotlib.colormaps["turbo"](np.linspace(0, 1, 256)))
    got = tvis._colormap_lut("turbo")
    assert got.shape == (256, 3) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want[:, :3])
    np.testing.assert_array_equal(got, jvis._colormap_lut("turbo"))
    # Other names still go to matplotlib.
    np.testing.assert_array_equal(tvis._colormap_lut("viridis"),
                                  jvis._colormap_lut("viridis"))


@pytest.mark.parametrize("use_avg", [False, True])
def test_resample_matches_jax_package(rng, use_avg):
    n, s, r = 5, 12, 33
    tp = np.sort(rng.uniform(0, 1, (n, s + 1)), axis=-1).astype(np.float32)
    vp = rng.uniform(0, 2, (n, s)).astype(np.float32)
    t = np.sort(rng.uniform(-0.1, 1.1, (n, r + 1)), axis=-1).astype(
        np.float32)
    got = tstepfun.resample(torch.from_numpy(t), torch.from_numpy(tp),
                            torch.from_numpy(vp), use_avg=use_avg).numpy()
    want = np.asarray(jstepfun.resample(jnp.asarray(t), jnp.asarray(tp),
                                        jnp.asarray(vp), use_avg=use_avg))
    assert got.shape == (n, r)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _rendering(rng, h=8, w=12):
    return {
        "rgb": rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32),
        "acc": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "depth": rng.uniform(1, 5, (h, w)).astype(np.float32),
        "distance_mean": rng.uniform(1, 5, (h, w)).astype(np.float32),
        "distance_median": rng.uniform(1, 5, (h, w)).astype(np.float32),
        "normals": rng.normal(0, 1, (h, w, 3)).astype(np.float32),
    }


def test_visualize_cmap_and_suite_match_jax_package(rng):
    r = _rendering(rng, 16, 24)
    for kw in ({}, {"lo": 1.5, "hi": 4.0}, {"colormap": None},
               {"matte_background": False}):
        np.testing.assert_array_equal(
            tvis.visualize_cmap(r["depth"], r["acc"], **kw),
            jvis.visualize_cmap(r["depth"], r["acc"], **kw), err_msg=str(kw))
    got, want = tvis.visualize_suite(r), jvis.visualize_suite(r)
    assert set(got) == set(want) == {"color", "depth", "depth_matted",
                                     "depth_median", "acc", "normals"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _history(rng, n=6):
    """A two-level ray history (proposal without rgb, then NeRF)."""
    history = []
    for ns, with_rgb in ((16, False), (8, True)):
        deltas = rng.uniform(0.01, 0.1, (n, ns)).astype(np.float32)
        sdist = np.concatenate([np.zeros((n, 1), np.float32),
                                np.cumsum(deltas, -1)], -1)
        sdist /= sdist.max()
        weights = rng.dirichlet(np.ones(ns), n).astype(np.float32)
        rgb = rng.uniform(0, 1, (3, n, ns)).astype(np.float32)
        history.append({"sdist": sdist, "weights": weights,
                        "rgb": rgb if with_rgb else None})
    return history


@pytest.mark.parametrize("accumulate", [False, True])
def test_visualize_rays_matches_jax_package(rng, accumulate):
    history = _history(rng)
    dist = [h["sdist"] for h in history]
    weights = [h["weights"] for h in history]
    rgbs = [rng.uniform(0, 1, w.shape + (3,)).astype(np.float32)
            for w in weights]
    kw = dict(accumulate=accumulate, renormalize=accumulate, resolution=64)
    img, alpha = tvis.visualize_rays(dist, (0.0, 1.0), weights, rgbs, **kw)
    jimg, jalpha = jvis.visualize_rays(dist, (0.0, 1.0), weights, rgbs, **kw)
    assert img.shape == jimg.shape == (6 * 3 - 1, 64, 3)
    np.testing.assert_allclose(img, jimg, atol=RAYS_ATOL, rtol=0)
    np.testing.assert_allclose(alpha, jalpha, atol=RAYS_ATOL, rtol=0)


def test_visualize_ray_histograms_matches_jax_package(rng):
    history = _history(rng)
    got = tvis.visualize_ray_histograms(history, num_rays=4, repeat=2)
    want = jvis.visualize_ray_histograms(history, num_rays=4, repeat=2)
    assert set(got) == set(want) == {"ray_colors", "ray_weights"}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], atol=RAYS_ATOL, rtol=0,
                                   err_msg=k)
    red = lambda im: ((im[..., 0] == 1) & (im[..., 1] == 0)
                      & (im[..., 2] == 0))
    assert red(got["ray_weights"]).any()
    np.testing.assert_array_equal(red(got["ray_weights"]),
                                  red(want["ray_weights"]))


@pytest.mark.parametrize("shape", [(7, 9, 3), (5, 11), (6, 4, 4), (1, 1, 3)])
def test_save_image_u8_decodes_as_the_jax_packages_png(rng, tmp_path, shape):
    img = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    img.flat[:2] = [1.0, 254.5 / 255]  # the top value and a rounding edge
    tvis.save_image_u8(tmp_path / "port.png", img)
    jvis.save_image_u8(tmp_path / "jax.png", img)
    with Image.open(tmp_path / "port.png") as a, \
            Image.open(tmp_path / "jax.png") as b:
        assert a.format == "PNG" and a.mode == b.mode and a.size == b.size
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        tvis.encode_png_u8(np.zeros((2, 2, 2), np.uint8))

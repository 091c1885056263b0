"""The port's host-side data layer (``ucnerf_tpu_torch/data``, ``utils/image``,
``cli/eval._eval_camidx``) against the JAX package's.

Both sides are the same numpy code over the same seeds, so arrays are held
bitwise equal (``assert_array_equal``).  The one tensor function,
``warp_image_torch``, is held to ``warp_image_jax`` at rtol 1e-5 with an atol
of 1e-3 px (f32 on both sides; the projection divides by depths down to
~1): masks may differ only where a pixel lies within that atol of the image
border.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_data_waymo as waymo_fixture
from ucnerf_tpu import configs as jconfigs
from ucnerf_tpu.cli import eval as jeval
from ucnerf_tpu.data import cameras as jcameras
from ucnerf_tpu.data import datasets as jdatasets
from ucnerf_tpu.data import warping as jwarping
from ucnerf_tpu.utils import image as jimage
from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch.cli import eval as teval
from ucnerf_tpu_torch.data import cameras as tcameras
from ucnerf_tpu_torch.data import datasets as tdatasets
from ucnerf_tpu_torch.data import warping as twarping
from ucnerf_tpu_torch.utils import image as timage

ARRAYS = ("images", "camtoworlds", "pixtocams", "sky_segments", "disp_images",
          "virtual_poses", "virtual_pixtocams")


def _same_arrays(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.n_examples, a.height, a.width, a.cam_num) == (
        b.n_examples, b.height, b.width, b.cam_num)


def _same_batch(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _pair(split, **over):
    return (jdatasets.load_dataset(split, jconfigs.tiny(**over)),
            tdatasets.load_dataset(split, tconfigs.tiny(**over)))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("virtual", [False, True])
def test_synthetic_dataset_matches_jax_package(split, virtual):
    """Scene arrays, a sampled batch (with the virtual-view fifth when on)
    and a whole image's rays."""
    jd, td = _pair(split, virtual_poses=virtual)
    _same_arrays(jd, td)
    assert (td.virtual_poses is not None) == (virtual and split == "train")
    _same_batch(jd.sample_batch(np.random.default_rng(5), 40),
                td.sample_batch(np.random.default_rng(5), 40))
    _same_batch(jd.image_batch(jd.n_examples - 1),
                td.image_batch(td.n_examples - 1))


def test_synthetic_quality_preset_loads_the_same_scene():
    over = dict(training_views=4, synthetic_height=32, synthetic_width=48)
    jd = jdatasets.load_dataset("train", jconfigs.synthetic_quality(**over))
    td = tdatasets.load_dataset("train", tconfigs.synthetic_quality(**over))
    _same_arrays(jd, td)
    assert td.images.shape == (4, 32, 48, 3)


def test_rejection_sampling_of_virtual_rays_matches(rng):
    """The fall-back path of ``_sample_virtual`` (no correspondence pool)."""
    jd, td = _pair("train", virtual_poses=True)
    jd._warp_pool = td._warp_pool = None
    a = jd._sample_virtual(np.random.default_rng(3), 25)
    b = td._sample_virtual(np.random.default_rng(3), 25)
    assert a is not None
    _same_batch(a, b)


def test_warping_functions_match_jax_package():
    jd, td = _pair("train", virtual_poses=True)
    k = np.tile(np.linalg.inv(td.pixtocams[0])[None], (td.n_examples, 1, 1))
    for a, b in zip(
            jwarping.generate_virtual_poses(jd.camtoworlds, k,
                                            np.random.default_rng(1)),
            twarping.generate_virtual_poses(td.camtoworlds, k,
                                            np.random.default_rng(1))):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jwarping.GL_TO_CV, twarping.GL_TO_CV)
    args = (td.camtoworlds[1] @ twarping.GL_TO_CV,
            td.virtual_poses[5] @ twarping.GL_TO_CV, td.disp_images[1], k[0])
    for a, b in zip(jwarping.warp_image(*args), twarping.warp_image(*args)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jwarping.warp_depth(*args),
                                  twarping.warp_depth(*args))
    pools = [lib.precompute_correspondence_pool(
        d, np.random.default_rng(2), pool_per_pair=64, max_pairs=7)
        for lib, d in ((jwarping, jd), (twarping, td))]
    _same_batch(*pools)
    assert len(pools[1]["ref_idx"]) > 0


def test_warp_image_torch_matches_warp_image_jax():
    _, td = _pair("train", virtual_poses=True)
    k = np.linalg.inv(td.pixtocams[0]).astype(np.float32)
    ref = (td.camtoworlds[1] @ twarping.GL_TO_CV).astype(np.float32)
    src = (td.virtual_poses[12] @ twarping.GL_TO_CV).astype(np.float32)
    depth = td.disp_images[1]
    pix_j, mask_j = jwarping.warp_image_jax(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(depth),
        jnp.asarray(k))
    pix_t, mask_t = twarping.warp_image_torch(
        torch.from_numpy(ref), torch.from_numpy(src),
        torch.from_numpy(depth), torch.from_numpy(k))
    pix_j, mask_j = np.asarray(pix_j), np.asarray(mask_j)
    assert mask_j.any() and not mask_j.all()
    valid = depth > 0  # where depth is 0 the projection is 0 / 1e-9
    np.testing.assert_allclose(pix_t.numpy()[valid], pix_j[valid], rtol=1e-5,
                               atol=1e-3)
    ht, wd = depth.shape
    near_border = ((np.abs(pix_j[..., 0]) < 1e-3)
                   | (np.abs(pix_j[..., 0] - (wd - 0.5)) < 1e-3)
                   | (np.abs(pix_j[..., 1]) < 1e-3)
                   | (np.abs(pix_j[..., 1] - (ht - 0.5)) < 1e-3))
    np.testing.assert_array_equal(mask_t.numpy()[~near_border],
                                  mask_j[~near_border])
    # And the numpy version it twins.
    pix_n, mask_n = twarping.warp_image(ref, src, depth, k)
    np.testing.assert_allclose(pix_t.numpy()[valid], pix_n[valid], rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(mask_t.numpy()[~near_border],
                                  mask_n[~near_border])


def test_image_metrics_match_jax_package(rng):
    img = rng.uniform(0, 1, (24, 36, 3)).astype(np.float32)
    ref = np.clip(0.8 * img + 0.1 + rng.normal(0, 0.02, img.shape), 0,
                  1).astype(np.float32)
    for name, args in (("mse_to_psnr", (0.013,)), ("psnr_to_mse", (21.5,)),
                       ("ssim_to_dssim", (0.7,)), ("dssim_to_ssim", (0.2,)),
                       ("linear_to_srgb", (img,)), ("srgb_to_linear", (img,)),
                       ("downsample", (img, 4)), ("rgb_to_gray", (img,)),
                       ("ssim", (img, ref)), ("color_correct", (img, ref))):
        np.testing.assert_array_equal(getattr(timage, name)(*args),
                                      getattr(jimage, name)(*args),
                                      err_msg=name)
    got = timage.MetricHarness()(img, ref)
    assert got == jimage.MetricHarness()(img, ref)
    assert set(got) == {"psnr", "ssim"} and np.isfinite(got["psnr"])
    assert timage.MetricHarness()(img, ref, quantize=False) == \
        jimage.MetricHarness()(img, ref, quantize=False)
    with pytest.raises(ValueError):
        timage.downsample(img, 5)
    # A missing LPIPS weights file: no LPIPS, as in the JAX package
    # (tests/test_torch_lpips.py holds the metric itself).
    missing = "no-such-dir/vgg.npz"
    assert timage.MetricHarness(lpips_weights=missing)(img, ref) == \
        jimage.MetricHarness(lpips_weights=missing)(img, ref) == got


def test_eval_camidx_and_quaternion_match_jax_package(rng):
    cfg = tconfigs.tiny(training_views=40)
    for cam_num in (0, 1, 3):
        for idx in range(12):
            assert teval._eval_camidx(cfg, idx, cam_num) == \
                jeval._eval_camidx(cfg, idx, cam_num)
    assert teval._eval_camidx(cfg, 3, 3) == 21
    assert teval._eval_camidx(cfg, 11, 3) == 39  # clamped to the last latent
    q = rng.normal(size=4)
    np.testing.assert_array_equal(tcameras.quat_xyzw_to_rotmat(q),
                                  jcameras.quat_xyzw_to_rotmat(q))


@pytest.fixture(scope="module")
def segment(tmp_path_factory):
    """The JAX tests' miniature Waymo-style segment on disk."""
    pytest.importorskip("PIL")
    root = str(tmp_path_factory.mktemp("waymo_seg_port"))
    return root, waymo_fixture._make_segment(root, np.random.default_rng(0))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("variant", ["scenario", "virtual", "no_depth"])
def test_waymo_loader_matches_jax_package(segment, monkeypatch, split,
                                          variant):
    root, gt = segment
    for lib in (jdatasets, tdatasets):
        monkeypatch.setattr(lib.WaymoV2Dataset, "NUM_FRAMES",
                            waymo_fixture.N_FRAMES)
    kw = dict(dataset_loader="waymov2", data_dir=root,
              depth_dir=gt["depth_dir"], cam_type=6, factor=20,
              load_sky_segments=True, near=0.0, far=8.0)
    if variant == "virtual":
        kw["virtual_poses"] = True
    if variant == "no_depth":
        kw.update(depth_dir=None, load_sky_segments=False, cam_type=2)
    jd = jdatasets.load_dataset(split, jconfigs.Config(**kw))
    td = tdatasets.load_dataset(split, tconfigs.Config(**kw))
    _same_arrays(jd, td)
    assert jd.image_names == td.image_names
    _same_batch(jd.sample_batch(np.random.default_rng(9), 30),
                td.sample_batch(np.random.default_rng(9), 30))


def test_loaders_fail_on_a_missing_segment(tmp_path):
    for loader, cls in (("waymov2", tdatasets.WaymoV2Dataset),
                        ("nuscenes", tdatasets.NuScenesDataset)):
        assert tdatasets._LOADERS[loader] is cls
        cfg = tconfigs.Config(dataset_loader=loader, data_dir=str(tmp_path))
        with pytest.raises(FileNotFoundError):
            tdatasets.load_dataset("train", cfg)
    assert issubclass(tdatasets.NuScenesDataset, tdatasets.WaymoV2Dataset)
    assert (tdatasets.NuScenesDataset.NUM_FRAMES,
            tdatasets.NuScenesDataset.SKY_CLASS) == (
        jdatasets.NuScenesDataset.NUM_FRAMES,
        jdatasets.NuScenesDataset.SKY_CLASS)
    with pytest.raises(KeyError):
        tdatasets.load_dataset("train", dataclasses.replace(
            tconfigs.tiny(), dataset_loader="blender"))

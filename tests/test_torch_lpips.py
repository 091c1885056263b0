"""The port's LPIPS (``ucnerf_tpu_torch/utils/lpips.py``) against the JAX
package's, on synthetic VGG-16 weights written in the ``.npz`` layout of
``tools/convert_lpips_weights.py`` (the real weights are not in the
repository).  Tolerance rtol 1e-4: thirteen 3x3 convolutions in f32 with
another library's summation order.
"""

import sys

import numpy as np
import pytest
import torch

from ucnerf_tpu.utils import image as jimage
from ucnerf_tpu.utils.lpips import LPIPS as JLPIPS
from ucnerf_tpu_torch.utils import image as timage
from ucnerf_tpu_torch.utils.lpips import LPIPS as TLPIPS

sys.path.insert(0, "tools")
import convert_lpips_weights as conv  # noqa: E402

torch.set_num_threads(2)

RTOL = 1e-4


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    """A converted synthetic lpips state_dict (VGG-16 shapes)."""
    rng = np.random.default_rng(7)
    sd, cin, idx = {}, 3, 0
    for stage, convs in conv.VGG_CFG:
        for _ in range(convs):
            cout = conv.VGG_OUT_CHANNELS[idx]
            sd[f"net.slice{stage}.{idx}.weight"] = torch.from_numpy(
                rng.normal(0, np.sqrt(2 / (9 * cin)), (cout, cin, 3, 3))
                .astype(np.float32))
            sd[f"net.slice{stage}.{idx}.bias"] = torch.from_numpy(
                rng.normal(0, 0.01, (cout,)).astype(np.float32))
            cin = cout
            idx += 1
    for k, c in enumerate([64, 128, 256, 512, 512]):
        sd[f"lin{k}.model.1.weight"] = torch.from_numpy(
            np.abs(rng.normal(0, 0.1, (1, c, 1, 1))).astype(np.float32))
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz")
    np.savez(path, **conv.extract_arrays([sd]))
    return path


def _pair(rng, h=32, w=48, noise=0.2):
    img0 = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0, noise, img0.shape), 0, 1).astype(
        np.float32)
    return img0, img1


@pytest.mark.parametrize("size,noise", [((32, 48), 0.2), ((37, 21), 0.05)])
def test_lpips_matches_jax_package(weights_file, rng, size, noise):
    """Odd sizes too: the four 2x2 max-pools floor as flax's do."""
    img0, img1 = _pair(rng, *size, noise)
    ours, ref = TLPIPS.from_file(weights_file), JLPIPS.from_file(weights_file)
    got, want = ours(img0, img1), ref(img0, img1)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert ours(img0, img0) == pytest.approx(0.0, abs=1e-6)


def test_lpips_missing_file_is_none(tmp_path):
    assert TLPIPS.from_file(str(tmp_path / "absent.npz")) is None


def test_metric_harness_adds_lpips(weights_file, rng):
    img0, img1 = _pair(rng)
    got = timage.MetricHarness(lpips_weights=weights_file)(img0, img1)
    want = jimage.MetricHarness(lpips_weights=weights_file)(img0, img1)
    assert set(got) == set(want) == {"psnr", "ssim", "lpips"}
    assert got["psnr"] == want["psnr"] and got["ssim"] == want["ssim"]
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=RTOL)

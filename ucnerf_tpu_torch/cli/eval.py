"""Evaluation CLI (port of ``ucnerf_tpu/cli/eval.py``): only
``_eval_camidx``, which the training loop's test render needs, is ported;
the evaluation loop itself (``main``) is not yet."""

from __future__ import annotations


def _eval_camidx(config, test_idx, cam_num):
    """Map a test image to a training-view latent id for the brightness
    correction (the reference's remap (idx//3)*21+idx%3: test group g sits
    before 7 train frame-groups of `cam_num` cams each)."""
    cam_num = max(cam_num, 1)
    group = test_idx // cam_num
    cam = test_idx % cam_num
    return min(group * 7 * cam_num + cam, config.training_views - 1)

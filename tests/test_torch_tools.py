"""The port's user tools on the CPU at tiny sizes, against the JAX package:
``ucnerf_tpu_torch.tools.mvs_quality`` against ``tools/mvs_quality.py``'s
stages (``torch_mvs_quality_fixture.jax_pipeline``) from the same exported
weights, ``ucnerf_tpu_torch.tools.eval_ckpt_step`` against the port's
``cli.eval`` on a folder that holds only that step, and
``tools/train_log_report.py`` on a log of the port's ``cli.train``.

Tolerances of the MVS stages, on the same weights (the JAX CLI's initial
tiny cascade, and the same after 20 JAX training steps):
- every stage's depth map at rtol 2e-3 where both sides are valid
  (measured: 5.5e-4 per view at the initial weights, whose near-zero
  disparities make depth = 1 / disparity sensitive; 9.7e-5 trained), the
  network's f32 rounding (``tests/test_torch_mvs.py``) through 1 / x;
- which pixels are valid (depth > 0) at most ``MASK_FLIPS`` pixels a
  stage apart (a depth within rounding of the 50 m cut or of a fusion
  threshold; measured: 0), and the fused point counts at most that far
  apart (measured: equal);
- the tool's training from the JAX initial weights: each of its first 3
  losses at rtol 2e-4 of the JAX CLI's (measured 6.7e-5: Adam's first
  steps move each weight by ~lr x sign(g), and a gradient at rounding level,
  such as those behind the correlation encoders' ReLU, can take either
  sign; ``tests/test_torch_mvs.py`` holds one step's gradients and
  update).
``eval_ckpt_step`` and ``cli.eval`` render the same weights the same way:
their PSNR and SSIM are equal.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mvs_quality_fixture as mfx
from ucnerf_tpu_torch.cli import eval as cli_eval
from ucnerf_tpu_torch.cli import mvs_train
from ucnerf_tpu_torch.cli import train as cli_train
from ucnerf_tpu_torch.tools import eval_ckpt_step, mvs_quality

torch.set_num_threads(2)

ROOT = mfx.ROOT
CROP = (64, 96)
DEPTH_RTOL = 2e-3
MASK_FLIPS = 8
LOSS_RTOL = 2e-4
JAX_TRAIN_STEPS = 20
TOOL_STEPS = 3


@pytest.fixture(scope="module")
def mvs_weights(tmp_path_factory):
    """{label: (JAX tree, its export)} for the JAX CLI's initial tiny
    cascade and the same after JAX_TRAIN_STEPS JAX steps."""
    folder = str(tmp_path_factory.mktemp("mvs"))
    init = mfx.jax_init(CROP)
    with contextlib.redirect_stdout(io.StringIO()):
        losses, trained = mfx.jax_train(JAX_TRAIN_STEPS, CROP, folder)
    return {"random-init": (init, mfx.export_mvs(init, folder, "init")),
            "trained": (trained, mfx.export_mvs(trained, folder, "trained")),
            "losses": losses}


def _same_stages(got, want):
    (g_scores, g_points, g_depths), (w_scores, w_points, w_depths) = got, want
    assert set(g_depths) == set(w_depths) == set(mvs_quality.STAGES)
    for stage in mvs_quality.STAGES:
        a, b = g_depths[stage], w_depths[stage]
        assert a.shape == b.shape, stage
        flips = int(((a > 0) != (b > 0)).sum())
        assert flips <= MASK_FLIPS, (stage, flips)
        both = (a > 0) & (b > 0)
        np.testing.assert_allclose(a[both], b[both], rtol=DEPTH_RTOL,
                                   atol=0, err_msg=stage)
    assert abs(g_points - w_points) <= MASK_FLIPS, (g_points, w_points)
    return g_scores, w_scores


@pytest.mark.parametrize("label", ["random-init", "trained"])
def test_mvs_stages_match_the_jax_tool(mvs_weights, label):
    """Stages 2-4 of the port's tool on the same weights as the JAX
    tool's: per-view, multires and geo-fused depth maps, and the fused
    point count."""
    params, npz = mvs_weights[label]
    model = mvs_train.build_model(True, init=npz).eval()
    got = mvs_quality.pipeline(model, mvs_quality.eval_windows(CROP, CROP, 5),
                               CROP, "cpu")
    scores, _ = _same_stages(got, mfx.jax_pipeline(params, CROP))
    assert got[1] > 0
    if label == "trained":
        # Training has moved the per-view depth off the initial weights'.
        assert scores["per-view"][1] < 0.9


def test_mvs_quality_trains_from_the_jax_init(mvs_weights, tmp_path):
    """The whole tool from the JAX CLI's initial weights (``--init``): its
    training losses against the JAX CLI's, its random-init stages against
    the JAX tool's, and its table and JSON."""
    out = str(tmp_path / "mq.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = mvs_quality.main(["--steps", str(TOOL_STEPS), "--init",
                                mvs_weights["random-init"][1], "--device",
                                "cpu", "--json", out])
    np.testing.assert_allclose(res["losses"],
                               mvs_weights["losses"][:TOOL_STEPS],
                               rtol=LOSS_RTOL)
    init_scores = res["scores"]["random-init"]
    got = (init_scores[0], init_scores[1], res["depths"]["random-init"])
    _same_stages(got, mfx.jax_pipeline(mvs_weights["random-init"][0], CROP))
    text = buf.getvalue()
    for label in ("random-init", "TRAINED"):
        for stage in mvs_quality.STAGES:
            assert re.search(rf"{label} {stage} +[\d.]+ +[\d.]+ +[\d.]+",
                             text), (label, stage)
        assert f"{label} fused points: " in text
    with open(out) as f:
        saved = json.load(f)
    assert saved["losses"] == res["losses"]
    assert set(saved["scores"]) == {"random-init", "TRAINED"}


# The tiny preset with two test views.
CKPT_FLAGS = ["--tiny", "--device", "cpu", "-b", "Config.llffhold = 4"]


@pytest.fixture(scope="module")
def port_exp(tmp_path_factory):
    """A port cli.train run on the CPU that keeps its last two checkpoints
    (steps 2 and 4)."""
    exp = str(tmp_path_factory.mktemp("ckpts") / "exp")
    cli_train.main(CKPT_FLAGS + [
        "--max-steps", "4", "-b", f"Config.exp_name = {exp!r}",
        "-b", "Config.checkpoint_every = 2",
        "-b", "Config.checkpoints_total_limit = 2",
        "-b", "Config.train_render_every = 0"])
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["2", "4"]
    return exp


def test_eval_ckpt_step_scores_an_older_step_as_cli_eval(port_exp, tmp_path):
    """The tool on the older retained step equals cli.eval on a folder that
    holds only that step, view by view."""
    flags = CKPT_FLAGS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        step, scores = eval_ckpt_step.main(
            flags + ["-b", f"Config.exp_name = {port_exp!r}", "--step", "2",
                     "--indices", "0", "1"])
    assert step == 2
    only = str(tmp_path / "only")
    os.makedirs(os.path.join(only, "checkpoints"))
    shutil.copytree(os.path.join(port_exp, "checkpoints", "2"),
                    os.path.join(only, "checkpoints", "2"))
    cli_eval.main(flags + ["-b", f"Config.exp_name = {only!r}",
                           "--limit", "2"])
    for key in ("psnr", "ssim"):
        with open(os.path.join(only, f"{key}_2.txt")) as f:
            want = [float(v) for v in f.read().split()]
        assert [float(scores[i][key]) for i in (0, 1)] == want, key
    lines = buf.getvalue().splitlines()
    for i in (0, 1):
        assert (f"step 2 image {i}: psnr={scores[i]['psnr']:.3f} "
                f"ssim={scores[i]['ssim']:.4f}") in lines
    # The newest step scores otherwise: the step was staged, not the folder.
    with contextlib.redirect_stdout(io.StringIO()):
        _, newest = eval_ckpt_step.main(
            flags + ["-b", f"Config.exp_name = {port_exp!r}", "--step", "4"])
    assert newest[0]["psnr"] != scores[0]["psnr"]
    with pytest.raises(SystemExit, match="no checkpoint at step 3"):
        eval_ckpt_step.main(flags + ["-b", f"Config.exp_name = {port_exp!r}",
                                     "--step", "3"])


def _train_log(main, exp, device_flags):
    """A 4-step run, logged every step, rendered at step 4, saved every 2
    steps, then resumed to 6: its log_train.txt."""
    flags = ["--tiny"] + device_flags + [
        "-b", f"Config.exp_name = {exp!r}", "-b", "Config.print_every = 1",
        "-b", "Config.train_render_every = 4",
        "-b", "Config.checkpoint_every = 2"]
    for steps in (4, 6):
        main(flags + ["--max-steps", str(steps)])
    return os.path.join(exp, "log_train.txt")


def _report(log):
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "train_log_report.py"),
         log, "--max-steps", "6", "--lr-delay-steps", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_train_log_report_reads_a_port_log(tmp_path):
    """tools/train_log_report.py needs no port: on a log of the port's
    cli.train it reports the fields it reports on the JAX CLI's log of the
    same run (steps, checkpoints, test renders, the LR tail, the resume),
    the numbers aside."""
    from ucnerf_tpu.cli import train as jax_train

    port = _report(_train_log(cli_train.main, str(tmp_path / "port"),
                              ["--device", "cpu"]))
    jax = _report(_train_log(jax_train.main, str(tmp_path / "jax"), []))

    def fields(text):
        return [re.sub(r"[-+]?\d[\d.eE+-]*", "#", line)
                for line in text.splitlines()]

    assert fields(port) == fields(jax), (port, jax)
    assert "steps logged: 1..6 (6 windows), checkpoints: 3" in port
    assert "test renders: 1;" in port
    assert "resume at step 4:" in port and "(continuous)" in port

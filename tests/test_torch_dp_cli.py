"""The entry points on 2 real gloo ranks on the CPU, at the tiny preset:
``cli.train --multihost`` (one log, one checkpoint set, a resumed run
bitwise the uninterrupted one) and ``cli.eval`` under a 2-rank launch (the
metric files of a 1-process eval of the same checkpoint); and
``cli.train --multihost`` on 3 ranks with uneven shares of each
microbatch (UNEVEN: 102 rays in 6 microbatches of 17, 34 rays a rank
taken as shares of 6, 6, 6, 6, 5 and 5), trained and resumed.

Tolerances: the 2-rank training run against its own resumed copy is held
bitwise (every parameter, Adam moment and count).  The 2-rank eval against
the 1-process eval: every metric at rtol 1e-5 (the render differs by f32
ulps between the world sizes, ``tests/test_torch_dp.py``; PSNR and SSIM
move by far less than 1e-5 relative for that).
"""

import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from ucnerf_tpu_torch.cli import eval as cli_eval
from ucnerf_tpu_torch.cli import train as cli_train

from test_torch_parallel import launch_ranks, rendezvous

STEPS = 6
TRAIN = ["--tiny", "--device", "cpu", "--max-steps", str(STEPS),
         "-b", "Config.print_every = 2", "-b", "Config.train_render_every = 3",
         "-b", "Config.checkpoint_every = 3",
         "-b", "Config.checkpoints_total_limit = 2"]


UNEVEN = ["-b", "Config.batch_size = 102", "-b", "Config.microbatches = 6",
          "-b", "Config.train_render_every = 0"]


def _launch(module, folder, name, *argv, world=2):
    """`python -m module argv` as `world` ranks; returns their output."""
    work = folder / name
    work.mkdir()
    return launch_ranks(
        [sys.executable, "-m", module, "--dist-init-method",
         rendezvous(work), *argv], world)


def _train(folder, name, exp):
    return _launch("ucnerf_tpu_torch.cli.train", folder, name, "--multihost",
                   *TRAIN, "-b", f"Config.exp_name = {str(exp)!r}")


def _load(exp, step):
    payload = torch.load(os.path.join(exp, "checkpoints", str(step),
                                      "state.pt"), weights_only=True)
    out = {f"model.{k}": v for k, v in payload["model"].items()}
    for i, s in payload["adam"]["state"].items():
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = torch.as_tensor(v)
    out["step"] = torch.tensor(payload["step"])
    out["count"] = torch.tensor(payload["count"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 2-rank run of 6 steps, and a 2-rank run resumed from its step-3
    checkpoint to step 6."""
    tmp = tmp_path_factory.mktemp("dp_cli")
    straight = tmp / "straight"
    outs = _train(tmp, "run_straight", straight)
    resumed = tmp / "resumed"
    os.makedirs(resumed / "checkpoints")
    shutil.copytree(straight / "checkpoints" / "3",
                    resumed / "checkpoints" / "3")
    resumed_outs = _train(tmp, "run_resumed", resumed)
    return dict(tmp=tmp, straight=straight, resumed=resumed, outs=outs,
                resumed_outs=resumed_outs)


def test_two_rank_train_writes_once(runs):
    straight = runs["straight"]
    written = sorted(os.listdir(straight))
    assert "log_train.txt" in written and "checkpoints" in written
    assert not [f for f in written if f not in ("log_train.txt",
                                                "checkpoints")
                and not f.startswith("events.out.tfevents")]
    assert len([f for f in written if f.startswith("events.")]) <= 1
    assert sorted(os.listdir(straight / "checkpoints")) == ["3", "6"]
    log = (straight / "log_train.txt").read_text()
    assert "(rank 0 of 2, gloo)" in log and "[rank 1]" not in log
    # One line a logged step: 1, 2, 4, 6; the loss falls; two test renders.
    losses = [float(x) for x in re.findall(r"step \d+/6: loss=(\S+)", log)]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    renders = re.findall(r"test render 0: psnr=(\S+)", log)
    assert len(renders) == 2 and np.isfinite(float(renders[-1]))
    # The other rank logs to its own stdout, marked, and writes nothing.
    assert "[rank 1]: device: cpu (rank 1 of 2, gloo)" in runs["outs"]


def test_two_rank_train_resumes_bitwise(runs):
    log = (runs["resumed"] / "log_train.txt").read_text()
    assert "resumed from step 3" in log
    assert re.findall(r"step (\d+)/6", log) == ["4", "6"]
    a, b = _load(runs["straight"], STEPS), _load(runs["resumed"], STEPS)
    assert set(a) == set(b) and int(a["step"]) == STEPS
    for k in a:
        assert torch.equal(a[k], b[k]), k
    straight_log = (runs["straight"] / "log_train.txt").read_text()
    assert re.findall(r"step 6/6: (loss=\S+)", log) == \
        re.findall(r"step 6/6: (loss=\S+)", straight_log)
    # The step-6 test render, digit for digit.
    assert re.findall(r"test render 0: (psnr=\S+ ssim=\S+)", log) == \
        re.findall(r"test render 0: (psnr=\S+ ssim=\S+)", straight_log)[-1:]


def test_two_rank_train_differs_from_one_process(runs, tmp_path):
    """The ranks draw their own rays: 2 x 128 rays a step are not the
    1-process run's 256."""
    one = tmp_path / "one"
    cli_train.main(TRAIN + ["-b", f"Config.exp_name = {str(one)!r}",
                            "--max-steps", "3"])
    a, b = _load(one, 3), _load(runs["straight"], 3)
    assert not torch.equal(a["model.nerf_mlp.table"],
                           b["model.nerf_mlp.table"])


def test_two_rank_eval_matches_one_process(runs):
    tmp = runs["tmp"]
    one, two = tmp / "eval_one", tmp / "eval_two"
    for exp in (one, two):
        os.makedirs(exp / "checkpoints")
        shutil.copytree(runs["straight"] / "checkpoints" / str(STEPS),
                        exp / "checkpoints" / str(STEPS))
    cli_eval.main(["--tiny", "--device", "cpu",
                   "-b", f"Config.exp_name = {str(one)!r}"])
    _launch("ucnerf_tpu_torch.cli.eval", tmp, "run_eval", "--tiny",
            "--device", "cpu", "-b", f"Config.exp_name = {str(two)!r}")
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))
    assert sorted(os.listdir(two / "test_preds")) == \
        sorted(os.listdir(one / "test_preds"))
    names = [f for f in os.listdir(one) if f.endswith(f"_{STEPS}.txt")]
    assert {"psnr_6.txt", "ssim_6.txt", "psnr_cc_6.txt"} <= set(names)
    for name in names:
        want = np.loadtxt(one / name, ndmin=1)
        got = np.loadtxt(two / name, ndmin=1)
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    assert "(rank 0 of 2, gloo)" in (two / "log_eval.txt").read_text()


def test_three_rank_train_with_uneven_shares(tmp_path):
    """4 steps at 3 ranks, then a resume to 6: one loss line a logged step,
    written by rank 0 alone, finite and falling."""
    exp = tmp_path / "uneven"
    args = ["--multihost", *TRAIN, *UNEVEN,
            "-b", f"Config.exp_name = {str(exp)!r}"]
    outs = _launch("ucnerf_tpu_torch.cli.train", tmp_path, "run_4",
                   *args, "--max-steps", "4", world=3)
    _launch("ucnerf_tpu_torch.cli.train", tmp_path, "run_6", *args, world=3)
    log = (exp / "log_train.txt").read_text()
    assert log.count("(rank 0 of 3, gloo)") == 2
    assert "[rank 1]" not in log and "[rank 2]" not in log
    for r in (1, 2):
        assert f"[rank {r}]: device: cpu (rank {r} of 3, gloo)" in outs
    assert "resumed from step 4" in log
    steps = re.findall(r"step (\d+)/\d+: loss=(\S+)", log)
    assert [int(a) for a, _ in steps] == [1, 2, 4, 5, 6]
    losses = np.array([float(b) for _, b in steps])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # Saved at 3 and at the end of each call, the last 2 kept.
    assert sorted(os.listdir(exp / "checkpoints")) == ["4", "6"]

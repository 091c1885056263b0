"""The port's checkpoints (``train/checkpoints.py``) and training entry
point (``cli/train.py``) on the CPU, at the tiny preset.

Checkpoints are held bitwise: what is restored equals what was saved, for
the parameters, Adam's moments and step counts.  The CLI is held to its own
determinism: every step seeds its ray sampling and its forward's draws from
the step number, so a run resumed from the step-3 checkpoint must end in the
bitwise-same state as the uninterrupted run.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from ucnerf_tpu_torch import configs
from ucnerf_tpu_torch.cli import common
from ucnerf_tpu_torch.cli import train as cli_train
from ucnerf_tpu_torch.train import checkpoints as ckpt
from ucnerf_tpu_torch.train import state as state_lib
from ucnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(2)


def _trained_state(cfg, steps=2, seed=0):
    model = step_lib.init_model(cfg, seed=seed, device="cpu")
    state = state_lib.create_train_state(cfg, model)
    train_step = step_lib.make_train_step(model, cfg)
    batch = {k: torch.from_numpy(v)
             for k, v in step_lib.dummy_batch(cfg, 16).items()}
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        state, _ = train_step(state, batch, 0.5, generator=gen)
    return state


def _snapshot(state):
    """Everything a checkpoint must carry, as cloned tensors."""
    adam = state.optimizer.adam.state_dict()
    moments = {f"{i}.{k}": torch.as_tensor(v).clone()
               for i, s in adam["state"].items() for k, v in s.items()}
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            moments, state.step, state.optimizer.count)


def _assert_same(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert a[2:] == b[2:]


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    cfg = configs.tiny()
    state = _trained_state(cfg)
    want = _snapshot(state)
    assert want[2] == 2 and want[3] == 2 and len(want[1]) > 0
    path = ckpt.save_checkpoint(str(tmp_path), state, 2)
    assert path == str(tmp_path / "checkpoints" / "2")
    assert ckpt.latest_checkpoint_step(str(tmp_path)) == 2

    fresh = state_lib.create_train_state(
        cfg, step_lib.init_model(cfg, seed=3, device="cpu"))
    restored, step = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert step == 2 and restored.model is fresh.model
    _assert_same(_snapshot(restored), want)
    # The restored run goes on as the original does.
    batch = {k: torch.from_numpy(v)
             for k, v in step_lib.dummy_batch(cfg, 16).items()}
    nexts = []
    for st in (state, restored):
        st, _ = step_lib.make_train_step(st.model, cfg)(
            st, batch, 0.5, generator=torch.Generator().manual_seed(2))
        nexts.append(_snapshot(st))
    _assert_same(*nexts)


def test_restore_of_an_empty_folder_returns_step_0(tmp_path):
    cfg = configs.tiny()
    state = state_lib.create_train_state(
        cfg, step_lib.init_model(cfg, seed=0, device="cpu"))
    assert ckpt.latest_checkpoint_step(str(tmp_path)) is None
    restored, step = ckpt.restore_checkpoint(str(tmp_path), state)
    assert step == 0 and restored is state
    os.makedirs(tmp_path / "checkpoints" / "7.tmp")  # a save that was cut
    assert ckpt.restore_checkpoint(str(tmp_path), state)[1] == 0


@pytest.mark.parametrize("limit", [1, 2, 0])
def test_pruning_keeps_the_newest_total_limit(tmp_path, limit):
    cfg = configs.tiny()
    state = _trained_state(cfg, steps=1)
    for step in (5, 10, 100, 20):
        ckpt.save_checkpoint(str(tmp_path), state, step, total_limit=limit)
    kept = sorted(int(d) for d in os.listdir(tmp_path / "checkpoints"))
    # Numeric order, not string order: 100 is the newest, and 20 < 100
    # goes as soon as it is written when only one is kept.
    want = {1: [100], 2: [20, 100], 0: [5, 10, 20, 100]}[limit]
    assert kept == want
    assert ckpt.latest_checkpoint_step(str(tmp_path)) == 100


def _run(exp, *extra, max_steps=6):
    """Run the CLI; returns what this run added to the log file."""
    log_path = os.path.join(exp, "log_train.txt")
    before = os.path.getsize(log_path) if os.path.exists(log_path) else 0
    cli_train.main([
        "--tiny", "--device", "cpu", "--max-steps", str(max_steps),
        "-b", f"Config.exp_name = {str(exp)!r}",
        "-b", "Config.print_every = 2",
        "-b", "Config.train_render_every = 6",
        "-b", "Config.checkpoint_every = 3",
        "-b", "Config.checkpoints_total_limit = 2", *extra])
    with open(log_path) as f:
        f.seek(before)
        return f.read()


def _load(exp, step):
    return torch.load(os.path.join(exp, "checkpoints", str(step), "state.pt"),
                      weights_only=True)


def _flat(payload):
    out = {f"model.{k}": v for k, v in payload["model"].items()}
    for i, s in payload["adam"]["state"].items():
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = torch.as_tensor(v)
    out["step"] = torch.tensor(payload["step"])
    out["count"] = torch.tensor(payload["count"])
    return out


@pytest.mark.parametrize("bf16", [False, True])
def test_cli_train_runs_and_resumes_bitwise(tmp_path, bf16):
    """6 straight steps, against 3 steps + resume + 3 steps; with the f32
    and with the bf16-packed table backward."""
    extra = []
    if bf16:
        extra = ["-b", 'NerfMLP.grid_bwd_value_dtype = "bfloat16"',
                 "-b", 'PropMLP.grid_bwd_value_dtype = "bfloat16"']
    straight = str(tmp_path / "straight")
    log = _run(straight, *extra)
    losses = [float(x) for x in re.findall(r"step \d+/6: loss=(\S+)", log)]
    assert len(losses) == 4  # steps 1, 2, 4, 6
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert re.search(r"step 6/6: loss=\S+ psnr=\S+ \d+ rays/s \(.*data=", log)
    psnr = re.search(r"test render 0: psnr=(\S+) ssim=(\S+)", log)
    assert psnr and np.isfinite(float(psnr.group(1)))
    assert "resumed" not in log
    assert sorted(os.listdir(os.path.join(straight, "checkpoints"))) == [
        "3", "6"]

    resumed = str(tmp_path / "resumed")
    os.makedirs(os.path.join(resumed, "checkpoints"))
    shutil.copytree(os.path.join(straight, "checkpoints", "3"),
                    os.path.join(resumed, "checkpoints", "3"))
    log = _run(resumed, *extra)
    assert "resumed from step 3" in log
    assert re.findall(r"step (\d+)/6", log) == ["4", "6"]
    a, b = _flat(_load(straight, 6)), _flat(_load(resumed, 6))
    assert set(a) == set(b) and int(a["step"]) == 6 and int(a["count"]) == 6
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # The steps did something: step 6 is not step 3.
    c = _flat(_load(straight, 3))
    assert not torch.equal(a["model.nerf_mlp.table"],
                           c["model.nerf_mlp.table"])

    # A finished run resumes to nothing but the final save.
    log = _run(resumed, *extra)
    assert "resumed from step 6" in log and "step 6/6" not in log


def test_cli_train_refuses_what_it_cannot_do(tmp_path, monkeypatch):
    exp = str(tmp_path / "exp")
    with pytest.raises(NotImplementedError, match="multihost"):
        cli_train.main(["--tiny", "--device", "cpu", "--multihost"])
    with pytest.raises(ValueError, match="binding scope"):
        _run(exp, "-b", "Nope.field = 1")

    # More training views than brightness latents (a Waymo split can have
    # them; the synthetic scene never does).
    from ucnerf_tpu_torch.data import datasets
    load = datasets.load_dataset

    def crowded(split, config):
        ds = load(split, config)
        ds.n_examples = config.training_views + 1
        return ds
    monkeypatch.setattr(datasets, "load_dataset", crowded)
    with pytest.raises(ValueError, match="training_views"):
        _run(exp)


def test_common_parses_presets_and_bindings():
    parser = common.make_parser("x")
    args = parser.parse_args([
        "--preset", "synthetic_quality",
        "-b", 'NerfMLP.grid_bwd_value_dtype = "bfloat16"',
        "-b", 'PropMLP.grid_bwd_value_dtype = "bfloat16"'])
    cfg = common.load_config_from_args(args)
    assert cfg.dataset_loader == "synthetic" and cfg.microbatches == 2
    assert cfg.nerf_mlp.grid_bwd_value_dtype == "bfloat16"
    assert cfg.prop_mlp.grid_bwd_value_dtype == "bfloat16"
    assert cfg.nerf_mlp.grid_bwd_dense_sample
    assert common.load_config_from_args(
        parser.parse_args(["--tiny"])).batch_size == 256

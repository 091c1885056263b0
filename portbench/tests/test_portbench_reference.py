"""The reference against the port at a tiny size on the CPU (the port's
plain kernels), the control that the comparison must reject, and whole
runs with the timed path broken underneath, which must come out not
correct."""

import numpy as np
import pytest

from conftest import cpu_cell, tiny_config
from portbench import check, run
from portbench.kinds import render as render_kind
from portbench.kinds import train as train_kind


@pytest.mark.parametrize("single_query", [False, True])
def test_train_run_matches_the_reference(single_query):
    cell = cpu_cell("train", tiny_config(single_query))
    res = run.run_cell(cell)
    assert res.correct and res.attempted >= 1 and res.failed == 0
    for name, (value, limit) in res.checks.items():
        assert value <= 1e-6, name


@pytest.mark.parametrize("single_query", [False, True])
def test_render_run_matches_the_reference(single_query):
    cell = cpu_cell("render", tiny_config(single_query))
    res = run.run_cell(cell)
    assert res.correct and res.attempted >= 1
    for name, (value, limit) in res.checks.items():
        assert value <= 1e-6, name


def test_train_control_is_rejected():
    """The reference with its matrix products in TF32 in the program's
    place fails the f32 reference's comparison, over the first steps and
    over the late step alike; the half-batch fault fails it too."""
    from portbench import control
    cell = cpu_cell("train", seed=5)
    readings = control.train_readings(cell, steps=1)
    lim = check.limits("waymo.train")
    assert check.judge(readings["program"], lim)[0]
    for part in ("control", "half_batch"):
        assert not check.judge(readings[part], lim)[0], part
    ctl, prog = readings["control"], readings["program"]
    assert ctl["grad_gap"] > 10 * prog["grad_gap"]
    assert ctl["late_grad_gap"] > 10 * prog["late_grad_gap"]


def test_render_control_is_rejected():
    cell = cpu_cell("render", seed=6)
    from portbench.scene import Scene
    scene = Scene(cell.traffic["scene"], cell.seed, "test")
    path = scene.path_poses(cell.traffic["path_frames"])
    f32 = render_kind.reference_views(cell, scene, path, [3, 40])
    tf32 = render_kind.reference_views(cell, scene, path, [3, 40], "tf32")
    ok, _ = check.judge(check.render_numbers(tf32, f32),
                        check.limits("waymo.render"))
    assert not ok


def _unchanged_state(monkeypatch):
    from ucnerf_tpu_torch.train import state
    monkeypatch.setattr(state.Optimizer, "update",
                        lambda self: setattr(self, "count", self.count + 1))


def _half_batch(monkeypatch):
    from portbench.control import half_batch_fault
    from ucnerf_tpu_torch.train import step
    monkeypatch.setattr(step, "make_train_step", step.make_train_step)
    half_batch_fault()


def _altered_answer(monkeypatch):
    from ucnerf_tpu_torch.train import step
    render = step.render_image

    def altered(*args, **kwargs):
        out = render(*args, **kwargs)
        out["rgb"] = out["rgb"] + np.float32(1e-2)
        return out
    monkeypatch.setattr(step, "render_image", altered)


def _after_setup(monkeypatch, wrap):
    """Hand the window the set-up's train step wrapped by `wrap`."""
    setup = train_kind.setup

    def broken(cell):
        scene, dataset, state, step_fn, gen, first = setup(cell)
        return scene, dataset, state, wrap(step_fn), gen, first
    monkeypatch.setattr(train_kind, "setup", broken)


def _unchanged_state_after_setup(monkeypatch):
    def wrap(step_fn):
        _unchanged_state(monkeypatch)
        return step_fn
    _after_setup(monkeypatch, wrap)


def _half_batch_after_setup(monkeypatch):
    def wrap(step_fn):
        def half(state, batch, train_frac, generator=None, rand_vec=None):
            n = batch["origins"].shape[0] // 2
            return step_fn(state, {k: v[:n] for k, v in batch.items()},
                           train_frac, generator=generator)
        return half
    _after_setup(monkeypatch, wrap)


@pytest.mark.parametrize("kind,fault", [
    ("train", _unchanged_state),
    ("train", _half_batch),
    ("train", _unchanged_state_after_setup),
    ("train", _half_batch_after_setup),
    ("render", _altered_answer),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, kind, fault):
    fault(monkeypatch)
    res = run.run_cell(cpu_cell(kind))
    assert not res.correct
    if fault in (_unchanged_state_after_setup, _half_batch_after_setup):
        # The set-up's steps ran sound: the step after the window fails.
        assert all(v <= lim for k, (v, lim) in res.checks.items()
                   if not k.startswith("late_"))
        assert any(v > lim for k, (v, lim) in res.checks.items()
                   if k.startswith("late_"))


@pytest.mark.card
@pytest.mark.parametrize("kind", ["train", "render"])
def test_the_card_matches_the_reference_and_rejects_the_control(card, kind):
    """The port's CUDA kernels at the tiny size: sound, and the control
    (the reference in TF32) fails the cell's limits."""
    from portbench import control
    cell = cpu_cell(kind, seed=7)
    cell.device = card
    read = control.train_readings if kind == "train" \
        else control.render_readings
    readings = read(cell)
    lim = check.limits(f"waymo.{kind}")
    assert check.judge(readings["program"], lim)[0]
    assert not check.judge(readings["control"], lim)[0]

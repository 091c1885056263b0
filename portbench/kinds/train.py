"""The ``train`` kind: ``cli.train``'s loop body on the port.

Set-up makes the segment's train views, the parameters from the seed, the
port's model, train state and step, and drives that one state through the
first ``check_steps`` steps by the window's own feed and call: these warm
up every shape and are the steps the reference follows from the seed.  The
window then runs steps until ``seconds`` have passed and the device has
finished; the rate is all rays of all its steps over its whole time.  A
traced run profiles ``trace_units`` steps after ``trace_after`` steps of
the window.

Once the window has closed and its peak is read, the same state takes one
more step by the same feed and call, from a snapshot of its parameters and
Adam moments: the reference takes up that snapshot and follows that step,
so that the path the window ran is judged as it runs after warm-up.  With
the port's state freed, the reference also runs the first steps from the
same parameters on its own ray batches and generators, and
``check.train_numbers`` compares both.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check, scene as scene_lib, weights
from portbench.kinds.common import (Result, port_model, run_window,
                                    to_device)
from portbench.reference import rays as ref_rays
from portbench.reference import steps as ref_steps


def dataset_class():
    """The port's ``RayDataset`` over a benchmark scene."""
    from ucnerf_tpu_torch.data import datasets

    class PortDataset(datasets.RayDataset):
        def __init__(self, scene, config):
            self._scene = scene
            super().__init__(datasets.DataSplit.TRAIN, config)

        def _load_renderings(self, config):
            s = self._scene
            views = len(s.camtoworlds)
            self.images = scene_lib.PerCamera(s.textures, views)
            self.sky_segments = scene_lib.PerCamera(s.sky, views)
            self.camtoworlds = s.camtoworlds
            self.pixtocams = s.pixtocams
            self.cam_num = s.cameras
    return PortDataset


def train_frac(cfg, step):
    return float(np.clip((step - 1) / max(cfg["max_steps"] - 1, 1), 0, 1))


def step_seed(seed, step):
    return weights.seed_of(seed, 3, step)


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def port_step(cell, state, train_step, dataset, generator, step):
    """Step `step` through the window's own feed and call."""
    from ucnerf_tpu_torch.train import step as step_lib
    cfg = cell.cfg
    batch = step_lib.batch_to_device(dataset.sample_batch(
        np.random.default_rng((cell.seed, step)), cfg["batch_size"]),
        cell.device)
    generator.manual_seed(step_seed(cell.seed, step))
    return train_step(state, batch, train_frac(cfg, step),
                      generator=generator)


def moments(state) -> dict:
    """{leaf: Adam's first moment} of the port's state (zeros for a leaf
    that has none yet)."""
    adam = state.optimizer.adam.state
    return {k: adam[p]["exp_avg"] if "exp_avg" in adam.get(p, {})
            else torch.zeros_like(p)
            for k, p in state.model.named_parameters()}


def program_first_steps(cell, state, train_step, dataset, generator, p0):
    """Steps 1..check_steps through the window's feed and call; the
    readings the comparison takes: each step's loss, the first gradient
    from Adam's first moment after step 1, each leaf's change after the
    last."""
    beta1 = cell.cfg["adam_beta1"]
    losses, grad = [], None
    for step in range(1, cell.traffic["check_steps"] + 1):
        state, stats = port_step(cell, state, train_step, dataset,
                                 generator, step)
        losses.append(float(stats["loss"]))
        if step == 1:
            grad = {k: float(torch.linalg.vector_norm(m.double()))
                    / (1 - beta1) for k, m in moments(state).items()}
    update = norms({k: p.detach() - p0[k]
                    for k, p in state.model.named_parameters()})
    return state, {"losses": losses, "grad": grad, "update": update}


def snapshot(state) -> dict:
    """What the reference takes up of the port's state: each leaf's value
    and Adam moments, and the optimizer's count of updates."""
    adam = state.optimizer.adam.state
    leaves = {}
    for k, p in state.model.named_parameters():
        s = adam.get(p, {})
        leaves[k] = tuple(s[m].detach().clone() if m in s
                          else torch.zeros_like(p)
                          for m in ("exp_avg", "exp_avg_sq"))
        leaves[k] = (p.detach().clone(),) + leaves[k]
    return {"leaves": leaves, "count": state.optimizer.count}


def program_late_step(cell, state, train_step, dataset, generator, step):
    """Step `step` after the window, from a snapshot of the state; the
    readings: its loss, its gradient worked out from Adam's first moment
    before and after, each leaf's change.  Returns (state, snapshot,
    readings)."""
    beta1 = cell.cfg["adam_beta1"]
    snap = snapshot(state)
    state, stats = port_step(cell, state, train_step, dataset, generator,
                             step)
    m1 = moments(state)
    grad = norms({k: (m1[k].double() - beta1 * v[1].double()) / (1 - beta1)
                  for k, v in snap["leaves"].items()})
    update = norms({k: p.detach() - snap["leaves"][k][0]
                    for k, p in state.model.named_parameters()})
    return state, snap, {"losses": [float(stats["loss"])], "grad": grad,
                         "update": update}


def _reference_steps(cell, scene, params, steps, precision, opt=None):
    cfg = cell.cfg
    p0 = {k: v.detach().clone() for k, v in params.items()}
    for v in params.values():
        v.requires_grad_(True)
    batches = [to_device(ref_rays.train_batch(
        scene, np.random.default_rng((cell.seed, s)), cfg["batch_size"],
        cfg["near"], cfg["far"]), cell.device) for s in steps]
    losses, first, _ = ref_steps.train(
        params, cfg, batches, [step_seed(cell.seed, s) for s in steps],
        [train_frac(cfg, s) for s in steps], precision, opt)
    update = norms({k: params[k].detach() - p0[k] for k in params})
    return {"losses": losses, "grad": norms(first), "update": update}


def reference_first_steps(cell, scene, precision=None):
    """The reference's readings over the set-up's steps, from the seed."""
    params = weights.make(cell.cfg, cell.seed, cell.device)
    return _reference_steps(cell, scene, params,
                            range(1, cell.traffic["check_steps"] + 1),
                            precision)


def reference_late_step(cell, scene, snap, step, precision=None):
    """The reference's readings of step `step`, taken up from the port's
    snapshot (values and moments copied, so that one snapshot serves
    several readings)."""
    leaves = snap["leaves"]
    params = {k: v[0].clone() for k, v in leaves.items()}
    opt = ref_steps.Adam(params, cell.cfg,
                         m={k: v[1].clone() for k, v in leaves.items()},
                         v={k: v[2].clone() for k, v in leaves.items()},
                         t=snap["count"])
    return _reference_steps(cell, scene, params, [step], precision, opt)


def setup(cell):
    """Everything before the window: (scene, dataset, state, train step,
    generator, the readings of the first steps)."""
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step as step_lib
    cell.stage("imports")
    scene = scene_lib.Scene(cell.traffic["scene"], cell.seed, "train")
    dataset = dataset_class()(scene, cell.config)
    cell.stage("scene")
    params = weights.make(cell.cfg, cell.seed, cell.device)
    model = port_model(cell.config, params, cell.device)
    p0 = params
    state = state_lib.create_train_state(cell.config, model)
    train_step = step_lib.make_train_step(model, cell.config)
    generator = torch.Generator(device=cell.device)
    cell.stage("model")
    state, readings = program_first_steps(cell, state, train_step, dataset,
                                          generator, p0)
    cell.stage("first steps")
    del p0, params
    return scene, dataset, state, train_step, generator, readings


def compare(cell, scene, prog, late, snap, late_step):
    """(correct, checks) of the first steps' and the late step's readings,
    each against the reference's; the leaves counted go into the notes."""
    numbers = check.train_run_numbers(
        prog, reference_first_steps(cell, scene),
        late, reference_late_step(cell, scene, snap, late_step))
    for label, leaves in numbers["_leaves"].items():
        worst_grad, worst_update, n_grad, n_update, n_all = leaves
        left = numbers["_left_out"][label].values()
        cell.note(
            f"{label}: grad worst {worst_grad} ({n_grad} of {n_all} leaves),"
            f" update worst {worst_update} ({n_update}); the program's "
            f"widest change of a leaf the reference leaves unmoved "
            f"{max(left, default=0.0):.3e}")
    return check.judge(numbers, check.limits(cell.name))


def run(cell) -> Result:
    from ucnerf_tpu_torch.train import step as step_lib
    cfg, tr = cell.cfg, cell.traffic
    batch_size = cfg["batch_size"]
    scene, dataset, state, train_step, generator, prog = setup(cell)
    cell.sync()
    setup_peak = cell.peak_bytes()
    cell.mark_setup_done()

    cell.reset_peak()
    data_s, losses = [], []

    def unit(i, traced):
        nonlocal state
        step = tr["check_steps"] + 1 + i
        a = time.perf_counter()
        batch = step_lib.batch_to_device(dataset.sample_batch(
            np.random.default_rng((cell.seed, step)), batch_size),
            cell.device)
        if not traced:
            data_s.append(time.perf_counter() - a)
        generator.manual_seed(step_seed(cell.seed, step))
        state, stats = train_step(state, batch, train_frac(cfg, step),
                                  generator=generator)
        losses.append(stats["loss"])

    win = run_window(cell, unit, tr["trace_after"], tr["trace_units"])
    window_peak = cell.peak_bytes()
    cell.note_intervals("step", win.stamps)
    peak = max(setup_peak, window_peak)
    late_step = tr["check_steps"] + 1 + win.units
    state, snap, late = program_late_step(cell, state, train_step, dataset,
                                          generator, late_step)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    del state, train_step, losses, dataset
    cell.free()

    ok, checks = compare(cell, scene, prog, late, snap, late_step)
    res = Result(correct=ok and failed == 0, attempted=win.units,
                 failed=failed, end_to_end={
                     "train_rays_per_s": batch_size * win.units / win.seconds,
                     "peak_mem_gib": window_peak / 2**30},
                 checks=checks, memory_peak_bytes=peak)
    if win.trace is not None:
        untraced = win.units - tr["trace_units"]
        res.trace, res.units, res.unit_rays = (win.trace, tr["trace_units"],
                                               batch_size)
        res.unit_s = ((win.seconds - win.traced_s) / untraced if untraced
                      else None)
        res.host = {"data_s": data_s}
    return res

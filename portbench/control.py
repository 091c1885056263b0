"""The readings that a cell's limits are set from, at the cell's own size,
over several seeds in one process (benchmark runs never call this).

For each seed it reads the comparison's numbers of
- the program against the float32 reference (sound runs: the lower
  reading);
- the control, the reference with its matrix products' operands in TF32
  (the nearest precision below the configurations' float32 with TF32 off),
  in the program's place (the upper reading);
- for a training cell, the program with half of each batch left out (a
  fault; a state left unchanged reads 1 on ``update_gap`` by the measure
  and needs no run).
A training cell's late step comes after ``--steps`` steps by the window's
feed (about as many as a window runs).

  python3 -m portbench.control --workload waymo.train --seeds 1,2,3 \
      --steps 64 --out readings.json
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import numpy as np


def half_batch_fault():
    """Make the port's train step leave out half of each batch (and take
    the mean over the rest); returns the function that undoes it."""
    from ucnerf_tpu_torch.train import step
    make = step.make_train_step

    def half(model, config, group=None):
        inner = make(model, config, group)

        def train_step(state, batch, train_frac, generator=None,
                       rand_vec=None):
            n = batch["origins"].shape[0] // 2
            return inner(state, {k: v[:n] for k, v in batch.items()},
                         train_frac, generator=generator)
        return train_step
    step.make_train_step = half
    return lambda: setattr(step, "make_train_step", make)


def train_readings(cell, controls=True, steps=0):
    """The training cell's numbers over the set-up's first steps and, after
    `steps` more steps by the window's feed, the late step."""
    from portbench import check, scene as scene_lib
    from portbench.kinds import train
    first_steps = cell.traffic["check_steps"]
    late_step = first_steps + 1 + steps

    def program():
        _, dataset, state, step_fn, gen, first = train.setup(cell)
        for i in range(steps):
            state, _ = train.port_step(cell, state, step_fn, dataset, gen,
                                       first_steps + 1 + i)
        state, snap, late = train.program_late_step(
            cell, state, step_fn, dataset, gen, late_step)
        del state, step_fn, dataset
        cell.free()
        return first, late, snap

    scene = scene_lib.Scene(cell.traffic["scene"], cell.seed, "train")
    first, late, snap = program()
    ref = train.reference_first_steps(cell, scene)
    ref_late = train.reference_late_step(cell, scene, snap, late_step)
    out = {"program": check.train_run_numbers(first, ref, late, ref_late)}
    if controls:
        out["control"] = check.train_run_numbers(
            train.reference_first_steps(cell, scene, "tf32"), ref,
            train.reference_late_step(cell, scene, snap, late_step, "tf32"),
            ref_late)
        del snap
        undo = half_batch_fault()
        try:
            first, late, snap = program()
        finally:
            undo()
        out["half_batch"] = check.train_run_numbers(
            first, ref, late,
            train.reference_late_step(cell, scene, snap, late_step))
    return out


def render_readings(cell, controls=True):
    from portbench import check, scene as scene_lib, weights
    from portbench.kinds import render
    from portbench.kinds.common import port_model
    from ucnerf_tpu_torch.train import step as step_lib
    cfg, tr = cell.cfg, cell.traffic
    scene = scene_lib.Scene(tr["scene"], cell.seed, "test")
    path = scene.path_poses(tr["path_frames"])
    frames = [int(f) for f in np.random.default_rng((cell.seed, 5)).choice(
        len(path), size=tr["check_views"], replace=False)]
    model = port_model(cell.config, weights.make(cfg, cell.seed, cell.device,
                                                 widen=True), cell.device)
    eval_step = step_lib.make_eval_step(model, cell.config)
    prog = [render.flat(step_lib.render_image(
        eval_step, render.view_batch(scene, path[f], cfg), cell.config,
        train_frac=1.0, eval_camidx=0)) for f in frames]
    del model, eval_step
    cell.free()
    ref = render.reference_views(cell, scene, path, frames)
    out = {"program": check.render_numbers(prog, ref)}
    if controls:
        ctl = render.reference_views(cell, scene, path, frames, "tf32")
        out["control"] = check.render_numbers(ctl, ref)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=3,
                   help="run the control and the faults on the first N seeds")
    p.add_argument("--steps", type=int, default=0,
                   help="training: steps between the first ones and the "
                   "late step, as a window would run them")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch

    from portbench import run
    _, entry, config_file, traffic = run.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    read = (functools.partial(train_readings, steps=args.steps)
            if traffic["kind"] == "train" else render_readings)
    results = {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        cell = run.Cell(args.workload, config_file["config"], traffic, seed,
                        0.0, False, torch.device("cuda", 0))
        results[seed] = read(cell, i < args.controls)
        results[seed]["seconds"] = time.perf_counter() - t
        print(json.dumps({seed: results[seed]}), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    first = results[next(iter(results))]
    for part in first:
        if part == "seconds":
            continue
        for k in (k for k in first[part] if not k.startswith("_")):
            vals = [r[part][k] for r in results.values() if part in r]
            print(f"{part:10s} {k:14s} min {min(vals):.3e} max "
                  f"{max(vals):.3e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Import a JAX train state: write the export of
``tools/export_jax_checkpoint.py`` as a checkpoint of the port.

The JAX package saves its train state with orbax, which the card's machine
cannot read (it has no JAX, orbax or tensorstore).  On the JAX host,
``tools/export_jax_checkpoint.py --exp EXP -o scene.npz`` writes the state
as numpy arrays (parameters, Adam's moments and count, the schedule's count
and the step); this CLI builds the model and train state of the run's
preset and bindings on ``--device``, fills them from the export by
parameter name (``convert.state_from_export``: every key must fit, nothing
loads partially) and saves ``{exp}/checkpoints/<step>/state.pt``, which
``cli.eval``, ``cli.render``, ``cli.extract``, ``cli.tsdf`` and
``cli.train`` (resuming) read as they read their own.

It refuses a folder whose checkpoints hold a JAX checkpoint at the
export's step (the save would replace it) or a later step than the
export's (which the other CLIs would read instead); it deletes no other
checkpoint.

Usage:
  python -m ucnerf_tpu_torch.cli.import_jax --preset waymo \
      -b "Config.exp_name = '/path/to/port_exp'" --export scene.npz
"""

from __future__ import annotations

import os
import time


def main(argv=None):
    from ucnerf_tpu_torch.cli import common

    parser = common.make_parser(__doc__)
    parser.add_argument("--export", required=True,
                        help="npz written by tools/export_jax_checkpoint.py "
                             "--exp")
    common.add_device_arg(parser)
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)
    device = common.resolve_device(args.device)
    exp, logger = common.setup_experiment(config, "import")
    t0 = time.time()

    from ucnerf_tpu_torch import convert
    from ucnerf_tpu_torch.train import checkpoints as ckpt_lib
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step as step_lib

    export = convert.load_export(args.export, "nerf")
    step = int(export["step"])
    path = os.path.join(exp, "checkpoints", str(step))
    if ckpt_lib.is_jax_checkpoint(path):
        raise ValueError(f"{path} holds a JAX checkpoint, which the import "
                         f"would replace: pass another Config.exp_name")
    latest = ckpt_lib.latest_checkpoint_step(exp)
    if latest is not None and latest > step:
        raise ValueError(f"{exp} holds checkpoint {latest}, later than the "
                         f"export's step {step}: the other CLIs would read "
                         f"it instead; pass another Config.exp_name")
    model = step_lib.init_model(config, seed=0, device=device)
    state = convert.state_from_export(
        export, state_lib.create_train_state(config, model))
    del export
    ckpt_lib.save_checkpoint(exp, state, step, total_limit=0)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("imported step %d from %s: %d parameters (%.2fM) on %s, "
                "written to %s in %.1f s", step, args.export, n_params,
                n_params / 1e6, device, path, time.time() - t0)
    return path


if __name__ == "__main__":
    main()

"""Export a checkpoint of the JAX package to the neutral npz that the PyTorch
port (``ucnerf_tpu_torch``) reads.

Runs where the JAX package is installed (it needs numpy, orbax and flax,
never torch); the port's side needs numpy and torch, never JAX.

NeRF: the orbax train state that ``ucnerf_tpu.train.checkpoints`` writes
under ``{exp}/checkpoints/<step>`` (the newest step, or ``--step``):

  python tools/export_jax_checkpoint.py --exp /path/to/exp [--step N] \\
      -o scene.npz

then, on the card's machine, ``python -m ucnerf_tpu_torch.cli.import_jax
--preset ... -b "Config.exp_name = '...'" --export scene.npz`` writes the
port's checkpoint, which ``cli.eval``, ``cli.render``, ``cli.extract``,
``cli.tsdf`` and ``cli.train`` (resuming) read.

MVS: the flax msgpack file that ``ucnerf_tpu.cli.mvs_train --out`` writes
(``{"params": ...}``):

  python tools/export_jax_checkpoint.py --mvs params.msgpack -o mvs.npz

which ``ucnerf_tpu_torch.cli.mvs_depth --ckpt mvs.npz`` reads.

Layout of the npz (uncompressed ``np.savez``; a full-width NeRF state is
about 1 GB):

  format                 "ucnerf-jax-export/1"
  kind                   "nerf" or "mvs"
  params/<flax path>     the parameter tree in JAX's layout, path parts
                         joined by '/' (dense kernels [in, out], conv
                         kernels HWIO, hash tables [C, rows])
  adam/mu/<flax path>    nerf only: Adam's first moments, same layout
  adam/nu/<flax path>    nerf only: Adam's second moments
  adam/count             nerf only: Adam's update count (int32)
  schedule/count         nerf only: the learning-rate schedule's count
  step                   nerf only: the train state's step

The train state's optimizer is the optax chain of
``ucnerf_tpu.train.state.create_optimizer``, restored as a list with one
entry per link; links that hold no state come back as None, and which
links exist depends on ``grad_max_val``, ``grad_max_norm`` and
``cam_lr_mult``.  So Adam's entry is found by its content (the one entry
holding ``mu`` and ``nu``) and the schedule's as the entry after it that
holds only ``count``; any other shape of the list is refused.  The state is
restored without a target, as numpy arrays, so no device topology enters
(a checkpoint saved across several hosts is read the same way; that case
is untested).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

FORMAT = "ucnerf-jax-export/1"


def flatten(tree, prefix: str) -> dict:
    """{prefix + 'a/b/c': array} for every leaf of the nested dict
    `tree`."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


def restore_numpy(path: str):
    """The orbax checkpoint at `path` as nested dicts and lists of numpy
    arrays, restored without a target."""
    import jax
    import orbax.checkpoint as ocp

    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.metadata(path).item_metadata.tree
    restore_args = jax.tree.map(
        lambda _: ocp.RestoreArgs(restore_type=np.ndarray), tree)
    return ckptr.restore(path, args=ocp.args.PyTreeRestore(
        restore_args=restore_args))


def _describe(entry):
    return sorted(entry) if isinstance(entry, dict) else type(entry).__name__


def split_opt_state(opt_state):
    """(Adam's {count, mu, nu}, the schedule's count) of the restored optax
    chain state; raises, printing the chain, unless it holds one Adam
    entry, one later entry with only ``count`` and nothing else."""
    links = list(opt_state) if isinstance(opt_state, (list, tuple)) else []
    adam = [i for i, e in enumerate(links)
            if isinstance(e, dict) and set(e) == {"count", "mu", "nu"}]
    sched = [i for i, e in enumerate(links)
             if isinstance(e, dict) and set(e) == {"count"}]
    rest = [e for i, e in enumerate(links) if i not in adam + sched]
    if (len(adam) == 1 and len(sched) == 1 and sched[0] > adam[0]
            and all(e is None for e in rest)):
        return links[adam[0]], links[sched[0]]["count"]
    shape = ([_describe(e) for e in links] if links
             else _describe(opt_state))
    raise ValueError(f"unexpected optimizer state {shape}: expected the "
                     f"links of ucnerf_tpu.train.state.create_optimizer, "
                     f"one holding Adam's count, mu and nu, a later one only "
                     f"the schedule's count, the others None")


def nerf_arrays(exp: str, step=None) -> dict:
    """The export arrays of the train state under `exp` at `step` (the
    newest when None)."""
    from ucnerf_tpu.train import checkpoints

    if step is None:
        step = checkpoints.latest_checkpoint_step(exp)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {exp}/checkpoints")
    path = os.path.join(os.path.abspath(exp), "checkpoints", str(step))
    state = restore_numpy(path)
    if not isinstance(state, dict) or set(state) != {"step", "params",
                                                      "opt_state"}:
        raise ValueError(f"{path}: keys {_describe(state)}, expected a "
                         f"TrainState (step, params, opt_state)")
    adam, sched_count = split_opt_state(state["opt_state"])
    if int(state["step"]) != step:
        raise ValueError(f"{path}: the state's step is {int(state['step'])}, "
                         f"the folder's {step}")
    arrays = {"format": np.array(FORMAT), "kind": np.array("nerf")}
    arrays.update(flatten(state["params"], "params/"))
    arrays.update(flatten(adam["mu"], "adam/mu/"))
    arrays.update(flatten(adam["nu"], "adam/nu/"))
    arrays["adam/count"] = np.asarray(adam["count"])
    arrays["schedule/count"] = np.asarray(sched_count)
    arrays["step"] = np.asarray(state["step"])
    return arrays


def mvs_arrays(path: str) -> dict:
    """The export arrays of the flax msgpack file at `path`."""
    from flax.serialization import msgpack_restore

    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict) or set(tree) != {"params"}:
        raise ValueError(f"{path}: collections {_describe(tree)}, expected "
                         f"{{'params'}} as ucnerf_tpu.cli.mvs_train writes")
    arrays = {"format": np.array(FORMAT), "kind": np.array("mvs")}
    arrays.update(flatten(tree["params"], "params/"))
    return arrays


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--exp", help="experiment folder of a JAX NeRF run")
    source.add_argument("--mvs", help="flax msgpack file of cli.mvs_train")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step (default: the newest)")
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)
    if args.mvs and args.step is not None:
        parser.error("--step applies to --exp only")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    arrays = (nerf_arrays(args.exp, args.step) if args.exp
              else mvs_arrays(args.mvs))
    np.savez(args.output, **arrays)
    n = sum(v.size for k, v in arrays.items() if k.startswith("params/"))
    print(f"wrote {args.output}: {arrays['kind']} export, {n} parameters"
          + (f", step {int(arrays['step'])}" if "step" in arrays else ""))


if __name__ == "__main__":
    main()

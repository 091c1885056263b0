"""Import a train state of the PyTorch port (``ucnerf_tpu_torch``) into the
JAX package: write the neutral npz of ``ucnerf_tpu_torch.convert``
(``state_to_export``) as the orbax checkpoint that
``ucnerf_tpu.train.checkpoints`` reads, so that a scene trained on a GPU
is served or trained on by the JAX package.

The inverse of ``tools/export_jax_checkpoint.py``.  Runs where the JAX
package is installed (it needs numpy, orbax, flax and optax, never
torch):

  # on the card's machine
  python -c "..." # convert.state_to_export(state, 'scene.npz')
  # on the JAX host, with the run's preset and bindings
  python tools/import_port_checkpoint.py --preset waymo \\
      -b "Config.exp_name = '/path/to/jax_exp'" --export scene.npz

which writes ``{exp}/checkpoints/<step>``; ``ucnerf_tpu.cli.eval`` and
``ucnerf_tpu.cli.train`` (resuming) restore it as they restore their own.

The train state is built as the JAX CLI builds it (the config from the
preset and the bindings, ``create_train_state``) and filled from the
export: the parameters by flax path, Adam's ``mu``, ``nu`` and ``count``
into the chain's ``scale_by_adam`` entry and the schedule's ``count`` into
its ``scale_by_schedule`` entry (both found by their fields, as the
exporter finds them in a restored chain), and the step.  Nothing is
written unless every key fits: a missing, unexpected, misshapen or
mistyped array is refused with the list of them, and so is a chain of
another shape (printed).  It refuses a folder that holds a checkpoint at
the export's step or a later one, and deletes no checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from export_jax_checkpoint import FORMAT

COUNTS = ("adam/count", "schedule/count", "step")


def split_chain(opt_state):
    """(index of Adam's entry, index of the schedule's) in the optax chain
    state `opt_state` of ``create_optimizer``: one entry with the fields
    count, mu and nu, one later entry with count alone, the others with no
    field.  Raises, printing the chain, on any other shape."""
    links = list(opt_state) if isinstance(opt_state, tuple) else []
    fields = [tuple(getattr(e, "_fields", ("?",))) for e in links]
    adam = [i for i, f in enumerate(fields) if set(f) == {"count", "mu",
                                                          "nu"}]
    sched = [i for i, f in enumerate(fields) if f == ("count",)]
    rest = [f for i, f in enumerate(fields) if i not in adam + sched]
    if (len(adam) == 1 and len(sched) == 1 and sched[0] > adam[0]
            and all(f == () for f in rest)):
        return adam[0], sched[0]
    shape = ([f"{type(e).__name__}{fields[i]}" for i, e in enumerate(links)]
             if links else type(opt_state).__name__)
    raise ValueError(f"unexpected optimizer chain {shape}: expected the "
                     f"links of ucnerf_tpu.train.state.create_optimizer, "
                     f"one scale_by_adam (count, mu, nu), a later "
                     f"scale_by_schedule (count), the others stateless")


def abstract_state(config):
    """The shapes and dtypes of the JAX CLI's train state for `config`
    (``init_model``, then ``create_train_state``), computed without
    drawing a weight."""
    import jax

    from ucnerf_tpu.train import state as state_lib
    from ucnerf_tpu.train import step as step_lib

    params = jax.eval_shape(
        lambda key: step_lib.init_model(config, key)[1],
        jax.random.PRNGKey(0))
    return jax.eval_shape(
        lambda p: state_lib.create_train_state(config, p), params)


def _key(prefix, path):
    """The export key of the leaf at the pytree `path` under `prefix`."""
    return prefix + "/".join(str(getattr(p, "key", p)) for p in path)


def expected_arrays(abstract) -> dict:
    """{export key: ShapeDtypeStruct} of the train state `abstract`."""
    import jax

    adam_i, sched_i = split_chain(abstract.opt_state)
    adam = abstract.opt_state[adam_i]
    out = {}
    for prefix, tree in (("params/", abstract.params),
                         ("adam/mu/", adam.mu), ("adam/nu/", adam.nu)):
        out.update((_key(prefix, path), leaf) for path, leaf in
                   jax.tree_util.tree_flatten_with_path(tree)[0])
    out["adam/count"] = adam.count
    out["schedule/count"] = abstract.opt_state[sched_i].count
    out["step"] = abstract.step
    return out


def misfits(export, expected) -> list:
    """Every way the export's arrays and `expected` differ: keys that one
    side lacks, shapes and dtypes."""
    out = []
    for key in ("format", "kind"):
        if key not in export:
            out.append(f"missing {key}")
    if "format" in export and str(export["format"]) != FORMAT:
        out.append(f"format {str(export['format'])!r}, expected {FORMAT!r}")
    if "kind" in export and str(export["kind"]) != "nerf":
        out.append(f"kind {str(export['kind'])!r}, expected 'nerf'")
    keys = [k for k in export if k not in ("format", "kind")]
    out += [f"unexpected {k}" for k in sorted(set(keys) - set(expected))]
    out += [f"missing {k}" for k in sorted(set(expected) - set(keys))]
    for key in sorted(set(keys) & set(expected)):
        got, want = np.asarray(export[key]), expected[key]
        if got.shape != tuple(want.shape):
            out.append(f"{key}: shape {got.shape}, expected "
                       f"{tuple(want.shape)}")
        if got.dtype != np.dtype(want.dtype):
            out.append(f"{key}: dtype {got.dtype}, expected "
                       f"{np.dtype(want.dtype)}")
    return out


def state_from_export(config, export):
    """The JAX train state of `config` filled from the port's export
    `export` (arrays by key); raises, listing every misfit, unless each
    key of the export fills one array of the state with its shape and
    dtype."""
    import jax
    import jax.numpy as jnp

    abstract = abstract_state(config)
    expected = expected_arrays(abstract)
    bad = misfits(export, expected)
    if bad:
        raise ValueError(f"the export does not fit the train state of this "
                         f"config ({len(bad)} misfits): " + "; ".join(bad))

    def tree(prefix, like):
        return jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(export[_key(prefix, path)]), like)

    adam_i, sched_i = split_chain(abstract.opt_state)
    chain = list(abstract.opt_state)
    adam = chain[adam_i]
    chain[adam_i] = adam._replace(
        count=jnp.asarray(export["adam/count"]),
        mu=tree("adam/mu/", adam.mu), nu=tree("adam/nu/", adam.nu))
    chain[sched_i] = chain[sched_i]._replace(
        count=jnp.asarray(export["schedule/count"]))
    return abstract.replace(step=jnp.asarray(export["step"]),
                            params=tree("params/", abstract.params),
                            opt_state=tuple(chain))


def main(argv=None):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from ucnerf_tpu.cli import common

    parser = common.make_parser(__doc__)
    parser.formatter_class = argparse.RawDescriptionHelpFormatter
    parser.add_argument("--export", required=True,
                        help="npz written by the port's "
                             "convert.state_to_export")
    args = parser.parse_args(argv)
    config = common.load_config_from_args(args)

    import jax

    from ucnerf_tpu.train import checkpoints

    t0 = time.time()
    with np.load(args.export, allow_pickle=False) as data:
        export = {key: data[key] for key in data.files}
    if "step" not in export or np.asarray(export["step"]).shape != ():
        raise ValueError(f"{args.export}: no scalar step")
    step = int(export["step"])
    exp = os.path.abspath(config.exp_name)
    path = os.path.join(exp, "checkpoints", str(step))
    latest = checkpoints.latest_checkpoint_step(exp)
    if os.path.exists(path) or (latest is not None and latest > step):
        raise ValueError(f"{exp} holds checkpoint {latest}, at or after the "
                         f"export's step {step}: the import would replace "
                         f"it or the CLIs would read it instead; pass "
                         f"another Config.exp_name")
    state = state_from_export(config, export)
    del export
    checkpoints.save_checkpoint(exp, state, step, total_limit=0)
    n = sum(x.size for x in jax.tree.leaves(state.params))
    print(f"wrote {path}: step {step}, {n} parameters, in "
          f"{time.time() - t0:.1f} s")
    return path


if __name__ == "__main__":
    main()

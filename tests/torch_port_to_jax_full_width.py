"""The full-width round trip of a port train state through the JAX package's
orbax checkpoint, on the CPU: ``configs.waymo()`` (87.3 M parameters), its
Adam moments and counts filled from a seeded generator, written by
``convert.state_to_export``, imported by ``tools/import_port_checkpoint.py``
(orbax), exported again by ``tools/export_jax_checkpoint.py`` and imported
by ``convert.state_from_export``: every parameter, moment and count must
come back bitwise.  Prints the seconds of each stage and the bytes.

Run (from the repository root; ~6 GB of memory):
  python tests/torch_port_to_jax_full_width.py
"""

import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import export_jax_checkpoint as exporter
    import import_port_checkpoint as importer
    from ucnerf_tpu import configs as jconfigs
    from ucnerf_tpu_torch import configs as tconfigs
    from ucnerf_tpu_torch import convert
    from ucnerf_tpu_torch.train import state as tstate
    from ucnerf_tpu_torch.train import step as tstep

    cfg = tconfigs.waymo()
    rng = np.random.default_rng(0)

    def port_state(seed):
        return tstate.create_train_state(
            cfg, tstep.init_model(cfg, seed=seed, device="cpu"))

    arrays = convert.export_arrays(port_state(0))
    for key in list(arrays):
        if key.startswith("adam/mu/"):
            arrays[key] = rng.normal(0, 1e-3, arrays[key].shape).astype(
                np.float32)
        elif key.startswith("adam/nu/"):
            arrays[key] = rng.uniform(0, 1e-6, arrays[key].shape).astype(
                np.float32)
    for key in importer.COUNTS:
        arrays[key] = np.array(5, np.int32)
    state = convert.state_from_export(arrays, port_state(0))
    n = sum(p.numel() for p in state.model.parameters())
    want = convert.export_arrays(state)
    secs = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "port.npz")
        t0 = time.perf_counter()
        convert.state_to_export(state, npz)
        secs["port export (state_to_export)"] = time.perf_counter() - t0
        size = os.path.getsize(npz)
        del state
        exp = os.path.join(tmp, "jax")
        t0 = time.perf_counter()
        importer.main(["--preset", "waymo", "-b",
                       f"Config.exp_name = {exp!r}", "--export", npz])
        secs["orbax write (import_port_checkpoint)"] = (
            time.perf_counter() - t0)
        # The JAX package's own restore, into the CLI's train state.
        from ucnerf_tpu.train import checkpoints

        abstract = importer.abstract_state(jconfigs.waymo())
        t0 = time.perf_counter()
        restored, step = checkpoints.restore_checkpoint(exp, abstract)
        secs["orbax restore (restore_checkpoint)"] = time.perf_counter() - t0
        assert step == 5 and int(restored.step) == 5
        del restored
        back = os.path.join(tmp, "back.npz")
        t0 = time.perf_counter()
        exporter.main(["--exp", exp, "-o", back])
        secs["JAX export (export_jax_checkpoint)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = convert.state_from_export(convert.load_export(back, "nerf"),
                                          port_state(1))
        secs["port import (state_from_export)"] = time.perf_counter() - t0
        got = convert.export_arrays(again)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert np.array_equal(got[key], value), key
    print(f"full width: {n} parameters, export {size} bytes; every "
          f"parameter, moment and count bitwise after port -> orbax -> port")
    for stage, s in secs.items():
        print(f"  {stage}: {s:.2f} s")


if __name__ == "__main__":
    main()

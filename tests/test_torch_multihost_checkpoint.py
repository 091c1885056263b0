"""A JAX train state saved across several hosts, on the port: two JAX
processes (``tests/torch_multihost_checkpoint_worker.py``, launched as
``tests/test_multiprocess.py`` launches its workers) take one data-parallel
step together and save the state through
``ucnerf_tpu.train.checkpoints.save_checkpoint``, replicated and split
across the processes; ``tools/export_jax_checkpoint.py`` exports each
folder and ``convert.state_from_export`` imports it.  Both imports are
bitwise equal to the import of the same state saved by one process.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from ucnerf_tpu_torch import configs as tconfigs
from ucnerf_tpu_torch import convert
from ucnerf_tpu_torch.train import state as tstate
from ucnerf_tpu_torch.train import step as tstep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import export_jax_checkpoint as exporter  # noqa: E402

PROCESSES = 2


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The workers' folder: the replicated and the sharded checkpoints and
    the state's leaves."""
    outdir = str(tmp_path_factory.mktemp("multihost"))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    worker = os.path.join(ROOT, "tests",
                          "torch_multihost_checkpoint_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid), str(PROCESSES),
         outdir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for pid in range(PROCESSES)]
    outputs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outputs.append(out.decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    diag = "\n".join(f"--- worker {i} rc={p.returncode} ---\n{out}"
                     for i, (p, out) in enumerate(zip(procs, outputs)))
    for i in range(PROCESSES):
        err = os.path.join(outdir, f"proc{i}.err")
        if os.path.exists(err):
            with open(err) as f:
                diag += f"\n--- worker {i} traceback ---\n{f.read()}"
    assert all(p.returncode == 0 for p in procs), diag
    return outdir


@pytest.fixture(scope="module")
def single(saved):
    """The workers' state saved by this one process: its export."""
    from ucnerf_tpu import configs
    from ucnerf_tpu.train import checkpoints
    from ucnerf_tpu.train import state as state_lib
    from ucnerf_tpu.train import step as step_lib

    cfg = configs.tiny()
    _, params = step_lib.init_model(cfg, jax.random.PRNGKey(0))
    treedef = jax.tree.structure(state_lib.create_train_state(cfg, params))
    with np.load(os.path.join(saved, "leaves.npz")) as data:
        leaves = [data[k] for k in sorted(data.files)]
    state = jax.tree.unflatten(treedef, leaves)
    exp = os.path.join(saved, "single")
    checkpoints.save_checkpoint(exp, state, int(state.step))
    return exporter.nerf_arrays(exp)


def _import(export):
    cfg = tconfigs.tiny()
    return convert.state_from_export(export, tstate.create_train_state(
        cfg, tstep.init_model(cfg, seed=0, device="cpu")))


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
def test_multihost_save_imports_as_a_single_process_save(saved, single,
                                                         layout):
    exp = os.path.join(saved, layout)
    if layout == "sharded":
        # Each process wrote its own shards.
        names = os.listdir(os.path.join(exp, "checkpoints", "1"))
        assert any("process_1" in n for n in names), names
    multi = exporter.nerf_arrays(exp)
    assert set(multi) == set(single)
    for key, value in single.items():
        assert multi[key].dtype == value.dtype, key
        assert np.array_equal(multi[key], value), key
    a, b = _import(multi), _import(single)
    assert (a.step, a.optimizer.count) == (b.step, b.optimizer.count) == (
        1, 1)
    got, want = convert.export_arrays(a), convert.export_arrays(b)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert np.array_equal(got[key], value), key
    # The step moved the parameters off their initial values.
    assert np.abs(multi["adam/mu/nerf_mlp/density_hidden/kernel"]).max() > 0

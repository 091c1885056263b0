"""The port's process-group layer (``ucnerf_tpu_torch/parallel/mesh.py``)
against ``ucnerf_tpu/parallel/mesh.py``, and its collectives on 2 real gloo
ranks on the CPU.

The slicing and padding helpers are held equal to the JAX package's (same
integers, same arrays, the same ``ValueError`` for a ragged batch).  The
collectives move and add float32 values between two ranks, so their results
are held exactly: ``all_gather_rays`` is ``torch.cat`` of the ranks' slices
in rank order, and ``all_reduce_mean`` of two values is their float32 sum
times 0.5.

``launch_ranks`` starts the ranks through ``torchrun`` with one thread
each and a time limit; the ranks join their group through a file
rendezvous under the test's temporary folder (``rendezvous``, no TCP
port).  The other DP test files use both, and their ranks import this
module, so it imports JAX only in the tests that compare with it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ucnerf_tpu_torch.parallel import mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
               "MASTER_ADDR", "MASTER_PORT")


def rendezvous(folder, name="rendezvous"):
    """A file:// init method under `folder` (a fresh file per launch)."""
    return f"file://{os.path.join(str(folder), name)}"


def launch_ranks(cmd, world, timeout=240):
    """Run `cmd` as `world` ranks of one host through ``torchrun
    --standalone`` from the repo root, one thread a rank.  Returns the
    ranks' output; fails the test with it if a rank exits non-zero (torchrun
    then stops the others) or the launch outlasts `timeout` seconds."""
    with subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", "--no-python", *cmd],
            cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) as proc:
        try:
            out, _ = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()  # torchrun stops its ranks on SIGTERM
            out, _ = proc.communicate()
            pytest.fail(f"{out}\n(timed out after {timeout} s)")
    if proc.returncode:
        pytest.fail(f"{out}\n(torchrun exited {proc.returncode})")
    return out


@pytest.fixture
def jmesh():
    from ucnerf_tpu.parallel import mesh as jax_mesh
    return jax_mesh


@pytest.mark.parametrize("n,count", [(12, 1), (12, 2), (12, 3), (64, 4),
                                     (0, 2)])
def test_process_slice_matches_jax(jmesh, n, count):
    for index in range(count):
        assert mesh.process_slice(n, index, count) == \
            jmesh.process_slice(n, index, count)


def test_ragged_batch_raises_as_in_jax(jmesh):
    with pytest.raises(ValueError) as jerr:
        jmesh.process_slice(10, 0, 3)
    with pytest.raises(ValueError) as terr:
        mesh.process_slice(10, 0, 3)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n,multiple", [(10, 4), (12, 4), (1, 3), (7, 1)])
def test_pad_rays_to_multiple_matches_jax(jmesh, n, multiple):
    rng = np.random.default_rng(n)
    batch = {"origins": rng.normal(size=(n, 3)).astype(np.float32),
             "cam_idx": rng.integers(0, 9, n).astype(np.int32)}
    got, pad = mesh.pad_rays_to_multiple(batch, multiple)
    want, jpad = jmesh.pad_rays_to_multiple(batch, multiple)
    assert pad == jpad and (n + pad) % multiple == 0
    for k in batch:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_one_process_without_a_group(monkeypatch):
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert (mesh.rank(), mesh.world_size(), mesh.is_main_process(),
            mesh.launched()) == (0, 1, True, False)
    assert mesh.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cuda") == torch.device("cuda", 3)
    assert mesh.rank_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert mesh.launched()


def test_initialize_multihost_refuses_a_missing_launch(monkeypatch):
    """No fallback to one process: without torchrun's environment, or with
    NCCL on a CPU device, it raises."""
    for k in _LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.initialize_multihost("gloo")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        mesh.initialize_multihost("gloo")
    with pytest.raises(ValueError, match="nccl"):
        mesh.initialize_multihost("nccl", torch.device("cpu"),
                                  init_method="file:///nonexistent/x")


_COLLECTIVES = """
import json, os, sys
import torch
from ucnerf_tpu_torch.parallel import mesh
torch.set_num_threads(1)
group = mesh.initialize_multihost("gloo", torch.device("cpu"), sys.argv[1])
r, w = mesh.rank(), mesh.world_size()
assert mesh.initialize_multihost("gloo", torch.device("cpu"),
                                 sys.argv[1]) is group
n = 3
out = {"rgb": torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
              + 100 * r,
       "depth": torch.full((n,), float(r)),
       "cam": torch.full((n,), r, dtype=torch.int32)}
got = mesh.all_gather_rays(out, n, group)
mean = mesh.all_reduce_mean([torch.tensor(0.1 + r), torch.full((2,), 3.0 * r)],
                            group)
obj = mesh.broadcast_object({"from": r}, group)
shared = None
for index in (0, r):
    try:
        mesh._refuse_shared_cards(torch.device("cuda", index))
    except RuntimeError as e:
        shared = str(e)
        assert index == 0, e
res = {"rank": r, "world": w,
       "got": {k: v.tolist() for k, v in got.items()},
       "dtypes": {k: str(v.dtype) for k, v in got.items()},
       "mean": [m.tolist() for m in mean], "obj": obj, "shared": shared}
with open(sys.argv[2] + f"/collectives{r}.json", "w") as f:
    json.dump(res, f)
mesh.shutdown()
"""


def test_collectives_on_two_gloo_ranks(tmp_path):
    import json

    launch_ranks([sys.executable, "-c", _COLLECTIVES, rendezvous(tmp_path),
                  str(tmp_path)], 2)
    res = [json.load(open(tmp_path / f"collectives{r}.json"))
           for r in range(2)]
    n = 3
    want = {"rgb": torch.cat([torch.arange(n * 3, dtype=torch.float32)
                              .reshape(n, 3) + 100 * r for r in range(2)]),
            "depth": torch.tensor([0.0] * n + [1.0] * n),
            "cam": torch.tensor([0] * n + [1] * n, dtype=torch.int32)}
    mean0 = float((torch.tensor(0.1, dtype=torch.float32)
                   + torch.tensor(1.1, dtype=torch.float32)) * 0.5)
    for r, got in enumerate(res):
        assert (got["rank"], got["world"]) == (r, 2)
        for k, v in want.items():
            assert got["got"][k] == v.tolist(), k
            assert got["dtypes"][k] == str(v.dtype), k
        assert got["mean"] == [mean0, [1.5, 1.5]]
        assert got["obj"] == {"from": 0}
        # Two ranks on card 0 are refused on both ranks; one card each is
        # not.
        assert "two ranks on one card" in got["shared"]
        assert "--dist-backend gloo" in got["shared"]

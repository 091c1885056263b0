"""Worker of tests/test_torch_multihost_checkpoint.py: one of several JAX
processes that train one data-parallel step of the tiny preset together
(as ``tests/multiprocess_worker.py`` does, over a localhost coordinator, one
CPU device a process) and save the train state through
``ucnerf_tpu.train.checkpoints.save_checkpoint`` twice: as the training
CLI holds it (replicated on every process) under ``<outdir>/replicated``,
and with every array whose first axis the process count divides split
across the processes under ``<outdir>/sharded``.  Process 0 also writes
the state's leaves, in tree order, to ``<outdir>/leaves.npz``, for a save
of the same state from one process.

Run:  python tests/torch_multihost_checkpoint_worker.py <port> <pid> \\
          <nprocs> <outdir>
"""

import os
import sys


def main():
    port, pid, nprocs, outdir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{port}", nprocs, pid)
    assert jax.process_count() == nprocs

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from multiprocess_worker import make_local_batch
    from ucnerf_tpu import configs
    from ucnerf_tpu.parallel import mesh as meshlib
    from ucnerf_tpu.train import checkpoints
    from ucnerf_tpu.train import state as state_lib
    from ucnerf_tpu.train import step as step_lib

    cfg = configs.tiny()
    mesh = meshlib.create_mesh()
    model, params = step_lib.init_model(cfg, jax.random.PRNGKey(0))
    state = state_lib.create_train_state(cfg, params)
    train_step = step_lib.make_train_step(model, cfg, mesh=mesh)
    batch = meshlib.shard_local_batch(make_local_batch(pid, 32, cfg), mesh)
    state, _ = train_step(state, batch, jax.random.PRNGKey(5678),
                          jnp.float32(0.5))
    step = int(meshlib.fetch_to_host(state.step))

    checkpoints.save_checkpoint(os.path.join(outdir, "replicated"), state,
                                step)

    def split(x):
        spec = (PartitionSpec(meshlib.DATA_AXIS)
                if x.ndim and x.shape[0] % nprocs == 0 else PartitionSpec())
        return jax.device_put(x, NamedSharding(mesh, spec))

    sharded = jax.tree.map(split, state)
    assert not all(x.is_fully_addressable for x in jax.tree.leaves(sharded))
    checkpoints.save_checkpoint(os.path.join(outdir, "sharded"), sharded,
                                step)

    leaves = [meshlib.fetch_to_host(x) for x in jax.tree.leaves(state)]
    if pid == 0:
        np.savez(os.path.join(outdir, "leaves.npz"),
                 **{f"{i:04d}": np.asarray(x) for i, x in enumerate(leaves)})
    print(f"proc {pid} saved step {step}", flush=True)


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        import traceback
        with open(os.path.join(sys.argv[4], f"proc{sys.argv[2]}.err"),
                  "w") as f:
            traceback.print_exc(file=f)
        raise

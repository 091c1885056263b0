"""Data-parallel scaling of the train step (the port of
``tools/scaling_bench.py``).

Runs ``train/step.make_train_step`` with a process group of W ranks for
each W of ``--ranks`` and reports, for each W and mode:
- step rays/s (the global batch over the median step time of rank 0, host
  clock around a step that ends in ``torch.cuda.synchronize()``) and the
  efficiency against the smallest W (rays/s over W times its per-rank
  rays/s);
- the gradient all-reduce: milliseconds (CUDA events on the card, the host
  clock on the CPU), bytes a step, and its share of the step;
- peak memory per rank (``torch.cuda.max_memory_allocated``; not measured
  on the CPU);
- the collectives one step issues, with their bytes (every
  ``torch.distributed`` collective is recorded while the step runs): the
  port's counterpart of ``tools/collective_audit.py``, which expects one
  gradient all-reduce of exactly the parameters' bytes and one small
  all-reduce of the stats (``audit_ok``).

Two modes:
- ``weak``: a constant batch a rank, the preset's batch_size (set it with
  ``-b "Config.batch_size = ..."``), as the JAX tool sweeps;
- ``strong``: a fixed global batch, the preset's batch_size, B / W a rank,
  as the reference's ``batch_size // world``; a rank then holds uneven
  shares of a microbatch where W does not divide it
  (``step.microbatch_shares``).
The microbatch count stays the preset's in both.  The rays are the JAX
tool's ``dummy_batch`` (seed 0), each rank's ``process_slice`` of the
global batch; each step draws its jitter and hex patterns from a generator
seeded as the training CLI seeds it.

The sweep is one launch of ``torch.distributed.run`` (``--standalone``,
max(W) ranks joined through a file rendezvous in a temporary folder); each
W runs in a group of ranks 0..W-1 while the others wait on the host, and
starts from the same initial weights.  On a machine with several cards
each rank takes a card of its own over NCCL (W above the card count is
skipped); with one card every rank runs on it
over gloo, and with ``--device cpu`` on the CPU over gloo: those sweeps are
marked ``wiring_only``, as the JAX tool marks its virtual CPU mesh (ranks
that share one device or one host's cores say nothing of scaling).

Prints one JSON line at the end (and writes it to ``--out``).

Usage:
  python -m ucnerf_tpu_torch.tools.scaling_bench --preset waymo \\
      --ranks 1,2,4,8 --steps 5
  python -m ucnerf_tpu_torch.tools.scaling_bench --preset tiny --ranks 1,2 \\
      --device cpu --steps 2   # wiring only
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
MODES = ("weak", "strong")
# Every collective of torch.distributed that a step could issue.
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "barrier")


def card_line():
    """nvidia-smi's name and power limit of each card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return "; ".join(line.strip() for line in out.splitlines() if line)


def _tensor_bytes(obj):
    """Bytes of the first tensor among a collective's arguments (the one a
    rank sends), or 0."""
    import torch
    for a in obj:
        if torch.is_tensor(a):
            return a.numel() * a.element_size(), str(a.dtype)
        if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
            return (sum(t.numel() * t.element_size() for t in a),
                    str(a[0].dtype))
    return 0, None


@contextlib.contextmanager
def record_collectives(log):
    """Append {"op", "bytes", "dtype"} to `log` for every torch.distributed
    collective called inside the block."""
    import torch.distributed as dist
    saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}

    def wrap(name, fn):
        def call(*args, **kwargs):
            nbytes, dtype = _tensor_bytes(list(args) + list(kwargs.values()))
            log.append({"op": name, "bytes": nbytes, "dtype": dtype})
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def audit(collectives, param_bytes):
    """One gradient all-reduce of exactly the parameters' bytes and one
    smaller all-reduce (the stats), nothing else."""
    ops = [c["op"] for c in collectives]
    sizes = sorted(c["bytes"] for c in collectives)
    return (ops == ["all_reduce", "all_reduce"] and sizes[1] == param_bytes
            and sizes[0] < param_bytes)


def batches(cfg, world):
    """{mode: global batch} of the modes W ranks can run: weak keeps the
    preset's batch a rank, strong the preset's batch in all."""
    micro = max(cfg.microbatches, 1)
    out = {"weak": cfg.batch_size * world, "strong": cfg.batch_size}
    return {m: b for m, b in out.items() if b % world == 0 and b % micro == 0}


def worker(spec_path):
    """One rank of the sweep's launch: for each world size W of the spec, a
    group of ranks 0..W-1 runs the train step on each mode's global batch,
    timed, while the other ranks wait; writes <out>/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from ucnerf_tpu_torch import configs
    from ucnerf_tpu_torch.cli import train as cli_train
    from ucnerf_tpu_torch.parallel import mesh
    from ucnerf_tpu_torch.train import state as state_lib
    from ucnerf_tpu_torch.train import step as step_lib

    with open(spec_path) as f:
        spec = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    local_rank = int(os.environ["LOCAL_RANK"])
    if spec["device"] == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", local_rank
                              if spec["backend"] == "nccl" else 0)
        torch.cuda.set_device(device)
    on_card = device.type == "cuda"
    mesh.initialize_multihost(spec["backend"], device, spec["init"])
    rank = mesh.rank()
    # The ranks outside a world size's group wait here, on the host.
    waiting = dist.new_group(backend="gloo")
    cfg = configs.load_config(spec["preset"], spec["bindings"])
    micro = max(cfg.microbatches, 1)
    model = step_lib.init_model(cfg, seed=0, device=device)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())

    reduces = []
    all_reduce_grads = mesh.all_reduce_grads

    def timed_reduce(ps, g=None):
        ps = list(ps)
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            all_reduce_grads(ps, g)
            end.record()
            end.synchronize()
            reduces.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            all_reduce_grads(ps, g)
            reduces.append(1e3 * (time.perf_counter() - t0))

    mesh.all_reduce_grads = timed_reduce

    def sync():
        if on_card:
            torch.cuda.synchronize()

    generator = torch.Generator(device=device)
    res = {"rank": rank, "param_bytes": param_bytes, "worlds": {}}
    for world, modes in spec["sweep"]:
        group = dist.new_group(list(range(world)))
        if rank < world:
            # Every world size starts from the same replicas.
            model.load_state_dict(initial)
            state = state_lib.create_train_state(cfg, model)
            train_step = step_lib.make_train_step(model, cfg, group)
            out = res["worlds"][str(world)] = {}
            count = 0
            for mode, n in modes.items():
                lo, hi = mesh.process_slice(n, rank, world)
                batch = step_lib.batch_to_device(
                    {k: v[lo:hi]
                     for k, v in step_lib.dummy_batch(cfg, n).items()},
                    device)
                shares = step_lib.microbatch_shares(n, world, micro)[rank]
                if on_card:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                seconds, collectives = [], []
                del reduces[:]
                for i in range(1 + spec["steps"]):
                    count += 1
                    generator.manual_seed(
                        cli_train._step_seed(5678, count, rank))
                    log = []
                    sync()
                    t0 = time.perf_counter()
                    with record_collectives(log):
                        state, stats = train_step(state, batch, 0.5,
                                                  generator=generator)
                    sync()
                    if i:  # after the warm-up step
                        seconds.append(time.perf_counter() - t0)
                        collectives.append(log)
                loss = float(stats["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"{world} ranks, {mode}: loss "
                                             f"{loss}")
                out[mode] = {
                    "global_batch": n, "rays": hi - lo,
                    "shares_min": int(shares.min()),
                    "shares_max": int(shares.max()),
                    "step_seconds": seconds,
                    "all_reduce_ms": reduces[1:],
                    "peak_bytes": (torch.cuda.max_memory_allocated()
                                   if on_card else None),
                    "collectives": collectives[0],
                    "same_collectives_every_step": all(
                        c == collectives[0] for c in collectives),
                    "loss": loss}
            del state, train_step, batch
        dist.barrier(group=waiting)
    mesh.shutdown()
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def launch(folder, spec, timeout):
    """This module's worker as max(W) ranks through torch.distributed.run;
    returns the ranks' results.  Raises with the end of the launch's log
    if a rank fails or the launch outlasts `timeout` seconds."""
    world = max(w for w, _ in spec["sweep"])
    spec = dict(spec, out=folder,
                init="file://" + os.path.join(folder, "rendezvous"))
    path = os.path.join(folder, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    log_path = os.path.join(folder, "launch.log")
    with open(log_path, "w") as log, subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={world}", "--no-python", sys.executable,
             "-m", "ucnerf_tpu_torch.tools.scaling_bench", "--worker", path],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT) as proc:
        try:
            rc = proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()  # torch.distributed.run stops its ranks
            proc.wait()
            rc = "timeout"
    if rc:
        with open(log_path) as f:
            raise RuntimeError(f"{world} ranks: exit {rc}\n"
                               f"{f.read()[-8000:]}")
    out = []
    for r in range(world):
        with open(os.path.join(folder, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def point(mode, world, ranks):
    """One sweep point from the results of ranks 0..world-1 (rank 0's
    times)."""
    mine = [r["worlds"][str(world)][mode] for r in ranks[:world]]
    r0 = mine[0]
    step_ms = 1e3 * float(np.median(r0["step_seconds"]))
    ar_ms = float(np.median(r0["all_reduce_ms"]))
    grads = [c for c in r0["collectives"] if c["op"] == "all_reduce"]
    param_bytes = ranks[0]["param_bytes"]
    return {
        "mode": mode, "ranks": world, "global_batch": r0["global_batch"],
        "rays_per_rank": r0["rays"],
        "shares": [min(m["shares_min"] for m in mine),
                   max(m["shares_max"] for m in mine)],
        "step_ms": step_ms,
        "rays_per_sec": r0["global_batch"] / (step_ms / 1e3),
        "all_reduce_ms": ar_ms,
        "all_reduce_bytes": max(c["bytes"] for c in grads) if grads else 0,
        "all_reduce_share": ar_ms / step_ms,
        "peak_bytes_per_rank": [m["peak_bytes"] for m in mine],
        "collectives_per_step": r0["collectives"],
        "param_bytes": param_bytes,
        "audit_ok": all(audit(m["collectives"], param_bytes)
                        and m["same_collectives_every_step"] for m in mine),
        "loss": r0["loss"],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", default="1,2,4,8",
                   help="comma-separated world sizes to sweep")
    p.add_argument("--preset", default="tiny",
                   choices=["tiny", "waymo", "waymo_tpu"])
    p.add_argument("--steps", type=int, default=5,
                   help="timed steps a point, after one warm-up step")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--binding", "-b", action="append", default=[])
    p.add_argument("--timeout", type=float, default=1800,
                   help="seconds the sweep's launch may take")
    p.add_argument("--out", help="also write the JSON line here")
    p.add_argument("--worker", metavar="SPEC", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    sizes = sorted({int(s) for s in args.ranks.split(",")})

    import torch

    from ucnerf_tpu_torch import configs
    if args.device == "cpu":
        backend, cards, card = "gloo", 0, None
        device_name = "cpu"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("no CUDA device; pass --device cpu for a "
                               "wiring run on the CPU")
        backend = "nccl" if cards > 1 else "gloo"
        card = card_line()
        device_name = torch.cuda.get_device_name(0)
    wiring_only = backend == "gloo"
    if backend == "nccl":
        skipped = [w for w in sizes if w > cards]
        sizes = [w for w in sizes if w <= cards]
        if skipped:
            print(f"ranks {skipped} skipped: {cards} cards", file=sys.stderr)
    cfg = configs.load_config(args.preset, args.binding)

    sweep = []
    for world in sizes:
        modes = batches(cfg, world)
        if modes:
            sweep.append((world, modes))
        else:
            print(f"ranks {world}: no mode's batch splits over {world} "
                  f"ranks and {cfg.microbatches} microbatches",
                  file=sys.stderr)
    if not sweep:
        raise ValueError("nothing to run")
    folder = tempfile.mkdtemp(prefix="ucnerf_scaling_")
    try:
        t0 = time.perf_counter()
        ranks = launch(folder, {
            "device": args.device, "backend": backend,
            "preset": args.preset, "bindings": args.binding,
            "sweep": sweep, "steps": args.steps},
            args.timeout)
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    rows = [point(mode, world, ranks) for world, modes in sweep
            for mode in modes]
    for mode in MODES:
        mine = [r for r in rows if r["mode"] == mode]
        if not mine:
            continue
        base = mine[0]["rays_per_sec"] / mine[0]["ranks"]
        for r in mine:
            r["efficiency"] = r["rays_per_sec"] / (r["ranks"] * base)
            print(f"  {mode:6s} ranks={r['ranks']:2d} batch "
                  f"{r['global_batch']:6d} shares {r['shares']}: "
                  f"{r['rays_per_sec']:10.1f} rays/s, efficiency "
                  f"{r['efficiency']:6.1%}, all-reduce "
                  f"{r['all_reduce_ms']:.3f} ms of {r['step_ms']:.1f} "
                  f"({r['all_reduce_bytes']} B), audit "
                  f"{'ok' if r['audit_ok'] else 'FAILED'}", file=sys.stderr)
    result = {
        "metric": "data_parallel_scaling", "preset": args.preset,
        "bindings": args.binding, "device": device_name, "cards": cards,
        "card": card, "backend": backend, "wiring_only": wiring_only,
        "microbatches": cfg.microbatches, "steps": args.steps,
        "launch_seconds": secs, "sweep": rows,
        "audit_ok": bool(rows) and all(r["audit_ok"] for r in rows)}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["audit_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

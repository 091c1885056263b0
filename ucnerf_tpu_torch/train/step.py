"""Model construction, the train step and the image renderer
(port of ``ucnerf_tpu/train/step.py``: ``init_model``, ``dummy_batch``,
``make_train_step``, ``make_eval_step`` and ``render_image``).

``make_train_step`` runs the JAX step's microbatch accumulation as one
Python loop (the JAX scan and ``host_microbatches`` are two ways of running
it): forward, losses and backward per microbatch, gradients summed and
scaled by 1/microbatches, then one optimizer update.  ``render_image``
chunks an image's rays on the host, renders each chunk with the eval step
(optionally in ``render_subchunks`` sequential pieces, which bound the
activation peak at the piece's size), and reassembles numpy arrays.

Both take an optional process group (``parallel/mesh.py``): the step then
receives the rank's local batch, takes its share of each global microbatch
(``microbatch_shares``) and averages the ranks' gradients and stats, and
the render splits each chunk over the ranks and gathers it back (the JAX
package's mesh-sharded step and render).

On a card, and without a group, the train step replays its microbatch loop
from a CUDA graph once the shapes of a call have repeated: the same kernels
in the same order, issued by one graph launch instead of one host launch
each (``_StepGraph``).

Under a profiler, each microbatch's backward, each graph replay, the step's
optimizer update and ``render_image`` show as ``ucnerf.*`` spans
(``utils/spans.py``).
"""

from __future__ import annotations

import functools
import gc
from typing import Dict

import numpy as np
import torch

from ucnerf_tpu_torch.configs import Config
from ucnerf_tpu_torch.models.model import UCNeRFModel
from ucnerf_tpu_torch.parallel import mesh as meshlib
from ucnerf_tpu_torch.train import losses as losses_lib
from ucnerf_tpu_torch.train.state import TrainState
from ucnerf_tpu_torch.utils.spans import span, spanned


def init_model(config: Config, seed: int = 0, device="cuda") -> UCNeRFModel:
    """Construct the model with parameters drawn from a seeded generator.

    Parameters are drawn on the CPU (so a seed gives the same weights on
    every device) and then moved to `device`.
    """
    generator = torch.Generator().manual_seed(seed)
    model = UCNeRFModel(config, generator)
    return model.to(device).eval()


def dummy_batch(config: Config, n: int) -> Dict[str, np.ndarray]:
    """A synthetic ray batch with the canonical layout (the JAX package's
    ``dummy_batch``: spatially diverse random rays)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origins = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
    return {
        "origins": origins,
        "directions": d.copy(),
        "viewdirs": d.copy(),
        "cam_dirs": d.copy(),
        "radii": np.full((n, 1), 1e-3, np.float32),
        "near": np.full((n, 1), config.near, np.float32),
        "far": np.full((n, 1), config.far, np.float32),
        "cam_idx": (rng.integers(0, max(config.training_views, 1), n)
                    .astype(np.int32)),
        "phys_cam_idx": (rng.integers(0, max(config.num_phys_cams, 1), n)
                         .astype(np.int32)),
        "lossmult": np.ones((n, 1), np.float32),
        "rgb": np.full((n, 3), 0.5, np.float32),
        "sky_segs": np.zeros((n,), np.float32),
    }


@spanned("ucnerf.data.to_device")
def batch_to_device(arrays, device) -> Dict[str, torch.Tensor]:
    """Host ray arrays as tensors on `device`, 64-bit floats and ints
    narrowed to 32 bits (the data layer casts rays in float64; the JAX
    package narrows the same way when an array reaches the device)."""
    narrow = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        v = np.array(v, dtype=narrow.get(v.dtype, v.dtype))  # a writable copy
        out[k] = torch.from_numpy(v).to(device)
    return out


def microbatch_shares(batch: int, world: int, microbatches: int):
    """The rays each rank takes of each global microbatch: an int array
    [world, microbatches] whose columns sum to N = batch / microbatches,
    whose rows sum to batch / world, and whose entries are floor(N / world)
    or ceil(N / world) (0 where N < world).  The ceil cells lie cyclically:
    row r holds a = batch / world - microbatches * floor(N / world) of them,
    in columns r a, ..., r a + a - 1 (mod microbatches), so each column
    gets N mod world.  Raises, as ``process_slice`` and the JAX package's
    sharded reshape do, unless world and microbatches divide batch."""
    if batch % world:
        raise ValueError(f"global batch {batch} not divisible by {world} "
                         f"processes")
    if batch % microbatches:
        raise ValueError(f"{batch} rays do not split into {microbatches} "
                         f"microbatches")
    floor = batch // microbatches // world
    ceils = batch // world - microbatches * floor
    shares = np.full((world, microbatches), floor, np.int64)
    for r in range(world):
        shares[r, (r * ceils + np.arange(ceils)) % microbatches] += 1
    return shares


def make_train_step(model: UCNeRFModel, config: Config, group=None,
                    graphs: bool = True):
    """Build the train step.

    Returns ``train_step(state, batch, train_frac, generator=None,
    rand_vec=None) -> (state, stats)``.  batch is a dict of [n, ...] tensors
    on the model's device (the ``dummy_batch`` layout).  With a
    ``torch.Generator`` the forward draws its jitter and hex patterns from
    it (the JAX keyed step); without one it is deterministic and
    ``rand_vec`` [n, 3] fixes the hex basis.  stats holds the microbatch
    means of the total (``loss``), of each loss term (``losses``) and of
    the per-level MSEs (``mses``), as tensors.

    The step is the JAX step's: the mean, over ``config.microbatches``
    global microbatches of N = B / microbatches rays, of each microbatch's
    ray-mean gradient, then one optimizer update.  Without a group B = n,
    and microbatch i is rays [i N, (i + 1) N).

    With a process `group` of W ranks, batch is this rank's B / W rays of
    the global batch B (every rank passes as many).  The step runs
    whenever W and the microbatch count divide B, as the JAX package's
    sharded step does: rank r takes ``microbatch_shares(B, W, M)[r, i]``
    rays of global microbatch i, its rays in order, floor or ceil of N / W.
    Each microbatch's total is scaled by W n / N before its backward (the
    multiply is skipped where the weight is 1, so equal shares are
    bitwise what they were), and so are its loss terms and stats; an empty
    share runs no forward.  One all-reduce then replaces each gradient by
    the ranks' mean (``mesh.all_reduce_grads``), before the optimizer
    cleans, clips and steps, and a second, small one averages the stats.
    That is the global microbatches' gradient because every loss term is
    a ray mean or independent of the rays (the data loss divides by the
    sum of ``lossmult``, which every dataset sets to 1; where it varied,
    the weighted shares would not be the global mean).  At W = 1 the
    reduce is the identity, bit for bit.

    On CUDA tensors and without a group, the microbatch loop (forwards,
    losses, backwards into ``.grad`` and the sums of the losses and stats)
    runs from a CUDA graph once a call's key repeats the previous call's:
    the key is the shares, every batch tensor's name, shape and dtype, the
    hex basis's shape, the device, the generator and the parameters'
    storage.  A call whose key differs from the previous call's runs
    eagerly; one that repeats it captures the loop and replays it, and
    later calls with that key replay it.  The step keeps one graph: a
    capture for another key drops the one before.  Each replay reads the
    batch and the hex basis copied into the graph's buffers, and
    ``model.schedule(train_frac)`` as 0-d tensors, draws from the
    generator where the eager step would (the graph holds the generator's
    state), and leaves the gradients in the ``.grad`` tensors the call
    before the capture made, zeroed first inside the graph (0 + g is g),
    so the step is bitwise the eager step.  The 1/microbatches scale and
    the optimizer stay eager.  ``train_step.captures`` and
    ``train_step.replays`` count the graphs captured and run; each replay
    shows as the span ``ucnerf.graph_replay``.  The kernel wrappers'
    launch counters count the launches their Python issues, so a replay
    adds nothing to them.  ``graphs=False`` keeps every call eager.

    The JAX package recomputes the fields in the backward
    (``remat_fields``, for a TPU's 16 GB); the port keeps the activations
    and ignores that knob.
    """
    return _TrainStep(config, group, graphs)


class _TrainStep:
    """``make_train_step``'s step; ``captures`` and ``replays`` count its
    graphs' captures and runs.  (A class, so that the step holds no
    reference to itself and its graph goes with it.)"""

    def __init__(self, config: Config, group, graphs: bool):
        self.config, self.group = config, group
        self.num_micro = max(config.microbatches, 1)
        self.world, self.rank = ((1, 0) if group is None else
                                 (meshlib.world_size(group),
                                  meshlib.rank(group)))
        self.graphs = graphs and group is None
        self.graph = None
        self.last_key = None
        self.captures = 0
        self.replays = 0

    def _accumulate(self, model, batch, shares, train_frac, generator,
                    rand_vec, schedule):
        """The microbatch loop: each share's forward, losses and backward
        into ``.grad``; returns the sums of the total, the loss terms and
        the stats."""
        world = self.world
        starts = np.cumsum([0] + shares).tolist()
        per_micro = sum(shares) * world // self.num_micro
        total_acc = losses_acc = stats_acc = None
        for i, size in enumerate(shares):
            if not size:
                continue
            part = slice(starts[i], starts[i] + size)
            mb = {k: v[part] for k, v in batch.items()}
            renderings, ray_history = model(
                mb, train_frac, None if rand_vec is None else rand_vec[part],
                compute_extras=False, train=True, generator=generator,
                schedule=schedule)
            total, losses, stats = losses_lib.compute_all_losses(
                mb, renderings, ray_history, self.config)
            if world * size != per_micro:
                weight = world * size / per_micro
                total = total * weight
                losses = {k: v * weight for k, v in losses.items()}
                stats = {k: v * weight for k, v in stats.items()}
            with span("ucnerf.backward"):
                total.backward()
            del renderings, ray_history
            if total_acc is None:
                total_acc = total.detach()
                losses_acc = {k: v.detach() for k, v in losses.items()}
                stats_acc = {k: v.detach() for k, v in stats.items()}
            else:
                total_acc = total_acc + total.detach()
                losses_acc = {k: losses_acc[k] + v.detach()
                              for k, v in losses.items()}
                stats_acc = {k: stats_acc[k] + v.detach()
                             for k, v in stats.items()}
        return total_acc, losses_acc, stats_acc

    def __call__(self, state: TrainState, batch, train_frac, generator=None,
                 rand_vec=None):
        group, num_micro = self.group, self.num_micro
        n = batch["origins"].shape[0]
        shares = microbatch_shares(n * self.world, self.world,
                                   num_micro)[self.rank].tolist()
        params = list(state.model.parameters())
        key = _graph_key(batch, shares, generator, rand_vec, params) \
            if self.graphs else None
        graph = self.graph
        if graph is not None and graph.key != key:
            graph = None
        if graph is None and key is not None and key == self.last_key:
            self.graph = None  # its pool goes before the next capture
            graph = self.graph = _StepGraph(
                key, functools.partial(self._accumulate, state.model,
                                       shares=shares, train_frac=train_frac,
                                       generator=generator),
                params, batch, rand_vec, state.model.schedule(train_frac),
                generator)
            self.captures += 1
        self.last_key = key
        if graph is None:
            for p in params:
                p.grad = None
            total_acc, losses_acc, stats_acc = self._accumulate(
                state.model, batch, shares, train_frac, generator, rand_vec,
                None)
        else:
            total_acc, losses_acc, stats_acc = graph.replay(
                batch, rand_vec, state.model.schedule(train_frac))
            self.replays += 1
        inv = 1.0 / num_micro
        with span("ucnerf.optimizer"):
            if num_micro > 1:
                with torch.no_grad():
                    for p in params:
                        if p.grad is not None:
                            p.grad.mul_(inv)
            if group is not None:
                meshlib.all_reduce_grads(params, group)
            state.optimizer.update()
        new_state = TrainState(step=state.step + 1, model=state.model,
                               optimizer=state.optimizer)
        out = {k: v * inv for k, v in stats_acc.items()}
        out["loss"] = total_acc * inv
        out["losses"] = {k: v * inv for k, v in losses_acc.items()}
        if group is not None:
            out = _mean_over_ranks(out, group)
        return new_state, out


def _graph_key(batch, shares, generator, rand_vec, params,
               devices=("cuda",)):
    """The key under which a train step's call may replay a graph, or None
    where it stays eager: tensors on a device whose type is not among
    `devices`, or a generator on another device."""
    dev = batch["origins"].device
    if dev.type not in devices or (
            generator is not None and generator.device.type != dev.type):
        return None
    return (dev, tuple(shares),
            tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items()),
            None if rand_vec is None else tuple(rand_vec.shape),
            None if generator is None else id(generator),
            tuple(p.data_ptr() for p in params))


class _CudaGraph:
    """One call of `body` captured as a CUDA graph: ``outputs`` are its
    results, which each ``replay()`` writes anew.  A generator the body
    draws from is registered, so that each replay draws at the
    generator's state then and advances it as the eager calls would."""

    def __init__(self, body, generator):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        # A graph that the garbage collector destroys during a capture
        # ends that capture, so the collector waits until it is done.
        collecting = gc.isenabled()
        gc.disable()
        try:
            # Capture frees the cached blocks of the eager calls first.
            with torch.cuda.graph(self.graph):
                self.outputs = body()
        finally:
            if collecting:
                gc.enable()

    def replay(self):
        self.graph.replay()


class _StepGraph:
    """A train step's microbatch loop for one key as a graph over buffers
    of its own: the batch and the hex basis it reads, and the schedule's
    values as 0-d float32 tensors.  The gradients go into the parameters'
    ``.grad`` as the call before the capture left them (zeros where it
    left none), which the graph zeroes before the loop.  The first replay
    follows the capture at once."""

    def __init__(self, key, loop, params, batch, rand_vec, schedule,
                 generator):
        self.key, self.params = key, params
        self.batch = {k: v.clone() for k, v in batch.items()}
        self.rand_vec = None if rand_vec is None else rand_vec.clone()
        dev = batch["origins"].device
        self.schedule = {
            k: (tuple(_scalar(x, dev) for x in v) if isinstance(v, tuple)
                else _scalar(v, dev)) for k, v in schedule.items()}
        self.grads = [torch.zeros_like(p) if p.grad is None else p.grad
                      for p in params]
        self._attach_grads()

        def body():
            for g in self.grads:
                g.zero_()
            return loop(self.batch, rand_vec=self.rand_vec,
                        schedule=self.schedule)

        self.graph = _CudaGraph(body, generator)

    def _attach_grads(self):
        for p, g in zip(self.params, self.grads):
            p.grad = g

    def replay(self, batch, rand_vec, schedule):
        """Run the loop on `batch`, `rand_vec` and the `schedule`'s floats;
        returns the sums of the total, the loss terms and the stats (the
        graph's own tensors, which the next replay overwrites)."""
        for k, v in batch.items():
            self.batch[k].copy_(v)
        if rand_vec is not None:
            self.rand_vec.copy_(rand_vec)
        for k, v in schedule.items():
            if isinstance(v, tuple):
                for t, x in zip(self.schedule[k], v):
                    t.fill_(x)
            else:
                self.schedule[k].fill_(v)
        self._attach_grads()
        with span("ucnerf.graph_replay"):
            self.graph.replay()
        return self.graph.outputs


def _scalar(value, device):
    """A 0-d float32 tensor holding float32(value) on `device`."""
    return torch.full((), value, dtype=torch.float32, device=device)


def _mean_over_ranks(stats, group):
    """stats (tensors, and a dict of them under ``losses``) averaged over
    the ranks in one all-reduce."""
    keys = [k for k in stats if k != "losses"]
    loss_keys = list(stats["losses"])
    means = meshlib.all_reduce_mean(
        [stats[k] for k in keys] + [stats["losses"][k] for k in loss_keys],
        group)
    out = dict(zip(keys, means))
    out["losses"] = dict(zip(loss_keys, means[len(keys):]))
    return out


def hex_basis(seed: int, n: int) -> torch.Tensor:
    """The eval step's hex-basis vectors for a chunk of n rays: [n, 3]
    normals on the CPU from a generator seeded from (seed, n)."""
    mixed = np.random.SeedSequence((seed, n)).generate_state(1, np.uint64)[0]
    generator = torch.Generator().manual_seed(int(mixed >> np.uint64(1)))
    return torch.randn((n, 3), generator=generator)


def make_eval_step(model: UCNeRFModel, config: Config,
                   compute_extras: bool = True, seed: int = 0):
    """Build the eval render step over one flat ray chunk.

    Returns ``eval_step(batch, train_frac, eval_camidx, rand_vec=None)``:
    batch is a dict of [N, ...] tensors on the model's device; rand_vec
    ([N, 3]) fixes the hex basis and, when None, is ``hex_basis(seed, n)``
    for each (sub-)chunk of n rays: drawn on the CPU from a
    ``torch.Generator`` seeded from (`seed`, n), moved to the model's device
    and kept there for the next chunk of that size.  So, as in the JAX
    package (``PRNGKey(0)`` with ``key=None``), the basis depends on the
    chunk's shape alone, and a render is a function of the weights and the
    rays: the same on every call and on every device.  The ``grid_bwd_*``
    config knobs only shape a backward pass and are ignored, as in the JAX
    package.  Returns the final level's rendering: rgb [N, 3], depth and acc
    [N] and, with compute_extras, the ``distance_*`` statistics.
    """
    device = next(model.parameters()).device
    sub = max(config.render_subchunks, 1)

    # A render holds a few chunk sizes: full chunks, their sub-chunks and a
    # last, shorter chunk.
    @functools.lru_cache(maxsize=8)
    def basis(n):
        return hex_basis(seed, n).to(device)

    def eval_one(batch, train_frac, eval_camidx, rand_vec):
        if rand_vec is None:
            rand_vec = basis(batch["origins"].shape[0])
        renderings, _ = model(batch, train_frac, rand_vec,
                              compute_extras=compute_extras,
                              eval_camidx=eval_camidx)
        out = dict(renderings[-1])
        for k in ("weights", "sky_rgbs", "affine_trans", "affine_trans_sky"):
            out.pop(k, None)
        return out

    @torch.no_grad()
    def eval_step(batch, train_frac, eval_camidx, rand_vec=None):
        if sub == 1:
            return eval_one(batch, train_frac, eval_camidx, rand_vec)
        n = batch["origins"].shape[0]
        if n % sub:
            raise ValueError(f"chunk of {n} rays does not split into "
                             f"{sub} sub-chunks")
        step = n // sub
        outs = []
        for i in range(sub):
            part = slice(i * step, (i + 1) * step)
            outs.append(eval_one(
                {k: v[part] for k, v in batch.items()}, train_frac,
                eval_camidx, None if rand_vec is None else rand_vec[part]))
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    eval_step.device = device
    eval_step.basis = basis
    return eval_step


@spanned("ucnerf.render")
def render_image(eval_step, batch, config: Config, train_frac=1.0,
                 eval_camidx=0, rand_vec=None, group=None):
    """Render all rays of an image by chunking through the eval step.

    Args:
      eval_step: from make_eval_step.
      batch: dict of [H, W, ...] ray arrays (host numpy).
      eval_camidx: brightness-correction view id for this render.
      rand_vec: optional [H, W, 3] hex-basis vectors (else eval_step draws).
      group: optional process group of W ranks, each of which calls this
        with the same arguments: each chunk is padded to a multiple of
        W x render_subchunks rays, each rank renders its ``process_slice``
        of it, and ``all_gather_rays`` hands every rank the whole chunk.
        The hex basis of a chunk is the one a single process would draw for
        it (padded and sliced like the rays), so the render is the same at
        every W up to the rounding of batched arithmetic over other sizes.

    Returns:
      dict of [H, W, ...] numpy arrays, on every rank.
    """
    height, width = batch["origins"].shape[:2]
    num_rays = height * width
    flat = {k: np.asarray(v).reshape((num_rays,) + np.shape(v)[2:])
            for k, v in batch.items() if v is not None}
    if rand_vec is not None:
        flat["rand_vec"] = np.asarray(rand_vec, np.float32).reshape(
            num_rays, 3)

    world, rank = ((1, 0) if group is None else
                   (meshlib.world_size(group), meshlib.rank(group)))
    sub = max(config.render_subchunks, 1)
    chunk = config.render_chunk_size
    outs = []
    for i0 in range(0, num_rays, chunk):
        part = {k: v[i0:i0 + chunk] for k, v in flat.items()}
        n = next(iter(part.values())).shape[0]
        part, pad = meshlib.pad_rays_to_multiple(part, world * sub)
        lo, hi = meshlib.process_slice(n + pad, rank, world)
        tensors = batch_to_device({k: v[lo:hi] for k, v in part.items()},
                                  eval_step.device)
        rv = tensors.pop("rand_vec", None)
        if rv is None:
            # One process's basis for the chunk (hex_basis of its
            # sub-chunks' size, for each), edge-padded as the rays.
            rv = eval_step.basis(-(-n // sub)).repeat(sub, 1)[:n]
            rv = torch.cat([rv, rv[-1:].expand(pad, 3)])[lo:hi]
        out = eval_step(tensors, train_frac, eval_camidx, rv)
        if world > 1:
            out = meshlib.all_gather_rays(out, hi - lo, group)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if pad:
            out = {k: v[:-pad] for k, v in out.items()}
        outs.append(out)

    rendering = {}
    for k in outs[0]:
        z = np.concatenate([o[k] for o in outs], axis=0)
        rendering[k] = z.reshape((height, width) + z.shape[1:])
    return rendering

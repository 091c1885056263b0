"""Data parallelism over processes with ``torch.distributed`` (port of
``ucnerf_tpu/parallel/mesh.py``).

The JAX package lays rays over a device mesh and lets XLA insert the
gradient psum and the output gathers.  Here every process (rank) holds a
replica of the parameters and its own slice of the rays: the train step
sums the ranks' gradients with one all-reduce (``all_reduce_grads``) before
the optimizer update, and ``render_image`` gathers each chunk's slices back
in rank order (``all_gather_rays``).  Ranks are launched by ``torchrun``
(one per card, NCCL) and join with ``initialize_multihost``.

Counterparts of the JAX module:
- ``initialize_multihost``: ``jax.distributed.initialize``, from the
  environment that ``torchrun`` sets; it raises where that is absent instead
  of falling back to one process.
- ``rank`` / ``world_size`` / ``is_main_process``: ``jax.process_index`` /
  ``jax.process_count`` / ``is_main_process``.
- ``process_slice`` and ``pad_rays_to_multiple``: copies, same semantics.
- ``all_gather_rays``: ``fetch_to_host`` of a process-sharded output.

``create_mesh``, ``batch_sharding``, ``replicated_sharding``, ``shard_batch``
and ``shard_local_batch`` have no counterpart: there is no global array to
lay out, since each rank holds its slice and a replica of the parameters.
``broadcast_parameters`` makes the replicas equal after init or resume, as
DDP does at construction.  DDP itself is not used: it would all-reduce every
microbatch's backward, where the step reduces once.

gloo reduces on the host.  Its support for CUDA tensors differs from one
collective to the next, so every collective here hands gloo host tensors,
copied explicitly (``_staged``).
"""

from __future__ import annotations

import contextlib
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def launched() -> bool:
    """Whether the environment holds a multi-process launch (``torchrun``
    with ``WORLD_SIZE > 1``)."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def rank_device(name: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda`` without an index means
    ``cuda:{LOCAL_RANK}``; any other name is taken as it is."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def initialize_multihost(backend: Optional[str] = None,
                         device: Optional[torch.device] = None,
                         init_method: str = "env://"):
    """Join the process group that ``torchrun`` describes.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (and, for the default
    ``env://`` rendezvous, ``MASTER_ADDR`` and ``MASTER_PORT``) and raises
    if one is missing.  The backend is NCCL for a CUDA `device` and gloo
    otherwise, unless `backend` names one.  NCCL cannot serve two ranks on
    one card: that raises here, before NCCL would; pass ``gloo`` to run
    several ranks on one card.  A no-op when the group exists.  Returns the
    default group.
    """
    if dist.is_initialized():
        return dist.group.WORLD
    needed = list(_ENV)
    if init_method == "env://":
        needed += ["MASTER_ADDR", "MASTER_PORT"]
    missing = [k for k in needed if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"multihost: {missing} not set; launch with torchrun "
            f"(--nproc-per-node N), which sets them")
    device = torch.device("cpu") if device is None else device
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend nccl needs a CUDA device, not "
                             f"{device}")
        device = rank_device(str(device))
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    if backend == "nccl" and dist.get_world_size() > 1:
        _refuse_shared_cards(device)
    return dist.group.WORLD


def _refuse_shared_cards(device: torch.device) -> None:
    """Raise on every rank if two ranks of the NCCL group hold one card.
    The ranks compare (host, card) over a gloo group of their own, before
    NCCL sees a collective."""
    probe = dist.new_group(backend="gloo")
    try:
        mine = (socket.gethostname(), device.index)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine, group=probe)
    finally:
        dist.destroy_process_group(probe)
    shared = sorted({c for c in every if every.count(c) > 1})
    if shared:
        raise RuntimeError(
            f"NCCL cannot run two ranks on one card, and ranks share "
            f"{shared} (host, card index); give each rank its own card, or "
            f"pass --dist-backend gloo to put several ranks on one card")


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank-0-only I/O gating (logs, checkpoints, written outputs)."""
    return rank() == 0


def barrier(group=None) -> None:
    if world_size(group) > 1:
        dist.barrier(group=group)


def process_slice(n: int, process_index: Optional[int] = None,
                  process_count: Optional[int] = None):
    """This process's [start, stop) slice of a global leading axis of size
    n.  n must divide evenly: callers pad with pad_rays_to_multiple
    first."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    if n % pc != 0:
        raise ValueError(f"global batch {n} not divisible by {pc} processes")
    per = n // pc
    return pi * per, (pi + 1) * per


def pad_rays_to_multiple(batch, multiple: int):
    """Edge-pad a flat ray batch (dict of [n, ...] numpy arrays) so that its
    leading axis divides `multiple`.  Returns (padded_batch, num_padding)."""
    n = next(iter(batch.values())).shape[0]
    rem = n % multiple
    if rem == 0:
        return batch, 0
    pad = multiple - rem
    padded = {
        k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
        for k, v in batch.items()
    }
    return padded, pad


@contextlib.contextmanager
def _staged(tensor: torch.Tensor, group):
    """The tensor a collective of `group` runs on: `tensor` itself, or, for
    a CUDA tensor under gloo, a host copy that is copied back after the
    block."""
    if tensor.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = tensor.cpu()
        yield host
        tensor.copy_(host)
    else:
        yield tensor


def _sum_mean(flat: torch.Tensor, group) -> None:
    """`flat` in place: the SUM over the ranks, times 1 / world size.  (NCCL
    has an AVG op and gloo has not; one formula serves both.)"""
    with _staged(flat, group) as buf:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    flat.mul_(1.0 / world_size(group))


@torch.no_grad()
def all_reduce_grads(params, group=None) -> None:
    """Replace each parameter's ``.grad`` by its mean over the ranks.

    One all-reduce of one flat buffer, laid out in the order of `params`
    (the same on every rank), so each rank sends the same list; a missing
    ``.grad`` is filled with zeros first, as ``Optimizer.update`` does.
    """
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    dtypes = {p.grad.dtype for p in params}
    if len(dtypes) != 1:
        raise TypeError(f"all_reduce_grads: gradients of several dtypes "
                        f"{sorted(map(str, dtypes))}")
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    _sum_mean(flat, group)
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
        offset += n


@torch.no_grad()
def all_reduce_mean(tensors, group=None):
    """The ranks' mean of each tensor of a list (one all-reduce of their
    concatenation); returns new tensors in their shapes."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _sum_mean(flat, group)
    out, offset = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[offset:offset + n].view(t.shape).to(t.dtype))
        offset += n
    return out


@torch.no_grad()
def all_gather_rays(out, n_local: int, group=None):
    """Every rank's [n_local, ...] slice of a chunk's outputs (a dict of
    tensors), concatenated in rank order, on every rank: the whole chunk,
    as ``torch.cat`` of the ranks' slices."""
    w = world_size(group)
    gathered = {}
    for k, v in out.items():
        if v.shape[0] != n_local:
            raise ValueError(f"all_gather_rays: {k} holds {v.shape[0]} "
                             f"rays, not {n_local}")
        v = v.contiguous()
        if v.device.type == "cuda" and dist.get_backend(group) == "gloo":
            src = v.cpu()  # gloo gathers on the host
        else:
            src = v
        parts = [torch.empty_like(src) for _ in range(w)]
        dist.all_gather(parts, src, group=group)
        gathered[k] = torch.cat(parts).to(v.device)
    return gathered


@torch.no_grad()
def broadcast_parameters(module: torch.nn.Module, group=None,
                         src: int = 0) -> None:
    """Copy rank `src`'s parameters and buffers to every rank, in place."""
    if world_size(group) == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        with _staged(t.data, group) as buf:
            dist.broadcast(buf, src=src, group=group)


def broadcast_object(obj, group=None, src: int = 0):
    """Rank `src`'s `obj` (anything picklable), on every rank."""
    if world_size(group) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]

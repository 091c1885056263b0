"""Shared CLI plumbing: config parsing, logging, experiment folders
(port of ``ucnerf_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys

from ucnerf_tpu_torch import configs


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="default",
                   help="config preset: default | waymo | waymo_tpu | "
                        "synthetic_quality | tiny")
    p.add_argument("--binding", "-b", action="append", default=[],
                   help="config override, e.g. \"Config.near = 0.\" "
                        "(repeatable; mirrors --gin_bindings)")
    p.add_argument("--tiny", action="store_true",
                   help="shortcut for --preset tiny")
    return p


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda | cpu); under a "
                             "multi-process launch, cuda is "
                             "cuda:LOCAL_RANK")


def add_dist_args(parser: argparse.ArgumentParser) -> None:
    """The process group's options, for the entry points that run one
    process per card under torchrun (parallel/mesh.py)."""
    parser.add_argument("--dist-backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process-group backend: nccl (the default on "
                             "CUDA; one rank per card) or gloo (the default "
                             "on the CPU; several ranks may share a card)")
    parser.add_argument("--dist-init-method", default="env://",
                        help="the group's rendezvous: env:// (MASTER_ADDR "
                             "and MASTER_PORT, as torchrun sets them) or "
                             "file:///path on one host")


def resolve_device(name, logger=None):
    """The torch device `name`; raises for cuda without a CUDA device (the
    kernels have no quiet fallback: --device cpu runs their plain
    versions)."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device (pass --device "
                           f"cpu to run the plain versions of the kernels)")
    if logger is not None:
        logger.info("device: %s", torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device)
    return device


def join_processes(args, multihost: bool):
    """(device, group): with `multihost`, this rank's device
    (``mesh.rank_device``) and the process group it joined
    (``mesh.initialize_multihost``); else ``--device`` and None."""
    from ucnerf_tpu_torch.parallel import mesh

    if not multihost:
        return resolve_device(args.device), None
    device = resolve_device(mesh.rank_device(args.device))
    group = mesh.initialize_multihost(args.dist_backend, device,
                                      args.dist_init_method)
    return device, group


def log_processes(device, group, logger) -> None:
    import torch
    import torch.distributed as dist

    logger.info("device: %s%s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device,
                "" if group is None else
                f" (rank {dist.get_rank(group)} of "
                f"{dist.get_world_size(group)}, {dist.get_backend(group)})")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block, and no autotuning
    (a convolution's backward may otherwise pick an algorithm that adds in
    a varying order); the previous settings come back after it."""
    import torch

    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


@contextlib.contextmanager
def no_tf32():
    """Full f32 matmuls and convolutions inside the block (cuDNN's
    convolutions take TF32 by default on the card); the previous settings
    come back after it."""
    import torch

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = prev


def load_config_from_args(args) -> configs.Config:
    preset = "tiny" if getattr(args, "tiny", False) else args.preset
    return configs.load_config(preset, args.binding)


def setup_experiment(config: configs.Config, mode: str):
    """Create the experiment folder and a stdout+file logger
    (the reference logs to log_train.txt).  Under a process group only rank
    0 writes the file; the other ranks log to stdout, marked with their
    rank."""
    from ucnerf_tpu_torch.parallel import mesh

    exp = os.path.abspath(config.exp_name)
    os.makedirs(exp, exist_ok=True)
    logger = logging.getLogger("ucnerf_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False  # avoid duplicate lines via the root logger
    for h in logger.handlers:
        h.close()
    logger.handlers = []
    handlers = [logging.StreamHandler(sys.stdout)]
    if mesh.is_main_process():
        fmt = logging.Formatter("%(asctime)s: %(message)s")
        handlers.append(logging.FileHandler(
            os.path.join(exp, f"log_{mode}.txt")))
    else:
        fmt = logging.Formatter(f"%(asctime)s [rank {mesh.rank()}]: "
                                f"%(message)s")
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return exp, logger

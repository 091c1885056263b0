"""Shared CLI plumbing: config parsing, logging, experiment folders
(port of ``ucnerf_tpu/cli/common.py``)."""

from __future__ import annotations

import argparse
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
                        help="torch device to run on (cuda | cpu)")


def resolve_device(name: str, logger):
    """The torch device `name`; raises for cuda without a CUDA device (the
    kernels have no quiet fallback: --device cpu runs their plain
    versions)."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device (pass --device "
                           f"cpu to run the plain versions of the kernels)")
    logger.info("device: %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)
    return device


def load_config_from_args(args) -> configs.Config:
    preset = "tiny" if getattr(args, "tiny", False) else args.preset
    return configs.load_config(preset, args.binding)


def setup_experiment(config: configs.Config, mode: str):
    """Create the experiment folder and a stdout+file logger
    (the reference logs to log_train.txt)."""
    exp = os.path.abspath(config.exp_name)
    os.makedirs(exp, exist_ok=True)
    logger = logging.getLogger("ucnerf_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False  # avoid duplicate lines via the root logger
    for h in logger.handlers:
        h.close()
    logger.handlers = []
    fmt = logging.Formatter("%(asctime)s: %(message)s")
    for h in (logging.StreamHandler(sys.stdout),
              logging.FileHandler(os.path.join(exp, f"log_{mode}.txt"))):
        h.setFormatter(fmt)
        logger.addHandler(h)
    return exp, logger

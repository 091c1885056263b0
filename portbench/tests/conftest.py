"""Fixtures of the benchmark's own tests: the port's tiny preset as a
configuration dict, and tiny traffic, so that a whole run fits the CPU.

Run them with ``python -m pytest portbench/tests -q``.  Tests marked
``card`` need a CUDA card and skip without one.
"""

import copy
import dataclasses
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


def tiny_config(single_query=False):
    from ucnerf_tpu_torch import configs
    cfg = json.loads(json.dumps(dataclasses.asdict(configs.tiny(
        training_views=30, batch_size=64, microbatches=2,
        render_chunk_size=300))))
    for mlp in ("nerf_mlp", "prop_mlp"):
        cfg[mlp]["grid_bwd_dense_sample"] = True
        cfg[mlp]["hex_single_query"] = single_query
    return cfg


def tiny_traffic(kind):
    name = "rig_train" if kind == "train" else "path_render"
    with open(os.path.join(ROOT, "portbench", "traffic", f"{name}.json")) as f:
        traffic = json.load(f)
    traffic["scene"].update(frames=12, sensor_width=64, sensor_height=48,
                            focal_px=70.0, factor=1, texture_cell_px=4)
    if kind == "render":
        traffic["check_views"] = 2
    return traffic


def cpu_cell(kind, cfg=None, seed=2**31 + 11, seconds=1.0, name=None):
    """A run.Cell on the CPU over the tiny preset."""
    import torch

    from portbench import run
    cfg = copy.deepcopy(cfg or tiny_config())
    return run.Cell(name or f"waymo.{kind}", cfg, tiny_traffic(kind), seed,
                    seconds, False, torch.device("cpu"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

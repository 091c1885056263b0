"""What both kinds share: the port's configuration and model from the
benchmark's files, and the record of a run."""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


def port_config(cfg: dict):
    """The port's ``Config`` holding exactly the configuration file's
    values."""
    from ucnerf_tpu_torch import configs

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}
    top = tuples({k: v for k, v in cfg.items()
                  if k not in ("model", "nerf_mlp", "prop_mlp")})
    return configs.Config(
        **top, model=configs.ModelConfig(**tuples(cfg["model"])),
        nerf_mlp=configs.MLPConfig(**tuples(cfg["nerf_mlp"])),
        prop_mlp=configs.MLPConfig(**tuples(cfg["prop_mlp"])))


def port_model(config, params: dict, device):
    """The port's model on `device`, holding `params`."""
    from ucnerf_tpu_torch.models.model import UCNeRFModel
    model = UCNeRFModel(config, torch.Generator()).to(device)
    model.load_state_dict(params, strict=True)
    return model


def to_device(arrays: dict, device):
    """Host arrays as float32 / int32 tensors on `device`."""
    out = {}
    for k, v in arrays.items():
        t = torch.as_tensor(np.ascontiguousarray(v))
        t = t.to(torch.float32) if t.is_floating_point() else t.to(
            torch.int32)
        out[k] = t.to(device)
    return out


@dataclasses.dataclass
class Result:
    """What a kind's run hands back to ``run.py``."""
    correct: bool
    attempted: int
    failed: int
    end_to_end: dict            # name -> value
    checks: dict                # name -> (value, limit)
    memory_peak_bytes: int
    # The traced run's readings, for the per-layer readers.
    trace: Optional[object] = None
    units: int = 0
    unit_rays: int = 0
    unit_s: Optional[float] = None
    chunks_per_unit: int = 1
    host: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Window:
    """What ``run_window`` measured."""
    units: int                  # units run
    seconds: float              # the window's time, to the device's finish
    stamps: list                # host clock after each unit, from the start
    trace: Optional[object]     # the traced units' Trace, with cell.trace
    traced_s: float             # host seconds of the traced units


def run_window(cell, unit, trace_after: int, trace_units: int) -> Window:
    """Run unit(i, traced) for i = 0, 1, ... until ``cell.seconds`` have
    passed, then wait for the device.  With ``cell.trace`` the units
    trace_after .. trace_after + trace_units - 1 run under the profiler
    (``traced`` True), and the window lasts at least until they are done."""
    trace_from = trace_after if cell.trace else None
    profile = trace = None
    traced_s = 0.0
    t0 = time.perf_counter()
    stamps = [t0]
    n = 0
    while True:
        if n == trace_from:
            profile = cell.profile()
            traced_s = time.perf_counter()
            profile.start()
        unit(n, profile is not None)
        stamps.append(time.perf_counter())
        n += 1
        if profile is not None and n == trace_from + trace_units:
            trace = profile.stop()
            traced_s = time.perf_counter() - traced_s
            profile = None
        if time.perf_counter() - t0 >= cell.seconds and profile is None \
                and (trace_from is None or trace is not None):
            break
    cell.sync()
    return Window(n, time.perf_counter() - t0, stamps, trace, traced_s)

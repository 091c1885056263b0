"""Parameters made on the card from a seed, in a few large draws, for both
the port and the reference.

``make`` follows ``reference.model.param_specs``: one uniform draw covers
every U(-b, b) leaf, each scaled by its bound; zero and constant leaves are
set.  With ``widen`` (the render cells) one normal draw then replaces the
hash tables by N(0, 0.1) and the brightness decoder's output weights and
latent codes by N(0, 0.3), so that every parameter shapes a render: at the
initial 1e-4 the tables give features that barely move the field.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.model import param_specs

WIDEN = ((".table", 0.1), ("output_linear.weight", 0.3),
         ("latent_code", 0.3))


def seed_of(seed: int, *words: int) -> int:
    """A 63-bit seed mixed from the run's seed and tag words."""
    state = np.random.SeedSequence((seed,) + words).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _widen_std(name):
    for suffix, std in WIDEN:
        if name.endswith(suffix):
            return std
    return None


def make(cfg: dict, seed: int, device, widen: bool = False):
    """{name: float32 tensor} on `device`."""
    specs = param_specs(cfg)
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 1))
    sizes = [math.prod(shape) for _, shape, _ in specs]
    uniform = [i for i, (_, _, init) in enumerate(specs)
               if init[0] == "uniform"]
    flat = torch.rand(sum(sizes[i] for i in uniform), generator=gen,
                      device=device)
    out, pos = {}, 0
    for i, (name, shape, init) in enumerate(specs):
        if init[0] == "uniform":
            part = flat[pos:pos + sizes[i]]
            pos += sizes[i]
            out[name] = ((part * 2 - 1) * init[1]).reshape(shape)
        elif init[0] == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.tensor(init[1], dtype=torch.float32,
                                     device=device).reshape(shape)
    del flat
    if widen:
        names = [name for name, _, _ in specs if _widen_std(name)]
        normal = torch.randn(sum(out[k].numel() for k in names),
                             generator=gen, device=device)
        pos = 0
        for k in names:
            n = out[k].numel()
            out[k] = (normal[pos:pos + n] * _widen_std(k)).reshape(
                out[k].shape)
            pos += n
    return out

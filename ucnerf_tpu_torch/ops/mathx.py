"""Numerically-safe math helpers (port of ``ucnerf_tpu/ops/mathx.py``).

Only what the render path needs: ``EPS`` and the masked-extrema formulation
of sorted interpolation.  The JAX package's ``take_along_last`` (a one-hot
MXU contraction, a TPU workaround for slow trailing-axis gathers) has no
counterpart here: where the port needs it, it calls ``torch.gather``.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


def linspace(start: float, stop: float, num: int, device=None):
    """float32 ``jnp.linspace`` with its formula:
    ``start * (1 - k/div) + stop * (k/div)`` in f32, last entry ``stop``
    (``torch.linspace`` steps from both ends and rounds differently)."""
    f32 = torch.float32
    start_t = torch.tensor(start, dtype=f32, device=device)
    stop_t = torch.tensor(stop, dtype=f32, device=device)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    step = torch.arange(div, dtype=f32, device=device) / div
    out = start_t * (1 - step) + stop_t * step
    return torch.cat([out, stop_t.reshape(1)])


def _masked_extrema(mask, y):
    """Given mask[..., N, M] over sorted y[..., N], return (y0, y1) where y0
    is y at the last True row and y1 is y at the first False row, clamped to
    the first/last entry when the query is out of range."""
    y_col = y[..., :, None]
    y0 = torch.where(mask, y_col, y[..., :1, None]).amax(dim=-2)
    y1 = torch.where(~mask, y_col, y[..., -1:, None]).amin(dim=-2)
    return y0, y1


def sorted_interp(x, xp, fp):
    """Piecewise-linear interpolation; xp and fp must be sorted.

    Same masked max/min formulation as the JAX package (no searchsorted), so
    ties (``x >= xp``) and out-of-range clamping agree exactly.
    """
    mask = x[..., None, :] >= xp[..., :, None]  # [..., N, M]
    fp0, fp1 = _masked_extrema(mask, fp)
    xp0, xp1 = _masked_extrema(mask, xp)
    offset = torch.clamp(torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0),
                         0, 1)
    return fp0 + offset * (fp1 - fp0)

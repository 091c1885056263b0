"""Numerically-safe math helpers (port of ``ucnerf_tpu/ops/mathx.py``).

``EPS``, the reference's cheap ``fast_erf``, ``safe_sin`` / ``safe_cos``,
the masked-extrema formulations of sorted (linear and quadratic)
interpolation, and the log-lerp learning-rate schedule.  The JAX package's
``take_along_last`` (a one-hot MXU contraction, a TPU workaround for slow
trailing-axis gathers) has no counterpart here: the port calls
``torch.gather``.  ``safe_exp`` and ``override_gradient`` have no caller in
the JAX package and are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


def fast_erf(x):
    """Cheap erf approximation: sign(x) * sqrt(1 - exp(-4/pi x^2))."""
    return torch.sign(x) * torch.sqrt(1.0 - torch.exp(-(4.0 / math.pi)
                                                      * x**2))


def safe_trig_helper(x, fn, t=100 * math.pi):
    """Mod `x` into a safe range before applying a trig function (the
    remainder of ``jnp.mod``: the sign of the divisor)."""
    return fn(torch.where(torch.abs(x) < t, x, torch.remainder(x, t)))


def safe_cos(x):
    return safe_trig_helper(x, torch.cos)


def safe_sin(x):
    return safe_trig_helper(x, torch.sin)


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


def sorted_interp_quad(x, xp, fpdf, fcdf):
    """Piecewise-quadratic CDF interpolation: the CDF ``fcdf`` of a
    piecewise-linear PDF ``fpdf`` on knots ``xp``, at the points x.

    First-occurrence argmax/argmin pick the interval ends, as the JAX
    package (and the reference's torch.max/min indices) do."""
    mask = x[..., None, :] >= xp[..., :, None]  # [..., N, M]
    big = torch.where(mask, fcdf[..., :, None], fcdf[..., :1, None])
    small = torch.where(~mask, fcdf[..., :, None], fcdf[..., -1:, None])
    fcdf0 = big.amax(dim=-2)
    idx0 = big.argmax(dim=-2)
    idx1 = small.argmin(dim=-2)
    fpdf0 = torch.gather(fpdf, -1, idx0)
    fpdf1 = torch.gather(fpdf, -1, idx1)
    xp0, xp1 = _masked_extrema(mask, xp)
    offset = torch.clamp(torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0),
                         0, 1)
    # Trapezoid rule on the linear PDF between xp0 and x.
    return fcdf0 + (x - xp0) * (fpdf0 + fpdf1 * offset
                                + fpdf0 * (1 - offset)) / 2


def log_lerp(t: float, v0: float, v1: float) -> float:
    """Interpolate log-linearly from v0 (t=0) to v1 (t=1)."""
    if v0 <= 0 or v1 <= 0:
        raise ValueError(f"Interpolants {v0} and {v1} must be positive.")
    lv0, lv1 = math.log(v0), math.log(v1)
    return math.exp(min(max(t, 0.0), 1.0) * (lv1 - lv0) + lv0)


def learning_rate_decay(step: int, lr_init: float, lr_final: float,
                        max_steps: int, lr_delay_steps: int = 0,
                        lr_delay_mult: float = 1.0) -> float:
    """Log-lerp LR decay with a reverse-cosine warmup, in float64 on the
    host (the JAX package traces it in float32)."""
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
    else:
        delay_rate = 1.0
    return delay_rate * log_lerp(step / max_steps, lr_init, lr_final)

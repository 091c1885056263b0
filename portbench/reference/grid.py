"""Plain PyTorch multiresolution hash grid (the reference ``gridencoder.cu``
geometry, as UC-NeRF's Zip-NeRF encoder uses it), with Zip-NeRF's erf
downweighting and hex-point mean.

The table is channel-planar [C, rows] and holds every level, packed.  The
lookups are plain indexing, and the table gradient a plain ``index_add_``.
Where the configuration asks for ``grid_bwd_dense_sample`` (both presets),
the backward of the dense (unhashed) leading levels forms each corner's
weight from the fractional coordinates rounded once to bfloat16, as that
option states; every other weight is the forward's float32 one.
"""

from __future__ import annotations

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class GridSpec:
    """Level sizes, offsets and resolutions of a hash grid
    (``grid.py`` of the source with align_corners=False)."""

    def __init__(self, mlp: dict):
        self.num_levels = mlp["grid_num_levels"]
        self.level_dim = mlp["grid_level_dim"]
        base = mlp["grid_base_resolution"]
        desired = mlp["grid_desired_resolution"]
        self.log2_size = mlp["grid_log2_hashmap_size"]
        n = self.num_levels
        scale = 1.0 if n == 1 else float(
            np.exp2(np.log2(desired / base) / (n - 1)))
        self.resolutions = [int(np.ceil(base * scale**i)) + 1
                            for i in range(n)]
        max_params = 2**self.log2_size
        self.level_sizes = [int(np.ceil(min(max_params, r**3) / 8) * 8)
                            for r in self.resolutions]
        self.offsets = [0]
        for s in self.level_sizes:
            self.offsets.append(self.offsets[-1] + s)
        ls = np.log2(scale)
        # The CUDA encoder's per-level scale and index stride.
        self.kernel_scales = [float(np.exp2(i * ls) * base - 1.0)
                              for i in range(n)]
        self.kernel_res = [int(np.ceil(s)) + 1 for s in self.kernel_scales]
        dense = 0
        for level in range(n):
            stride = self.kernel_res[level] + 1
            if self.uses_hash(level):
                break
            if self.kernel_res[level] * (1 + stride + stride**2) \
                    >= self.level_sizes[level]:
                break
            dense += 1
        self.dense_prefix = dense

    @property
    def rows(self) -> int:
        return self.offsets[-1]

    def uses_hash(self, level: int) -> bool:
        return (self.kernel_res[level] + 1) ** 3 > self.level_sizes[level]


def mlp_with_grid(mlp: dict, desired: int) -> dict:
    """A proposal level's grid: the levels that reach `desired`."""
    n = int(np.log(desired / mlp["grid_base_resolution"])
            / np.log(mlp["grid_level_interval"])) + 1
    return dict(mlp, grid_desired_resolution=desired, grid_num_levels=n)


def _row(spec: GridSpec, level: int, cx, cy, cz):
    size = spec.level_sizes[level]
    if spec.uses_hash(level):
        index = ((cx * _PRIMES[0]) ^ (cy * _PRIMES[1])
                 ^ (cz * _PRIMES[2])) & _U32
    else:
        stride = spec.kernel_res[level] + 1
        index = (cx + cy * stride + cz * (stride * stride)) & _U32
        r = spec.kernel_res[level]
        if r * (1 + stride + stride**2) < size:
            return index
    if size & (size - 1) == 0:
        return index & (size - 1)
    return index % size


def corners(spec: GridSpec, level: int, xs):
    """Rows idx [8, P] (int64, level-local), trilinear weights w [8, P] and
    fractional coordinates frac [3, P] of unit-cube points xs [3, P]."""
    scale = float(np.float32(spec.kernel_scales[level]))
    pos = xs * scale + 0.5
    floor = torch.floor(pos)
    frac = pos - floor
    pg = floor.long()
    idx, w = [], []
    for corner in range(8):
        weight, comps = None, []
        for d in range(3):
            if corner & (1 << d):
                f, c = frac[d], pg[d] + 1
            else:
                f, c = 1 - frac[d], pg[d]
            comps.append(c)
            weight = f if weight is None else weight * f
        idx.append(_row(spec, level, *comps))
        w.append(weight)
    return torch.stack(idx), torch.stack(w), frac


def bf16_corner_weights(frac):
    """Corner weights [8, P] from fractional coordinates rounded to bf16:
    ones, then * f or * (1 - f) per axis."""
    fr = frac.to(torch.bfloat16).to(frac.dtype)
    out = []
    for corner in range(8):
        w = torch.ones_like(fr[0])
        for d in range(3):
            w = w * (fr[d] if corner & (1 << d) else 1.0 - fr[d])
        out.append(w)
    return torch.stack(out)


class _Lookup(torch.autograd.Function):
    """sum_k w[k] * table[:, rows[k]] per point, with the table gradient
    sum over (k, p) of wb[k, p] * g[:, p] at rows[k, p]."""

    @staticmethod
    def forward(ctx, table, rows, w, wb):
        ctx.save_for_backward(rows, wb)
        ctx.shape = table.shape
        return (table[:, rows] * w[None]).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        rows, wb = ctx.saved_tensors
        c = ctx.shape[0]
        upd = (wb[None] * g[:, None, :]).reshape(c, -1)
        d = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        d.index_add_(1, rows.reshape(-1), upd)
        return d, None, None, None


def encode_hex(x01, stds, table, spec: GridSpec, dense_bf16: bool):
    """Per-level features [L*C, M] of points x01 [3, H, M] (H = 6 hex points,
    or 1 at the hex mean) with stds [6, M]: the corner sum of each point,
    times its erf weight and zero outside the unit cube, averaged over the
    hex points (H = 6) or, at H = 1, times the mean erf weight."""
    hex_n, m = x01.shape[1], x01.shape[2]
    oob = ((x01 < 0) | (x01 > 1)).any(dim=0)
    xs = torch.clamp(x01, 0.0, 1.0).reshape(3, hex_n * m)
    feats = []
    for level in range(spec.num_levels):
        gs2 = float(np.float32(spec.resolutions[level]) ** 2)
        erf = torch.erf(1.0 / torch.sqrt(8.0 * stds**2 * gs2))  # [6, M]
        idx, w, frac = corners(spec, level, xs)
        wb = (bf16_corner_weights(frac)
              if dense_bf16 and level < spec.dense_prefix else w)
        rows = idx + spec.offsets[level]
        acc = _Lookup.apply(table, rows, w, wb).reshape(-1, hex_n, m)
        if hex_n == erf.shape[0]:
            valid = torch.where(oob, torch.zeros_like(erf), erf)
            feats.append((acc * valid[None]).mean(dim=1))
        else:
            w_mean = erf.mean(dim=0)
            w_single = torch.where(oob[0], torch.zeros_like(w_mean), w_mean)
            feats.append(acc[:, 0] * w_single[None])
    return torch.cat(feats, dim=0)


def hash_decay(table, spec: GridSpec):
    """Mean over levels of each level's mean squared entry."""
    return torch.stack([
        torch.mean(table[:, spec.offsets[l]:spec.offsets[l + 1]] ** 2)
        for l in range(spec.num_levels)]).mean()


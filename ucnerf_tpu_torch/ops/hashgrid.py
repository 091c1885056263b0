"""Multiresolution hash-grid encoder (port of ``ucnerf_tpu/ops/hashgrid.py``).

Table layout, level offsets, per-level resolutions and the prime-XOR hash
are those of the JAX package (and so of the reference ``gridencoder.cu``).
Each level's 8-corner lookups and their trilinear sum are one launch of
``gather.take_wsum_cm`` over that level's slice of the channel-major
``[C, rows]`` table (K4's fused entry on the card: the corner sum is the
gather's epilogue), so neither a ``[C, L*8*H*M]`` nor a per-level
``[C, 8, H*M]`` array exists.  Only where the trilinear weights themselves
need a gradient (sample positions that require grad) does a level go through
``gather.take_cm`` (K4's plain entry), keep its gathered rows and sum them in
torch.  Either way K4 launches once per level.

When grad mode is on and the table or the positions require grad, the
lookups run inside ``_GatherWSum``, the counterpart of the JAX
``_gather_wsum_ml`` custom VJP: its backward fills the table gradient with
the scatter kernels, K2
(``scatter.scatter_add_dense_cm``) for the dense-prefix levels when
``bwd_dense_sample`` is on and, for the other levels, K1's fused entry
(``scatter.scatter_add_wsum_cm``, which forms each update ``w * g`` inside
the kernel) or, with ``bwd_value_dtype='bfloat16'``, K3's fused entry
(``scatter.scatter_add_wsum_packed_cm``, which also rounds each update to
bf16 there).

The backward is itself differentiable (``_GatherWSumBackward``), for the
density normals' second derivative: the corner weights' gradient
``d_w[l, k, s] = sum_c table[c, idx[l, k, s]] * g[l, c, s]`` differentiates
to the table through K1's fused entry (with the weights' cotangent in the
place of the weights, over every level) and to the feature grads through
K4's fused entry ``gather.take_wsum_cm``.  With ``inner_grad_first`` the
first backward computes the weights' gradient alone (the normals' inner
gradient, which asks for no table gradient) and later ones the table
gradient as well.

``encode`` / ``encode_level`` are the reference encoder (row-major points,
per-level features): one K4 ``take_cm`` launch per level, and a table
gradient by K1's plain entry ``scatter.scatter_add_cm`` over the
corner-expanded updates.  ``tv_loss`` (torch indexing, as the JAX package's
``jnp.take``) and ``level_sq_means`` (the scale featurization) are plain
torch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ucnerf_tpu_torch.ops import gather, scatter

# Prime constants of the spatial hash (gridencoder.cu:54).
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class HashGridSpec:
    """Static geometry of a multiresolution hash grid (a copy of the JAX
    package's).

    Mirrors GridEncoder's constructor arguments (grid.py:97-149) with
    align_corners=False, gridtype='hash', linear interpolation.
    """
    input_dim: int = 3
    num_levels: int = 10
    level_dim: int = 4
    base_resolution: int = 16
    desired_resolution: int = 8192
    log2_hashmap_size: int = 21
    init_std: float = 1e-4

    @functools.cached_property
    def per_level_scale(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(np.exp2(
            np.log2(self.desired_resolution / self.base_resolution)
            / (self.num_levels - 1)))

    @functools.cached_property
    def resolutions(self) -> Tuple[int, ...]:
        """Per-level table resolutions (grid.py:128-129, align_corners=False):
        ceil(base * scale^l) + 1.  Exposed as `grid_sizes` for the erf
        multisample weighting (models.py:495)."""
        return tuple(
            int(np.ceil(self.base_resolution * self.per_level_scale**i)) + 1
            for i in range(self.num_levels))

    @functools.cached_property
    def level_sizes(self) -> Tuple[int, ...]:
        """Rows allocated per level: min(2^log2_hashmap_size, res^D), rounded
        up to a multiple of 8 (grid.py:130-131)."""
        max_params = 2**self.log2_hashmap_size
        sizes = []
        for res in self.resolutions:
            n = min(max_params, res**self.input_dim)
            sizes.append(int(np.ceil(n / 8) * 8))
        return tuple(sizes)

    @functools.cached_property
    def offsets(self) -> Tuple[int, ...]:
        """Row offset of each level in the packed table (len = L + 1)."""
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def table_rows(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.level_dim

    @functools.cached_property
    def cuda_scales(self) -> Tuple[float, ...]:
        """Per-level continuous scales as computed by the CUDA kernel:
        exp2(l * log2(per_level_scale)) * H - 1 (gridencoder.cu:138)."""
        s = np.log2(self.per_level_scale)
        return tuple(
            float(np.exp2(i * s) * self.base_resolution - 1.0)
            for i in range(self.num_levels))

    @functools.cached_property
    def cuda_resolutions(self) -> Tuple[int, ...]:
        """Index-stride resolutions as computed by the CUDA kernel:
        ceil(scale) + 1 (gridencoder.cu:139)."""
        return tuple(int(np.ceil(s)) + 1 for s in self.cuda_scales)

    def uses_hash(self, level: int) -> bool:
        """True when the level's dense stride exceeds its table, so corner
        coordinates are hashed (gridencoder.cu:72-81)."""
        stride = (self.cuda_resolutions[level] + 1) ** self.input_dim
        return stride > self.level_sizes[level]

    @functools.cached_property
    def dense_prefix(self) -> int:
        """Number of leading levels whose corner index is the plain linear
        cell index — no hash AND provably no modulo."""
        if self.input_dim != 3:
            return 0
        n = 0
        for level in range(self.num_levels):
            if self.uses_hash(level):
                break
            r = self.cuda_resolutions[level]
            stride = r + 1
            max_index = r * (1 + stride + stride * stride)
            if max_index >= self.level_sizes[level]:
                break
            n += 1
        return n

    @functools.cached_property
    def dense_strides(self) -> Tuple[int, ...]:
        """Corner strides (cuda_resolution + 1) of the dense prefix."""
        return tuple(self.cuda_resolutions[l] + 1
                     for l in range(self.dense_prefix))


def init_table(spec: HashGridSpec, generator: torch.Generator,
               device="cpu") -> torch.Tensor:
    """The packed embedding table, U(-init_std, init_std), channel-planar
    [C, rows] like the JAX package's."""
    table = torch.empty((spec.level_dim, spec.table_rows),
                        dtype=torch.float32, device=device)
    return table.uniform_(-spec.init_std, spec.init_std, generator=generator)


def _corner_index_components(spec: HashGridSpec, level: int, cx, cy, cz):
    """Row index within a level from int64 corner coordinates.

    The JAX package computes in uint32 with wraparound; here the arithmetic
    is int64 masked to 32 bits before the final ``&``/``%``, which gives the
    same values (2654435761 exceeds the int32 range)."""
    hashmap_size = spec.level_sizes[level]
    if spec.uses_hash(level):
        index = ((cx * _PRIMES[0]) ^ (cy * _PRIMES[1])
                 ^ (cz * _PRIMES[2])) & _U32
    else:
        stride = spec.cuda_resolutions[level] + 1
        index = (cx + cy * stride + cz * (stride * stride)) & _U32
        r = spec.cuda_resolutions[level]
        if r * (1 + stride + stride**2) < hashmap_size:
            return index
    if hashmap_size & (hashmap_size - 1) == 0:
        return index & (hashmap_size - 1)
    return index % hashmap_size


def _level_corners(spec: HashGridSpec, level: int, xs):
    """Level-local corner rows idx [8, H, M] int32, trilinear weights
    w [8, H, M] and fractional coords frac [3, H, M] of points xs [3, H, M]
    (clamped to the unit cube)."""
    scale = float(np.float32(spec.cuda_scales[level]))
    pos = xs * scale + 0.5
    pos_floor = torch.floor(pos)
    frac = pos - pos_floor
    pg = pos_floor.long()  # [3, H, M]
    idx = []
    w = []
    for corner in range(8):
        wc = None
        comps = []
        for d in range(3):
            if corner & (1 << d):
                f = frac[d]
                comps.append(pg[d] + 1)
            else:
                f = 1 - frac[d]
                comps.append(pg[d])
            wc = f if wc is None else wc * f
        idx.append(_corner_index_components(spec, level, *comps)
                   .to(torch.int32))
        w.append(wc)
    return torch.stack(idx), torch.stack(w), frac


def _global_keys(idx, spec, first_level=0, base=0):
    """Level-local corner rows idx [L, 8, N] of levels first_level.. as rows
    of the packed table less `base`, level-major, then corner, then sample
    (the layout of ``scatter._wsum_values``)."""
    return torch.cat([(idx[l - first_level] + (spec.offsets[l] - base))
                      .reshape(-1)
                      for l in range(first_level,
                                     first_level + idx.shape[0])])


def _table_grad(g, idx, w, frac, spec, nd, value_dtype):
    """The table gradient of the per-level corner sums (``_GatherWSum``'s
    backward): K2 for the first ``nd`` (dense) levels, K1's or K3's fused
    entry for the rest, each writing every row of its range."""
    num_levels, c, n = g.shape
    offsets = spec.offsets
    d_table = torch.empty((c, spec.table_rows), dtype=g.dtype,
                          device=g.device)
    dense_rows = offsets[nd]
    if nd:
        scatter.scatter_add_dense_cm(
            g[:nd].transpose(0, 1).reshape(c, nd * n),
            frac.transpose(0, 1).reshape(3, nd * n),
            torch.cat([idx[l, 0] + offsets[l] for l in range(nd)]),
            dense_rows, level_len=n, strides=spec.dense_strides[:nd],
            level_offsets=offsets[:nd + 1], out=d_table[:, :dense_rows])
    if nd < num_levels:
        # Level-major, corner, sample: hashgrid.py:302-304.
        keys = _global_keys(idx[nd:], spec, nd, dense_rows)
        fill = (scatter.scatter_add_wsum_packed_cm
                if value_dtype == "bfloat16" else scatter.scatter_add_wsum_cm)
        fill(g[nd:], w[nd:], keys, spec.table_rows - dense_rows,
             out=d_table[:, dense_rows:])
    return d_table


class _GatherWSum(torch.autograd.Function):
    """Per-level gather + trilinear corner sum with the table gradient
    (the JAX ``_gather_wsum_ml``, hashgrid.py:210-345).

    Forward: for each level l, K4 over the level's slice of the table.
    Where the weights need no gradient, which is every Waymo path
    (``track_linearize_cm`` stops gradients to the means), that is the fused
    ``gather.take_wsum_cm``: gather and weighted 8-corner sum in one kernel.
    Where they do, ``gather.take_cm`` gathers the rows, which are summed in
    torch and saved for the weights' gradient.  It always saves the corner
    indices and weights (and the fractional coords of the dense levels).

    Backward (``_GatherWSumBackward``, so that it can be differentiated
    again): one [C, rows] gradient buffer.  The first ``nd`` (dense) levels
    are filled by K2 from the per-sample feature grads, fractional coords
    and corner-0 rows; the rest from the per-level feature grads and corner
    weights, by K1's fused entry in f32 (the corner-expanded ``w * g`` is
    formed inside the kernel and never stored) or, with
    ``value_dtype='bfloat16'``, by K3's fused entry, which also rounds each
    update once to bf16 inside the kernel.  Each kernel writes every row of
    its range, so the
    buffer needs no zeroing, and neither the TPU's tile-offset assembly
    (hashgrid.py:292-319) nor its concatenation of parts (:320-343) has a
    counterpart.
    """

    @staticmethod
    def forward(ctx, table, idx, w, frac, spec, nd, bf16, value_dtype,
                inner_grad_first):
        """table [C, rows]; idx, w [L, 8, N] (level-local rows); frac
        [nd, 3, N]; value_dtype None or 'bfloat16'; inner_grad_first: the
        first backward is an inner gradient w.r.t. the positions (the
        density normals), which skips the table gradient.  Returns the
        per-level corner sums [L, C, N]."""
        keep_rows = ctx.needs_input_grad[2]
        t = table.detach()
        outs, rows_kept = [], []
        for level in range(spec.num_levels):
            lo, hi = spec.offsets[level], spec.offsets[level + 1]
            if keep_rows:
                rows = gather.take_cm(t[:, lo:hi], idx[level], bf16=bf16)
                outs.append((rows * w[level][None]).sum(dim=1))
                rows_kept.append(rows)
                del rows
            else:
                outs.append(gather.take_wsum_cm(t[:, lo:hi], idx[level],
                                                w[level], bf16=bf16))
        ctx.save_for_backward(table, idx, w, frac, *rows_kept)
        ctx.spec, ctx.nd, ctx.value_dtype = spec, nd, value_dtype
        ctx.skip_table = inner_grad_first
        return torch.stack(outs)

    @staticmethod
    def backward(ctx, g):
        table, idx, w, frac, *rows = ctx.saved_tensors
        want_table = ctx.needs_input_grad[0] and not ctx.skip_table
        ctx.skip_table = False
        want_w = ctx.needs_input_grad[2]
        d_table, d_w = _GatherWSumBackward.apply(
            table, g.contiguous(), w, idx, frac, ctx.spec, ctx.nd,
            ctx.value_dtype, want_table, want_w, *rows)
        return d_table, None, d_w, None, None, None, None, None, None


class _GatherWSumBackward(torch.autograd.Function):
    """``_GatherWSum``'s backward as a function of (table, g, w), with its
    own backward: the second derivative through the hash grid that the
    density normals' losses need.

    Forward: the table gradient (``_table_grad``: K2, K1's or K3's fused
    entry) when `want_table`, and the weights' gradient
    ``d_w[l] = einsum('chs,cs->hs', rows[l], g[l])`` over the rows the
    forward kept when `want_w`; either may be None.

    Backward, for cotangents dd_table (of d_table) and dd_w (of d_w):
      d/d table = sum over (l, k, s) of dd_w[l, k, s] * g[l, :, s] at row
        idx[l, k, s]: K1's fused entry with dd_w in the place of the
        weights, over every level (dd_w is arbitrary, so K2's corner weights
        rebuilt from bf16-rounded fracs do not apply; the JAX package's
        second derivative is the exact transpose of ``jnp.take``);
      d/d g = sum_k dd_w[l, k] * table[:, idx[l, k]] (K4's fused entry,
        ``take_wsum_cm``, per level) + sum_k w[l, k] * dd_table[:, idx[l, k]]
        (the same, where dd_table is given);
      d/d w = sum_c g[l, c] * dd_table[c, idx[l, k]] (``take_cm`` and the
        einsum), where dd_table is given.
    The terms are those of the exact f32 function: the bf16 roundings of
    K2 and K3 are not differentiated.
    """

    @staticmethod
    def forward(ctx, table, g, w, idx, frac, spec, nd, value_dtype,
                want_table, want_w, *rows):
        d_table = d_w = None
        if want_table:
            d_table = _table_grad(g, idx, w, frac, spec, nd, value_dtype)
        if want_w:
            d_w = torch.stack([torch.einsum("chs,cs->hs", rows[l], g[l])
                               for l in range(spec.num_levels)])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(table, g, w, idx)
        ctx.spec, ctx.num_rows = spec, len(rows)
        return d_table, d_w

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dd_table, dd_w):
        table, g, w, idx = ctx.saved_tensors
        spec = ctx.spec
        t = table.detach()
        num_levels = spec.num_levels
        d_t = d_g = d_w = None
        if dd_w is not None:
            dd_w = dd_w.contiguous()
            if ctx.needs_input_grad[0]:
                d_t = scatter.scatter_add_wsum_cm(
                    g, dd_w, _global_keys(idx, spec), spec.table_rows)
            if ctx.needs_input_grad[1]:
                d_g = torch.stack([
                    gather.take_wsum_cm(
                        t[:, spec.offsets[l]:spec.offsets[l + 1]], idx[l],
                        dd_w[l]) for l in range(num_levels)])
        if dd_table is not None:
            dd_table = dd_table.contiguous()
            levels = [dd_table[:, spec.offsets[l]:spec.offsets[l + 1]]
                      for l in range(num_levels)]
            if ctx.needs_input_grad[1]:
                term = torch.stack([gather.take_wsum_cm(levels[l], idx[l],
                                                        w[l])
                                    for l in range(num_levels)])
                d_g = term if d_g is None else d_g + term
            if ctx.needs_input_grad[2]:
                d_w = torch.stack([
                    torch.einsum("chs,cs->hs",
                                 gather.take_cm(levels[l], idx[l]), g[l])
                    for l in range(num_levels)])
        return (d_t, d_g, d_w) + (None,) * (7 + ctx.num_rows)


class _GatherRows(torch.autograd.Function):
    """The reference encoder's lookups: rows [L, C, 8, N] of the packed
    table at the level-local corner rows idx [L, 8, N] of the given levels,
    one K4 ``take_cm`` launch per level; the table gradient is one launch of
    K1's plain entry ``scatter.scatter_add_cm`` over every level's updates
    (the JAX package's ``jnp.take`` transposes to a scatter-add)."""

    @staticmethod
    def forward(ctx, table, idx, spec, levels):
        t = table.detach()
        ctx.save_for_backward(idx)
        ctx.spec, ctx.levels = spec, levels
        return torch.stack([
            gather.take_cm(t[:, spec.offsets[l]:spec.offsets[l + 1]], idx[i])
            for i, l in enumerate(levels)])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        spec = ctx.spec
        keys = torch.cat([(idx[i] + spec.offsets[l]).reshape(-1)
                          for i, l in enumerate(ctx.levels)])
        values = g.transpose(0, 1).reshape(g.shape[1], -1).contiguous()
        d_table = scatter.scatter_add_cm(values, keys, spec.table_rows)
        return d_table, None, None, None


def _encode_levels(x01, table, spec: HashGridSpec, levels):
    """Features [N, len(levels), C] of unit-cube points x01 [N, 3] at the
    given levels; points outside [0, 1]^3 give zeros."""
    oob = ((x01 < 0) | (x01 > 1)).any(dim=-1)  # [N]
    xs = torch.clamp(x01, 0.0, 1.0).T[:, None]  # [3, 1, N]
    idx, w = [], []
    for level in levels:
        i, wl, _ = _level_corners(spec, level, xs)
        idx.append(i[:, 0])
        w.append(wl[:, 0])
    rows = _GatherRows.apply(table, torch.stack(idx), spec, tuple(levels))
    acc = (rows * torch.stack(w)[:, None]).sum(dim=2)  # [L, C, N]
    acc = torch.where(oob[None, None], torch.zeros((), dtype=acc.dtype,
                                                   device=acc.device), acc)
    return acc.permute(2, 0, 1)


def encode_level(x01, table, spec: HashGridSpec, level: int):
    """Encode unit-cube points x01 [N, 3] into one level's features [N, C];
    points outside [0, 1]^3 give zeros (gridencoder.cu:111-135)."""
    return _encode_levels(x01, table, spec, [level])[:, 0]


def encode(x, table, spec: HashGridSpec, bound: float = 1.0):
    """Hash-encode points x [..., 3] in [-bound, bound]^3 into per-level
    features [..., L, C] (the reference encoder; table [C, rows])."""
    x01 = (x + bound) / (2 * bound)
    batch_shape = x01.shape[:-1]
    flat = x01.reshape(-1, spec.input_dim)
    out = _encode_levels(flat, table, spec, range(spec.num_levels))
    return out.reshape(batch_shape + (spec.num_levels, spec.level_dim))


def encode_hex_cm(x01, stds, table, spec: HashGridSpec, grid_sizes=None,
                  gather_bf16: bool = False, bwd_dense_sample: bool = False,
                  bwd_value_dtype=None, inner_grad_first: bool = False):
    """Channel-major hash encode with erf weighting + hex-mean folded in.

    Semantically equals the reference's per-point encode followed by the erf
    multisample downweighting and the mean over the 6 hex points
    (models.py:494-496).  The hex axis of x01 may have size 1
    (``hex_single_query``): one lookup per sample at the hex-mean position,
    modulated by the mean erf weight over the 6 stds.

    When grad mode is on and the table or the positions require grad, the
    lookups go through ``_GatherWSum``, whose backward runs the scatter
    kernels; otherwise (the render path) each level is one
    ``gather.take_wsum_cm``.  One K4 launch per level either way.

    Args:
      x01: [3, H, M] unit-cube coordinates (H = 6 or 1); points outside
        [0, 1]^3 contribute zero.
      stds: [6, M] per-multisample stds in the same normalized frame, or
        None to skip the erf weighting.
      table: [C, rows] channel-planar packed table.
      grid_sizes: optional [L] resolutions for the erf weight; defaults to
        spec.resolutions.
      gather_bf16: round the gathered features to bf16
        (``MLPConfig.grid_bf16_gather``); table gradients stay f32.
      bwd_dense_sample: fill the dense-prefix levels' table gradient with
        K2 (``MLPConfig.grid_bwd_dense_sample``); otherwise K1 covers every
        level.
      bwd_value_dtype: None, or 'bfloat16' to round each hashed-level
        update once to bf16 and sum it with K3
        (``MLPConfig.grid_bwd_value_dtype``); it shapes only the backward.
        Any other value raises ValueError.
      inner_grad_first: the first backward through these lookups is an
        inner gradient w.r.t. x01 (the density normals' ``autograd.grad``),
        which computes the corner weights' gradient alone; later backwards
        (the loss's) compute the table gradient too.  ``needs_input_grad``
        cannot tell the two apart: the table requires grad in both.  Where
        x01 needs no gradient the inner gradient never reaches the lookups,
        and the flag is ignored.

    Returns:
      feats [L*C, M] and wmeans [L, M] (per-level mean erf weight).
    """
    if grid_sizes is None:
        grid_sizes = np.asarray(spec.resolutions, np.float32)
    c_dim = spec.level_dim
    hex_n, m = x01.shape[1], x01.shape[2]
    if bwd_value_dtype not in (None, "bfloat16"):
        raise ValueError(f"bwd_value_dtype must be None or 'bfloat16', got "
                         f"{bwd_value_dtype!r}")
    if bwd_value_dtype is not None and c_dim % 2:
        raise ValueError(f"bwd_value_dtype needs an even level_dim, got "
                         f"{c_dim}")
    fused = torch.is_grad_enabled() and (table.requires_grad
                                         or x01.requires_grad)
    nd = spec.dense_prefix if bwd_dense_sample else 0

    oob = ((x01 < 0) | (x01 > 1)).any(dim=0)  # [H, M]
    xs = torch.clamp(x01, 0.0, 1.0)

    acc_levels, erf_levels = [], []
    idx_parts, w_parts, frac_parts = [], [], []
    for level in range(spec.num_levels):
        if stds is not None:
            gs2 = float(np.float32(grid_sizes[level]) ** 2)
            erf_levels.append(torch.erf(1.0 / torch.sqrt(8.0 * stds**2 * gs2)))
        else:
            erf_levels.append(torch.ones((hex_n, m), dtype=x01.dtype,
                                         device=x01.device))
        idx, w, frac = _level_corners(spec, level, xs)
        if fused:
            idx_parts.append(idx.reshape(8, hex_n * m))
            w_parts.append(w.reshape(8, hex_n * m))
            if level < nd:
                frac_parts.append(frac.detach().reshape(3, hex_n * m))
            continue
        lo, hi = spec.offsets[level], spec.offsets[level + 1]
        acc_levels.append(gather.take_wsum_cm(
            table[:, lo:hi], idx.reshape(8, hex_n * m),
            w.reshape(8, hex_n * m),
            bf16=gather_bf16).reshape(c_dim, hex_n, m))
        del idx, w

    if fused:
        frac_lvl = (torch.stack(frac_parts) if nd else
                    x01.new_zeros((0, 3, hex_n * m)))
        parts = _GatherWSum.apply(table, torch.stack(idx_parts),
                                  torch.stack(w_parts), frac_lvl, spec, nd,
                                  gather_bf16, bwd_value_dtype,
                                  inner_grad_first and x01.requires_grad)
        acc_levels = list(parts.reshape(spec.num_levels, c_dim, hex_n, m))

    feats = []
    wmeans = []
    for level in range(spec.num_levels):
        acc, w_erf = acc_levels[level], erf_levels[level]
        if hex_n == w_erf.shape[0]:
            # Hex mode: per-point erf weights, mean over the hex axis.
            w_valid = torch.where(oob, torch.zeros_like(w_erf), w_erf)
            feats.append((acc * w_valid[None]).mean(dim=1))  # [C, M]
        else:
            # Single-query mode: one lookup at the hex-mean position,
            # modulated by the mean erf weight over the multisample stds.
            w_mean = w_erf.mean(dim=0)
            w_single = torch.where(oob[0], torch.zeros_like(w_mean), w_mean)
            feats.append(acc[:, 0] * w_single[None])
        wmeans.append(w_erf.mean(dim=0))
    return torch.cat(feats, dim=0), torch.stack(wmeans, dim=0)


def hash_decay_means(table, spec: HashGridSpec):
    """Per-level mean of squared embeddings: [L] (the JAX
    ``hash_decay_means``, the reference's segment_coo scatter-mean)."""
    return torch.stack([
        torch.mean(table[:, spec.offsets[l]:spec.offsets[l + 1]] ** 2)
        for l in range(spec.num_levels)])


def level_sq_means(table, spec: HashGridSpec):
    """Per-level mean over rows of sum_c emb^2: [L] (the scale
    featurization's, models.py:497-506)."""
    return torch.stack([
        torch.mean(torch.sum(table[:, spec.offsets[l]:spec.offsets[l + 1]]
                             ** 2, dim=0))
        for l in range(spec.num_levels)])


def tv_loss(table, spec: HashGridSpec, x=None, generator=None,
            num_points: int = 4096, bound: float = 1.0,
            weight: float = 1e-7):
    """Total-variation regularizer on the hash table at sampled points (the
    JAX ``tv_loss``, API parity with ``GridEncoder.grad_total_variation``).

    The scalar ``w * sum_{points, levels, channels} sqrt(sum_{d, side}
    (anchor - neighbour)^2 + 1e-9)`` with w = weight / (2 D) and the
    neighbours detached, so its table gradient is the CUDA kernel's anchor
    update (``kernel_grad_tv``, gridencoder.cu:507-610): per-channel rsqrt,
    out-of-bound points skipped, boundary sides masked.

    Args:
      table: [C, rows] channel-planar packed table.
      x: optional [..., D] points in [-bound, bound]; when None, num_points
        uniform samples of the unit cube are drawn from `generator`.
      weight: loss scale (reference default 1e-7).

    Returns:
      Scalar loss.
    """
    if x is None:
        if generator is None:
            raise ValueError("tv_loss needs either x or generator")
        x01 = torch.rand((num_points, spec.input_dim), generator=generator,
                         device=table.device)
    else:
        x01 = ((x + bound) / (2 * bound)).reshape(-1, spec.input_dim)
    oob = ((x01 < 0) | (x01 > 1)).any(dim=-1)  # [B]
    xs = torch.clamp(x01, 0.0, 1.0)
    total = table.new_zeros(())
    for level in range(spec.num_levels):
        scale = float(np.float32(spec.cuda_scales[level]))
        res = spec.cuda_resolutions[level]
        pg = torch.floor(xs * scale + 0.5).long()  # [B, 3]
        lo = spec.offsets[level]
        anchor = _corner_index_components(spec, level, *pg.T).long()
        a = table[:, anchor + lo]  # [C, B]
        idelta = torch.zeros_like(a)
        for d in range(spec.input_dim):
            for step, valid in ((1, pg[:, d] < res), (-1, pg[:, d] > 0)):
                npos = pg.clone()
                npos[:, d] += step
                nidx = _corner_index_components(spec, level, *npos.T).long()
                # An invalid side reads its anchor (masked below): a dense
                # level's index one step past the edge may leave the level.
                nidx = torch.where(valid, nidx, anchor)
                nval = table[:, nidx + lo].detach()
                diff = torch.where(valid[None], a - nval,
                                   torch.zeros((), dtype=a.dtype,
                                               device=a.device))
                idelta = idelta + diff * diff
        per_pt = torch.sqrt(idelta + 1e-9)
        total = total + torch.sum(torch.where(
            oob[None], torch.zeros((), dtype=a.dtype, device=a.device),
            per_pt))
    return float(np.float32(weight / (2 * spec.input_dim))) * total

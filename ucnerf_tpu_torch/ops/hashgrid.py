"""Multiresolution hash-grid encoder, forward (port of ``ucnerf_tpu/ops/hashgrid.py``).

Table layout, level offsets, per-level resolutions and the prime-XOR hash
are those of the JAX package (and so of the reference ``gridencoder.cu``).
Each level's 8-corner lookups go through ``gather.take_cm`` over that level's
slice of the channel-major ``[C, rows]`` table (the CUDA kernel on the card),
and the corners are summed right after each level's gather, so no
``[C, L*8*H*M]`` array ever exists.

The table gradient (the Pallas scatter kernels) and ``tv_loss`` come with the
training slice; until then ``take_cm`` raises if a table gradient is asked
for.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from ucnerf_tpu_torch.ops import gather

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


def encode_hex_cm(x01, stds, table, spec: HashGridSpec, grid_sizes=None,
                  gather_bf16: bool = False):
    """Channel-major hash encode with erf weighting + hex-mean folded in.

    Semantically equals the reference's per-point encode followed by the erf
    multisample downweighting and the mean over the 6 hex points
    (models.py:494-496).  The hex axis of x01 may have size 1
    (``hex_single_query``): one lookup per sample at the hex-mean position,
    modulated by the mean erf weight over the 6 stds.

    Args:
      x01: [3, H, M] unit-cube coordinates (H = 6 or 1); points outside
        [0, 1]^3 contribute zero.
      stds: [6, M] per-multisample stds in the same normalized frame, or
        None to skip the erf weighting.
      table: [C, rows] channel-planar packed table.
      grid_sizes: optional [L] resolutions for the erf weight; defaults to
        spec.resolutions.
      gather_bf16: round the gathered features to bf16
        (``MLPConfig.grid_bf16_gather``).

    Returns:
      feats [L*C, M] and wmeans [L, M] (per-level mean erf weight).
    """
    if grid_sizes is None:
        grid_sizes = np.asarray(spec.resolutions, np.float32)
    hex_n, m = x01.shape[1], x01.shape[2]

    oob = ((x01 < 0) | (x01 > 1)).any(dim=0)  # [H, M]
    xs = torch.clamp(x01, 0.0, 1.0)

    feats = []
    wmeans = []
    for level in range(spec.num_levels):
        scale = float(np.float32(spec.cuda_scales[level]))
        pos = xs * scale + 0.5
        pos_floor = torch.floor(pos)
        frac = pos - pos_floor
        pg = pos_floor.long()  # [3, H, M]

        if stds is not None:
            gs2 = float(np.float32(grid_sizes[level]) ** 2)
            w_erf = torch.erf(1.0 / torch.sqrt(8.0 * stds**2 * gs2))
        else:
            w_erf = torch.ones((hex_n, m), dtype=x01.dtype,
                               device=x01.device)

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
        lo, hi = spec.offsets[level], spec.offsets[level + 1]
        rows = gather.take_cm(table[:, lo:hi], torch.stack(idx),
                              bf16=gather_bf16)  # [C, 8, H, M]
        acc = (rows * torch.stack(w)[None]).sum(dim=1)  # [C, H, M]
        del rows, idx, w

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

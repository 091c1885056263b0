"""The benchmark's frozen arithmetic: matrix-product FLOPs of a training
step and of a render, and the least HBM bytes of the hash-grid kernels, all
from a configuration dict and the batch it runs; the chip's peaks come from
``peaks.json``.

FLOPs count the model's matrix products as the source defines them (the
field and sky MLPs, the brightness decoder, and the einsums of
compositing, sky marching and the affine colour transform): 2 m k n for an
[m, k] x [k, n] product.  A training step adds, for each product, the
products of its backward: 2 m k n for the gradient of each operand that
needs one (a weight always; an activation unless it holds no parameter's
influence, as the sky MLP's sample positions).  Recomputed work is not
counted.  The count is the same whatever implements the step.

Byte models (copies of the port's ``ops/gather.py`` and ``ops/scatter.py``
models as they stood when the benchmark was defined) count each input byte
read once and each output byte written once.  The rows a lookup touches
depend on the data and are left out, so a share errs low.
"""

from __future__ import annotations

import json
import os

from portbench.reference.grid import GridSpec, mlp_with_grid

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(device_name: str):
    """The published peaks of a device by its name, or None."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f).get(device_name)


def _levels(cfg):
    m = cfg["model"]
    out = []
    for i in range(m["num_levels"] - 1):
        out.append((mlp_with_grid(cfg["prop_mlp"],
                                  m["prop_desired_grid_size"][i]),
                    m["num_prop_samples"]))
    out.append((cfg["nerf_mlp"], m["num_nerf_samples"]))
    return out


class _Count:
    """Forward and backward FLOPs of products."""

    def __init__(self, train):
        self.train = train
        self.fwd = self.bwd = 0

    def mm(self, m, k, n, grads=2):
        """An [m, k] x [k, n] product whose `grads` operands need a
        gradient in training."""
        f = 2 * m * k * n
        self.fwd += f
        if self.train:
            self.bwd += grads * f


def _field(c, mlp, points):
    spec = GridSpec(mlp)
    c.mm(64, spec.num_levels * spec.level_dim, points)
    out_w = 1 if mlp["disable_rgb"] else mlp["bottleneck_width"]
    c.mm(out_w, 64, points)
    if mlp["disable_rgb"]:
        return
    inputs = mlp["bottleneck_width"] + 3 + 6 * mlp["deg_view"]
    width = inputs
    for i in range(mlp["net_depth_viewdirs"]):
        c.mm(mlp["net_width_viewdirs"], width, points)
        width = mlp["net_width_viewdirs"]
        if i == mlp["skip_layer_dir"]:
            width += inputs
    c.mm(mlp["num_rgb_channels"], width, points)


def _sky(c, m, rays):
    s, w = m["sky_num_samples"], m["sky_net_width"]
    pts = rays * s
    width = 3
    for i in range(m["sky_net_depth"]):
        c.mm(w, width, pts, grads=1 if i == 0 else 2)
        width = w + (3 if i == 4 else 0)
    c.mm(1, width, pts)
    c.mm(w, width, pts)
    c.mm(w // 2, w + 3 + 6 * m["sky_deg_view"], pts)
    c.mm(3, w // 2, pts)
    c.mm(1, s, 3 * rays)  # weights x colours


def flops(cfg: dict, rays: int, train: bool) -> int:
    """Matrix-product FLOPs of a forward over `rays` rays, plus its backward
    when `train`."""
    m = cfg["model"]
    c = _Count(train)
    for mlp, samples in _levels(cfg):
        _field(c, mlp, rays * samples)
        # Compositing: weights x colours.  A proposal level's colours are
        # zeros; they need a gradient only where the brightness correction's
        # gradient scaler, which takes them with the density, passes one.
        zeros = mlp["disable_rgb"] and not cfg["brightness_correction"]
        c.mm(1, samples, 3 * rays, grads=1 if zeros else 2)
    if cfg["model_sky"]:
        _sky(c, m, rays)
    if cfg["brightness_correction"]:
        w, d = m["brightness_net_width"], m["brightness_latent_dim"]
        for _ in range(2 if cfg["model_sky"] else 1):
            width = d
            for _ in range(m["brightness_net_depth"]):
                c.mm(w, width, rays)
                width = w
            c.mm(12, width, rays)
        per_level = 2 if cfg["model_sky"] else 1
        for _ in range(m["num_levels"] * per_level):
            c.mm(3, 3, rays)  # the affine transform
    return c.fwd + c.bwd


def _points(mlp, rays, samples):
    return rays * samples * (1 if mlp["hex_single_query"] else 6)


def gather_bytes(cfg: dict, rays: int) -> int:
    """Least bytes of the K4 launches of a forward over `rays` rays: per
    level a launch over its points, reading 8 int32 rows and 8 float32
    weights a point and writing C float32 features (``take_wsum_cm_bytes``
    without the touched rows)."""
    total = 0
    for mlp, samples in _levels(cfg):
        spec = GridSpec(mlp)
        n = _points(mlp, rays, samples)
        total += spec.num_levels * (8 * (4 + 4) * n + 4 * spec.level_dim * n)
    return total


def scatter_bytes(cfg: dict, rays: int, launches: int) -> int:
    """Least bytes of the table-gradient kernels of one step: `launches`
    backward passes (microbatches), each over rays / launches rays.  Per
    field, K2 over the dense levels (``dense_sum_bytes``: per sample an
    int64 position, 3 float32 fracs and C float32 grads, the run starts,
    the dense rows written) when ``grid_bwd_dense_sample``, and K1's fused
    entry over the rest (``wsum_sum_bytes``: per update an int64 position
    and a float32 weight, the [L, C, N] grads once, the run starts, the
    rows written)."""
    total = 0
    per = rays // launches
    for mlp, samples in _levels(cfg):
        spec = GridSpec(mlp)
        c = spec.level_dim
        n = _points(mlp, per, samples)
        nd = spec.dense_prefix if mlp["grid_bwd_dense_sample"] else 0
        if nd:
            rows = spec.offsets[nd]
            m = nd * n
            total += m * (8 + 12 + 4 * c) + (rows + 1) * 4 + rows * 4 * c
        if nd < spec.num_levels:
            levels = spec.num_levels - nd
            rows = spec.rows - spec.offsets[nd]
            m = levels * 8 * n
            total += (m * (8 + 4) + levels * n * 4 * c + (rows + 1) * 4
                      + rows * 4 * c)
    return total * launches

"""Plain PyTorch UC-NeRF (Zip-NeRF's proposal hierarchy, a sky NeRF beyond
the far plane and per-view affine brightness correction), as a function of
a dict of parameter tensors and a configuration dict.

It follows the source's equations in the layout of the benchmark's
configurations (channel-major activations [features, rays, samples]); each
parameter has the name it has in the port's ``state_dict``, so the harness
can load one set of tensors into both.  Nothing here imports the port.

``param_specs`` lists every parameter with its shape and initial
distribution; ``forward`` renders a flat ray batch at every sampling level
and returns the renderings and the ray history the losses read.  With a
``torch.Generator`` the forward draws what a training forward draws, in the
source's order: per level the sampling jitter, the hex pattern's flip and
rotation, and the hex basis.  Without one it is deterministic and
``rand_vec`` fixes the hex basis (a render).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import grid

EPS = float(np.finfo(np.float32).eps)
_HEX = (0.0, 2.0, 4.0, 3.0, 5.0, 1.0)


# --- parameters -------------------------------------------------------------

def _dense(specs, name, fan_in, fan_out, scale=1 / 3, bias="zero"):
    bound = math.sqrt(3 * scale / fan_in)
    specs.append((f"{name}.weight", (fan_out, fan_in), ("uniform", bound)))
    specs.append((f"{name}.bias", (fan_out,),
                  ("uniform", 1 / math.sqrt(fan_in)) if bias == "torch"
                  else ("zero",)))


def _pos_enc_width(deg):
    return 3 + 6 * deg


def levels(cfg):
    """(field name, mlp dict, samples) of each sampling level."""
    m = cfg["model"]
    out = []
    for i in range(m["num_levels"] - 1):
        mlp = grid.mlp_with_grid(cfg["prop_mlp"],
                                 m["prop_desired_grid_size"][i])
        out.append((f"prop_mlp_{i}", mlp, m["num_prop_samples"]))
    out.append(("nerf_mlp", cfg["nerf_mlp"], m["num_nerf_samples"]))
    return out


def _field_specs(specs, name, mlp):
    spec = grid.GridSpec(mlp)
    specs.append((f"{name}.table", (spec.level_dim, spec.rows),
                  ("uniform", float(mlp["grid_init_std"]))))
    feat = spec.num_levels * spec.level_dim
    _dense(specs, f"{name}.density_hidden", feat, 64)
    out_w = 1 if mlp["disable_rgb"] else mlp["bottleneck_width"]
    _dense(specs, f"{name}.density_out", 64, out_w)
    if not mlp["disable_rgb"]:
        inputs = mlp["bottleneck_width"] + _pos_enc_width(mlp["deg_view"])
        width = inputs
        for i in range(mlp["net_depth_viewdirs"]):
            _dense(specs, f"{name}.lin_second_stage_{i}", width,
                   mlp["net_width_viewdirs"], scale=2.0)
            width = mlp["net_width_viewdirs"]
            if i == mlp["skip_layer_dir"]:
                width += inputs
        _dense(specs, f"{name}.rgb_layer", width, mlp["num_rgb_channels"])


def param_specs(cfg):
    """[(name, shape, init)] in the port's order; init is ("uniform", b)
    for U(-b, b), ("zero",), or ("const", values)."""
    m = cfg["model"]
    specs = []
    for name, mlp, _ in levels(cfg)[-1:] + levels(cfg)[:-1]:
        _field_specs(specs, name, mlp)
    if cfg["model_sky"]:
        w = m["sky_net_width"]
        width = 3
        for i in range(m["sky_net_depth"]):
            _dense(specs, f"skynerf.pts_linears_{i}", width, w)
            width = w + (3 if i == 4 else 0)
        _dense(specs, "skynerf.alpha_linear", width, 1)
        _dense(specs, "skynerf.feature_linear", width, w)
        _dense(specs, "skynerf.views_linears_0",
               w + _pos_enc_width(m["sky_deg_view"]), w // 2)
        _dense(specs, "skynerf.rgb_linear", w // 2, 3)
    if cfg["brightness_correction"]:
        n, d = cfg["training_views"], m["brightness_latent_dim"]
        pre = "brightness_corr"
        specs.append((f"{pre}.latent_code", (n, d), ("zero",)))
        if cfg["model_sky"]:
            specs.append((f"{pre}.sky_latent_code", (n, 4), ("zero",)))
        width = d
        for i in range(m["brightness_net_depth"]):
            _dense(specs, f"{pre}.brightness_mlp.pts_linears_{i}", width,
                   m["brightness_net_width"], bias="torch")
            width = m["brightness_net_width"]
        specs.append((f"{pre}.brightness_mlp.output_linear.weight",
                      (12, width), ("zero",)))
        specs.append((f"{pre}.brightness_mlp.output_linear.bias", (12,),
                      ("const", (1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0))))
    return specs


# --- building blocks --------------------------------------------------------

class _RoundTF32(torch.autograd.Function):
    """x rounded to the nearest TF32 value (10 mantissa bits, ties away);
    the gradient is rounded the same way, as a TF32 product's backward
    takes it."""

    @staticmethod
    def forward(ctx, x):
        return _tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _tf32(g)


def _tf32(x):
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Products:
    """The model's matrix products, with their operands in `precision`:
    None (float32), or "tf32", each operand rounded to TF32's 10-bit
    mantissa as the tensor cores take it (products and sums stay float32).
    "tf32" is the control that ``check`` must reject."""

    def __init__(self, precision=None):
        if precision not in (None, "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.round = precision == "tf32"

    def operand(self, x):
        return _RoundTF32.apply(x) if self.round else x

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.operand(a), self.operand(b))

    def dense(self, P, name, x):
        """[in, ...] -> [out, ...] through weight [out, in] and bias."""
        w = P[f"{name}.weight"]
        y = torch.matmul(self.operand(w),
                         self.operand(x.reshape(x.shape[0], -1)))
        y = y + P[f"{name}.bias"][:, None]
        return y.reshape((w.shape[0],) + x.shape[1:])


def linspace(start, stop, num, device):
    """float32 linspace as start * (1 - k/div) + stop * k/div, last = stop."""
    f32 = torch.float32
    a = torch.tensor(start, dtype=f32, device=device)
    b = torch.tensor(stop, dtype=f32, device=device)
    step = torch.arange(num - 1, dtype=f32, device=device) / (num - 1)
    return torch.cat([a * (1 - step) + b * step, b.reshape(1)])


def pos_enc(x, deg):
    scales = 2.0 ** torch.arange(0, deg, dtype=x.dtype, device=x.device)
    sx = (x[..., None, :] * scales[:, None]).reshape(x.shape[:-1] + (-1,))
    return torch.cat([x, torch.sin(torch.cat([sx, sx + 0.5 * np.pi],
                                             dim=-1))], dim=-1)


def _extrema(mask, y):
    y_col = y[..., :, None]
    lo = torch.where(mask, y_col, y[..., :1, None]).amax(dim=-2)
    hi = torch.where(~mask, y_col, y[..., -1:, None]).amin(dim=-2)
    return lo, hi


def sorted_interp(x, xp, fp):
    mask = x[..., None, :] >= xp[..., :, None]
    fp0, fp1 = _extrema(mask, fp)
    xp0, xp1 = _extrema(mask, xp)
    t = torch.clamp(torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0), 0, 1)
    return fp0 + t * (fp1 - fp0)


def sorted_interp_quad(x, xp, fpdf, fcdf):
    mask = x[..., None, :] >= xp[..., :, None]
    big = torch.where(mask, fcdf[..., :, None], fcdf[..., :1, None])
    small = torch.where(~mask, fcdf[..., :, None], fcdf[..., -1:, None])
    fcdf0 = big.amax(dim=-2)
    fpdf0 = torch.gather(fpdf, -1, big.argmax(dim=-2))
    fpdf1 = torch.gather(fpdf, -1, small.argmin(dim=-2))
    xp0, xp1 = _extrema(mask, xp)
    t = torch.clamp(torch.nan_to_num((x - xp0) / (xp1 - xp0), nan=0.0), 0, 1)
    return fcdf0 + (x - xp0) * (fpdf0 + fpdf1 * t + fpdf0 * (1 - t)) / 2


def integrate_weights(w):
    cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1.0)
    shape = cw.shape[:-1] + (1,)
    return torch.cat([cw.new_zeros(shape), cw, cw.new_ones(shape)], dim=-1)


def max_dilate_weights(t, w, dilation, domain):
    p = w / torch.clamp(t[..., 1:] - t[..., :-1], min=EPS)
    t0, t1 = t[..., :-1] - dilation, t[..., 1:] + dilation
    td = torch.clamp(torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1)
                     .values, *domain)
    covered = ((t0[..., None, :] <= td[..., None])
               & (t1[..., None, :] > td[..., None]))
    pd = torch.where(covered, p[..., None, :],
                     torch.zeros((), dtype=p.dtype, device=p.device))
    pd = pd.amax(dim=-1)[..., :-1]
    wd = pd * (td[..., 1:] - td[..., :-1])
    return td, wd / torch.clamp(wd.sum(dim=-1, keepdim=True), min=EPS)


def sample_intervals(t, logits, n, domain, jitter):
    """Interval fenceposts [.., n+1] from the step function (t, logits)."""
    dev = t.device
    if jitter is not None:
        u_max = EPS + (1 - EPS) / n
        max_jitter = (1 - u_max) / (n - 1) - EPS
        u = linspace(0, 1 - u_max, n, dev) + jitter * max_jitter
    else:
        pad = 1 / (2 * n)
        u = linspace(pad, 1.0 - pad - EPS, n, dev).expand(
            t.shape[:-1] + (n,))
    cw = integrate_weights(torch.softmax(logits, dim=-1))
    centers = sorted_interp(u, cw, t)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=domain[0])
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=domain[1])
    return torch.cat([first, mid, last], dim=-1)


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def cast_rays(tdist, rays, basis, std_scale, flip=None, rot=None):
    """Zip-NeRF's 6-point hex multisamples: means [3, 6, R, S], stds and
    distances [6, R, S]."""
    r, s = tdist.shape[0], tdist.shape[1] - 1
    dev, dt = tdist.device, tdist.dtype
    t0, t1 = tdist[None, :, :-1], tdist[None, :, 1:]
    radii = rays["radii"].reshape(1, r, 1)
    t_m, t_d = (t0 + t1) / 2, (t1 - t0) / 2
    j = torch.arange(6, dtype=dt, device=dev).reshape(6, 1, 1)
    t = t0 + t_d / (t_d**2 + 3 * t_m**2) * (
        t1**2 + 2 * t_m**2 + 3 / 7**0.5 * (2 * j / 5 - 1)
        * torch.sqrt((t_d**2 - t_m**2) ** 2 + 4 * t_m**4))
    deg = (np.pi / 3) * torch.tensor(_HEX, dtype=dt, device=dev).reshape(
        6, 1, 1).expand(6, r, s)
    if flip is not None:
        deg = deg + 2 * np.pi * rot[None]
        deg = torch.where((flip > 0.5)[None], deg, np.pi * 5 / 3 - deg)
    else:
        even = (torch.arange(s, device=dev) % 2 == 0)[None, None, :]
        deg = torch.where(even, deg, deg + np.pi / 6)
        deg = torch.where(even, deg, np.pi * 5 / 3 - deg)
    mx = radii * t * torch.cos(deg) / 2**0.5
    my = radii * t * torch.sin(deg) / 2**0.5
    stds = std_scale * radii * t / 2**0.5
    o1 = _normalize(torch.linalg.cross(rays["cam_dirs"], basis))
    o2 = _normalize(torch.linalg.cross(rays["cam_dirs"], o1))

    def comp(c):
        return (o1[:, c].reshape(1, r, 1) * mx + o2[:, c].reshape(1, r, 1) * my
                + rays["directions"][:, c].reshape(1, r, 1) * t
                + rays["origins"][:, c].reshape(1, r, 1))
    return torch.stack([comp(0), comp(1), comp(2)]), stds, t


def contract(means, stds):
    """mip-NeRF 360's contraction of Gaussians into the radius-2 ball, with
    no gradient (as the source's track_linearize)."""
    x_sq = torch.clamp(means[0] ** 2 + means[1] ** 2 + means[2] ** 2,
                       min=EPS)
    x_mag = torch.sqrt(x_sq)
    inside = x_sq <= 1
    scale = torch.where(inside, torch.ones_like(x_sq), (2 * x_mag - 1) / x_sq)
    det = (torch.pow(torch.clamp(2 * x_mag - 1, min=EPS), 1.0 / 3.0)
           / x_mag) ** 2
    return ((means * scale[None]).detach(),
            torch.where(inside, stds, det * stds).detach())


# --- the model --------------------------------------------------------------

def field(mm, P, name, mlp, means, stds, viewdirs):
    """Density [R, S] and rgb [3, R, S] of one field."""
    spec = grid.GridSpec(mlp)
    _, _, r, s = means.shape
    m = r * s
    means, stds = contract(means, stds)
    means, stds = means / 2.0, stds / 2.0
    x01 = (means.reshape(3, 6, m) + 1.0) / 2.0
    if mlp["hex_single_query"]:
        x01 = x01.mean(dim=1, keepdim=True)
    feats = grid.encode_hex(x01, stds.reshape(6, m), P[f"{name}.table"], spec,
                            dense_bf16=mlp["grid_bwd_dense_sample"])
    x = mm.dense(P, f"{name}.density_out",
                 torch.relu(mm.dense(P, f"{name}.density_hidden", feats)))
    density = F.softplus(x[0].reshape(r, s) + mlp["density_bias"])
    if mlp["disable_rgb"]:
        rgb = torch.zeros((3, r, s), dtype=density.dtype,
                          device=density.device)
        return density, rgb
    enc = pos_enc(viewdirs, mlp["deg_view"])
    h = torch.cat([x, enc.T[:, :, None].expand(-1, r, s).reshape(-1, m)])
    inputs = h
    for i in range(mlp["net_depth_viewdirs"]):
        h = torch.relu(mm.dense(P, f"{name}.lin_second_stage_{i}", h))
        if i == mlp["skip_layer_dir"]:
            h = torch.cat([h, inputs])
    rgb = torch.sigmoid(mlp["rgb_premultiplier"]
                        * mm.dense(P, f"{name}.rgb_layer", h)
                        + mlp["rgb_bias"])
    rgb = rgb * (1 + 2 * mlp["rgb_padding"]) - mlp["rgb_padding"]
    return density, rgb.reshape(3, r, s)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; gradients times clamp(dist^2, 0, 1)."""

    @staticmethod
    def forward(ctx, rgb, density, dist):
        ctx.save_for_backward(dist)
        return rgb.view_as(rgb), density.view_as(density)

    @staticmethod
    def backward(ctx, g_rgb, g_density):
        dist, = ctx.saved_tensors
        k = torch.clamp(torch.square(dist), 0.0, 1.0)
        return g_rgb * k[None], g_density * k, None


def alpha_weights(density, tdist, dirs):
    delta = (tdist[..., 1:] - tdist[..., :-1]) * torch.linalg.norm(
        dirs[..., None, :], dim=-1)
    dd = density * delta
    trans = torch.exp(-torch.cat([torch.zeros_like(dd[..., :1]),
                                  torch.cumsum(dd[..., :-1], dim=-1)], dim=-1))
    return (1 - torch.exp(-dd)) * trans


def composite(mm, rgbs, weights, tdist, bg, t_far, extras):
    acc = weights.sum(dim=-1)
    bg_w = torch.clamp(1 - acc, min=0.0)
    out = {"rgb": mm.einsum("rs,crs->rc", weights, rgbs)
           + bg_w[:, None] * bg}
    t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
    lo, hi = tdist[..., 0], tdist[..., -1]
    depth = torch.clamp(torch.nan_to_num(
        (weights * t_mids).sum(dim=-1) / torch.clamp(acc, min=EPS),
        nan=float("inf")), lo, hi)
    out["depth"] = torch.where(acc < 0.6, torch.full_like(depth, 300.0),
                               depth)
    out["acc"] = acc
    if extras:
        mean_log = ((weights * torch.log(t_mids)).sum(dim=-1)
                    / torch.clamp(acc, min=EPS))
        out["distance_mean"] = torch.clamp(torch.nan_to_num(
            torch.exp(mean_log), nan=float("inf")), lo, hi)
        t_aug = torch.cat([tdist, t_far], dim=-1)
        w_aug = torch.cat([weights, bg_w[:, None]], dim=-1)
        q = torch.tensor([5, 50, 95], dtype=t_aug.dtype,
                         device=t_aug.device) / 100
        pct = sorted_interp(q.expand(t_aug.shape[:-1] + (3,)),
                            integrate_weights(w_aug), t_aug)
        for i, key in enumerate(("percentile_5", "median",
                                 "percentile_95")):
            out["distance_" + key] = pct[..., i]
    return out


def sky(mm, P, cfg, rays, far):
    """The sky NeRF raymarched linearly from far to far * sky_far_mult."""
    m = cfg["model"]
    r, s = rays["origins"].shape[0], m["sky_num_samples"]
    sky_far = (far[0, 0].detach() * m["sky_far_mult"]).expand_as(far)
    z = far * (1.0 - linspace(0.0, 1.0, s, far.device)) \
        + sky_far * linspace(0.0, 1.0, s, far.device)
    pts = rays["origins"].T[:, :, None] + rays["directions"].T[:, :, None] * z
    views = pos_enc(rays["cam_dirs"], m["sky_deg_view"]).T[:, :, None] \
        .expand(-1, r, s)
    h = pts
    for i in range(m["sky_net_depth"]):
        h = torch.relu(mm.dense(P, f"skynerf.pts_linears_{i}", h))
        if i == 4:
            h = torch.cat([pts, h])
    alpha_raw = mm.dense(P, "skynerf.alpha_linear", h)
    feature = mm.dense(P, "skynerf.feature_linear", h)
    h = torch.relu(mm.dense(P, "skynerf.views_linears_0",
                         torch.cat([feature, views])))
    rgb = torch.sigmoid(mm.dense(P, "skynerf.rgb_linear", h))
    dists = torch.diff(z, dim=-1)
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays["directions"], dim=-1,
                                      keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(alpha_raw[0]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], dim=-1),
                          dim=-1)[..., :-1]
    return mm.einsum("rs,crs->rc", alpha * trans, rgb)


def brightness(mm, P, cfg, idx):
    pre = "brightness_corr"
    lat = P[f"{pre}.latent_code"]
    idx = idx.long().clamp(0, lat.shape[0] - 1)

    def mlp(code):
        h = code.T
        for i in range(cfg["model"]["brightness_net_depth"]):
            h = torch.relu(mm.dense(
                P, f"{pre}.brightness_mlp.pts_linears_{i}", h))
        return mm.dense(P, f"{pre}.brightness_mlp.output_linear",
                        h).T.reshape(-1, 3, 4)
    sky_aff = mlp(P[f"{pre}.sky_latent_code"][idx]) if cfg["model_sky"] \
        else None
    return mlp(lat[idx]), sky_aff


def affine(mm, a, rgb):
    return mm.einsum("nij,nj->ni", a[:, :, :3], rgb) + a[:, :, 3]


def forward(P, cfg, rays, train_frac, rand_vec=None, generator=None,
            eval_camidx=None, extras=False, train=False, precision=None):
    """(renderings, history): one dict a sampling level each; the matrix
    products in `precision` (``Products``)."""
    mm = Products(precision)
    m = cfg["model"]
    near, far = rays["near"], rays["far"]
    n, dev = near.shape[0], near.device
    lo_bg, hi_bg = m["bg_intensity_range"]
    unsupported = [k for k, on in (
        ("a random background", lo_bg != hi_bg),
        ("near annealing", m["near_anneal_rate"] is not None),
        ("a ray-distance warp", m["raydist_fn"] is not None),
        ("an opaque background", m["opaque_background"]),
        ("camera refinement", cfg["optimize_cameras"]),
        ("field options", any(
            not f["disable_density_normals"] or f["enable_pred_normals"]
            or f["scale_featurization"] or f["density_noise"] > 0
            or f["bottleneck_noise"] > 0 or f["grid_bf16_gather"]
            or f["compute_dtype"] is not None or f["warp_fn"] != "contract"
            or f["contract_grads"] or f["grid_bwd_value_dtype"] is not None
            for f in (cfg["nerf_mlp"], cfg["prop_mlp"]))))
        if on]
    if unsupported:
        raise NotImplementedError("the reference has no " + ", ".join(
            unsupported))
    bg = lo_bg
    init_near, init_far = 0.0, 1.0
    sdist = torch.cat([torch.full_like(near, init_near),
                       torch.full_like(far, init_far)], dim=-1)
    weights = torch.ones_like(near)
    prod = 1
    renderings, history = [], []
    lv = levels(cfg)
    for i, (name, mlp, num) in enumerate(lv):
        dilation = (m["dilation_bias"] + m["dilation_multiplier"]
                    * (init_far - init_near) / prod)
        prod *= num
        if i > 0 and (m["dilation_bias"] > 0 or m["dilation_multiplier"] > 0):
            sdist, weights = max_dilate_weights(sdist, weights, dilation,
                                                (init_near, init_far))
            sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]
        s = m["anneal_slope"]
        anneal = (s * train_frac) / ((s - 1) * train_frac + 1) if s > 0 \
            else 1.0
        logits = torch.where(sdist[..., 1:] > sdist[..., :-1],
                             anneal * torch.log(weights
                                                + m["resample_padding"]),
                             torch.full_like(weights, -float("inf")))
        jitter = flip = rot = None
        basis = rand_vec
        if generator is not None:
            jitter = torch.rand((n, 1 if m["single_jitter"] else num),
                                generator=generator, device=dev)
        sdist = sample_intervals(sdist, logits, num, (init_near, init_far),
                                 jitter)
        if m["stop_level_grad"]:
            sdist = sdist.detach()
        tdist = sdist * far + (1 - sdist) * near
        if generator is not None:
            flip, rot = (torch.rand((n, num), generator=generator,
                                    device=dev) for _ in range(2))
            basis = torch.randn((n, 3), generator=generator, device=dev)
        means, stds, ts = cast_rays(tdist, rays, basis, m["std_scale"], flip,
                                    rot)
        density, rgb = field(mm, P, name, mlp, means, stds,
                             rays["viewdirs"])
        if cfg["brightness_correction"]:
            rgb, density = _ScaleGrad.apply(rgb, density, ts.mean(dim=0))
        weights = alpha_weights(density, tdist, rays["directions"])
        level = composite(mm, rgb, weights, tdist, bg, far, extras)
        level["weights"] = weights
        renderings.append(level)
        entry = {"sdist": sdist, "weights": weights}
        if train:
            entry["hash_decay"] = grid.hash_decay(P[f"{name}.table"],
                                                  grid.GridSpec(mlp))
        history.append(entry)

    sky_rgb = sky(mm, P, cfg, rays, far) if cfg["model_sky"] else None
    final_acc = renderings[-1]["weights"].sum(dim=-1, keepdim=True)
    if cfg["brightness_correction"]:
        idx = (rays["cam_idx"].reshape(-1) if eval_camidx is None else
               torch.full((n,), int(eval_camidx), dtype=torch.long,
                          device=dev))
        aff, aff_sky = brightness(mm, P, cfg, idx)
        for r in renderings:
            rgb = affine(mm, aff, r["rgb"])
            if sky_rgb is not None:
                rgb = rgb + (1.0 - final_acc) * affine(mm, aff_sky,
                                                       sky_rgb)
            r["rgb"], r["affine"], r["affine_sky"] = rgb, aff, aff_sky
    elif sky_rgb is not None:
        for r in renderings:
            r["rgb"] = r["rgb"] + (1.0 - final_acc) * sky_rgb
    return renderings, history

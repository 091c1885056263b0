"""Step-function toolkit for resampling (port of ``ucnerf_tpu/ops/stepfun.py``).

Searchsorted, PDF/weight conversion, max-dilation, CDF integration and
inversion, interval sampling (deterministic, or jittered by a uniform draw
the caller passes in), weighted percentiles, and the histogram losses of
training (``lossfun_outer``, ``lossfun_distortion``, ``blur_stepfun``).
Every lookup keeps the JAX package's masked-extrema form over a dense
[..., N, M] comparison, so ties (``v >= a``) and the clamping of
out-of-range queries agree exactly.  ``take_along_last`` becomes
``torch.gather``.
"""

from __future__ import annotations

import torch

from ucnerf_tpu_torch.ops import mathx

EPS = mathx.EPS


def searchsorted(a, v):
    """For each v, find idx_lo/idx_hi in sorted `a` with a[lo] <= v < a[hi].

    Out-of-range queries clamp both indices to the first/last index of `a`.
    """
    i = torch.arange(a.shape[-1], dtype=torch.int32, device=a.device)
    v_ge_a = v[..., None, :] >= a[..., :, None]
    idx_lo = torch.where(v_ge_a, i[:, None], i[:1, None]).amax(dim=-2)
    idx_hi = torch.where(~v_ge_a, i[:, None], i[-1:, None]).amin(dim=-2)
    return idx_lo, idx_hi


def query(tq, t, y, outside_value=0.0):
    """Look up the values of the step function (t, y) at locations tq."""
    idx_lo, idx_hi = searchsorted(t, tq)
    yq = torch.gather(y, -1, torch.clamp(idx_lo, max=y.shape[-1] - 1).long())
    return torch.where(idx_lo == idx_hi, torch.full_like(yq, outside_value),
                       yq)


def inner_outer(t0, t1, y1):
    """Construct inner and outer measures on (t1, y1) for intervals t0."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]),
                     torch.cumsum(y1, dim=-1)], dim=-1)
    idx_lo, idx_hi = searchsorted(t1, t0)
    cy1_lo = torch.gather(cy1, -1, idx_lo.long())
    cy1_hi = torch.gather(cy1, -1, idx_hi.long())
    y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
    y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                           cy1_lo[..., 1:] - cy1_hi[..., :-1],
                           torch.zeros((), dtype=y1.dtype, device=y1.device))
    return y0_inner, y0_outer


def lossfun_outer(t, w, t_env, w_env):
    """Penalize proposal weights that fail to upper-bound the nerf weights."""
    _, w_outer = inner_outer(t, t_env, w_env)
    return torch.clamp(w - w_outer, min=0.0) ** 2 / (w + EPS)


def weight_to_pdf(t, w):
    """Turn weights summing to 1 into a PDF integrating to 1."""
    return w / torch.clamp(t[..., 1:] - t[..., :-1], min=EPS)


def pdf_to_weight(t, p):
    """Turn a PDF integrating to 1 into weights summing to 1."""
    return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation, domain=(-float("inf"), float("inf"))):
    """Dilate (via max-pooling) a non-negative step function."""
    t0 = t[..., :-1] - dilation
    t1 = t[..., 1:] + dilation
    t_dilate = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
    t_dilate = torch.clamp(t_dilate, *domain)
    covered = ((t0[..., None, :] <= t_dilate[..., None])
               & (t1[..., None, :] > t_dilate[..., None]))
    w_dilate = torch.where(covered, w[..., None, :],
                           torch.zeros((), dtype=w.dtype, device=w.device))
    return t_dilate, w_dilate.amax(dim=-1)[..., :-1]


def max_dilate_weights(t, w, dilation, domain=(-float("inf"), float("inf")),
                       renormalize=False):
    """Dilate (via max-pooling) a set of weights."""
    p = weight_to_pdf(t, w)
    t_dilate, p_dilate = max_dilate(t, p, dilation, domain=domain)
    w_dilate = pdf_to_weight(t_dilate, p_dilate)
    if renormalize:
        w_dilate = w_dilate / torch.clamp(
            w_dilate.sum(dim=-1, keepdim=True), min=EPS)
    return t_dilate, w_dilate


def integrate_weights(w):
    """CDF endpoints of weights assumed to sum to 1: [0, cumsum..., 1]."""
    cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1.0)
    shape = cw.shape[:-1] + (1,)
    return torch.cat([cw.new_zeros(shape), cw, cw.new_ones(shape)], dim=-1)


def invert_cdf(u, t, w_logits):
    """Invert the CDF defined by (t, w_logits) at points u in [0, 1)."""
    w = torch.softmax(w_logits, dim=-1)
    cw = integrate_weights(w)
    return mathx.sorted_interp(u, cw, t)


def sample(t, w_logits, num_samples, deterministic_center=False,
           jitter=None):
    """Piecewise-constant PDF sampling (the JAX ``sample``).

    Args:
      t: [..., num_bins + 1], sorted bin endpoints.
      w_logits: [..., num_bins], logits of bin weights.
      num_samples: number of samples.
      deterministic_center: without jitter, return interval centers instead
        of a full-span linspace.
      jitter: None for deterministic sampling (the JAX ``key=None``), or a
        U[0, 1) draw [..., 1] (``single_jitter``) or [..., num_samples] that
        offsets the samples, as the JAX keyed branch draws it.

    Returns:
      t_samples: [..., num_samples].
    """
    if jitter is not None:
        u_max = EPS + (1 - EPS) / num_samples
        max_jitter = (1 - u_max) / (num_samples - 1) - EPS
        u = (mathx.linspace(0, 1 - u_max, num_samples, t.device)
             + jitter * max_jitter)
    else:
        if deterministic_center:
            pad = 1 / (2 * num_samples)
            u = mathx.linspace(pad, 1.0 - pad - EPS, num_samples, t.device)
        else:
            u = mathx.linspace(0, 1.0 - EPS, num_samples, t.device)
        u = u.expand(t.shape[:-1] + (num_samples,))
    return invert_cdf(u, t, w_logits)


def sample_intervals(t, w_logits, num_samples,
                     domain=(-float("inf"), float("inf")), jitter=None):
    """Sample *intervals* from a step function.

    Returns num_samples+1 fenceposts spanning midpoints of adjacent sampled
    centers, with reflected and domain-clamped first/last posts.  ``jitter``
    as for ``sample``.
    """
    if num_samples <= 1:
        raise ValueError(f"num_samples must be > 1, is {num_samples}.")
    centers = sample(t, w_logits, num_samples, deterministic_center=True,
                     jitter=jitter)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    minval, maxval = domain
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=minval)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=maxval)
    return torch.cat([first, mid, last], dim=-1)


def lossfun_distortion(t, w):
    """Compute iint w[i] w[j] |t[i] - t[j]| di dj."""
    ut = (t[..., 1:] + t[..., :-1]) / 2
    dut = torch.abs(ut[..., :, None] - ut[..., None, :])
    loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1),
                           dim=-1)
    loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
    return loss_inter + loss_intra


def weighted_percentile(t, w, ps):
    """Weighted percentiles of a step function; w must sum to 1 on each ray."""
    cw = integrate_weights(w)
    q = torch.tensor(ps, dtype=t.dtype, device=t.device) / 100
    q = q.expand(t.shape[:-1] + (len(ps),))
    return mathx.sorted_interp(q, cw, t)


def resample(t, tp, vp, use_avg=False):
    """Resample a step function (tp, vp) onto new fenceposts t: the integral
    of (tp, vp) over each new interval, or with use_avg its mean there."""
    if use_avg:
        wp = torch.diff(tp, dim=-1)
        v_numer = resample(t, tp, vp * wp, use_avg=False)
        v_denom = resample(t, tp, wp, use_avg=False)
        return v_numer / torch.clamp(v_denom, min=EPS)
    acc = torch.cumsum(vp, dim=-1)
    acc0 = torch.cat([torch.zeros_like(acc[..., :1]), acc], dim=-1)
    return torch.diff(mathx.sorted_interp(t, tp, acc0), dim=-1)


def blur_stepfun(x, y, r):
    """Convolve a step function (x, y) with a box filter of radius r.

    Returns the blurred (piecewise-linear) function sampled at the union of
    shifted knots.  x: [..., n+1] fenceposts, y: [..., n] values; output
    xr, yr: [..., 2n+2].  The knots are sorted with a stable sort that
    carries their provenance (the JAX ``sort_key_val``).
    """
    xr, xr_idx = torch.sort(torch.cat([x - r, x + r], dim=-1), dim=-1,
                            stable=True)
    zeros = torch.zeros_like(y[..., :1])
    y1 = (torch.cat([y, zeros], dim=-1) - torch.cat([zeros, y], dim=-1)) \
        / (2 * r)
    y2 = torch.gather(torch.cat([y1, -y1], dim=-1), -1, xr_idx[..., :-1])
    yr = torch.clamp(torch.cumsum((xr[..., 1:] - xr[..., :-1])
                                  * torch.cumsum(y2, dim=-1), dim=-1),
                     min=0.0)
    return xr, torch.cat([torch.zeros_like(yr[..., :1]), yr], dim=-1)

"""Step-function toolkit for resampling (port of ``ucnerf_tpu/ops/stepfun.py``).

The render path's half: searchsorted, PDF/weight conversion, max-dilation,
CDF integration and inversion, deterministic interval sampling and weighted
percentiles.  Every lookup keeps the JAX package's masked-extrema form over a
dense [..., N, M] comparison, so ties (``v >= a``) and the clamping of
out-of-range queries agree exactly.  The jittered (keyed) sampling branch
and the histogram losses come with the training slice.
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


def sample(t, w_logits, num_samples, deterministic_center=False):
    """Deterministic piecewise-constant PDF sampling (the JAX ``sample`` with
    ``key=None``).

    Args:
      t: [..., num_bins + 1], sorted bin endpoints.
      w_logits: [..., num_bins], logits of bin weights.
      num_samples: number of samples.
      deterministic_center: return interval centers instead of a full-span
        linspace.

    Returns:
      t_samples: [..., num_samples].
    """
    if deterministic_center:
        pad = 1 / (2 * num_samples)
        u = mathx.linspace(pad, 1.0 - pad - EPS, num_samples, t.device)
    else:
        u = mathx.linspace(0, 1.0 - EPS, num_samples, t.device)
    u = u.expand(t.shape[:-1] + (num_samples,))
    return invert_cdf(u, t, w_logits)


def sample_intervals(t, w_logits, num_samples,
                     domain=(-float("inf"), float("inf"))):
    """Deterministically sample *intervals* from a step function.

    Returns num_samples+1 fenceposts spanning midpoints of adjacent sampled
    centers, with reflected and domain-clamped first/last posts.
    """
    if num_samples <= 1:
        raise ValueError(f"num_samples must be > 1, is {num_samples}.")
    centers = sample(t, w_logits, num_samples, deterministic_center=True)
    mid = (centers[..., 1:] + centers[..., :-1]) / 2
    minval, maxval = domain
    first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=minval)
    last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=maxval)
    return torch.cat([first, mid, last], dim=-1)


def weighted_percentile(t, w, ps):
    """Weighted percentiles of a step function; w must sum to 1 on each ray."""
    cw = integrate_weights(w)
    q = torch.tensor(ps, dtype=t.dtype, device=t.device) / 100
    q = q.expand(t.shape[:-1] + (len(ps),))
    return mathx.sorted_interp(q, cw, t)

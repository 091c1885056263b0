"""Reflection-direction utilities and the integrated directional encoding
(port of ``ucnerf_tpu/ops/ref_utils.py``).

Vector reflection, normalization, the weighted mean angular error, and the
ref-NeRF integrated directional encoding over spherical harmonics.  The
spherical-harmonic coefficient tables are built in numpy (the JAX package's
own functions, copied); the encoding tracks the real and imaginary parts of
(x + iy)^m apart, as the JAX package does.
"""

from __future__ import annotations

import math as pymath

import numpy as np
import torch


def reflect(viewdirs, normals):
    """u = 2 dot(n, v) n - v (normals assumed unit length)."""
    return (2.0 * torch.sum(normals * viewdirs, dim=-1, keepdim=True)
            * normals - viewdirs)


def l2_normalize(x, eps=None):
    eps = eps or float(np.finfo(np.float32).eps)
    return x / torch.sqrt(
        torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=eps**2))


def compute_weighted_mae(weights, normals, normals_gt):
    """Weighted mean angular error in degrees (unit-length normals)."""
    one_eps = 1 - float(np.finfo(np.float32).eps)
    return ((weights * torch.arccos(
        torch.clamp((normals * normals_gt).sum(-1), -one_eps, one_eps))).sum()
        / weights.sum() * 180.0 / np.pi)


def _generalized_binomial_coeff(a, k):
    return np.prod(a - np.arange(k)) / pymath.factorial(k)


def _assoc_legendre_coeff(l, m, k):
    """Coefficient of cos^k sin^m in P_l^m(cos theta)."""
    return ((-1) ** m * 2**l * pymath.factorial(l) / pymath.factorial(k)
            / pymath.factorial(l - k - m)
            * _generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def _sph_harm_coeff(l, m, k):
    return (np.sqrt(
        (2.0 * l + 1.0) * pymath.factorial(l - m)
        / (4.0 * np.pi * pymath.factorial(l + m)))
        * _assoc_legendre_coeff(l, m, k))


def get_ml_array(deg_view):
    """All (m, l) pairs used by the encoding: l in {1,2,4,...}, 0 <= m <= l."""
    ml_list = []
    for i in range(deg_view):
        l = 2**i
        for m in range(l + 1):
            ml_list.append((m, l))
    return np.array(ml_list).T


def generate_ide_fn(deg_view):
    """Integrated directional encoding (ref-NeRF Eq. 6-8).

    Returns fn(xyz [..., 3], kappa_inv [..., 1]) -> [..., 2 * n_harmonics].
    """
    if deg_view > 5:
        raise ValueError("Only deg_view of at most 5 is numerically stable.")
    ml_array = get_ml_array(deg_view)
    l_max = 2 ** (deg_view - 1)

    mat_np = np.zeros((l_max + 1, ml_array.shape[1]))
    for i, (m, l) in enumerate(ml_array.T):
        for k in range(l - m + 1):
            mat_np[k, i] = _sph_harm_coeff(l, m, k)
    mat_np = mat_np.astype(np.float32)
    m_arr = [int(m) for m in ml_array[0]]
    l_arr = np.asarray(ml_array[1], np.float32)
    sigma_np = (0.5 * l_arr * (l_arr + 1)).astype(np.float32)

    def integrated_dir_enc_fn(xyz, kappa_inv):
        mat = torch.from_numpy(mat_np).to(xyz.device, xyz.dtype)
        sigma = torch.from_numpy(sigma_np).to(xyz.device, xyz.dtype)
        x = xyz[..., 0:1]
        y = xyz[..., 1:2]
        z = xyz[..., 2:3]
        vmz = torch.cat([z**i for i in range(mat.shape[0])], dim=-1)
        # (x + iy)^m via real/imag recurrences.
        re, im = torch.ones_like(x), torch.zeros_like(x)
        re_pows, im_pows = [re], [im]
        for _ in range(max(m_arr)):
            re, im = re * x - im * y, re * y + im * x
            re_pows.append(re)
            im_pows.append(im)
        vmxy_re = torch.cat([re_pows[m] for m in m_arr], dim=-1)
        vmxy_im = torch.cat([im_pows[m] for m in m_arr], dim=-1)

        zcomp = vmz @ mat
        sph_re = vmxy_re * zcomp
        sph_im = vmxy_im * zcomp
        att = torch.exp(-sigma * kappa_inv)
        return torch.cat([sph_re * att, sph_im * att], dim=-1)

    return integrated_dir_enc_fn


def generate_dir_enc_fn(deg_view):
    """Plain directional encoding: IDE with zero roughness."""
    ide_fn = generate_ide_fn(deg_view)

    def dir_enc_fn(xyz):
        return ide_fn(xyz, torch.zeros_like(xyz[..., :1]))

    return dir_enc_fn

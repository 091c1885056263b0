"""Deterministic scatter-adds for hash-grid table gradients
(port of ``ucnerf_tpu/ops/scatter.py``: K1 ``scatter_add_cm`` and K2
``scatter_add_dense_cm``).

``scatter_add_cm(values, idx, num_rows)`` computes
``out[:, idx[m]] += values[:, m]`` on channel-major ``[C, M]`` updates, and
``scatter_add_dense_cm`` the dense-level corner scatter of the JAX package:
for every sample s of dense level l and every corner k,
``out[:, base[s] + off_l(k)] += w_k(bf16(frac[:, s])) * g[:, s]``.

On a CUDA tensor both sort their keys with a stable ``torch.sort``, find each
key's run with ``torch.searchsorted`` (``sort_rows``; the JAX package sorts
with ``lax.sort`` outside its kernel too), and launch the hand-written
kernels in ``csrc/scatter.cu``, which sum every output row in a fixed order:
the result is bitwise the same on every launch, with no float atomics.  On a
CPU tensor they run the plain PyTorch versions (``index_add_``), which the
CPU tests compare against the Pallas kernels in interpret mode.  A tensor on
another device raises.

The Pallas kernels split each value into two bf16 parts for the MXU
(relative error ~1e-5); the kernels here sum in f32.  K2 rounds the
fractional coords to bf16 before it forms the corner weights, exactly as the
Pallas kernel does (``scatter.py:619-622``).
"""

from __future__ import annotations

import ctypes

import torch

from ucnerf_tpu_torch.ops import build

# Walks longer than this go to the block-per-row pass (``kLong`` in
# csrc/scatter.cu).
LONG_RUN = 256


def scatter_add_cm_plain(values, idx, num_rows: int, out=None):
    """Plain version of K1: ``out.zero_().index_add_(1, idx, values)``."""
    c = values.shape[0]
    if out is None:
        out = torch.zeros((c, num_rows), dtype=values.dtype,
                          device=values.device)
    else:
        out.zero_()
    return out.index_add_(1, idx.long(), values)


def _dense_weights(fracs, corner):
    """Trilinear corner weight from bf16-rounded fracs, in the Pallas
    kernel's order (ones, then * f or * (1 - f) per axis)."""
    w = torch.ones_like(fracs[0])
    for d in range(3):
        f = fracs[d]
        w = w * (f if corner & (1 << d) else 1.0 - f)
    return w


def scatter_add_dense_cm_plain(gvals, fracs, base_idx, num_rows: int, *,
                               level_len: int, strides, out=None):
    """Plain version of K2: the 8-corner expansion with bf16-rounded fracs,
    summed with ``index_add_``."""
    c = gvals.shape[0]
    if out is None:
        out = torch.zeros((c, num_rows), dtype=gvals.dtype,
                          device=gvals.device)
    else:
        out.zero_()
    fr = fracs[:3].to(torch.bfloat16).to(gvals.dtype)
    for l, s in enumerate(strides):
        sl = slice(l * level_len, (l + 1) * level_len)
        base = base_idx[sl].long()
        for corner in range(8):
            off = ((corner & 1) + ((corner >> 1) & 1) * s
                   + ((corner >> 2) & 1) * s * s)
            out.index_add_(1, base + off,
                           _dense_weights(fr[:, sl], corner) * gvals[:, sl])
    return out


def sort_rows(keys, num_rows: int):
    """The stable sort of int32 keys in [0, num_rows) and each key's run:
    returns (perm int64 [M], starts int32 [num_rows + 1]); the updates of
    key r are sorted positions [starts[r], starts[r + 1])."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    bounds = torch.arange(num_rows + 1, dtype=torch.int32, device=keys.device)
    starts = torch.searchsorted(sorted_keys, bounds, out_int32=True)
    return perm, starts


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")


def _check_planes(name, t, rows):
    """A [C, rows] float32 view whose rows are contiguous."""
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != rows:
        raise ValueError(f"{name} must be float32 [C, {rows}], got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.stride(1) != 1 and rows > 1:
        raise ValueError(f"{name} rows must be contiguous (stride 1)")


def _check_sorted_runs(perm, starts, m, rows, c):
    if perm.dtype != torch.int64 or perm.shape != (m,) \
            or not perm.is_contiguous():
        raise ValueError("perm must be a contiguous int64 [M] tensor")
    if starts.dtype != torch.int32 or starts.shape != (rows + 1,) \
            or not starts.is_contiguous():
        raise ValueError("starts must be a contiguous int32 [rows + 1] "
                         "tensor")
    if c not in (1, 2, 3, 4, 8):
        raise ValueError(f"{c} channels: the kernels take 1, 2, 3, 4 or 8")


def _out_buffer(out, c, num_rows, device):
    if out is None:
        return torch.empty((c, num_rows), dtype=torch.float32, device=device)
    _check_planes("out", out, num_rows)
    if out.shape[0] != c or out.device != device:
        raise ValueError(f"out must be [{c}, {num_rows}] on {device}")
    return out


def _bind(lib):
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    seg = lib.ucnerf_segment_sum_cm
    seg.argtypes = [vp, ll, vp, vp, ll, vp, ll, ctypes.c_int, vp, vp, vp]
    seg.restype = ctypes.c_int
    dense = lib.ucnerf_dense_sum_cm
    dense.argtypes = [vp, ll, vp, ll, vp, vp, ll, ctypes.POINTER(ll),
                      ctypes.POINTER(ll), ctypes.c_int, vp, ll, ctypes.c_int,
                      vp, vp, vp]
    dense.restype = ctypes.c_int
    return seg, dense


def segment_sum_cm(values, perm, starts, out):
    """Launch K1 on a prepared sort (``sort_rows``): out[:, r] = the sum of
    values[:, perm[p]] over the run of row r, for every row of out."""
    _check_cuda("segment_sum_cm", values, perm, starts, out)
    c, m = values.shape
    rows = out.shape[1]
    _check_planes("values", values, m)
    _check_sorted_runs(perm, starts, m, rows, c)
    if rows == 0:
        return out
    long_rows = torch.empty((min(rows, m // (LONG_RUN + 1) + 1),),
                            dtype=torch.int32, device=values.device)
    long_count = torch.zeros((1,), dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        seg, _ = _bind(build.load("scatter"))
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = seg(values.data_ptr(), values.stride(0), perm.data_ptr(),
                  starts.data_ptr(), rows, out.data_ptr(), out.stride(0), c,
                  long_rows.data_ptr(), long_count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: cudaError {err}")
    scatter_add_cm.launches += 1
    return out


def scatter_add_cm(values, idx, num_rows: int, out=None):
    """K1: deterministic ``out[:, idx[m]] += values[:, m]``.

    Args:
      values: [C, M] float32 updates.
      idx: [M] int32 rows in [0, num_rows).
      num_rows: output rows.
      out: optional [C, num_rows] float32 view with contiguous rows (a
        column slice of a larger buffer) to write into; every row of it is
        written.

    Returns:
      out, or a new [C, num_rows] float32 tensor.
    """
    if values.device != idx.device:
        raise ValueError(f"values on {values.device}, idx on {idx.device}")
    if values.device.type == "cpu":
        return scatter_add_cm_plain(values, idx, num_rows, out)
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be an int32 [M] tensor")
    out = _out_buffer(out, values.shape[0], num_rows, values.device)
    perm, starts = sort_rows(idx, num_rows)
    return segment_sum_cm(values, perm, starts, out)


scatter_add_cm.launches = 0


def dense_sum_cm(gvals, fracs, perm, starts, level_offsets, strides, out):
    """Launch K2 on a prepared sort of the base keys (``sort_rows``)."""
    _check_cuda("dense_sum_cm", gvals, fracs, perm, starts, out)
    c, m = gvals.shape
    rows = out.shape[1]
    _check_planes("gvals", gvals, m)
    if fracs.dtype != torch.float32 or fracs.dim() != 2 \
            or fracs.shape[0] < 3 or fracs.shape[1] != m \
            or fracs.stride(1) != 1:
        raise ValueError("fracs must be float32 [>=3, M] with contiguous "
                         "rows")
    _check_sorted_runs(perm, starts, m, rows, c)
    n = len(strides)
    if len(level_offsets) != n + 1 or level_offsets[0] != 0 \
            or level_offsets[-1] != rows or not 1 <= n <= 8:
        raise ValueError(f"level_offsets {level_offsets} must run from 0 "
                         f"to {rows} over 1 to 8 levels")
    if rows == 0:
        return out
    offs = (ctypes.c_longlong * (n + 1))(*level_offsets)
    strd = (ctypes.c_longlong * n)(*strides)
    long_rows = torch.empty((rows,), dtype=torch.int32, device=gvals.device)
    long_count = torch.zeros((1,), dtype=torch.int32, device=gvals.device)
    with torch.cuda.device(gvals.device):
        _, dense = _bind(build.load("scatter"))
        stream = torch.cuda.current_stream(gvals.device).cuda_stream
        err = dense(gvals.data_ptr(), gvals.stride(0), fracs.data_ptr(),
                    fracs.stride(0), perm.data_ptr(), starts.data_ptr(), rows,
                    offs, strd, n, out.data_ptr(), out.stride(0), c,
                    long_rows.data_ptr(), long_count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dense scatter kernel launch failed: "
                           f"cudaError {err}")
    scatter_add_dense_cm.launches += 1
    return out


def scatter_add_dense_cm(gvals, fracs, base_idx, num_rows: int, *,
                         level_len: int, strides, level_offsets, out=None):
    """K2: the dense-level corner scatter at sample granularity.

    Args:
      gvals: [C, M] float32 feature grads, M = len(strides) * level_len,
        level-major.
      fracs: [>=3, M] float32 fractional coords (fx, fy, fz, ...), rounded
        to bf16 before the weights are formed.
      base_idx: [M] int32 corner-0 rows in [0, num_rows).
      num_rows: rows of the dense region.
      level_len: samples per level.
      strides: per-level corner stride.
      level_offsets: len(strides) + 1 row offsets of the levels, 0 first and
        num_rows last; every sample's 8 corners lie inside its level.
      out: optional [C, num_rows] view to write into (every row is written).

    Returns:
      out, or a new [C, num_rows] float32 tensor.
    """
    if not gvals.device == fracs.device == base_idx.device:
        raise ValueError("gvals, fracs and base_idx on different devices")
    if gvals.shape[1] != len(strides) * level_len:
        raise ValueError(f"{gvals.shape[1]} samples for {len(strides)} "
                         f"levels of {level_len}")
    if gvals.device.type == "cpu":
        return scatter_add_dense_cm_plain(
            gvals, fracs, base_idx, num_rows, level_len=level_len,
            strides=strides, out=out)
    if base_idx.dtype != torch.int32 or base_idx.dim() != 1:
        raise ValueError("base_idx must be an int32 [M] tensor")
    out = _out_buffer(out, gvals.shape[0], num_rows, gvals.device)
    perm, starts = sort_rows(base_idx, num_rows)
    return dense_sum_cm(gvals, fracs, perm, starts, tuple(level_offsets),
                        tuple(strides), out)


scatter_add_dense_cm.launches = 0

"""Deterministic scatter-adds for hash-grid table gradients
(port of ``ucnerf_tpu/ops/scatter.py``: K1 ``scatter_add_cm``, K2
``scatter_add_dense_cm``, K3 ``scatter_add_packed_cm``, K5
``scatter_add_chunked_cm``, and ``scatter_add_partial_cm`` built from K1).

``scatter_add_cm(values, idx, num_rows)`` computes
``out[:, idx[m]] += values[:, m]`` on channel-major ``[C, M]`` updates, and
``scatter_add_dense_cm`` the dense-level corner scatter of the JAX package:
for every sample s of dense level l and every corner k,
``out[:, base[s] + off_l(k)] += w_k(bf16(frac[:, s])) * g[:, s]``.
``scatter_add_packed_cm`` is K1's sum with every update rounded once to bf16
and carried to the kernel as pairs in int32 (``pack_bf16_pairs``);
``scatter_add_chunked_cm`` is K1's sum over a stream cut into equal chunks
that are sorted each on its own and summed in chunk order.

On a CUDA tensor they sort their keys with a stable ``torch.sort``, find each
key's run with ``torch.searchsorted`` (``sort_rows``; the JAX package sorts
with ``lax.sort`` outside its kernel too; K5 searches inside its kernel),
and launch the hand-written kernels in ``csrc/scatter.cu`` and
``csrc/scatter_chunked.cu``, which sum every output row in a fixed order:
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
    packed = lib.ucnerf_packed_sum_cm
    packed.argtypes = seg.argtypes
    packed.restype = ctypes.c_int
    return {"segment": seg, "dense": dense, "packed": packed}


def _bind_chunked(lib):
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    chunked = lib.ucnerf_chunked_sum_cm
    chunked.argtypes = [vp, ll, vp, vp, ctypes.c_int, ll, ll, vp, ll,
                        ctypes.c_int, vp, vp, vp]
    chunked.restype = ctypes.c_int
    return chunked


def _long_row_scratch(rows, m, device):
    """The list of rows handed to the block-per-row pass, and its count."""
    return (torch.empty((min(rows, m // (LONG_RUN + 1) + 1),),
                        dtype=torch.int32, device=device),
            torch.zeros((1,), dtype=torch.int32, device=device))


def _launch_run_sum(kernel, planes, perm, starts, out, c):
    """Launch K1 ("segment") or K3 ("packed"): they share their arguments,
    value planes, the sort and the runs."""
    rows = out.shape[1]
    long_rows, long_count = _long_row_scratch(rows, perm.shape[0],
                                              planes.device)
    with torch.cuda.device(planes.device):
        fn = _bind(build.load("scatter"))[kernel]
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = fn(planes.data_ptr(), planes.stride(0), perm.data_ptr(),
                 starts.data_ptr(), rows, out.data_ptr(), out.stride(0), c,
                 long_rows.data_ptr(), long_count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{kernel} scatter kernel launch failed: "
                           f"cudaError {err}")


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
    _launch_run_sum("segment", values, perm, starts, out, c)
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
        dense = _bind(build.load("scatter"))["dense"]
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


def pack_bf16_pairs(values):
    """Round [C, M] f32 to bf16 (RNE) and pack channel pairs into int32:
    word p[c] carries channel c in its high 16 bits and channel c + C/2 in
    its low 16.  Returns [C // 2, M] int32, bit for bit what the JAX
    package's ``pack_bf16_pairs`` gives."""
    c = values.shape[0]
    if c % 2:
        raise ValueError(f"{c} channels: bf16 pairs need an even count")
    half = c // 2
    bits = values.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    return (bits[:half] << 16) | (bits[half:] & 0xFFFF)


def unpack_bf16_pairs(packed):
    """Inverse of ``pack_bf16_pairs``: [P, ...] int32 -> [2P, ...] f32
    (bf16-valued; the high halves first)."""
    top = (packed & -65536).view(torch.float32)
    bot = (packed << 16).view(torch.float32)
    return torch.cat([top, bot], dim=0)


def scatter_add_packed_cm_plain(values, idx, num_rows: int, out=None):
    """Plain version of K3: ``index_add_`` of the updates after the round
    trip through the bf16 pairs."""
    return scatter_add_cm_plain(unpack_bf16_pairs(pack_bf16_pairs(values)),
                                idx, num_rows, out)


def packed_sum_cm(packed, perm, starts, out):
    """Launch K3 on a prepared sort (``sort_rows``): out[:, r] = the f32 sum
    over the run of row r of the bf16 pairs packed[:, perm[p]], for every
    row of out ([2P, rows] for [P, M] words)."""
    _check_cuda("packed_sum_cm", packed, perm, starts, out)
    half, m = packed.shape
    c = 2 * half
    rows = out.shape[1]
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or (packed.stride(1) != 1 and m > 1):
        raise ValueError("packed must be int32 [C/2, M] with contiguous "
                         "rows")
    if out.shape[0] != c:
        raise ValueError(f"out must have {c} planes for {half} packed ones")
    _check_sorted_runs(perm, starts, m, rows, c)
    if rows == 0:
        return out
    _launch_run_sum("packed", packed, perm, starts, out, c)
    scatter_add_packed_cm.launches += 1
    return out


def scatter_add_packed_cm(values, idx, num_rows: int, *, out=None):
    """K3: K1's sum with each update value rounded once to bf16.

    The updates are rounded and packed as pairs in int32
    (``pack_bf16_pairs``); the kernel reads the C/2 packed planes through the
    sort's permutation, widens the halves in registers and sums in f32 in
    K1's fixed order.

    Args:
      values: [C, M] float32 updates, C even.
      idx: [M] int32 rows in [0, num_rows).
      num_rows: output rows.
      out: optional [C, num_rows] float32 view with contiguous rows to write
        into; every row of it is written.

    Returns:
      out, or a new [C, num_rows] float32 tensor.
    """
    if values.device != idx.device:
        raise ValueError(f"values on {values.device}, idx on {idx.device}")
    if values.device.type == "cpu":
        return scatter_add_packed_cm_plain(values, idx, num_rows, out)
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("idx must be an int32 [M] tensor")
    if values.dtype != torch.float32 or values.dim() != 2:
        raise ValueError("values must be a float32 [C, M] tensor")
    out = _out_buffer(out, values.shape[0], num_rows, values.device)
    perm, starts = sort_rows(idx, num_rows)
    return packed_sum_cm(pack_bf16_pairs(values), perm, starts, out)


scatter_add_packed_cm.launches = 0


def scatter_add_chunked_cm_plain(values, idx, num_rows: int):
    """Plain version of K5: one ``index_add_`` (the chunking changes the
    order of the sum, not the sum)."""
    return scatter_add_cm_plain(values, idx, num_rows)


def sort_chunks(keys, num_chunks: int):
    """One batched stable sort of the [num_chunks, M / num_chunks] view of
    int32 keys: returns (sorted keys int32 [M], perm int64 [M]), perm holding
    each sorted position's column inside its chunk."""
    sorted_keys, perm = torch.sort(
        keys.view(num_chunks, keys.shape[0] // num_chunks), dim=1,
        stable=True)
    return sorted_keys.reshape(-1), perm.reshape(-1)


def chunked_sum_cm(values, sorted_keys, perm, num_chunks: int, out):
    """Launch K5 on prepared chunk-local sorts (``sort_chunks``): every row
    of out gets the sum of its updates, chunk by chunk in chunk order."""
    _check_cuda("chunked_sum_cm", values, sorted_keys, perm, out)
    c, m = values.shape
    rows = out.shape[1]
    _check_planes("values", values, m)
    if sorted_keys.dtype != torch.int32 or sorted_keys.shape != (m,) \
            or not sorted_keys.is_contiguous():
        raise ValueError("sorted_keys must be a contiguous int32 [M] tensor")
    if perm.dtype != torch.int64 or perm.shape != (m,) \
            or not perm.is_contiguous():
        raise ValueError("perm must be a contiguous int64 [M] tensor")
    if c not in (1, 2, 3, 4, 8):
        raise ValueError(f"{c} channels: the kernels take 1, 2, 3, 4 or 8")
    if rows == 0:
        return out
    long_rows, long_count = _long_row_scratch(rows, m, values.device)
    with torch.cuda.device(values.device):
        chunked = _bind_chunked(build.load("scatter_chunked"))
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = chunked(values.data_ptr(), values.stride(0),
                      sorted_keys.data_ptr(), perm.data_ptr(), num_chunks,
                      m // num_chunks, rows, out.data_ptr(), out.stride(0),
                      c, long_rows.data_ptr(), long_count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"chunked scatter kernel launch failed: "
                           f"cudaError {err}")
    scatter_add_chunked_cm.launches += 1
    return out


def scatter_add_chunked_cm(values, idx, num_rows: int, *, num_chunks: int):
    """K5: deterministic scatter-add with chunk-local sorting.

    The stream is cut into ``num_chunks`` equal contiguous chunks, each
    sorted on its own (one batched ``torch.sort``), and every output row
    sums its updates chunk by chunk in chunk order.  The kernel finds each
    row's run inside each chunk with a binary search of the chunk's sorted
    keys, so no ``[num_chunks, num_rows]`` table of run starts is stored.

    Args:
      values: [C, M] float32 updates, M divisible by num_chunks.
      idx: [M] int32 rows in [0, num_rows).
      num_rows: output rows.
      num_chunks: chunks of the stream.

    Returns:
      [C, num_rows] float32, bitwise the same on every call.
    """
    if values.device != idx.device:
        raise ValueError(f"values on {values.device}, idx on {idx.device}")
    m = values.shape[1]
    if num_chunks < 1 or m % num_chunks:
        raise ValueError(f"{m} updates do not split into {num_chunks} "
                         f"equal chunks")
    if values.device.type == "cpu":
        return scatter_add_chunked_cm_plain(values, idx, num_rows)
    if idx.dtype != torch.int32 or idx.shape != (m,) \
            or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous int32 [M] tensor")
    out = _out_buffer(None, values.shape[0], num_rows, values.device)
    sorted_keys, perm = sort_chunks(idx, num_chunks)
    return chunked_sum_cm(values, sorted_keys, perm, num_chunks, out)


scatter_add_chunked_cm.launches = 0


def scatter_add_partial_cm(values, idx, num_rows: int, *, num_chunks: int,
                           sort_segments: int = 1):
    """Partial-table chunked scatter-add: no kernel of its own.

    The stream's ``sort_segments`` level segments each split into
    ``num_chunks`` sub-chunks; sub-chunk g of every segment concatenates
    into a stream of its own, which K1 (``scatter_add_cm``) sums into its
    own partial table; the partial tables are added in order.  Needs
    ``M % (sort_segments * num_chunks) == 0``.
    """
    c, m = values.shape
    pieces = sort_segments * num_chunks
    if num_chunks < 1 or sort_segments < 1 or m % pieces:
        raise ValueError(f"{m} updates do not split into {sort_segments} "
                         f"segments of {num_chunks} chunks")
    sub = m // pieces
    vals4 = values.reshape(c, sort_segments, num_chunks, sub)
    idx3 = idx.reshape(sort_segments, num_chunks, sub)
    out = None
    for g in range(num_chunks):
        part = scatter_add_cm(vals4[:, :, g].reshape(c, -1),
                              idx3[:, g].reshape(-1), num_rows)
        out = part if out is None else out + part
    return out

"""Forward gather of hash-grid table columns (port of ``ucnerf_tpu/ops/gather.py``).

``take_cm(table, idx)`` computes ``out[:, i] = table[:, idx[i]]`` on a
channel-major ``[C, rows]`` table, with zeros for indices outside
``[0, rows)`` (the JAX kernel's sentinels) and, with ``bf16=True``, every
value rounded to bf16 and widened back (the JAX kernel's ``two_pass=False``,
i.e. ``Config.grid_bf16_gather``).

``take_wsum_cm(table, idx, w)`` is the same gather with the encoder's weighted
corner sum as its epilogue: ``out[:, n] = sum_k w[k, n] * table[:, idx[k, n]]``
over the 8 corners of a point, so the ``[C, 8, N]`` gathered tensor is never
stored.  The hash encoder launches it once per level wherever the weights
need no gradient (every render, and every training step whose sample
positions carry no gradient); ``take_cm`` serves the other case, where the
gathered rows are kept for the weights' gradient.

On a CUDA tensor both launch the hand-written kernels in ``csrc/gather.cu``
(which replace the Pallas ``gather_sorted_cm``; see the note there for the
design and bound): the level's slice is first copied into a row-interleaved
``[rows, C]`` scratch image, so that each index is one 16-byte load.  Both
count in ``take_cm.launches`` / ``take_wsum_cm.launches``.  On a CPU tensor
they run ``take_cm_plain`` / ``take_wsum_cm_plain``, the plain PyTorch
versions, which the CPU tests compare against the JAX package.  There is no
other route: a tensor on another device raises.

``take_cm_bytes`` and ``take_wsum_cm_bytes`` are the kernels' byte models:
the HBM bytes a launch must move, which bound its time
(``utils/roofline.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ucnerf_tpu_torch.ops import build
from ucnerf_tpu_torch.ops.traffic import kernel_bytes

# The kernels take up to this many channels (``kMaxChannels`` in
# csrc/gather.cu); 4 has the 16-byte path.
MAX_CHANNELS = 16
CORNERS = 8


def take_cm_plain(table, idx, bf16: bool = False):
    """Plain PyTorch version of the kernel: ``table[:, idx]`` with the
    sentinel mask.  table [C, rows] float32, idx int [...] -> [C, ...]."""
    rows = table.shape[1]
    valid = (idx >= 0) & (idx < rows)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    out = table[:, safe.reshape(-1)].reshape((table.shape[0],) + idx.shape)
    out = torch.where(valid[None], out, torch.zeros((), dtype=out.dtype,
                                                    device=out.device))
    if bf16:
        out = out.to(torch.bfloat16).to(torch.float32)
    return out


def take_wsum_cm_plain(table, idx, w, bf16: bool = False):
    """Plain PyTorch version of the fused kernel: the gather, the product
    with the weights and the sum over the corner axis, as three passes.
    table [C, rows], idx int [8, N], w [8, N] -> [C, N]."""
    return (take_cm_plain(table, idx, bf16) * w[None]).sum(dim=1)


def rows_touched(table, idx) -> int:
    """The distinct rows of table [C, rows] that idx reads (sentinels
    excluded)."""
    flat = idx.reshape(-1)
    return int(torch.unique(flat[(flat >= 0) & (flat < table.shape[1])])
               .numel())


def take_cm_bytes(c: int, m: int, touched: int) -> int:
    """Bytes of a ``take_cm`` launch: m int32 indices read, [C, m] float32
    written, each of the `touched` rows read once."""
    return 4 * m + 4 * c * m + 4 * c * touched


def take_wsum_cm_bytes(c: int, n: int, touched: int) -> int:
    """Bytes of a ``take_wsum_cm`` launch over n points: 8 int32 indices and
    8 float32 weights a point read, [C, n] float32 written, each of the
    `touched` rows read once."""
    return 8 * (4 + 4) * n + 4 * c * n + 4 * c * touched


def _bind(lib):
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    take = lib.ucnerf_take_cm
    take.argtypes = [vp, ll, ll, vp, ll, vp, vp, ci, ci, vp]
    take.restype = ci
    wsum = lib.ucnerf_take_wsum_cm
    wsum.argtypes = [vp, ll, ll, vp, vp, ll, vp, vp, ci, ci, vp]
    wsum.restype = ci
    inter = lib.ucnerf_interleave_cm
    inter.argtypes = [vp, ll, ll, vp, ci, vp]
    inter.restype = ci
    return {"take": take, "wsum": wsum, "interleave": inter}


def _check_table(name, table):
    """What the kernels ask of a CUDA table slice."""
    if table.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be 2-D float32, got {table.dtype} "
                         f"{tuple(table.shape)}")
    c, rows = table.shape
    if table.stride(1) != 1 and rows > 1:
        raise ValueError("table rows must be contiguous (stride 1)")
    if c > MAX_CHANNELS:
        raise ValueError(f"{c} channels: the kernels take at most "
                         f"{MAX_CHANNELS}")
    if rows >= 2**31:
        raise ValueError(f"{rows} rows do not fit an int32 index")


def _check_idx(idx):
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous int32 tensor")


def _image(table):
    """Scratch for the row-interleaved copy of a [C, rows] slice."""
    c, rows = table.shape
    return torch.empty((rows, c), dtype=torch.float32, device=table.device)


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def interleave_cm(table):
    """The ``[rows, C]`` image of a CUDA ``[C, rows]`` table slice that
    ``take_cm`` and ``take_wsum_cm`` make for themselves on every call; on
    its own it serves to time that part (``chip_smoke.py``)."""
    _check_table("interleave_cm", table)
    c, rows = table.shape
    image = _image(table)
    with torch.cuda.device(table.device):
        fn = _bind(build.load("gather"))["interleave"]
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), rows, image.data_ptr(),
                 c, stream)
    _raise_on(err, "interleave")
    return image


@kernel_bytes(lambda table, idx, bf16=False: take_cm_bytes(
    table.shape[0], idx.numel(), rows_touched(table, idx)))
def take_cm(table, idx, bf16: bool = False):
    """Gather columns of a [C, rows] float32 table at int32 indices idx [...].

    The table may be a column slice of a larger table (a hash level's rows):
    its row stride must be 1, its channel stride is passed to the kernel.
    Returns a new [C, *idx.shape] float32 tensor.  The kernel has no
    backward of its own: the table gradient is ``hashgrid``'s autograd
    Function, whose forward calls this on the detached table.
    """
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")
    if table.device.type == "cpu":
        return take_cm_plain(table, idx, bf16)
    _check_table("take_cm", table)
    _check_idx(idx)
    c, rows = table.shape
    out = torch.empty((c,) + tuple(idx.shape), dtype=torch.float32,
                      device=table.device)
    m = idx.numel()
    if m == 0 or c == 0:
        return out
    image = _image(table)
    with torch.cuda.device(table.device):
        fn = _bind(build.load("gather"))["take"]
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), rows, idx.data_ptr(), m,
                 out.data_ptr(), image.data_ptr(), c, int(bf16), stream)
    _raise_on(err, "gather")
    take_cm.launches += 1
    return out


take_cm.launches = 0


@kernel_bytes(lambda table, idx, w, bf16=False: take_wsum_cm_bytes(
    table.shape[0], idx.shape[1], rows_touched(table, idx)))
def take_wsum_cm(table, idx, w, bf16: bool = False):
    """Gather the 8 corner rows of N points and sum them with their weights.

    ``out[c, n] = sum_k w[k, n] * r(table[c, idx[k, n]])`` for k = 0..7 in
    that order, ``r`` the optional bf16 rounding, an index outside
    ``[0, rows)`` contributing 0; products and sums in f32.  It differs from
    ``take_wsum_cm_plain`` only in the order in which the 8 terms are added
    (at most 8 ulp of ``sum_k |w * row|``), and equals ``take_cm`` bitwise
    where one weight is 1 and the others 0.

    Args:
      table: [C, rows] float32, possibly a column slice (row stride 1).
      idx: [8, N] int32, contiguous.
      w: [8, N] float32, contiguous.  It gets no gradient here: with grad
        mode on and ``w.requires_grad`` the call raises (the encoder then
        gathers with ``take_cm`` and keeps the rows).
      bf16: round each gathered value to bf16 first.

    Returns:
      [C, N] float32.
    """
    if not table.device == idx.device == w.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}, "
                         f"w on {w.device}")
    if idx.dim() != 2 or idx.shape[0] != CORNERS or w.shape != idx.shape:
        raise ValueError(f"idx and w must be [{CORNERS}, N], got "
                         f"{tuple(idx.shape)} and {tuple(w.shape)}")
    if torch.is_grad_enabled() and w.requires_grad:
        raise ValueError("take_wsum_cm gives the weights no gradient")
    if table.device.type == "cpu":
        return take_wsum_cm_plain(table, idx, w, bf16)
    _check_table("take_wsum_cm", table)
    _check_idx(idx)
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("w must be a contiguous float32 tensor")
    c, rows = table.shape
    n = idx.shape[1]
    out = torch.empty((c, n), dtype=torch.float32, device=table.device)
    if n == 0 or c == 0:
        return out
    image = _image(table)
    with torch.cuda.device(table.device):
        fn = _bind(build.load("gather"))["wsum"]
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), rows, idx.data_ptr(),
                 w.data_ptr(), n, out.data_ptr(), image.data_ptr(), c,
                 int(bf16), stream)
    _raise_on(err, "fused gather")
    take_wsum_cm.launches += 1
    return out


take_wsum_cm.launches = 0

"""Forward gather of hash-grid table columns (port of ``ucnerf_tpu/ops/gather.py``).

``take_cm(table, idx)`` computes ``out[:, i] = table[:, idx[i]]`` on a
channel-major ``[C, rows]`` table, with zeros for indices outside
``[0, rows)`` (the JAX kernel's sentinels) and, with ``bf16=True``, every
value rounded to bf16 and widened back (the JAX kernel's ``two_pass=False``,
i.e. ``Config.grid_bf16_gather``).

On a CUDA tensor it launches the hand-written kernel in ``csrc/gather.cu``
(which replaces the Pallas ``gather_sorted_cm``; see the note there for its
design and bound).  On a CPU tensor it runs ``take_cm_plain``, the plain
PyTorch version, which the CPU tests compare against the JAX package.  There
is no other route: a tensor on another device raises.
"""

from __future__ import annotations

import ctypes

import torch

from ucnerf_tpu_torch.ops import build


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


def _bind(lib):
    fn = lib.ucnerf_take_cm
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if table.device.type != "cuda":
        raise ValueError(f"take_cm runs on cuda or cpu, not {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be 2-D float32, got {table.dtype} "
                         f"{tuple(table.shape)}")
    c, rows = table.shape
    if table.stride(1) != 1 and rows > 1:
        raise ValueError("table rows must be contiguous (stride 1)")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous int32 tensor")
    out = torch.empty((c,) + tuple(idx.shape), dtype=torch.float32,
                      device=table.device)
    m = idx.numel()
    if m == 0 or c == 0:
        return out
    with torch.cuda.device(table.device):
        fn = _bind(build.load("gather"))
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), table.stride(0), rows, idx.data_ptr(), m,
                 out.data_ptr(), c, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError {err}")
    take_cm.launches += 1
    return out


take_cm.launches = 0

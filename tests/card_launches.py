"""The port's hand-written kernels counted on the device: how many times the
card ran each kernel wrapper's kernel, read from a ``torch.profiler``
trace by the kernel's name.  A kernel launched from a CUDA graph shows in
the trace like one launched by the host, so this counts what a graph
replay ran, which the wrappers' ``.launches`` (the launches their Python
issued) do not see.

Each wrapper launches one kernel that names it (``csrc/*.cu``): K4's
``take_kernel`` and ``take_wsum_kernel``; the scatters' first walk
``rows_kernel<...>``, told apart by the walk's source (``F32Planes`` K1,
``WeightedRows`` K1's fused entry, ``DenseWalk`` K2, ``Bf16Pairs`` K3,
``Bf16Records`` K3's fused entry); K5's ``chunk_tiles_kernel``; the run
starts' ``run_starts_kernel``; and ``hash_corners_kernel``.  Used by
``tests/test_card_train_graph.py`` and ``chip_smoke.py``; imports no JAX.
"""

import re

# Wrapper name -> the pattern of its kernel's name.
KERNELS = {
    "take_cm": r"\btake_kernel<",
    "take_wsum_cm": r"\btake_wsum_kernel<",
    "hash_corners": r"\bhash_corners_kernel\b",
    "run_starts": r"\brun_starts_kernel\b",
    "scatter_add_cm": r"\brows_kernel<.*\bF32Planes<",
    "scatter_add_wsum_cm": r"\brows_kernel<.*\bWeightedRows<",
    "scatter_add_dense_cm": r"\brows_kernel<.*\bDenseWalk<",
    "scatter_add_packed_cm": r"\brows_kernel<.*\bBf16Pairs<",
    "scatter_add_wsum_packed_cm": r"\brows_kernel<.*\bBf16Records<",
    "scatter_add_chunked_cm": r"\bchunk_tiles_kernel<",
}
_PATTERNS = {k: re.compile(v) for k, v in KERNELS.items()}


def count(names):
    """{wrapper: the number of `names` (device kernels' names) that are its
    kernel}."""
    out = dict.fromkeys(KERNELS, 0)
    for name in names:
        for k, pattern in _PATTERNS.items():
            if pattern.search(name):
                out[k] += 1
    return out


def on_device(fn):
    """fn() run under ``torch.profiler`` (the host's and the card's
    activity), the card synchronized before the trace stops; returns
    (fn's result, `count` of the kernels the card ran)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, count(names)

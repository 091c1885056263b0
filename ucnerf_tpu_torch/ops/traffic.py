"""Memory traffic of a PyTorch computation, counted by op, with the
hand-written kernels counted by their own byte models.

``ByteCounter`` is a ``TorchDispatchMode`` that adds, for every aten op that
moves data, the bytes of its tensor operands and outputs, each tensor once
per op: the analogue of XLA's "bytes accessed", an ideal count that ignores
caches and re-reads.  Views and allocations move nothing and are skipped.

The CUDA kernels launch through ctypes (``ops/build.py``), below the
dispatcher, so no mode sees them; on the CPU the same wrappers run their
plain versions, which a mode does see.  So that a count does not depend on
the route, every kernel wrapper is decorated with ``kernel_bytes(model)``:
while a ``ByteCounter`` is active the wrapper runs with every dispatch mode
suspended and the counter adds ``model(*args, **kwargs)``, the kernel's own
byte model (the bound that ``chip_smoke.py`` reports beside the kernel's
time).  The sort that prepares a scatter is not in its model.
"""

from __future__ import annotations

import functools
from collections import Counter

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

_aten = torch.ops.aten
# Ops that only allocate: their outputs are counted where they are written.
_ALLOCATING = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}
# The ByteCounters entered and not yet left, so that a kernel wrapper outside
# every counter costs one test; emptied while a counted kernel runs, so that
# a wrapper it calls adds nothing twice.
_ACTIVE: list = []


class ByteCounter(TorchDispatchMode):
    """Counts the bytes that the aten ops run inside it move, and the byte
    models of the kernels called inside it (``kernel_bytes``).

    ``bytes`` is the total; ``kernels`` the kernels' share by wrapper name.
    """

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.kernels = Counter()

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func in _ALLOCATING:
            return out
        seen = set()
        for t in pytree.tree_leaves((args, kwargs, out)):
            if not isinstance(t, torch.Tensor):
                continue
            key = (t.untyped_storage().data_ptr(), t.storage_offset(),
                   tuple(t.shape), t.dtype)
            if key not in seen:
                seen.add(key)
                self.bytes += t.numel() * t.element_size()
        return out

    def add_kernel(self, name: str, nbytes: int):
        self.bytes += nbytes
        self.kernels[name] += nbytes


def kernel_bytes(model):
    """Decorator of a kernel wrapper: inside a ``ByteCounter`` the wrapper
    runs unseen by every dispatch mode (as a ctypes launch is) and the
    counter adds ``model(*args, **kwargs)``; outside one it runs as it
    is."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ACTIVE:
                return fn(*args, **kwargs)
            counters = _ACTIVE[:]
            _ACTIVE.clear()
            try:
                with _disable_current_modes():
                    nbytes = int(model(*args, **kwargs))
                    out = fn(*args, **kwargs)
            finally:
                _ACTIVE[:] = counters
            for counter in counters:
                counter.add_kernel(fn.__name__, nbytes)
            return out
        return wrapper
    return wrap

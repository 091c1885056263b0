"""Named spans at the port's layer boundaries, for whoever profiles it.

While a ``torch.profiler`` records, ``span(name)`` is a
``torch.profiler.record_function``: the trace shows the layer's host time
beside the kernels it launched, on one clock.  Otherwise it is one shared
null context, so an unprofiled call costs a flag test and allocates
nothing.  There is no setting: every profiler sees the spans, such as the
one ``cli.train --profile-steps`` starts.

The spans (all named ``ucnerf.*``): ``data.sample`` (a training batch's
pixels and rays on the host), ``data.to_device`` (a ray batch to the
device), ``forward`` (the model's whole forward), ``encode`` (a field's
contraction, hash indices and gather), ``losses``, ``backward``,
``optimizer`` (gradient scale, all-reduce, clean, clips, Adam, schedule),
``graph_replay`` (a train step's microbatch loop replayed from a CUDA
graph, in place of its forward, losses and backward spans) and ``render``
(``render_image``'s chunk loop).
"""

from __future__ import annotations

import contextlib
import functools

import torch

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context that marks `name` in the trace of a recording profiler."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


def spanned(name: str):
    """Decorator: the function's body runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap

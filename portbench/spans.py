"""The program's own spans in a traced run, against the device's idle time.

The port marks its layers with ``record_function`` spans named
``ucnerf.*`` (``ucnerf_tpu_torch/utils/spans.py``); they land in the same
trace as the device's intervals, on one clock.  An idle gap of the device
is charged to a layer for the part of it that the layer's spans cover: the
union of their host intervals, on any thread, clipped to the traced span.
A trace without any ``ucnerf.*`` span (a program that has none) reads
None.
"""

from __future__ import annotations

import numpy as np

PREFIX = "ucnerf."
DATA = ("ucnerf.data.sample", "ucnerf.data.to_device")
STEP = DATA + ("ucnerf.forward", "ucnerf.losses", "ucnerf.backward",
               "ucnerf.optimizer")


def present(trace) -> bool:
    return any(e["name"].startswith(PREFIX) for e in trace.host)


def union(trace, names):
    """The union of the host intervals of spans named in `names`, clipped
    to the traced span: [K, 2] in us, sorted and disjoint."""
    out = []
    for a, b in sorted(
            (max(float(e["ts"]), trace.t0),
             min(float(e["ts"]) + float(e["dur"]), trace.t1))
            for e in trace.host if e["name"] in names):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out).reshape(-1, 2)


def subtract(a, b):
    """The intervals of `a` outside those of `b` (both sorted, disjoint)."""
    out = []
    for lo, hi in a:
        for blo, bhi in b:
            if bhi <= lo or blo >= hi:
                continue
            if blo > lo:
                out.append([lo, blo])
            lo = max(lo, bhi)
            if lo >= hi:
                break
        if lo < hi:
            out.append([lo, hi])
    return np.array(out).reshape(-1, 2)


def length_s(intervals) -> float:
    return float((intervals[:, 1] - intervals[:, 0]).sum()) * 1e-6


def idle_s(trace, intervals) -> float:
    """Seconds of the device's idle gaps that lie inside `intervals`."""
    gaps = trace.gaps()
    if not len(gaps) or not len(intervals):
        return 0.0
    lo, hi = gaps[:, 0], gaps[:, 1]
    before = np.concatenate([[0.0], np.cumsum(hi - lo)])

    def idle_to(t):
        # Idle time from the span's start to each t: the whole gaps that
        # start at or before t, less the part of the last beyond t.
        i = np.searchsorted(lo, t, side="right")
        last = np.maximum(i - 1, 0)
        beyond = np.clip(hi[last] - t, 0.0, None)
        return np.where(i > 0, before[i] - beyond, 0.0)

    return float((idle_to(intervals[:, 1])
                  - idle_to(intervals[:, 0])).sum()) * 1e-6


def _readable(run, kind) -> bool:
    return run.kind == kind and run.trace is not None and present(run.trace)


def host_ms(run, kind, names):
    """Host ms a unit inside the spans `names`, or None for another kind
    or a trace without spans."""
    if not _readable(run, kind):
        return None
    return 1e3 * length_s(union(run.trace, names)) / run.units


def idle_ms(run, kind, names, exclude=()):
    """Device idle ms a unit inside the spans `names` (and outside
    `exclude`), or None as ``host_ms``."""
    if not _readable(run, kind):
        return None
    inside = union(run.trace, names)
    if exclude:
        inside = subtract(inside, union(run.trace, exclude))
    return 1e3 * idle_s(run.trace, inside) / run.units


def covered(run, kind, names):
    """The share (%) of the traced span's device idle time that lies inside
    the spans `names`, or None as ``host_ms``."""
    if not _readable(run, kind):
        return None
    idle = run.trace.window_s - run.trace.busy_s()
    if idle <= 0:
        return None
    return 100.0 * idle_s(run.trace, union(run.trace, names)) / idle

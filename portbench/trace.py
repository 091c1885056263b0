"""The traced part of a run: ``torch.profiler`` over a few steady steps or
views, its Chrome trace read back, and the arithmetic the per-layer readers
share.

Device time is the union of the intervals of the device's kernels, copies
and fills inside the traced span (a sum over kernels would count overlap
twice); the span is the host annotation the harness wraps around the
traced units.  Launches are the runtime's and the driver's launch calls
(kernel and graph launches), which tick whether a kernel comes from a
library, a hand-written CUDA source or a graph replay.  Idle gaps are the
stretches of the span that no device interval covers, each named by the
innermost host operation that was running at its midpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

SPAN = "portbench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
            "cudaGraphLaunch", "cuGraphLaunch")


class Profile:
    """Start and stop the profiler around the traced units."""

    def __init__(self, torch):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.torch = torch
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.span = record_function(SPAN)

    def start(self):
        self.torch.cuda.synchronize()
        self.prof.start()
        self.span.__enter__()

    def stop(self):
        self.torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return Trace(events)


class Trace:
    """Device intervals, launch calls and host operations of the span."""

    def __init__(self, events):
        spans = [e for e in events if e.get("name") == SPAN
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise RuntimeError("the trace holds no traced span")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        self.names = [e["name"] for e in dev]
        self.start = np.array([float(e["ts"]) for e in dev])
        self.dur = np.array([float(e["dur"]) for e in dev])
        self.launches = sum(
            1 for e in events if e.get("ph") == "X"
            and e.get("name") in LAUNCHES
            and self.t0 <= float(e["ts"]) <= self.t1)
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS and e.get("name") != SPAN]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def merged(self):
        """The union of device intervals inside the span, [K, 2] in us."""
        if not len(self.start):
            return np.zeros((0, 2))
        lo = np.clip(self.start, self.t0, self.t1)
        hi = np.clip(self.start + self.dur, self.t0, self.t1)
        order = np.argsort(lo)
        out = []
        for a, b in zip(lo[order], hi[order]):
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.array(out).reshape(-1, 2)

    def busy_s(self) -> float:
        m = self.merged()
        return float((m[:, 1] - m[:, 0]).sum()) * 1e-6

    def seconds(self, patterns, exclude=()) -> float:
        """Device seconds of the kernels whose names hold one of
        `patterns` and none of `exclude`."""
        total = 0.0
        for name, d in zip(self.names, self.dur):
            if any(p in name for p in patterns) \
                    and not any(x in name for x in exclude):
                total += d
        return total * 1e-6

    def top_ops(self, k=10):
        by = defaultdict(float)
        for name, d in zip(self.names, self.dur):
            by[name] += d * 1e-6
        return sorted(([n[:160], s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def gaps(self):
        """Idle stretches of the span, [G, 2] in us."""
        m = self.merged()
        edges = np.concatenate([[self.t0], m.reshape(-1), [self.t1]])
        g = edges.reshape(-1, 2)
        return g[g[:, 1] > g[:, 0]]

    def idle_gaps(self, k=10):
        """Idle seconds summed by the innermost host operation at each
        gap's midpoint (any thread), the longest first."""
        gaps = self.gaps()
        if not len(gaps):
            return []
        mids = (gaps[:, 0] + gaps[:, 1]) / 2
        best = [None] * len(mids)
        best_dur = np.full(len(mids), np.inf)
        by_thread = defaultdict(list)
        for e in self.host:
            by_thread[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), float(e["dur"]), e["name"]))
        order = np.argsort(mids)
        for evs in by_thread.values():
            evs.sort(key=lambda x: (x[0], -x[1]))
            stack, j = [], 0
            for qi in order:
                t = mids[qi]
                while j < len(evs) and evs[j][0] <= t:
                    while stack and stack[-1][0] + stack[-1][1] < evs[j][0]:
                        stack.pop()
                    stack.append(evs[j])
                    j += 1
                while stack and stack[-1][0] + stack[-1][1] < t:
                    stack.pop()
                if stack and stack[-1][1] < best_dur[qi]:
                    best_dur[qi] = stack[-1][1]
                    best[qi] = stack[-1][2]
        by = defaultdict(float)
        for (a, b), name in zip(gaps, best):
            by[name or "(host between operations)"] += (b - a) * 1e-6
        return sorted(([n[:160], s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

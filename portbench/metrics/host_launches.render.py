"""Kernel and graph launches a render chunk issues: the runtime's and the
driver's launch calls in the traced views, divided by their chunks."""


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    return run.trace.launches / (run.units * run.chunks_per_unit)

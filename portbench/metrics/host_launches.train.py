"""Kernel and graph launches a training step issues: the runtime's and the
driver's launch calls in the traced steps, divided by their count."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return run.trace.launches / run.units

"""The device's idle share of the traced views: 1 - the union of its
kernel, copy and fill intervals over the traced span."""


def read(run):
    if run.kind != "render" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

"""Device milliseconds a training step spends preparing the table-gradient
scatters: the radix sorts of the row keys and the run-starts pass."""

from portbench import kernels


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    seconds = run.trace.seconds(kernels.SORT)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.units

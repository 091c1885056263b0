"""The table-gradient scatter (K1's fused entry and K2) in a training step:
the least time by the frozen byte model (``roofline.scatter_bytes`` at the
card's HBM rate) over the device time of its walk, record and interleave
kernels in the trace; the key sorts and run starts are left out (they are
``sort_ms.train``)."""

from portbench import kernels, roofline


def read(run):
    if run.kind != "train" or run.trace is None or run.peak_bw is None:
        return None
    seconds = run.trace.seconds(kernels.SCATTER) / run.units
    if seconds <= 0:
        return None
    least = roofline.scatter_bytes(run.cfg, run.unit_rays,
                                   run.cfg["microbatches"]) / run.peak_bw
    return 100.0 * least / seconds

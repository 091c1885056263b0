"""K4, the hash-grid gather, in a training step: the least time its
launches need by the frozen byte model (``roofline.gather_bytes`` at the
card's HBM rate) over the device time of its kernels in the trace (the
fused and plain gathers and the table's row interleave before them)."""

from portbench import kernels, roofline


def read(run):
    if run.kind != "train" or run.trace is None or run.peak_bw is None:
        return None
    seconds = run.trace.seconds(kernels.K4) / run.units
    if seconds <= 0:
        return None
    least = roofline.gather_bytes(run.cfg, run.unit_rays) / run.peak_bw
    return 100.0 * least / seconds

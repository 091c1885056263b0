"""A rendered view's share of the card's peak: the benchmark's count of the
forward's matrix-product FLOPs (``roofline.flops``) over the mean time of
the traced run's untraced views, against the peak of the precision the
configuration computes in."""

from portbench import roofline


def read(run):
    if run.kind != "render" or not run.unit_s or run.peak_flops is None:
        return None
    f = roofline.flops(run.cfg, run.unit_rays, train=False)
    return 100.0 * f / run.unit_s / run.peak_flops

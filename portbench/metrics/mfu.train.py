"""The training step's share of the card's peak: the benchmark's count of
its matrix-product FLOPs (``roofline.flops``) over the mean time of the
traced run's untraced steps, against the peak of the precision the
configuration computes in."""

from portbench import roofline


def read(run):
    if run.kind != "train" or not run.unit_s or run.peak_flops is None:
        return None
    f = roofline.flops(run.cfg, run.unit_rays, train=True)
    return 100.0 * f / run.unit_s / run.peak_flops

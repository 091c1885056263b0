"""The share of the traced steps' device idle time that lies inside the
program's data, forward, losses, backward and optimizer spans; the rest
is host work outside them (the microbatch loop's slicing and sums, the
harness between steps)."""

from portbench import spans


def read(run):
    return spans.covered(run, "train", spans.STEP)

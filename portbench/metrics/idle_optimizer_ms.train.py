"""Device idle milliseconds a training step while the host is inside the
optimizer (``ucnerf.optimizer``: the gradient scale, clean and clips, Adam,
the schedule), over the traced steps."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "train", ("ucnerf.optimizer",))

"""Device idle milliseconds a training step while the host is inside the
model's forward (``ucnerf.forward``: sampling, encoding, the MLPs,
compositing, sky and brightness), over the traced steps."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "train", ("ucnerf.forward",))

"""Device idle milliseconds a training step while the host is inside
autograd's backward (``ucnerf.backward``), over the traced steps."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "train", ("ucnerf.backward",))

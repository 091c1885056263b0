"""Device idle milliseconds a rendered view while the host is inside the
model's forward (``ucnerf.forward``), over the traced views."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "render", ("ucnerf.forward",))

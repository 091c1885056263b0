"""Device idle milliseconds a rendered view while the host is inside a
field's hash encoding (``ucnerf.encode``), a part of
``idle_forward_ms.render``."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "render", ("ucnerf.encode",))

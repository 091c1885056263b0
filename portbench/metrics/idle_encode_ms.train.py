"""Device idle milliseconds a training step while the host is inside a
field's hash encoding (``ucnerf.encode``: contraction, the hash index
arithmetic, K4), a part of ``idle_forward_ms.train``."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "train", ("ucnerf.encode",))

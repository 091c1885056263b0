"""Device idle milliseconds a rendered view while the host is inside
``render_image`` (``ucnerf.render``) and outside the forward: the chunk
loop's slicing, padding, copies to the card, the wait for each chunk's
result and its assembly."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "render", ("ucnerf.render",),
                         exclude=("ucnerf.forward",))

"""The share of the traced views' device idle time that lies inside
``render_image`` (``ucnerf.render``); the rest is each view's ray making
on the host."""

from portbench import spans


def read(run):
    return spans.covered(run, "render", ("ucnerf.render",))

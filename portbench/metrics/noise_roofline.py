"""noise_roofline: the least time of the noise layer's work (work.py, from
the unit's real clusters) over the device time of the kernels launched
inside span(s) bt.noise, in %, over the traced units."""

from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "noise", ("bt.noise",))

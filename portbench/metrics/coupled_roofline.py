"""coupled_roofline: the least time of the coupled layer's work (work.py, from
the unit's real clusters) over the device time of the kernels launched
inside span(s) bt.coupled, in %, over the traced units."""

from portbench.metrics import roofline


def read(ctx):
    return roofline(ctx, "coupled", ("bt.coupled",))
